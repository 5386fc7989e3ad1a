"""Adam's device microseconds a step: the ``multi_tensor_apply``
kernels of the foreach optimizer."""

from benchmark import layers


def read(ctx):
    us = 1e6 * ctx.layer_s_per_unit([layers.ADAM])
    return us if us > 0 else None
