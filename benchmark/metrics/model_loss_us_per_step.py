"""The model's and the loss's device microseconds a step: the GEMM,
convolution, elementwise, reduction, copy and memset kernels (every kernel
that is not the renderer's, Adam's, the draws' or NCCL's)."""

from benchmark import layers


def read(ctx):
    us = 1e6 * ctx.layer_s_per_unit(layers.MODEL_LOSS)
    return us if us > 0 else None
