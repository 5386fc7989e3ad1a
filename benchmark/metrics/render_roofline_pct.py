"""The renderer's share of its roofline (%): the frozen least time of
the renderer's forward and backward a training step or a renderer call
(``yardstick.render_work``) over the device time of the renderer's kernels
in it (rank 0's on several cards)."""

from benchmark import layers, yardstick


def read(ctx):
    device_s = ctx.layer_s_per_unit(layers.RENDERER)
    if device_s <= 0:
        return None
    work = yardstick.render_step_work(ctx.settings, ctx.renders, ctx.weights)
    return 100.0 * work["seconds"] / device_s
