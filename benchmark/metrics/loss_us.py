"""The loss, device microseconds a training step: the program's
``train.loss`` spans less the renderer's launches inside them
(``render.fwd``): the loss terms, the camera transform and the renderer's
glue (``render.project`` less its launch)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "train.loss",
                                     less=("render.fwd", "render.bwd"))
