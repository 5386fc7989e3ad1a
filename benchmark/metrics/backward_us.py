"""The backward, device microseconds a training step: the program's
``train.backward`` spans less the renderer's backward launches inside
them (``render.bwd``): the model's, the loss's and the camera transform's
backward."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "train.backward",
                                     less=("render.bwd",))
