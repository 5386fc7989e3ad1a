"""The renderer's backward, device microseconds a unit (a training step
or a renderer call): the program's ``render.bwd`` spans (the launch of K2,
or K4 + K5 at D > 64, on the autograd engine's thread), each timed by its
pair of CUDA events on the stream."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "render.bwd")
