"""The renderer's forward, device microseconds a unit (a training step
or a renderer call): the program's ``render.fwd`` spans (the launch of K1,
or K3 at D > 64), each timed by its pair of CUDA events on the stream."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "render.fwd")
