"""The predicted-pose selection, device microseconds a training step: the
program's ``pose.select`` spans (the candidates' scores, the hard min, its
gathers, the student loss and the gauge telemetry), each timed by its
pair of CUDA events on the stream."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "pose.select")
