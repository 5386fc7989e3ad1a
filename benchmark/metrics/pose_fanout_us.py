"""The predicted-pose fan-out, device microseconds a training step: the
program's ``pose.fanout`` spans (each sample's points and keep weights
and each candidate camera broadcast to B x K x V rows), each timed by its
pair of CUDA events on the stream."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "pose.fanout")
