"""The target views' encoder and pose heads, device microseconds a
training step: the program's ``pose.views`` spans (``model.pose_only`` on
the B x V target-view images of predicted pose from the views), each timed
by its pair of CUDA events on the stream."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "pose.views")
