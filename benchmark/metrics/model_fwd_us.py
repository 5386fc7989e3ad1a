"""The model's forward, device microseconds a training step: the
program's ``train.forward`` spans (the encoder and the decoder), each
timed by its pair of CUDA events on the stream."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "train.forward")
