"""The gradients' and metrics' exchange, device microseconds a step on
rank 0: the program's ``parallel.all_mean`` spans (the concatenation, the
NCCL ``all_reduce`` the stream waits for, the division and the copy
back), each timed by its pair of CUDA events on the stream."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.device_us_per_unit(ctx, "parallel.all_mean")
