"""The NCCL kernels' device microseconds a step on rank 0: the
gradient-and-metrics ``all_reduce`` of data parallelism."""

from benchmark import layers


def read(ctx):
    us = 1e6 * ctx.layer_s_per_unit([layers.PARALLEL])
    return us if us > 0 else None
