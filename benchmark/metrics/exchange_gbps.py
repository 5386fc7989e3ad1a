"""The exchange's algorithm bandwidth (GB/s) on rank 0: the bytes the
program's ``parallel.all_mean`` spans count over their device time."""

from benchmark.metrics import _spans


def read(ctx):
    spans = _spans.named(_spans.in_window(ctx) or [], "parallel.all_mean")
    if not spans or any(m.span.events is None for m in spans):
        return None
    total_s = sum(m.span.device_s for m in spans)
    return sum(m.span.counts["bytes"] for m in spans) / total_s / 1e9
