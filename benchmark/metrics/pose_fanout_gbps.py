"""The predicted-pose fan-out's achieved bandwidth (GB/s): the bytes the
program's ``pose.fanout`` spans count (the rows they materialise) over
their device time. The fan-out is a copy; HBM's peak is 3,350 GB/s."""

from benchmark.metrics import _spans


def read(ctx):
    spans = _spans.named(_spans.in_window(ctx) or [], "pose.fanout")
    if not spans or any(m.span.events is None for m in spans):
        return None
    total_s = sum(m.span.device_s for m in spans)
    return sum(m.span.counts["bytes"] for m in spans) / total_s / 1e9
