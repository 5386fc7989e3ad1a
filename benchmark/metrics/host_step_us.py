"""The host's microseconds inside a training step (rank 0's): the
program's ``train.step`` spans on the host's clock over the window's
steps, the program's own dispatch. Where it reaches the step's device
time, the host paces the step."""

from benchmark.metrics import _spans


def read(ctx):
    spans = _spans.in_window(ctx)
    steps = _spans.named(spans or [], "train.step")
    if not steps:
        return None
    return 1e6 * sum(m.span.host_s for m in steps) / ctx.units
