"""The device's idle share of the traced window (%) while rank 0's host
is inside a training step: the window's gaps between device operations
that fall inside the program's ``train.step`` spans, carried onto the
trace's clock. ``device_idle_pct`` less this is the idle outside the
program's steps: the harness's read-back and the loop between chunks."""

from benchmark.metrics import _spans


def read(ctx):
    idle_s = _spans.idle_within(ctx, "train.step")
    if idle_s is None:
        return None
    return 100.0 * idle_s / ctx.trace.window_s
