"""The device's idle share of the traced window (%): the window less
the union of its kernels, copies and memsets, over the window."""

from benchmark.window import idle_pct


def read(ctx):
    return idle_pct(ctx.trace.busy_s, ctx.trace.window_s)
