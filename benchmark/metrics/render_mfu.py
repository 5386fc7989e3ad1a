"""The whole renderer call's share of the card's peak (%): the
renderer's forward and backward operations as the frozen bound counts
them, at their peak, over the call's time (the traced window over its
calls)."""

from benchmark import yardstick


def read(ctx):
    s = ctx.settings
    work = yardstick.render_step_work(s, ctx.renders, ctx.weights)
    peak_s = yardstick.render_peak_seconds(
        work, s["pallas_acc_dtype"] == "bfloat16")
    return 100.0 * peak_s / ctx.unit_s
