"""The whole step's share of the card's peak (%): the operations a step
needs, each kind at its peak, over the step's time (the traced window
over its steps). Kinds: the model's convolutions and dense layers,
forward and backward, at the peak of the nets' compute dtype (bf16: 989
TFLOP/s); the renderer's operations as the frozen bound counts them, at
67 TFLOP/s in f32 (the bf16 mode's products at 989). Nothing recomputed
counts."""

from benchmark import yardstick


def read(ctx):
    s = ctx.settings
    peak = (yardstick.PEAK_BF16_FLOPS if s["compute_dtype"] == "bfloat16"
            else yardstick.PEAK_F32_FLOPS)
    model_s = yardstick.model_train_ops(s, ctx.rows) / peak
    render_s = yardstick.render_peak_seconds(
        yardstick.render_step_work(s, ctx.renders, ctx.weights),
        s["pallas_acc_dtype"] == "bfloat16")
    return 100.0 * (model_s + render_s) / ctx.unit_s
