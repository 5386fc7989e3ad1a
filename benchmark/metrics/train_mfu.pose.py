"""The whole predicted-pose step's share of the card's peak (%): the
operations a step needs, each kind at its peak, over the step's time (the
traced window over its steps).

Predicted pose from the views: the encoder's convolutions and ``fc1``,
``fc_pose`` and the pose head (``fc0``, ``fc_quats``, ``fc_student``) on
the B input and B x V target-view images; ``fc_latent`` and the decoder
on the B input images; forward and backward (the backward twice the
forward, no input gradient of the first convolution), at the peak of the
nets' compute dtype (bf16: 989 TFLOP/s). The renderer's B x K x V renders
(``ctx.renders``) as the frozen bound counts them, at 67 TFLOP/s in f32
(the bf16 mode's products at 989). An FMA counts 2; nothing recomputed
counts."""

from benchmark import yardstick

POSE_HIDDEN = 256  # the pose head's hidden width (nets/pose.py)


def forward_ops(s: dict) -> tuple[float, float, float]:
    """(operations of one image through the encoder's convolutions, fc1,
    fc_pose and the pose head; of one through fc_latent and the decoder;
    of the first convolution alone)."""
    size, ch, convs, first = s["image_size"], 3, 0.0, None
    for f in s["encoder_filters"]:
        size = -(-size // 2)
        ops = 2.0 * size * size * f * ch * 9
        first = ops if first is None else first
        convs += ops
        ch = f
    K, F = s["pose_predict_num_candidates"], s["fc_hidden"]
    pose = [(size * size * ch, F), (F, F), (F, POSE_HIDDEN),
            (POSE_HIDDEN, 4 * K)]
    if s["pose_student"]:
        pose.append((POSE_HIDDEN, 4))
    dec, width = [(F, s["latent_dim"])], s["latent_dim"]
    for h in s["pc_decoder_hidden"]:
        dec.append((width, h))
        width = h
    dec += [(width, 3 * s["pc_num_points"]), (width, 1)]
    return (convs + sum(2.0 * a * b for a, b in pose),
            sum(2.0 * a * b for a, b in dec), first)


def step_ops(s: dict, rows: int, views: int) -> float:
    """The nets' operations of a step of ``rows`` samples with ``views``
    target views each (encoded only with ``pose_from_views``)."""
    image, decode, first = forward_ops(s)
    images = rows * (1 + views if s["pose_from_views"] else 1)
    return 3 * (images * image + rows * decode) - images * first


def read(ctx):
    s = ctx.settings
    K = s["pose_predict_num_candidates"]
    views = ctx.renders // (ctx.rows * K)
    peak = (yardstick.PEAK_BF16_FLOPS if s["compute_dtype"] == "bfloat16"
            else yardstick.PEAK_F32_FLOPS)
    model_s = step_ops(s, ctx.rows, views) / peak
    render_s = yardstick.render_peak_seconds(
        yardstick.render_step_work(s, ctx.renders, ctx.weights),
        s["pallas_acc_dtype"] == "bfloat16")
    return 100.0 * (model_s + render_s) / ctx.unit_s
