"""The yardstick, frozen: one H100's published peaks, the least operations
and bytes of the renderer's function, and the operations of the model's
convolutions and dense layers.

Peaks (NVIDIA's H100 SXM data sheet, dense): 67 TFLOP/s in float32 outside
the tensor cores, 989 TFLOP/s in bf16 on them, 3.35 TB/s of HBM.

The renderer's counts are those of the port's ``render_bound`` as it stood
when this benchmark was defined: f32 operations per item counted from the
CUDA source (the splat per point: floors, fractions, 1 - t, 8 corners x (3
mults + 1 add); the splat backward per point: the same hats, 8 corners x 4
sums x 3; DRC per cell: clip, p = o T, sil += p, T *= 1 - o, + 3 with
depth; its backward: the forward walk's T, phi, the suffix, dL/do); a blur
pass costs a multiply and an add per in-range tap. Bytes: each input read
once, each output written once. The backward takes the lesser of two ways:
reading the blurred grid the forward keeps, or recomputing it.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SPLAT_OPS, SPLAT_BWD_OPS, DRC_OPS, DRC_BWD_OPS, DEPTH_OPS = 40, 108, 6, 14, 3


def blur_taps(d: int, r: int) -> int:
    """In-range taps of one 1-D blur pass along a line of d cells."""
    return sum(min(r, d - 1 - i) + min(r, i) + 1 for i in range(d))


def _way(mm_ops: float, f32_ops: float, nbytes: float, bf16: bool) -> dict:
    if bf16:
        t_ops = mm_ops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS
    else:
        t_ops = (mm_ops + f32_ops) / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return {"mm_ops": mm_ops, "f32_ops": f32_ops, "bytes": nbytes,
            "seconds": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}


def render_work(renders: int, n: int, vox: int, radius: int,
                with_depth: bool, weights: bool, backward: bool,
                bf16: bool = False) -> dict:
    """The least work of one forward or backward renderer call: its
    operations (``mm_ops``, which run as bf16 products in the bf16 mode,
    and ``f32_ops``), its ``bytes``, the least ``seconds`` on the card and
    whether operations or bytes bound it (``by``)."""
    cells = renders * vox**3
    blur_pass = 2 * renders * vox * vox * blur_taps(vox, radius)
    pts = renders * n
    depth_ops = DEPTH_OPS if with_depth else 0
    point_bytes = 4 * pts * (4 if weights else 3)
    image_bytes = 4 * renders * vox * vox * (2 if with_depth else 1)
    taps_bytes = 4 * (2 * radius + 1)
    if not backward:
        return _way(SPLAT_OPS * pts + 3 * blur_pass,
                    (DRC_OPS + depth_ops) * cells,
                    point_bytes + taps_bytes + image_bytes, bf16)
    mm_ops = 3 * blur_pass + SPLAT_BWD_OPS * pts
    f32_ops = (DRC_BWD_OPS + depth_ops) * cells
    nbytes = 2 * point_bytes + taps_bytes + image_bytes
    return min(_way(mm_ops, f32_ops, nbytes + 4 * cells, bf16),
               _way(mm_ops + SPLAT_OPS * pts + 3 * blur_pass, f32_ops,
                    nbytes, bf16),
               key=lambda w: w["seconds"])


def kernel_radius(cfg: dict) -> int:
    D = cfg["vox_size"]
    s = max(cfg["pc_relative_sigma"], cfg["pc_relative_sigma_end"])
    return max(1, min(D - 1, int(s * D * cfg["gauss_kernel_truncate"])))


def render_step_work(cfg: dict, renders: int, weights: bool) -> dict:
    """The forward and backward of one call of ``renders`` renders at
    ``cfg`` summed: {"mm_ops", "f32_ops", "seconds"}."""
    args = (renders, cfg["pc_num_points"], cfg["vox_size"],
            kernel_radius(cfg), cfg["proj_depth"], weights)
    bf16 = cfg["pallas_acc_dtype"] == "bfloat16"
    f, b = (render_work(*args, backward=bw, bf16=bf16) for bw in (False,
                                                                  True))
    return {k: f[k] + b[k] for k in ("mm_ops", "f32_ops", "seconds")}


def render_peak_seconds(work: dict, bf16: bool) -> float:
    """The seconds the renderer's operations alone take at their peaks."""
    if bf16:
        return (work["mm_ops"] / PEAK_BF16_FLOPS
                + work["f32_ops"] / PEAK_F32_FLOPS)
    return (work["mm_ops"] + work["f32_ops"]) / PEAK_F32_FLOPS


def model_forward_ops(cfg: dict) -> tuple[float, float]:
    """(operations of one sample's forward through the convolutions and
    dense layers the GT-pose loss needs, those of the first convolution):
    an FMA counts 2. The pose branch's ``fc_pose``, which no GT-pose loss
    reads, is left out."""
    size, ch, total, first = cfg["image_size"], 3, 0.0, None
    for f in cfg["encoder_filters"]:
        size = -(-size // 2)
        ops = 2.0 * size * size * f * ch * 9
        first = ops if first is None else first
        total += ops
        ch = f
    dense = [(size * size * ch, cfg["fc_hidden"]),
             (cfg["fc_hidden"], cfg["latent_dim"])]
    width = cfg["latent_dim"]
    for h in cfg["pc_decoder_hidden"]:
        dense.append((width, h))
        width = h
    dense += [(width, 3 * cfg["pc_num_points"]), (width, 1)]
    total += sum(2.0 * a * b for a, b in dense)
    return total, first


def model_train_ops(cfg: dict, rows: int) -> float:
    """Operations of ``rows`` samples' forward and backward through the
    model: the backward twice the forward (input and weight gradients),
    but no input gradient of the first convolution."""
    fwd, first = model_forward_ops(cfg)
    return rows * (3 * fwd - first)
