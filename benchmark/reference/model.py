"""dpcx's point-cloud model, its GT-pose loss and Adam in plain torch ops,
float32 (the renderer in float64, ``render.py`` says why): the training
step that the benchmark holds the port's to.

Model (the paper's, at dpcx's widths): an image [H, W, 3] goes through 3x3
stride-2 convolutions with SAME padding (pad (0, 1) on even sizes) and
leaky ReLU 0.2, is flattened channels-last, then a dense layer with leaky
ReLU and a dense latent; the decoder's dense layers with leaky ReLU end in
``fc_points`` (N x 3 points, ``0.5 tanh``) and ``fc_scale`` (a global
scale ``0.4 + 0.6 sigmoid``, multiplied into the points). Parameters are
named as the port's ``state_dict`` names them: ``encoder.conv<i>``,
``encoder.fc1``, ``encoder.fc_latent``, ``decoder.fc<i>``,
``decoder.fc_points``, ``decoder.fc_scale`` (torch layouts: OIHW and
[out, in]). ``encoder.fc_pose`` feeds no GT-pose loss, so its gradient is
zero here.

Loss (GT pose): each row renders its V target views with their cameras,
its points weighted by Bernoulli keep weights drawn from the step's
dropout key; ``proj_weight * mean((sil - mask)^2)`` plus, with depth,
``drc_weight`` times the batch mean of each view's masked squared depth
error over its mask's area.

Adam as torch's: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr / (1 - b1^t) m / (sqrt(v) / sqrt(1 - b2^t) + eps)`` with b1 0.9,
b2 0.999, eps 1e-8.

``operand="float8"`` rounds both operands of every convolution and dense
layer to float8 e4m3 (each tensor scaled to its largest magnitude, 448)
before the product: the lower precision below the configuration's bf16
nets, run as the control that the comparison must reject.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import prng
from benchmark.reference.render import keep_prob_schedule, render, \
    sigma_schedule

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
F8_MAX = 448.0


def _round(x: torch.Tensor, operand: str) -> torch.Tensor:
    if operand == "float32":
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return x + (q - x).detach()


def _same_pads(size: int) -> tuple[int, int]:
    out = -(-size // 2)
    total = max((out - 1) * 2 + 3 - size, 0)
    return total // 2, total - total // 2


def _conv(x, p, name, operand):
    top, bottom = _same_pads(x.shape[-2])
    left, right = _same_pads(x.shape[-1])
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(_round(x, operand), _round(p[name + ".weight"], operand),
                    p[name + ".bias"], stride=2)


def _dense(x, p, name, operand):
    return F.linear(_round(x, operand), _round(p[name + ".weight"], operand),
                    p[name + ".bias"])


def forward(cfg: dict, p: dict, images: torch.Tensor,
            operand: str = "float32") -> torch.Tensor:
    """images [B, H, W, 3] -> scaled points [B, N, 3]."""
    x = images.permute(0, 3, 1, 2)
    for i in range(len(cfg["encoder_filters"])):
        x = F.leaky_relu(_conv(x, p, f"encoder.conv{i}", operand), 0.2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.leaky_relu(_dense(x, p, "encoder.fc1", operand), 0.2)
    x = _dense(x, p, "encoder.fc_latent", operand)
    for i in range(len(cfg["pc_decoder_hidden"])):
        x = F.leaky_relu(_dense(x, p, f"decoder.fc{i}", operand), 0.2)
    B, N = x.shape[0], cfg["pc_num_points"]
    points = 0.5 * torch.tanh(_dense(x, p, "decoder.fc_points", operand))
    points = points.reshape(B, N, 3)
    scale = 0.4 + 0.6 * torch.sigmoid(_dense(x, p, "decoder.fc_scale",
                                             operand))
    return points * scale[..., None]


def loss(cfg: dict, p: dict, batch: dict, step: int, weights,
         operand: str = "float32", render_dtype=torch.float64):
    """The GT-pose loss of one batch (image [B, H, W, 3], masks, depths
    [B, V, D, D], quats [B, V, 4]) at ``step``, its points weighted by
    ``weights`` [B, N] (None: no dropout)."""
    points = forward(cfg, p, batch["image"], operand)
    B = points.shape[0]
    V = batch["masks"].shape[1]
    D = cfg["vox_size"]
    if weights is not None:
        weights = weights.repeat_interleave(V, dim=0)
    sil, depth = render(cfg, points.repeat_interleave(V, dim=0),
                        batch["quats"].reshape(B * V, 4),
                        sigma_schedule(cfg, step), weights, render_dtype)
    masks = batch["masks"]
    total = cfg["proj_weight"] * torch.mean(
        (sil.reshape(B, V, D, D) - masks) ** 2)
    if cfg["proj_depth"] and cfg["drc_weight"] > 0:
        se = masks * (depth.reshape(B, V, D, D) - batch["depths"]) ** 2
        dl = se.sum(dim=(-2, -1)) / masks.sum(dim=(-2, -1)).clamp_min(1.0)
        total = total + cfg["drc_weight"] * dl.mean()
    return total


def gather(records: dict, rows: torch.Tensor) -> dict:
    """The batch at ``rows`` ([B, 1 + V], ``prng.batch_rows``'s) of
    records [M, V, ...] viewed as [M * V, ...]."""
    flat = {k: v.flatten(0, 1) for k, v in records.items()}
    return {"image": flat["images"][rows[:, 0]],
            "masks": flat["masks"][rows[:, 1:]],
            "depths": flat["depths"][rows[:, 1:]],
            "quats": flat["quats"][rows[:, 1:]]}


def first_outputs(cfg: dict, params: dict, records: dict, key, ranks: int,
                  points: torch.Tensor | None = None,
                  operand: str = "float32", render_dtype=torch.float64,
                  block_rows: int = 32) -> dict:
    """The first step's rows of rank 0 (the first ``batch_size // ranks``
    of the step's draw): {"points": the model's points of those rows from
    ``params`` [rows, N, 3], "silhouette", "depth": the renders [rows * V,
    D, D] of ``points`` (None: the model's own) through the rows' target
    cameras, the step's sigma and rank 0's dropout weights}."""
    M, V = records["images"].shape[:2]
    per = cfg["batch_size"] // ranks
    rows, k_drop = prng.batch_rows(key, 0, cfg["batch_size"], M, V,
                                   min(cfg["views_per_step"], V),
                                   records["images"].device)
    rows = rows[:per]
    p = {k: v.detach().float() for k, v in params.items()}
    weights = None
    if cfg["pc_point_dropout"] < 1.0:
        weights = prng.dropout_weights(
            k_drop if ranks == 1 else prng.fold_in(k_drop, 0), per,
            cfg["pc_num_points"], keep_prob_schedule(cfg, 0),
            records["images"].device)
    own, sils, depths = [], [], []
    with torch.no_grad():
        for lo in range(0, per, block_rows):
            hi = min(lo + block_rows, per)
            batch = gather(records, rows[lo:hi])
            own.append(forward(cfg, p, batch["image"], operand))
            pts = own[-1] if points is None else points[lo:hi].float()
            v = batch["quats"].shape[1]
            sil, depth = render(
                cfg, pts.repeat_interleave(v, dim=0),
                batch["quats"].reshape(-1, 4), sigma_schedule(cfg, 0),
                None if weights is None
                else weights[lo:hi].repeat_interleave(v, dim=0),
                render_dtype)
            sils.append(sil)
            depths.append(depth)
    return {"points": torch.cat(own), "silhouette": torch.cat(sils),
            "depth": None if depths[0] is None else torch.cat(depths)}


def train_steps(cfg: dict, params: dict, records: dict, key, steps: int,
                ranks: int = 1, operand: str = "float32",
                render_dtype=torch.float64, block_rows: int = 32) -> dict:
    """``steps`` training steps from ``params`` (left unchanged) on the
    stream of base ``key``. Each step's whole batch of ``cfg["batch_size"]``
    rows is split over ``ranks`` equal slices, each with the dropout key
    ``fold_in(k_drop, rank)`` (one slice: ``k_drop`` itself) and its own
    mean loss; the loss and the gradient are the means over the slices.
    A slice is computed ``block_rows`` rows at a time, so that it fits.
    -> {"losses": [steps], "grad1": the first step's gradient,
    "grad1_rank0": the first step's gradient of rank 0's slice alone, the
    gradient that rank would step on with no exchange (None with one
    rank), "grad1_half": the first step's gradient of the first half of
    each slice's rows alone, the mean over them (None where a slice has
    one row), "params": the parameters after the last step}."""
    M, V = records["images"].shape[:2]
    views_use = min(cfg["views_per_step"], V)
    B = cfg["batch_size"]
    per = B // ranks
    half = per // 2
    blocks = [(lo, min(lo + block_rows, end))
              for start, end in ((0, half), (half, per))
              for lo in range(start, end, block_rows)]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1, own0 = [], None, None
    halves = {k: torch.zeros_like(v) for k, v in p.items()} if half else None
    device = records["images"].device
    for t in range(steps):
        rows, k_drop = prng.batch_rows(key, t, B, M, V, views_use, device)
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total = 0.0
        for r in range(ranks):
            dk = k_drop if ranks == 1 else prng.fold_in(k_drop, r)
            weights = None
            if cfg["pc_point_dropout"] < 1.0:
                weights = prng.dropout_weights(
                    dk, per, cfg["pc_num_points"], keep_prob_schedule(cfg, t),
                    device)
            for lo, hi in blocks:
                batch = gather(records, rows[r * per + lo:r * per + hi])
                leaves = {k: v.requires_grad_(True) for k, v in p.items()}
                lv = loss(cfg, leaves, batch, t,
                          None if weights is None else weights[lo:hi],
                          operand, render_dtype) * ((hi - lo) / per)
                gs = torch.autograd.grad(lv, list(leaves.values()),
                                         allow_unused=True)
                for (k, _), g in zip(leaves.items(), gs):
                    if g is not None:
                        grads[k] += g
                        if t == 0 and hi <= half:
                            halves[k] += g * (per / (half * ranks))
                total += float(lv.detach())
                del lv, gs
            if t == 0 and r == 0 and ranks > 1:
                own0 = {k: g.clone() for k, g in grads.items()}
        p = {k: v.detach() for k, v in p.items()}
        for k in grads:
            grads[k] /= ranks
        losses.append(total / ranks)
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        step = t + 1
        bc1, bc2 = 1 - BETA1**step, 1 - BETA2**step
        for k, g in grads.items():
            m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
            v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            denom = (v2[k].sqrt() / bc2**0.5).add_(EPS)
            p[k].addcdiv_(m[k], denom, value=-cfg["learning_rate"] / bc1)
    return {"losses": losses, "grad1": grad1, "grad1_rank0": own0,
            "grad1_half": halves, "params": p}
