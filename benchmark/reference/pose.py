"""dpcx's predicted-pose training step in plain torch ops: the model with
its pose head, the candidates' renders, the hard min, the student and
Adam, float32 (the renderer in float64, ``render.py`` says why). The
benchmark's pose cells and the port's CPU tests both hold the port to it.

Model (``model.py``'s, with the pose branch): the encoder's convolutions
and ``fc1`` give ``feat``; ``fc_latent`` gives the latent the decoder reads
(once, on the input view) and ``pose_inp = lrelu(fc_pose(feat))`` feeds the
pose head: ``h = lrelu(fc0(pose_inp))`` (1024 -> 256), the K candidates
``q_k = normalize(fc_quats(h)_k + (1, 0, 0, 0)) (x) (cos(t_k / 2), 0,
sin(t_k / 2), 0)``, ``t_k = 2 pi k / K`` (the azimuth offsets), and the
student ``s = normalize(fc_student(h) + (1, 0, 0, 0))``; ``(x)`` is the
Hamilton product, quaternions (w, x, y, z), ``normalize`` divides by the
norm clamped at 1e-12. Leaky ReLUs take 0.2. Parameters as the port's
``state_dict`` names them (``pose_head.fc0`` ...).

Loss, with ``pose_from_views`` (each target view v of sample b runs its own
image through the encoder and the pose head; the decoder runs once, on the
input view): the input view's points, weighted by the step's Bernoulli
keep weights, render through every candidate camera of every target view,
``sil[b, k, v]``;

- ``l[b, k, v] = mean_px (sil - mask)^2``, the score ``proj_weight l``;
- ``k*[b, v] = argmin_k`` of the score (the first minimum);
- ``L_proj = mean_{b, v} l[b, k*, v]`` (only the winners get gradient);
- ``L_student = mean_{b, v} (1 - <s[b, v], stopgrad(q[b, k*, v])>^2)``;
- ``L = proj_weight L_proj + pose_student_weight L_student`` (the weight
  ramped over ``pose_student_warmup_steps`` where set).

Without ``pose_from_views`` the candidates are the input view's: target
view v renders through ``q_rel(v) (x) q_k``, ``q_rel(v) = cam(v) (x)
conj(cam_in)`` (the known rig), each sample picks one winner over the mean
of its views' errors, and its one student distils it.

Departures from the paper (Insafutdinov & Dosovitskiy 2018), all dpcx's
recipe: the paper's head predicts K = 4 candidates from the input view
alone; dpcx composes fixed azimuth offsets onto its K candidates and, with
``pose_from_views``, predicts each target view's candidates from that
view's own image. The gauge telemetry (``gauge_spread_deg``) is a metric
of the program's, no term of the loss, and is left out here, as are the
terms the benchmark's configurations do not train (colour, depth, splats,
translations, softmin, anchor, consistency): a configuration with one of
them is refused.

A winner needs care in a comparison: two candidates whose scores differ by
less than the rounding of the program's nets can swap. ``train_steps``
therefore takes the program's scores of each step (``follow``) and a
``tie_margin``: where the reference's own best and second-best scores of a
(b, v) lie within ``tie_margin``, it takes the program's winner there,
elsewhere its own, and it counts the (b, v) outside the band whose winners
differ from the program's. Near-ties are common at the start of training
(a cloud from weights at random is a round blob, which every candidate
renders alike), so it also reports the largest regret: how much worse,
under its own scores, the program's winner scores than the best.

``operand="float8"`` rounds every convolution's and dense layer's operands
to float8 e4m3 (``model.py``'s control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import prng
from benchmark.reference.model import BETA1, BETA2, EPS, _conv, _dense
from benchmark.reference.render import keep_prob_schedule, render, \
    sigma_schedule

UNSUPPORTED = {"pc_rgb": True, "pc_gauss": True, "predict_translation": True,
               "proj_depth": True}
UNTRAINED = ("pose_softmin_temp", "pose_anchor_weight",
             "pose_consistency_weight")


def supported(cfg: dict) -> None:
    """Refuse a configuration with a term this reference leaves out."""
    bad = [k for k, v in UNSUPPORTED.items() if cfg[k] == v]
    bad += [k for k in UNTRAINED if cfg[k] > 0]
    if not cfg["predict_pose"] or bad:
        raise ValueError("the pose reference does not cover "
                         f"{bad or ['a GT-pose configuration']}")


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
        1e-12)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Hamilton product ``a (x) b``."""
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def _plus_identity(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1] + 1.0, q[..., 1:]], dim=-1)


def encode(cfg: dict, p: dict, images: torch.Tensor, operand: str
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """images [M, H, W, 3] -> (latent [M, L], pose_inp [M, F])."""
    x = images.permute(0, 3, 1, 2)
    for i in range(len(cfg["encoder_filters"])):
        x = F.leaky_relu(_conv(x, p, f"encoder.conv{i}", operand), 0.2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    feat = F.leaky_relu(_dense(x, p, "encoder.fc1", operand), 0.2)
    return (_dense(feat, p, "encoder.fc_latent", operand),
            F.leaky_relu(_dense(feat, p, "encoder.fc_pose", operand), 0.2))


def decode(cfg: dict, p: dict, latent: torch.Tensor, operand: str
           ) -> torch.Tensor:
    """latent [M, L] -> scaled points [M, N, 3]."""
    x = latent
    for i in range(len(cfg["pc_decoder_hidden"])):
        x = F.leaky_relu(_dense(x, p, f"decoder.fc{i}", operand), 0.2)
    points = 0.5 * torch.tanh(_dense(x, p, "decoder.fc_points", operand))
    points = points.reshape(x.shape[0], cfg["pc_num_points"], 3)
    scale = 0.4 + 0.6 * torch.sigmoid(_dense(x, p, "decoder.fc_scale",
                                             operand))
    return points * scale[..., None]


def pose_head(cfg: dict, p: dict, pose_inp: torch.Tensor, operand: str
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """pose_inp [M, F] -> (candidates [M, K, 4], student [M, 4] or
    None)."""
    K = cfg["pose_predict_num_candidates"]
    h = F.leaky_relu(_dense(pose_inp, p, "pose_head.fc0", operand), 0.2)
    quats = normalize(_plus_identity(
        _dense(h, p, "pose_head.fc_quats", operand).reshape(-1, K, 4)))
    if cfg["pose_candidate_offsets"] and K > 1:
        theta = 2.0 * math.pi * torch.arange(
            K, dtype=torch.float32, device=h.device) / K
        zeros = torch.zeros_like(theta)
        quats = multiply(quats, torch.stack(
            [torch.cos(theta / 2), zeros, torch.sin(theta / 2), zeros], -1))
    student = None
    if cfg["pose_student"]:
        student = normalize(_plus_identity(
            _dense(h, p, "pose_head.fc_student", operand)))
    return quats, student


def gather(records: dict, rows: torch.Tensor) -> dict:
    """The batch at ``rows`` ([B, 1 + V], ``prng.batch_rows``'s) of
    records [M, V, ...] viewed as [M * V, ...]."""
    flat = {k: v.flatten(0, 1) for k, v in records.items()}
    return {"image": flat["images"][rows[:, 0]],
            "images_v": flat["images"][rows[:, 1:]],
            "masks": flat["masks"][rows[:, 1:]],
            "quats": flat["quats"][rows[:, 1:]],
            "quat_in": flat["quats"][rows[:, 0]]}


def candidates(cfg: dict, p: dict, batch: dict, operand: str
               ) -> dict[str, torch.Tensor]:
    """The model on one batch: {"points" [B, N, 3], "cameras" [B, K, V, 4]
    (each candidate camera of each target view), "cand" (the candidates
    the student distils: [B, V, K, 4] from the views, [B, K, 4] from the
    input view), "student" ([B, V, 4] or [B, 4], or None)}."""
    B, V = batch["masks"].shape[:2]
    latent, pose_inp = encode(cfg, p, batch["image"], operand)
    points = decode(cfg, p, latent, operand)
    if cfg["pose_from_views"]:
        iv = batch["images_v"]
        _, pose_v = encode(cfg, p, iv.reshape((B * V,) + iv.shape[2:]),
                           operand)
        quats, student = pose_head(cfg, p, pose_v, operand)
        cand = quats.reshape(B, V, -1, 4)
        cameras = cand.transpose(1, 2)
        student = None if student is None else student.reshape(B, V, 4)
    else:
        cand, student = pose_head(cfg, p, pose_inp, operand)
        q_rel = multiply(batch["quats"], conjugate(batch["quat_in"])[:, None])
        cameras = multiply(q_rel[:, None], cand[:, :, None])
    return {"points": points, "cameras": cameras, "cand": cand,
            "student": student}


def renders(cfg: dict, points: torch.Tensor, cameras: torch.Tensor,
            sigma_rel, weights, render_dtype) -> torch.Tensor:
    """points [B, N, 3] through cameras [B, K, V, 4] -> silhouettes [B, K,
    V, D, D], each sample's keep ``weights`` [B, N] (or None) on every
    render of it."""
    B, K, V = cameras.shape[:3]
    D = cfg["vox_size"]
    sil, _ = render(cfg, points.repeat_interleave(K * V, dim=0),
                    cameras.reshape(B * K * V, 4), sigma_rel,
                    None if weights is None
                    else weights.repeat_interleave(K * V, dim=0),
                    render_dtype)
    return sil.reshape(B, K, V, D, D)


def choose(scores: torch.Tensor, follow: torch.Tensor | None,
           tie_margin: float) -> dict:
    """Winners over dim 1 of ``scores`` [B, K(, V)] and how the program's
    (``follow``: its scores) compare: {"winners"; "outside": the entries
    outside the tie band; "differ": those among them whose own winner
    differs from the program's; "regret": the most by which the program's
    winner scores above the best, under ``scores``}. Within
    ``tie_margin`` of the second-best score the winner is the program's,
    elsewhere the own argmin. A ``follow`` of another shape (the program
    scored other rows) differs everywhere."""
    own = torch.argmin(scores, dim=1)
    n = own.numel()
    if follow is None or follow.shape != scores.shape:
        return {"winners": own, "outside": n,
                "differ": 0 if follow is None else n,
                "regret": 0.0 if follow is None else math.inf}
    theirs = torch.argmin(follow.to(scores.device), dim=1)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    outside = (two[:, 1] - two[:, 0]) >= tie_margin
    regret = torch.take_along_dim(scores, theirs[:, None], 1)[:, 0] \
        - two[:, 0]
    return {"winners": torch.where(outside, own, theirs),
            "outside": int(outside.sum()),
            "differ": int((outside & (own != theirs)).sum()),
            "regret": float(regret.max())}


def loss(cfg: dict, p: dict, batch: dict, step: int, weights,
         operand: str = "float32", render_dtype=torch.float64,
         follow: torch.Tensor | None = None, tie_margin: float = 0.0):
    """The predicted-pose loss of one batch at ``step``, its points
    weighted by ``weights`` [B, N] (None: no dropout); ``follow``: the
    program's scores of these rows. -> (loss, {"scores", "student" (the
    student loss, None without a student), and ``choose``'s "winners",
    "outside", "differ", "regret"})."""
    c = candidates(cfg, p, batch, operand)
    sil = renders(cfg, c["points"], c["cameras"], sigma_schedule(cfg, step),
                  weights, render_dtype)
    l_kv = ((sil - batch["masks"][:, None]) ** 2).mean(dim=(3, 4))
    l_k = l_kv if cfg["pose_from_views"] else l_kv.mean(2)
    scores = cfg["proj_weight"] * l_k.detach()
    info = choose(scores, follow, tie_margin)
    k_star = info["winners"]
    proj = torch.take_along_dim(l_k, k_star[:, None], 1).mean()
    total = cfg["proj_weight"] * proj
    info.update(scores=scores, student=None)
    if c["student"] is not None:
        if cfg["pose_from_views"]:
            teacher = torch.take_along_dim(
                c["cand"], k_star[:, :, None, None], 2).squeeze(2)
        else:
            teacher = torch.take_along_dim(
                c["cand"], k_star[:, None, None], 1).squeeze(1)
        dot = (c["student"] * teacher.detach()).sum(-1)
        student = (1.0 - dot**2).mean()
        sw = cfg["pose_student_weight"]
        if cfg["pose_student_warmup_steps"] > 0:
            sw *= min(max(step / cfg["pose_student_warmup_steps"], 0.0), 1.0)
        total = total + sw * student
        info["student"] = student.detach()
    return total, info


def _dropout(cfg, key, rows, t, device):
    if cfg["pc_point_dropout"] >= 1.0:
        return None
    return prng.dropout_weights(key, rows, cfg["pc_num_points"],
                                keep_prob_schedule(cfg, t), device)


def train_steps(cfg: dict, params: dict, records: dict, key, steps: int,
                operand: str = "float32", render_dtype=torch.float64,
                block_rows: int = 16, follow: list | None = None,
                tie_margin: float = 0.0) -> dict:
    """``steps`` training steps of the whole batch from ``params`` (left
    unchanged) on the stream of base ``key``, ``block_rows`` rows at a
    time so that it fits; ``follow[t]``: the program's scores of step t
    (None: every winner the reference's own). -> {"losses", "grad1"
    (the first step's gradient), "grad1_half" (that of the first half of
    the rows alone, None for one row), "params" (after the last step),
    "scores" and "winners" (each step's, [B, K(, V)] and [B(, V)]),
    "outside", "differ" (over all steps: the (b, v) outside the tie band,
    those whose winners differ from ``follow``'s), "regret" (the largest
    of ``choose``'s over the steps), "student1" (the first step's student
    loss)}."""
    supported(cfg)
    M, V = records["images"].shape[:2]
    views_use = min(cfg["views_per_step"], V)
    B = cfg["batch_size"]
    half = B // 2
    blocks = [(lo, min(lo + block_rows, end))
              for start, end in ((0, half), (half, B))
              for lo in range(start, end, block_rows)]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    device = records["images"].device
    out = {"losses": [], "scores": [], "winners": [], "outside": 0,
           "differ": 0, "regret": 0.0, "grad1": None, "student1": 0.0,
           "grad1_half": ({k: torch.zeros_like(v) for k, v in p.items()}
                          if half else None)}
    for t in range(steps):
        rows, k_drop = prng.batch_rows(key, t, B, M, V, views_use, device)
        weights = _dropout(cfg, k_drop, B, t, device)
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total, scores, winners = 0.0, [], []
        for lo, hi in blocks:
            batch = gather(records, rows[lo:hi])
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            lv, info = loss(cfg, leaves, batch, t,
                            None if weights is None else weights[lo:hi],
                            operand, render_dtype,
                            None if follow is None else follow[t][lo:hi],
                            tie_margin)
            lv = lv * ((hi - lo) / B)
            gs = torch.autograd.grad(lv, list(leaves.values()),
                                     allow_unused=True)
            for k, g in zip(leaves, gs):
                if g is not None:
                    grads[k] += g
                    if t == 0 and hi <= half:
                        out["grad1_half"][k] += g * (B / half)
            total += float(lv.detach())
            scores.append(info["scores"])
            winners.append(info["winners"])
            out["outside"] += info["outside"]
            out["differ"] += info["differ"]
            out["regret"] = max(out["regret"], info["regret"])
            if t == 0:
                if info["student"] is not None:
                    out["student1"] += float(info["student"]) * (hi - lo) / B
            del lv, gs
        p = {k: v.detach() for k, v in p.items()}
        out["losses"].append(total)
        out["scores"].append(torch.cat(scores))
        out["winners"].append(torch.cat(winners))
        if out["grad1"] is None:
            out["grad1"] = {k: g.clone() for k, g in grads.items()}
        step = t + 1
        bc1, bc2 = 1 - BETA1**step, 1 - BETA2**step
        for k, g in grads.items():
            m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
            v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            denom = (v2[k].sqrt() / bc2**0.5).add_(EPS)
            p[k].addcdiv_(m[k], denom, value=-cfg["learning_rate"] / bc1)
    out["params"] = p
    return out


def first_outputs(cfg: dict, params: dict, records: dict, key,
                  points: torch.Tensor | None = None,
                  cameras: torch.Tensor | None = None,
                  operand: str = "float32", render_dtype=torch.float64,
                  block_rows: int = 16) -> dict:
    """The first step's model outputs and renders: {"points" [B, N, 3] and
    "cameras" [B, K, V, 4], the reference's own from ``params``;
    "silhouette" [B * K * V, D, D]: the renders of ``points`` through
    ``cameras`` (None: its own), the step's sigma and keep weights;
    "depth": None}."""
    supported(cfg)
    M, V = records["images"].shape[:2]
    B = cfg["batch_size"]
    rows, k_drop = prng.batch_rows(key, 0, B, M, V,
                                   min(cfg["views_per_step"], V),
                                   records["images"].device)
    weights = _dropout(cfg, k_drop, B, 0, records["images"].device)
    p = {k: v.detach().float() for k, v in params.items()}
    own, cams, sils = [], [], []
    with torch.no_grad():
        for lo in range(0, B, block_rows):
            hi = min(lo + block_rows, B)
            c = candidates(cfg, p, gather(records, rows[lo:hi]), operand)
            own.append(c["points"])
            cams.append(c["cameras"])
            sils.append(renders(
                cfg, c["points"] if points is None else points[lo:hi].float(),
                c["cameras"] if cameras is None
                else cameras[lo:hi].float(), sigma_schedule(cfg, 0),
                None if weights is None else weights[lo:hi], render_dtype))
    D = cfg["vox_size"]
    return {"points": torch.cat(own), "cameras": torch.cat(cams),
            "silhouette": torch.cat(sils).reshape(-1, D, D), "depth": None}
