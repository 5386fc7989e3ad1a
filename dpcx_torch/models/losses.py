"""Loss assembly (port of ``dpcx/models/losses.py::compute_loss``).

GT pose: every target view is rendered with its known camera; the loss is
the squared-L2 silhouette error, plus the masked colour error with rgb,
plus the masked depth error when the config renders depth, plus the scale
regulariser. Predicted pose: each of K candidate poses renders every
target view (B x K x V renders in one call); a per-sample hard min over
the candidates (``torch.argmin``: the first minimum, as ``jnp.argmin``)
picks the winner, and only the winner's renders receive projection
gradient; the student quaternion distils the detached winner; with
``pose_from_views`` each target view's candidates come from that view's
own image (``train.apply_model``) and each view picks its own winner, and
the live ``gauge_spread_deg`` metric watches the winners' cross-view
coherence. Softmin annealing, candidate re-anchoring, cross-view shape
consistency, translations, rgb in the selection and the gauss splats under
predicted pose follow dpcx. Where dpcx stops a gradient, the port detaches.

With ``renderer: pallas`` the render goes through the fused CUDA kernels
(forward and backward, at any D <= 128); with ``pc_gauss`` it is the
anisotropic splat renderer (``render/gsplat.py``), whose ``gsplat_impl:
pallas`` runs the CUDA kernels of ``render/aniso.py``. With ``train=True``
and ``pc_point_dropout < 1`` the points carry Bernoulli keep weights drawn
from the ``utils.prng`` key passed in: dpcx's ``jax.random`` draws, bit for
bit.

With ``shard_points`` in a ``torch.distributed`` world of more than one
process, the GT-pose render is ``render/sharded.py``'s point-sharded one
over ``nd`` ranks, ``nd`` the largest divisor of N not above the world (the
others hold empty shards), as dpcx shards over its devices. Its point
cotangent comes back whole on every rank. With a ``batch_mesh`` (the
host-fed step of data parallelism, whose result is dpcx's one-device step
of the whole batch) the rank holds its rows of the batch: the dropout
weights are its rows of the whole batch's draw, and the terms that are not
means over the batch are formed from sums over the ranks, with gradients
through them: the GT-pose colour loss (a ratio of sums), and the batch
means of the predicted-pose selection (``rgb_sel_normalize``'s and the
softmin's temperature).

Masks, depths and target images stored at another resolution than
``vox_size`` are resized at loss time as the reference resizes them with
``jax.image.resize``: masks and images bilinearly with antialiasing
(``F.interpolate(mode="bilinear", antialias=True)``), depths to the
nearest sample (``mode="nearest-exact"``; plain "nearest" picks other
samples).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dpcx_torch.config import Config, world_size
from dpcx_torch.eval.chamfer import chamfer_distance
from dpcx_torch.eval.pose_metrics import gauge_spread_deg
from dpcx_torch.geometry.quaternion import (
    quaternion_conjugate,
    quaternion_multiply,
)
from dpcx_torch.parallel.mesh import all_sum, make_mesh, shard_bounds
from dpcx_torch.render.gsplat import gsplat_project
from dpcx_torch.render.project import (
    keep_prob_schedule,
    pointcloud_project_fn,
    sigma_schedule,
)
from dpcx_torch.render.sharded import pointcloud_project_point_sharded
from dpcx_torch.render.voxelize import pc_point_dropout_weights
from dpcx_torch.utils.profiling import span


def _masked_depth_loss(
    depth: torch.Tensor, gt_depth: torch.Tensor, gt_mask: torch.Tensor
) -> torch.Tensor:
    """L2 on depth inside the GT silhouette (per-sample mean)."""
    se = gt_mask * (depth - gt_depth) ** 2
    return se.sum(dim=(-2, -1)) / gt_mask.sum(dim=(-2, -1)).clamp_min(1.0)


def _resize(x: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """[..., S, S] images to [..., size, size], each plane on its own;
    ``mode`` "bilinear" (antialiased) or "nearest-exact"."""
    lead = x.shape[:-2]
    kw = dict(antialias=True, align_corners=False) if mode == "bilinear" \
        else {}
    out = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=(size, size),
                        mode=mode, **kw)
    return out.reshape(*lead, size, size)


def _batch_sum(x: torch.Tensor, batch_mesh) -> torch.Tensor:
    """``x`` summed over the ranks that hold the batch's rows (``x`` itself
    without a ``batch_mesh``), the cotangent summed back."""
    return x if batch_mesh is None else all_sum(x, batch_mesh)


def _batch_mean(x: torch.Tensor, batch_mesh) -> torch.Tensor:
    """The mean of ``x`` [B_local, ...] over the whole batch."""
    if batch_mesh is None:
        return x.mean()
    return all_sum(x.sum(), batch_mesh) / (x.numel() * batch_mesh.size)


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def rgb_ramp(cfg: Config, step) -> float:
    """Linear warmup factor of the colour loss (``cfg.rgb_warmup_steps``)
    under predicted pose."""
    if cfg.rgb_warmup_steps <= 0:
        return 1.0
    return _clip01(float(step) / cfg.rgb_warmup_steps)


def candidate_scores(
    cfg: Config,
    l_k: torch.Tensor,
    rgb_l_k: torch.Tensor | None,
    ramp: float = 1.0,
    batch_mesh=None,
) -> torch.Tensor:
    """Per-candidate selection score [B, K] (or [B, K, V]) for the hard-min
    argmin. With rgb and ``cfg.rgb_sel_normalize`` each error is divided by
    its detached batch mean (of the whole batch, over ``batch_mesh``), so
    silhouette and colour weigh O(1) each; the loss values are unaffected,
    only the argmin's input changes."""
    if rgb_l_k is None:
        return cfg.proj_weight * l_k
    if cfg.rgb_sel_normalize:
        return l_k / (_batch_mean(l_k.detach(), batch_mesh) + 1e-8) + \
            ramp * rgb_l_k / (_batch_mean(rgb_l_k.detach(), batch_mesh)
                              + 1e-8)
    return cfg.proj_weight * l_k + cfg.rgb_weight * ramp * rgb_l_k


def _resize_images(tgt: torch.Tensor, size: int) -> torch.Tensor:
    """[..., H, W, 3] colour images to [..., size, size, 3], bilinearly."""
    if tgt.shape[-2] == size:
        return tgt
    return _resize(tgt.movedim(-1, -3), size, "bilinear").movedim(-3, -1)


def compute_loss(
    cfg: Config,
    preds: dict[str, torch.Tensor],
    batch: dict[str, torch.Tensor],
    step,
    key=None,
    train: bool = True,
    density_fn=None,
    project_fn=None,
    batch_mesh=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss + metrics dict.

    batch: masks [B, V, S, S], depths [B, V, S, S] (with depth), quats
    [B, V, 4], images_tgt [B, V, H, H, 3] (with rgb), quat_in [B, 4] (the
    input view's camera, predicted pose without ``pose_from_views``).
    preds: the model's outputs, and ``train.apply_model``'s per-view pose
    heads (``quats_views`` ...) and ``points_view2``. ``key`` (a
    ``utils.prng`` key) draws the point dropout weights on the points'
    device; it is needed only when ``train`` and ``pc_point_dropout < 1``. ``density_fn`` goes to
    ``gsplat_project``, ``project_fn`` to ``pointcloud_project_fn`` (None:
    the kernels' dispatchers). ``batch_mesh``: the mesh whose ranks hold the
    rows of one batch, this rank's the ones given (None: the batch is
    whole).
    """
    points = preds["points"]  # [B, N, 3]
    B = points.shape[0]
    masks = batch["masks"]
    D = cfg.vox_size
    # external datasets may store masks/depths at another resolution than
    # the projection grid: resized here, so any mask size trains at any D
    if masks.shape[-1] != D:
        masks = _resize(masks, D, "bilinear")
    depths = batch.get("depths")
    if cfg.proj_depth and depths is not None and depths.shape[-1] != D:
        # nearest: bilinear would blend background depth into silhouette
        # boundary pixels and corrupt the masked depth loss
        depths = _resize(depths, D, "nearest-exact")
    sigma_rel = sigma_schedule(cfg, step, points.device)
    point_weights = None
    if train and cfg.pc_point_dropout < 1.0:
        if key is None:
            raise ValueError("point dropout needs a key")
        keep = keep_prob_schedule(cfg, step)
        rows = B if batch_mesh is None else B * batch_mesh.size
        point_weights = pc_point_dropout_weights(
            key, rows, points.shape[1], keep, points.device
        )
        if batch_mesh is not None:  # this rank's rows of the whole draw
            lo, hi = shard_bounds(rows, batch_mesh)
            point_weights = point_weights[lo:hi]
    metrics: dict[str, torch.Tensor] = {"sigma_rel": sigma_rel}
    pose_loss = _predicted_pose_loss if cfg.predict_pose else _gt_pose_loss
    total = pose_loss(cfg, preds, batch, masks, depths, sigma_rel,
                      point_weights, step, metrics, density_fn, project_fn,
                      batch_mesh)

    if cfg.predict_scale and cfg.scale_weight > 0 and "scale" in preds:
        s_loss = torch.mean((preds["scale"] - 0.7) ** 2)
        total = total + cfg.scale_weight * s_loss
        metrics["loss_scale"] = s_loss

    if cfg.translation_weight > 0 and (
        "translation" in preds or "translations_views" in preds
    ):
        t = preds.get("translations_views", preds.get("translation"))
        t_loss = torch.mean(t**2)
        total = total + cfg.translation_weight * t_loss
        metrics["loss_translation"] = t_loss

    metrics["loss_total"] = total
    return total, metrics


def _gt_pose_loss(cfg, preds, batch, masks, depths, sigma_rel,
                  point_weights, step, metrics, density_fn,
                  project_fn, batch_mesh) -> torch.Tensor:
    """The GT-pose branch: render B*V views in one batched call."""
    points = preds["points"]
    B, V, D = points.shape[0], masks.shape[1], cfg.vox_size
    pts = points.repeat_interleave(V, dim=0)  # [B*V, N, 3]
    pw = (None if point_weights is None
          else point_weights.repeat_interleave(V, dim=0))
    quats = batch["quats"].reshape(B * V, 4)
    rgb = None
    if cfg.pc_rgb and "rgb" in preds:
        rgb = preds["rgb"].repeat_interleave(V, dim=0)
    if cfg.pc_gauss and "gauss_scales" in preds:
        # anisotropic alpha-composited splats; dropout folds into opacity
        opacity = preds["gauss_opacity"].repeat_interleave(V, dim=0)
        if pw is not None:
            opacity = opacity * pw
        out = gsplat_project(
            cfg, pts, quats,
            preds["gauss_scales"].repeat_interleave(V, dim=0),
            preds["gauss_rot"].repeat_interleave(V, dim=0),
            opacity=opacity, rgb=rgb, density_fn=density_fn,
        )
    elif cfg.shard_points and world_size() > 1:
        # every rank renders the whole batch; the points shard over the
        # largest count of ranks that divides N, the others splat nothing
        N, nd = points.shape[1], world_size()
        while N % nd:
            nd -= 1
        mesh = make_mesh(cfg, ranks=range(nd), device=points.device,
                         join_all=True)
        out = pointcloud_project_point_sharded(cfg, mesh, pts, quats,
                                               sigma_rel, point_weights=pw,
                                               rgb=rgb)
    else:
        out = pointcloud_project_fn(cfg, pts, quats, sigma_rel,
                                    point_weights=pw, rgb=rgb,
                                    project_fn=project_fn)
    sil, depth, rgb_proj = out.silhouette.reshape(B, V, D, D), out.depth, \
        out.rgb
    proj_loss = torch.mean((sil - masks) ** 2)
    total = cfg.proj_weight * proj_loss
    metrics["loss_proj"] = proj_loss
    if rgb_proj is not None and "images_tgt" in batch:
        # colour re-projection inside the GT silhouette against the target
        # view, resized to the mask resolution. The targets are
        # background-composited renders, so the background is composited
        # into the prediction first
        tgt = _resize_images(batch["images_tgt"], D)
        rgb_proj = rgb_proj.reshape(B, V, D, D, 3)
        rgb_proj = rgb_proj + (1.0 - sil[..., None]) * cfg.rgb_background
        w = masks[..., None]
        rgb_loss = _batch_sum(torch.sum(w * (rgb_proj - tgt) ** 2),
                              batch_mesh) / (
            _batch_sum(torch.sum(w), batch_mesh) * 3.0).clamp_min(1.0)
        total = total + cfg.rgb_weight * rgb_loss
        metrics["loss_rgb"] = rgb_loss
    if cfg.proj_depth and cfg.drc_weight > 0:
        depth = depth.reshape(B, V, D, D)
        d_loss = torch.mean(_masked_depth_loss(depth, depths, masks))
        total = total + cfg.drc_weight * d_loss
        metrics["loss_depth"] = d_loss
    metrics["iou"] = _iou(sil, masks)
    return total


def _iou(sil: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """IoU diagnostic on the first target view: sil, masks [B, V, D, D]."""
    pred_m = sil[:, 0] > 0.4
    gt_m = masks[:, 0] > 0.5
    inter = (pred_m & gt_m).sum(dim=(-2, -1))
    union = (pred_m | gt_m).sum(dim=(-2, -1)).clamp_min(1)
    return torch.mean(inter / union)


def _predicted_pose_loss(cfg, preds, batch, masks, depths, sigma_rel,
                         point_weights, step, metrics, density_fn,
                         project_fn, batch_mesh) -> torch.Tensor:
    """The predicted-pose branch: K candidates, hard-min selection."""
    points = preds["points"]
    B, V, D = points.shape[0], masks.shape[1], cfg.vox_size
    K = cfg.pose_predict_num_candidates
    per_view_pose = cfg.pose_from_views and "quats_views" in preds

    def bc(x: torch.Tensor) -> torch.Tensor:
        """[B, ...] -> [B*K*V, ...] candidate/view broadcast."""
        return x[:, None, None].expand((B, K, V) + x.shape[1:]).reshape(
            (B * K * V,) + x.shape[1:])

    # the rows the fan-out materialises: each sample's points and keep
    # weights, and each row's camera (and offset) in float32
    floats = 4 + (3 if "translation" in preds else 0)
    fan_bytes = B * K * V * (4 * floats + sum(
        x.numel() // B * x.element_size() for x in (points, point_weights)
        if x is not None))
    with span("pose.fanout", bytes=fan_bytes):
        if per_view_pose:
            # each target view's candidates were predicted from that
            # view's own image, so q_k(v) is object -> camera v: no GT rig
            # transform
            cand_v = preds["quats_views"]  # [B, V, K, 4]
            q_full = cand_v.transpose(1, 2)  # [B, K, V, 4]
        else:
            cand = preds["quats"]  # [B, K, 4]
            q_rel = quaternion_multiply(
                batch["quats"],
                quaternion_conjugate(batch["quat_in"])[:, None])
            # object -> camera v for each (candidate, view): q_rel(v) * q_k
            q_full = quaternion_multiply(q_rel[:, None], cand[:, :, None])
        pts = bc(points)
        pw = None if point_weights is None else bc(point_weights)
        trans = None
        if per_view_pose and "translation" in preds:
            # each target view's offset from that view's own pose head
            if "translations_views" not in preds:
                raise ValueError(
                    "pose_from_views with predict_translation needs "
                    "per-view translations (preds['translations_views'] — "
                    "apply_model builds them from pose_only)"
                )
            trans = preds["translations_views"].transpose(1, 2).reshape(
                B * K * V, 3)
        elif "translation" in preds:
            trans = preds["translation"][:, :, None].expand(
                B, K, V, 3).reshape(B * K * V, 3)
        q_flat = q_full.reshape(B * K * V, 4)
    use_rgb = (cfg.pc_rgb and "rgb" in preds and "images_tgt" in batch
               and cfg.rgb_weight > 0)
    if cfg.pc_gauss and "gauss_scales" in preds:
        opacity = bc(preds["gauss_opacity"])
        if pw is not None:
            opacity = opacity * pw  # point dropout folds into opacity
        out = gsplat_project(
            cfg, pts, q_flat, bc(preds["gauss_scales"]),
            bc(preds["gauss_rot"]), opacity=opacity,
            rgb=bc(preds["rgb"]) if use_rgb else None, translation=trans,
            density_fn=density_fn,
        )
    else:
        # with rgb every candidate's colour renders in the same call, and
        # its error takes part in the selection
        out = pointcloud_project_fn(
            cfg, pts, q_flat, sigma_rel, point_weights=pw,
            rgb=bc(preds["rgb"]) if use_rgb else None, translation=trans,
            project_fn=project_fn)
    # the scores, the hard min, its gathers, the student and the
    # telemetry
    with span("pose.select"):
        sil, depth = out.silhouette.reshape(B, K, V, D, D), out.depth
        # per-sample per-candidate loss over pixels (and over views in
        # input-view-pose mode; per-view selection keeps the view axis)
        l_kv = torch.mean((sil - masks[:, None]) ** 2, dim=(3, 4))  # [B, K, V]
        l_k = l_kv if per_view_pose else l_kv.mean(2)
        rgb_l_k = None
        if use_rgb:
            tgt = _resize_images(batch["images_tgt"], D)
            rgb_cmp = out.rgb.reshape(B, K, V, D, D, 3) + (
                1.0 - sil[..., None]) * cfg.rgb_background
            w = masks[:, None, :, :, :, None]  # [B, 1, V, D, D, 1]
            axes = (3, 4, 5) if per_view_pose else (2, 3, 4, 5)
            denom = (w.sum(axes) * 3.0).clamp_min(1.0)
            rgb_l_k = (w * (rgb_cmp - tgt[:, None]) ** 2).sum(axes) / denom
        ramp = rgb_ramp(cfg, step)
        comb_k = candidate_scores(cfg, l_k, rgb_l_k, ramp, batch_mesh)
        k_star = torch.argmin(comb_k, dim=1)  # [B] or [B, V]
        sel_w = None
        if cfg.pose_softmin_temp > 0 and cfg.pose_softmin_steps > 0:
            # softmin -> hard-min anneal: a softmax over the detached scores
            # at a relative temperature decaying to ~0
            frac = _clip01(1.0 - float(step) / cfg.pose_softmin_steps)
            scores = comb_k.detach()
            t_eff = cfg.pose_softmin_temp * frac * _batch_mean(
                scores, batch_mesh) + 1e-8
            sel_w = torch.softmax(-scores / t_eff, dim=1)
            proj_loss = torch.mean((sel_w * l_k).sum(1))
            metrics["sel_entropy"] = torch.mean(
                -(sel_w * torch.log(sel_w + 1e-12)).sum(1))
        else:
            # the winner alone receives projection gradient
            proj_loss = torch.mean(
                torch.take_along_dim(l_k, k_star[:, None], 1))
        total = cfg.proj_weight * proj_loss
        metrics["loss_proj"] = proj_loss
        metrics["cand_spread"] = torch.mean(
            comb_k.amax(1) - comb_k.amin(1))
        if per_view_pose:
            # gauge-coherence telemetry of the winners (a metric only)
            q_sel = torch.take_along_dim(
                q_full, k_star[:, None, :, None], 1).squeeze(1)  # [B, V, 4]
            metrics["gauge_spread_deg"] = torch.mean(gauge_spread_deg(
                q_sel.detach().transpose(0, 1),
                batch["quats"].transpose(0, 1)))
        if use_rgb:
            if sel_w is not None:
                rgb_loss = torch.mean((sel_w * rgb_l_k).sum(1))
            else:
                rgb_loss = torch.mean(
                    torch.take_along_dim(rgb_l_k, k_star[:, None], 1))
            total = total + cfg.rgb_weight * ramp * rgb_loss
            metrics["loss_rgb"] = rgb_loss
        student = "student_quat_views" if per_view_pose else "student_quat"
        if cfg.pose_student and student in preds:
            if per_view_pose:
                q_teacher = torch.take_along_dim(  # [B, V, 4]
                    cand_v, k_star[:, :, None, None], 2).squeeze(2)
            else:
                q_teacher = torch.take_along_dim(
                    cand, k_star[:, None, None], 1).squeeze(1)  # [B, 4]
            dot = (preds[student] * q_teacher.detach()).sum(-1)
            student_loss = torch.mean(1.0 - dot**2)  # sign-invariant
            sw = cfg.pose_student_weight
            if cfg.pose_student_warmup_steps > 0:
                sw = sw * _clip01(float(step) / cfg.pose_student_warmup_steps)
            total = total + sw * student_loss
            metrics["loss_student"] = student_loss
        if cfg.pose_anchor_weight > 0 and "correction_quats" in preds:
            # pull each candidate's pre-offset correction toward identity
            aw = cfg.pose_anchor_weight
            if cfg.pose_anchor_steps > 0:
                aw = aw * _clip01(1.0 - float(step) / cfg.pose_anchor_steps)
            corr = (preds["correction_quats_views"]
                    if per_view_pose and "correction_quats_views" in preds
                    else preds["correction_quats"])
            if cfg.pose_anchor_mode == "azimuth":
                # only the vertical-axis component, q_y = sin(theta / 2)
                anchor_loss = torch.mean(corr[..., 2] ** 2)
            else:
                anchor_loss = torch.mean(1.0 - corr[..., 0] ** 2)
            total = total + aw * anchor_loss
            metrics["loss_anchor"] = anchor_loss
        if cfg.pose_consistency_weight > 0 and "points_view2" in preds:
            # two input views of one model must decode to the same cloud
            cons = torch.mean(
                chamfer_distance(points, preds["points_view2"])["chamfer"])
            total = total + cfg.pose_consistency_weight * cons
            metrics["loss_consistency"] = cons
        win_idx = (  # into [B, K, V, D, D]
            k_star[:, None, :, None, None] if per_view_pose
            else k_star[:, None, None, None, None])
        if cfg.proj_depth and cfg.drc_weight > 0:
            d_win = torch.take_along_dim(
                depth.reshape(B, K, V, D, D), win_idx, 1).squeeze(1)
            d_loss = torch.mean(_masked_depth_loss(d_win, depths, masks))
            total = total + cfg.drc_weight * d_loss
            metrics["loss_depth"] = d_loss
        metrics["iou"] = _iou(
            torch.take_along_dim(sil, win_idx, 1).squeeze(1), masks)
        return total
