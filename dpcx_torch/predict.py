"""Prediction and evaluation (port of ``dpcx/predict.py``).

Forward a held-out set through a trained model, write the clouds and
predicted poses to disk (npz, ``.mat`` or one PLY a model), and score them:
Chamfer both ways, voxel IoU at 16^3 and, with predicted pose, acc@30deg
and the median angular error after the canonical alignment.

``params`` is the model's ``state_dict`` or the ``ModelPointCloud`` itself;
the model runs on the device its tensors are on, in eval mode under
``torch.inference_mode``, and so do the metrics. Every function returns
what dpcx's returns, under dpcx's keys in dpcx's order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dpcx_torch.config import Config
from dpcx_torch.data.dataset import Dataset
from dpcx_torch.eval.chamfer import chamfer_distance
from dpcx_torch.eval.iou import voxel_iou
from dpcx_torch.eval.pose_metrics import (
    FLIP_QUAT,
    align_canonical_frame,
    gauge_spread_deg,
    pose_error_metrics,
    pose_error_metrics_up_to_flip,
)
from dpcx_torch.geometry.quaternion import (
    quaternion_conjugate,
    quaternion_multiply,
    quaternion_rotate,
)
from dpcx_torch.models.losses import _resize
from dpcx_torch.models.model_pc import ModelPointCloud
from dpcx_torch.render.project import pointcloud_project_fn, sigma_schedule


def load_model(cfg: Config, params) -> ModelPointCloud:
    """``params`` (a ``state_dict``, or the model) as a model in eval mode
    on the device of its tensors."""
    if isinstance(params, ModelPointCloud):
        return params.eval()
    device = next(iter(params.values())).device
    model = ModelPointCloud(cfg, device=device)
    model.load_state_dict(params)
    return model.eval()


def predict_batch(cfg: Config, model: ModelPointCloud,
                  images: torch.Tensor) -> dict[str, torch.Tensor]:
    """images [B, H, W, 3] -> predictions (points, scale, pose): "pose" is
    the student quaternion under ``predict_pose``."""
    preds = model(images)
    if cfg.predict_pose and "student_quat" in preds:
        preds["pose"] = preds["student_quat"]
    return preds


@torch.inference_mode()
def predict_dataset(
    cfg: Config,
    params,
    dataset: Dataset,
    view_idx: int = 0,
    batch_size: int = 16,
    out_path: str | Path | None = None,
) -> dict[str, np.ndarray]:
    """Forward view ``view_idx`` of every model of the set, in batches of
    ``batch_size`` (the tail padded with its last index, as dpcx pads it
    for a fixed jit shape); optionally write the float32 predictions to
    ``out_path``: ``.mat`` (one bundled file), ``.ply`` (one ASCII PLY a
    model, ``<stem>_0000.ply``, ...) or else npz."""
    model = load_model(cfg, params)
    device = next(model.parameters()).device
    M = dataset.num_models
    outs: dict[str, list[np.ndarray]] = {}
    for start in range(0, M, batch_size):
        idx = np.arange(start, min(start + batch_size, M))
        idx_p = np.concatenate(
            [idx, np.repeat(idx[-1:], batch_size - len(idx))])
        eb = dataset.eval_batch(idx_p, view_idx)
        images = torch.as_tensor(eb["image"], dtype=torch.float32)
        preds = predict_batch(cfg, model, images.to(device))
        for k in ("points", "pose", "scale", "rgb"):
            if k in preds:
                outs.setdefault(k, []).append(
                    preds[k][: len(idx)].float().cpu().numpy())
    out = {k: np.concatenate(v) for k, v in outs.items()}
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        if out_path.suffix == ".mat":
            # the reference's predict_eval writes .mat; one bundled file
            # keeps MATLAB/scipy eval scripts working
            from scipy.io import savemat

            savemat(str(out_path), out)
        elif out_path.suffix == ".ply":
            rgbs = out.get("rgb")
            for i, pts in enumerate(out["points"]):
                save_ply(out_path.with_name(f"{out_path.stem}_{i:04d}.ply"),
                         pts, None if rgbs is None else rgbs[i])
        else:
            np.savez_compressed(out_path, **out)
    return out


def save_ply(
    path: str | Path, points: np.ndarray, rgb: np.ndarray | None = None
) -> None:
    """Write one cloud as ASCII PLY ([N, 3] points, optional [N, 3]
    colours in [0, 1])."""
    pts = np.asarray(points, np.float32)
    lines = [
        "ply", "format ascii 1.0", f"element vertex {len(pts)}",
        "property float x", "property float y", "property float z",
    ]
    if rgb is not None:
        lines += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        cols = np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint8)
        body = [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}"
                for p, c in zip(pts, cols)]
    else:
        body = [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in pts]
    Path(path).write_text("\n".join(lines + ["end_header"] + body) + "\n")


def _mean_row(table: dict[str, dict[str, float]]) -> dict[str, float]:
    keys = next(iter(table.values())).keys()
    return {k: float(np.mean([v[k] for v in table.values() if k in v]))
            for k in keys}


def evaluate_categories(
    cfg: Config,
    params_by_category: dict[str, object],
    datasets: dict[str, Dataset],
    batch_size: int = 16,
) -> dict[str, dict[str, float]]:
    """A table of one model a category, each on its own set, and a mean
    row (the reference's per-category means)."""
    table = {cat: evaluate(cfg, params_by_category[cat], ds,
                           batch_size=batch_size)
             for cat, ds in datasets.items()}
    table["mean"] = _mean_row(table)
    return table


def evaluate_category_slices(
    cfg: Config,
    params,
    dataset: Dataset,
    batch_size: int = 16,
    view_idx: int | None = 0,
    flip_resolve: bool = False,
) -> dict[str, dict[str, float]]:
    """One jointly trained model on a "multi" dataset, evaluated on each
    category's records (by ``category_idx``), and a mean row."""
    from dpcx_torch.data.synthetic import CATEGORIES

    if "category_idx" not in dataset.records:
        raise ValueError(
            "per-category eval needs a dataset with category_idx "
            "(synthetic category='multi'); converted/external datasets "
            "don't carry category labels — evaluate them whole"
        )
    idx = np.asarray(dataset.records["category_idx"])
    if int(idx.max(initial=0)) >= len(CATEGORIES):
        raise ValueError(
            f"category_idx values exceed the known categories "
            f"{CATEGORIES}; cannot label the table rows"
        )
    model = load_model(cfg, params)
    table: dict[str, dict[str, float]] = {}
    for ci in sorted(set(idx.tolist())):
        sel = np.nonzero(idx == ci)[0]
        sub = Dataset({k: v[sel] for k, v in dataset.records.items()}, cfg)
        table[CATEGORIES[ci]] = evaluate(
            cfg, model, sub, batch_size=min(batch_size, len(sel)),
            view_idx=view_idx, flip_resolve=flip_resolve,
        )
    table["mean"] = _mean_row(table)
    return table


@torch.inference_mode()
def resolve_pose_flips(
    cfg: Config,
    points: np.ndarray,
    quats: np.ndarray,
    masks: np.ndarray,
    batch_size: int = 16,
    device="cuda",
) -> tuple[np.ndarray, float]:
    """Test-time mirror disambiguation from the input modality alone.

    Render each sample's predicted cloud under its pose q and under q o
    FLIP (the 180-degree vertical-axis flip), compare both silhouettes with
    the sample's own input-view mask, and keep the closer. The renders go
    through the plain ops (``renderer: xla``), as dpcx's do; the mask is
    resized with the loss's antialiased bilinear resize. Returns (resolved
    quats [M, 4], changed fraction).
    """
    M, D = quats.shape[0], cfg.vox_size
    sig = sigma_schedule(cfg, 10**9, device)
    rcfg = cfg.replace(renderer="xla")
    flip_q = FLIP_QUAT.to(device)
    flip = np.zeros(M, bool)
    for start in range(0, M, batch_size):
        idx = np.arange(start, min(start + batch_size, M))
        idx_p = np.concatenate(
            [idx, np.repeat(idx[-1:], batch_size - len(idx))])
        pts, q, m = (torch.as_tensor(a[idx_p], dtype=torch.float32)
                     .to(device) for a in (points, quats, masks))
        qf = quaternion_multiply(q, flip_q)
        out = pointcloud_project_fn(rcfg, torch.cat([pts, pts]),
                                    torch.cat([q, qf]), sig)
        md = _resize(m, D, "bilinear").repeat(2, 1, 1)
        e = ((out.silhouette - md) ** 2).mean((1, 2))
        b = q.shape[0]
        flip[idx] = (e[b:] < e[:b]).cpu().numpy()[: len(idx)]
    q_all = torch.as_tensor(quats, dtype=torch.float32)
    flipped = quaternion_multiply(q_all, FLIP_QUAT).numpy()
    return np.where(flip[:, None], flipped, quats), float(flip.mean())


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


@torch.inference_mode()
def evaluate(
    cfg: Config,
    params,
    dataset: Dataset,
    view_idx: int | None = 0,
    batch_size: int = 16,
    flip_resolve: bool = False,
    per_sample: bool = False,
) -> dict[str, float]:
    """Chamfer, voxel IoU and, with predicted pose, pose metrics over a
    dataset (the reference's predict_eval protocol).

    ``view_idx=None`` sweeps every view of every model and pools the
    predictions: sample i of view v sits at index v*M + i. Pose metrics
    come after the canonical alignment; the flip diagnostics score each
    sample up to the vertical-axis mirror after one re-alignment of the
    flip-corrected poses; a pooled multi-view eval also reports
    ``pose_gauge_spread_deg``. ``flip_resolve`` adds the metrics after
    ``resolve_pose_flips``. ``per_sample=True`` attaches a "per_sample"
    dict of plain lists: the aligned angular error, the object-side
    residual axis and angle (r = conj(aligned) o gt), the per-sample
    Chamfer, the source view, and with the pooled views the per-model gauge
    spread.
    """
    model = load_model(cfg, params)
    device = next(model.parameters()).device
    rec = dataset.records
    if view_idx is None:
        views = range(dataset.num_views)
        parts = [predict_dataset(cfg, model, dataset, v, batch_size)
                 for v in views]
        preds = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        gt_np = np.concatenate([rec["gt_points"] for _ in views])
        gt_quats_np = np.concatenate([rec["quats"][:, v] for v in views])
    else:
        preds = predict_dataset(cfg, model, dataset, view_idx, batch_size)
        gt_np = rec["gt_points"]
        gt_quats_np = rec["quats"][:, view_idx]

    def t(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)

    gt = t(gt_np)
    pred_pts = t(preds["points"])
    metrics: dict[str, float] = {}
    ps: dict[str, list] = {}
    if "pose" in preds:
        gt_quats = t(gt_quats_np)
        pred_quats = t(preds["pose"])
        # the pose is defined up to a global canonical rotation: estimate
        # it, then rotate the predicted clouds into the world frame before
        # Chamfer, p_world = R(conj(q_align)) p_canonical
        q_align, aligned = align_canonical_frame(pred_quats, gt_quats)
        pm = pose_error_metrics(aligned, gt_quats)
        metrics["pose_acc_30deg"] = float(pm["acc_30deg"])
        metrics["pose_median_err_deg"] = float(pm["median_err_deg"])
        # the mirror-gauge diagnostic, after one re-alignment round with
        # flip-corrected quats (half-flipped samples bias the alignment)
        flip_q = FLIP_QUAT.to(device)
        e0 = pm["angular_err_deg"]
        flipped = quaternion_multiply(aligned, flip_q)
        e1 = pose_error_metrics(flipped, gt_quats)["angular_err_deg"]
        corrected = torch.where((e1 < e0)[:, None], flipped, aligned)
        _, re_aligned = align_canonical_frame(corrected, gt_quats)
        fm = pose_error_metrics_up_to_flip(re_aligned, gt_quats)
        metrics["pose_acc_30deg_up_to_flip"] = float(
            fm["acc_30deg_up_to_flip"])
        metrics["pose_median_err_deg_up_to_flip"] = float(
            fm["median_err_deg_up_to_flip"])
        # the fraction before the correction (fm's is ~0 by construction)
        metrics["pose_flip_rate"] = float((e1 < e0).float().mean())
        if view_idx is None and dataset.num_views > 1:
            # GT-free gauge coherence: per-model cross-view dispersion of
            # conj(q_cam) o q_pred
            V, M = dataset.num_views, dataset.num_models
            spread = gauge_spread_deg(pred_quats.reshape(V, M, 4),
                                      gt_quats.reshape(V, M, 4))
            metrics["pose_gauge_spread_deg"] = float(spread.mean())
            if per_sample:
                ps["gauge_spread_deg"] = _np(spread).round(2).tolist()
        if per_sample:
            # the object-side residual r with aligned o r = gt, its sign
            # fixed to one hemisphere so axes compare across samples
            q_res = quaternion_multiply(quaternion_conjugate(aligned),
                                        gt_quats)
            q_res = torch.where(q_res[:, :1] < 0, -q_res, q_res)
            vec = q_res[:, 1:]
            norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
            axis = vec / norm.clamp_min(1e-12)
            e0_np, e1_np = _np(e0), _np(e1)
            ps["err_deg"] = e0_np.round(2).tolist()
            ps["err_deg_flip"] = np.minimum(e0_np, e1_np).round(2).tolist()
            ps["res_axis"] = _np(axis).round(4).tolist()
            ps["res_angle_deg"] = np.degrees(
                2.0 * np.arctan2(_np(norm[:, 0]), _np(q_res[:, 0]))
            ).round(2).tolist()
        if flip_resolve:
            # mirror disambiguation against each sample's own input mask
            masks = (np.concatenate([rec["masks"][:, v] for v in views])
                     if view_idx is None else rec["masks"][:, view_idx])
            rq, changed = resolve_pose_flips(
                cfg, preds["points"], preds["pose"], np.asarray(masks),
                batch_size, device=device)
            _, aligned_r = align_canonical_frame(t(rq), gt_quats)
            pr = pose_error_metrics(aligned_r, gt_quats)
            metrics["pose_acc_30deg_flip_resolved"] = float(pr["acc_30deg"])
            metrics["pose_median_err_deg_flip_resolved"] = float(
                pr["median_err_deg"])
            metrics["flip_resolve_changed"] = changed
        pred_pts = quaternion_rotate(
            pred_pts, quaternion_conjugate(q_align)[None])
    cd = chamfer_distance(pred_pts, gt)
    metrics.update({
        "chamfer": float(cd["chamfer"].mean()),
        "chamfer_pred_to_gt": float(cd["pred_to_gt"].mean()),
        "chamfer_gt_to_pred": float(cd["gt_to_pred"].mean()),
    })
    # volumetric overlap at D 16, the highest resolution the production
    # point budgets keep free of the sampling floor (eval/iou.py)
    metrics["iou_3d_16"] = float(voxel_iou(pred_pts, gt, 16).mean())
    if per_sample:
        ps["chamfer"] = _np(cd["chamfer"]).astype(float).round(6).tolist()
        ps["view"] = ([v for v in range(dataset.num_views)
                       for _ in range(dataset.num_models)]
                      if view_idx is None
                      else [view_idx] * int(pred_pts.shape[0]))
        metrics["per_sample"] = ps  # type: ignore[assignment]
    return metrics
