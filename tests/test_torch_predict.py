"""The port's predict/eval path against dpcx's (CPU): ``evaluate`` in every
branch on flax params carried across, the per-category table, the files
``predict_dataset`` writes, the periodic eval of ``train``, and the
``eval``/``predict`` verbs.

The inputs are the port's synthetic records (real shapes, GT clouds and
masks; the same numpy arrays go to both packages). Tolerances:
- pose metrics and Chamfer: rtol 1e-5 (the same f32 forward and metrics,
  summed in another order);
- ``iou_3d_16``: 1e-2 absolute. The two forwards differ by up to ~1e-5,
  so a predicted point within that distance of a cell boundary may round
  into the neighbouring cell (``voxel_iou`` itself is exact on identical
  points: tests/test_torch_eval.py);
- the per-sample lists, rounded as dpcx rounds them (2 decimals for
  degrees, 4 for axes, 6 for Chamfer): one unit of the last decimal;
- the up-to-flip metrics, where the flip-corrected re-alignment's argmin
  picks another candidate than dpcx's: rtol 1e-5 to dpcx's own metrics
  re-aligned at the port's pick, and only under a tie, as chip_smoke.py's
  ``is_tie`` holds one: the two picks more than 2e-3 and at most 2 degrees
  apart, dpcx's mean errors at them within 5e-7 rad
  (tests/test_torch_eval.py's bound for a tie f32 cannot order). dpcx's
  shards at seed 3 hold one (pose_view0: picks 0.3 degrees apart, mean
  errors 1.8e-7 rad apart);
- the periodic eval after training steps: rtol 1e-4 (Adam carries the
  step-to-step differences, tests/test_torch_train.py).
"""

import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.data.dataset import Dataset as JDataset
from dpcx.models.model_pc import ModelPointCloud as JModel
from dpcx.parallel.mesh import make_mesh
from dpcx.predict import evaluate as j_evaluate
from dpcx.predict import evaluate_category_slices as j_slices
from dpcx.predict import predict_dataset as j_predict_dataset
from dpcx.train import create_state as j_create_state
from dpcx.train import train as j_train
from dpcx_torch import cli
from dpcx_torch import predict
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.config import load_config, save_config
from dpcx_torch.convert import params_from_flax
from dpcx_torch.data.dataset import Dataset
from dpcx_torch.data.synthetic import make_dataset
from torch_workers import share_cores

share_cores()

BASE = Config(
    vox_size=16, mask_size=16, pc_num_points=256, image_size=16,
    encoder_filters=(8, 16), latent_dim=24, fc_hidden=32,
    pc_decoder_hidden=(32,), num_views=3, views_per_step=3, batch_size=2,
    compute_dtype="float32", pc_point_dropout=1.0, pc_relative_sigma=0.1,
    learning_rate=1e-4,
)
# tests/test_torch_pose.py's POSE config
POSE = BASE.replace(predict_pose=True, pose_predict_num_candidates=4,
                    pose_student=True, pose_student_weight=5.0,
                    pose_from_views=True)
RTOL = 1e-5


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


def _flax_params(cfg):
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    return jax.tree.map(np.asarray,
                        JModel(cfg).init(jax.random.PRNGKey(1), dummy))


def _records(cfg, models=5, category=None, seed=3):
    return {k: v.numpy() for k, v in make_dataset(
        _t(cfg), models, seed=seed, category=category,
        gt_points=200).items()}


# the metrics of the flip-corrected re-alignment alone
REALIGNED = ("pose_acc_30deg_up_to_flip", "pose_median_err_deg_up_to_flip")
# a tie of the re-alignment (chip_smoke.py's is_tie): two picks more than
# TIE_MIN_DEG and at most TIE_DEG apart, dpcx's mean errors at them within
# TIE_GAP rad
TIE_MIN_DEG, TIE_DEG, TIE_GAP = 2e-3, 2.0, 5e-7


def _realignment_at_port_pick(cfg, fp, rec, params):
    """evaluate's second alignment (view 0: each aligned pose, or its
    180-degree flip where that is nearer the GT, aligned again) on each
    side; returns the rotation between the port's pick and dpcx's
    (degrees), dpcx's mean errors at the two picks apart (rad), and dpcx's
    up-to-flip metrics at the port's pick in place of its own."""
    from dpcx.eval import pose_metrics as jpm
    from dpcx.geometry.quaternion import quaternion_angular_distance as j_ad
    from dpcx.geometry.quaternion import quaternion_multiply as j_qmul
    from dpcx_torch.eval import pose_metrics as tpm
    from dpcx_torch.geometry.quaternion import quaternion_multiply

    gq = rec["quats"][:, 0].astype(np.float32)
    pose_j = j_predict_dataset(cfg, fp, JDataset(rec, cfg), 0, 2)["pose"]
    pose_t = predict.predict_dataset(_t(cfg), params,
                                     Dataset(rec, _t(cfg)), 0, 2)["pose"]

    def corrected(pm, qmul, align, p, g, flip):
        _, al = align(p, g)
        fl = qmul(al, flip)
        e0, e1 = (pm(a, g)["angular_err_deg"] for a in (al, fl))
        return al, fl, e1 < e0

    al, fl, pick = corrected(jpm.pose_error_metrics, j_qmul,
                             jpm.align_canonical_frame,
                             jnp.asarray(pose_j), jnp.asarray(gq),
                             jpm.FLIP_QUAT[None])
    c_j = jnp.where(pick[:, None], fl, al)
    al, fl, pick = corrected(tpm.pose_error_metrics, quaternion_multiply,
                             tpm.align_canonical_frame,
                             torch.from_numpy(np.asarray(pose_t)),
                             torch.from_numpy(gq), tpm.FLIP_QUAT)
    c_t = torch.where(pick[:, None], fl, al)
    q_j, _ = jpm.align_canonical_frame(c_j, jnp.asarray(gq))
    q_t, _ = tpm.align_canonical_frame(c_t, torch.from_numpy(gq))
    q_t = jnp.asarray(q_t.numpy())

    def mean_err(q):
        aligned = j_qmul(c_j, q[None])
        return float(jnp.mean(j_ad(aligned, jnp.asarray(gq))))

    # 2 arccos |a . b| in float64, as 4 atan2(|a - b|, |a + b|)
    a, b = np.float64(q_j), np.float64(q_t)
    b = b * np.sign(a @ b)
    deg = np.degrees(4 * np.arctan2(np.linalg.norm(a - b),
                                    np.linalg.norm(a + b)))
    fm = jpm.pose_error_metrics_up_to_flip(j_qmul(c_j, q_t[None]),
                                           jnp.asarray(gq))
    at_pick = {
        "pose_acc_30deg_up_to_flip": float(fm["acc_30deg_up_to_flip"]),
        "pose_median_err_deg_up_to_flip": float(
            fm["median_err_deg_up_to_flip"]),
    }
    return float(deg), abs(mean_err(q_t) - mean_err(q_j)), at_pick


def _assert_metrics_match(got, want, realignment=None):
    """Key for key, in dpcx's order, at this file's tolerances. Where the
    up-to-flip metrics miss dpcx's, ``realignment()``
    (_realignment_at_port_pick) must show a tie, and they are held to
    dpcx's at the port's pick."""
    assert list(got) == list(want)
    missed = [k for k in REALIGNED if k in want and not np.allclose(
        got[k], want[k], rtol=RTOL, atol=1e-7)]
    if missed:
        assert realignment is not None, missed
        deg, gap, at_pick = realignment()
        print(f"re-alignment tie: {missed} miss; picks {deg:.4f} degrees "
              f"apart, dpcx's mean errors at them {gap:.3e} rad apart; "
              f"dpcx at the port's pick {at_pick}")
        assert TIE_MIN_DEG < deg <= TIE_DEG and gap <= TIE_GAP, (
            missed, deg, gap)
        for k in missed:
            np.testing.assert_allclose(got[k], at_pick[k], rtol=RTOL,
                                       atol=1e-7, err_msg=k)
    for k, w in want.items():
        if k in missed:
            continue  # held above to dpcx's at the port's pick
        if k == "per_sample":
            _assert_per_sample_match(got[k], w)
        elif k == "iou_3d_16":
            assert abs(got[k] - w) <= 1e-2, (got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=1e-7,
                                       err_msg=k)


def _assert_per_sample_match(got, want):
    assert list(got) == list(want)
    last_unit = {"res_axis": 1e-4, "chamfer": 1e-6, "view": 0}
    for k, w in want.items():
        np.testing.assert_allclose(
            np.asarray(got[k], float), np.asarray(w, float), rtol=RTOL,
            atol=last_unit.get(k, 1e-2) * 1.001, err_msg=k)


EVALS = [
    ("gt_view0", BASE, {}),
    ("gt_all_views", BASE, {"view_idx": None, "per_sample": True}),
    ("pose_view0", POSE, {"per_sample": True, "flip_resolve": True}),
    ("pose_all_views", POSE, {"view_idx": None, "flip_resolve": True,
                              "per_sample": True}),
]


@pytest.mark.parametrize("name,cfg,kw", EVALS, ids=[e[0] for e in EVALS])
def test_evaluate_matches_dpcx(name, cfg, kw):
    """evaluate on the same flax params and records: every key dpcx
    reports, in its order (5 models in batches of 2: a padded tail)."""
    fp = _flax_params(cfg)
    rec = _records(cfg)
    want = j_evaluate(cfg, fp, JDataset(rec, cfg), batch_size=2, **kw)
    tcfg = _t(cfg)
    params = params_from_flax(fp)
    got = predict.evaluate(tcfg, params, Dataset(rec, tcfg),
                           batch_size=2, **kw)
    _assert_metrics_match(
        got, want,
        (lambda: _realignment_at_port_pick(cfg, fp, rec, params))
        if kw.get("view_idx", 0) == 0 else None)
    assert ("pose_acc_30deg" in got) == cfg.predict_pose
    assert ("pose_gauge_spread_deg" in got) == (
        cfg.predict_pose and kw.get("view_idx", 0) is None)
    assert 0.0 < got["iou_3d_16"] <= 1.0 and got["chamfer"] > 0.0
    if kw.get("per_sample"):
        rows = 5 * (3 if kw.get("view_idx", 0) is None else 1)
        assert len(got["per_sample"]["chamfer"]) == rows
        assert json.dumps(got)  # plain lists and floats


def test_evaluate_category_slices_match_dpcx():
    """One model over a "multi" set (chair, car, airplane, chair, ...):
    each category's row and the mean row equal dpcx's; evaluate_categories
    is each category's evaluate and their mean; sets with no or unknown
    category labels are refused."""
    cfg = POSE
    fp = _flax_params(cfg)
    rec = _records(cfg, models=6, category="multi")
    assert rec["category_idx"].tolist() == [0, 1, 2, 0, 1, 2]
    want = j_slices(cfg, fp, JDataset(rec, cfg), view_idx=None)
    tcfg = _t(cfg)
    params = params_from_flax(fp)
    ds = Dataset(rec, tcfg)
    got = predict.evaluate_category_slices(tcfg, params, ds, view_idx=None)
    assert list(got) == list(want) == ["chair", "car", "airplane", "mean"]
    for cat in want:
        _assert_metrics_match(got[cat], want[cat])

    sets = {c: Dataset({k: v[i::3] for k, v in rec.items()}, tcfg)
            for i, c in enumerate(("chair", "car"))}
    table = predict.evaluate_categories(
        tcfg, {c: params for c in sets}, sets, batch_size=2)
    for c, sub in sets.items():
        assert table[c] == predict.evaluate(tcfg, params, sub, batch_size=2)
    assert table["mean"]["chamfer"] == pytest.approx(
        np.mean([table[c]["chamfer"] for c in sets]))

    no_labels = {k: v for k, v in rec.items() if k != "category_idx"}
    with pytest.raises(ValueError, match="category_idx"):
        predict.evaluate_category_slices(tcfg, params,
                                         Dataset(no_labels, tcfg))
    bad = dict(rec, category_idx=rec["category_idx"] + 7)
    with pytest.raises(ValueError, match="exceed the known categories"):
        predict.evaluate_category_slices(tcfg, params, Dataset(bad, tcfg))


def _ply_numbers(path: Path):
    text = path.read_text()
    header, body = text.split("end_header\n")
    return header, np.array([[float(x) for x in line.split()]
                             for line in body.splitlines()])


@pytest.mark.parametrize("suffix", [".npz", ".mat", ".ply"])
def test_predict_dataset_files_match_dpcx(suffix, tmp_path):
    """The files dpcx writes, from the same params and records (points,
    student pose, scale and colours; 5 models in batches of 2)."""
    cfg = POSE.replace(pc_rgb=True, predict_scale=True)
    fp = _flax_params(cfg)
    rec = _records(cfg)
    tcfg = _t(cfg)
    j_out = j_predict_dataset(cfg, fp, JDataset(rec, cfg), view_idx=1,
                              batch_size=2, out_path=tmp_path / f"j{suffix}")
    out = predict.predict_dataset(tcfg, params_from_flax(fp),
                                  Dataset(rec, tcfg), view_idx=1,
                                  batch_size=2,
                                  out_path=tmp_path / f"t{suffix}")
    assert list(out) == list(j_out) == ["points", "pose", "scale", "rgb"]
    for k in out:
        assert out[k].dtype == np.float32 and out[k].shape[0] == 5
        np.testing.assert_allclose(out[k], j_out[k], atol=1e-5, err_msg=k)
    if suffix == ".npz":
        with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") \
                as j:
            assert sorted(t.files) == sorted(j.files)
            for k in j.files:
                np.testing.assert_allclose(t[k], j[k], atol=1e-5)
    elif suffix == ".mat":
        from scipy.io import loadmat

        t, j = loadmat(tmp_path / "t.mat"), loadmat(tmp_path / "j.mat")
        keys = [k for k in j if not k.startswith("__")]
        assert sorted(keys) == sorted(k for k in t if not k.startswith("__"))
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], atol=1e-5)
    else:
        names = sorted(p.name for p in tmp_path.glob("t_*.ply"))
        assert names == [f"t_{i:04d}.ply" for i in range(5)]
        for i in range(5):
            h_t, n_t = _ply_numbers(tmp_path / f"t_{i:04d}.ply")
            h_j, n_j = _ply_numbers(tmp_path / f"j_{i:04d}.ply")
            assert h_t == h_j and "property uchar red" in h_t
            assert n_t.shape == (cfg.pc_num_points, 6)
            # 6 decimals; a colour may round to the next byte
            np.testing.assert_allclose(n_t[:, :3], n_j[:, :3], atol=2e-5)
            np.testing.assert_allclose(n_t[:, 3:], n_j[:, 3:], atol=1)


def test_train_periodic_eval_follows_dpcx(tmp_path):
    """train(..., eval_dataset=) with eval_every 2 over 5 steps: val_*
    records at steps 2 and 4, as dpcx's host-fed loop writes them, with
    its values; the training records are those of a run without eval."""
    cfg = BASE.replace(checkpoint_dir=str(tmp_path / "run"), log_every=1,
                       save_every=1000, eval_every=2, device_data=False,
                       batch_size=3)
    tcfg = _t(cfg)
    rec = _records(cfg, models=4, seed=0)
    held = _records(cfg, models=3, seed=1)
    jstate = j_create_state(cfg, jax.random.PRNGKey(cfg.seed))
    init = ttrain.create_state(tcfg, "cpu")
    init.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    ttrain.save_checkpoint(tcfg, init)
    _, hist = ttrain.train(tcfg, dataset=Dataset(rec, tcfg), max_steps=5,
                           device="cpu", eval_dataset=Dataset(held, tcfg))
    jcfg = cfg.replace(checkpoint_dir=str(tmp_path / "jrun"))
    _, j_hist = j_train(jcfg, dataset=JDataset(rec, cfg), max_steps=5,
                        mesh=make_mesh(cfg, devices=jax.devices()[:1]),
                        use_checkpoints=False,
                        eval_dataset=JDataset(held, cfg))

    def val(h):
        return [r for r in h if any(k.startswith("val_") for k in r)]

    got, want = val(hist), val(j_hist)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["step", "val_chamfer",
                                      "val_chamfer_pred_to_gt",
                                      "val_chamfer_gt_to_pred",
                                      "val_iou_3d_16"]
        for k in w:
            tol = dict(atol=1e-2) if k == "val_iou_3d_16" else dict(rtol=1e-4)
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)
    recs = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "val_chamfer" in r] == [2, 4]
    losses = [h["loss_total"] for h in hist if "loss_total" in h]
    np.testing.assert_allclose(
        losses, [h["loss_total"] for h in j_hist if "loss_total" in h],
        rtol=1e-4)


EVAL_KEYS = [
    "pose_acc_30deg", "pose_median_err_deg", "pose_acc_30deg_up_to_flip",
    "pose_median_err_deg_up_to_flip", "pose_flip_rate",
    "pose_gauge_spread_deg", "pose_acc_30deg_flip_resolved",
    "pose_median_err_deg_flip_resolved", "flip_resolve_changed", "chamfer",
    "chamfer_pred_to_gt", "chamfer_gt_to_pred", "iou_3d_16", "per_sample",
]


def test_cli_eval_and_predict(tmp_path, capsys):
    """datagen, train --steps 2, then eval (view 0; --all-views
    --flip-resolve --per-sample; --per-category on a multi set) and
    predict -o: dpcx's JSON lines from the step-2 checkpoint on a held-out
    set drawn at seed + 1. --per-category with --per-sample is refused in
    dpcx's words, and so is an Orbax checkpoint."""
    cfg = _t(POSE).replace(checkpoint_dir=str(tmp_path / "run"),
                           data_dir=str(tmp_path / "data"), category="multi",
                           save_every=2, log_every=1)
    path = str(tmp_path / "tiny.yaml")
    save_config(cfg, path)
    dev = ["--device", "cpu"]
    cli.main(["datagen", "-f", path, "-n", "3", *dev])
    cli.main(["train", "-f", path, "-n", "3", "--steps", "2", *dev])
    assert ttrain.checkpoint_steps(load_config(path)) == [2]
    capsys.readouterr()

    def run(*args):
        cli.main([*args, "-f", path, "-n", "3", *dev])
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    view0 = run("eval")
    assert list(view0) == [k for k in EVAL_KEYS if k not in (
        "pose_gauge_spread_deg", "pose_acc_30deg_flip_resolved",
        "pose_median_err_deg_flip_resolved", "flip_resolve_changed",
        "per_sample")]
    assert (tmp_path / "data" / "multi_m3_v3_d16_s1.npz").exists()
    full = run("eval", "--all-views", "--flip-resolve", "--per-sample")
    assert list(full) == EVAL_KEYS
    assert all(np.isfinite(v) for k, v in full.items() if k != "per_sample")
    assert full["per_sample"]["view"] == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    params = ttrain.load_checkpoint(cfg)["params"]
    held = Dataset({k: v.numpy() for k, v in make_dataset(
        cfg, 3, seed=cfg.seed + 1).items()}, cfg)
    assert view0 == predict.evaluate(cfg, params, held)
    table = run("eval", "--per-category")
    assert list(table) == ["chair", "car", "airplane", "mean"]

    with pytest.raises(SystemExit, match="--per-sample is not supported "
                                         "with --per-category"):
        run("eval", "--per-category", "--per-sample")

    out = tmp_path / "preds" / "p.npz"
    assert run("predict", "-o", str(out)) == {"num_models": 3,
                                               "out": str(out)}
    with np.load(out) as f:
        assert f["points"].shape == (3, cfg.pc_num_points, 3)
        assert f["pose"].shape == (3, 4)

    (tmp_path / "run" / "ckpt" / "100").mkdir()  # dpcx's Orbax layout
    for verb in ("eval", "predict"):
        with pytest.raises(SystemExit, match=re.escape("cannot read")):
            run(verb)
