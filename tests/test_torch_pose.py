"""Predicted pose in the port against dpcx (CPU): the pose head and
``pose_only``, ``gauge_spread_deg`` and the chamfer distance, a train step
with per-view poses, the gauge reseed, and the served output surface (the
predicted-pose loss branch: ``tests/test_torch_pose_loss.py``).

Tolerances:
- the pose head and the model at ``compute_dtype: float32``: atol 1e-5
  (the same f32 matmuls summed in another order); at bfloat16 a mean abs
  error of at most 0.05 (tests/test_torch_models.py's bound: the two
  frameworks round bf16 at different places);
- ``gauge_spread_deg`` and the chamfer distance: rtol 1e-5;
- a train step with per-view poses: the parameters after the step atol
  1e-5 (Adam moves each by up to lr = 1e-4 a step).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.data.dataset import Dataset as JDataset
from dpcx.eval.chamfer import chamfer_distance as j_chamfer
from dpcx.eval.pose_metrics import gauge_spread_deg as j_gauge_spread
from dpcx.geometry.quaternion import quaternion_multiply as j_qmul
from dpcx.models.model_pc import ModelPointCloud as JModel
from dpcx.serve import ServingModel as JServingModel
from dpcx.train import _prep_batch
from dpcx.train import create_state as j_create_state
from dpcx.train import train_step as j_train_step
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import adam_state_from_optax, params_from_flax
from dpcx_torch.data.dataset import Dataset
from dpcx_torch.eval.chamfer import chamfer_distance
from dpcx_torch.eval.pose_metrics import gauge_spread_deg
from dpcx_torch.models.model_pc import ModelPointCloud
from dpcx_torch.nets import net_factory
from dpcx_torch.render import fused
from dpcx_torch.serve import ServingModel
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

POSE = Config(
    vox_size=16, mask_size=16, pc_num_points=256, image_size=16,
    encoder_filters=(8, 16), latent_dim=24, fc_hidden=32,
    pc_decoder_hidden=(32,), num_views=3, views_per_step=3, batch_size=2,
    compute_dtype="float32", pc_point_dropout=1.0, pc_relative_sigma=0.1,
    learning_rate=1e-4, predict_pose=True, pose_predict_num_candidates=4,
    pose_student=True, pose_student_weight=5.0, pose_from_views=True,
)


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_params(cfg):
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    return _np(JModel(cfg).init(jax.random.PRNGKey(1), dummy))


def _torch_model(cfg, flax_params):
    model = ModelPointCloud(_t(cfg))
    model.load_state_dict(params_from_flax(flax_params))  # strict
    return model


def _records(rng, cfg, models=4):
    """Random but well-formed records: blob masks, depths, unit quats."""
    V, D, S = cfg.num_views, cfg.vox_size, cfg.image_size
    yy, xx = np.mgrid[:D, :D] / D - 0.5
    r = rng.uniform(0.15, 0.35, (models, V, 1, 1))
    masks = ((yy**2 + xx**2) < r**2).astype(np.float32)
    q = rng.normal(size=(models, V, 4)).astype(np.float32)
    return {
        "images": rng.random((models, V, S, S, 3), np.float32),
        "masks": masks,
        "depths": np.where(masks > 0, rng.uniform(-0.3, 0.3, masks.shape),
                           1.0).astype(np.float32),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "gt_points": np.zeros((models, 1, 3), np.float32),
    }


HEADS = [
    ("f32", {}),
    ("f32_translation_no_offsets", {"predict_translation": True,
                                    "pose_candidate_offsets": False,
                                    "pose_predict_num_candidates": 8}),
    ("f32_no_student_k1", {"pose_student": False,
                           "pose_predict_num_candidates": 1}),
    ("bf16", {"compute_dtype": "bfloat16", "predict_translation": True}),
]


@pytest.mark.parametrize("name,kw", HEADS, ids=[h[0] for h in HEADS])
def test_pose_head_and_model_match_flax(name, kw, rng):
    """forward and pose_only through converted flax params: every output
    of the model and of the pose head alone."""
    cfg = POSE.replace(**kw)
    fp = _flax_params(cfg)
    model = _torch_model(cfg, fp).eval()
    imgs = rng.random((3, cfg.image_size, cfg.image_size, 3), np.float32)
    out_j = JModel(cfg).apply(fp, jnp.asarray(imgs))
    pose_j = JModel(cfg).apply(fp, jnp.asarray(imgs), method="pose_only")
    with torch.no_grad():
        out_t = model(torch.from_numpy(imgs))
        pose_t = model.pose_only(torch.from_numpy(imgs))
    assert out_t.keys() == set(out_j)
    assert pose_t.keys() == set(pose_j)
    assert ("student_quat" in pose_t) == cfg.pose_student
    assert ("translation" in pose_t) == cfg.predict_translation
    K = cfg.pose_predict_num_candidates
    assert pose_t["quats"].shape == (3, K, 4)
    for got, want in ((out_t, out_j), (pose_t, pose_j)):
        for k in got:
            a, b = got[k].float().numpy(), np.asarray(want[k])
            if cfg.compute_dtype == "float32":
                np.testing.assert_allclose(a, b, atol=1e-5, err_msg=k)
            else:
                assert np.abs(a - b).mean() <= 0.05, k
    torch.testing.assert_close(
        torch.linalg.vector_norm(pose_t["quats"], dim=-1), torch.ones(3, K))


def test_pose_params_and_adam_state_carry_across(rng):
    """params_from_flax walks pose_head/* into pose_head.fc0, .fc_quats,
    .fc_student, .fc_trans; optax's Adam state loads into the port's
    optimizer for every one of them."""
    cfg = POSE.replace(predict_translation=True)
    jstate = j_create_state(cfg, jax.random.PRNGKey(0))
    sd = params_from_flax(_np(jstate.params))
    heads = {k for k in sd if k.startswith("pose_head.")}
    assert heads == {f"pose_head.{m}.{p}" for m in
                     ("fc0", "fc_quats", "fc_student", "fc_trans")
                     for p in ("weight", "bias")}
    assert net_factory.get_network("pose_head").__name__ == "PoseHead"
    state = ttrain.create_state(_t(cfg), "cpu")
    state.model.load_state_dict(sd)  # strict
    adam = jstate.opt_state[0]
    named = adam_state_from_optax(_np(adam.mu), _np(adam.nu), adam.count)
    state.load_adam_state(named)
    assert set(named) == {n for n, _ in state.model.named_parameters()}
    p = state.model.pose_head.fc_quats.weight
    assert state.optimizer.state[p]["exp_avg"].shape == p.shape


def test_gauge_spread_and_chamfer_match_dpcx(rng):
    """gauge_spread_deg on random (widely spread: the sign-coherent
    chordal mean's hard case) and on nearly coherent residuals; the chamfer
    distance in one chunk and in several."""
    V, M = 4, 6
    cam = rng.normal(size=(V, M, 4)).astype(np.float32)
    pred = rng.normal(size=(V, M, 4)).astype(np.float32)
    cam /= np.linalg.norm(cam, axis=-1, keepdims=True)
    pred /= np.linalg.norm(pred, axis=-1, keepdims=True)
    g = rng.normal(size=(1, M, 4)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    coherent = np.asarray(j_qmul(jnp.asarray(cam), jnp.asarray(g)))
    coherent = coherent + 0.05 * rng.normal(size=coherent.shape)
    for p in (pred, coherent.astype(np.float32)):
        want = np.asarray(j_gauge_spread(jnp.asarray(p), jnp.asarray(cam)))
        got = gauge_spread_deg(torch.from_numpy(p), torch.from_numpy(cam))
        assert got.shape == (M,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    a = rng.uniform(-0.5, 0.5, (2, 300, 3)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (2, 500, 3)).astype(np.float32)
    for chunk in (2048, 128):
        want = j_chamfer(jnp.asarray(a), jnp.asarray(b), chunk)
        got = chamfer_distance(torch.from_numpy(a), torch.from_numpy(b),
                               chunk)
        assert got.keys() == set(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, err_msg=k)


def test_train_step_with_views_matches_dpcx(rng):
    """One dpcx step (so Adam's moments are warm), then one more step on
    both sides from the carried-over params and Adam state, with per-view
    pose inputs (images_v) and the consistency view: the loss, grad norm
    and parameters after the step."""
    cfg = POSE.replace(pose_consistency_weight=0.2)
    ds = JDataset(_records(rng, cfg), cfg)
    batches = [ds.batch(np.random.default_rng((0, s)), cfg.batch_size)
               for s in range(2)]
    assert "images_v" in batches[1] and "image_in2" in batches[1]
    key = jax.random.PRNGKey(1)
    jstate = j_create_state(cfg, jax.random.PRNGKey(0))
    jstate, _ = j_train_step(cfg, jstate, _prep_batch(batches[0], cfg), key)
    state = ttrain.create_state(_t(cfg), "cpu")
    state.model.load_state_dict(params_from_flax(_np(jstate.params)))
    adam = jstate.opt_state[0]
    state.load_adam_state(adam_state_from_optax(_np(adam.mu), _np(adam.nu),
                                                adam.count))
    state.step = int(jstate.step)
    jstate, m_j = j_train_step(cfg, jstate, _prep_batch(batches[1], cfg), key)
    m_t = ttrain.train_step(_t(cfg), state,
                            ttrain._prep_batch(batches[1], "cpu", _t(cfg)),
                            None)
    for k in ("loss_total", "loss_student", "loss_consistency",
              "gauge_spread_deg", "grad_norm"):
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_flax(_np(jstate.params))
    for n, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[n].numpy(), atol=1e-5,
                                   err_msg=n)


def test_batch_carries_pose_fields_on_device_records(rng):
    """quat_in, images_v and image_in2 gathered from device-resident
    records (gather_batch, the scan's gather) at the rows of Dataset.batch's
    draws (v_in2 after the target views), equal to the host batch."""
    cfg = _t(POSE.replace(pose_consistency_weight=0.2))
    ds = Dataset(_records(rng, cfg), cfg)
    records = ttrain.device_records(ds, "cpu")
    V = ds.num_views
    for step in range(3):
        m, v_in, v_tgt, v_in2 = ds.batch_indices(
            np.random.default_rng((cfg.seed, step)), cfg.batch_size)
        rows = torch.from_numpy(np.concatenate(
            [(m * V + v_in)[:, None], (m * V + v_in2)[:, None],
             m[:, None] * V + v_tgt], 1))
        host = ttrain.host_batch(cfg, ds, step, "cpu")
        dev = ttrain.gather_batch(cfg, records, rows)
        assert host.keys() == dev.keys() == {
            "image", "masks", "depths", "quats", "quat_in", "images_v",
            "image_in2"}
        for k in host:
            torch.testing.assert_close(dev[k], host[k], atol=0, rtol=0)


def _reseed_cfg(tmp_path, **kw):
    return _t(POSE.replace(**{
        "checkpoint_dir": str(tmp_path / "run"),
        "data_dir": str(tmp_path / "data"), "renderer": "pallas",
        "gauge_reseed_threshold_deg": 1.0, "gauge_reseed_check_step": 5,
        "gauge_reseed_max_retries": 1, "save_every": 2, "log_every": 1,
        **kw}))


def _metric_records(cfg):
    with open(f"{cfg.checkpoint_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("threshold", [1.0, 179.0])
def test_gauge_reseed_drive(threshold, tmp_path, rng):
    """The reseed drive shrunk to the CPU, through a resume that crosses
    the check step: an untrained model's spread (tens of degrees) fires at
    threshold 1.0: the record is written, the dead attempt's checkpoints
    are deleted, the model restarts from an init seeded seed + 7919, the
    logged steps restart from 1 (as dpcx's do: the step count goes
    backwards, ADVICE's train.py:653) and the run ends at its last step.
    At 179 degrees it never fires."""
    cfg = _reseed_cfg(tmp_path, gauge_reseed_threshold_deg=threshold)
    ds = Dataset(_records(rng, cfg), cfg)
    ttrain.train(cfg, dataset=ds, max_steps=3, device="cpu")
    state, hist = ttrain.train(cfg, dataset=ds, max_steps=7, device="cpu")
    recs = _metric_records(cfg)
    steps = [r["step"] for r in recs]
    fired = [r for r in recs if "gauge_reseed" in r]
    assert hist[-1]["step"] == 7 and state.step == 7
    # dead attempt: 2, 3 (the first call's last) and 4, deleted at the
    # reseed; the new attempt's 2, 4, 6, 7, the newest three kept
    assert ttrain.checkpoint_steps(cfg) == [4, 6, 7]
    if threshold > 90:
        assert steps == list(range(1, 8)) and not fired
        return
    assert len(fired) == 1 and fired[0]["gauge_reseed"] == 1.0
    assert fired[0]["step"] == 5 and fired[0]["gauge_spread_deg"] > 1.0
    assert steps == [1, 2, 3, 4, 5, 5, 1, 2, 3, 4, 5, 6, 7], steps
    # the new attempt's first step is one from dpcx's seed + 7919 init, on
    # the step-0 draws of the device-side stream (device_data)
    fresh = ttrain.create_state(cfg, "cpu", seed=cfg.seed + 7919)
    m = ttrain.train_steps_scan(cfg, fresh, ttrain.device_records(ds, "cpu"),
                                prng.prng_key(cfg.seed + 1), 1)
    assert recs[6]["step"] == 1
    assert recs[6]["loss_total"] == pytest.approx(m["loss_total"].item(),
                                                  rel=1e-6)


def test_gauge_reseed_reference_faults_match_dpcx(tmp_path, rng,
                                                  monkeypatch):
    """Two of dpcx's known reseed faults, which the port keeps (ADVICE):
    train.py:577, the attempt count is not in the checkpoints, so a run
    resumed below the check step fires again as attempt 1, the init being
    abandoned; train.py:640, a missing gauge_spread_deg reads as a healthy
    0 and never fires."""
    cfg = _reseed_cfg(tmp_path)
    ds = Dataset(_records(rng, cfg), cfg)
    ttrain.train(cfg, dataset=ds, max_steps=7, device="cpu")  # fires at 5
    # interrupted at step 7 of attempt 1; the newest checkpoint is 7, past
    # the check step: a resume from step 4 of attempt 1 fires again
    for s in ttrain.checkpoint_steps(cfg):
        if s != 4:
            (tmp_path / "run" / "ckpt" / f"{s}.pt").unlink()
    ttrain.train(cfg, dataset=ds, max_steps=6, device="cpu")
    fired = [r for r in _metric_records(cfg) if "gauge_reseed" in r]
    assert [r["gauge_reseed"] for r in fired] == [1.0, 1.0]

    real = ttrain.update  # the step of both streams

    def no_metric(*a, **k):
        m = real(*a, **k)
        m.pop("gauge_spread_deg")
        return m

    monkeypatch.setattr(ttrain, "update", no_metric)
    other = cfg.replace(checkpoint_dir=str(tmp_path / "other"))
    _, hist = ttrain.train(other, dataset=ds, max_steps=6, device="cpu")
    assert not any("gauge_reseed" in h for h in hist)
    assert hist[-1]["step"] == 6


@pytest.mark.parametrize("predict_pose", [True, False])
def test_serving_surface_matches_dpcx(predict_pose, rng):
    """A predicted-pose model serves exactly dpcx's keys: "pose" (the
    student quaternion), none of the pose head's internals; the values
    through converted params at f32."""
    cfg = POSE.replace(predict_pose=predict_pose,
                       pose_from_views=predict_pose)
    fp = _flax_params(cfg)
    imgs = rng.random((3, cfg.image_size, cfg.image_size, 3), np.float32)
    want = JServingModel(cfg, fp, batch_size=2)(imgs)
    got = ServingModel(_t(cfg), params_from_flax(fp), batch_size=2)(imgs)
    assert got.keys() == want.keys()
    assert ("pose" in got) == predict_pose
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert not any(fused.LAUNCHES.values())
