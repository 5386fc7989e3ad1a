"""The port's training path against dpcx's (CPU).

Tolerances (the observed errors, measured once, in brackets):
- loss with injected dropout weights: rtol 1e-4 (f32 renders summed in
  another order), d loss / d points atol 1e-6 (3e-8);
- train steps at ``compute_dtype: float32``: ``loss_total`` and
  ``grad_norm`` rtol 1e-4 (3e-7); parameters atol 1e-6 after each step
  (3e-8; Adam moves each by up to lr = 1e-4 a step, and a gradient
  element near 0 takes its m / sqrt(v) from two nearly-zero sums);
- the 30-step loss curve of the end-to-end run: rtol 1e-3 per step
  (2e-5), which Adam at lr 2e-3 carries from step to step.
"""

import dataclasses
import http.server
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcx.models.losses as jlosses
from dpcx.config import Config
from dpcx.data.dataset import Dataset as JDataset
from dpcx.data.dataset import load_shards as j_load_shards
from dpcx.parallel.mesh import make_mesh
from dpcx.train import _prep_batch
from dpcx.train import create_state as j_create_state
from dpcx.train import train as j_train
from dpcx.train import train_step as j_train_step
from dpcx_torch import cli
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.config import load_config, save_config
from dpcx_torch.convert import adam_state_from_optax, params_from_flax
from dpcx_torch.data.dataset import Dataset, save_shards
from dpcx_torch.data.synthetic import make_dataset
from dpcx_torch.models import losses as tlosses
from dpcx_torch.render import fused

TINY = Config(
    vox_size=12,
    pc_num_points=128,
    image_size=32,
    encoder_filters=(8, 16, 32),
    latent_dim=64,
    fc_hidden=64,
    pc_decoder_hidden=(64, 64),
    views_per_step=2,
    num_views=3,
    batch_size=8,
    learning_rate=2e-3,
    pc_point_dropout=1.0,
    pc_relative_sigma=0.12,
    pc_relative_sigma_end=0.08,
    sigma_anneal_steps=60,
    compute_dtype="float32",
)
SMALL = Config(
    vox_size=8, pc_num_points=64, image_size=16, encoder_filters=(8,),
    latent_dim=16, fc_hidden=16, pc_decoder_hidden=(16,), num_views=3,
    views_per_step=2, batch_size=3, compute_dtype="float32",
    pc_relative_sigma=0.15, proj_depth=True, drc_weight=0.1,
    learning_rate=1e-4,
)


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


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


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("renderer", ["pallas", "xla"])
@pytest.mark.parametrize("step", [0, 30_000])
def test_compute_loss_dropout_matches_dpcx(renderer, step, rng, monkeypatch):
    """train=True with point dropout, on the same injected weights: the
    loss and d loss / d points, with the weights repeated per view."""
    cfg = SMALL.replace(renderer=renderer, pc_point_dropout=0.3)
    B, N = 3, cfg.pc_num_points
    keep = rng.random((B, N)) < 0.5
    w = (keep / 0.5).astype(np.float32)
    calls = []

    def j_weights(key, batch, num_points, keep_prob):
        calls.append(float(keep_prob))
        return jnp.asarray(w)

    def t_weights(generator, batch, num_points, keep_prob):
        calls.append(float(keep_prob))
        return torch.from_numpy(w)

    monkeypatch.setattr(jlosses, "pc_point_dropout_weights", j_weights)
    monkeypatch.setattr(tlosses, "pc_point_dropout_weights", t_weights)
    pts = rng.uniform(-0.3, 0.3, (B, N, 3)).astype(np.float32)
    batch = {k: v[:B, :2] for k, v in _records(rng, cfg).items()
             if k in ("masks", "depths", "quats")}

    def j_loss(p):
        total, m = jlosses.compute_loss(
            cfg, {"points": p}, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(step), jax.random.PRNGKey(0), train=True)
        return total, m

    (total_j, m_j), g_j = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(pts))
    p_t = torch.from_numpy(pts).requires_grad_()
    total_t, m_t = tlosses.compute_loss(_t(cfg), {"points": p_t},
                                        _torch_batch(batch), step,
                                        torch.Generator(), train=True)
    total_t.backward()
    assert calls[0] == pytest.approx(calls[1])  # the same keep-prob
    assert m_t.keys() == set(m_j)
    np.testing.assert_allclose(total_t.item(), float(total_j), rtol=1e-4)
    assert np.abs(np.asarray(g_j)).max() > 0
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(g_j), atol=1e-6)


def _carried_state(cfg, jstate):
    """The port's TrainState from a dpcx TrainState: params and Adam state
    carried across by convert.py."""
    state = ttrain.create_state(_t(cfg), "cpu")
    state.model.load_state_dict(
        params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    adam = jstate.opt_state[0]
    state.load_adam_state(adam_state_from_optax(
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        adam.count))
    state.step = int(jstate.step)
    return state


def _assert_params_equal(state, jstate, atol):
    want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("dropout", [False, True])
def test_train_steps_match_dpcx(dropout, rng, monkeypatch):
    """dpcx create_state + one step (so Adam's moments are warm), then the
    port continues from the carried-over params and Adam state: 3 more
    steps on the same batches agree with dpcx's after each step."""
    cfg = SMALL.replace(renderer="xla",
                        pc_point_dropout=0.5 if dropout else 1.0)
    if dropout:  # the same injected weights on both sides
        w = ((rng.random((cfg.batch_size, cfg.pc_num_points)) < 0.5) / 0.5
             ).astype(np.float32)
        monkeypatch.setattr(jlosses, "pc_point_dropout_weights",
                            lambda *a: jnp.asarray(w))
        monkeypatch.setattr(tlosses, "pc_point_dropout_weights",
                            lambda *a: torch.from_numpy(w))
    ds = JDataset(_records(rng, cfg), cfg)
    batches = [ds.batch(np.random.default_rng((0, s)), cfg.batch_size)
               for s in range(4)]
    key = jax.random.PRNGKey(1)
    jstate = j_create_state(cfg, jax.random.PRNGKey(0))
    jstate, _ = j_train_step(cfg, jstate, _prep_batch(batches[0], cfg), key)
    state = _carried_state(cfg, jstate)
    _assert_params_equal(state, jstate, atol=0)
    for b in batches[1:]:
        jstate, m_j = j_train_step(cfg, jstate, _prep_batch(b, cfg), key)
        m_t = ttrain.train_step(_t(cfg), state, ttrain._prep_batch(b, "cpu"),
                                torch.Generator())
        assert state.step == int(jstate.step)
        for k in ("loss_total", "grad_norm"):
            np.testing.assert_allclose(m_t[k].item(), float(m_j[k]),
                                       rtol=1e-4, err_msg=k)
        _assert_params_equal(state, jstate, atol=1e-6)


def test_rgb_splats_train_step_matches_dpcx(rng, monkeypatch):
    """rgb_splats' loss (pc_rgb + pc_gauss, gsplat_impl pallas: dpcx's
    Pallas kernels in interpret mode, the port's plain version) with point
    dropout on the same injected weights, target images at twice the grid:
    after one dpcx step the port continues from the carried-over params and
    Adam state, and one more step agrees with dpcx's."""
    cfg = SMALL.replace(renderer="xla", proj_depth=False, drc_weight=0.0,
                        pc_rgb=True, pc_gauss=True, gsplat_impl="pallas",
                        pc_point_dropout=0.5)
    w = ((rng.random((cfg.batch_size, cfg.pc_num_points)) < 0.5) / 0.5
         ).astype(np.float32)
    monkeypatch.setattr(jlosses, "pc_point_dropout_weights",
                        lambda *a: jnp.asarray(w))
    monkeypatch.setattr(tlosses, "pc_point_dropout_weights",
                        lambda *a: torch.from_numpy(w))
    ds = JDataset(_records(rng, cfg), cfg)
    batches = [ds.batch(np.random.default_rng((0, s)), cfg.batch_size)
               for s in range(2)]
    assert batches[1]["images_tgt"].shape[-2] == 2 * cfg.vox_size
    key = jax.random.PRNGKey(1)
    jstate = j_create_state(cfg, jax.random.PRNGKey(0))
    jstate, _ = j_train_step(cfg, jstate, _prep_batch(batches[0], cfg), key)
    state = _carried_state(cfg, jstate)
    jstate, m_j = j_train_step(cfg, jstate, _prep_batch(batches[1], cfg), key)
    tbatch = ttrain._prep_batch(batches[1], "cpu", cfg.pc_rgb)
    assert "images_tgt" in tbatch
    m_t = ttrain.train_step(_t(cfg), state, tbatch, torch.Generator())
    assert "loss_rgb" in m_t
    for k in ("loss_total", "loss_rgb", "grad_norm"):
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    _assert_params_equal(state, jstate, atol=1e-6)


def test_train_step_takes_the_density_fn_it_is_handed(rng):
    """train_step's density_fn reaches the splat renderer: a step from the
    same init and batch through a recording wrapper of the plain version
    calls it once and equals the step through the default dispatcher (the
    plain version too, on CPU tensors)."""
    from dpcx_torch.render import aniso

    cfg = _t(SMALL).replace(renderer="xla", proj_depth=False, drc_weight=0.0,
                            pc_rgb=True, pc_gauss=True, gsplat_impl="pallas",
                            pc_point_dropout=1.0)
    batch = ttrain.batch_at(cfg, Dataset(_records(rng, cfg), cfg), 0, "cpu")
    calls = []

    def plain(mu, A6, w, rgb, rz, vox, acc_dtype="float32"):
        calls.append(acc_dtype)
        return aniso.aniso_density_reference(mu, A6, w, rgb, rz, vox)

    runs = []
    for fn in (None, plain):
        state = ttrain.create_state(cfg, "cpu", torch.Generator().manual_seed(0))
        m = ttrain.train_step(cfg, state, batch, None, density_fn=fn)
        runs.append((m, state.model.state_dict()))
    assert calls == ["float32"]
    (m_a, p_a), (m_b, p_b) = runs
    for k in ("loss_total", "loss_rgb", "grad_norm"):
        assert torch.equal(m_a[k], m_b[k]), k
    for k in p_a:
        assert torch.equal(p_a[k], p_b[k]), k


@pytest.mark.parametrize("pc_rgb", [True, False])
def test_batch_at_device_records_match_host_batch(pc_rgb, rng):
    """The batch gathered from device-resident records equals the host
    batch of the same step, the target views' images included with
    pc_rgb (the colour loss reads them) and left out without."""
    cfg = _t(SMALL).replace(pc_rgb=pc_rgb)
    ds = Dataset(_records(rng, cfg), cfg)
    records = ttrain.device_records(ds, "cpu")
    for step in (0, 5):
        host = ttrain.batch_at(cfg, ds, step, "cpu")
        dev = ttrain.batch_at(cfg, ds, step, "cpu", records)
        assert host.keys() == dev.keys()
        assert ("images_tgt" in host) == pc_rgb
        for k in host:
            assert torch.equal(host[k], dev[k]), k
    if pc_rgb:
        V = min(cfg.views_per_step, cfg.num_views)
        assert host["images_tgt"].shape == (cfg.batch_size, V,
                                            cfg.image_size, cfg.image_size, 3)


def test_train_end_to_end_follows_dpcx(tmp_path):
    """The port's train() on the TINY config (test_train_e2e.py's) for 30
    steps: the loss falls by at least 10%, and a dpcx run from the same
    init, on the same shards and batches, follows the same curve. The
    shared init enters the port as a step-0 checkpoint."""
    cfg = TINY.replace(checkpoint_dir=str(tmp_path / "run"), log_every=1,
                       save_every=1000, device_data=False)
    tcfg = _t(cfg)
    records = {k: v.numpy() for k, v in
               make_dataset(tcfg, 4, seed=0, gt_points=256).items()}
    save_shards(records, tmp_path / "shards.npz")  # the port's shards
    j_ds = JDataset(j_load_shards(tmp_path / "shards.npz"), cfg)
    jstate = j_create_state(cfg, jax.random.PRNGKey(cfg.seed))
    ttrain.save_checkpoint(tcfg, _carried_state(cfg, jstate))

    state, hist = ttrain.train(tcfg, dataset=Dataset(records, tcfg),
                               max_steps=30, device="cpu")
    assert state.step == 30 and [h["step"] for h in hist] == list(
        range(1, 31))
    losses = np.array([h["loss_total"] for h in hist])
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < 0.9 * losses[:5].mean(), losses

    _, j_hist = j_train(cfg, dataset=j_ds, max_steps=30,
                        mesh=make_mesh(cfg, devices=jax.devices()[:1]),
                        use_checkpoints=False)
    j_losses = np.array([h["loss_total"] for h in j_hist])
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert sorted(p.name for p in (tmp_path / "run" / "ckpt").iterdir()) \
        == ["0.pt", "30.pt"]


def _tiny_cfg(tmp_path, **kw):
    return _t(SMALL).replace(checkpoint_dir=str(tmp_path / "run"),
                             pc_point_dropout=0.5, save_every=2, log_every=1,
                             **kw)


def test_checkpoint_resume_equals_uninterrupted(tmp_path, rng):
    """7 steps, then 6 more from the step-7 checkpoint, end where 13
    uninterrupted steps end (batches and dropout are functions of
    (seed, step)); the newest 3 checkpoints are kept."""
    cfg = _tiny_cfg(tmp_path)
    ds = Dataset(_records(rng, cfg), cfg)
    ttrain.train(cfg, dataset=ds, max_steps=7, device="cpu")
    assert ttrain.checkpoint_steps(cfg) == [4, 6, 7]
    resumed, hist = ttrain.train(cfg, dataset=ds, max_steps=13, device="cpu")
    assert hist[0]["step"] == 8
    assert ttrain.checkpoint_steps(cfg) == [10, 12, 13]
    straight, _ = ttrain.train(
        cfg.replace(checkpoint_dir=str(tmp_path / "straight")), dataset=ds,
        max_steps=13, device="cpu")
    for (k, a), b in zip(resumed.params.items(), straight.params.values()):
        assert torch.equal(a, b), k
    summaries = sorted(p.name for p in
                       (tmp_path / "run" / "summaries").glob("*.png"))
    assert summaries[0] == "proj_0000002.png" and len(summaries) == 6
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines] == list(range(1, 14))


def test_checkpoints_refuse_orbax_and_changed_semantics(tmp_path, rng):
    cfg = _tiny_cfg(tmp_path)
    (tmp_path / "run" / "ckpt" / "100").mkdir(parents=True)  # Orbax's
    with pytest.raises(ValueError, match="Orbax"):
        ttrain.train(cfg, dataset=Dataset(_records(rng, cfg), cfg),
                     max_steps=1, device="cpu")
    with pytest.raises(ValueError, match="Orbax"):
        ttrain.load_checkpoint(cfg)

    cfg = cfg.replace(checkpoint_dir=str(tmp_path / "other"))
    ttrain.record_and_check_run_config(cfg)
    ttrain.record_and_check_run_config(cfg.replace(learning_rate=0.5))
    with pytest.raises(ValueError, match="pc_rgb"):
        ttrain.record_and_check_run_config(cfg.replace(pc_rgb=True))
    with pytest.raises(ValueError, match="pose_candidate_offsets"):
        ttrain.record_and_check_run_config(
            cfg.replace(pose_candidate_offsets=False), write=False)


@pytest.mark.parametrize("overrides,item", [
    ({"predict_pose": True}, "item 4"),
    ({"eval_every": 10}, "item 3"),
    ({"device_records_models": 4}, "item 10"),
    ({"gauge_reseed_threshold_deg": 5.0}, "item 4"),  # remat is ported
    ({"profile_dir": "prof"}, "item 8"),
    ({"shard_points": True}, "item 9"),
])
def test_train_refuses_unported(overrides, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.train(_tiny_cfg(tmp_path).replace(**overrides), device="cpu")


def test_cli_datagen_train_serve(tmp_path, monkeypatch, capsys):
    """datagen, train --steps 3, then serve: the server holds the trained
    model's parameters and returns its points."""
    cfg = _t(SMALL).replace(checkpoint_dir=str(tmp_path / "run"),
                            data_dir=str(tmp_path / "data"),
                            renderer="pallas", save_every=2, log_every=1,
                            pc_point_dropout=0.5)
    path = tmp_path / "tiny.yaml"
    save_config(cfg, path)
    dev = ["--device", "cpu"]
    cli.main(["datagen", "-f", str(path), "-n", "3", *dev])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"models": 3, "views": 3, "dir": cfg.data_dir}
    assert (tmp_path / "data" / "chair_m3_v3_d8_s0.npz").exists()

    cli.main(["train", "-f", str(path), "-n", "3", "--steps", "3", *dev])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 3 and np.isfinite(out["loss_total"])
    assert ttrain.checkpoint_steps(load_config(path)) == [2, 3]
    assert not any(fused.LAUNCHES.values())

    served = {}
    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever",
                        lambda self, *a, **k: served.setdefault("srv", self))
    cli.main(["serve", "-f", str(path), "--port", "0", "--batch", "2", *dev])
    model = served["srv"].model
    trained = ttrain.load_checkpoint(load_config(path))["params"]
    for k, v in model.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    imgs = np.random.default_rng(0).random((2, 16, 16, 3), np.float32)
    ref = ttrain.create_state(cfg, "cpu")
    ref.model.load_state_dict(trained)
    with torch.no_grad():
        want = ref.model(torch.from_numpy(imgs))["points"].numpy()
    np.testing.assert_allclose(model(imgs)["points"], want, atol=1e-6)
