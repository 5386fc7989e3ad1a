"""Config knobs that dpcx runs on one device and the port once refused:
``shard_points`` (a no-op that warns on one process; over a world of
processes it shards the points and does not warn), ``eval_every`` without
an eval dataset (evaluates nothing) and ``device_records_models`` where
dpcx does not rotate blocks (CPU). Where dpcx does rotate, the port
rotates as it does (``tests/test_torch_train.py::test_train_refuses_unported``,
``tests/test_torch_stream.py``).

dpcx's side of ``shard_points`` runs in a one-device subprocess
(``JAX_PLATFORMS=cpu`` without the host device count that
``tests/conftest.py`` forces here, where dpcx would really shard the
points over 8 devices). Tolerances as ``tests/test_torch_train.py``:
``loss_total`` and ``grad_norm`` rtol 1e-4, parameters atol 1e-6.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dpcx_torch import config as tconfig
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config
from dpcx_torch.convert import params_from_flax
from dpcx_torch.data.dataset import Dataset, load_shards, save_shards
from dpcx_torch.utils import prng
from torch_ranks import dp_world, run_world
from torch_workers import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
# largecloud_pointshard's knobs (GT pose, renderer xla, shard_points) at a
# small size
SHARD_CFG = dict(
    vox_size=16, pc_num_points=256, image_size=16, encoder_filters=(8,),
    latent_dim=16, fc_hidden=16, pc_decoder_hidden=(16,), num_views=2,
    views_per_step=2, batch_size=2, compute_dtype="float32",
    renderer="xla", shard_points=True, pc_point_dropout=1.0,
    learning_rate=1e-4,
)
MESSAGE = ("shard_points on a single device is a no-op (the point axis has "
           "nothing to shard over)")

DPCX_SCRIPT = r"""
import sys
import warnings

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
from dpcx.config import Config
from dpcx.train import _prep_batch, create_state, train_step

assert len(jax.devices()) == 1, jax.devices()
inp = dict(np.load(sys.argv[1]))
out = {}


def flat(tree, prefix):
    for k, v in tree.items():
        if hasattr(v, "items"):
            flat(v, f"{prefix}{k}/")
        else:
            out[prefix + k] = np.asarray(v)


cfg = Config(**SHARD_CFG)
with warnings.catch_warnings(record=True) as seen:
    warnings.simplefilter("always")
    cfg.validate()
out["warnings"] = np.array([str(w.message) for w in seen])
state = create_state(cfg, jax.random.PRNGKey(0))
flat(jax.device_get(state.params), "init/")
state, m = train_step(cfg, state, _prep_batch(inp, cfg),
                      jax.random.PRNGKey(1))
out["loss_total"] = np.asarray(m["loss_total"])
out["grad_norm"] = np.asarray(m["grad_norm"])
flat(jax.device_get(state.params), "step/")
np.savez(sys.argv[2], **out)
""".replace("SHARD_CFG", repr(SHARD_CFG))


def _records(rng, cfg, models=4):
    """Well-formed records: blob masks, depths, unit quats."""
    V, D, S = cfg.num_views, cfg.vox_size, cfg.image_size
    yy, xx = np.mgrid[:D, :D] / D - 0.5
    r = rng.uniform(0.15, 0.35, (models, V, 1, 1))
    masks = ((yy**2 + xx**2) < r**2).astype(np.float32)
    q = rng.normal(size=(models, V, 4))
    return {
        "images": rng.random((models, V, S, S, 3)).astype(np.float32),
        "masks": masks,
        "depths": np.where(masks > 0, rng.uniform(-0.3, 0.3, masks.shape),
                           1.0).astype(np.float32),
        "quats": (q / np.linalg.norm(q, axis=-1, keepdims=True)
                  ).astype(np.float32),
        "gt_points": np.zeros((models, 1, 3), np.float32),
    }


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def dpcx_one_device(tmp_path_factory):
    """dpcx's validate() warnings, init and one training step of the small
    shard_points config, on one device; and the batch it took."""
    tmp = tmp_path_factory.mktemp("shard_points")
    cfg = Config(**SHARD_CFG)
    ds = Dataset(_records(np.random.default_rng(5), cfg), cfg)
    batch = ds.batch(np.random.default_rng((0, 0)), cfg.batch_size)
    np.savez(tmp / "in.npz", **batch)
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-c", DPCX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return batch, {k: f[k] for k in f.files}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("group", [False, True], ids=["no_group", "world_1"])
def test_shard_points_warns_on_one_process(group, dpcx_one_device):
    """On one process (no torch.distributed group, or a gloo world of one)
    validate() warns with dpcx's one-device message, word for word, and
    raises nothing."""
    _, ref = dpcx_one_device
    assert list(ref["warnings"]) == [MESSAGE]
    if group:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    try:
        assert tconfig.world_size() == 1
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            Config(**SHARD_CFG).validate()
            Config(**SHARD_CFG).replace(shard_points=False).validate()
    finally:
        if group:
            dist.destroy_process_group()
    assert [str(w.message) for w in seen] == [MESSAGE]


def test_shard_points_step_matches_dpcx_on_one_device(dpcx_one_device):
    """From dpcx's init, one training step of the shard_points config: the
    port renders unsharded, as dpcx's loss does on one device; loss,
    grad norm and parameters agree."""
    batch, ref = dpcx_one_device
    cfg = Config(**SHARD_CFG)
    state = ttrain.create_state(cfg, "cpu")
    state.model.load_state_dict(params_from_flax(_unflat(ref, "init/")))
    m = ttrain.train_step(cfg, state, ttrain._prep_batch(batch, "cpu", cfg),
                          prng.prng_key(1))
    for k in ("loss_total", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_flax(_unflat(ref, "step/"))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_shard_points_over_processes_trains(tmp_path):
    """In a gloo world of 2 the shard_points config trains with the points
    split over both ranks (every rank the whole batch) and does not warn:
    3 steps log the losses of the one-process run, which renders
    unsharded (rtol 1e-4), the same on both ranks."""
    cfg = Config(**SHARD_CFG).replace(log_every=1)
    save_shards(_records(np.random.default_rng(3), cfg),
                tmp_path / "shards.npz")
    run_world(dp_world, 2, tmp_path, {"train": {"shard": (
        dataclasses.asdict(cfg.replace(
            checkpoint_dir=str(tmp_path / "run"))), [3])}})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the one-process warning
        _, want = ttrain.train(
            cfg.replace(checkpoint_dir=str(tmp_path / "one")),
            dataset=Dataset(load_shards(tmp_path / "shards.npz"), cfg),
            max_steps=3, device="cpu", use_checkpoints=False)
    for rank in (0, 1):
        got = json.loads((tmp_path / f"shard_r{rank}.json").read_text())
        assert got["warnings"] == []
        hist = got["calls"][0]
        assert [h["step"] for h in hist] == [1, 2, 3]
        np.testing.assert_allclose([h["loss_total"] for h in hist],
                                   [h["loss_total"] for h in want],
                                   rtol=1e-4)


def _losses(cfg, tmp_path, name, rng_seed=3):
    cfg = cfg.replace(checkpoint_dir=str(tmp_path / name))
    ds = Dataset(_records(np.random.default_rng(rng_seed), cfg), cfg)
    _, hist = ttrain.train(cfg, dataset=ds, max_steps=3, device="cpu",
                           use_checkpoints=False)
    return [(h["step"], h["loss_total"]) for h in hist]


BASE = Config(**SHARD_CFG).replace(shard_points=False, log_every=1,
                                   pc_point_dropout=0.5)


@pytest.mark.parametrize("overrides", [
    {"eval_every": 5},
    {"eval_every": 1},
], ids=["eval_every_5", "eval_every_1"])
def test_eval_every_without_eval_dataset_trains_as_without(overrides,
                                                           tmp_path):
    """train takes no eval dataset yet (ROADMAP queue 1 item 1); without
    one dpcx evaluates nothing and eval_every only sets its device loop's
    chunk: the port trains the same losses as with eval_every 0."""
    assert _losses(BASE.replace(**overrides), tmp_path, "eval") == \
        _losses(BASE, tmp_path, "plain")


@pytest.mark.parametrize("overrides", [
    {"device_records_models": 4},  # all 4 models: nothing to rotate
    {"device_records_models": 9},
    {"device_records_models": 3, "device_data": False},
], ids=["all_models", "more_than_models", "host_fed"])
def test_device_records_models_without_rotation_trains(overrides, tmp_path):
    """Where dpcx does not rotate device-resident blocks (not device_data,
    or device_records_models >= num_models) the knob changes nothing: the
    same losses as device_records_models 0 on the same stream (the
    host-fed one without device_data, the device-side one with it)."""
    base = BASE.replace(device_data=overrides.get("device_data", True))
    assert _losses(BASE.replace(**overrides), tmp_path, "drm") == \
        _losses(base, tmp_path, "plain")
