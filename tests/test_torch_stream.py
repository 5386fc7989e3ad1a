"""The port's device-side batch stream against dpcx's (CPU).

With ``device_data`` (every shipped config) dpcx trains through
``train_steps_scan`` (``dpcx/train.py:129-217``), drawing each step's batch
and dropout key with ``jax.random`` inside the scan, and rotates blocks of
``device_records_models`` models onto the device (:353-378, :560-605). The
port draws the same bits (``utils/prng.py``), so:

- the scan's gather rows (model ids, input views, target views, the second
  input view) equal jax's through dpcx's own code order, bitwise;
- ``train()`` follows dpcx's default ``train()`` from the same init, with
  point dropout on, without and with block rotation: ``loss_total`` within
  rtol 1e-3 per logged step (``test_train_end_to_end_follows_dpcx``'s
  tolerance: f32 sums in another order, which Adam carries from step to
  step), the logged steps equal;
- a run resumed under rotation ends bitwise where the uninterrupted run
  ends.

dpcx runs on a one-device mesh: ``tests/conftest.py`` forces 8 host
devices, and dpcx's multi-device scan folds the device index into each
dropout key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.data.dataset import Dataset as JDataset
from dpcx.data.dataset import load_shards as j_load_shards
from dpcx.parallel.mesh import make_mesh
from dpcx.train import create_state as j_create_state
from dpcx.train import train as j_train
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import adam_state_from_optax, params_from_flax
from dpcx_torch.data.dataset import Dataset, save_shards
from dpcx_torch.data.synthetic import make_dataset
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

# test_torch_train.py's TINY (test_train_e2e.py's), dropout on
TINY = Config(
    vox_size=12, pc_num_points=128, image_size=32,
    encoder_filters=(8, 16, 32), latent_dim=64, fc_hidden=64,
    pc_decoder_hidden=(64, 64), views_per_step=2, num_views=3,
    batch_size=8, learning_rate=2e-3, pc_point_dropout=0.5,
    pc_relative_sigma=0.12, pc_relative_sigma_end=0.08,
    sigma_anneal_steps=60, compute_dtype="float32", device_data=True,
)


def _key(jkey) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jkey))


def _dpcx_rows(key, step, B, M, V, V_use, with_in2):
    """The scan body's draws in dpcx's code order (dpcx/train.py:153-190),
    as gather rows [B, 2 + V_use] of the records viewed as [M * V, ...]
    (take_mv's rows_in, m V + v_in2, rows_tgt), and the dropout key."""
    kk = jax.random.fold_in(key, step)
    k_m, k_vin, k_tgt, k_drop = jax.random.split(kk, 4)
    m = jax.random.randint(k_m, (B,), 0, M)
    v_in = jax.random.randint(k_vin, (B,), 0, V)
    perm = jnp.argsort(jax.random.uniform(k_tgt, (B, V)), axis=1)[:, :V_use]
    if with_in2:
        k_vin2 = jax.random.fold_in(kk, 7)
        v_in2 = (v_in + 1 + jax.random.randint(k_vin2, (B,), 0, V - 1)) % V
        in2 = m * V + v_in2
    else:
        in2 = jnp.full_like(m, -1)
    rows = jnp.concatenate(
        [(m * V + v_in)[:, None], in2[:, None], m[:, None] * V + perm], 1)
    return np.asarray(rows).astype(np.int64), _key(k_drop)


@pytest.mark.parametrize("B,M,V,views_per_step", [
    (8, 200, 5, 4),  # car_64_depth at the default 200 models
    (16, 32, 5, 4),  # chair_gt_pose on 32 models
    (8, 7, 24, 3),  # more views than a row's stable sort ties easily
    (4, 3, 1, 1),  # one view: v_in2 wraps onto v_in
])
@pytest.mark.parametrize("consistency", [0.0, 0.2])
def test_scan_rows_match_dpcx(B, M, V, views_per_step, consistency):
    """scan_batch's draws (prng.batch_draws, the kernel's plain version on
    the CPU) and its dropout key equal jax.random's through dpcx's code at
    several seeds and steps, v_in2 drawn only with
    pose_consistency_weight > 0; the batch is the records at those rows."""
    V_use = min(views_per_step, V)
    rng = np.random.default_rng(B + M + V)
    records = {"images": torch.from_numpy(rng.random((M, V, 4, 4, 3),
                                                     np.float32)),
               "masks": torch.from_numpy(rng.random((M, V, 3, 3),
                                                    np.float32)),
               "depths": torch.from_numpy(rng.random((M, V, 3, 3),
                                                     np.float32)),
               "quats": torch.from_numpy(rng.random((M, V, 4), np.float32))}
    cfg = TConfig(batch_size=B, num_views=max(V, 2),
                  views_per_step=views_per_step,
                  pose_consistency_weight=consistency, predict_pose=True)
    for seed in (0, 5):
        for step in (0, 1, 9999, 2**31 - 1):
            want, want_drop = _dpcx_rows(jax.random.PRNGKey(seed + 1), step,
                                         B, M, V, V_use, consistency > 0)
            kk = prng.fold_in(prng.prng_key(seed + 1), step)
            k_m, k_vin, k_tgt, k_drop = prng.split(kk, 4)
            rows = prng.batch_draws(
                k_m, k_vin, k_tgt,
                prng.fold_in(kk, 7) if consistency > 0 else None,
                B, M, V, V_use)
            np.testing.assert_array_equal(rows.numpy(), want)
            assert k_drop == want_drop
            batch, drop = ttrain.scan_batch(cfg, records,
                                            prng.prng_key(seed + 1), step)
            assert drop == want_drop
            flat = {k: v.flatten(0, 1).numpy() for k, v in records.items()}
            tgt, src = want[:, 2:], want[:, 0]
            expect = {"image": flat["images"][src],
                      "masks": flat["masks"][tgt],
                      "depths": flat["depths"][tgt],
                      "quats": flat["quats"][tgt],
                      "quat_in": flat["quats"][src]}
            if consistency > 0:
                expect["image_in2"] = flat["images"][want[:, 1]]
            assert batch.keys() == expect.keys()
            for k, v in expect.items():
                np.testing.assert_array_equal(batch[k].numpy(), v,
                                              err_msg=k)


def _carried_state(cfg, jstate):
    """The port's TrainState from a dpcx TrainState (convert.py)."""
    state = ttrain.create_state(TConfig(**dataclasses.asdict(cfg)), "cpu")
    state.model.load_state_dict(
        params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    adam = jstate.opt_state[0]
    state.load_adam_state(adam_state_from_optax(
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        adam.count))
    state.step = int(jstate.step)
    return state


@pytest.mark.parametrize("overrides", [
    {"log_every": 1},
    {"log_every": 2, "device_records_models": 3, "block_rotate_chunks": 1},
], ids=["device_data", "block_rotation"])
def test_train_follows_dpcx_default_train(overrides, tmp_path):
    """30 steps of the port's train() on TINY with device_data and point
    dropout (keep 0.5) from dpcx's init (a step-0 checkpoint), on the
    port's shards of 4 models; dpcx's default train() on the same shards,
    on one device: the same logged steps, loss_total within rtol 1e-3.
    With device_records_models 3 of 4 both rotate a block of 3 models every
    2-step chunk."""
    cfg = TINY.replace(checkpoint_dir=str(tmp_path / "run"),
                       save_every=1000, **overrides)
    tcfg = TConfig(**dataclasses.asdict(cfg))
    records = {k: v.numpy() for k, v in
               make_dataset(tcfg, 4, seed=0, gt_points=256).items()}
    save_shards(records, tmp_path / "shards.npz")
    j_ds = JDataset(j_load_shards(tmp_path / "shards.npz"), cfg)
    jstate = j_create_state(cfg, jax.random.PRNGKey(cfg.seed))
    ttrain.save_checkpoint(tcfg, _carried_state(cfg, jstate))

    state, hist = ttrain.train(tcfg, dataset=Dataset(records, tcfg),
                               max_steps=30, device="cpu")
    every = cfg.log_every
    assert state.step == 30
    assert [h["step"] for h in hist] == list(range(every, 31, every))
    losses = np.array([h["loss_total"] for h in hist])
    assert np.isfinite(losses).all()

    _, j_hist = j_train(cfg, dataset=j_ds, max_steps=30,
                        mesh=make_mesh(cfg, devices=jax.devices()[:1]),
                        use_checkpoints=False)
    assert [h["step"] for h in j_hist] == [h["step"] for h in hist]
    j_losses = np.array([h["loss_total"] for h in j_hist])
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)


def test_resume_under_rotation_equals_uninterrupted(tmp_path):
    """Block rotation (3 of 4 models, a block every 2-step chunk) and
    dropout: 5 steps, then 7 more from the step-5 checkpoint (the first
    chunk cut at the block's end), end bitwise where 12 uninterrupted steps
    end, with the same logged losses from step 6 on."""
    cfg = TConfig(**dataclasses.asdict(TINY)).replace(
        checkpoint_dir=str(tmp_path / "run"), log_every=2, save_every=1000,
        device_records_models=3, block_rotate_chunks=1)
    ds = Dataset({k: v.numpy() for k, v in
                  make_dataset(cfg, 4, seed=0).items()}, cfg)
    ttrain.train(cfg, dataset=ds, max_steps=5, device="cpu")
    resumed, r_hist = ttrain.train(cfg, dataset=ds, max_steps=12,
                                   device="cpu")
    straight, s_hist = ttrain.train(
        cfg.replace(checkpoint_dir=str(tmp_path / "straight")), dataset=ds,
        max_steps=12, device="cpu")
    assert [h["step"] for h in r_hist] == [6, 8, 10, 12]
    want = {h["step"]: h["loss_total"] for h in s_hist}
    for h in r_hist:
        assert h["loss_total"] == want[h["step"]], h
    for (k, a), b in zip(resumed.params.items(), straight.params.values()):
        assert torch.equal(a, b), k
