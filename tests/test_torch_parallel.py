"""The port's data parallelism against dpcx's (CPU, gloo).

dpcx trains over a mesh of jax devices: ``train_steps_scan_dp`` with
device-resident data (every device draws the whole batch, takes its rows,
folds its index into the dropout key, and ``pmean``s gradients and
metrics), the jitted ``train_step`` on a sharded host batch (XLA's
partition of the one-device step), and ``train`` over the largest device
count that divides the batch. The port runs one process per rank
(``parallel/mesh.py``, ``train.py``). Here a world of 2 ranks, and one of 3
with batch 4, each started once for the module (``tests/torch_ranks.py``),
against dpcx on ``jax.devices()[:2]`` of the 8 host devices that
``tests/conftest.py`` forces, from dpcx's init (``convert.params_from_flax``)
on the port's shards.

Tolerances: the scan's 4 steps with dropout, dpcx's own
``test_dp_scan_matches_single_device_scan``'s (``loss_total`` rtol 2e-3,
parameters atol 5e-3); one host-fed step, ``tests/test_torch_train.py``'s
(``loss_total`` and ``grad_norm`` rtol 1e-4, parameters atol 1e-6; with
predicted pose ``tests/test_torch_pose.py``'s atol 1e-5);
``train()``'s logged losses, ``tests/test_torch_stream.py``'s rtol 1e-3
(which Adam at lr 2e-3 carries from step to step), its final parameters
atol 5e-3.
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
from dpcx.data.dataset import load_shards as j_load_shards
from dpcx.parallel.mesh import make_mesh as j_make_mesh
from dpcx.parallel.mesh import shard_batch as j_shard_batch
from dpcx.train import _device_records, _prep_batch
from dpcx.train import create_state as j_create_state
from dpcx.train import train as j_train
from dpcx.train import train_step as j_train_step
from dpcx.train import train_steps_scan_dp as j_train_steps_scan_dp
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import adam_state_from_optax, params_from_flax
from dpcx_torch.data.dataset import Dataset, save_shards
from dpcx_torch.data.synthetic import make_dataset
from dpcx_torch.parallel.mesh import Mesh, make_mesh, mesh_shape, shard_batch
from dpcx_torch.utils import prng
from torch_ranks import dp_world, run_world
from torch_workers import share_cores

share_cores()

# test_torch_stream.py's TINY: dropout on (keep 0.5), float32 compute
TINY = Config(
    vox_size=12, pc_num_points=128, image_size=32,
    encoder_filters=(8, 16, 32), latent_dim=64, fc_hidden=64,
    pc_decoder_hidden=(64, 64), views_per_step=2, num_views=3,
    batch_size=8, learning_rate=2e-3, pc_point_dropout=0.5,
    pc_relative_sigma=0.12, pc_relative_sigma_end=0.08,
    sigma_anneal_steps=60, compute_dtype="float32", device_data=True,
)
# host-fed steps whose loss holds terms that are not means over the batch:
# GT pose with colour (a ratio of sums), predicted pose with colour in the
# selection (rgb_sel_normalize's batch means) and the softmin (its
# temperature's batch mean); at test_torch_train.py's learning rate, whose
# Adam step bounds what an element near a zero gradient can move, and each
# with its parameters' tolerance after the step
HOST_PARAM_ATOL = {"host_gt_rgb": 1e-6, "host_pose_rgb": 1e-5}
HOST = {
    "host_gt_rgb": TINY.replace(pc_rgb=True, proj_depth=True,
                                drc_weight=0.1, device_data=False,
                                learning_rate=1e-4),
    "host_pose_rgb": TINY.replace(
        pc_rgb=True, predict_pose=True, pose_predict_num_candidates=2,
        rgb_sel_normalize=True, pose_softmin_temp=1.0,
        pose_softmin_steps=20, device_data=False, learning_rate=1e-4),
}
TRAIN_STEPS, RESUME_AT = 10, 5


def _t(cfg: Config) -> TConfig:
    return TConfig(**dataclasses.asdict(cfg))


def _port_params(jparams) -> dict:
    return params_from_flax(jax.tree.map(np.asarray, jparams))


def _carried_state(cfg, jstate):
    """The port's TrainState from a dpcx TrainState."""
    state = ttrain.create_state(_t(cfg), "cpu")
    state.model.load_state_dict(_port_params(jstate.params))
    adam = jstate.opt_state[0]
    state.load_adam_state(adam_state_from_optax(
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        adam.count))
    state.step = int(jstate.step)
    return state


def _load(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _params_of(res: dict) -> dict:
    return {k[len("param/"):]: v for k, v in res.items()
            if k.startswith("param/")}


def _train_cfg(tmp, name, **kw) -> Config:
    return TINY.replace(checkpoint_dir=str(tmp / name), log_every=1,
                        save_every=RESUME_AT, **kw)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The port's shards of 4 TINY models (dpcx's draws) and dpcx's
    Dataset of the same file."""
    tmp = tmp_path_factory.mktemp("parallel")
    records = {k: v.numpy() for k, v in
               make_dataset(_t(TINY), 4, seed=0, gt_points=256).items()}
    save_shards(records, tmp / "shards.npz")
    return tmp, JDataset(j_load_shards(tmp / "shards.npz"), TINY)


@pytest.fixture(scope="module")
def w2(shards):
    """The world of 2 ranks: the mesh, 4 scan_dp steps, the host-fed
    steps, and train() to step 5 then on to 10 from its checkpoint; and
    dpcx's side of each on a 2-device mesh."""
    tmp, j_ds = shards
    mesh2 = j_make_mesh(TINY, devices=jax.devices()[:2])
    jinit = j_create_state(TINY, jax.random.PRNGKey(0))
    torch.save(_port_params(jinit.params), tmp / "scan_init.pt")
    host_batches = {}
    for name, cfg in HOST.items():
        js = j_create_state(cfg, jax.random.PRNGKey(0))
        torch.save(_port_params(js.params), tmp / f"{name}_init.pt")
        batch = j_ds.batch(np.random.default_rng((0, 0)), cfg.batch_size)
        np.savez(tmp / f"{name}_batch.npz", **batch)
        host_batches[name] = batch
    train_cfg = _train_cfg(tmp, "train_w2")
    ttrain.save_checkpoint(_t(train_cfg), _carried_state(train_cfg, jinit))
    run_world(dp_world, 2, tmp, {
        "mesh": dataclasses.asdict(_t(TINY)),
        "scan": dataclasses.asdict(_t(TINY)),
        "host": {n: dataclasses.asdict(_t(c)) for n, c in HOST.items()},
        "train": {"train_w2": (dataclasses.asdict(_t(train_cfg)),
                               [RESUME_AT, TRAIN_STEPS])},
    })

    ref = {}
    s, m = j_train_steps_scan_dp(
        TINY, j_create_state(TINY, jax.random.PRNGKey(0)),
        _device_records(j_ds), jax.random.PRNGKey(3), 4, mesh2)
    ref["scan"] = (m, s.params)
    for name, cfg in HOST.items():
        s, m = j_train_step(
            cfg, j_create_state(cfg, jax.random.PRNGKey(0)),
            j_shard_batch(_prep_batch(host_batches[name], cfg), mesh2),
            jax.random.PRNGKey(1))
        ref[name] = (m, s.params)
    # dpcx writes its metrics.jsonl beside, not into the port's run
    s, hist = j_train(train_cfg.replace(checkpoint_dir=str(tmp / "dpcx_w2")),
                      dataset=j_ds, max_steps=TRAIN_STEPS, mesh=mesh2,
                      use_checkpoints=False)
    ref["train_w2"] = (hist, s.params)
    return tmp, ref


@pytest.fixture(scope="module")
def w3(shards):
    """A world of 3 ranks with batch 4: dpcx's rule trains on 2 of them;
    dpcx's train() on the 2 devices its rule picks from 3."""
    tmp, j_ds = shards
    cfg = _train_cfg(tmp, "train_w3", batch_size=4)
    jinit = j_create_state(cfg, jax.random.PRNGKey(0))
    ttrain.save_checkpoint(_t(cfg), _carried_state(cfg, jinit))
    run_world(dp_world, 3, tmp, {
        "train": {"train_w3": (dataclasses.asdict(_t(cfg)), [TRAIN_STEPS])}})
    s, hist = j_train(cfg.replace(checkpoint_dir=str(tmp / "dpcx_w3")),
                      dataset=j_ds, max_steps=TRAIN_STEPS,
                      mesh=j_make_mesh(cfg, devices=jax.devices()[:2]),
                      use_checkpoints=False)
    return tmp, (hist, s.params)


def _fake_mesh(index: int, size: int = 2) -> Mesh:
    return Mesh(shape=(size,), axes=("data",), rank=index, index=index,
                device=torch.device("cpu"), members=tuple(range(size)))


@pytest.mark.parametrize("shape,n,want", [
    ((-1,), 1, (1,)), ((-1,), 2, (2,)), ((2,), 2, (2,)), ((-1,), 3, (3,)),
])
def test_mesh_shape(shape, n, want):
    """dpcx's make_mesh: -1 stands for every rank; the shape holds them."""
    assert mesh_shape(_t(TINY).replace(mesh_shape=shape), n) == want
    jshape = j_make_mesh(TINY.replace(mesh_shape=shape),
                         devices=jax.devices()[:n]).devices.shape
    assert jshape == want


@pytest.mark.parametrize("shape,n", [((2,), 3), ((4,), 2), ((2, -1), 4)])
def test_mesh_shape_that_cannot_hold_the_ranks(shape, n):
    """A fixed shape the ranks cannot fill is an error, as dpcx's reshape
    of its devices is."""
    with pytest.raises(ValueError, match="cannot hold"):
        mesh_shape(_t(TINY).replace(mesh_shape=shape), n)
    with pytest.raises(ValueError):
        j_make_mesh(TINY.replace(mesh_shape=shape), devices=jax.devices()[:n])


def test_make_mesh_in_a_world_of_one():
    """Without a process group the mesh is this process alone."""
    mesh = make_mesh(_t(TINY), device="cpu")
    assert (mesh.shape, mesh.axes, mesh.size, mesh.index, mesh.world) == \
        ((1,), ("data",), 1, 0, 1)
    with pytest.raises(ValueError, match="distinct ranks"):
        make_mesh(_t(TINY), ranks=[0, 1], device="cpu")


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_and_shard_batch_in_a_world_of_two(rank, w2):
    """make_mesh over the world and shard_batch's rows, against dpcx's
    mesh of 2 devices and the rows of its sharding."""
    tmp, _ = w2
    got = json.loads((tmp / f"mesh_r{rank}.json").read_text())
    jmesh = j_make_mesh(TINY, devices=jax.devices()[:2])
    assert tuple(got["shape"]) == jmesh.devices.shape == (2,)
    assert tuple(got["axes"]) == jmesh.axis_names
    assert (got["size"], got["index"], got["rank"], got["world"]) == \
        (2, rank, rank, 2)
    assert got["shape_of_4"] == [4]
    x = j_shard_batch({"x": np.arange(8)}, jmesh)["x"]
    want = np.asarray(x.addressable_shards[rank].data)
    assert got["x"] == want.tolist()
    assert np.asarray(got["y"]).shape == (4, 2)


@pytest.mark.parametrize("batch,world,want", [(8, 2, 2), (4, 3, 2),
                                              (6, 4, 3)])
@pytest.mark.parametrize("shard_points", [False, True])
def test_data_ranks_rule(batch, world, want, shard_points):
    """dpcx's count of data ranks: the largest divisor of the batch not
    above the world, 1 with shard_points."""
    cfg = _t(TINY).replace(batch_size=batch, shard_points=shard_points)
    assert ttrain.data_ranks(cfg, world) == (1 if shard_points else want)


@pytest.mark.parametrize("index", [0, 1])
def test_shard_batch_rows(index):
    """A rank's rows: [i B / W, (i + 1) B / W); rows that do not split
    evenly are an error, as dpcx's sharding refuses them."""
    mesh = _fake_mesh(index)
    got = shard_batch({"a": torch.arange(6), "b": torch.ones(6, 2)}, mesh)
    assert got["a"].tolist() == [3 * index, 3 * index + 1, 3 * index + 2]
    assert got["b"].shape == (3, 2)
    with pytest.raises(ValueError, match="do not split"):
        shard_batch({"a": torch.arange(5)}, mesh)


def _dpcx_dp_rows(key, step, B, M, V, V_use, di, ndev, with_in2):
    """dpcx's multi-device scan draws of device ``di``
    (dpcx/train.py:272-309) as gather rows [B / ndev, 2 + V_use]."""
    Bl = B // ndev
    kk = jax.random.fold_in(key, step)
    k_m, k_vin, k_tgt, k_drop = jax.random.split(kk, 4)
    m = jax.random.randint(k_m, (B,), 0, M)
    v_in = jax.random.randint(k_vin, (B,), 0, V)
    perm = jnp.argsort(jax.random.uniform(k_tgt, (B, V)), axis=1)[:, :V_use]
    sl = di * Bl
    m, v_in, perm = (jax.lax.dynamic_slice_in_dim(a, sl, Bl)
                     for a in (m, v_in, perm))
    if with_in2:
        k_vin2 = jax.random.fold_in(kk, 7)
        v_in2 = (v_in + 1 + jax.random.randint(k_vin2, (Bl,), 0, V - 1)) % V
        in2 = m * V + v_in2
    else:
        in2 = jnp.full_like(m, -1)
    rows = jnp.concatenate(
        [(m * V + v_in)[:, None], in2[:, None], m[:, None] * V + perm], 1)
    k_drop = jax.random.fold_in(k_drop, di)
    return np.array(rows), tuple(int(w) for w in np.asarray(k_drop))


@pytest.mark.parametrize("consistency", [0.0, 0.2])
@pytest.mark.parametrize("index", [0, 1])
def test_scan_dp_rows_match_dpcx(index, consistency):
    """A rank's batch of the multi-device scan is dpcx's device's, bitwise,
    with its dropout key; with the consistency loss each slice takes the
    second input view's offsets of the whole batch's first rows, as dpcx's
    devices draw them."""
    B, M, V, V_use = 8, 7, 5, 3
    rng = np.random.default_rng(index)
    records = {k: torch.from_numpy(rng.random((M, V) + s, np.float32))
               for k, s in (("images", (2, 2, 3)), ("masks", (3, 3)),
                            ("depths", (3, 3)), ("quats", (4,)))}
    cfg = _t(TINY).replace(batch_size=B, num_views=V, views_per_step=V_use,
                           pose_consistency_weight=consistency,
                           predict_pose=True)
    for step in (0, 7, 2**31 - 1):
        want, want_drop = _dpcx_dp_rows(jax.random.PRNGKey(1), step, B, M, V,
                                        V_use, index, 2, consistency > 0)
        batch, k_drop = ttrain.scan_batch(cfg, records, prng.prng_key(1),
                                          step, _fake_mesh(index))
        assert prng.fold_in(k_drop, index) == want_drop
        flat = {k: v.flatten(0, 1) for k, v in records.items()}
        np.testing.assert_array_equal(batch["image"],
                                      flat["images"][want[:, 0]])
        np.testing.assert_array_equal(batch["masks"],
                                      flat["masks"][want[:, 2:]])
        if consistency > 0:
            np.testing.assert_array_equal(batch["image_in2"],
                                          flat["images"][want[:, 1]])


@pytest.mark.parametrize("rank", [0, 1])
def test_scan_dp_matches_dpcx(rank, w2):
    """4 steps of train_steps_scan_dp at W 2 with dropout keep 0.5 from
    dpcx's init: the last step's loss_total and grad_norm and the
    parameters, against dpcx's train_steps_scan_dp on 2 devices."""
    tmp, ref = w2
    got = _load(tmp / f"scan_r{rank}.npz")
    m, params = ref["scan"]
    np.testing.assert_allclose(got["loss_total"], float(m["loss_total"]),
                               rtol=2e-3)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                               rtol=2e-3)
    want = _port_params(params)
    for k, v in _params_of(got).items():
        np.testing.assert_allclose(v, want[k].numpy(), atol=5e-3,
                                   err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", list(HOST))
def test_host_fed_step_matches_dpcx(name, rank, w2):
    """One host-fed step at W 2 on each rank's rows: dpcx's train_step on
    the sharded batch (the one-device step of the whole batch): every
    metric, grad_norm and the parameters."""
    tmp, ref = w2
    got = _load(tmp / f"{name}_r{rank}.npz")
    m, params = ref[name]
    metrics = {k[len("metric/"):]: v for k, v in got.items()
               if k.startswith("metric/")}
    assert set(metrics) == set(m), (set(metrics), set(m))
    for k, v in metrics.items():
        np.testing.assert_allclose(v, float(m[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    want = _port_params(params)
    for k, v in _params_of(got).items():
        np.testing.assert_allclose(v, want[k].numpy(),
                                   atol=HOST_PARAM_ATOL[name], err_msg=k)


def _records(tmp, name, rank):
    return json.loads((tmp / f"{name}_r{rank}.json").read_text())


@pytest.mark.parametrize("rank", [0, 1])
def test_train_w2_follows_dpcx(rank, w2):
    """train() at W 2 to step 5, then resumed to 10 from its checkpoint
    (rank 0's, broadcast), against dpcx's uninterrupted train() over 2
    devices: the same logged steps, loss_total rtol 1e-3, the final
    parameters atol 5e-3; every rank logs the same records."""
    tmp, ref = w2
    got = _records(tmp, "train_w2", rank)
    hist = [h for call in got["calls"] for h in call]
    j_hist, j_params = ref["train_w2"]
    assert [h["step"] for h in hist] == [h["step"] for h in j_hist] == \
        list(range(1, TRAIN_STEPS + 1))
    np.testing.assert_allclose([h["loss_total"] for h in hist],
                               [h["loss_total"] for h in j_hist], rtol=1e-3)
    assert got["step"] == TRAIN_STEPS and got["warnings"] == []
    want = _port_params(j_params)
    for k, v in _params_of(_load(tmp / f"train_w2_r{rank}.npz")).items():
        np.testing.assert_allclose(v, want[k].numpy(), atol=5e-3, err_msg=k)


def test_train_only_rank0_writes(w2):
    """Both ranks trained into one checkpoint_dir: metrics.jsonl holds each
    logged record once, equal to every rank's records; the checkpoints and
    the summaries are rank 0's (one file each)."""
    tmp, _ = w2
    run = tmp / "train_w2"
    lines = [json.loads(x) for x in
             (run / "metrics.jsonl").read_text().splitlines()]
    for rank in (0, 1):
        calls = _records(tmp, "train_w2", rank)["calls"]
        hist = [h for call in calls for h in call]
        assert [h["step"] for h in lines] == [h["step"] for h in hist]
        for a, b in zip(lines, hist):
            assert a["loss_total"] == b["loss_total"]
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == \
        ["0.pt", "10.pt", "5.pt"]
    assert sorted(p.name for p in (run / "summaries").iterdir()) == \
        ["proj_0000005.png", "proj_0000010.png"]
    assert not list(run.glob("**/*.tmp"))


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_end_with_equal_parameters(world, w2, w3):
    """Every rank ends with rank 0's parameters, bitwise (the rank that
    took no step at W 3 too)."""
    tmp = (w2 if world == 2 else w3)[0]
    name = f"train_w{world}"
    ranks = [_params_of(_load(tmp / f"{name}_r{r}.npz"))
             for r in range(world)]
    for other in ranks[1:]:
        assert other.keys() == ranks[0].keys()
        for k in ranks[0]:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_train_w3_batch4_follows_dpcx(rank, w3):
    """W 3 with batch 4: ranks 0 and 1 take 2 rows each, as dpcx's rule
    picks 2 of 3 devices; their records follow dpcx's train() over those 2
    devices (loss_total rtol 1e-3, parameters atol 5e-3)."""
    tmp, (j_hist, j_params) = w3
    hist = _records(tmp, "train_w3", rank)["calls"][0]
    assert [h["step"] for h in hist] == [h["step"] for h in j_hist]
    np.testing.assert_allclose([h["loss_total"] for h in hist],
                               [h["loss_total"] for h in j_hist], rtol=1e-3)
    want = _port_params(j_params)
    for k, v in _params_of(_load(tmp / f"train_w3_r{rank}.npz")).items():
        np.testing.assert_allclose(v, want[k].numpy(), atol=5e-3, err_msg=k)


def test_train_w3_third_rank_takes_no_step(w3):
    """The rank beyond dpcx's 2 logs nothing and ends at rank 0's step."""
    tmp, _ = w3
    got = _records(tmp, "train_w3", 2)
    assert got["calls"] == [[]] and got["step"] == TRAIN_STEPS
