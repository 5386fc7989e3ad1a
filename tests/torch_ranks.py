"""Worlds of W ranks for the port's parallel tests, on the CPU over gloo.

``run_world(target, world, out_dir, spec)`` spawns W processes (each imports
this module afresh, and never jax), joins them into a gloo group over
localhost, gives each ``core_budget() // W`` threads, and runs
``target(rank, out_dir, spec)`` in each; a rank's traceback goes to
``out_dir/rank<r>.err`` and fails the call. The targets are the worlds
that the test files start once per module: each reads its inputs from
``out_dir`` (written by the test: dpcx's init converted to the port's
names, shards, batches) and writes its results there, a file per rank.
Configs travel as ``Config`` keyword dicts.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from torch_workers import core_budget

WORLD_TIMEOUT = 600  # seconds a world may take before the test fails


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(target, rank, world, port, threads, out_dir, spec):
    torch.set_num_threads(threads)
    os.environ["OMP_NUM_THREADS"] = str(threads)
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            target(rank, Path(out_dir), spec)
        finally:
            dist.destroy_process_group()
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(target, world: int, out_dir, spec: dict) -> None:
    """Run ``target`` in a gloo world of ``world`` spawned ranks."""
    ctx = multiprocessing.get_context("spawn")
    port, threads = _free_port(), max(1, core_budget() // world)
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, port, threads, str(out_dir),
                               spec))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORLD_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {r: Path(out_dir, f"rank{r}.err") for r in range(world)}
    failed = {r: e.read_text() for r, e in errs.items() if e.exists()}
    codes = [p.exitcode for p in procs]
    assert not failed and codes == [0] * world, (codes, failed)


def _config(d: dict):
    from dpcx_torch.config import Config

    return Config(**d)


def _state(cfg, out: Path, name: str):
    """The port's state from dpcx's init (``<name>_init.pt``)."""
    from dpcx_torch import train as ttrain

    state = ttrain.create_state(cfg, "cpu")
    state.model.load_state_dict(torch.load(out / f"{name}_init.pt"))
    return state


def _save(out: Path, name: str, rank: int, state=None, **arrays) -> None:
    if state is not None:
        arrays.update({f"param/{k}": v.numpy()
                       for k, v in state.model.state_dict().items()})
    np.savez(out / f"{name}_r{rank}.npz",
             **{k: np.asarray(v) for k, v in arrays.items()})


def dp_world(rank: int, out: Path, spec: dict) -> None:
    """Data parallelism: whichever of these ``spec`` names.

    - ``mesh``: a config dict; ``make_mesh`` of it and ``shard_batch`` of
      an 8-row batch -> ``mesh_r<rank>.json``;
    - ``scan``: a config dict; ``train_steps_scan_dp`` for 4 steps from
      ``scan_init.pt`` on ``shards.npz`` at key ``PRNGKey(3)`` ->
      ``scan_r<rank>.npz`` (the last step's loss_total, grad_norm, params);
    - ``host``: {name: config dict}; one host-fed step of each over the
      world's mesh, from ``<name>_init.pt`` on this rank's rows of
      ``<name>_batch.npz``, key ``PRNGKey(1)`` -> ``<name>_r<rank>.npz``;
    - ``train``: {name: (config dict, [max_steps, ...])}; ``train`` on
      ``shards.npz`` (and ``eval.npz`` where the config has eval_every) to
      each max_steps in turn, a resume each after the first ->
      ``<name>_r<rank>.json`` (the records of each call, the warnings) and
      ``<name>_r<rank>.npz`` (the final params).
    """
    from dpcx_torch import train as ttrain
    from dpcx_torch.data.dataset import Dataset, load_shards
    from dpcx_torch.parallel.mesh import make_mesh, mesh_shape, shard_batch
    from dpcx_torch.utils import prng

    if "mesh" in spec:
        cfg = _config(spec["mesh"])
        mesh = make_mesh(cfg, device="cpu")
        rows = shard_batch({"x": torch.arange(8), "y": torch.arange(16)
                            .reshape(8, 2)}, mesh)
        (out / f"mesh_r{rank}.json").write_text(json.dumps({
            "shape": mesh.shape, "axes": mesh.axes, "size": mesh.size,
            "index": mesh.index, "rank": mesh.rank, "world": mesh.world,
            "members": mesh.members, "shape_of_4": mesh_shape(cfg, 4),
            "x": rows["x"].tolist(), "y": rows["y"].tolist()}))
    if "scan" in spec:
        cfg = _config(spec["scan"])
        records = ttrain.device_records(
            Dataset(load_shards(out / "shards.npz"), cfg), "cpu")
        state = _state(cfg, out, "scan")
        m = ttrain.train_steps_scan_dp(cfg, state, records, prng.prng_key(3),
                                       4, make_mesh(cfg, device="cpu"))
        _save(out, "scan", rank, state, loss_total=m["loss_total"].item(),
              grad_norm=m["grad_norm"].item())
    for name, d in spec.get("host", {}).items():
        cfg = _config(d)
        state = _state(cfg, out, name)
        with np.load(out / f"{name}_batch.npz") as f:
            batch = ttrain._prep_batch({k: f[k] for k in f.files}, "cpu",
                                       cfg)
        mesh = make_mesh(cfg, device="cpu")
        m = ttrain.train_step(cfg, state, shard_batch(batch, mesh),
                              prng.prng_key(1), mesh=mesh)
        _save(out, name, rank, state,
              **{f"metric/{k}": v.item() for k, v in m.items()})
    for name, (d, steps) in spec.get("train", {}).items():
        cfg = _config(d)
        ds = Dataset(load_shards(out / "shards.npz"), cfg)
        ev = (Dataset(load_shards(out / "eval.npz"), cfg)
              if cfg.eval_every else None)
        calls = []
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for n in steps:
                state, hist = ttrain.train(cfg, dataset=ds, max_steps=n,
                                           device="cpu", eval_dataset=ev)
                calls.append(hist)
        (out / f"{name}_r{rank}.json").write_text(json.dumps({
            "calls": calls, "step": state.step,
            "warnings": [str(w.message) for w in seen]}))
        _save(out, name, rank, state)


def _render_case(rank: int, out: Path, name: str, case: dict) -> None:
    """One sharded render of ``<name>_in.npz`` over the world's mesh, its
    outputs and the gradients of a fixed loss of them with respect to the
    points, colours and weights given."""
    from dpcx_torch.parallel.mesh import make_mesh
    from dpcx_torch.render import sharded

    cfg = _config(case["cfg"])
    with np.load(out / f"{name}_in.npz") as f:
        inp = {k: torch.from_numpy(f[k]) for k in f.files}
    leaves = {k: inp[k].clone().requires_grad_()
              for k in ("points", "rgb", "weights") if k in inp}
    mesh = make_mesh(cfg, device="cpu")
    res = {}
    if case["kind"] == "loss":
        loss = sharded.gt_pose_projection_loss_sharded(
            cfg, mesh, leaves["points"], inp["quat"], inp["masks"],
            inp["sigma"], rgb=leaves.get("rgb"),
            images_tgt=inp.get("images_tgt"),
            point_weights=leaves.get("weights"))
        res["loss"] = loss.detach().numpy()
    else:
        fn = (sharded.pointcloud_project_grid_sharded if case["kind"] ==
              "grid" else sharded.pointcloud_project_point_sharded)
        o = fn(cfg, mesh, leaves["points"], inp["quat"], inp["sigma"],
               point_weights=leaves.get("weights"), rgb=leaves.get("rgb"))
        loss = torch.mean((o.silhouette - inp["target"]) ** 2)
        res["silhouette"] = o.silhouette.detach().numpy()
        if o.depth is not None:
            loss = loss + torch.mean(o.depth ** 2)
            res["depth"] = o.depth.detach().numpy()
        if o.rgb is not None:
            loss = loss + torch.mean(o.rgb ** 2)
            res["rgb"] = o.rgb.detach().numpy()
    loss.backward()
    for k, v in leaves.items():
        res[f"grad_{k}"] = v.grad.numpy()
    _save(out, name, rank, **res)


def sharded_world(rank: int, out: Path, spec: dict) -> None:
    """The sharded renderers and ``shard_points`` steps:

    - ``renders``: {name: {"kind": "point" | "grid" | "loss", "cfg":
      config dict}} -> ``<name>_r<rank>.npz`` (``_render_case``);
    - ``steps``: {name: config dict}; one host-fed ``train_step`` of a
      ``shard_points`` config from ``<name>_init.pt`` on the whole of
      ``<name>_batch.npz`` (every rank the same), key ``PRNGKey(1)`` ->
      ``<name>_r<rank>.npz``, with the warnings ``validate`` gave.
    """
    from dpcx_torch import train as ttrain
    from dpcx_torch.utils import prng

    for name, case in spec.get("renders", {}).items():
        _render_case(rank, out, name, case)
    for name, d in spec.get("steps", {}).items():
        cfg = _config(d)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            cfg.validate()
        state = _state(cfg, out, name)
        with np.load(out / f"{name}_batch.npz") as f:
            batch = ttrain._prep_batch({k: f[k] for k in f.files}, "cpu",
                                       cfg)
        m = ttrain.train_step(cfg, state, batch, prng.prng_key(1))
        _save(out, name, rank, state,
              warnings=np.array([str(w.message) for w in seen] or [""]),
              **{f"metric/{k}": v.item() for k, v in m.items()})


def spans_world(rank: int, out: Path, spec: dict) -> None:
    """``all_mean_`` of ``spec["sizes"]`` float32 tensors (rank r's all
    r + 1) over the world's mesh under a CPU ``torch.profiler`` ->
    ``spans_r<rank>.json``: each recorded span's name and counts, and
    whether every tensor came back as the ranks' mean."""
    from torch.profiler import ProfilerActivity, profile

    from dpcx_torch.parallel.mesh import all_mean_, make_mesh
    from dpcx_torch.utils import profiling

    mesh = make_mesh(_config({"batch_size": 2}), device="cpu")
    tensors = [torch.full((n,), float(rank + 1)) for n in spec["sizes"]]
    with profile(activities=[ProfilerActivity.CPU]):
        all_mean_(tensors, mesh)
    want = sum(range(1, mesh.world + 1)) / mesh.world
    (out / f"spans_r{rank}.json").write_text(json.dumps({
        "spans": [[s.name, s.counts] for s in profiling.RECORDER.finished()],
        "mean": all(bool((t == want).all()) for t in tensors)}))
