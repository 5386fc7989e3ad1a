"""Training loop: Adam, eager steps, ``torch.save`` checkpoints, JSONL
metrics, the gauge reseed (port of ``dpcx/train.py``).

The random stream is dpcx's, bit for bit (``utils/prng.py``: jax.random's
threefry2x32), from the base key ``PRNGKey(seed + 1)``:

- with ``device_data`` (the default) the records live on the device and
  ``train`` advances in dpcx's chunks, ``min(log_every, save_every,
  eval_every or save_every)`` steps, through ``train_steps_scan``, the
  counterpart of dpcx's ``lax.scan`` of the same name: each step draws its
  batch as dpcx's scan body does (``kk = fold_in(key, step)``, ``split(kk,
  4)``: the model ids, input views, target views and the dropout key;
  ``fold_in(kk, 7)``: the second input view), one draw kernel on the card,
  and gathers it from the records. With ``0 < device_records_models <
  num_models`` it rotates blocks of that many models onto the device every
  ``chunk * block_rotate_chunks`` steps (dpcx's ``_device_block``: the
  block's models a function of ``(seed, block)``), a chunk cut at the
  block's end;
- without ``device_data`` every step's batch is ``Dataset.batch`` drawing
  from ``np.random.default_rng((seed, step))`` and its dropout key is
  ``fold_in(key, step)``, dpcx's host-fed path.

Logging, the reseed check, checkpoints, the image summary (of the host
batch at that step, as dpcx's) and eval happen at the ends of the loop's
passes, where a multiple of their period is crossed. A resumed run replays
the uninterrupted run's batches and dropout. Where dpcx's loop is a jitted
scan, this one is a Python loop of eager steps that reads nothing back on
the host inside a chunk.

Checkpoints are ``checkpoint_dir/ckpt/<step>.pt`` files holding
``{"params", "opt_state", "step"}``, the newest 3 kept (Orbax's
``max_to_keep``). An Orbax step directory there is refused, never read.

The gauge reseed is dpcx's (``gauge_reseed_*``): after the pass that
crosses ``gauge_reseed_check_step``, a logged ``gauge_spread_deg`` above
the threshold re-initialises the model with flax's init from ``seed +
7919 * attempt`` (dpcx's ``PRNGKey(seed + 7919 * attempt)``), deletes the
dead attempt's checkpoints, writes
``{"gauge_reseed": attempt, "gauge_spread_deg": spread}`` and restarts the
step count and the clock. As in dpcx, the attempt count is not saved in
checkpoints, a missing ``gauge_spread_deg`` reads as 0 (healthy), and the
logged steps restart from 0 after a reseed.

With an ``eval_dataset``, ``train`` evaluates it (``predict.evaluate``,
view 0) after every pass that crosses a multiple of ``eval_every`` and
logs ``val_<metric>`` records, as dpcx does; without one dpcx evaluates
nothing either, and ``eval_every`` only sets the chunk. With
``profile_dir`` one pass of the loop is traced, as dpcx traces one: the one
after the first, by ``utils.profiling.trace``, the program's spans
(``utils.profiling.span``) nested over its kernels.

In a ``torch.distributed`` world of W processes (``torch.distributed.run``;
one rank a device) ``train`` is dpcx's ``train`` over a mesh of W devices:

- data parallelism over ``n`` ranks, ``n`` the largest divisor of
  ``batch_size`` not above W. With ``device_data`` each step is
  ``train_steps_scan_dp``'s (dpcx's multi-device scan): every rank draws
  the whole batch, takes its rows and folds its index into the dropout
  key, and the gradients and metrics are averaged over the ranks before
  Adam. Host-fed, the rank takes its rows of the host batch and the step is
  dpcx's one-device step of the whole batch (``compute_loss``'s
  ``batch_mesh``). Ranks beyond ``n`` take no step: they wait in one
  ``broadcast`` a pass of the loop and receive rank 0's final state;
- with ``shard_points`` every rank steps on the whole batch and the loss
  shards the points over the ranks (``models/losses.py``);
- rank 0's state after ``restore_checkpoint`` goes to every rank, and
  only rank 0 writes ``metrics.jsonl``, config, checkpoints, image
  summaries, ``val_*`` records and the trace; every stepping rank runs the
  periodic eval and holds the same logged records.

``shard_points`` on one process renders unsharded, as dpcx on one device
(``Config.validate`` warns).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dpcx_torch.config import Config, world_size
from dpcx_torch.data.dataset import Dataset, load_or_make
from dpcx_torch.models.losses import compute_loss
from dpcx_torch.models.model_pc import ModelPointCloud
from dpcx_torch.parallel.mesh import (
    Mesh,
    all_mean_,
    barrier,
    broadcast_,
    make_mesh,
    rank,
    shard_batch,
    shard_bounds,
)
from dpcx_torch.predict import evaluate
from dpcx_torch.utils import prng
from dpcx_torch.utils.profiling import span, trace

KEEP_CHECKPOINTS = 3


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, and the number of steps taken."""

    model: ModelPointCloud
    optimizer: torch.optim.Adam
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self.model.state_dict()

    def load_adam_state(self, named: dict[str, dict[str, torch.Tensor]]):
        """Per-parameter Adam state keyed by ``state_dict`` name (as
        ``convert.adam_state_from_optax`` gives it) into the optimizer."""
        for name, p in self.model.named_parameters():
            s = named[name]
            self.optimizer.state[p] = {
                "step": s["step"].clone(),
                "exp_avg": s["exp_avg"].to(p.device).clone(),
                "exp_avg_sq": s["exp_avg_sq"].to(p.device).clone(),
            }


def create_state(cfg: Config, device=None,
                 seed: int | None = None) -> TrainState:
    """dpcx's ``create_state(cfg, PRNGKey(seed))``: the model with flax's
    init from ``seed`` (``cfg.seed`` when None) and its Adam."""
    model = ModelPointCloud(cfg, device=device, seed=seed)
    # betas and eps are optax.adam's defaults, as dpcx's create_state uses
    optimizer = torch.optim.Adam(
        model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
        eps=1e-8,
    )
    return TrainState(model, optimizer)


def apply_model(cfg: Config, model: ModelPointCloud,
                batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The model application of one training batch: the input view's
    forward, the second input view's decode of the consistency loss
    (``image_in2``) and, with ``images_v`` [B, V, H, W, 3], each target
    view's pose heads from its own image (``pose_only``: the decoder runs
    once, on the input view)."""
    preds = model(batch["image"])
    if "image_in2" in batch:
        preds["points_view2"] = model(batch["image_in2"])["points"]
    if "images_v" in batch:
        iv = batch["images_v"]
        Bv, Vu = iv.shape[:2]
        with span("pose.views"):
            pv = model.pose_only(iv.reshape((Bv * Vu,) + iv.shape[2:]))
        preds["quats_views"] = pv["quats"].reshape(Bv, Vu, -1, 4)
        preds["correction_quats_views"] = pv["correction_quats"].reshape(
            Bv, Vu, -1, 4)
        if "translation" in pv:
            preds["translations_views"] = pv["translation"].reshape(
                Bv, Vu, -1, 3)
        if "student_quat" in pv:
            preds["student_quat_views"] = pv["student_quat"].reshape(
                Bv, Vu, 4)
    return preds


def update(
    cfg: Config,
    state: TrainState,
    batch: dict[str, torch.Tensor],
    drop_key,
    density_fn=None,
    project_fn=None,
    mesh: Mesh | None = None,
    batch_mesh: Mesh | None = None,
) -> dict[str, torch.Tensor]:
    """One step (forward, render, backward, Adam) on ``state`` in place,
    with point dropout drawn from ``drop_key`` (a ``utils.prng`` key);
    returns the metrics as device tensors, ``grad_norm`` included.
    ``density_fn`` and ``project_fn`` go to ``compute_loss`` (the
    anisotropic splats' density and the fused renderer; None: the kernels'
    dispatchers), and so does ``batch_mesh``. With a ``mesh`` the gradients
    and metrics are averaged over its ranks before Adam (dpcx's ``pmean``),
    in one ``all_reduce``; ``grad_norm`` is the averaged gradient's.

    With ``cfg.remat`` model plus loss run under ``torch.utils.checkpoint``
    (dpcx's ``jax.checkpoint`` of its ``loss_fn``): their activations are
    recomputed in the backward instead of being kept, and the recompute
    draws the same dropout weights from the same key.
    """
    def loss_fn():
        with span("train.forward"):
            preds = apply_model(cfg, state.model, batch)
        with span("train.loss"):
            return compute_loss(cfg, preds, batch, state.step, drop_key,
                                train=True, density_fn=density_fn,
                                project_fn=project_fn, batch_mesh=batch_mesh)

    if cfg.remat:
        from torch.utils.checkpoint import checkpoint

        loss, metrics = checkpoint(loss_fn, use_reentrant=False)
    else:
        loss, metrics = loss_fn()
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    with span("train.backward"):
        loss.backward()
    with span("train.grads"):
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            # optax updates every leaf; a parameter the loss never reached
            # (the pose branch's fc_pose without predicted pose) takes a
            # zero gradient here too, so each parameter's Adam step count
            # stays the global one
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        if mesh is not None:
            all_mean_([p.grad for p in params] + list(metrics.values()),
                      mesh)
        metrics["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
        )  # optax.global_norm
    with span("train.adam"):
        opt.step()
    state.step += 1
    return metrics


def train_step(cfg: Config, state: TrainState, batch: dict[str, torch.Tensor],
               key, density_fn=None, project_fn=None,
               mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """dpcx's host-fed step (``dpcx/train.py::train_step``): ``update``
    with the dropout key ``fold_in(key, state.step)`` (None: no dropout
    key, for a config without dropout). With a ``mesh`` of more than one
    rank ``batch`` is this rank's rows (``shard_batch``) and the step is
    dpcx's step of the whole batch on a sharded batch: its loss, gradients
    and metrics."""
    with span("train.step", step=state.step):
        drop_key = None if key is None else prng.fold_in(key, state.step)
        return update(cfg, state, batch, drop_key, density_fn, project_fn,
                      mesh=mesh, batch_mesh=mesh)


def device_records(dataset: Dataset, device,
                   models: np.ndarray | None = None
                   ) -> dict[str, torch.Tensor]:
    """The records a step gathers from, float32 on ``device``: of the
    models at ``models`` (indices), or of all."""
    return {
        k: torch.as_tensor(v if models is None else np.asarray(v)[models],
                           dtype=torch.float32).to(device)
        for k, v in dataset.records.items()
        if k in ("images", "masks", "depths", "quats")
    }


def device_block(dataset: Dataset, cfg: Config, block_idx: int,
                 device) -> dict[str, torch.Tensor]:
    """The records of block ``block_idx`` on ``device`` (dpcx's
    ``_device_block``): ``device_records_models`` models drawn without
    replacement by ``default_rng((seed, 7, block_idx))``, sorted, so a
    resumed run rotates through the same blocks."""
    M = dataset.num_models
    R = min(cfg.device_records_models, M)
    idx = np.sort(np.random.default_rng((cfg.seed, 7, block_idx)).choice(
        M, R, replace=False))
    return device_records(dataset, device, idx)


def _batch_keys(cfg: Config) -> tuple[str, ...]:
    """The batch fields the model and the loss read under ``cfg`` (dpcx's
    ``_prep_batch``): the input-view camera with predicted pose, the
    target views' images with ``pc_rgb`` and ``pose_from_views``, and a
    second input view when the batch drew one."""
    return ("image", "masks", "quats", "depths", "image_in2") + tuple(
        k for k, on in (("quat_in", cfg.predict_pose),
                        ("images_tgt", cfg.pc_rgb),
                        ("images_v", cfg.pose_from_views)) if on)


def _prep_batch(batch: dict, device, cfg: Config) -> dict[str, torch.Tensor]:
    """numpy batch -> float32 tensors on ``device``, the fields the loss
    reads under ``cfg``."""
    return {
        k: torch.as_tensor(batch[k], dtype=torch.float32).to(device)
        for k in _batch_keys(cfg) if k in batch
    }


def host_batch(cfg: Config, dataset: Dataset, step: int,
               device) -> dict[str, torch.Tensor]:
    """The host-fed batch of ``step`` (dpcx's ``device_data: false``
    stream): ``Dataset.batch`` drawing from ``default_rng((seed, step))``."""
    rng = np.random.default_rng((cfg.seed, step))
    return _prep_batch(dataset.batch(rng, cfg.batch_size), device, cfg)


def gather_batch(cfg: Config, records: dict[str, torch.Tensor],
                 rows: torch.Tensor) -> dict[str, torch.Tensor]:
    """The batch at ``rows`` ([B, 2 + V_use], ``prng.batch_draws``'s) of
    ``records`` [M, V, ...] viewed as [M * V, ...] (dpcx's ``take_mv``): the
    input view at column 0, the second input view at column 1 (-1: none),
    the target views after."""
    rows_in, rows_tgt = rows[:, 0], rows[:, 2:]
    fields = {"image": ("images", rows_in), "masks": ("masks", rows_tgt),
              "depths": ("depths", rows_tgt), "quats": ("quats", rows_tgt),
              "quat_in": ("quats", rows_in),
              "images_tgt": ("images", rows_tgt),
              "images_v": ("images", rows_tgt)}
    if cfg.pose_consistency_weight > 0:
        fields["image_in2"] = ("images", rows[:, 1])
    return {k: records[r].flatten(0, 1)[idx]
            for k, (r, idx) in fields.items()
            if k in _batch_keys(cfg) and r in records}


@span("train.draw")
def scan_batch(cfg: Config, records: dict[str, torch.Tensor], key,
               step: int, mesh: Mesh | None = None
               ) -> tuple[dict[str, torch.Tensor], Any]:
    """One step's draws of dpcx's device-resident scan
    (``dpcx/train.py:153-190``) -> (the batch gathered from ``records``,
    the dropout key). ``kk = fold_in(key, step)`` splits into the keys of
    the model ids, the input views, the target views' uniforms and the
    dropout; ``fold_in(kk, 7)`` is the second input view's, drawn when
    ``pose_consistency_weight > 0``. One ``prng.batch_draws`` launch on
    the card; no host sync.

    With a ``mesh`` the batch is this rank's rows of the whole batch, as
    dpcx's multi-device scan takes them (``dpcx/train.py:272-296``), the
    dropout key not yet folded: there every device draws the second input
    view's offsets for its own rows alone, from ``k_vin2``, so each slice
    takes the offsets of the whole batch's first rows (dpcx's, matched)."""
    M, V = records["images"].shape[:2]
    kk = prng.fold_in(key, step)
    k_m, k_vin, k_tgt, k_drop = prng.split(kk, 4)
    k_vin2 = prng.fold_in(kk, 7) if cfg.pose_consistency_weight > 0 else None
    rows = prng.batch_draws(k_m, k_vin, k_tgt, k_vin2, cfg.batch_size, M, V,
                            min(cfg.views_per_step, V),
                            records["images"].device)
    if mesh is not None:
        lo, hi = shard_bounds(cfg.batch_size, mesh)
        if k_vin2 is not None:
            # rows[:, 1] = m V + (v_in + 1 + off) % V: the slice keeps its
            # m and v_in and takes off of rows [0, hi - lo)
            v_in = rows[:, 0] % V
            off = (rows[:, 1] % V - v_in - 1) % V
            rows = rows.clone()
            rows[lo:hi, 1] = (rows[lo:hi, 0] // V) * V + (
                v_in[lo:hi] + 1 + off[:hi - lo]) % V
        rows = rows[lo:hi]
    return gather_batch(cfg, records, rows), k_drop


def train_steps_scan(cfg: Config, state: TrainState,
                     records: dict[str, torch.Tensor], key, n_steps: int,
                     density_fn=None, project_fn=None
                     ) -> dict[str, torch.Tensor]:
    """``n_steps`` steps on device-resident ``records`` (dpcx's
    ``train_steps_scan``): each step's batch and dropout key from
    ``scan_batch(cfg, records, key, state.step)``, a function of the
    absolute step, so a chunk boundary (resume, block rotation) never
    changes the stream. Returns the last step's metrics as device tensors;
    reads nothing back on the host."""
    metrics = {}
    with span("train.chunk", step=state.step):
        for _ in range(n_steps):
            with span("train.step", step=state.step):
                batch, k_drop = scan_batch(cfg, records, key, state.step)
                metrics = update(cfg, state, batch, k_drop, density_fn,
                                 project_fn)
    return metrics


def train_steps_scan_dp(cfg: Config, state: TrainState,
                        records: dict[str, torch.Tensor], key, n_steps: int,
                        mesh: Mesh, density_fn=None, project_fn=None
                        ) -> dict[str, torch.Tensor]:
    """``n_steps`` data-parallel steps (dpcx's ``train_steps_scan_dp``):
    each rank of ``mesh`` draws the step's whole batch from the shared
    key and takes its rows (``scan_batch``), folds its index into the
    dropout key, and runs the loss and backward on its rows; the gradients
    and the metrics are averaged over the ranks before Adam (``update``),
    so ``grad_norm`` is the averaged gradient's and a batch statistic is
    the mean of the slices' values, as in dpcx. Returns the last step's
    metrics as device tensors."""
    metrics = {}
    with span("train.chunk", step=state.step):
        for _ in range(n_steps):
            with span("train.step", step=state.step):
                batch, k_drop = scan_batch(cfg, records, key, state.step,
                                           mesh)
                metrics = update(cfg, state, batch,
                                 prng.fold_in(k_drop, mesh.index),
                                 density_fn, project_fn, mesh=mesh)
    return metrics


class MetricWriter:
    """JSONL metric log at ``<log_dir>/metrics.jsonl`` (dpcx's format)."""

    def __init__(self, log_dir: str | Path):
        self.path = Path(log_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, step: int, metrics: dict[str, Any]) -> None:
        rec = {"step": step}
        for k, v in metrics.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# Flags that change what a checkpoint's params MEAN without changing the
# param tree (dpcx/train.py _SEMANTIC_FLAGS); checked on every resume.
_SEMANTIC_FLAGS = (
    "predict_pose",
    "pose_predict_num_candidates",
    "pose_candidate_offsets",
    "pc_rgb",
    "pc_gauss",
)


def record_and_check_run_config(cfg: Config, write: bool = True) -> None:
    """Write the run config next to the checkpoints (first call) or verify
    the semantic flags against the recorded one (later calls)."""
    import yaml

    from dpcx_torch.config import save_config

    path = Path(cfg.checkpoint_dir) / "config.yaml"
    if not path.exists():
        if write:
            save_config(cfg, path)
        return
    with open(path) as f:
        saved = yaml.safe_load(f) or {}
    bad = {
        k: (saved[k], getattr(cfg, k))
        for k in _SEMANTIC_FLAGS
        if k in saved and saved[k] != getattr(cfg, k)
    }
    if bad:
        raise ValueError(
            f"checkpoints in {cfg.checkpoint_dir} were trained with "
            f"different pose/appearance semantics: "
            + ", ".join(
                f"{k}: saved={s!r} vs current={c!r}"
                for k, (s, c) in bad.items()
            )
            + " — evaluate with the recorded flags or point "
            "checkpoint_dir at a fresh run"
        )


def checkpoint_steps(cfg: Config) -> list[int]:
    """Steps of the port's checkpoints in ``checkpoint_dir/ckpt``, oldest
    first. Raises on an Orbax step directory (dpcx's format)."""
    ckpt = Path(cfg.checkpoint_dir) / "ckpt"
    if not ckpt.is_dir():
        return []
    orbax = sorted(p.name for p in ckpt.iterdir()
                   if p.is_dir() and p.name.isdigit())
    if orbax:
        raise ValueError(
            f"{ckpt} holds Orbax checkpoint step directories {orbax} "
            "written by dpcx; the PyTorch port cannot read them (it reads "
            "and writes <step>.pt files): point checkpoint_dir at a fresh "
            "run"
        )
    return sorted(int(p.stem) for p in ckpt.glob("*.pt") if p.stem.isdigit())


def save_checkpoint(cfg: Config, state: TrainState) -> Path:
    """``ckpt/<step>.pt`` (written whole, then renamed), keeping the newest
    ``KEEP_CHECKPOINTS``."""
    ckpt = Path(cfg.checkpoint_dir) / "ckpt"
    ckpt.mkdir(parents=True, exist_ok=True)
    path = ckpt / f"{state.step}.pt"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save({"params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    for old in checkpoint_steps(cfg)[:-KEEP_CHECKPOINTS]:
        (ckpt / f"{old}.pt").unlink()
    return path


def load_checkpoint(cfg: Config, device=None) -> dict | None:
    """The newest checkpoint's ``{"params", "opt_state", "step"}``, tensors
    on ``device``, or None when there is none."""
    steps = checkpoint_steps(cfg)
    if not steps:
        return None
    path = Path(cfg.checkpoint_dir) / "ckpt" / f"{steps[-1]}.pt"
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(cfg: Config, state: TrainState) -> TrainState:
    """Auto-resume from the newest checkpoint, if any."""
    device = next(state.model.parameters()).device
    saved = load_checkpoint(cfg, device)
    if saved is None:
        return state
    state.model.load_state_dict(saved["params"])
    state.optimizer.load_state_dict(saved["opt_state"])
    state.step = int(saved["step"])
    return state


def broadcast_state(state: TrainState) -> None:
    """Rank 0's step, parameters and Adam state into ``state`` on every
    rank of the default group, as dpcx re-places a restored state over its
    mesh."""
    device = next(state.model.parameters()).device
    step = torch.tensor([state.step], device=device)
    broadcast_([step])
    state.step = int(step)
    params = list(state.model.parameters())
    broadcast_([p.detach() for p in params])
    if state.step == 0:  # no Adam state to carry (torch makes it lazily)
        return
    opt = state.optimizer
    for p in params:
        if not opt.state[p]:
            opt.state[p] = {"step": torch.tensor(0.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
    adam = [opt.state[p] for p in params]
    counts = torch.stack([s["step"] for s in adam]).to(device)
    broadcast_([counts] + [s[k] for s in adam
                           for k in ("exp_avg", "exp_avg_sq")])
    for s, c in zip(adam, counts.cpu()):
        s["step"].copy_(c)


def data_ranks(cfg: Config, world: int) -> int:
    """dpcx's count of devices that take batch rows: the largest divisor
    of ``batch_size`` not above ``world``; 1 with ``shard_points``, whose
    batch stays whole (the points shard instead)."""
    if cfg.shard_points:
        return 1
    n = world
    while cfg.batch_size % n:
        n -= 1
    return n


def _beat(device, running: bool) -> bool:
    """One ``broadcast`` of rank 0's loop state to every rank of the
    default group: the ranks that take no step wait in it each pass."""
    flag = torch.tensor([int(running)], device=device)
    broadcast_([flag])
    return bool(flag)


def train(
    cfg: Config,
    dataset: Dataset | None = None,
    num_models: int = 200,
    max_steps: int | None = None,
    use_checkpoints: bool = True,
    device="cuda",
    eval_dataset: Dataset | None = None,
    mesh: Mesh | None = None,
) -> tuple[TrainState, list[dict]]:
    """Full training entry (dpcx's ``train``) on ``device``, over ``mesh``
    (None: dpcx's choice of ranks from the default group, one device each;
    see the module's docstring); returns the state and the logged metric
    records (``val_*`` ones too, with ``eval_dataset``). A rank that takes
    no step returns rank 0's final state and no records."""
    cfg.validate()
    device = torch.device(device)
    world, lead = world_size(), rank() == 0
    if mesh is None:
        mesh = make_mesh(cfg, ranks=range(data_ranks(cfg, world)),
                         device=device, join_all=cfg.shard_points)
    if cfg.shard_points and mesh.size > 1:
        raise ValueError("shard_points keeps the batch whole: its mesh is "
                         "the points', so train takes a mesh of one rank")
    # shard_points: every rank steps on the whole batch (the loss shards
    # the points over them); else the mesh's ranks step on their rows
    stepping = cfg.shard_points or mesh.index is not None
    dp = mesh if mesh.size > 1 else None
    waiting = world > mesh.world and not cfg.shard_points
    if dataset is None:
        if not lead:  # rank 0 makes and caches the shards first
            barrier(device)
        dataset = load_or_make(cfg, num_models, seed=cfg.seed, device=device)
        if lead:
            barrier(device)
    state = create_state(cfg, device)
    if use_checkpoints and lead:
        record_and_check_run_config(cfg)
        state = restore_checkpoint(cfg, state)
    if world > 1:
        broadcast_state(state)
    if not stepping:
        while _beat(device, True):
            pass
        broadcast_state(state)
        return state, []

    def crossed(prev: int, cur: int, every: int) -> bool:
        return every > 0 and cur // every > prev // every

    # every draw is a pure function of (seed, step): a resumed run replays
    # the uninterrupted run's batches and dropout
    base_key = prng.prng_key(cfg.seed + 1)
    max_steps = max_steps or cfg.max_number_of_steps
    history: list[dict] = []
    t0 = time.time()
    first_log = None  # (step, host time) of the first logged read-back
    start_step = step = state.step
    reseed_attempt = 0
    # dpcx's host-boundary chunk: with device_data the loop advances a
    # chunk of steps between host interactions
    chunk = max(1, min(cfg.log_every, cfg.save_every,
                       cfg.eval_every or cfg.save_every))
    rotate_blocks = (cfg.device_data
                     and 0 < cfg.device_records_models < dataset.num_models)
    if rotate_blocks:
        block_period = chunk * max(cfg.block_rotate_chunks, 1)
        records, cur_block = None, -1
    else:
        records = device_records(dataset, device) if cfg.device_data else None
    # one pass of the loop after the first (which holds the kernels' build
    # and the allocator's warm-up) runs under the trace, as in dpcx
    trace_state = "armed" if cfg.profile_dir and lead else "off"
    tracer = contextlib.ExitStack()
    writer = MetricWriter(cfg.checkpoint_dir) if lead else None
    with tracer, writer or contextlib.nullcontext():
        while step < max_steps:
            if waiting:
                _beat(device, True)
            prev_step = step
            if trace_state == "armed" and step >= start_step + chunk:
                tracer.enter_context(trace(cfg.profile_dir))
                trace_state = "on"
            elif trace_state == "on":
                tracer.close()  # synchronises, then writes the trace
                trace_state = "done"
            if cfg.device_data:
                n = min(chunk, max_steps - step)
                if rotate_blocks:
                    bi = step // block_period
                    if bi != cur_block:
                        records = device_block(dataset, cfg, bi, device)
                        cur_block = bi
                    # the chunk stays inside its block, so the stream is a
                    # function of (seed, step) across resumes
                    n = min(n, (bi + 1) * block_period - step)
                if dp is None:
                    metrics = train_steps_scan(cfg, state, records, base_key,
                                               n)
                else:
                    metrics = train_steps_scan_dp(cfg, state, records,
                                                  base_key, n, dp)
                batch = None
            else:
                batch = host_batch(cfg, dataset, step, device)
                metrics = train_step(
                    cfg, state, batch if dp is None else shard_batch(batch, dp),
                    base_key, mesh=dp)
            step = state.step
            if crossed(prev_step, step, cfg.log_every) or \
                    prev_step == start_step:
                with span("train.readback", step=step):
                    rec = {k: float(v) for k, v in metrics.items()}
                # from the first logged chunk's read-back on, the rate
                # leaves out that chunk's warm-up (the kernels' build, the
                # allocator's growth)
                now = time.time()
                if first_log is None:
                    rec["steps_per_sec"] = (step - start_step) / max(
                        now - t0, 1e-9)
                    first_log = (step, now)
                else:
                    rec["steps_per_sec"] = (step - first_log[0]) / max(
                        now - first_log[1], 1e-9)
                if writer:
                    writer.write(step, rec)
                history.append({"step": step, **rec})
            if (
                cfg.gauge_reseed_threshold_deg > 0
                and reseed_attempt < cfg.gauge_reseed_max_retries
                and prev_step < cfg.gauge_reseed_check_step <= step
            ):
                # the gauge never cohered: re-roll the init from a
                # per-attempt seed and restart the step count; the batch
                # stream stays a function of (seed, step). The averaged
                # metric is the same on every rank, and so is the choice
                gs = float(metrics.get("gauge_spread_deg", 0.0))
                if gs > cfg.gauge_reseed_threshold_deg:
                    reseed_attempt += 1
                    rec = {"gauge_reseed": reseed_attempt,
                           "gauge_spread_deg": gs}
                    if writer:
                        writer.write(step, rec)
                    history.append({"step": step, **rec})
                    state = create_state(
                        cfg, device,
                        seed=cfg.seed + 7919 * reseed_attempt)
                    if use_checkpoints and lead:
                        # else the dead attempt's checkpoints would win the
                        # newest-step restore on resume
                        for old in checkpoint_steps(cfg):
                            (Path(cfg.checkpoint_dir) / "ckpt"
                             / f"{old}.pt").unlink()
                    step = start_step = 0
                    t0, first_log = time.time(), None
                    continue
            if use_checkpoints and lead and crossed(prev_step, step,
                                                    cfg.save_every):
                save_checkpoint(cfg, state)
                if batch is None:  # dpcx's summary takes the host batch
                    batch = host_batch(cfg, dataset, step, device)
                _write_image_summary(cfg, state.model, batch, step)
            if eval_dataset is not None and crossed(prev_step, step,
                                                    cfg.eval_every or 0):
                # periodic held-out eval (the reference's train_eval), on
                # every stepping rank so that none waits in a collective
                val = evaluate(cfg, state.params, eval_dataset, batch_size=min(
                    cfg.batch_size, eval_dataset.num_models))
                val_rec = {f"val_{k}": v for k, v in val.items()}
                if writer:
                    writer.write(step, val_rec)
                history.append({"step": step, **val_rec})
        tracer.close()  # a trace that spanned the last chunk
        if use_checkpoints and lead:
            save_checkpoint(cfg, state)
    if waiting:
        _beat(device, False)
    if world > 1:  # the ranks end with rank 0's state
        broadcast_state(state)
    return state, history


def _write_image_summary(cfg: Config, model: ModelPointCloud, batch,
                         step: int) -> None:
    """Projected-cloud image grid beside the GT masks, under
    ``checkpoint_dir/summaries``. Best-effort: never stops training."""
    from dpcx_torch.utils.visualise import render_cloud_image, save_image_grid

    try:
        with torch.no_grad():
            points = model(batch["image"][:4])["points"]
        imgs = [render_cloud_image(cfg, p) for p in points]
        gt = [batch["masks"][i, 0].float().cpu().numpy()
              for i in range(len(imgs))]
        save_image_grid(
            imgs + gt,
            Path(cfg.checkpoint_dir) / "summaries" / f"proj_{step:07d}.png",
            cols=len(imgs),
        )
    except Exception as e:  # noqa: BLE001 — a summary must not stop training
        print(f"[dpcx_torch] image summary skipped: {e!r}", flush=True)
