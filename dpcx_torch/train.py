"""Training loop for GT pose: Adam, one eager step per batch, ``torch.save``
checkpoints, JSONL metrics (port of ``dpcx/train.py``).

Differences from the reference, by design:

- one Python loop of eager steps instead of the jitted ``lax.scan`` of
  ``train_steps_scan``: every step's batch comes from
  ``Dataset.batch(np.random.default_rng((cfg.seed, step)))``, the stream of
  the reference's host-fed path, so the data is a pure function of
  ``(seed, step)`` and a dpcx run with ``device_data: false`` sees the
  same batches. With ``device_data`` the records live on the device and
  the batch is gathered there with the same indices;
- point dropout draws from a ``torch.Generator`` reseeded from
  ``(seed + 1, step)`` every step, so a resumed run replays the
  uninterrupted run's dropout as well;
- checkpoints are ``checkpoint_dir/ckpt/<step>.pt`` files holding
  ``{"params", "opt_state", "step"}``, the newest 3 kept (Orbax's
  ``max_to_keep``). An Orbax step directory there is refused, never read.

Not ported yet, and refused: predicted pose and the gauge reseed (ROADMAP
queue 1 item 4), periodic eval (item 3), profiling (item 8), point
sharding (item 9), block rotation (item 10: it rotates the records of
dpcx's device-side batch stream, which this loop does not follow).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dpcx_torch.config import Config
from dpcx_torch.data.dataset import Dataset, load_or_make
from dpcx_torch.models.losses import compute_loss
from dpcx_torch.models.model_pc import ModelPointCloud

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
                 generator: torch.Generator | None = None) -> TrainState:
    """Seeded model (``generator``, or one seeded with ``cfg.seed``) and
    its Adam."""
    model = ModelPointCloud(cfg, device=device, generator=generator)
    # betas and eps are optax.adam's defaults, as dpcx's create_state uses
    optimizer = torch.optim.Adam(
        model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
        eps=1e-8,
    )
    return TrainState(model, optimizer)


def apply_model(cfg: Config, model: ModelPointCloud,
                batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The GT-pose model application: the input view's forward."""
    if "image_in2" in batch or "images_v" in batch:
        raise NotImplementedError(
            "second-view and per-view pose inputs come with predicted pose "
            "(ROADMAP queue 1 item 4)"
        )
    return model(batch["image"])


def train_step(
    cfg: Config,
    state: TrainState,
    batch: dict[str, torch.Tensor],
    generator: torch.Generator | None,
) -> dict[str, torch.Tensor]:
    """One step (forward, render, backward, Adam) on ``state`` in place;
    returns the metrics as device tensors, ``grad_norm`` included.

    With ``cfg.remat`` model plus loss run under ``torch.utils.checkpoint``
    (dpcx's ``jax.checkpoint`` of its ``loss_fn``): their activations are
    recomputed in the backward instead of being kept. The recompute must
    draw the same dropout weights, but checkpoint restores only the
    default generators, not ``generator``: so its state is taken before
    the forward and set again at the top of every run of the function.
    """
    gen_state = None if generator is None else generator.get_state()

    def loss_fn():
        if gen_state is not None:
            generator.set_state(gen_state)
        preds = apply_model(cfg, state.model, batch)
        return compute_loss(cfg, preds, batch, state.step, generator,
                            train=True)

    if cfg.remat:
        from torch.utils.checkpoint import checkpoint

        loss, metrics = checkpoint(loss_fn, use_reentrant=False)
    else:
        loss, metrics = loss_fn()
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        # optax updates every leaf; a parameter the loss never reached
        # (the unused pose branch) takes a zero gradient here too, so each
        # parameter's Adam step count stays the global one
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    metrics["grad_norm"] = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
    )  # optax.global_norm
    opt.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step: a pure function of (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def device_records(dataset: Dataset, device) -> dict[str, torch.Tensor]:
    return {
        k: torch.as_tensor(v, dtype=torch.float32).to(device)
        for k, v in dataset.records.items()
        if k in ("images", "masks", "depths", "quats")
    }


def _prep_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    """numpy batch -> float32 tensors on ``device``, the fields the loss
    reads."""
    keys = ("image", "masks", "quats", "depths")
    return {
        k: torch.as_tensor(batch[k], dtype=torch.float32).to(device)
        for k in keys if k in batch
    }


def batch_at(cfg: Config, dataset: Dataset, step: int, device,
             records: dict[str, torch.Tensor] | None = None) -> dict:
    """The batch of ``step``: numpy draws from ``default_rng((seed,
    step))``, gathered from device-resident ``records`` when given."""
    rng = np.random.default_rng((cfg.seed, step))
    if records is None:
        return _prep_batch(dataset.batch(rng, cfg.batch_size), device)
    m, v_in, v_tgt = (
        torch.from_numpy(a).to(device)
        for a in dataset.batch_indices(rng, cfg.batch_size)
    )
    return {
        "image": records["images"][m, v_in],
        "masks": records["masks"][m[:, None], v_tgt],
        "depths": records["depths"][m[:, None], v_tgt],
        "quats": records["quats"][m[:, None], v_tgt],
    }


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


def _refuse_unported(cfg: Config) -> None:
    refusals = [
        (cfg.predict_pose or cfg.gauge_reseed_threshold_deg > 0,
         "predicted pose and the gauge reseed", 4),
        (cfg.eval_every > 0, "periodic eval (eval_every > 0)", 3),
        (cfg.device_records_models > 0, "device_records_models > 0", 10),
        (bool(cfg.profile_dir), "profile_dir", 8),
        (cfg.shard_points, "shard_points", 9),
    ]
    for hit, what, item in refusals:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1 item {item})"
            )


def train(
    cfg: Config,
    dataset: Dataset | None = None,
    num_models: int = 200,
    max_steps: int | None = None,
    use_checkpoints: bool = True,
    device="cuda",
) -> tuple[TrainState, list[dict]]:
    """Full training entry on one ``device``; returns the state and the
    logged metric records."""
    _refuse_unported(cfg)
    cfg.validate()
    device = torch.device(device)
    state = create_state(cfg, device)
    if use_checkpoints:
        record_and_check_run_config(cfg)
        state = restore_checkpoint(cfg, state)
    if dataset is None:
        dataset = load_or_make(cfg, num_models, seed=cfg.seed, device=device)
    records = device_records(dataset, device) if cfg.device_data else None

    def crossed(prev: int, cur: int, every: int) -> bool:
        return every > 0 and cur // every > prev // every

    max_steps = max_steps or cfg.max_number_of_steps
    history: list[dict] = []
    t0 = time.time()
    start_step = step = state.step
    with MetricWriter(cfg.checkpoint_dir) as writer:
        while step < max_steps:
            prev_step = step
            batch = batch_at(cfg, dataset, step, device, records)
            metrics = train_step(cfg, state, batch,
                                 step_generator(cfg.seed + 1, step, device))
            step = state.step
            if crossed(prev_step, step, cfg.log_every) or \
                    prev_step == start_step:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["steps_per_sec"] = (step - start_step) / max(
                    time.time() - t0, 1e-9)
                writer.write(step, rec)
                history.append({"step": step, **rec})
            if use_checkpoints and crossed(prev_step, step, cfg.save_every):
                save_checkpoint(cfg, state)
                _write_image_summary(cfg, state.model, batch, step)
        if use_checkpoints:
            save_checkpoint(cfg, state)
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
