"""Config system: frozen dataclass defaults + YAML experiment overrides
(the port's own copy of ``dpcx/config.py``).

The port reads the same ``experiments/*.yaml`` as dpcx, so ``Config`` has
the same fields, types and defaults, and ``validate()`` the same checks and
messages (``tests/test_torch_config.py`` pins the copy to dpcx's). The copy
exists so that this package imports nothing of dpcx. Where dpcx counts
jax devices (the ``shard_points`` warning, ``train``'s mesh, the point
shards), the port counts the processes of the ``torch.distributed`` group,
one device each (``world_size``); ``mesh_shape`` and ``mesh_axes`` shape
its process mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import yaml


@dataclasses.dataclass(frozen=True)
class Config:
    # --- experiment identity ---
    name: str = "default"
    category: str = "chair"            # chair | car | airplane | synthetic
    checkpoint_dir: str = "runs/default"

    # --- point cloud / decoder (ref: dpc/nets/pc_decoder.py) ---
    pc_num_points: int = 8000
    pc_rgb: bool = False               # per-point RGB channels
    predict_scale: bool = True         # global sigmoid scale on the cloud
    # anisotropic Gaussian splats (BASELINE config 5, no reference
    # counterpart): per-point covariance + opacity, alpha-composited by
    # the DRC reduction (dpcx/render/gsplat.py)
    pc_gauss: bool = False
    gauss_scale_min: float = 0.005     # per-axis stddev bounds, NDC units
    gauss_scale_max: float = 0.06
    gsplat_impl: str = "dense"         # dense (all-cells oracle; runs at
                                       # VPU f32 speed-of-light — NOTES
                                       # r3 measurements) | pallas
                                       # (z-sorted window kernel, the
                                       # native fast path) | windowed
                                       # (one-hot matmul-scatter;
                                       # measured a PESSIMIZATION on TPU,
                                       # kept for comparison)
    gsplat_remat: bool = True          # checkpoint the windowed point-chunk
                                       # scan body: recomputing one chunk's
                                       # VPU exps in the backward is nearly
                                       # free, while saving them OOMs HBM at
                                       # B*V*n_chunks scale (measured: the
                                       # showcase config exceeds 15.75G
                                       # without this)
    pc_decoder_hidden: tuple[int, ...] = (1024, 1024, 1024)

    # --- encoder (ref: dpc/nets/img_encoder.py) ---
    image_size: int = 128
    encoder_filters: tuple[int, ...] = (32, 64, 96, 128, 192)
    latent_dim: int = 1024
    fc_hidden: int = 1024

    # --- renderer (ref: dpc/util/point_cloud.py, drc.py, gauss_kernel.py) ---
    vox_size: int = 64                 # D: occupancy grid is D^3
    focal_length: float = 1.875
    camera_distance: float = 2.0
    pc_relative_sigma: float = 0.05    # Gaussian sigma relative to grid extent
    pc_relative_sigma_end: float = 0.016
    sigma_anneal_steps: int = 100_000  # exponential sigma_start->sigma_end
    gauss_kernel_truncate: float = 2.5 # kernel half-width in sigmas
    proj_type: str = "drc"             # drc | sum (flag-gated, ref drc.py)
    drc_logsum: bool = False           # log-space product variant
    proj_depth: bool = False           # also render expected depth
    pc_point_dropout: float = 0.1      # initial keep-prob (anneals to 1.0)
    pc_point_dropout_steps: int = 50_000
    renderer: str = "xla"              # xla | pallas (same interface)
    pallas_acc_dtype: str = "float32"  # matmul operand dtype in the fused
                                       # kernel: float32 (parity) | bfloat16
                                       # (perf; fp32 accumulate either way)
    xla_splat: str = "auto"            # scatter | matmul | auto (matmul on
                                       # TPU — scatter-add serializes badly
                                       # there — scatter oracle on CPU)

    # --- pose (ref: dpc/models/model_pc.py::predict_pose) ---
    predict_pose: bool = False
    pose_predict_num_candidates: int = 4
    # fixed azimuth rotations per candidate (uniform about the vertical
    # axis), composed with predicted corrections — the ensemble covers the
    # flip/azimuth modes by construction (paper pose-ensemble design)
    pose_candidate_offsets: bool = True
    pose_student: bool = True
    pose_student_weight: float = 20.0
    # linear warmup of the student weight over this many steps (0 = the
    # reference behavior, full weight from step 0). Early in training the
    # argmin teacher is noise; its distillation gradient flows through the
    # SHARED pose trunk (fc0 + encoder) and can perturb gauge locking —
    # round-4 gauge-lottery mechanism (c)
    pose_student_warmup_steps: int = 0
    # candidate re-anchoring — round-4 gauge-lottery mechanism (b): a
    # regularizer pulling each candidate's CORRECTION quaternion (the
    # learned rotation composed with its fixed azimuth offset) toward
    # identity, so every offset keeps owning its azimuth sector instead of
    # two candidates drifting onto the same mode and leaving the mirror
    # mode uncovered. Loss = mean(1 - w^2) over corrections (sign-invariant
    # angular distance to identity).
    pose_anchor_weight: float = 0.0
    # >0: the anchor weight decays linearly to 0 over this many steps —
    # pull hard while the gauge locks (coarse-sigma phase), then free the
    # corrections to fine-tune elevation/azimuth within their sector
    pose_anchor_steps: int = 0
    # "full": anchor the whole correction to identity (measured HARMFUL on
    # airplane at weight 1.0 — it also freezes the elevation correction
    # during the lock-in window, so no candidate can match the view and
    # the argmin stays noise). "azimuth": penalize only the vertical-axis
    # component of the correction (q_y^2) — offsets keep owning their
    # azimuth sector while elevation/roll corrections stay free
    pose_anchor_mode: str = "full"
    # soft-min -> hard-min annealing — round-4 gauge-lottery mechanism
    # (d): replace the hard argmin over candidate scores with a softmax
    # weighting at a temperature that decays linearly to 0 over
    # pose_softmin_steps. Early in training every candidate receives
    # (score-weighted) projection gradient, so the per-input gauge
    # assignment stays PLASTIC instead of reinforcing whichever offset
    # happened to win the first coin flips (failing seeds lock a
    # per-input mirror gauge with flip_rate~0.5 — POSE_RESULTS finding
    # 12). The temperature is RELATIVE: T = temp * stop_grad(batch-mean
    # score) * (1 - step/steps), so the knob is dimensionless. 0 = the
    # reference hard-min from step 0.
    pose_softmin_temp: float = 0.0
    pose_softmin_steps: int = 0
    # cross-view shape consistency — round-4 gauge-lottery mechanism (e):
    # decode a SECOND view of the same model each step and penalize the
    # symmetric Chamfer distance between the two canonical clouds. A
    # per-input mirror gauge makes two views of one model decode to
    # mirrored canonical shapes, which this term punishes directly —
    # ties the gauge per MODEL without any pose supervision. Motivated by
    # the flip-resolver negative (the decoder co-flips with the pose even
    # on held-out inputs, so the gauge must be fixed at training time).
    pose_consistency_weight: float = 0.0
    # pose-from-views — round-4 gauge-lottery mechanism (f), and the
    # reference's actual unknown-pose protocol (dpc paper §"learning with
    # unknown pose": shape and pose are predicted from DIFFERENT views of
    # the object): each target view's K candidate poses are predicted
    # from THAT view's own image and the input view's shape is rendered
    # under them directly (q_k(v) = object->camera_v), with the hard-min
    # selection per (sample, view). False = pose predicted from the input
    # view and composed with GT relative rig rotations (q_rel(v) * q_k) —
    # the rounds-1-3 formulation, which needs MORE supervision (the rig)
    # and lets a mirrored (shape, pose) pair stay self-consistent because
    # both flip bits come from the same image: the per-input mirror coin
    # flip of POSE_RESULTS finding 12. With per-view poses the shape's
    # flip bit (input view) and each pose's flip bit (target views) are
    # computed from different images, so random view pairings punish any
    # per-IMAGE gauge and force a per-OBJECT canonical frame.
    pose_from_views: bool = False
    # auto-reseed on detected gauge failure (POSE_RESULTS finding 21):
    # the pose lottery's failure mode — a per-view gauge that never
    # coheres into one canonical frame — is visible tens of thousands of
    # steps before the end in the live, GT-free gauge_spread_deg metric
    # (pfv winner quats vs the camera rig; healthy runs <~15 deg, failed
    # ~55+). When threshold_deg > 0, train() checks the metric the first
    # time training crosses check_step; if it exceeds the threshold the
    # attempt is abandoned: parameters re-initialize from a deterministic
    # per-attempt key, the dead attempt's checkpoints are deleted, and
    # the step counter restarts, up to max_retries times. The batch
    # stream stays a pure function of (seed, step) — only the init
    # re-rolls — so bit-reproducible resume is preserved. pfv-only (the
    # metric is 0 by construction in input-view-pose mode).
    gauge_reseed_threshold_deg: float = 0.0  # 0 disables
    gauge_reseed_check_step: int = 10_000
    gauge_reseed_max_retries: int = 3
    predict_translation: bool = False  # per-candidate camera-frame offset
    translation_weight: float = 0.0    # L2 regularizer on the offset

    # --- losses ---
    proj_weight: float = 1.0
    # normalize the per-candidate silhouette and rgb error scales (each by
    # its stop-gradient batch mean) before the hard-min argmin, so the
    # SELECTION weighs both signals O(1) regardless of raw magnitudes.
    # Without this the raw sum is dominated by whichever term is larger
    # and late-training winner flips were observed (rgb-in-selection car
    # runs, round 2); the LOSS values themselves are unchanged.
    rgb_sel_normalize: bool = True
    drc_weight: float = 0.0            # depth-projection loss weight
    scale_weight: float = 0.0          # scale regularizer
    rgb_weight: float = 1.0            # color re-projection loss (pc_rgb)
    rgb_background: float = 1.0        # bg color composited into rendered
                                       # rgb before the loss (datagen
                                       # composites a white background)

    # --- training (ref: dpc/run/train_eval.py) ---
    batch_size: int = 16
    num_views: int = 5                 # candidate projection views per model
    views_per_step: int = 4            # views used for the loss each step
    learning_rate: float = 1e-4
    max_number_of_steps: int = 100_000
    save_every: int = 2000
    log_every: int = 100
    eval_every: int = 0                # 0 = no periodic eval during train
    profile_dir: str = ""              # write ONE torch.profiler trace
                                       # of the chunk after the first here
                                       # (Chrome JSON; the program's spans,
                                       # utils/profiling.py, over kernels)
    seed: int = 0
    compute_dtype: str = "bfloat16"    # encoder/decoder matmul dtype
    renderer_dtype: str = "float32"    # splat/blur/DRC accumulate dtype

    # --- data ---
    dataset: str = "synthetic"         # synthetic | npz
    # synthetic-datagen texture: "stripes" = per-part palette x high-freq
    # procedural stripes (~30+ cycles across the object — at/above Nyquist
    # when the rgb loss compares at mask resolution D=32, so the
    # symmetry-breaking signal mostly aliases away); "lowfreq" = per-part
    # palette blended with a two-tone front/back split (<1 cycle, survives
    # any loss resolution — the control for whether rgb-in-selection can
    # break silhouette-mirror pose gauges)
    texture_mode: str = "stripes"
    rgb_warmup_steps: int = 0          # >0: linear warmup of the color
                                       # loss weight AND its selection
                                       # influence (predicted-pose) —
                                       # geometry locks before rgb carries
                                       # weight (collapse mitigation)
    data_dir: str = "data"
    mask_size: int = 64                # projection/mask resolution (== D)
    remat: bool = False                # jax.checkpoint the loss forward:
                                       # recompute render residuals in the
                                       # backward instead of storing them
                                       # (HBM relief for big K-render
                                       # graphs at ~1.3x step cost)
    device_data: bool = True           # keep the dataset device-resident and
                                       # sample batches inside the jitted
                                       # scan (zero host work per step)
    device_records_models: int = 0     # >0: rotate blocks of this many
                                       # models through device memory (the
                                       # big-dataset path — datasets beyond
                                       # HBM train with one host->device
                                       # block transfer per rotation instead
                                       # of the leaking host-fed dispatch)
    block_rotate_chunks: int = 4       # scan chunks trained per resident
                                       # block before rotating

    # --- parallelism (new capability; reference is single-GPU) ---
    mesh_shape: tuple[int, ...] = (-1,)  # -1 = all devices, data-parallel
    mesh_axes: tuple[str, ...] = ("data",)
    # shard the POINT axis of the GT-pose render over the device mesh
    # (render/sharded.py): the scale lever for clouds too large to splat
    # on one device (N >> 100k). The mesh axis is consumed inside the
    # loss, so the batch stays replicated — mutually exclusive with
    # data-parallel batch sharding (train() keeps the outer mesh trivial
    # when this is set). No-op on a single device.
    shard_points: bool = False

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def effective_mask_size(self) -> int:
        return self.vox_size

    def validate(self) -> "Config":
        """Reject silently-contradictory knob combinations.

        Called by every CLI entry point and by ``train()``; direct
        ``Config(...)`` construction stays unvalidated so tests and
        scripts can build partial configs. Each trap below corresponds
        to a code path that would otherwise IGNORE a knob the user set
        (the reference's app_config has no such cross-flag checks — its
        flags are consumed unconditionally — so this is a new surface).
        """
        errs: list[str] = []
        enums = {
            "renderer": ("xla", "pallas"),
            "gsplat_impl": ("dense", "pallas", "windowed"),
            "proj_type": ("drc", "sum"),
            "xla_splat": ("scatter", "matmul", "auto"),
            "pose_anchor_mode": ("full", "azimuth"),
            "texture_mode": ("stripes", "lowfreq"),
            "pallas_acc_dtype": ("float32", "bfloat16"),
            "compute_dtype": ("float32", "bfloat16"),
            "renderer_dtype": ("float32", "bfloat16"),
            "dataset": ("synthetic", "npz"),
        }
        for knob, allowed in enums.items():
            if getattr(self, knob) not in allowed:
                errs.append(
                    f"{knob}={getattr(self, knob)!r} not in {allowed}"
                )
        if self.shard_points and self.predict_pose:
            errs.append(
                "shard_points is only implemented for the GT-pose loss "
                "branch (models/losses.py routes the predicted-pose "
                "render unsharded, silently ignoring the knob)"
            )
        if self.shard_points and self.pc_gauss:
            errs.append(
                "shard_points is ignored when pc_gauss is set: the "
                "gsplat branch renders unsharded"
            )
        if not self.predict_pose:
            for knob in ("pose_from_views", "predict_translation"):
                if getattr(self, knob):
                    errs.append(
                        f"{knob} requires predict_pose: the pose head "
                        "is only built in predicted-pose mode"
                    )
            for knob in (
                "pose_anchor_weight",
                "pose_softmin_temp",
                "pose_consistency_weight",
            ):
                if getattr(self, knob) > 0:
                    errs.append(f"{knob} > 0 requires predict_pose")
        if self.pose_consistency_weight > 0 and self.num_views < 2:
            errs.append(
                "pose_consistency_weight needs num_views >= 2 (a "
                "second view of each model to decode)"
            )
        if self.gauge_reseed_threshold_deg > 0 and not self.pose_from_views:
            errs.append(
                "gauge_reseed_threshold_deg requires pose_from_views "
                "(the live gauge_spread_deg metric is 0 by construction "
                "in input-view-pose mode, so the detector never fires)"
            )
        if errs:
            raise ValueError(
                "invalid config:\n  - " + "\n  - ".join(errs)
            )
        if self.shard_points and world_size() == 1:
            import warnings

            warnings.warn(
                "shard_points on a single device is a no-op (the "
                "point axis has nothing to shard over)",
                stacklevel=2,
            )
        return self


def world_size() -> int:
    """The processes of the default ``torch.distributed`` group (1 without
    one): the port's device count, one card per process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


_TUPLE_FIELDS = {
    f.name
    for f in dataclasses.fields(Config)
    if "tuple" in str(f.type)
}


def load_config(yaml_path: str | Path | None = None, **overrides: Any) -> Config:
    """defaults <- YAML <- kwargs, mirroring app_config's flag merging."""
    merged: dict[str, Any] = {}
    if yaml_path is not None:
        with open(yaml_path) as f:
            loaded = yaml.safe_load(f) or {}
        merged.update(loaded)
    merged.update(overrides)
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = set(merged) - known
    if unknown:
        raise ValueError(f"Unknown config keys: {sorted(unknown)}")
    for k in list(merged):
        if k in _TUPLE_FIELDS and isinstance(merged[k], list):
            merged[k] = tuple(merged[k])
    return Config(**merged)


def save_config(cfg: Config, path: str | Path) -> None:
    d = dataclasses.asdict(cfg)
    for k, v in d.items():
        if isinstance(v, tuple):
            d[k] = list(v)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
