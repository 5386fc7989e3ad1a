"""Predicted-pose training cells: dpcx's shape-and-pose training as ``cli
train`` runs it (``train_steps_scan`` chunks on records resident on the
card, each chunk's metrics read back), held to the plain reference of the
pose path (``benchmark/reference/pose.py``).

The set-up, the window, its metrics and the result are the GT-pose
driver's (``drivers/train.py::run``, imported and run as it is); this
module hands it the parts where the pose path differs:

- the first steps (``first_steps``): besides the losses, the first
  gradient and the parameters after them, each step's selection scores
  [B, K, V] as the loss computes them (``losses.candidate_scores``
  wrapped), the first step's student loss, and its renderer call: each
  sample's points, the candidate cameras it rendered through [B, K, V,
  4] and the B x K x V silhouettes;
- the reference (``reference``): ``reference/pose.py`` follows the same
  steps from the same seeded records and weights, taking the program's
  winner where its own best two candidates lie within the cell's
  ``tie_margin`` (``benchmark/workloads/<cell>.json``), and renders the
  program's points through the program's cameras;
- the numbers (``benchmark/check_pose.py``);
- the metrics' context: each sample makes K x V renders a step.
"""

from __future__ import annotations

import contextlib
import functools
import math
import types

from benchmark import check, check_pose, harness
from benchmark.drivers import train as gt
from benchmark.reference import exact_f32
from benchmark.reference import pose as ref_pose

BLOCK_ROWS = 64  # the reference's rows at a time: 2,048 renders at K 8, V 4


@contextlib.contextmanager
def observed(scores: list, calls: list | None = None, fan: int = 1):
    """Inside the block, each selection's scores (detached copies) into
    ``scores`` and, with ``calls``, each renderer call of the pose loss:
    {"points" (every ``fan``-th of the call's clouds: one a sample),
    "quats" (the call's cameras), "silhouette"}. The calls are the
    program's, unchanged."""
    from dpcx_torch.models import losses

    score, project = losses.candidate_scores, losses.pointcloud_project_fn

    def scoring(*a, **k):
        out = score(*a, **k)
        scores.append(out.detach().float().clone())
        return out

    def recording(cfg, points, quat, *a, **k):
        out = project(cfg, points, quat, *a, **k)
        calls.append({"points": points.detach()[::fan].float().clone(),
                      "quats": quat.detach().float().clone(),
                      "silhouette": out.silhouette.detach().float().clone()})
        return out

    losses.candidate_scores = scoring
    if calls is not None:
        losses.pointcloud_project_fn = recording
    try:
        yield
    finally:
        losses.candidate_scores = score
        losses.pointcloud_project_fn = project


def first_steps(p: gt.Program, n: int, fan: int) -> dict:
    """``n`` steps, one call each: {"losses", "grad1" (from Adam's first
    moment after the first step), "params" (after the last), "scores"
    (each step's), "student1" (the first step's student loss), "first"
    (its renderer call: "points" [B, N, 3], "cameras" [B, K, V, 4],
    "silhouette", "depth" None; or None)}; ``fan`` = K x V."""
    import torch

    opt = p.state.optimizer
    losses, grad1, calls, scores, student1 = [], None, [], [], math.nan
    for i in range(n):
        with observed(scores, calls if i == 0 else None, fan):
            rec = gt.read(p.steps(1))
        losses.append(rec["loss_total"])
        if grad1 is None:
            student1 = rec.get("loss_student", math.nan)
            grad1 = {k: opt.state[w]["exp_avg"].detach() / (1 - gt.BETA1)
                     if opt.state.get(w) else torch.zeros_like(w)
                     for k, w in p.named.items()}
    first = None
    if len(calls) == 1:
        c = calls[0]
        B = c["points"].shape[0]
        first = {"points": c["points"], "silhouette": c["silhouette"],
                 "depth": None,
                 "cameras": c["quats"].reshape(
                     B, p.cfg.pose_predict_num_candidates, -1, 4)}
    return {"losses": losses, "grad1": grad1, "scores": scores,
            "student1": student1, "first": first,
            "params": {k: w.detach().clone() for k, w in p.named.items()}}


def reference(settings: dict, p: gt.Program, n: int, ranks: int,
              operand: str = "float32", points=None,
              tie_margin: float = 0.0) -> dict:
    """The reference's first ``n`` steps on the program's inputs, and its
    first step's outputs; ``points``: the program's record of its first
    steps (``first_steps``), whose scores it follows within
    ``tie_margin`` and whose points and cameras it renders (None: its own
    winners and renders)."""
    if ranks != 1:
        raise ValueError("the pose reference follows one card's steps")
    prog = points or {}
    first = prog.get("first") or {}
    if first and first["points"].shape[0] != settings["batch_size"]:
        first = {}  # the program rendered other rows: judged as none
    with exact_f32():
        out = ref_pose.train_steps(settings, p.start, p.records, p.key, n,
                                   operand=operand, block_rows=BLOCK_ROWS,
                                   follow=prog.get("scores"),
                                   tie_margin=tie_margin)
        out["first"] = ref_pose.first_outputs(
            settings, p.start, p.records, p.key, first.get("points"),
            first.get("cameras"), operand, block_rows=BLOCK_ROWS)
    return out


class _Harness:
    """``harness`` as the GT driver reads it, its metrics' context
    counting each sample's K x V renders where the GT driver counts V."""

    def __init__(self, candidates: int):
        self.candidates = candidates

    def __getattr__(self, name):
        return getattr(harness, name)

    def MetricContext(self, **kw):  # noqa: N802 (harness's name)
        return harness.MetricContext(
            **{**kw, "renders": kw["renders"] * self.candidates})


@contextlib.contextmanager
def pose_parts(cell):
    """The GT driver with the pose path's parts inside the block."""
    K = cell.settings()["pose_predict_num_candidates"]
    parts = {
        "first_steps": lambda p, n, views: first_steps(p, n, K * views),
        "judged_points": lambda prog, rows: prog,
        "reference": functools.partial(
            reference, tie_margin=cell.workload["tie_margin"]),
        "check": types.SimpleNamespace(train_numbers=check_pose.numbers,
                                       verdict=check.verdict),
        "harness": _Harness(K),
    }
    saved = {name: getattr(gt, name) for name in parts}
    for name, value in parts.items():
        setattr(gt, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(gt, name, value)


def run(r: harness.Run) -> dict | None:
    with pose_parts(r.cell):
        return gt.run(r)
