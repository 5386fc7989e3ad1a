"""The numbers that decide ``correct``, and the verdict against each
number's limit (the cell's ``benchmark/workloads/<name>.json``).

Training (the set-up's first steps, program against reference):

- ``loss_gap``: the largest over the steps of |loss - reference's| over
  |reference's|;
- ``grad_gap``: the first step's gradient as the optimizer got it (the
  program's from its Adam state after one step), leaf by leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf
  (``grad_gap_median``: the median leaf);
- ``change_gap`` (``change_gap_median``): the same of each leaf's change
  over the steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf the loss never reaches moves by
  round-off alone);
- ``exchange_gap`` (several ranks): where the program's first gradient
  lies on the line from the reference's gradient of rank 0's rows alone
  (0) to the reference's gradient exchanged over the ranks (1), all
  leaves as one vector: |1 - t|. Rounding moves a gradient in no
  particular direction, so a sound run reads near 0; a step that skips
  the exchange reads near 1;
- ``half_gap``: the same on the line from the reference's gradient of
  the first half of each rank's rows alone, the mean over them (0), to
  the whole batch's (1). A step that leaves half its rows out of the
  gradient and takes the mean over the rest reads near 1, whether or not
  its shapes and its loss show it;
- ``points_gap``: the first step's model outputs, the points of each
  sample: the largest over the samples of the L2 distance from the
  reference's points over their L2 norm;
- ``render_gap``: the first step's renders, the silhouettes and depths
  the program's renderer made of its points, against the reference
  renderer's of the same points through the reference's cameras, sigma
  and dropout weights: the largest absolute difference.

Rendering (each sampled call of the window against the reference on the
same inputs and cotangents):

- ``image_gap``: the largest absolute difference of the silhouettes and
  depths;
- ``grad_gap`` (``grad_gap_median``): the worst (the median) render's
  L2 distance of the point gradients, over the larger of its reference
  norm and the median render's.

A cell's ``limits`` name the numbers that decide its ``correct``; the
others are readings for the limits' choice.
"""

from __future__ import annotations

import math
import statistics

import torch

NOUGHT = 1e-3  # a leaf gradient below this share of the median leaf's


def _norms(leaves: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def _leaf_gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    names = list(names)
    pn, rn = _norms({k: prog[k] for k in names}), _norms(
        {k: ref[k] for k in names})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def train_leaf_gaps(prog: dict, ref: dict, start: dict
                    ) -> tuple[dict, dict]:
    """(the first gradient's gap by leaf, the change's gap by moved
    leaf)."""
    names = list(ref["grad1"])
    gn = _norms(ref["grad1"])
    med = statistics.median(gn.values())
    moved = [k for k in names if gn[k] >= NOUGHT * med]
    return (_leaf_gaps(prog["grad1"], ref["grad1"], names),
            _leaf_gaps({k: prog["params"][k].float() - start[k]
                        for k in moved},
                       {k: ref["params"][k] - start[k] for k in moved},
                       moved))


def _image_gap(prog: dict, ref: dict) -> float:
    gap = float((prog["silhouette"] - ref["silhouette"]).abs().max())
    if ref["depth"] is not None:
        gap = max(gap, float((prog["depth"] - ref["depth"]).abs().max()))
    return gap


def first_gaps(prog: dict | None, ref: dict | None) -> dict[str, float]:
    """``points_gap`` and ``render_gap`` of the first step's outputs
    ({"points", "silhouette", "depth"} each); inf where the program made
    none or a different number of them."""
    if prog is None or ref is None or any(
            (prog[k] is None) != (ref[k] is None) or (
                prog[k] is not None and prog[k].shape != ref[k].shape)
            for k in ("points", "silhouette", "depth")):
        return {"points_gap": math.inf, "render_gap": math.inf}
    p, r = prog["points"].double(), ref["points"].double()
    rn = torch.linalg.vector_norm(r.flatten(1), dim=1)
    dn = torch.linalg.vector_norm((p - r).flatten(1), dim=1)
    out = {"points_gap": float((dn / rn.clamp_min(1e-30)).max()),
           "render_gap": _image_gap(prog, ref)}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def line_gap(prog: dict, ref: dict, start: str) -> float:
    """|1 - t| for the program's first gradient g = g0 + t (g1 - g0), t
    by least squares: g0 the reference's ``ref[start]``, g1 its whole
    first gradient."""
    names = list(ref["grad1"])

    def flat(leaves):
        return torch.cat([leaves[k].double().flatten() for k in names])

    g, g1 = flat(prog["grad1"]), flat(ref["grad1"])
    g0 = flat(ref[start])
    d = g1 - g0
    t = float(torch.dot(g - g0, d) / torch.dot(d, d).clamp_min(1e-300))
    return abs(1.0 - t) if math.isfinite(t) else math.inf


def train_numbers(prog: dict, ref: dict, start: dict) -> dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad1", "params"} as
    ``reference.model.train_steps`` returns them; ``start``: the
    parameters both began from."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(x) for x in prog["losses"]):
        loss_gap = math.inf
    grad, change = train_leaf_gaps(prog, ref, start)
    lines = {name: line_gap(prog, ref, start)
             for name, start in (("exchange_gap", "grad1_rank0"),
                                 ("half_gap", "grad1_half"))
             if ref.get(start) is not None}
    return {**first_gaps(prog.get("first"), ref.get("first")), **lines,
            "loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "change_gap_median": statistics.median(change.values())}


def render_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref``: {"silhouette", "depth" (or None),
    "grad"} of one call."""
    image_gap = _image_gap(prog, ref)
    g, r = prog["grad"].double(), ref["grad"].double()
    rn = torch.linalg.vector_norm(r.flatten(1), dim=1)
    dn = torch.linalg.vector_norm((g - r).flatten(1), dim=1)
    by_render = dn / torch.maximum(rn, rn.median())
    out = {"image_gap": image_gap, "grad_gap": float(by_render.max()),
           "grad_gap_median": float(by_render.median())}
    if not all(math.isfinite(v) for v in out.values()):
        out = {k: math.inf for k in out}
    return out


def verdict(numbers: dict[str, float], limits: dict[str, float]
            ) -> tuple[bool, dict]:
    """(every number the cell's ``limits`` name within its limit,
    {name: {"value", "limit"}} of those). Limits that name nothing fail."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    ok = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
