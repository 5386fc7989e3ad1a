"""The numbers that decide a predicted-pose cell's ``correct``:
``check.train_numbers``'s (``points_gap``, ``render_gap``, ``grad_gap``,
``change_gap``, ``half_gap``, ``loss_gap``) and the pose path's own:

- ``select_gap``: the share of the (sample, view) pairs of every checked
  step, outside the tie band, whose winner the program and the reference
  pick differently (``reference.pose.choose``: within ``tie_margin`` of
  its second-best score the reference takes the program's winner, and
  that pair is not counted); 0 where no pair lies outside the band;
- ``select_regret``: the largest, over the pairs of every checked step,
  of how much the program's winner scores above the best candidate under
  the reference's scores (0 where the program picks the reference's best;
  a sound program's winners lie within the scores' rounding of it);
- ``quat_gap``: the largest angle, in degrees, between the program's and
  the reference's candidate cameras of the first step;
- ``student_gap``: the relative gap of the first step's student loss;
- ``decoder_half_gap``: ``half_gap`` over the decoder's leaves alone, the
  leaves only the renders' gradient reaches. The student's gradient,
  which reaches the encoder and the pose head from every row, dominates
  ``half_gap`` over all leaves, so a step that leaves half the rows'
  renders out of the gradient shows here and not there.

Readings for the limits' choice: ``score_gap``, the largest absolute gap
of a candidate's score over the checked steps (a winner can swap only
where the best two scores lie within twice it), and ``outside``, the pairs
counted.
"""

from __future__ import annotations

import math

import torch

from benchmark import check


def quat_angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle between the rotations of quaternions [..., 4], in
    degrees (q and -q are one rotation)."""
    a, b = a.double(), b.double()
    dot = (a * b).sum(-1).abs() / (torch.linalg.vector_norm(a, dim=-1)
                                   * torch.linalg.vector_norm(b, dim=-1))
    return torch.rad2deg(2.0 * torch.arccos(dot.clamp(0.0, 1.0)))


def numbers(prog: dict, ref: dict, start: dict) -> dict[str, float]:
    """``prog``: the driver's record of the program's first steps
    ({"losses", "grad1", "params", "first" (with "cameras"), "scores" (a
    step each), "student1"}); ``ref``: ``reference.pose.train_steps``'s,
    with "first" from ``first_outputs``."""
    out = check.train_numbers(prog, ref, start)
    pf, rf = prog.get("first"), ref.get("first")
    quat_gap = math.inf
    if pf is not None and rf is not None and \
            pf["cameras"].shape == rf["cameras"].shape:
        quat_gap = float(quat_angle_deg(pf["cameras"].cpu(),
                                        rf["cameras"].cpu()).max())
    score_gap = math.inf
    if len(prog["scores"]) == len(ref["scores"]) and all(
            a.shape == b.shape for a, b in zip(prog["scores"], ref["scores"])):
        score_gap = max(float((a.cpu() - b.cpu()).abs().max())
                        for a, b in zip(prog["scores"], ref["scores"]))
    student_gap = abs(prog["student1"] - ref["student1"]) / max(
        abs(ref["student1"]), 1e-30)
    decoder = [k for k in ref["grad1"] if k.startswith("decoder.")]
    if ref.get("grad1_half") is not None and decoder:
        out["decoder_half_gap"] = check.line_gap(
            {"grad1": {k: prog["grad1"][k] for k in decoder}},
            {"grad1": {k: ref["grad1"][k] for k in decoder},
             "grad1_half": {k: ref["grad1_half"][k] for k in decoder}},
            "grad1_half")
    out.update({
        "select_gap": (ref["differ"] / ref["outside"] if ref["outside"]
                       else 0.0),
        "select_regret": ref["regret"],
        "quat_gap": quat_gap,
        "student_gap": student_gap,
        "score_gap": score_gap,
        "outside": ref["outside"],
    })
    return {k: v if isinstance(v, int) or math.isfinite(v) else math.inf
            for k, v in out.items()}
