"""Faults of the predicted-pose path, planted in the port underneath the
timed path: what a pose cell's ``correct`` has to come out false for. They
patch the port's modules in this process only; the benchmark's own runs
plant nothing.

- ``argmax``: each (sample, view) takes its worst candidate, not its best
  (the scores negated before the hard min);
- ``view0``: every target view takes view 0's winner;
- ``live_teacher``: the student's teacher is left undetached, so the
  student loss also pulls the winning candidate toward the student. The
  loss's value is unchanged; its gradient is not.

Other modes plant nothing here (``benchmark.faults`` has the shared
ones).
"""

from __future__ import annotations

import contextlib

MODES = ("argmax", "view0", "live_teacher")


@contextlib.contextmanager
def planted(mode: str):
    """The port with ``mode``'s fault inside the block."""
    import torch

    import dpcx_torch.models.losses as losses

    saved = []

    def patch(name, value):
        saved.append((name, getattr(losses, name)))
        setattr(losses, name, value)

    scores = losses.candidate_scores
    if mode == "argmax":
        patch("candidate_scores", lambda *a, **k: -scores(*a, **k))
    elif mode == "view0":
        def first_view(*a, **k):
            out = scores(*a, **k)  # [B, K, V] from the views
            return out[..., :1].expand_as(out) if out.dim() == 3 else out

        patch("candidate_scores", first_view)
    elif mode == "live_teacher":
        pose_loss = losses._predicted_pose_loss

        def live(cfg, preds, *a, **k):
            seen, inner = [], losses.candidate_scores

            def seeing(*sa, **sk):
                seen.append(inner(*sa, **sk))
                return seen[-1]

            losses.candidate_scores = seeing
            try:
                total = pose_loss(cfg, preds, *a, **k)
            finally:
                losses.candidate_scores = inner
            # the same student loss with the teacher live and the student
            # held: its value cancels, its gradient reaches the candidates
            k_star = torch.argmin(seen[-1].detach(), dim=1)
            if "student_quat_views" in preds:
                student = preds["student_quat_views"]
                teacher = torch.take_along_dim(
                    preds["quats_views"], k_star[:, :, None, None],
                    2).squeeze(2)
            else:
                student = preds["student_quat"]
                teacher = torch.take_along_dim(
                    preds["quats"], k_star[:, None, None], 1).squeeze(1)
            dot = (student.detach() * teacher).sum(-1)
            lt = torch.mean(1.0 - dot**2)
            return total + cfg.pose_student_weight * (lt - lt.detach())

        patch("_predicted_pose_loss", live)
    try:
        yield
    finally:
        for name, value in reversed(saved):
            setattr(losses, name, value)
