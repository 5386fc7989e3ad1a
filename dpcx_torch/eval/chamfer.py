"""Chamfer distance between point clouds (port of ``dpcx/eval/chamfer.py``).

The pairwise squared distances |a|^2 + |b|^2 - 2 a.b are formed one chunk
of ``b`` at a time, with a running minimum, so the [N, M] matrix never
exists whole for a large M.
"""

from __future__ import annotations

import torch


def directed_distance(
    a: torch.Tensor, b: torch.Tensor, chunk: int = 2048
) -> torch.Tensor:
    """Mean over the points of ``a`` of the squared distance to the
    nearest point of ``b``: a [..., N, 3], b [..., M, 3] -> [...]."""
    a_sq = (a * a).sum(-1)  # [..., N]
    min_d = torch.full(a.shape[:-1], float("inf"), dtype=a.dtype,
                       device=a.device)
    for s in range(0, b.shape[-2], chunk):
        bc = b[..., s:s + chunk, :]
        cross = torch.einsum("...nd,...md->...nm", a, bc)
        d = a_sq[..., None] + (bc * bc).sum(-1)[..., None, :] - 2.0 * cross
        min_d = torch.minimum(min_d, d.amin(-1))
    return min_d.clamp_min(0.0).mean(-1)


def chamfer_distance(
    pred: torch.Tensor, gt: torch.Tensor, chunk: int = 2048
) -> dict[str, torch.Tensor]:
    """Symmetric Chamfer: pred->gt ("accuracy") + gt->pred ("coverage"),
    reported apart and summed."""
    acc = directed_distance(pred, gt, chunk)
    cov = directed_distance(gt, pred, chunk)
    return {"pred_to_gt": acc, "gt_to_pred": cov, "chamfer": acc + cov}
