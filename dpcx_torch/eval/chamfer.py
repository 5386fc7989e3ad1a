"""Chamfer distance between point clouds (port of ``dpcx/eval/chamfer.py``).

The pairwise squared distances |a|^2 + |b|^2 - 2 a.b are formed one chunk
of ``b`` at a time, with a running minimum, so the [N, M] matrix never
exists whole for a large M; and a bounded group of rows at a time, so a
pooled eval of many clouds (160 x 16000 points) fits on one card.
"""

from __future__ import annotations

import torch


# the bytes of one [rows, N, chunk] tensor of a pass; rows are taken as
# many at a time as fit (at least one)
ROW_BUDGET = 1 << 30


def _directed_rows(a: torch.Tensor, b: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """directed_distance over rows a [R, N, 3], b [R, M, 3] -> [R]."""
    a_sq = (a * a).sum(-1)  # [R, N]
    min_d = torch.full(a.shape[:-1], float("inf"), dtype=a.dtype,
                       device=a.device)
    for s in range(0, b.shape[-2], chunk):
        bc = b[..., s:s + chunk, :]
        cross = torch.einsum("...nd,...md->...nm", a, bc)
        d = a_sq[..., None] + (bc * bc).sum(-1)[..., None, :] - 2.0 * cross
        min_d = torch.minimum(min_d, d.amin(-1))
    return min_d.clamp_min(0.0).mean(-1)


def directed_distance(
    a: torch.Tensor, b: torch.Tensor, chunk: int = 2048
) -> torch.Tensor:
    """Mean over the points of ``a`` of the squared distance to the
    nearest point of ``b``: a [..., N, 3], b [..., M, 3] -> [...]. The
    rows of the leading axes go through in groups, so no pass holds more
    than ``ROW_BUDGET`` bytes in one tensor whatever their number."""
    lead = a.shape[:-2]
    a = a.reshape(-1, *a.shape[-2:])
    b = b.reshape(-1, *b.shape[-2:])
    per_row = a.shape[1] * min(chunk, b.shape[1]) * a.element_size()
    rows = max(1, ROW_BUDGET // max(per_row, 1))
    out = [_directed_rows(a[r:r + rows], b[r:r + rows], chunk)
           for r in range(0, a.shape[0], rows)]
    return torch.cat(out).reshape(lead)


def chamfer_distance(
    pred: torch.Tensor, gt: torch.Tensor, chunk: int = 2048
) -> dict[str, torch.Tensor]:
    """Symmetric Chamfer: pred->gt ("accuracy") + gt->pred ("coverage"),
    reported apart and summed."""
    acc = directed_distance(pred, gt, chunk)
    cov = directed_distance(gt, pred, chunk)
    return {"pred_to_gt": acc, "gt_to_pred": cov, "chamfer": acc + cov}
