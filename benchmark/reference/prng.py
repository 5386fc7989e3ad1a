"""jax.random's threefry2x32 stream in plain torch ops: the draws of one
training step (the batch's gather rows and the point-dropout weights).

A frozen copy of the few functions the port's training step draws with, so
that the reference recomputes the step's batch and dropout mask itself:

- a key is a pair of 32-bit words; ``prng_key(seed)`` is ``(0, seed)``;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``, ``split(key, n)[i]``
  is ``threefry2x32(key, (0, i))``;
- the words over a shape are ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``,
  ``i`` the element's flat index;
- ``uniform`` is ``bitcast((bits >> 9) | 0x3F800000) - 1`` in float32;
- ``randint(key, shape, lo, hi)`` draws one word from each half of
  ``split(key)`` and combines them modulo the span with the multiplier
  ``(2^16 mod span)^2 mod span``;
- ``bernoulli`` is ``uniform < p``.

Words are int64 tensors holding 32-bit values, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def threefry2x32(key, x0, x1):
    """threefry2x32 of the counter words (x0, x1) under ``key``: 5 groups
    of 4 rounds, the key injected after each group."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    return 0, seed & MASK


def fold_in(key, data: int) -> tuple[int, int]:
    return threefry2x32(key, 0, data & MASK)


def split(key, n: int = 2) -> list[tuple[int, int]]:
    return [threefry2x32(key, 0, i) for i in range(n)]


def random_bits(key, shape, device) -> torch.Tensor:
    size = int(np.prod(shape, dtype=np.int64))
    x0, x1 = threefry2x32(
        key, torch.zeros(size, dtype=torch.int64, device=device),
        torch.arange(size, dtype=torch.int64, device=device))
    return (x0 ^ x1).reshape(shape)


def uniform(key, shape, device) -> torch.Tensor:
    bits = random_bits(key, shape, device)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def randint(key, shape, lo: int, hi: int, device) -> torch.Tensor:
    span = hi - lo if hi > lo else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    k_hi, k_lo = split(key)
    higher = random_bits(k_hi, shape, device)
    lower = random_bits(k_lo, shape, device)
    offset = ((higher % span) * mult + lower % span) & MASK
    return lo + offset % span


def dropout_weights(key, batch: int, num_points: int, keep_prob,
                    device) -> torch.Tensor:
    """``bernoulli(key, keep, (batch, num_points)) / max(keep, 1e-6)`` in
    float32."""
    keep = np.float32(keep_prob)
    scale = np.float32(1.0) / np.maximum(keep, np.float32(1e-6))
    kept = uniform(key, (batch, num_points), device) < float(keep)
    return kept.to(torch.float32) * float(scale)


def batch_rows(key, step: int, batch: int, models: int, views: int,
               views_use: int, device) -> tuple[torch.Tensor, tuple]:
    """The gather rows of training step ``step`` from the stream's base
    ``key`` -> (rows [batch, 1 + views_use] int64: ``m V + v_in``, then
    ``m V + perm`` for the first ``views_use`` of a stable argsort of
    ``views`` uniforms; the step's dropout key). ``kk = fold_in(key,
    step)`` splits into the keys of the model ids, the input views, the
    target views and the dropout."""
    kk = fold_in(key, step)
    k_m, k_vin, k_tgt, k_drop = split(kk, 4)
    m = randint(k_m, (batch,), 0, models, device)
    v_in = randint(k_vin, (batch,), 0, views, device)
    perm = torch.argsort(uniform(k_tgt, (batch, views), device), dim=1,
                         stable=True)[:, :views_use]
    base = m * views
    rows = torch.cat([(base + v_in)[:, None], base[:, None] + perm], dim=1)
    return rows, k_drop
