"""``jax.random``'s threefry2x32 stream, as dpcx's training draws it.

dpcx draws each step's batch and point-dropout mask with ``jax.random``
(``dpcx/train.py:153-197``, ``dpcx/render/voxelize.py:54``). This module is
the port's copy of the few functions those draws use, written to give the
same bits:

- ``prng_key(seed)`` is the word pair ``(0, seed)`` (``jax.random.PRNGKey``
  of a 32-bit seed; ``jax/_src/prng.py::_threefry_seed``);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``
  (``prng.py::_threefry_fold_in``);
- ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``
  (``prng.py::_threefry_split_foldlike``, :1156);
- the 32-bit words over a shape are ``x0 ^ x1`` of ``threefry2x32(key,
  (hi, lo))``, ``(hi, lo)`` the element's flat index
  (``prng.py::_threefry_random_bits_partitionable``, :1184);
- ``uniform`` is ``bitcast((bits >> 9) | 0x3F800000) - 1`` in float32
  (``jax/_src/random.py::_uniform``);
- ``randint`` splits its key in two, draws one word from each half and
  combines them modulo the span with the multiplier ``(2^16 mod span)^2
  mod span``, all in uint32 (``random.py::_randint``, :581);
- ``bernoulli`` is ``uniform(key, shape) < p`` (``random.py::_bernoulli``,
  :1075, mode "low");
- threefry2x32 runs 5 groups of 4 rounds with rotations ``[13, 15, 26, 6]``
  and ``[17, 29, 16, 24]``, injecting the key after each group; the third
  key word is ``k0 ^ k1 ^ 0x1BD11BDA`` (``prng.py::_threefry2x32_lowering``,
  :883-930).

It depends on two things: ``jax_threefry_partitionable`` True (jax's
default since 0.5; the other setting splits and draws bits another way),
and 32-bit counters: the high counter word is 0, so a draw's flat size
must stay under 2^32 (the largest at a shipped shape is largecloud's
4 x 131072 dropout mask).

Keys are pairs of Python ints. ``fold_in`` and ``split`` run on the host
(a few evaluations a step: no launch, no sync). The draws over a shape run
in torch ops on int64 tensors masked to 32 bits, on any device; these are
the plain versions. On the card the two draws of a training step are
hand-written kernels (``csrc/prng.cu``): ``dropout_weights`` (the mask of
``render/voxelize.py::pc_point_dropout_weights``) and ``batch_draws`` (the
gather rows of dpcx's scan). Each dispatcher (``batch_draws`` here,
``pc_point_dropout_weights`` there) launches its kernel for a CUDA device,
runs the plain version for the CPU, and raises for anything else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
MAX_VIEWS = 64  # batch_draws_kernel sorts a row's view uniforms in place

# kernel launches by name; counted only where a launch happens
LAUNCHES: dict[str, int] = {"dropout_weights": 0, "batch_draws": 0}


def threefry2x32(key, x0, x1):
    """threefry2x32 of the counter words (x0, x1) under ``key``; the words
    are Python ints or int64 tensors holding 32-bit values."""
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
    """``jax.random.PRNGKey(seed)`` of a 32-bit seed."""
    return 0, seed & MASK


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, data & MASK)


def split(key, n: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, n)``, as a list of keys."""
    return [threefry2x32(key, 0, i) for i in range(n)]


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """The 32-bit words of ``jax.random.bits(key, shape)``, as int64."""
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 1 << 32:
        raise ValueError(f"{shape}: a draw needs under 2^32 elements")
    x0, x1 = threefry2x32(
        key, torch.zeros(size, dtype=torch.int64, device=device),
        torch.arange(size, dtype=torch.int64, device=device))
    return (x0 ^ x1).reshape(shape)


def uniform(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, [0, 1))."""
    bits = random_bits(key, shape, device)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _span_multiplier(lo: int, hi: int) -> tuple[int, int]:
    if not (0 <= lo and hi < 1 << 31):
        raise ValueError(f"randint bounds [{lo}, {hi}) outside [0, 2^31)")
    span = hi - lo if hi > lo else 1  # jax returns lo for an empty range
    mult = (1 << 16) % span
    return span, ((mult * mult) & MASK) % span


def randint(key, shape, lo: int, hi: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` (int32 draws) as int64,
    for ``0 <= lo`` and ``hi < 2^31``."""
    span, mult = _span_multiplier(lo, hi)
    k_hi, k_lo = split(key)
    higher = random_bits(k_hi, shape, device)
    lower = random_bits(k_lo, shape, device)
    offset = ((higher % span) * mult + lower % span) & MASK
    return lo + offset % span


def bernoulli(key, p, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, float32(p), shape)``."""
    return uniform(key, shape, device) < float(np.float32(p))


def device_type(device) -> str:
    """"cpu" (the plain versions) or "cuda" (the kernels); raises for any
    other device."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no draw kernel for device {device}")
    return kind


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def dropout_weights_plain(key, batch: int, num_points: int, keep_prob,
                          device="cpu") -> torch.Tensor:
    """dpcx's ``pc_point_dropout_weights`` in torch ops: ``bernoulli(key,
    keep, (batch, num_points)) / max(keep, 1e-6)`` in float32."""
    keep = np.float32(keep_prob)
    scale = np.float32(1.0) / np.maximum(keep, np.float32(1e-6))
    kept = bernoulli(key, keep, (batch, num_points), device)
    return kept.to(torch.float32) * float(scale)


def launch_dropout_weights(key, batch: int, num_points: int, keep_prob,
                           device="cuda") -> torch.Tensor:
    """``dropout_weights_plain``'s weights [batch, num_points] on a CUDA
    ``device``, one launch of the kernel; bitwise equal."""
    from dpcx_torch import _build

    size = batch * num_points
    if size >= 1 << 31:
        raise ValueError(f"[{batch}, {num_points}]: too many points")
    out = torch.empty((batch, num_points), dtype=torch.float32,
                      device=device)
    lib = _build.load()
    with torch.cuda.device(out.device):
        err = lib.dpcx_dropout_weights(
            out.data_ptr(), size, key[0], key[1],
            float(np.float32(keep_prob)),
            torch.cuda.current_stream(out.device).cuda_stream)
    _check(err, "dropout_weights")
    LAUNCHES["dropout_weights"] += 1
    return out


def batch_draws_plain(k_m, k_vin, k_tgt, k_vin2, batch: int, models: int,
                      views: int, views_use: int,
                      device="cpu") -> torch.Tensor:
    """The gather rows of one step of dpcx's scan (``dpcx/train.py:155-
    190``), in torch ops: [batch, 2 + views_use] int64 holding ``m V +
    v_in``, ``m V + v_in2`` (-1 where ``k_vin2`` is None: the batch draws
    no second view), then ``m V + perm``, perm the first ``views_use`` of a
    stable argsort of ``views`` uniforms."""
    m = randint(k_m, (batch,), 0, models, device)
    v_in = randint(k_vin, (batch,), 0, views, device)
    perm = torch.argsort(uniform(k_tgt, (batch, views), device), dim=1,
                         stable=True)[:, :views_use]
    if k_vin2 is None:
        v_in2 = None
    else:
        v_in2 = (v_in + 1 + randint(k_vin2, (batch,), 0, views - 1,
                                    device)) % views
    base = m * views
    return torch.cat([
        (base + v_in)[:, None],
        torch.full_like(m, -1)[:, None] if v_in2 is None
        else (base + v_in2)[:, None],
        base[:, None] + perm,
    ], dim=1)


def batch_draws(k_m, k_vin, k_tgt, k_vin2, batch: int, models: int,
                views: int, views_use: int, device="cpu") -> torch.Tensor:
    """``batch_draws_plain``'s rows on ``device``: one launch of the kernel
    on a CUDA device (the host derives the randint halves of each key), the
    plain version on the CPU; bitwise equal."""
    if device_type(device) == "cpu":
        return batch_draws_plain(k_m, k_vin, k_tgt, k_vin2, batch, models,
                                 views, views_use, device)
    from dpcx_torch import _build

    if not (0 < views <= MAX_VIEWS and 0 < views_use <= views
            and 0 < models < 1 << 31 and batch * views < 1 << 31):
        raise ValueError(f"batch_draws: batch {batch}, models {models}, "
                         f"views {views} (at most {MAX_VIEWS}), views_use "
                         f"{views_use}")
    in2 = split(k_vin2) if k_vin2 is not None else [(0, 0)] * 2
    words = [w for k in (*split(k_m), *split(k_vin), k_tgt, *in2)
             for w in k]
    rows = torch.empty((batch, 2 + views_use), dtype=torch.int64,
                       device=device)
    lib = _build.load()
    with torch.cuda.device(rows.device):
        err = lib.dpcx_batch_draws(
            (ctypes.c_uint32 * 14)(*words), rows.data_ptr(), batch, models,
            views, views_use, int(k_vin2 is not None),
            torch.cuda.current_stream(rows.device).cuda_stream)
    _check(err, "batch_draws")
    LAUNCHES["batch_draws"] += 1
    return rows
