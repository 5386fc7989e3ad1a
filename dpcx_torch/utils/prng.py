"""``jax.random``'s threefry2x32 stream, as dpcx draws it.

dpcx draws each step's batch and point-dropout mask with ``jax.random``
(``dpcx/train.py:153-197``, ``dpcx/render/voxelize.py:54``), its synthetic
models (``dpcx/data/synthetic.py``) and, through flax, its parameter init.
This module is the port's copy of the few functions those draws use,
written to give the same bits:

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
- ``uniform(minval, maxval)`` is ``max(minval, u (maxval - minval) +
  minval)``, the multiply-add one FMA, as XLA:CPU contracts it;
- ``truncated_normal``, ``normal`` and flax's ``lecun_normal`` kernel init
  go through ``erf_inv``, XLA:CPU's float32 program in torch ops (Giles'
  polynomials over XLA's log1p and Eigen's log, each multiply-add a
  float64 product and sum rounded once): it differs from jax's on about 2
  in 100,000 inputs, by at most 2 ulp; everything else here is bitwise.
  These ops round the same on the card and the CPU, so a draw is the same
  bits on both;
- ``fold_in_static`` and ``param_key`` are flax's parameter keys
  (``flax/core/scope.py``): a SHA-1 of the module path and the scope's
  counter, folded into ``PRNGKey(seed)``;
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
the plain versions. The float draws run ``DRAW_CHUNK`` counters at a time
on the card, ``CPU_DRAW_CHUNK`` on the CPU (the partitionable layout makes
a chunk the draw of its counters alone, so the bits do not depend on it),
so a 400M-element kernel init needs about 0.5 GB of temporaries. On the
card the two draws of a training step are hand-written kernels
(``csrc/prng.cu``): ``dropout_weights`` (the mask of
``render/voxelize.py::pc_point_dropout_weights``) and ``batch_draws`` (the
gather rows of dpcx's scan). Each dispatcher (``batch_draws`` here,
``pc_point_dropout_weights`` there) launches its kernel for a CUDA device,
runs the plain version for the CPU, and raises for anything else.
"""

from __future__ import annotations

import ctypes
import hashlib
import math

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


def random_bits_range(key, start: int, stop: int,
                      device="cpu") -> torch.Tensor:
    """The words of flat counters ``[start, stop)`` of ``random_bits``: the
    draw's partitionable layout, so a draw may be made in chunks."""
    if stop > 1 << 32:
        raise ValueError(f"counter {stop}: a draw needs under 2^32 elements")
    x0, x1 = threefry2x32(
        key, torch.zeros(stop - start, dtype=torch.int64, device=device),
        torch.arange(start, stop, dtype=torch.int64, device=device))
    return x0 ^ x1


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """The 32-bit words of ``jax.random.bits(key, shape)``, as int64."""
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 1 << 32:
        raise ValueError(f"{shape}: a draw needs under 2^32 elements")
    return random_bits_range(key, 0, size, device).reshape(shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA:CPU contracts it (the
    product of two float32 is exact in float64)."""
    return (a.double() * b + c).float()


def _scale_uniform(floats, minval, maxval) -> torch.Tensor:
    """jax's ``max(minval, floats * (maxval - minval) + minval)`` in
    float32 (``random.py::_uniform``)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    if (lo, hi) == (0.0, 1.0):
        return floats
    out = _fma(floats, float(np.float32(hi - lo)), float(lo))
    return torch.clamp(out, min=float(lo))


def uniform(key, shape, device="cpu", minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` (float32)."""
    floats = _unit_floats(random_bits(key, shape, device))
    return _scale_uniform(floats, minval, maxval)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """XLA's ``EvaluatePolynomial``: ``p = p x + c`` from the highest
    coefficient, each step one FMA."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, float(np.float32(c)))
    return p


# XLA's float32 log1p (``elemental_ir_emitter.cc::EmitLog1p``): Cephes'
# rational form where |x| < sqrt(2) - 1, else log(1 + x)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA:CPU's float32 log (Eigen's Cephes ``plog``)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _log_f32(v: torch.Tensor) -> torch.Tensor:
    """log of positive normal float32 ``v`` in XLA:CPU's steps: the
    mantissa in [sqrt(1/2), sqrt(2)), a degree-9 polynomial in FMAs."""
    bits = v.view(torch.int32).to(torch.int64)
    e = ((bits >> 23) - 126).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).to(torch.int32).view(
        torch.float32)
    small = m < np.float32(0.707106781186547524)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    m2 = m * m
    m3 = m2 * m
    p = [float(np.float32(c)) for c in _LOG_P]
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = y * m3 + y1
    y = _fma(y, m3, y2) * m3
    y = y + e * np.float32(_LOG_Q1)
    m = m - m2 * np.float32(0.5)
    return _fma(e, float(np.float32(_LOG_Q2)), m + y)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p`` of ``x`` in (-1, 1) (the argument range
    of ``erf_inv``)."""
    x2 = x * x
    small = (x2 * x) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    large = _log_f32(torch.clamp(x + 1.0, min=np.finfo(np.float32).tiny))
    return torch.where(x.abs() < np.float32(0.41421356237309504880), small,
                       large)


# XLA's float32 erf_inv (Giles' single-precision polynomials)
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of float32 ``x`` in (-1, 1), as XLA:CPU computes
    it: ``w = -log1p(-x x)``; below 5 the central polynomial in ``w -
    2.5``, else the tail's in ``sqrt(w) - 3``; ``p = c + p w`` one FMA a
    step; the result ``p x``."""
    w = -log1p_f32(-(x * x))
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, float(np.float32(_ERFINV_CENTRAL[0])),
                    float(np.float32(_ERFINV_TAIL[0])))
    for c, t in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = _fma(p, w, torch.where(central, float(np.float32(c)),
                                   float(np.float32(t))))
    return p * x


_SQRT2 = float(np.float32(np.sqrt(2)))
# counters a chunk: on the card ~0.5 GB of int64 temporaries and few
# launches; on the CPU a chunk whose temporaries stay in cache (2^18 drew
# 8M values 6.5x faster than 2^22 on an 8-core host)
DRAW_CHUNK, CPU_DRAW_CHUNK = 1 << 22, 1 << 18


def _flat_draw(fn, key, shape, device, chunk: int | None) -> torch.Tensor:
    """``fn(bits)`` over the flat counters of ``shape``, ``chunk`` of them
    at a time (by default the device's), into one float32 tensor."""
    if chunk is None:
        chunk = (CPU_DRAW_CHUNK if torch.device(device).type == "cpu"
                 else DRAW_CHUNK)
    size = int(np.prod(shape, dtype=np.int64))
    out = torch.empty(size, dtype=torch.float32, device=device)
    for start in range(0, size, chunk):
        stop = min(start + chunk, size)
        out[start:stop] = fn(random_bits_range(key, start, stop, device))
    return out.reshape(shape)


def _erf_f32(x: float) -> float:
    return float(np.float32(math.erf(float(np.float32(x)))))


def truncated_normal_bits(bits: torch.Tensor, lower: float,
                          upper: float) -> torch.Tensor:
    """``truncated_normal``'s values from its words ``bits``."""
    lo, hi = np.float32(lower), np.float32(upper)
    a = _erf_f32(lo / np.float32(_SQRT2))
    b = _erf_f32(hi / np.float32(_SQRT2))
    u = _scale_uniform(_unit_floats(bits), a, b)
    out = _SQRT2 * erf_inv(u)
    return torch.clamp(out, float(np.nextafter(lo, np.float32(np.inf))),
                       float(np.nextafter(hi, np.float32(-np.inf))))


def truncated_normal(key, lower: float, upper: float, shape,
                     device="cpu") -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` (float32;
    ``random.py::_truncated_normal``): a uniform between ``erf(lower /
    sqrt 2)`` and ``erf(upper / sqrt 2)``, ``sqrt 2 erf_inv`` of it,
    clipped inside the bounds. Drawn ``chunk`` counters at a time."""
    return _flat_draw(lambda bits: truncated_normal_bits(bits, lower, upper),
                      key, shape, device, None)


_NORMAL_LO = float(np.nextafter(np.float32(-1), np.float32(0)))


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32; ``random.py::
    _normal_real``): ``sqrt 2 erf_inv`` of a uniform on
    ``[nextafter(-1, 0), 1)``."""
    return _flat_draw(
        lambda bits: _SQRT2 * erf_inv(
            _scale_uniform(_unit_floats(bits), _NORMAL_LO, 1.0)),
        key, shape, device, None)


def fold_in_static(key, data) -> tuple[int, int]:
    """flax's ``_fold_in_static`` (``flax/core/scope.py``, flax 0.12 with
    ``flax_fix_rng_separator`` False): a SHA-1 of the names (utf-8) and
    ints (big-endian, fewest bytes) with no separator; its first 4 bytes,
    big-endian, go through ``fold_in``."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def param_key(seed: int, path, counter: int) -> tuple[int, int]:
    """The key flax's ``model.init(PRNGKey(seed), ...)`` hands the
    ``counter``-th parameter of the module at ``path`` (``Scope.make_rng``:
    the module names, then the scope's counter; 1 for a kernel, 2 for its
    bias)."""
    return fold_in_static(prng_key(seed), (*path, counter))


# stddev of a standard normal truncated to [-2, 2]
TRUNC_STD = np.float32(0.87962566103423978)


def lecun_std(fan_in: int) -> float:
    """flax's ``sqrt(variance) / 0.8796...`` in float32, variance
    ``1 / fan_in``."""
    return float(np.sqrt(np.float32(1.0 / fan_in)) / TRUNC_STD)


def lecun_normal(key, shape, fan_in: int, device="cpu",
                 chunk: int | None = None) -> torch.Tensor:
    """flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``, in flax's layout: ``truncated_normal(key, -2,
    2, shape) * lecun_std(fan_in)`` in float32, ``chunk`` counters at a
    time (by default the device's)."""
    std = lecun_std(fan_in)
    return _flat_draw(lambda bits: truncated_normal_bits(bits, -2.0, 2.0)
                      * std, key, shape, device, chunk)


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
