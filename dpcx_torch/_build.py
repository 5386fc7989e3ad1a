"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use they are
compiled by ``nvcc`` for ``sm_90a`` (one process per source, in parallel)
and linked into one shared library under
``build/`` at the repository root, named by a hash of the sources and the
flags (so an edited source rebuilds and an unchanged one is reused), and
loaded with ``ctypes``. The compiler's output, with ptxas's registers,
stack frame and spills per kernel, is kept beside it (``build_log``).
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda_home / "bin" / "nvcc").is_file():
        return str(cuda_home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdpcx_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> Path:
    """The compiler's output for the library at ``library_path()``."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile the kernels unless this exact build exists; -> its path.
    Each source compiles to an object in its own nvcc process, all started
    together; one more nvcc links them."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{text}")
    tmp = out.with_name(f"{stem}.tmp.so")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    build_log().write_text("".join(log))
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C symbols."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # csrc/fused_render.cu, the renderer from world clouds: points, weights,
    # rot, trans, focal length, camera distance, renders per cloud, taps,
    # radius, then the forward's grid, sil, depth (the backward's grid,
    # recompute, the cotangents, dgrid, dpoints, dweights, drot, dtrans);
    # renders, N, D, with_depth, and the operand mode (1: bfloat16) last
    # before the stream
    f32 = ctypes.c_float
    lib.dpcx_fused_render_world.argtypes = [
        ptr, ptr, ptr, ptr, f32, f32, i32, ptr, i32, ptr, ptr, ptr, i32, i32,
        i32, i32, i32, ptr,
    ]
    lib.dpcx_fused_render_world.restype = i32
    lib.dpcx_fused_render_world_bwd.argtypes = [
        ptr, ptr, ptr, ptr, f32, f32, i32, ptr, i32, ptr, i32, ptr, ptr, ptr,
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
    ]
    lib.dpcx_fused_render_world_bwd.restype = i32
    # csrc/aniso_splat.cu: the anisotropic splat forward (K6) and backward
    # (K7): the packed points, the chunk table (order, band_lo, band_hi),
    # then the grids; renders, N, sorted positions, chunks, D, rgb, and the
    # operand mode last before the stream
    lib.dpcx_aniso_render.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.dpcx_aniso_render.restype = i32
    lib.dpcx_aniso_render_bwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.dpcx_aniso_render_bwd.restype = i32
    # csrc/prng.cu: the draws of a training step (threefry2x32): the
    # dropout weights (out, size, key words, keep-prob) and the batch's
    # gather rows (14 host key words, rows, B, M, V, V_use, with_in2)
    u32 = ctypes.c_uint32
    lib.dpcx_dropout_weights.argtypes = [ptr, i32, u32, u32, ctypes.c_float,
                                         ptr]
    lib.dpcx_dropout_weights.restype = i32
    lib.dpcx_batch_draws.argtypes = [ctypes.POINTER(u32), ptr] + [i32] * 5 \
        + [ptr]
    lib.dpcx_batch_draws.restype = i32
    return lib
