"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use they are
compiled by ``nvcc`` for ``sm_90a`` into one shared library under
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
    """Compile the kernels unless this exact build exists; -> its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    build_log().write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C symbols."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dpcx_fused_render.argtypes = [
        ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, ptr,
    ]
    lib.dpcx_fused_render.restype = i32
    # the saved-grid and the recompute backward take the same arguments
    for fn in (lib.dpcx_fused_render_bwd, lib.dpcx_fused_render_bwd_recompute):
        fn.argtypes = [
            ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            i32, ptr,
        ]
        fn.restype = i32
    return lib
