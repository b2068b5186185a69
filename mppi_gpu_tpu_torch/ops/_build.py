"""Build the port's CUDA sources and bind them with ctypes.

``load_library()`` compiles ``mppi_gpu_tpu_torch/csrc/*.cu`` with ``nvcc``
into one shared library with a plain C interface and loads it. It runs at the
first kernel launch on a CUDA device; importing the package, or running on
the CPU, never builds.

* Output: ``build/mppi_gpu_tpu_torch/libmppi_<hash>.so`` under the checkout,
  named by a hash of the sources and the flags, so an edited source or flag
  builds anew and an unchanged one is reused.
* The compiler writes to a temporary file in the same directory that is then
  renamed into place (atomic on POSIX), so concurrent processes never load a
  half-written library.
* ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
  ``/usr/local/cuda/bin``; without it the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mppi_gpu_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _u, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# (argtypes, restype) of every C entry; pointers and the stream as c_void_p
_SIGNATURES = {
    "mppi_solve_partials": (
        [_i] + [_p] * 8 + [_i, _i, _i, _i, _f, _f, _f, _u, _u, _u, _u, _u, _i, _f, _f, _i, _p], _i,
    ),
    "mppi_softmin_combine": ([_p, _i, _i, _i, _f, _i, _p, _p, _p], _i),
    "mppi_noise_dump": ([_p, _p, _p, _i, _i, _i, _u, _u, _u, _u, _u, _i, _f, _f, _p], _i),
    "mppi_weighted_update": ([_p] * 4 + [_i, _i, _i, _u, _u, _u, _u, _u, _i, _f, _f, _p], _i),
}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built from mppi_gpu_tpu_torch/csrc at the first launch "
        "on a CUDA device and need the CUDA toolkit"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmppi_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path. The compiler's messages (``-Xptxas -v``: registers, shared memory,
    spills per kernel) are kept beside it as ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log = lib.with_suffix(".log")
        log_tmp = Path(tmp + ".log")
        log_tmp.write_text(proc.stdout + proc.stderr)
        os.replace(log_tmp, log)
        os.replace(tmp, lib)
    finally:
        for leftover in (tmp, tmp + ".log"):
            if os.path.exists(leftover):
                os.unlink(leftover)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
