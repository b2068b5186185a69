"""Build the port's CUDA sources and bind them with ctypes.

``load_library()`` compiles ``mppi_gpu_tpu_torch/csrc/*.cu`` with ``nvcc``
into one shared library with a plain C interface and loads it. It runs at the
first kernel launch on a CUDA device; importing the package, or running on
the CPU, never builds.

``load_family_library(source, struct, A)`` does the same for a fused family
registered from user code (``ops/families.register_family``): one generated
translation unit (:func:`family_source`) that includes ``csrc/mppi_solve.cuh``
(K1's and K4's bodies and their launch), holds the user's struct, and exports
``mppi_family_solve_partials``, K1 (partials given) or K4 (partials null) on
that struct, with ``mppi_solve_partials``'s arguments less the family id.

* Output: ``build/mppi_gpu_tpu_torch/libmppi_<hash>.so`` under the checkout,
  named by a hash of the sources (``*.cu`` and ``*.cuh``) and the flags, so an
  edited source, header or flag builds anew and an unchanged one is reused;
  a family's ``libfamily_<hash>.so``, the hash over the header, the user's
  source, the struct's name, A and the flags.
* The compiler writes to a temporary file in the same directory that is then
  renamed into place (atomic on POSIX), so concurrent processes never load a
  half-written library.
* ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
  ``/usr/local/cuda/bin``; without it, or when it fails, the build raises
  with the compiler's output. Nothing falls back to the plain versions.
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
        [_i] + [_p] * 9 + [_i, _i, _i, _i, _f, _f, _f, _u, _u, _u, _u, _u, _i, _f, _f, _i, _p], _i,
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


def _sources() -> list[Path]:
    """Every source the built-in library depends on: the ``.cu`` files it
    compiles and the headers they include."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmppi_{h.hexdigest()[:16]}.so"


def _compile(lib: Path, sources: list[str], extra: tuple[str, ...] = ()) -> None:
    """nvcc `sources` into `lib` through a temporary file renamed into place;
    the compiler's messages (``-Xptxas -v``: registers, shared memory, spills
    per kernel) are kept beside it as ``<lib>.log``. Raises with the
    compiler's output if it fails."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, *sources]
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


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path (the compiler's messages beside it, ``<lib>.log``)."""
    lib = library_path()
    if not lib.exists():
        _compile(lib, [str(p) for p in sorted(CSRC.glob("*.cu"))])
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


# --------------------------------------------------------------------------
# a fused family registered from user code

FAMILY_ENTRY = "mppi_family_solve_partials"
# mppi_solve_partials's arguments without the leading family id
_FAMILY_SIGNATURE = (_SIGNATURES["mppi_solve_partials"][0][1:], _i)


def family_source(source: str, struct: str, A: int) -> str:
    """The translation unit of a user family's library: the header, the
    user's `source` (which defines `struct`, a family struct as the header
    describes it), and the C entries: ``mppi_family_solve_partials`` (K1 on
    `struct` at A actions when `partials` is given, else K4; a robot count
    outside 1..65535, another A, or a goal pointer given exactly when the
    struct reads none is refused with cudaErrorInvalidValue), and
    ``mppi_family_state_dim`` / ``mppi_family_has_goal`` (its kS and kGoal,
    which the wrapper holds against the Python side's)."""
    if not struct.isidentifier():
        raise ValueError(f"the family's struct must be a C++ identifier, got {struct!r}")
    if not 1 <= A <= 4:
        raise ValueError(f"a family struct runs at 1 <= A <= 4, got A={A}")
    return f"""// Generated by mppi_gpu_tpu_torch/ops/_build.py: K1 and K4 on the fused
// family {struct}, A = {A}, registered from user code.
#include "mppi_solve.cuh"

{source}

extern "C" {{

int mppi_family_state_dim() {{ return {struct}::kS; }}

int mppi_family_has_goal() {{ return {struct}::kGoal ? 1 : 0; }}

int {FAMILY_ENTRY}(const float* x0, const float* U, const float* params, const float* goal,
                   const long long* keys, const long long* step_ptr, const float* eps_in,
                   float* S, float* partials, int R, int K, int T, int A, float dt,
                   float lam_cost, float lam_softmin, unsigned key0, unsigned key1,
                   unsigned step, unsigned it, unsigned k0, int antithetic, float ou_beta,
                   float ou_c, int width, void* stream) {{
  if (R < 1 || R > kMaxRobots || A != {A} || (goal != nullptr) != {struct}::kGoal)
    return (int)cudaErrorInvalidValue;
  const NoiseParams np = make_noise(key0, key1, step, it, k0, K, antithetic, ou_beta, ou_c);
  const SolveArgs a{{x0, U, params, goal, keys, step_ptr, eps_in, S, partials, R, T, A, dt,
                    lam_cost, lam_softmin, width}};
  cudaStream_t s = (cudaStream_t)stream;
  return partials != nullptr ? (int)launch_mode<{struct}, {A}, true>(a, np, s)
                             : (int)launch_mode<{struct}, {A}, false>(a, np, s);
}}

}}  // extern "C"
"""


def family_library_path(source: str, struct: str, A: int) -> Path:
    """Where the library of a user family lives: named by a hash of the
    header, the generated unit (the user's source, the struct's name, A) and
    the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / "mppi_solve.cuh").read_bytes())
    h.update(family_source(source, struct, A).encode())
    return BUILD_DIR / f"libfamily_{h.hexdigest()[:16]}.so"


def build_family(source: str, struct: str, A: int) -> Path:
    """Compile a user family's library (:func:`family_source`) unless it
    exists; returns its path. The generated unit is kept beside it as
    ``<lib>.cu``, the compiler's messages as ``<lib>.log``."""
    lib = family_library_path(source, struct, A)
    if lib.exists():
        return lib
    find_nvcc()  # before anything is written
    unit = lib.with_suffix(".cu")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".cu.tmp")
    with os.fdopen(fd, "w") as f:
        f.write(family_source(source, struct, A))
    os.replace(tmp, unit)
    _compile(lib, [str(unit)], ("-I", str(CSRC)))
    return lib


_FAMILY_LIBRARIES: dict[Path, ctypes.CDLL] = {}


def load_family_library(source: str, struct: str, A: int) -> ctypes.CDLL:
    """Build a user family's library if needed, load it once per hash and
    declare its entries; ``lib.family_struct`` is its struct's (kS,
    kGoal)."""
    path = family_library_path(source, struct, A)
    lib = _FAMILY_LIBRARIES.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(build_family(source, struct, A)))
        entry = getattr(lib, FAMILY_ENTRY)
        entry.argtypes, entry.restype = _FAMILY_SIGNATURE
        for name in ("mppi_family_state_dim", "mppi_family_has_goal"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [], _i
        lib.family_struct = (lib.mppi_family_state_dim(), bool(lib.mppi_family_has_goal()))
        _FAMILY_LIBRARIES[path] = lib
    return lib
