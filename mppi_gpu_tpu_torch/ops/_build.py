"""Build the port's CUDA sources and bind them with ctypes.

``load_library()`` compiles ``mppi_gpu_tpu_torch/csrc/*.cu`` with ``nvcc``
into one shared library with a plain C interface and loads it: the solve's
kernels (``mppi_solve.cu``, K1-K5), the world step (``world_step.cu``, K6),
the solve's tail (``solve_tail.cu``, K7), K2 with the tail and the world
step as its epilogue (``combine_tail.cu``, K2') and the sharded controller's
combine and tail (``sharded_combine.cu``, K8 and K9) and its two-kernel
softmin (K10 and K11, same file), each file its own translation unit. It
runs at the first kernel launch on a CUDA device; importing the package, or
running on the CPU, never builds.

``load_family_library(source, struct, A)`` does the same for a fused family
registered from user code (``ops/families.register_family``): one generated
translation unit (:func:`family_source`) that includes ``csrc/mppi_solve.cuh``
(K1's and K4's bodies and their launch), holds the user's struct, and exports
``mppi_family_solve_partials``, K1 (partials given) or K4 (partials null) on
that struct, with ``mppi_solve_partials``'s arguments less the family id.

* Output: ``build/mppi_gpu_tpu_torch/libmppi_<hash>.so`` under the checkout,
  named by a hash of the sources (``*.cu`` and ``*.cuh``) and the flags, so an
  edited source, header or flag builds anew and an unchanged one is reused;
  a family's ``libfamily_<hash>.so``, the hash over the headers, the user's
  source, the struct's name, A and the flags.
* Each source compiles in its own ``nvcc`` process, all started together,
  into an object in a temporary directory beside the library; the objects
  are linked there and the library renamed into place (atomic on POSIX), so
  concurrent processes never load a half-written library.
* ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
  ``/usr/local/cuda/bin``; without it, or when it fails, the build raises
  with the compiler's output. Nothing falls back to the plain versions.
* Traced (``utils/timing``): a load is the span ``setup.library``, a build
  within it the child ``setup.library.build``; the registry counts
  ``library.load`` (libraries loaded) and ``library.build`` (of them, those
  built first).
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

from mppi_gpu_tpu_torch.utils import timing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mppi_gpu_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _u, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_pp, _ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# (argtypes, restype) of every C entry; pointers and the stream as c_void_p
_SIGNATURES = {
    "mppi_solve_partials": (
        [_i] + [_p] * 9 + [_i, _i, _i, _i, _f, _f, _f, _u, _u, _u, _u, _u, _i, _f, _f, _i, _p], _i,
    ),
    "mppi_solve_residency": ([_i, _p, _p, _i, _i, _i, _i, _p, _p], _i),
    "mppi_softmin_combine": ([_p, _i, _i, _i, _f, _i, _p, _p, _p], _i),
    "mppi_noise_dump": ([_p, _p, _p, _i, _i, _i, _u, _u, _u, _u, _u, _i, _f, _f, _p], _i),
    "mppi_weighted_update": ([_p] * 4 + [_i, _i, _i, _u, _u, _u, _u, _u, _i, _f, _f, _p]
                             + [_p, _p, _p, _f, _p], _i),
    # csrc/world_step.cu (K6)
    "mppi_world_layout": ([_i, _ip, _ip, _ip], _i),
    "mppi_world_advance": ([_i, _pp, _pp, _i, _p, _p, _i, _p, _i, _i, _p, _i, _i, _i, _p, _p, _p,
                            _i, _p, _p, _i, _p], _i),
    "mppi_world_identities": ([_p, _p, _p], _i),
    # csrc/solve_tail.cu (K7)
    "mppi_solve_tail": ([_p, _p, _p, _i, _p, _p, _p, _p, _p, _i, _p, _i, _f, _p, _i, _i, _i, _i, _p],
                        _i),
    # csrc/combine_tail.cu (K2')
    "mppi_combine_tail": ([_p, _i, _i, _i, _i, _f] + [_p] * 4 + [_i] + [_p] * 4
                          + [_i, _pp, _pp, _i, _p, _p, _i, _p, _i, _i, _p, _p, _p, _i, _p, _p, _i,
                             _p], _i),
    # csrc/sharded_combine.cu (K8, K9, K10, K11)
    "mppi_sharded_scale": ([_p, _i, _i, _p, _f, _p, _p], _i),
    "mppi_softmin_min": ([_p, _i, _i, _p, _p, _p, _p], _i),
    "mppi_softmin_eta": ([_p, _i, _i, _p, _f, _p, _p, _p, _p], _i),
    "mppi_sharded_tail": ([_p, _p, _i, _p, _i] + [_p] * 7 + [_f, _p, _i, _i, _i, _p]
                          + [_i, _pp, _pp, _i, _p, _p, _i, _p, _i, _i, _p, _p, _p, _i, _p, _p, _p],
                          _i),
}


def set_build_dir(path: str | os.PathLike) -> None:
    """Build into `path` from now on, in place of ``build/mppi_gpu_tpu_torch/``
    (the CLI's ``--compile-cache DIR``): the built-in library, the libraries
    of user families and the native world library (``envs/native.py``)."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()


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
    """nvcc each of `sources` into an object, one process per source, all
    started together, then link the objects into `lib` through a temporary
    directory beside it, renamed into place; the compiler's messages
    (``-Xptxas -v``: registers, shared memory, spills per kernel) are kept
    beside it as ``<lib>.log``, in the order of `sources`. Raises with the
    compiler's output if a step fails."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    timing.count("library.build")

    def check(cmd, proc, log) -> str:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        return log

    with timing.span("setup.library.build"), tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(sources))]
        cmds = [[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, src] for obj, src in zip(objs, sources)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]  # every process ends before a raise
        logs = [check(cmd, proc, out) for cmd, proc, out in zip(cmds, procs, outs)]
        out, log = os.path.join(tmp, "lib.so"), os.path.join(tmp, "lib.log")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        Path(log).write_text("".join(logs) + check(cmd, proc, proc.stdout))
        os.replace(log, lib.with_suffix(".log"))
        os.replace(out, lib)


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
    with timing.span("setup.library"):
        lib = ctypes.CDLL(str(build()))
        timing.count("library.load")
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


# --------------------------------------------------------------------------
# a fused family registered from user code

FAMILY_ENTRY = "mppi_family_solve_partials"
FAMILY_RESIDENCY = "mppi_family_solve_residency"
# mppi_solve_partials's and mppi_solve_residency's arguments without the
# leading family id
_FAMILY_SIGNATURE = (_SIGNATURES["mppi_solve_partials"][0][1:], _i)
_FAMILY_RESIDENCY_SIGNATURE = (_SIGNATURES["mppi_solve_residency"][0][1:], _i)


def family_source(source: str, struct: str, A: int) -> str:
    """The translation unit of a user family's library: the header, the
    user's `source` (which defines `struct`, a family struct as the header
    describes it), and the C entries: ``mppi_family_solve_partials`` (K1 on
    `struct` at A actions when `partials` is given, else K4; a robot count
    outside 1..65535, another A, or a goal pointer given exactly when the
    struct reads none is refused with cudaErrorInvalidValue),
    ``mppi_family_solve_residency`` (``mppi_solve_residency`` less the
    family id: the residency of the instance it would launch), and
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
                    lam_cost, lam_softmin, width, nullptr}};
  cudaStream_t s = (cudaStream_t)stream;
  return partials != nullptr ? (int)launch_mode<{struct}, {A}, true>(a, np, s)
                             : (int)launch_mode<{struct}, {A}, false>(a, np, s);
}}

int {FAMILY_RESIDENCY}(const float* goal, const float* eps_in, int T, int A, int pass2,
                       int width, int* out, void* stream) {{
  (void)stream;
  if (A != {A} || (goal != nullptr) != {struct}::kGoal) return (int)cudaErrorInvalidValue;
  const NoiseParams np = make_noise(0, 0, 0, 0, 0, 1, 0, 0.0f, 0.0f);
  const SolveArgs a{{nullptr, nullptr, nullptr, goal, nullptr, nullptr, eps_in, nullptr, nullptr,
                    1, T, A, 0.0f, 0.0f, 0.0f, width, out}};
  return pass2 ? (int)launch_mode<{struct}, {A}, true>(a, np, nullptr)
               : (int)launch_mode<{struct}, {A}, false>(a, np, nullptr);
}}

}}  // extern "C"
"""


def family_library_path(source: str, struct: str, A: int) -> Path:
    """Where the library of a user family lives: named by a hash of the
    headers, the generated unit (the user's source, the struct's name, A)
    and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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
        with timing.span("setup.library"):
            lib = ctypes.CDLL(str(build_family(source, struct, A)))
            timing.count("library.load")
            for name, signature in ((FAMILY_ENTRY, _FAMILY_SIGNATURE),
                                    (FAMILY_RESIDENCY, _FAMILY_RESIDENCY_SIGNATURE)):
                entry = getattr(lib, name)
                entry.argtypes, entry.restype = signature
            for name in ("mppi_family_state_dim", "mppi_family_has_goal"):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = [], _i
            lib.family_struct = (lib.mppi_family_state_dim(), bool(lib.mppi_family_has_goal()))
        _FAMILY_LIBRARIES[path] = lib
    return lib
