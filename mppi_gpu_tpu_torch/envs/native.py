"""ctypes bindings over the native C++ worlds of the root ``csrc/world.cpp``
(the port's counterpart of ``mppi_gpu_tpu.envs.native``): the point mass,
pendulum, cart-pole, planar quadrotor and 3-D quadrotor, host-side like the
reference's MuJoCo env, each with the reference-env API ``reset()``,
``simulate(u) -> done``, ``step(u)``, ``get_x()``, ``time`` and
``set_state(x, time)``, and ``rollout`` on the point mass.

* Build: ``g++`` compiles ``csrc/world.cpp`` into
  ``<build dir>/libmppiworld_<hash>.so``, the build directory of
  ``ops/_build`` (``build/mppi_gpu_tpu_torch/`` under the checkout, or the
  CLI's ``--compile-cache DIR``), named by a hash of the source and the
  flags, through a temporary file renamed into place. Nothing is written
  into ``csrc/``.
* No fallback: when the build or the load fails, constructing a world
  raises with the compiler's output. :func:`native_available` only reports.
* Traced as ``ops/_build``'s libraries are: the spans ``setup.library`` and
  ``setup.library.build``, the counts ``library.load`` and ``library.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from mppi_gpu_tpu_torch.utils import timing

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "world.cpp"
GXX_FLAGS = ("-O2", "-Wall", "-shared", "-fPIC")

_f32p = ctypes.POINTER(ctypes.c_float)
# C prefix of each world → argtypes of its `_create`
_CREATE = {
    "mppi_world": [ctypes.c_int] + [ctypes.c_float] * 9,
    "mppi_pendulum": [ctypes.c_float] * 9,
    "mppi_cartpole": [ctypes.c_float] * 10,
    "mppi_quadrotor": [ctypes.c_float] * 10,
    "mppi_quadrotor3d": [ctypes.c_float] * 14,
}
_lock = threading.Lock()
_LIBRARIES: dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    from mppi_gpu_tpu_torch.ops import _build

    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _build.BUILD_DIR / f"libmppiworld_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/world.cpp`` unless the library for it exists; returns
    its path. Raises with the compiler's output if g++ is missing or
    fails."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native worlds are built from csrc/world.cpp")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
    os.close(fd)
    timing.count("library.build")
    try:
        cmd = [gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)]
        with timing.span("setup.library.build"):
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per library path, and declare every
    entry."""
    path = library_path()
    with _lock:
        lib = _LIBRARIES.get(path)
        if lib is None:
            with timing.span("setup.library"):
                lib = ctypes.CDLL(str(build()))
            timing.count("library.load")
            for prefix, create in _CREATE.items():
                fn = getattr(lib, f"{prefix}_create")
                fn.argtypes, fn.restype = create, ctypes.c_void_p
                for name in ("destroy", "reset"):
                    getattr(lib, f"{prefix}_{name}").argtypes = [ctypes.c_void_p]
                for name in ("step", "get_x"):
                    getattr(lib, f"{prefix}_{name}").argtypes = [ctypes.c_void_p, _f32p]
                fn = getattr(lib, f"{prefix}_simulate")
                fn.argtypes, fn.restype = [ctypes.c_void_p, _f32p], ctypes.c_int
                fn = getattr(lib, f"{prefix}_time")
                fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_float
                getattr(lib, f"{prefix}_set_state").argtypes = [
                    ctypes.c_void_p, _f32p, ctypes.c_float]
            lib.mppi_world_rollout.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_int, _f32p]
            _LIBRARIES[path] = lib
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here (reports only:
    nothing falls back on it)."""
    try:
        load_library()
    except (RuntimeError, OSError, AttributeError, subprocess.TimeoutExpired):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


class _NativeWorld:
    """One world of the native library, behind the C prefix `_prefix`;
    `_fields` names the params its `_create` takes, in order (a tuple field
    gives one argument per element)."""

    _prefix: str
    _fields: tuple[str, ...]
    state_dim: int
    action_dim: int

    def __init__(self, params) -> None:
        lib = load_library()
        self._lib, self.params = lib, params
        args = []
        for name in self._fields:
            v = getattr(params, name)
            args.extend(v if isinstance(v, tuple) else (v,))
        self._handle = getattr(lib, f"{self._prefix}_create")(*args)
        if not self._handle:
            raise RuntimeError(f"{self._prefix}_create failed")

    def _call(self, name: str, *args):
        return getattr(self._lib, f"{self._prefix}_{name}")(self._handle, *args)

    def __del__(self) -> None:  # pragma: no cover
        handle = getattr(self, "_handle", None)
        if handle:
            self._call("destroy")
            self._handle = None

    def _u(self, u) -> np.ndarray:
        u = np.ascontiguousarray(u, dtype=np.float32)
        if u.shape != (self.action_dim,):
            raise ValueError(f"u must have shape ({self.action_dim},), got {u.shape}")
        return u

    def reset(self) -> None:
        self._call("reset")

    def simulate(self, u) -> bool:
        """One control cycle holding `u`; True (the state unchanged) once
        the episode's time has passed, checked before stepping."""
        return bool(self._call("simulate", _ptr(self._u(u))))

    def step(self, u) -> None:
        """One physics step (the mismatch harness)."""
        self._call("step", _ptr(self._u(u)))

    def get_x(self) -> np.ndarray:
        x = np.empty((self.state_dim,), np.float32)
        self._call("get_x", _ptr(x))
        return x

    @property
    def time(self) -> float:
        return float(self._call("time"))

    def set_state(self, x, time: float) -> None:
        """Restore from a checkpoint: the state vector and the sim time."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.shape != (self.state_dim,):
            raise ValueError(f"x must have shape ({self.state_dim},)")
        self._call("set_state", _ptr(x), ctypes.c_float(time))


class NativePointMassWorld(_NativeWorld):
    """The point mass on 1-3 slide joints (``envs.params.WorldParams``)."""

    _prefix = "mppi_world"
    _fields = ("n_axes", "mass", "armature", "damping", "gear", "ctrl_range", "joint_range",
               "timestep", "control_period", "sim_end")

    def __init__(self, params) -> None:
        self.action_dim, self.state_dim = params.n_axes, 2 * params.n_axes
        super().__init__(params)

    def rollout(self, u_seq) -> np.ndarray:
        """Open-loop rollout (the mismatch harness): (n, a) controls →
        (n+1, 2a) trajectory including the initial state."""
        u_seq = np.ascontiguousarray(u_seq, dtype=np.float32)
        n, a = u_seq.shape
        if a != self.action_dim:
            raise ValueError(f"u_seq must be (n, {self.action_dim})")
        traj = np.empty((n + 1, 2 * a), np.float32)
        self._call("rollout", _ptr(u_seq), n, _ptr(traj))
        return traj


class NativePendulumWorld(_NativeWorld):
    """The pendulum (``envs.pendulum_world.PendulumParams``)."""

    _prefix, state_dim, action_dim = "mppi_pendulum", 2, 1
    _fields = ("mass", "length", "gravity", "damping", "max_torque", "timestep",
               "control_period", "sim_end", "init_theta")


class NativeCartPoleWorld(_NativeWorld):
    """The cart-pole (``envs.cartpole_world.CartPoleParams``)."""

    _prefix, state_dim, action_dim = "mppi_cartpole", 4, 1
    _fields = ("cart_mass", "pole_mass", "pole_length", "gravity", "max_force", "track_limit",
               "timestep", "control_period", "sim_end", "init_theta")


class NativeQuadrotorWorld(_NativeWorld):
    """The planar quadrotor (``envs.quadrotor_world.QuadrotorParams``)."""

    _prefix, state_dim, action_dim = "mppi_quadrotor", 6, 2
    _fields = ("mass", "inertia", "arm", "gravity", "max_thrust", "timestep", "control_period",
               "sim_end", "init_x", "init_z")


class NativeQuadrotor3DWorld(_NativeWorld):
    """The 3-D quadrotor (``envs.quadrotor3d_world.Quadrotor3DParams``)."""

    _prefix, state_dim, action_dim = "mppi_quadrotor3d", 13, 4
    _fields = ("mass", "inertia", "arm", "kappa", "gravity", "max_thrust", "timestep",
               "control_period", "sim_end", "init_pos")
