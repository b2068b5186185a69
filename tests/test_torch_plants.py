"""The port's host plants against the JAX package's: the XML world
schema (``envs/xml.py``), the native C++ worlds (``envs/native.py``, the
root csrc/world.cpp built into the port's build directory), the real-MuJoCo
worlds (``envs/mujoco_world.py``), the torch worlds against real MuJoCo,
and the closed loop on each plant (``runner.run_closed_loop(world_backend=,
view=)``, checkpoint/resume, the viewer and the CLI's ``--world``,
``--view`` and ``--compile-cache``)."""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.envs import native as jax_native  # noqa: E402
from mppi_gpu_tpu.envs import params_for_config as jax_params_for_config  # noqa: E402
from mppi_gpu_tpu.envs import xml as jax_xml  # noqa: E402
from mppi_gpu_tpu_torch import cli  # noqa: E402
from mppi_gpu_tpu_torch import runner as runner_mod  # noqa: E402
from mppi_gpu_tpu_torch.config import ConfigError, load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.envs import (  # noqa: E402
    ArmParams,
    CartPoleParams,
    PendulumParams,
    Quadrotor3DParams,
    QuadrotorParams,
    WorldParams,
    make_host_world,
    make_world,
    params_for_config,
    world_params_for_config,
)
from mppi_gpu_tpu_torch.envs import native  # noqa: E402
from mppi_gpu_tpu_torch.envs.xml import XMLWorldError, load_world_xml  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build  # noqa: E402
from mppi_gpu_tpu_torch.runner import run_closed_loop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
PM2 = os.path.join(CONFIGS, "point_mass2d.yaml")
XMLS = [os.path.join(ROOT, "envs_xml", f"point_mass{n}d.xml") for n in (1, 2, 3)]


def _cfg(name: str, **over):
    return load_config(os.path.join(CONFIGS, f"{name}.yaml")).replace(**over)


# ---------------------------------------------------------------------------
# (a) the XML world schema


@pytest.mark.parametrize("path", XMLS, ids=lambda p: os.path.basename(p))
def test_xml_world_equals_the_jax_parse(path):
    """The reference's point-mass XMLs: the same params, target site and
    model name in both packages, and the same params through a config whose
    env names the XML."""
    got, want = load_world_xml(path), jax_xml.load_world_xml(path)
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)
    assert got.target == want.target and got.model_name == want.model_name
    n = got.params.n_axes
    cfg = _cfg(f"point_mass{n}d", env=path)
    jcfg = load_jax_config(os.path.join(CONFIGS, f"point_mass{n}d.yaml")).replace(env=path)
    assert dataclasses.asdict(params_for_config(cfg)) == dataclasses.asdict(
        jax_params_for_config(jcfg))


@pytest.mark.parametrize(
    "mutation,match",
    [('integrator="RK4"', "integrator"), ('type="slide"', "not a slide joint"),
     ('<motor gear="10.0" joint="agent_x"/>', "motors")],
)
def test_bad_xml_gives_the_jax_error(tmp_path, mutation, match):
    """Each mutation of tests/test_xml.py: the same error class and message
    in both packages."""
    src = open(XMLS[0]).read()
    bad = src.replace('type="slide"', 'type="hinge"') if mutation.startswith("type=") else (
        src.replace(mutation, ""))
    path = tmp_path / "bad.xml"
    path.write_text(bad)
    with pytest.raises(XMLWorldError, match=match) as got:
        load_world_xml(path)
    with pytest.raises(jax_xml.XMLWorldError) as want:
        jax_xml.load_world_xml(path)
    assert str(got.value) == str(want.value)


def test_xml_config_refusals():
    """A config's XML env that does not exist, or whose axes do not match
    its action-dim, raises as in the JAX package."""
    with pytest.raises(FileNotFoundError):
        world_params_for_config(_cfg("point_mass2d", env="/nope/missing.xml"))
    with pytest.raises(ValueError, match="3 axes but config action-dim is 2"):
        world_params_for_config(_cfg("point_mass2d", env=XMLS[2]))


# ---------------------------------------------------------------------------
# (b) the native C++ worlds

NATIVE = [
    ("NativePointMassWorld", WorldParams(n_axes=3)),
    ("NativePendulumWorld", PendulumParams()),
    ("NativeCartPoleWorld", CartPoleParams()),
    ("NativeQuadrotorWorld", QuadrotorParams()),
    ("NativeQuadrotor3DWorld", Quadrotor3DParams()),
]


@pytest.mark.parametrize("name,params", NATIVE, ids=[n for n, _ in NATIVE])
def test_native_world_equals_the_jax_twin(name, params):
    """The same seeded u sequence through the port's class and the JAX
    class: a whole episode of ``simulate`` (to the same end), raw ``step``s
    after it, then ``set_state`` and more steps. get_x() and time agree to
    rtol 1e-6. The port's library and the JAX package's csrc/libmppiworld.so
    are built from one source with the same g++ flags; where both were built
    by one compiler they agree bit for bit (so they did when this test was
    written)."""
    mine, ref = getattr(native, name)(params), getattr(jax_native, name)(params)
    rng = np.random.default_rng(0)
    a = mine.action_dim

    def same():
        np.testing.assert_allclose(mine.get_x(), ref.get_x(), rtol=1e-6, atol=1e-7)
        assert mine.time == pytest.approx(ref.time, rel=1e-6)

    same()
    n = 0
    while True:
        u = rng.standard_normal(a).astype(np.float32)
        done = mine.simulate(u)
        assert done == ref.simulate(u)
        same()
        if done:
            break
        n += 1
    assert n == params.num_control_steps()
    for _ in range(10):
        u = rng.standard_normal(a).astype(np.float32)
        mine.step(u)
        ref.step(u)
        same()
    x = rng.standard_normal(mine.state_dim).astype(np.float32)
    mine.set_state(x, 1.25)
    ref.set_state(x, 1.25)
    same()
    for _ in range(5):
        u = rng.standard_normal(a).astype(np.float32)
        assert mine.simulate(u) == ref.simulate(u)
        same()
    mine.reset()
    ref.reset()
    same()
    with pytest.raises(ValueError, match="u must have shape"):
        mine.simulate(np.zeros(a + 1, np.float32))


def test_native_point_mass_rollout_equals_the_jax_twin():
    p = WorldParams(n_axes=2)
    us = np.random.default_rng(1).standard_normal((40, 2)).astype(np.float32)
    got = native.NativePointMassWorld(p).rollout(us)
    assert got.shape == (41, 4)
    np.testing.assert_allclose(got, jax_native.NativePointMassWorld(p).rollout(us), rtol=1e-6,
                               atol=1e-7)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_native_library_builds_into_the_build_dir(tmp_path, monkeypatch):
    """The library is compiled into the port's build directory (named by a
    hash of the source and the flags) and never into csrc/, whose prebuilt
    library keeps its bytes."""
    tracked = os.path.join(ROOT, "csrc", "libmppiworld.so")
    before = _sha(tracked)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path = native.build()
    assert path.parent == tmp_path / "build" and path.name.startswith("libmppiworld_")
    assert path == native.library_path() and path.exists()
    assert native.native_available()
    assert _sha(tracked) == before
    assert not any(p.suffix == ".tmp" for p in path.parent.iterdir())


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses, or no g++ at all, makes
    constructing a world raise, and native_available() reports False."""
    bad = tmp_path / "world.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.NativePendulumWorld(PendulumParams())
    assert "world.cpp" in str(e.value)
    assert not native.native_available()
    bad.write_text("// another source, another library\n")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.NativePointMassWorld(WorldParams(n_axes=2))


@pytest.mark.parametrize("env,match", [("unicycle", "unicycle"), ("arm", "arm")])
def test_host_world_refusals(env, match):
    """The unicycle has no native or MuJoCo plant, the arm no native one,
    as in the JAX runner."""
    cfg = _cfg(env)
    with pytest.raises(ValueError, match=match):
        make_host_world(cfg, backend="native")
    if env == "unicycle":
        with pytest.raises(ValueError, match=match):
            make_host_world(cfg, backend="mujoco")
    with pytest.raises(ValueError, match="unknown world backend"):
        make_host_world(cfg, backend="jax")


# ---------------------------------------------------------------------------
# (c) the real-MuJoCo worlds


def _mujoco_cases():
    from mppi_gpu_tpu_torch.envs import mujoco_world as mw

    return [
        ("PointMass", WorldParams(n_axes=2), mw._point_mass_mjcf, 2),
        ("Pendulum", PendulumParams(), mw._pendulum_mjcf, 1),
        ("CartPole", CartPoleParams(), mw._cartpole_mjcf, 1),
        ("Quadrotor", QuadrotorParams(), mw._quadrotor_mjcf, 2),
        ("Arm", ArmParams(), mw._arm_mjcf, 2),
        ("Quadrotor3D", Quadrotor3DParams(), mw._quadrotor3d_mjcf, 4),
    ]


@pytest.mark.parametrize("i", range(6), ids=["point_mass", "pendulum", "cartpole", "quadrotor",
                                             "arm", "quadrotor3d"])
def test_mujoco_world_equals_the_jax_twin(i):
    """Each MJCF generator's string is the JAX one's, and the same inputs
    (control cycles, raw steps, a restored state) give np.array_equal
    trajectories and clocks."""
    pytest.importorskip("mujoco")
    from mppi_gpu_tpu.envs import mujoco_world as jax_mw
    from mppi_gpu_tpu_torch.envs import mujoco_world as mw

    name, params, gen, a = _mujoco_cases()[i]
    assert gen(params) == getattr(jax_mw, gen.__name__)(params)
    mine = getattr(mw, f"Mujoco{name}World")(params)
    ref = getattr(jax_mw, f"Mujoco{name}World")(params)
    rng = np.random.default_rng(i)
    scale = np.asarray([p / 2 for p in (3.0,) * a], np.float32)
    for t in range(60):
        u = (rng.standard_normal(a) * scale).astype(np.float32)
        if name.startswith("Quadrotor"):
            u[0] += params.mass * params.gravity
        assert mine.simulate(u) == ref.simulate(u)
        if t % 7 == 0:
            mine.step(u)
            ref.step(u)
        assert np.array_equal(mine.get_x(), ref.get_x()), t
        assert mine.time == ref.time
    x, tm = mine.get_x(), mine.time
    mine.reset()
    mine.set_state(x, tm)
    assert np.array_equal(mine.get_x(), ref.get_x()) and mine.time == ref.time


def test_mujoco_point_mass_from_the_reference_xml():
    """A point-mass config whose env is a reference XML loads that XML into
    MuJoCo (make_host_world), and steps as the JAX world built from it."""
    pytest.importorskip("mujoco")
    from mppi_gpu_tpu.envs.mujoco_world import MujocoPointMassWorld as JaxWorld

    cfg = _cfg("point_mass2d", env=XMLS[1])
    mine = make_host_world(cfg, backend="mujoco")
    assert mine._xml_path == XMLS[1]
    ref = JaxWorld(jax_params_for_config(
        load_jax_config(PM2).replace(env=XMLS[1])), xml_path=XMLS[1])
    for u in np.random.default_rng(3).uniform(-1, 1, (30, 2)).astype(np.float32):
        mine.simulate(u)
        ref.simulate(u)
    assert np.array_equal(mine.get_x(), ref.get_x())


# ---------------------------------------------------------------------------
# (d) the torch worlds against real MuJoCo (tests/test_mujoco_xval.py's bars)


def _torch_cycles(world, us: np.ndarray) -> np.ndarray:
    """One control cycle of the torch world per input row; the states after
    each cycle."""
    s, out = world.reset(), []
    for u in us:
        s, _ = world.simulate(s, torch.as_tensor(u, dtype=torch.float32))
        out.append(s.x.numpy())
    return np.asarray(out)


def test_torch_point_mass_tracks_real_mujoco_in_the_interior():
    """An oscillatory drive that keeps the mass inside the ±1.4 joint range:
    the torch world tracks MuJoCo's mj_step on the reference's own XML within
    test_mujoco_xval's 2e-3 in position and 2e-2 in velocity."""
    mujoco = pytest.importorskip("mujoco")
    rng = np.random.default_rng(0)
    t = np.arange(100)[:, None]
    us = 0.5 * np.sin(0.35 * t + np.array([[0.0, 1.3]])) + 0.1 * rng.standard_normal((100, 2))
    m = mujoco.MjModel.from_xml_path(XMLS[1])
    d = mujoco.MjData(m)
    mj = []
    for u in us:
        d.ctrl[:] = u
        start = d.time
        while d.time - start < 1.0 / 60.0:
            mujoco.mj_step(m, d)
        mj.append(np.concatenate([d.qpos, d.qvel]))
    mj = np.asarray(mj)
    tw = _torch_cycles(make_world(_cfg("point_mass2d")), us.astype(np.float32))
    assert np.all(np.abs(mj[:, :2]) < 1.3), "drove into the limit"
    assert np.abs(mj[:, :2] - tw[:, :2]).max() < 2e-3
    assert np.abs(mj[:, 2:] - tw[:, 2:]).max() < 2e-2


def _family_drive(name: str) -> tuple[np.ndarray, np.ndarray]:
    """test_mujoco_xval.py's input for the family and its per-state bound."""
    if name == "pendulum":
        rng = np.random.default_rng(0)
        us = (1.5 * np.sin(0.3 * np.arange(80)) + 0.3 * rng.standard_normal(80))[:, None]
        return us, np.array([1e-4, 1e-3])
    if name == "cartpole":
        rng = np.random.default_rng(1)
        us = (2.0 * np.sin(0.5 * np.arange(60)) + 0.5 * rng.standard_normal(60))[:, None]
        return us, np.array([1e-4, 1e-4, 1e-3, 1e-3])
    if name == "quadrotor":
        p = QuadrotorParams()
        rng = np.random.default_rng(2)
        us = np.stack([p.mass * p.gravity + 1.0 * np.sin(0.4 * np.arange(60))
                       + 0.3 * rng.standard_normal(60),
                       0.25 * np.sin(0.7 * np.arange(60)) + 0.05 * rng.standard_normal(60)], 1)
        return us, np.array([1e-3] * 3 + [1e-2] * 3)
    if name == "quadrotor3d":
        p = Quadrotor3DParams()
        rng = np.random.default_rng(5)
        t = np.arange(60)
        us = np.stack([p.mass * p.gravity + 1.0 * np.sin(0.4 * t) + 0.3 * rng.standard_normal(60),
                       0.03 * np.sin(0.7 * t) + 0.01 * rng.standard_normal(60),
                       0.03 * np.cos(0.6 * t) + 0.01 * rng.standard_normal(60),
                       0.006 * np.sin(0.5 * t)], 1)
        return us, np.array([1e-3] * 7 + [1e-2] * 6)
    rng = np.random.default_rng(7)  # the arm
    return rng.uniform([-6.0, -3.0], [6.0, 3.0], size=(60, 2)), np.array([1e-4] * 2 + [1e-3] * 2)


@pytest.mark.parametrize("name", ["pendulum", "cartpole", "quadrotor", "quadrotor3d", "arm"])
def test_torch_family_world_tracks_real_mujoco(name):
    """Each family's torch world against its MuJoCo plant, cycle by cycle,
    within test_mujoco_xval.py's per-family, per-state bounds."""
    pytest.importorskip("mujoco")
    us, bound = _family_drive(name)
    us = us.astype(np.float32)
    params = params_for_config(_cfg(name)).__class__()
    tw = _torch_cycles(make_world(_cfg(name), params), us)
    mj = make_host_world(_cfg(name), params, "mujoco")
    gaps = []
    for t, u in enumerate(us):
        mj.simulate(u)
        gaps.append(np.abs(tw[t] - mj.get_x()))
    gap = np.asarray(gaps).max(axis=0)
    assert np.all(gap < bound), gap


# ---------------------------------------------------------------------------
# (e) the closed loop on each plant


def test_closed_loop_native_world_matches_torch_world():
    """tests/test_closed_loop.py's case on the port: point_mass1d at K=128,
    T=20, 100 steps, one Philox stream, the native plant against the torch
    world within rtol 5e-3, atol 5e-4 (the gap is ~1e-7 at seeds 0-7 in both
    packages, tests/_plant_gap_probe.py)."""
    cfg = _cfg("point_mass1d", samples=128, horizon=20)
    r_t = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend="torch", max_steps=100)
    r_n = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend="native", max_steps=100)
    assert r_n.xs.shape == r_t.xs.shape == (101, 2)
    np.testing.assert_allclose(r_n.xs, r_t.xs, rtol=5e-3, atol=5e-4)


def test_closed_loop_mujoco_world_matches_torch_world():
    """tests/test_mujoco_xval.py's case on the port: point_mass2d at K=256,
    T=20, 25 steps, within atol 5e-4 of the torch-world loop, and closer to
    the goal at the end than at the start."""
    pytest.importorskip("mujoco")
    cfg = _cfg("point_mass2d", samples=256, horizon=20)
    r_m = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend="mujoco", max_steps=25)
    r_t = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend="torch", max_steps=25)
    np.testing.assert_allclose(r_m.xs, r_t.xs, atol=5e-4)
    goal = np.asarray(cfg.goal[:2])
    assert np.linalg.norm(r_m.xs[-1][:2] - goal) < np.linalg.norm(r_m.xs[0][:2] - goal)


@pytest.mark.parametrize("env", ["pendulum", "cartpole", "quadrotor", "quadrotor3d"])
def test_family_closed_loop_on_mujoco_and_native(env):
    """tests/test_mujoco_xval.py's family loops on the port: K=128, T=15,
    one opt iteration, 20 steps; the MuJoCo and the native plants each
    within atol 3e-2 (quadrotors) or 1e-2 of the torch-world loop."""
    pytest.importorskip("mujoco")
    cfg = _cfg(env, samples=128, horizon=15, opt_iters=1)
    tol = 3e-2 if env.startswith("quadrotor") else 1e-2
    r_t = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend="torch", max_steps=20)
    for plant in ("mujoco", "native"):
        r = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend=plant, max_steps=20)
        np.testing.assert_allclose(r.xs, r_t.xs, atol=tol, err_msg=plant)


@pytest.mark.parametrize("plant", ["native", "torch", "mujoco"])
def test_resume_on_a_host_plant(tmp_path, plant):
    """Checkpoint every 10 steps of a 30-step run, resume from the last one
    (step 20), the plant restored through set_state: on the native and the
    torch plants, whose state is float32, the resumed suffix equals the
    uninterrupted run bit for bit. MuJoCo integrates in float64 and the
    checkpoint holds the float32 state of get_x() (the JAX package's format),
    so its resumed run starts from that rounding: within 1e-5 over 10 steps."""
    if plant == "mujoco":
        pytest.importorskip("mujoco")
    cfg = _cfg("point_mass2d", samples=64, horizon=10)
    ck = tmp_path / "ck.npz"
    full = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend=plant, max_steps=30,
                           checkpoint_path=ck, checkpoint_every=10)
    res = run_closed_loop(MPPIController(cfg, device="cpu"), world_backend=plant, max_steps=30,
                          resume_from=ck)
    assert res.xs.shape == full.xs[20:].shape and len(res.us) == 10
    if plant == "mujoco":
        np.testing.assert_allclose(res.xs, full.xs[20:], rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.times, full.times[20:], rtol=1e-12)
        return
    assert np.array_equal(res.xs, full.xs[20:]) and np.array_equal(res.us, full.us[20:])
    assert np.array_equal(res.times, full.times[20:])


def test_device_episodes_refuse_a_host_plant():
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.runner import run_episode_jit, run_fleet_episode

    cfg = _cfg("point_mass2d", samples=16, horizon=4)
    with pytest.raises(ValueError, match="run_episode_jit.*'native'.*host plant"):
        run_episode_jit(MPPIController(cfg, device="cpu"), num_steps=1, world_backend="native")
    with pytest.raises(ValueError, match="run_fleet_episode.*'mujoco'.*host plant"):
        run_fleet_episode(BatchedMPPIController(cfg, 2, device="cpu"), num_steps=1,
                          world_backend="mujoco")


# ---------------------------------------------------------------------------
# (f) the live viewer (tests/test_viewer.py with a stub handle)


class _StubViewer:
    def __init__(self, run_for: int = 10**9):
        self.syncs, self.closed, self._run_for = 0, False, run_for

    def is_running(self) -> bool:
        return self.syncs < self._run_for

    def sync(self) -> None:
        self.syncs += 1

    def close(self) -> None:
        self.closed = True


def test_view_syncs_every_step_and_closes(monkeypatch):
    pytest.importorskip("mujoco")
    stub = _StubViewer()
    seen = []
    monkeypatch.setattr(runner_mod, "_launch_viewer", lambda world: seen.append(world) or stub)
    ctrl = MPPIController(_cfg("point_mass2d", samples=64, horizon=10), device="cpu")
    res = run_closed_loop(ctrl, world_backend="mujoco", max_steps=5, view=True)
    assert stub.syncs == 5 and stub.closed and res.xs.shape[0] == 6
    assert hasattr(seen[0], "m") and hasattr(seen[0], "d")  # the MuJoCo plant


def test_view_window_close_ends_episode(monkeypatch):
    pytest.importorskip("mujoco")
    stub = _StubViewer(run_for=3)
    monkeypatch.setattr(runner_mod, "_launch_viewer", lambda world: stub)
    ctrl = MPPIController(_cfg("point_mass2d", samples=64, horizon=10), device="cpu")
    res = run_closed_loop(ctrl, world_backend="mujoco", max_steps=50, view=True)
    assert len(res.us) == 3 and stub.closed


@pytest.mark.parametrize("plant", ["torch", "native"])
def test_view_requires_the_mujoco_world(plant):
    ctrl = MPPIController(_cfg("point_mass2d", samples=16, horizon=4), device="cpu")
    with pytest.raises(ConfigError, match="--world mujoco"):
        run_closed_loop(ctrl, world_backend=plant, max_steps=2, view=True)


def test_headless_launch_raises_before_glfw(monkeypatch):
    """Without a display the launch raises ConfigError before GLFW is
    reached (glfwInit aborts the process on a headless host)."""
    pytest.importorskip("mujoco")
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    world = make_host_world(_cfg("point_mass2d"), backend="mujoco")
    with pytest.raises(ConfigError, match="display"):
        runner_mod._launch_viewer(world)


# ---------------------------------------------------------------------------
# (g) the CLI's --world, --view and --compile-cache


def test_cli_world_native_and_compile_cache(capsys, tmp_path, monkeypatch):
    """`--world native --compile-cache DIR` on the CPU: the episode runs on
    the native plant, its library is built into DIR, and its trajectory is
    the run_closed_loop one's."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored afterwards
    cache = tmp_path / "cache"
    traj = tmp_path / "t.csv"
    rc = cli.main(["-c", PM2, "--device", "cpu", "--max-steps", "12", "--world", "native",
                   "--compile-cache", str(cache), "-t", str(traj), "--seed", "2"])
    assert rc == 0 and "episode finished: 12 control steps" in capsys.readouterr().out
    assert _build.BUILD_DIR == cache.resolve()
    assert any(p.name.startswith("libmppiworld_") for p in cache.iterdir())
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns

    want = run_closed_loop(MPPIController(load_config(PM2).replace(seed=2), device="cpu"),
                           world_backend="native", max_steps=12)
    np.testing.assert_allclose(read_csv_columns(str(traj))["x[0]"], want.xs[1:, 0], rtol=1e-6)


def test_cli_view_jit_episode_and_world_refusals(capsys):
    for argv, needle in (
        (["--view", "--world", "mujoco", "--jit-episode"], "--view"),
        (["--world", "mujoco", "--jit-episode"], "--world mujoco"),
        (["--view"], "--world mujoco"),
    ):
        rc = cli.main(["-c", PM2, "--device", "cpu", "--max-steps", "1", *argv])
        err = capsys.readouterr().err
        assert rc == 2 and needle in err, (argv, err)
