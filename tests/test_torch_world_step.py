"""K6 ``world_advance`` on the CPU (``ops/world_step.py``, its kernel in
``csrc/world_step.cu``): the plain control cycle of every world against the
JAX world's ``simulate`` under ``jax.jit``, the packed parameters against
each params dataclass and against the field order the CUDA source declares,
the dispatch between the kernel and the plain loop (the C entries stubbed, so
no card is needed), the episode cycle's history writes, and ``utils/timing.py``'s
SolveTimer against the JAX package's.

Inputs come from numpy seeds; sizes are small (R ≤ 8, 2 cycles). The kernel
itself runs only on the card, where ``chip_smoke.py --episode`` holds it
against the plain loop bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.envs import make_jax_world  # noqa: E402
from mppi_gpu_tpu.utils.timing import SolveTimer as JaxSolveTimer  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.envs import make_world, params_for_config  # noqa: E402
from mppi_gpu_tpu_torch.envs.pendulum_world import PendulumState, PendulumWorld  # noqa: E402
from mppi_gpu_tpu_torch.ops import _build, _rounding  # noqa: E402
from mppi_gpu_tpu_torch.ops import fused_solve as fs  # noqa: E402
from mppi_gpu_tpu_torch.ops import solve_tail as st  # noqa: E402
from mppi_gpu_tpu_torch.ops import world_step as ws  # noqa: E402
from mppi_gpu_tpu_torch.utils.timing import SolveTimer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "mppi_gpu_tpu_torch", "csrc", "world_step.cu")
# the world bodies K6 and K2's epilogue share
HEADER = os.path.join(ROOT, "mppi_gpu_tpu_torch", "csrc", "world_step.cuh")
XML = os.path.join(ROOT, "envs_xml", "point_mass2d.xml")
# a config of each world body; point_mass_xml: point_mass2d's config with its
# env the reference XML (envs/xml.py)
CASES = ("point_mass1d", "point_mass2d", "point_mass3d", "point_mass_xml", "pendulum", "cartpole",
         "unicycle", "quadrotor", "arm", "quadrotor3d")
R = 8


def _configs(name: str):
    path = os.path.join(ROOT, "configs",
                        f"{'point_mass2d' if name == 'point_mass_xml' else name}.yaml")
    cfg, jcfg = load_config(path), load_jax_config(path)
    if name == "point_mass_xml":
        cfg, jcfg = cfg.replace(env=XML), dataclasses.replace(jcfg, env=XML)
    return cfg, jcfg


def _inputs(name: str, cfg, n: int, cycles: int, seed: int = 5):
    """(n, s) states near each task's and (cycles, n, a) actions up to 1.5×
    the config's bounds (past every clamp), from a numpy seed. Robot 0 of a
    point mass or the cart-pole starts at its stop driving into it; the 3-D
    quadrotors' quaternions are unit."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-0.6, 0.6, (n, cfg.state_dim)).astype(np.float32)
    if name == "quadrotor3d":
        xs[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + rng.uniform(-0.2, 0.2, (n, 4))
        xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=1, keepdims=True)
    bound = np.asarray(cfg.max_a, np.float32)
    us = rng.uniform(-1.5, 1.5, (cycles, n, cfg.action_dim)).astype(np.float32) * bound
    if name.startswith("point_mass"):
        xs[0, 0], us[:, 0, 0] = 1.39, 1.5 * bound[0]
    if name == "cartpole":
        xs[0, 0], us[:, 0, 0] = 2.38, 1.5 * bound[0]
    return xs, us


# each layout: robots (None: one robot, no robot axis), the clocks of the
# first cycle, as multiples-or-offsets of (timestep, sim_end), and the
# states: near the task's, or chip_smoke.world_hard_states' (angles on
# sinf's and cosf's large-argument path, the arm at its smallest mass-matrix
# determinant, NaN states)
LAYOUTS = {
    "solo before sim_end": (None, "dt", "task"),
    "solo at sim_end": (None, "end", "task"),
    "solo past sim_end": (None, "past", "task"),
    "R=8 shared clock": (R, "dt", "task"),
    "R=8 shared clock at sim_end": (R, "end", "task"),
    "R=8 per-robot clocks": (R, "mixed", "task"),
    "R=8 hard states": (R, "dt", "hard"),
}


def _clocks(kind: str, n: int, p) -> np.ndarray:
    dt, end = np.float32(p.timestep), np.float32(p.sim_end)
    last = np.float32(p.sim_end - p.steps_per_control * p.timestep)  # crosses sim_end in one cycle
    return {
        "dt": np.float32(dt), "end": end, "past": np.float32(p.sim_end + 0.5),
        "mixed": np.float32([dt, 1.0, last, end, p.sim_end + 0.5, 4.0, dt, last][:n]),
    }[kind]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_plain_cycle_matches_jax_simulate(name, layout):
    """Two control cycles of the plain loop (``ws.plain_advance``, what
    ``World.advance`` runs on the CPU) against the JAX world's ``simulate``
    under ``jax.jit`` (``jax.vmap`` over the robots), from the same states,
    clocks and actions: rtol 1e-5 / atol 1e-6 (XLA's and torch's float32
    trigonometry an ulp apart over up to 8 RK4 steps); a robot held at or
    past sim_end is equal bit for bit in both, and to its start. The hard
    states hold the worlds' angles at 1e5-7.8e12, where both reduce the
    argument in full, the arm where its determinant is smallest, and NaN
    states, which stay NaN in both."""
    cfg, jcfg = _configs(name)
    tworld, jworld = make_world(cfg), make_jax_world(jcfg)
    p = tworld.params
    n, clock_kind, states = LAYOUTS[layout]
    xs, us = _inputs(name, cfg, n or 1, 2)
    if states == "hard":
        import chip_smoke

        chip_smoke.world_hard_states(name, xs)
    clocks = _clocks(clock_kind, n or 1, p)
    if n is None:
        xs, us = xs[0], us[:, 0]
    ts = tworld.from_x(torch.from_numpy(xs), torch.from_numpy(np.asarray(clocks)))
    if n is None:
        js, sim = jworld.from_x(jnp.asarray(xs), float(clocks)), jax.jit(jworld.simulate)
        x_of = jworld.get_x
    elif np.ndim(clocks) == 0:  # one clock shared by the robots: not mapped
        js = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *(
            jworld.from_x(jnp.asarray(xs[r]), float(clocks)) for r in range(n)))
        js = js._replace(time=jnp.float32(clocks))
        axes = type(js)(*([0] * (len(js) - 1)), None)
        sim = jax.jit(jax.vmap(jworld.simulate, in_axes=(axes, 0), out_axes=(axes, None)))
        x_of = jax.vmap(jworld.get_x, in_axes=(axes,))
    else:
        js = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *(
            jworld.from_x(jnp.asarray(xs[r]), float(clocks[r])) for r in range(n)))
        sim = jax.jit(jax.vmap(jworld.simulate))
        x_of = jax.vmap(jworld.get_x)
    held = np.asarray(clocks >= np.float32(p.sim_end))
    for c in range(2):
        ts = ws.plain_advance(tworld, ts, torch.from_numpy(us[c]))
        js, _ = sim(js, jnp.asarray(us[c]))
        got, want = ts.x.numpy(), np.asarray(x_of(js))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"cycle {c}")
        np.testing.assert_allclose(ts.time.numpy(), np.asarray(js.time), rtol=1e-6)
        if held.any():
            np.testing.assert_array_equal(got[held], xs[held])
            np.testing.assert_array_equal(want[held], xs[held])


def _pack_lines() -> dict[str, list[str]]:
    src = open(SOURCE).read()
    return {m.group(1): m.group(2).split() for m in re.finditer(r"// @pack (\w+): (.*)", src)}


def _struct_constants() -> dict[str, dict[str, int]]:
    """{struct: {kS, kA, kLeaves, kParams}} of csrc/world_step.cuh's worlds."""
    src = open(HEADER).read()
    out = {}
    for m in re.finditer(r"struct (\w+) : Cadence \{\s*static constexpr int ([^;]*);", src):
        out[m.group(1)] = {k.strip(): v.strip() for k, v in
                           (a.split("=") for a in m.group(2).split(","))}
    return out


STRUCTS = {"point_mass": "PointMass", "pendulum": "Pendulum", "cartpole": "CartPole",
           "unicycle": "Unicycle", "quadrotor": "Quadrotor", "quadrotor3d": "Quadrotor3D",
           "arm": "Arm"}


def _expected_fields(name: str, p) -> dict[str, float]:
    """Each packed number from the params dataclass: the cadence, then the
    world's own, Python-scalar products and reciprocals taken in double (as
    the plain world's torch ops take them)."""
    h = p.timestep
    own = {
        "point_mass": lambda: dict(ctrl_range=p.ctrl_range, gear=p.gear, damping=p.damping,
                                   inv_mass=1.0 / (p.mass + p.armature), joint_range=p.joint_range),
        "pendulum": lambda: dict(max_torque=p.max_torque, g_over_l=p.gravity / p.length,
                                 inv_ml2=1.0 / (p.mass * p.length * p.length), damping=p.damping),
        "cartpole": lambda: dict(max_force=p.max_force, inv_total=1.0 / (p.cart_mass + p.pole_mass),
                                 ml=p.pole_mass * p.pole_length, gravity=p.gravity,
                                 pole_length=p.pole_length, four_thirds=4.0 / 3.0,
                                 pole_mass=p.pole_mass, track_limit=p.track_limit),
        "unicycle": lambda: dict(max_v=p.max_v, max_w=p.max_w),
        "quadrotor": lambda: dict(max_thrust=p.max_thrust, inv_mass=1.0 / p.mass, gravity=p.gravity,
                                  arm=p.arm, inv_inertia=1.0 / p.inertia),
        "quadrotor3d": lambda: dict(
            max_thrust=p.max_thrust, inv_two_arm=1.0 / (2 * p.arm), inv_four_kappa=1.0 / (4 * p.kappa),
            arm=p.arm, kappa=p.kappa, inv_mass=1.0 / p.mass, gravity=p.gravity,
            jzy=p.inertia[2] - p.inertia[1], jxz=p.inertia[0] - p.inertia[2],
            jyx=p.inertia[1] - p.inertia[0], inv_jx=1.0 / p.inertia[0], inv_jy=1.0 / p.inertia[1],
            inv_jz=1.0 / p.inertia[2]),
        # models/arm.py TwoLinkArmDynamics.create's constants at lc = l/2, I = m·l²/12
        "arm": lambda: dict(
            max_t1=p.max_t1, max_t2=p.max_t2,
            A=p.m1 * p.l1**2 / 12 + p.m2 * p.l2**2 / 12 + p.m1 * (p.l1 / 2) ** 2
            + p.m2 * (p.l1**2 + (p.l2 / 2) ** 2),
            B=p.m2 * p.l1 * p.l2 / 2, D=p.m2 * p.l2**2 / 12 + p.m2 * (p.l2 / 2) ** 2,
            G1=(p.m1 * p.l1 / 2 + p.m2 * p.l1) * p.gravity, G2=p.m2 * p.l2 / 2 * p.gravity,
            damping=p.damping, max_rate=p.max_rate),
    }[name]()
    return {"timestep": h, "half_step": 0.5 * h, "sixth_step": h / 6.0, "sim_end": p.sim_end, **own}


@pytest.mark.parametrize("name", CASES)
def test_pack_matches_params_and_the_source_layout(name):
    """The packed float32 vector against each params dataclass (every
    number within 1 ulp of its double, the products and reciprocals
    computed from the dataclass's fields); its field names and their order
    against the body's ``@pack`` line in csrc/world_step.cu; the body's
    kParams, kA, kLeaves and kS in csrc/world_step.cuh against WORLDS and
    the state; and the C ids of WORLDS against the header's WorldId."""
    cfg, _ = _configs(name)
    world = make_world(cfg)
    kind, fields = ws.pack_fields(world)
    wid, shapes, A, line = ws.WORLDS[kind]
    want = _expected_fields(line, world.params)
    assert list(fields) == _pack_lines()[line] == list(want)
    packed = world._packs[torch.device("cpu")]
    np.testing.assert_allclose(packed.numpy(), np.float32(list(want.values())), rtol=2**-23)
    assert torch.equal(packed, ws.pack(world))
    consts = _struct_constants()[STRUCTS[line]]
    state = world.reset()
    assert int(consts["kParams"]) == packed.numel()
    assert consts["kA"] in (str(A), "N") and A == cfg.action_dim
    assert int(consts["kLeaves"]) == len(shapes) == len(state) - 1
    assert [tuple(leaf.shape) for leaf in state[:-1]] == list(shapes)
    assert consts["kS"] in (str(cfg.state_dim), "2 * N")
    ids = re.search(r"enum WorldId \{([^}]*)\}", open(HEADER).read()).group(1)
    assert [int(v) for v in re.findall(r"= (\d+)", ids)] == sorted(w[0] for w in ws.WORLDS.values())
    assert wid == list(ws.WORLDS).index(kind)


def _struct_body(struct: str) -> str:
    """The source of one world struct of csrc/world_step.cuh."""
    src = open(HEADER).read()
    start = src.index(f"struct {struct} : Cadence")
    return src[start:src.index("\n};", start)]


@pytest.mark.parametrize("line", sorted(STRUCTS))
def test_world_bodies_take_their_float_substitutions(line):
    """Each world body of csrc/world_step.cuh reaches a sine and a cosine of
    one argument through ``sin_cos`` (never sinf and cosf of it apart) and a
    correctly rounded 1/x through ``rcp`` (never the division 1.0f / x):
    the substitutions that chip_smoke.py's phase 21 holds over all 2³² float
    inputs on the card (``world_step.identities``, in the order the probe
    kernel counts them)."""
    body = _struct_body(STRUCTS[line])
    sines = set(re.findall(r"\bsinf\(([^()]*(?:\([^()]*\))?)\)", body))
    cosines = set(re.findall(r"\bcosf\(([^()]*(?:\([^()]*\))?)\)", body))
    assert not sines & cosines, f"{line}: sinf and cosf of {sines & cosines} apart"
    assert not re.search(r"dvd\(1\.0f,", body)
    if line in ("cartpole", "unicycle", "quadrotor", "arm"):
        assert "sin_cos(" in body
    assert ("rcp(" in body) == (line == "arm")
    probe = open(SOURCE).read()
    assert re.search(r"k: 0 rcp, 1 sine, 2 cosine", probe)
    assert list(ws.IDENTITIES) == ["rcp", "sin", "cos"]
    with pytest.raises(ValueError, match="CUDA device"):
        ws.identities("cpu")


# the packed fields at which the two candidate reciprocals of torch's CUDA
# x / c, 1.0f/(float)c and (float)(1/c), are different floats at the
# configs' defaults: the cart-pole's total mass 1.1 and the 3-D
# quadrotor's 4κ = 0.064 (at every config's λ they agree)
RECIPROCALS_APART = {("cartpole", "inv_total"), ("quadrotor3d", "inv_four_kappa")}


@pytest.mark.parametrize("name", CASES)
def test_every_division_by_a_python_float_packs_one_reciprocal(monkeypatch, name):
    """Every field a world packs for a division by a Python float, and the
    config's λ that K7 divides by, go through ``_rounding.scalar_reciprocal``
    once each: each divisor is listed with the two candidate reciprocals,
    1.0f/(float)c and (float)(1/c), and whether they differ; the pack holds
    (float)(1/c), what torch's CUDA division multiplies by on the card, and
    K7's entry is passed that of λ. The candidates differ exactly at
    RECIPROCALS_APART and at no config's λ."""
    seen = []
    real = _rounding.scalar_reciprocal
    monkeypatch.setattr(_rounding, "scalar_reciprocal", lambda c: seen.append(c) or real(c))
    cfg, _ = _configs(name)
    world = make_world(cfg)
    kind, own = world.kernel_params()
    divisors = {k: v.divisor for k, v in own.items() if isinstance(v, ws.Reciprocal)}
    seen.clear()
    _, fields = ws.pack_fields(world)
    assert seen == list(divisors.values())
    rows = []
    for field, c in divisors.items():
        a, b = np.float32(1.0) / np.float32(c), np.float32(1.0 / c)
        assert fields[field] == float(b)
        rows.append((field, c, float(a), float(b), bool(a != b)))
    lam = cfg.lambda_
    rows.append(("lambda", lam, float(np.float32(1.0) / np.float32(lam)),
                 float(np.float32(1.0 / lam)), bool(np.float32(1.0) / np.float32(lam)
                                                    != np.float32(1.0 / lam))))
    apart = {(kind, f) for f, *_, d in rows if d}
    assert apart == {k for k in RECIPROCALS_APART if k[0] == kind}, rows
    # K7's wrapper, its C entry stubbed: λ through the helper, into the entry
    recorded = []
    lib = types.SimpleNamespace(mppi_solve_tail=lambda *a: recorded.append(a) or 0)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(st, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    monkeypatch.setattr(st, "_LAUNCHES", dict(st._LAUNCHES))
    seen.clear()
    T, A, K = 4, cfg.action_dim, 8
    z = torch.zeros(K)
    st.solve_tail(torch.zeros(T, A), torch.zeros(T, A), torch.ones(A), True, st.OUTPUTS,
                  (z, torch.tensor(0.0), torch.tensor(1.0), lam))
    (args,) = recorded
    assert seen == [lam] and args[12] == float(np.float32(1.0 / lam))


def _stub(monkeypatch, rc: int = 0):
    """CPU tensors taken for CUDA ones and K6's C entries stubbed (the
    layout the source's, the launch recorded and returning `rc`); stubbed
    launches count in a copy of the launch counts."""
    monkeypatch.setattr(ws, "_LAUNCHES", dict(ws._LAUNCHES))
    monkeypatch.setattr(ws, "_CHECKED", set())
    calls = []

    def layout(wid, widths, n_params, a):
        kind = next(k for k, v in ws.WORLDS.items() if v[0] == wid)
        _, shapes, A, line = ws.WORLDS[kind]
        for i, s in enumerate(shapes):
            widths[i] = int(np.prod(s))
        n_params._obj.value = len(_pack_lines()[line])
        a._obj.value = A
        return len(shapes)

    def advance(*args):
        calls.append(args)
        return rc

    lib = types.SimpleNamespace(mppi_world_layout=layout, mppi_world_advance=advance)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ws, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=5))
    return calls


@pytest.mark.parametrize("per_robot", [False, True])
@pytest.mark.parametrize("name", ["point_mass3d", "quadrotor3d"])
def test_cuda_bound_cycle_passes_its_buffers(monkeypatch, name, per_robot):
    """Device-free: a CUDA-bound cycle calls K6's entry once with the world's
    id, the state's leaves (in place for ``advance_into``, new buffers for
    ``advance``), the clock and its layout, u and A, the world's pack, R,
    steps_per_control, and for ``advance_into`` the histories, the step
    counter and the episode's x buffer by address with the counter's
    advance asked for (the fleet's
    action strided, as a column of its sequences, by its robot stride); the
    launch counts under the world's kind."""
    calls = _stub(monkeypatch)
    cfg, _ = _configs(name)
    world = make_world(cfg)
    xs0, us0 = _inputs(name, cfg, R, 1)
    clock = torch.full((R,), world.params.timestep) if per_robot else torch.tensor(0.01)
    state = world.from_x(torch.from_numpy(xs0), clock)
    state = type(state)(*(leaf.contiguous() for leaf in state))
    # the fleet's action as the controller gives it: a column of its sequences
    seqs = torch.from_numpy(us0[0])[:, None].expand(R, 5, cfg.action_dim).contiguous()
    u = seqs[:, 0]
    n = 6
    hx, hu = torch.zeros(n + 1, R, cfg.state_dim), torch.zeros(n, R, cfg.action_dim)
    ht, step = torch.zeros(n, *clock.shape), torch.tensor(3)
    xb = torch.zeros(R, cfg.state_dim)
    ws.advance_into(world, state, u, hx, hu, ht, step, xb)
    new = world.advance(state, u)
    assert len(calls) == 2 and ws.launch_counts()[ws.pack_fields(world)[0]] == 2
    kind, _ = ws.pack_fields(world)
    for args, out, hist in ((calls[0], state, True), (calls[1], new, False)):
        (wid, ins, outs, n_leaves, t_in, t_out, per, u_ptr, u_stride, A, params, n_params, r,
         steps, px, pu, pt, n_hist, step_ptr, x_ptr, tick) = args[:-1]
        assert args[-1] == 5  # the stream
        assert wid == ws.WORLDS[kind][0] and n_leaves == len(state) - 1
        assert list(ins)[:n_leaves] == [leaf.data_ptr() for leaf in state[:-1]]
        assert list(outs)[:n_leaves] == [leaf.data_ptr() for leaf in out[:-1]]
        assert (t_in, t_out, per) == (state.time.data_ptr(), out.time.data_ptr(), int(per_robot))
        assert (u_ptr, u_stride, A, r, steps) == (u.data_ptr(), 5 * cfg.action_dim, cfg.action_dim,
                                                  R, world.params.steps_per_control)
        packed = world._packs[torch.device("cpu")]
        assert (params, n_params) == (packed.data_ptr(), packed.numel())
        if hist:
            assert (px, pu, pt, n_hist, step_ptr) == (hx.data_ptr(), hu.data_ptr(), ht.data_ptr(),
                                                      n, step.data_ptr())
            assert (x_ptr, tick) == (xb.data_ptr(), 1)
        else:
            assert (px, pu, pt, n_hist, step_ptr, x_ptr, tick) == (None, None, None, 0, None, None, 0)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(new, state))
    assert [tuple(a.shape) for a in new] == [tuple(b.shape) for b in state]


def test_cpu_state_never_reaches_the_launcher(monkeypatch):
    """A built-in world on CPU tensors runs the plain loop: no entry called,
    nothing counted, the result the plain version's bit for bit."""
    calls = _stub(monkeypatch)
    monkeypatch.setattr(ws, "_on_cuda", lambda tensors: False)
    cfg, _ = _configs("cartpole")
    world = make_world(cfg)
    xs0, us0 = _inputs("cartpole", cfg, R, 1)
    state = world.from_x(torch.from_numpy(xs0), 0.01)
    u = torch.from_numpy(us0[0])
    got, done = world.advance(state, u), world.simulate(state, u)
    want = ws.plain_advance(world, state, u)
    assert not calls and sum(ws.launch_counts().values()) == 0
    assert torch.equal(got.x, want.x) and torch.equal(done[0].x, want.x) and not done[1]


def test_user_world_runs_its_own_operations(monkeypatch):
    """A World subclass from user code has no kernel, whatever its state's
    device: its own physics_step runs, also through ``advance_into``."""
    calls = _stub(monkeypatch)

    @dataclasses.dataclass(frozen=True)
    class Doubled(PendulumWorld):
        def physics_step(self, s, u):
            return PendulumState(th=s.th * 2.0, thd=s.thd + 1.0, time=s.time + self.params.timestep)

    world = Doubled(params_for_config(_configs("pendulum")[0]))
    assert not ws.has_kernel(world) and ws.has_kernel(PendulumWorld(world.params))
    state = world.reset(3)
    u = torch.zeros(3, 1)
    new = world.advance(state, u)
    steps = world.params.steps_per_control
    assert torch.equal(new.th, state.th * 2.0**steps) and torch.equal(new.thd, state.thd + steps)
    xs, us, ts = torch.zeros(3, 3, 2), torch.zeros(2, 3, 1), torch.zeros(2)
    x, step = torch.zeros(3, 2), torch.tensor(0)
    ws.advance_into(world, state, u, xs, us, ts, step, x)
    assert torch.equal(state.th, new.th) and torch.equal(xs[1], new.x) and ts[0] == new.time
    assert torch.equal(x, new.x) and int(step) == 1
    assert not calls


def test_failed_or_refused_launch_raises(monkeypatch):
    """A non-zero return of the entry raises (no fallback to the plain
    loop); so do a non-contiguous leaf, a float64 action, a step that is
    not a 0-dim int64, an action whose robot's entries are not side by
    side or whose robots share them, and an x buffer of another shape,
    before any launch."""
    calls = _stub(monkeypatch, rc=700)
    cfg, _ = _configs("arm")
    world = make_world(cfg)
    state = world.reset(4)
    u = torch.zeros(4, 2)
    with pytest.raises(RuntimeError, match="world_advance failed to launch: cudaError_t 700"):
        world.advance(state, u)
    assert len(calls) == 1 and sum(ws.launch_counts().values()) == 0
    hist = (torch.zeros(3, 4, 4), torch.zeros(2, 4, 2), torch.zeros(2))
    x = torch.zeros(4, 4)
    strided = type(state)(q=torch.zeros(4, 8)[:, ::2], time=state.time)
    with pytest.raises(ValueError, match="contiguous"):
        ws.advance_into(world, strided, u, *hist, torch.tensor(0), x)
    with pytest.raises(TypeError, match="float32"):
        ws.advance_into(world, state, u.double(), *hist, torch.tensor(0), x)
    with pytest.raises(TypeError, match="0-dim int64"):
        ws.advance_into(world, state, u, *hist, torch.tensor([0]), x)
    with pytest.raises(ValueError, match="side by side"):
        ws.advance_into(world, state, torch.zeros(2, 4).t(), *hist, torch.tensor(0), x)
    with pytest.raises(ValueError, match="side by side"):  # one action for every robot
        ws.advance_into(world, state, torch.zeros(2).expand(4, 2), *hist, torch.tensor(0), x)
    with pytest.raises(ValueError, match="x must have shape"):
        ws.advance_into(world, state, u, *hist, torch.tensor(0), torch.zeros(4, 3))
    assert len(calls) == 1


@pytest.mark.parametrize("capturing", [False, True])
def test_only_a_launch_that_runs_is_counted(monkeypatch, capturing):
    """While the stream captures a CUDA graph the entry is called (the graph
    records the launch) but nothing is counted."""
    calls = _stub(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    world = make_world(_configs("unicycle")[0])
    world.advance(world.reset(), torch.zeros(2))
    assert len(calls) == 1 and ws.launch_counts()["unicycle"] == (0 if capturing else 1)


@pytest.mark.parametrize("name", ["point_mass2d", "quadrotor"])
def test_cpu_cycle_writes_the_histories_per_robot_clock(name):
    """``advance_into`` on the CPU: the state's buffers and the x buffer hold
    the cycle's result, the histories their rows at the counter and the
    counter its next step, under one clock per robot too (ts of shape
    (N, R)), equal to ``advance``'s result."""
    cfg, _ = _configs(name)
    world = make_world(cfg)
    xs0, us0 = _inputs(name, cfg, 4, 2)
    p = world.params
    clocks = torch.tensor([p.timestep, 2.0, p.sim_end, 3.0], dtype=torch.float32)
    ref = world.from_x(torch.from_numpy(xs0), clocks)
    state = type(ref)(*(leaf.clone() for leaf in ref))
    hx, hu, ht = torch.zeros(3, 4, cfg.state_dim), torch.zeros(2, 4, cfg.action_dim), torch.zeros(2, 4)
    step, x = torch.tensor(0), torch.zeros(4, cfg.state_dim)
    for c in range(2):
        u = torch.from_numpy(us0[c])
        ref = world.advance(ref, u)
        ws.advance_into(world, state, u, hx, hu, ht, step, x)
        assert int(step) == c + 1 and torch.equal(x, ref.x)
        assert torch.equal(state.x, ref.x) and torch.equal(state.time, ref.time)
        assert torch.equal(hx[c + 1], ref.x) and torch.equal(hu[c], u) and torch.equal(ht[c], ref.time)
    assert torch.equal(hx[1:, 2], torch.from_numpy(xs0[2]).expand(2, -1))  # robot 2 held


SAMPLES = [3.5, 1.25, 9.0, 2.0, 2.5, 0.75, 4.0]


@pytest.mark.parametrize("split_first", [False, True])
def test_solve_timer_matches_jax(split_first):
    """``summary`` and ``percentile_ms``/``mean_ms`` of the port's
    SolveTimer against the JAX package's on the same samples."""
    mine, ref = SolveTimer(), JaxSolveTimer(list(SAMPLES))
    mine.samples_ms = list(SAMPLES)
    assert mine.summary(split_first=split_first) == pytest.approx(ref.summary(split_first=split_first))
    for q in (0, 10, 50, 95, 100):
        assert mine.percentile_ms(q) == pytest.approx(ref.percentile_ms(q))
    assert mine.mean_ms == pytest.approx(ref.mean_ms)
    empty = SolveTimer()
    assert np.isnan(empty.percentile_ms(50)) and np.isnan(empty.mean_ms)


@pytest.mark.parametrize("name", ["point_mass_xml", "cartpole", "quadrotor3d"])
def test_chip_smoke_world_check_runs_on_the_cpu(name):
    """chip_smoke.py's K6 check on CPU tensors, where ``advance`` and
    ``advance_into`` run the plain loop: every layout (solo, R=8, R=64,
    both clock layouts, crossing sim_end, NaN state and action) agrees bit
    for bit, the history rows land at the counter's rows and no launch is
    counted."""
    import chip_smoke

    got = chip_smoke.check_world_step(name, device="cpu")
    assert got == {"max_abs_err": 0.0, "bit_equal": True, "launches": 0}
