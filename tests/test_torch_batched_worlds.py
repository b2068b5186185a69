"""The port's batched worlds against the JAX package: R robots of each of the
six single-state worlds (pendulum, cart-pole, unicycle, planar quadrotor,
two-link arm, 3-D quadrotor) stepped by the device-side control cycle
(``envs/base.World.advance``) against ``jax.vmap`` of the JAX world's
``simulate``, one robot already past the episode's end; each robot of a
batch against the single-robot world; and the batched reset and state
layout. Inputs are made from numpy seeds; each tolerance is stated where it
is used.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.envs import make_jax_world  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.envs import make_world  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = ("pendulum", "cartpole", "unicycle", "quadrotor", "arm", "quadrotor3d")
R = 4


def _cfg_path(name: str) -> str:
    return os.path.join(ROOT, "configs", f"{name}.yaml")


def _states_and_actions(name: str, cfg, cycles: int):
    """(R, s) start states near each task's and (cycles, R, a) actions up to
    1.5× the config's bounds (past every clamp: rotors, torques, the cart's
    force), from a numpy seed. Robot 0 of the cart-pole starts at the track's
    end driving into it; the 3-D quadrotors' quaternions are unit."""
    rng = np.random.default_rng(11)
    xs = rng.uniform(-0.6, 0.6, (R, cfg.state_dim)).astype(np.float32)
    if name == "quadrotor3d":
        xs[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + rng.uniform(-0.2, 0.2, (R, 4))
        xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=1, keepdims=True)
    bound = np.asarray(cfg.max_a, np.float32)
    us = rng.uniform(-1.5, 1.5, (cycles, R, cfg.action_dim)).astype(np.float32) * bound
    if name == "cartpole":
        xs[0, 0], us[:, 0, 0] = 2.38, 1.5 * bound[0]
    return xs, us


@pytest.mark.parametrize("name", WORLDS)
def test_batched_world_matches_jax_vmap(name):
    """Three control cycles of R = 4 robots, each with its own clock, robot 3
    already past sim_end: the port's ``advance`` against ``jax.vmap`` of the
    JAX world's ``simulate`` from the same states and actions. Robot 3 is
    held bit for bit in both. The others agree to rtol 1e-5 / atol 1e-6
    (XLA's and torch's float32 trigonometry an ulp apart, over up to 12 RK4
    steps); the 3-D quadrotor to rtol 1e-4 / atol 1e-5 (its rsqrt
    renormalisation and 13-state stages round apart further)."""
    cfg, jcfg = load_config(_cfg_path(name)), load_jax_config(_cfg_path(name))
    tworld, jworld = make_world(cfg), make_jax_world(jcfg)
    xs, us = _states_and_actions(name, cfg, 3)
    dt = tworld.params.timestep
    clocks = np.float32([dt, 1.0, 4.0, tworld.params.sim_end + 0.5])
    ts = tworld.from_x(torch.from_numpy(xs), torch.from_numpy(clocks))
    js = jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves),
        *(jworld.from_x(jnp.asarray(xs[r]), float(clocks[r])) for r in range(R)))
    jsim = jax.jit(jax.vmap(jworld.simulate))
    x_of = jax.vmap(lambda ws: ws.x)
    tol = dict(rtol=1e-4, atol=1e-5) if name == "quadrotor3d" else dict(rtol=1e-5, atol=1e-6)
    for c in range(3):
        ts = tworld.advance(ts, torch.from_numpy(us[c]))
        js, done = jsim(js, jnp.asarray(us[c]))
        assert np.asarray(done).tolist() == [False, False, False, True]
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(x_of(js)), **tol)
        np.testing.assert_array_equal(ts.x[3].numpy(), xs[3])
        np.testing.assert_allclose(ts.time.numpy(), np.asarray(js.time), rtol=1e-6)
    if name == "cartpole":
        assert float(ts.p[0]) == pytest.approx(tworld.params.track_limit)


@pytest.mark.parametrize("name", WORLDS)
def test_batched_robot_is_the_single_world(name):
    """Robot r of a batch under one shared clock steps exactly as the
    single-robot world from its own state under the same actions, over ten
    control cycles, on the device-side cycle and on the host's
    (``simulate``): torch.equal, the order of each world's arithmetic being
    the same in both."""
    cfg = load_config(_cfg_path(name))
    world = make_world(cfg)
    xs, us = _states_and_actions(name, cfg, 10)
    t0 = world.reset().time
    batch = world.from_x(torch.from_numpy(xs), t0)
    singles = [world.from_x(torch.from_numpy(xs[r]), t0) for r in range(R)]
    hosts = list(singles)
    for c in range(10):
        u = torch.from_numpy(us[c])
        batch = world.advance(batch, u)
        singles = [world.advance(s, u[r]) for r, s in enumerate(singles)]
        hosts = [world.simulate(s, u[r])[0] for r, s in enumerate(hosts)]
        for r in range(R):
            assert torch.equal(batch.x[r], singles[r].x), (c, r)
            assert torch.equal(batch.x[r], hosts[r].x), (c, r)
        assert batch.time.dim() == 0 and torch.equal(batch.time, singles[0].time)


@pytest.mark.parametrize("name", WORLDS + ("point_mass2d",))
def test_batched_reset_and_state_layout(name):
    """``reset(R)`` is R copies of the single reset under one 0-dim clock;
    ``x`` stacks on the last axis, so a batch's (R, s) state round-trips
    through ``from_x``; the world's states live on the device it was made
    for."""
    cfg = load_config(_cfg_path(name))
    world = make_world(cfg, device="cpu")
    one, batch = world.reset(), world.reset(3)
    assert tuple(one.x.shape) == (cfg.state_dim,)
    assert tuple(batch.x.shape) == (3, cfg.state_dim) and batch.time.dim() == 0
    for r in range(3):
        assert torch.equal(batch.x[r], one.x)
    back = world.from_x(batch.x, batch.time)
    assert torch.equal(back.x, batch.x) and torch.equal(back.time, batch.time)
    assert all(leaf.device.type == "cpu" for leaf in batch)
