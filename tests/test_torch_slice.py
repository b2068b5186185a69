"""The port's closed-loop slice against the JAX package: point_mass2d with
both controllers fed the same numpy ε each step and each driving its own
PointMassWorld; the port's CLI on the CPU; and the divergence guard."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu.controller import MPPIController as JaxController  # noqa: E402
from mppi_gpu_tpu.envs.params import WorldParams as JaxWorldParams  # noqa: E402
from mppi_gpu_tpu.envs.point_mass_world import PointMassWorld as JaxWorld  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.controller import MPPIController  # noqa: E402
from mppi_gpu_tpu_torch.envs import PointMassWorld, WorldParams  # noqa: E402

CFG = "configs/point_mass2d.yaml"


def test_closed_loop_matches_jax_on_the_same_eps():
    """20 control steps at K=256, T=20. Per-step f32 differences (~1e-7 in
    S, amplified by the softmin to ~1e-6 in the action) feed back through
    the plant, so states and actions are held to 2e-5."""
    K, T, steps = 256, 20, 20
    cfg = load_config(CFG).replace(samples=K, horizon=T)
    jcfg = load_jax_config(CFG).replace(samples=K, horizon=T)
    tctrl = MPPIController(cfg, device="cpu")
    jctrl = JaxController(jcfg, rollout_backend="scan")
    tworld, jworld = PointMassWorld(WorldParams(n_axes=2)), JaxWorld(JaxWorldParams(n_axes=2))
    jsim = jax.jit(jworld.simulate)
    ts, js = tworld.reset(), jworld.reset()
    tU, jU = tctrl.init_action_seq(), jctrl.init_action_seq()
    rng = np.random.default_rng(0)
    for step in range(steps):
        eps = (0.25 * rng.standard_normal((T, K, 2))).astype(np.float32)
        rt = tctrl.solve_with_eps(ts.x, tU, torch.as_tensor(eps))
        rj = jctrl.solve_with_eps(js.x, jU, jnp.asarray(eps))
        np.testing.assert_allclose(rt.action.numpy(), np.asarray(rj.action), rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(rt.u_next.numpy(), np.asarray(rj.u_next), rtol=1e-4, atol=2e-5)
        tU, jU = rt.u_next, rj.u_next
        ts, tdone = tworld.simulate(ts, rt.action)
        js, jdone = jsim(js, rj.action)
        assert tdone == bool(jdone) is False
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-4, atol=2e-5)
        assert float(ts.time) == pytest.approx(float(js.time), rel=1e-6)
    assert float(np.abs(ts.x.numpy()).max()) > 0.01  # the robot moved


def test_world_matches_jax_world():
    """Same actions, same physics: RK4 steps and joint clamp agree with the
    JAX world, down to the episode's end flag."""
    tworld, jworld = PointMassWorld(WorldParams(n_axes=3)), JaxWorld(JaxWorldParams(n_axes=3))
    jsim = jax.jit(jworld.simulate)
    ts, js = tworld.reset(), jworld.reset()
    rng = np.random.default_rng(1)
    n = 0
    while True:
        u = rng.uniform(-1.5, 1.5, 3).astype(np.float32)  # past ctrl_range: clipped
        u[0] = 1.5  # drives axis 0 into its joint stop
        ts, tdone = tworld.simulate(ts, torch.as_tensor(u))
        js, jdone = jsim(js, jnp.asarray(u))
        assert tdone == bool(jdone)
        if tdone:
            break
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-5, atol=1e-6)
        n += 1
    assert n == WorldParams(n_axes=3).num_control_steps()
    assert float(np.abs(ts.q.numpy()).max()) == pytest.approx(1.4)  # hit a joint stop


def test_cli_runs_on_the_cpu(capsys, tmp_path):
    from mppi_gpu_tpu_torch import cli

    traj = tmp_path / "traj.csv"
    rc = cli.main(["-c", CFG, "--device", "cpu", "--max-steps", "30", "-t", str(traj),
                   "-s", str(tmp_path / "dump"), "--dump-every", "30", "--seed", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "episode finished: 30 control steps" in out
    assert "Average controller execution time" in out
    assert traj.exists() and len(traj.read_text().splitlines()) == 31
    assert [p.name for p in (tmp_path / "dump").iterdir()] == ["step_00000.csv"]


@pytest.mark.parametrize("argv,needle", [
    (["--device", "cuda"], None),
    (["--device", "cpu", "--view"], "--view"),
    (["--device", "cpu", "--world", "mujoco"], "--world"),
    (["--device", "cpu", "--compile-cache"], "--compile-cache"),
    (["--device", "cpu", "--world", "native"], "--world"),
])
def test_cli_refuses_what_it_cannot_do(capsys, argv, needle):
    from mppi_gpu_tpu_torch import cli

    if argv[1] == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(["-c", CFG, "--max-steps", "1", *argv])
    err = capsys.readouterr().err
    assert rc == 2
    assert ("CUDA is not available" in err) if needle is None else (needle in err and "ROADMAP" in err)


def test_all_diverged_guard_on_padded_K():
    """cost_w = 1e38 makes every rollout cost +inf: the eager solve's action
    is NaN and the closed loop raises ControllerDiverged, as on the JAX scan
    path; the fused path's plain version (K = 300, padded to 3 blocks) does
    the same."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.runner import run_closed_loop
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged

    cfg = load_config(CFG).replace(samples=300, horizon=8, cost_w=(1e38,) * 4)
    ctrl = MPPIController(cfg, device="cpu")
    res = ctrl.solve_auto(torch.zeros(4), ctrl.init_action_seq(), 0)
    assert torch.isnan(res.action).all()
    jres = JaxController(load_jax_config(CFG).replace(samples=300, horizon=8, cost_w=(1e38,) * 4),
                         rollout_backend="scan").solve_auto(
        jnp.zeros(4), jnp.zeros((8, 2)), jax.random.key(0), 0)
    assert np.isnan(np.asarray(jres.action)).all()
    with pytest.raises(ControllerDiverged):
        run_closed_loop(ctrl, max_steps=3)
    c = ctrl.cost
    S, beta, eta, dU = fs.fused_solve(
        torch.zeros(4), ctrl.init_action_seq(), ctrl.sigma, c.inv_s, c.w, c.goal, 1.0, 1.0,
        0.1, 300, 0, 0, 0, False, 0.0,
    )
    assert fs.BLOCK * 3 > 300 and torch.isnan(dU).all()


def test_unported_runner_options_raise():
    from mppi_gpu_tpu_torch.runner import run_closed_loop

    ctrl = MPPIController(load_config(CFG).replace(samples=16, horizon=4), device="cpu")
    for kw in (dict(world_backend="native"), dict(world_backend="mujoco"), dict(view=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_closed_loop(ctrl, max_steps=1, **kw)
