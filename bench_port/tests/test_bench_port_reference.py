"""The frozen reference agrees with the port's plain versions at a tiny size
on the CPU (the tests may import the port; the reference may not)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import run
from bench_port.reference import models, mppi, philox, worlds

ROOT = Path(__file__).resolve().parents[2]
CFG = {name: json.loads((ROOT / f"bench_port/configs/{name}.json").read_text())
       for name in ("point_mass3d_t200", "quadrotor3d")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys, bench_port.check, bench_port.control, bench_port.reference.mppi; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mppi_gpu_tpu_torch', 'mppi_gpu_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
    for src in (ROOT / "bench_port" / "reference").glob("*.py"):
        assert "mppi_gpu_tpu" not in src.read_text()


@pytest.mark.parametrize("seed", [7, 2**33 + 5, -3])
def test_noise_and_fleet_seeds_are_the_ports(seed):
    from mppi_gpu_tpu_torch.ops import philox as port

    sigma = torch.tensor([0.3, 0.2, 0.1, 0.4])
    want = port.sample_eps(seed, 5, 1, 6, 40, sigma)
    got = sigma * philox.normals(torch.tensor([seed]), 5, 1, 6, 40, 4)[0]
    assert torch.equal(got, want)
    assert torch.equal(philox.fleet_seeds(seed & (2**63 - 1), 9),
                       port.fleet_seeds(seed & (2**63 - 1), 9))


@pytest.mark.parametrize("name", ["point_mass3d_t200", "quadrotor3d"])
def test_model_and_cost_are_the_ports(name):
    from mppi_gpu_tpu_torch.config import config_from_mapping
    from mppi_gpu_tpu_torch.models import dynamics_for_config
    from mppi_gpu_tpu_torch.ops.cost import make_cost

    cfg = CFG[name]
    pc = config_from_mapping(cfg)
    dyn, cost = dynamics_for_config(pc, "cpu"), make_cost(pc, "cpu")
    ref = models.model(cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(32, pc.state_dim, generator=g)
    if name == "quadrotor3d":
        x[:, 3:7] /= x[:, 3:7].norm(dim=1, keepdim=True)
    u = torch.randn(32, pc.action_dim, generator=g)
    torch.testing.assert_close(ref.step(x, u), dyn.step(x, u), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ref.state_cost(x), cost.final(x), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", ["point_mass3d_t200", "quadrotor3d"])
def test_cycle_is_the_ports_solve(name):
    from mppi_gpu_tpu_torch.config import config_from_mapping
    from mppi_gpu_tpu_torch.controller import MPPIController

    cfg = {**CFG[name], "samples": 96, "horizon": 10}
    ctrl = MPPIController(config_from_mapping({**cfg, "seed": 11}), device="cpu")
    x = torch.tensor(cfg["goal"]) * 0.5
    if name == "quadrotor3d":
        x[3] = 1.0
    res = ctrl.solve_auto(x, ctrl.init_action_seq(), 3)
    a, U = mppi.Solver(cfg, torch.tensor([11]), "cpu").cycle(x[None], ctrl.init_action_seq()[None], 3)
    sigma = torch.tensor(cfg["noise"])
    assert torch.max(torch.abs(a[0] - res.action) / sigma) < 1e-3
    assert torch.max(torch.abs(U[0] - res.u_next) / sigma) < 1e-3


@pytest.mark.parametrize("name", ["point_mass3d_t200", "quadrotor3d"])
def test_world_cycle_is_the_ports(name):
    from mppi_gpu_tpu_torch.config import config_from_mapping
    from mppi_gpu_tpu_torch.envs import make_world

    cfg = CFG[name]
    world = make_world(config_from_mapping(cfg))
    g = torch.Generator().manual_seed(2)
    state = world.reset(8)
    x = state.x + 0.3 * torch.randn(state.x.shape, generator=g)
    if name == "quadrotor3d":
        x[:, 3:7] /= x[:, 3:7].norm(dim=1, keepdim=True)
    u = torch.tensor(cfg["init-act"]) + torch.randn(8, cfg["action-dim"], generator=g)
    want = world.advance(world.from_x(x, state.time), u).x
    torch.testing.assert_close(worlds.cycle(cfg["world"], x, u), want, rtol=1e-6, atol=1e-6)


def test_native_cycle_is_the_plant():
    from mppi_gpu_tpu_torch.config import config_from_mapping
    from mppi_gpu_tpu_torch.envs import make_host_world

    cfg = CFG["point_mass3d_t200"]
    plant = make_host_world(config_from_mapping(cfg), None, "native")
    rng = np.random.default_rng(3)
    for _ in range(20):
        x = rng.uniform(-1.5, 1.5, 6).astype(np.float32)
        u = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
        plant.set_state(x, 0.01)
        plant.simulate(u)
        np.testing.assert_array_equal(worlds.host_cycle(cfg["world"], x, u),
                                      plant.get_x())


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mppi_gpu_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mppi_gpu_tpu.envs", sys)
    assert run.forbidden_modules() == ["mppi_gpu_tpu"]
