"""The port stands alone: importing it loads neither JAX nor the JAX package
and builds nothing, and every config loads to the same fields in both
packages."""

from __future__ import annotations

import dataclasses
import glob
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import mppi_gpu_tpu_torch, mppi_gpu_tpu_torch.cli, mppi_gpu_tpu_torch.runner\n"
        "import mppi_gpu_tpu_torch.controller, mppi_gpu_tpu_torch.convert\n"
        "import mppi_gpu_tpu_torch.ops.fused_solve, mppi_gpu_tpu_torch.batched\n"
        "import mppi_gpu_tpu_torch.models.unicycle, mppi_gpu_tpu_torch.models.quadrotor\n"
        "import mppi_gpu_tpu_torch.models.arm, mppi_gpu_tpu_torch.envs.unicycle_world\n"
        "import mppi_gpu_tpu_torch.envs.quadrotor_world, mppi_gpu_tpu_torch.envs.arm_world\n"
        "import mppi_gpu_tpu_torch.models.quadrotor3d, mppi_gpu_tpu_torch.envs.quadrotor3d_world\n"
        "import mppi_gpu_tpu_torch.examples.obstacle_nav, mppi_gpu_tpu_torch.examples.quadrotor3d_flight\n"
        "import mppi_gpu_tpu_torch.parallel, mppi_gpu_tpu_torch.parallel.mesh\n"
        "import mppi_gpu_tpu_torch.parallel.multihost, mppi_gpu_tpu_torch.parallel.sharded\n"
        "import mppi_gpu_tpu_torch.parallel.fleet\n"
        "import mppi_gpu_tpu_torch.models.neural, mppi_gpu_tpu_torch.ops.families\n"
        "import mppi_gpu_tpu_torch.examples.custom_family, mppi_gpu_tpu_torch.examples.quadrotor_waypoints\n"
        "import mppi_gpu_tpu_torch.examples.learn_dynamics\n"
        "import mppi_gpu_tpu_torch.examples.learn_quadrotor_residual\n"
        "import mppi_gpu_tpu_torch.miss, mppi_gpu_tpu_torch.envs.native\n"
        "import mppi_gpu_tpu_torch.envs.mujoco_world, mppi_gpu_tpu_torch.envs.xml\n"
        "from mppi_gpu_tpu_torch import register_family\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'mppi_gpu_tpu', 'matplotlib', 'mujoco')]\n"
        "assert not bad, bad\n"
        "assert 'mppi_gpu_tpu_torch.ops._build' not in sys.modules\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_loads_equal_in_both_packages(path):
    from mppi_gpu_tpu.config import load_config as load_jax
    from mppi_gpu_tpu_torch.config import load_config as load_torch

    assert dataclasses.asdict(load_torch(path)) == dataclasses.asdict(load_jax(path))


def test_unported_families_raise_naming_roadmap():
    """Once the port's last refusals: an XML world now loads, and the one
    whose axes do not match the config's action-dim raises as in the JAX
    package. The 3-D quadrotor, the last family to be ported, builds its
    model, cost and world, and its fleet runs an episode in the batched
    world (which once raised here)."""
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.config import load_config
    from mppi_gpu_tpu_torch.envs import make_world, params_for_config
    from mppi_gpu_tpu_torch.models import dynamics_for_config
    from mppi_gpu_tpu_torch.ops.cost import make_cost
    from mppi_gpu_tpu_torch.runner import run_fleet_episode

    cfg = load_config(os.path.join(ROOT, "configs", "quadrotor3d.yaml"))
    assert type(dynamics_for_config(cfg, "cpu")).__name__ == "Quadrotor3DDynamics"
    assert type(make_cost(cfg, "cpu")).__name__ == "Quadrotor3DHoverCost"
    assert type(make_world(cfg)).__name__ == "Quadrotor3DWorld"
    xml = load_config(os.path.join(ROOT, "configs", "point_mass2d.yaml")).replace(
        env=os.path.join(ROOT, "envs_xml", "point_mass3d.xml"))
    with pytest.raises(ValueError, match="3 axes but config action-dim is 2"):
        params_for_config(xml)
    assert params_for_config(xml.replace(env=xml.env.replace("3d", "2d"))).n_axes == 2
    fleet = BatchedMPPIController(cfg.replace(samples=16, horizon=4), 2, device="cpu")
    ep = run_fleet_episode(fleet, num_steps=1)
    assert ep.xs.shape == (2, 2, 13) and ep.us.shape == (1, 2, 4) and ep.times.shape == (1,)
