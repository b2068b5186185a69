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
        "import mppi_gpu_tpu_torch.ops.fused_solve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mppi_gpu_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'mppi_gpu_tpu_torch.ops._build' not in sys.modules\n"
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
    from mppi_gpu_tpu_torch.config import load_config
    from mppi_gpu_tpu_torch.models import dynamics_for_config
    from mppi_gpu_tpu_torch.ops.cost import make_cost

    for name in ("quadrotor", "quadrotor3d", "unicycle", "arm"):
        cfg = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dynamics_for_config(cfg, "cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_cost(cfg, "cpu")
