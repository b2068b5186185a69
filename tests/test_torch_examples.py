"""Smoke tests of the port's examples that tests/test_examples.py runs in the
JAX package (quadrotor_waypoints, learn_dynamics, learn_quadrotor_residual;
custom_family is in tests/test_torch_custom_family.py): each at the JAX
smoke test's miniature scale on the CPU, so that the scripts cannot rot.
The point is that the pipeline runs and prints what it must, not task
performance (chip_smoke.py runs them at their defaults on the card)."""

from __future__ import annotations

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu_torch.examples import (  # noqa: E402
    learn_dynamics,
    learn_quadrotor_residual,
    quadrotor_waypoints,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _at_root(monkeypatch):
    monkeypatch.chdir(ROOT)  # the examples read configs/ relative to the checkout


def test_learn_dynamics_smoke(capsys):
    rc = learn_dynamics.main(["-c", "configs/point_mass1d.yaml", "--transitions", "200",
                              "--fit-steps", "60", "--episode-steps", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "closed loop with the LEARNED model" in out and "ms per step) on cpu" in out


def test_learn_quadrotor_residual_smoke(capsys):
    rc = learn_quadrotor_residual.main(["--transitions", "512", "--fit-steps", "120",
                                        "--loop-steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "hybrid model" in out and "eager backend on cpu" in out
    assert rc in (0, 1)  # 120 fit steps may not beat the analytic model; the pipeline ran


def test_quadrotor_waypoints_smoke(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    rc = quadrotor_waypoints.main(["-o", str(tmp_path / "wp.png"), "--steps", "40",
                                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "waypoints visited" in out and "40 steps, eager backend on cpu" in out
    assert (tmp_path / "wp.png").exists()
    assert rc in (0, 1)  # 40 steps can't finish the tour; the pipeline still runs


def test_quadrotor_waypoints_keeps_the_pack(monkeypatch, capsys):
    """Re-aiming the cost every step (a new cost of the old w, λ and Σ⁻¹)
    packs the fused family once, at the controller's init."""
    from mppi_gpu_tpu_torch.ops import families

    packs = []
    family_for = families.family_for
    monkeypatch.setattr(families, "family_for",
                        lambda *a, **k: packs.append(1) or family_for(*a, **k))
    quadrotor_waypoints.main(["--steps", "5", "--device", "cpu"])
    assert "5 steps" in capsys.readouterr().out and len(packs) == 1
