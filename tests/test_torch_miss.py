"""The port's `miss` harness (``mppi_gpu_tpu_torch.miss``) against the JAX
package's (``mppi_gpu_tpu.miss``) on the CPU, and the port's copies of the
analysis scripts (``mppi_gpu_tpu_torch/scripts/``) on CSVs the port wrote.

Both harnesses draw their excitation with ``numpy.random.default_rng(seed)``,
so the inputs are equal; the MuJoCo plants are the same engine and MJCF in
both packages, so their trajectories are equal; the native plants are one
source built twice (within rtol 1e-6; bit-equal from one compiler); the
torch world and the
model run the same f32 arithmetic as the JAX ones in another order, within
atol 5e-5 over 100 inputs (states up to ~14 in magnitude; the largest gap
measured is 1.2e-5, the cart-pole's model)."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu import miss as jax_miss  # noqa: E402
from mppi_gpu_tpu.config import load_config as load_jax_config  # noqa: E402
from mppi_gpu_tpu_torch import miss  # noqa: E402
from mppi_gpu_tpu_torch.config import load_config  # noqa: E402
from mppi_gpu_tpu_torch.io.csvio import read_csv_columns  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
F32 = dict(rtol=1e-5, atol=5e-5)
# the families run_mismatch_config takes, and the plants the reference has
# for each (the unicycle has no native or MuJoCo plant, the arm no native one)
FAMILIES = {
    "pendulum": ("native", "mujoco"),
    "cartpole": ("native", "mujoco"),
    "quadrotor": ("native", "mujoco"),
    "quadrotor3d": ("native", "mujoco"),
    "arm": ("mujoco",),
    "unicycle": (),
}


def _mujoco_or_skip(plant: str) -> None:
    if plant == "mujoco":
        pytest.importorskip("mujoco")


def _same(got, want, plant: str) -> None:
    assert np.array_equal(got.us, want.us)
    assert got.traj_world.shape == want.traj_world.shape
    if plant == "torch":  # the torch world against the JAX world
        np.testing.assert_allclose(got.traj_world, want.traj_world, **F32)
    elif plant == "native":  # one source, two builds (bit-equal from one compiler)
        np.testing.assert_allclose(got.traj_world, want.traj_world, rtol=1e-6, atol=1e-7)
    else:  # the same MuJoCo library and MJCF in both packages
        assert np.array_equal(got.traj_world, want.traj_world)
    np.testing.assert_allclose(got.traj_model, want.traj_model, **F32)
    assert got.position_rmse == pytest.approx(want.position_rmse, rel=1e-4)


@pytest.mark.parametrize("plant", ["torch", "native", "mujoco"])
def test_run_mismatch_point_mass_equals_the_jax_harness(plant):
    _mujoco_or_skip(plant)
    got = miss.run_mismatch(2, seed=3, world_backend=plant, device="cpu")
    want = jax_miss.run_mismatch(2, seed=3, world_backend="jax" if plant == "torch" else plant)
    assert got.traj_world.shape == (101, 4)
    _same(got, want, plant)


@pytest.mark.parametrize("name,plant", [(f, p) for f, ps in FAMILIES.items()
                                        for p in ("torch", *ps)])
def test_run_mismatch_config_equals_the_jax_harness(name, plant):
    """Every family the JAX ``run_mismatch_config`` takes, on every plant it
    has, 100 inputs."""
    _mujoco_or_skip(plant)
    path = os.path.join(CONFIGS, f"{name}.yaml")
    got = miss.run_mismatch_config(load_config(path), world_backend=plant, device="cpu")
    want = jax_miss.run_mismatch_config(load_jax_config(path),
                                        world_backend="jax" if plant == "torch" else plant)
    assert got.pos_dims == want.pos_dims
    _same(got, want, plant)


@pytest.mark.parametrize("name,plant", [("unicycle", "native"), ("unicycle", "mujoco"),
                                        ("arm", "native")])
def test_missing_plants_are_refused_by_name(name, plant, capsys, tmp_path):
    cfg = load_config(os.path.join(CONFIGS, f"{name}.yaml"))
    with pytest.raises(ValueError, match=name):
        miss.run_mismatch_config(cfg, world_backend=plant, device="cpu")
    rc = miss.main(["-c", os.path.join(CONFIGS, f"{name}.yaml"), "--world", plant,
                    "--device", "cpu", "-o", str(tmp_path / "m.csv")])
    assert rc == 2 and name in capsys.readouterr().err


def test_main_refuses_cuda_without_a_card(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = miss.main(["-n", "5", "-o", str(tmp_path / "m.csv")])
    assert rc == 2 and "CUDA is not available" in capsys.readouterr().err


def test_save_mismatch_csv_writes_the_jax_header(tmp_path):
    for res, jres in (
        (miss.run_mismatch(3, n_steps=5, device="cpu"), jax_miss.run_mismatch(3, n_steps=5)),
        (miss.run_mismatch_config(load_config(os.path.join(CONFIGS, "quadrotor3d.yaml")),
                                  n_steps=5, device="cpu"),
         jax_miss.run_mismatch_config(load_jax_config(os.path.join(CONFIGS, "quadrotor3d.yaml")),
                                      n_steps=5)),
    ):
        miss.save_mismatch_csv(str(tmp_path / "t.csv"), res)
        jax_miss.save_mismatch_csv(str(tmp_path / "j.csv"), jres)
        head = [open(tmp_path / f).readline() for f in ("t.csv", "j.csv")]
        assert head[0] == head[1]
        assert len(open(tmp_path / "t.csv").read().splitlines()) == 7


@pytest.mark.parametrize("name", ["arm", "unicycle"])
def test_main_routes_every_family_to_its_own_model(name, tmp_path, capsys):
    """A fault of the reference, not ported: the JAX `main` sends a config to
    ``run_mismatch_config`` only if its env names the pendulum, the
    cart-pole or a quadrotor, so `-c configs/arm.yaml` and `-c
    configs/unicycle.yaml` measure the point-mass model against the point
    mass world (its CSV is ``run_mismatch(2, dt=cfg.dt)``'s). The port's
    `main` sends every family but the point mass to ``run_mismatch_config``:
    its CSV is the JAX ``run_mismatch_config`` of that config."""
    path = os.path.join(CONFIGS, f"{name}.yaml")
    jcfg = load_jax_config(path)
    out = {k: str(tmp_path / f"{k}.csv") for k in ("port", "jax", "jax_cfg", "jax_pm")}
    assert miss.main(["-c", path, "--device", "cpu", "-o", out["port"]]) == 0
    assert jax_miss.main(["-c", path, "-o", out["jax"]]) == 0
    jax_miss.save_mismatch_csv(out["jax_cfg"], jax_miss.run_mismatch_config(jcfg))
    jax_miss.save_mismatch_csv(out["jax_pm"], jax_miss.run_mismatch(jcfg.action_dim, dt=jcfg.dt))
    capsys.readouterr()
    cols = {k: read_csv_columns(v) for k, v in out.items()}
    assert open(out["jax"]).read() == open(out["jax_pm"]).read()  # the reference's fault
    assert cols["port"].keys() == cols["jax_cfg"].keys()
    for k in cols["port"]:
        np.testing.assert_allclose(cols["port"][k], cols["jax_cfg"][k], **F32, err_msg=k)
    first_w = [next(v for k, v in cols[c].items() if k.endswith("_w")) for c in ("port", "jax_pm")]
    assert not np.allclose(*first_w, atol=1e-3)  # the point mass is another plant


# ---------------------------------------------------------------------------
# the analysis scripts, on CSVs the port wrote (tests/test_scripts.py's cases)

CFG_TEST = os.path.join(CONFIGS, "mppi-config-test.yaml")


def _load_script(name: str):
    path = os.path.join(ROOT, "mppi_gpu_tpu_torch", "scripts", name)
    spec = importlib.util.spec_from_file_location(f"torch_{name[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dump_csv(tmp_path_factory):
    """One step dump of the port's controller (write_step_dump_csv)."""
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.io.csvio import write_step_dump_csv

    ctrl = MPPIController(load_config(CFG_TEST), device="cpu")
    U = ctrl.init_action_seq()
    res, eps, traj = ctrl.solve_debug(torch.zeros(ctrl.cfg.state_dim), U, 0)
    path = tmp_path_factory.mktemp("dumps") / "step_00000.csv"
    write_step_dump_csv(path, traj.numpy(), eps.numpy(), res.info.u_seq.numpy(), U.numpy(),
                        res.info.weights.numpy(), res.info.costs.numpy())
    return str(path)


def test_plot_csv_oracle_passes_on_a_port_dump(dump_csv, tmp_path):
    rc = _load_script("plot_csv.py").main([dump_csv, "-c", CFG_TEST, "-o", str(tmp_path / "o.png")])
    assert rc == 0 and (tmp_path / "o.png").exists()


def test_plot_csv_oracle_fails_on_a_corrupted_dump(dump_csv, tmp_path):
    lines = open(dump_csv).read().splitlines()
    wi = lines[0].split(",").index("w")
    parts = lines[-1].split(",")
    parts[wi] = str(float(parts[wi]) + 0.5)
    lines[-1] = ",".join(parts)
    bad = tmp_path / "bad.csv"
    bad.write_text("\n".join(lines) + "\n")
    rc = _load_script("plot_csv.py").main([str(bad), "-c", CFG_TEST, "-o", str(tmp_path / "o.png")])
    assert rc == 1


def test_plot_traj_on_a_port_trajectory(tmp_path):
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.runner import run_closed_loop

    path = tmp_path / "traj.csv"
    cfg = load_config(os.path.join(CONFIGS, "point_mass2d.yaml")).replace(samples=32, horizon=5)
    run_closed_loop(MPPIController(cfg, device="cpu"), max_steps=10, traj_csv=path)
    rc = _load_script("plot_traj.py").main([str(path), "-c", os.path.join(
        CONFIGS, "point_mass2d.yaml"), "-o", str(tmp_path / "t.png")])
    assert rc == 0 and (tmp_path / "t.png").exists()


@pytest.mark.parametrize("name", ["point_mass", "quadrotor3d"])
def test_plot_miss_on_a_port_mismatch(tmp_path, name):
    res = (miss.run_mismatch(2, n_steps=10, device="cpu") if name == "point_mass" else
           miss.run_mismatch_config(load_config(os.path.join(CONFIGS, "quadrotor3d.yaml")),
                                    n_steps=10, device="cpu"))
    path = tmp_path / "miss.csv"
    miss.save_mismatch_csv(str(path), res)
    rc = _load_script("plot_miss.py").main([str(path), "-o", str(tmp_path / "m.png")])
    assert rc == 0 and (tmp_path / "m.png").exists()


@pytest.mark.parametrize(
    "env,s,a",
    [("point_mass1d", 2, 1), ("point_mass2d", 4, 2), ("point_mass3d", 6, 3),
     ("pendulum", 2, 1), ("cartpole", 4, 1), ("quadrotor", 6, 2),
     ("quadrotor3d", 13, 4), ("unicycle", 3, 2), ("arm", 4, 2)],
)
def test_animate_all_scene_families(tmp_path, env, s, a):
    from mppi_gpu_tpu_torch.io.csvio import write_traj_csv

    path = tmp_path / "traj.csv"
    n = 8
    write_traj_csv(path, np.linspace(0, 1, n),
                   0.3 * np.random.default_rng(2).normal(size=(n, s)),
                   0.3 * np.random.default_rng(3).normal(size=(n, a)))
    out = tmp_path / "ep.gif"
    rc = _load_script("animate.py").main([str(path), "--env", env, "-o", str(out), "--stride",
                                          "2", "--fps", "10"])
    assert rc == 0 and out.exists() and out.stat().st_size > 500


def test_animate_with_config_obstacles(tmp_path):
    from mppi_gpu_tpu_torch.io.csvio import write_traj_csv

    path = tmp_path / "traj.csv"
    n = 6
    write_traj_csv(path, np.linspace(0, 1, n),
                   0.3 * np.random.default_rng(4).normal(size=(n, 4)),
                   0.3 * np.random.default_rng(5).normal(size=(n, 2)))
    out = tmp_path / "ep2.gif"
    rc = _load_script("animate.py").main([str(path), "-c", os.path.join(
        CONFIGS, "point_mass2d.yaml"), "-o", str(out)])
    assert rc == 0 and out.exists()
