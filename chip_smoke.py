#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mppi_gpu_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``mppi_gpu_tpu_torch/csrc``, holds each one
against its plain PyTorch version and the float64 NumPy oracle, times them,
and drives the port's main path — ``MPPIController`` and the closed-loop CLI
— on the card. Every phase prints one line (or a few); any failure raises
and the script exits non-zero without the final line. Without a CUDA device
it exits 1 at once. The last two lines are a JSON object describing every
kernel (route, source, the TPU kernel it replaces, launches on the main path,
max abs error against its plain version, ms on the card next to the plain
version's) and ``{"ok": true, "device": {...}}``.

The ``check_*`` functions are also called by the GPU tests
(``tests/test_torch_fused.py``) at small shapes.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SOURCE = "mppi_gpu_tpu_torch/csrc/mppi_lti.cu"
PALLAS = "mppi_gpu_tpu/ops/pallas_rollout.py"
# steady-state goal-distance tripwire of the lti family (bench.QUALITY_THRESHOLDS)
LTI_QUALITY_THRESHOLD_M = 0.35
# tolerances of tests/test_parity_scale.py at K=10⁴, T=200
TOL = dict(
    S_rel=2e-4, beta=1e-6, eta=2e-3, u=dict(rtol=1e-4, atol=2e-5),
    dU=dict(rtol=2e-3, atol=2e-5),
)


class SmokeFailure(AssertionError):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def close(name: str, got, want, rtol: float, atol: float = 0.0) -> float:
    """Assert |got − want| ≤ atol + rtol·|want| elementwise (inf == inf);
    returns the max abs error over the finite entries."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    expect(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
    expect(
        np.array_equal(np.isfinite(got), np.isfinite(want))
        and np.array_equal(got[~np.isfinite(want)], want[~np.isfinite(want)], equal_nan=True),
        f"{name}: non-finite entries differ",
    )
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    bad = err > atol + rtol * np.abs(want[fin])
    expect(
        not bad.any(),
        f"{name}: {int(bad.sum())} entries outside rtol={rtol} atol={atol}, "
        f"max abs err {err.max() if err.size else 0.0:.3g}",
    )
    return float(err.max()) if err.size else 0.0


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _oracle():
    """tests/oracle.py (float64 NumPy), loaded by path: a `tests` package
    installed elsewhere may shadow the checkout's."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "oracle.py")
    spec = importlib.util.spec_from_file_location("mppi_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v output:
    registers and spill bytes."""
    out, name = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?(lti_solve_partials|softmin_combine|noise_dump)"
                      r"_kernel(?:ILi(\d)E(?:Lb(\d)E)?)?", line)
        if m:
            name = m.group(1) + (f"<A={m.group(2)}" + (f",inj={m.group(3)}" if m.group(3) else "") + ">"
                                 if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spill stores")
    return out


# ---------------------------------------------------------------------------
# problem set-up


def make_problem(A: int, K: int, T: int, seed: int = 0, device: str = "cuda") -> dict:
    """Point-mass problem at the config widths (point_mass2d/3d weights and
    goals), a live nominal sequence, and injected noise, all from `seed`."""
    import torch

    rng = np.random.default_rng(seed)
    w = np.array([1.0] * A + ([50.0] * A if A == 2 else [5.0] * A), np.float32)
    goal = np.array([1.0, 0.5, 0.75, 0.25][:A] + [0.0] * A, np.float32)
    x0 = np.concatenate([rng.uniform(-0.2, 0.2, A), rng.uniform(-0.1, 0.1, A)]).astype(np.float32)
    U = (0.2 * np.sin(0.05 * np.arange(T * A))).reshape(T, A).astype(np.float32)
    sigma = np.full(A, 0.25, np.float32)
    eps = (rng.standard_normal((T, K, A)) * sigma).astype(np.float32)
    np_arrays = dict(x0=x0, U=U, sigma=sigma, inv_s=np.ones(A, np.float32), w=w, goal=goal, eps=eps)
    p = {k: torch.as_tensor(v, device=device) for k, v in np_arrays.items()}
    p.update(np=np_arrays, A=A, K=K, T=T, dt=0.1, lam_cost=1.0, lam=1.0,
             max_a=torch.ones(A, device=device))
    return p


def solve_args(p: dict, *, seed=7, step=3, it=0, antithetic=False, ou_beta=0.0, eps=None):
    return (
        p["x0"], p["U"], p["sigma"], p["inv_s"], p["w"], p["goal"], p["lam_cost"],
        p["lam"], p["dt"], p["K"], seed, step, it, antithetic, ou_beta, eps,
    )


def finish(p: dict, S, beta, eta, dU):
    """The controller's tail (update, clamp, shift) on a solve core."""
    import torch

    from mppi_gpu_tpu_torch.controller import _finish

    weights = torch.exp(-(S - beta) / p["lam"]) / eta
    return _finish(p["U"], dU, S, beta, eta, weights, p["max_a"], True)


def compare_solves(name: str, p: dict, got, want, *, S_rtol: float) -> dict:
    """Solve cores (S, β, η, ΔU) and their controller results, within TOL."""
    rg, rw = finish(p, *got), finish(p, *want)
    errs = dict(
        S=close(f"{name} S", _np(got[0]), _np(want[0]), S_rtol),
        beta=close(f"{name} beta", _np(got[1]), _np(want[1]), TOL["beta"]),
        eta=close(f"{name} eta", _np(got[2]), _np(want[2]), TOL["eta"]),
        dU=close(f"{name} dU", _np(got[3]), _np(want[3]), **TOL["dU"]),
    )
    errs["action"] = close(f"{name} action", _np(rg.action), _np(rw.action), **TOL["u"])
    errs["u_next"] = close(f"{name} u_next", _np(rg.u_next), _np(rw.u_next), **TOL["u"])
    return errs


# ---------------------------------------------------------------------------
# checks (also called by tests/test_torch_fused.py on the card)


def check_injected(A: int, K: int, T: int, device: str = "cuda") -> dict:
    """K1 + K2 in the injected-ε mode against the plain version on the card
    and against the float64 oracle (tests/oracle.py)."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    oracle_solve = _oracle().oracle_solve
    p = make_problem(A, K, T, device=device)
    got = fs.fused_solve(*solve_args(p, eps=p["eps"]))
    want = fs.fused_solve_reference(*solve_args(p, eps=p["eps"]))
    errs = compare_solves(f"injected A={A} K={K} T={T} vs plain", p, got, want, S_rtol=1e-5)
    n = p["np"]
    S_o, _, action_o, shift_o, _, beta_o, eta_o = oracle_solve(
        n["x0"], n["U"], n["eps"], p["dt"], n["w"], n["goal"], p["lam_cost"], n["inv_s"],
        max_a=np.ones(A),
    )
    name = f"injected A={A} K={K} T={T} vs oracle"
    rel = np.abs(_np(got[0]) - S_o) / np.abs(S_o)
    expect(rel.max() < TOL["S_rel"], f"{name}: worst S relative error {rel.max():.2e}")
    close(f"{name} beta", _np(got[1]), beta_o, TOL["beta"])
    close(f"{name} eta", _np(got[2]), eta_o, TOL["eta"])
    res = finish(p, *got)
    close(f"{name} action", _np(res.action), action_o, **TOL["u"])
    close(f"{name} u_next", _np(res.u_next), shift_o, **TOL["u"])
    return errs


def check_kernels(A: int, K: int, T: int, *, antithetic=False, ou_beta=0.0,
                  device: str = "cuda") -> dict:
    """Philox mode, kernel by kernel on the same inputs: K1 against its plain
    version, K2 against its plain version on K1's partials, and the whole
    solve against the plain solve. Returns max abs errors per kernel."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    p = make_problem(A, K, T, device=device)
    args = solve_args(p, antithetic=antithetic, ou_beta=ou_beta)
    name = f"philox A={A} K={K} T={T} anti={antithetic} ou={ou_beta}"
    S, part = fs.lti_solve_partials(*args)
    S_r, part_r = fs.lti_solve_partials_reference(*args)
    e1 = close(f"{name} K1 S", _np(S), _np(S_r), 1e-5)
    close(f"{name} K1 beta_b", _np(part[:, 0]), _np(part_r[:, 0]), 1e-5)
    close(f"{name} K1 eta_b", _np(part[:, 1]), _np(part_r[:, 1]), TOL["eta"])
    scale = float(part_r[:, 2:].abs().max())
    close(f"{name} K1 dU_b", _np(part[:, 2:]), _np(part_r[:, 2:]), TOL["dU"]["rtol"],
          TOL["dU"]["atol"] * max(scale, 1.0))
    b, e, dU = fs.softmin_combine(part, p["lam"], T, A)
    b_r, e_r, dU_r = fs.softmin_combine_reference(part, p["lam"], T, A)
    close(f"{name} K2 beta", _np(b), _np(b_r), 1e-7)
    close(f"{name} K2 eta", _np(e), _np(e_r), 1e-5)
    e2 = close(f"{name} K2 dU", _np(dU), _np(dU_r), 1e-4, 1e-6)
    compare_solves(name, p, fs.fused_solve(*args), fs.fused_solve_reference(*args), S_rtol=1e-5)
    return dict(lti_solve_partials=e1, softmin_combine=e2)


def check_dump_replay(A: int, K: int, T: int, *, antithetic=False, ou_beta=0.0,
                      device: str = "cuda") -> dict:
    """K3's words equal ops/philox.py's bit for bit; its ε equals the plain
    stream on the card; the injected-ε solve on the dump equals the
    Philox-mode solve exactly (replay)."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    p = make_problem(A, K, T, device=device)
    seed, step, it = 11, 5, 1
    name = f"dump A={A} K={K} T={T} anti={antithetic} ou={ou_beta}"
    eps, words = fs.noise_dump(p["sigma"], T, K, seed, step, it, antithetic, ou_beta, words=True)
    K_draw = K // 2 if antithetic else K
    words_r = philox.philox_words(seed, step, it, T, K_draw, p["sigma"].device)
    expect(torch.equal(words, words_r), f"{name}: Philox words differ from ops/philox.py")
    eps_r = philox.sample_eps(seed, step, it, T, K, p["sigma"], antithetic=antithetic, ou_beta=ou_beta)
    err = close(f"{name} eps", _np(eps), _np(eps_r), 1e-6, 1e-6)
    bit_equal = bool(torch.equal(eps.view(torch.int32), eps_r.view(torch.int32)))
    args = dict(seed=seed, step=step, it=it, antithetic=antithetic, ou_beta=ou_beta)
    live = fs.fused_solve(*solve_args(p, **args))
    replay = fs.fused_solve(*solve_args(p, **args, eps=eps))
    for label, a, b in zip(("S", "beta", "eta", "dU"), live, replay):
        expect(torch.equal(a, b), f"{name}: replay {label} differs from the Philox-mode solve")
    return dict(noise_dump=err, eps_bit_identical=bit_equal)


def check_edge_cases(device: str = "cuda") -> None:
    """K not a multiple of the block; one block of diverged rollouts among
    finite ones; every rollout diverged (NaN action, guard fires)."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    check_kernels(3, 1000, 50, device=device)
    p = make_problem(2, 1000, 50, device=device)
    eps = p["eps"].clone()
    eps[:, fs.BLOCK:2 * fs.BLOCK, :] = 1e30  # block 1 diverges: S = +inf
    got = fs.fused_solve(*solve_args(p, eps=eps))
    want = fs.fused_solve_reference(*solve_args(p, eps=eps))
    compare_solves("one diverged block", p, got, want, S_rtol=1e-5)
    S = _np(got[0])
    expect(np.isinf(S[fs.BLOCK:2 * fs.BLOCK]).all() and np.isfinite(np.delete(S, np.s_[fs.BLOCK:2 * fs.BLOCK])).all(),
           "one diverged block: expected +inf exactly on block 1")
    res = finish(p, *got)
    expect(bool((res.info.weights[fs.BLOCK:2 * fs.BLOCK] == 0).all()), "diverged rollouts got weight")
    expect(bool(torch.isfinite(res.action).all()), "one diverged block: action not finite")

    cfg = _config("point_mass3d").replace(samples=1000, cost_w=(1e38,) * 6)
    ctrl = MPPIController(cfg, device=device)
    expect(ctrl.rollout_backend == ("fused" if ctrl.device.type == "cuda" else "eager"),
           f"auto picked the {ctrl.rollout_backend} backend on {device}")
    res = ctrl.solve_auto(torch.zeros(6), ctrl.init_action_seq(), 0)
    action = _np(res.action)
    expect(np.isnan(action).all(), f"all diverged: action {action} is not NaN")
    try:
        check_solve(0, action, res.info.cpu())
    except ControllerDiverged:
        return
    raise SmokeFailure("all diverged: check_solve did not raise ControllerDiverged")


# ---------------------------------------------------------------------------
# timing


def time_ms(fn, reps: int, warmup: int = 2) -> list[float]:
    """Per-call ms by CUDA events around each call, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def paired_median_ms(kernel_fn, plain_fn, reps: int, plain_reps: int) -> tuple[float, float]:
    """Median ms of both, measured in turns (plain, kernel, kernel, plain)."""
    k, pl = [], []
    for _ in range(2):
        pl += time_ms(plain_fn, plain_reps)
        k += time_ms(kernel_fn, reps)
        k += time_ms(kernel_fn, reps)
        pl += time_ms(plain_fn, plain_reps)
    return float(np.median(k)), float(np.median(pl))


# ---------------------------------------------------------------------------
# main


def _config(name: str):
    from mppi_gpu_tpu_torch.config import load_config

    return load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", f"{name}.yaml"))


def _cli(argv: list[str]) -> str:
    from mppi_gpu_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("\n".join("    " + line for line in out.strip().splitlines()))
    expect(rc == 0, f"cli {' '.join(argv)} exited {rc}")
    expect("episode finished" in out, f"cli {' '.join(argv)}: no 'episode finished'")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns
    from mppi_gpu_tpu_torch.ops import _build, philox
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    # [1] device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")

    # [2] build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"[2] build: {build_s:.2f} s -> {lib_path.name}")
    for line in ptxas_summary(lib_path.with_suffix(".log").read_text()):
        print(f"    ptxas {line}")

    # [3] injected ε vs plain and oracle
    err = {k.__name__: 0.0 for k in fs.KERNELS}
    for A, K, T in ((2, 3000, 50), (3, 10_000, 200)):
        e = check_injected(A, K, T)
        print(f"[3] injected A={A} K={K} T={T}: ok vs plain and oracle; max abs err "
              + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))

    # [4] Philox mode, kernel by kernel; dump and replay
    for A, K, T, anti, ou in ((3, 10_000, 200, False, 0.0), (3, 10_000, 200, True, 0.0),
                              (2, 3000, 50, False, 0.5)):
        e = check_kernels(A, K, T, antithetic=anti, ou_beta=ou)
        d = check_dump_replay(A, K, T, antithetic=anti, ou_beta=ou)
        for k in e:
            err[k] = max(err[k], e[k])
        err["noise_dump"] = max(err["noise_dump"], d["noise_dump"])
        print(f"[4] philox A={A} K={K} T={T} anti={anti} ou={ou}: K1 S err {e['lti_solve_partials']:.3g}, "
              f"K2 dU err {e['softmin_combine']:.3g}; dump words bit-exact, eps err "
              f"{d['noise_dump']:.3g} (bit-identical: {d['eps_bit_identical']}); replay exact")

    # [5] edge cases
    check_edge_cases()
    print("[5] edges: K=1000 ok; one diverged block matches plain, weight 0; "
          "all diverged -> NaN action, ControllerDiverged")

    # [6] controller on point_mass3d (and the point_mass2d shape): kernel vs plain
    timing = {}
    for cfg_name, K, T in (("point_mass2d", 3000, 50), ("point_mass3d", 10_000, 200),
                           ("point_mass3d", 100_000, 200)):
        cfg = _config(cfg_name).replace(samples=K, horizon=T)
        ctrl = MPPIController(cfg, device="cuda", rollout_backend="auto")
        plain = MPPIController(cfg, device="cuda", rollout_backend="eager")
        expect(ctrl.rollout_backend == "fused", f"auto picked {ctrl.rollout_backend} on cuda")
        x = torch.zeros(cfg.state_dim, device="cuda")
        U = ctrl.init_action_seq()
        before = fs.lti_solve_partials.launches
        k_ms, p_ms = paired_median_ms(
            lambda: ctrl.solve_auto(x, U, 1), lambda: plain.solve_auto(x, U, 1),
            reps=20, plain_reps=3 if K >= 100_000 else 5,
        )
        expect(fs.lti_solve_partials.launches > before, "K1 launch count did not go up")
        a_k, a_p = _np(ctrl.solve_auto(x, U, 1).action), _np(plain.solve_auto(x, U, 1).action)
        close(f"controller {cfg_name} K={K} action", a_k, a_p, **TOL["u"])
        timing[f"{cfg_name} K={K} T={T}"] = (k_ms, p_ms)
        print(f"[6] MPPIController {cfg_name} A={cfg.action_dim} K={K} T={T}: fused {k_ms:.4f} "
              f"ms/solve, eager {p_ms:.4f} ms/solve (CUDA events, warm median; {smi})")

    # per-kernel times at the flagship shape (point_mass3d, K=10⁴, T=200)
    p = make_problem(3, 10_000, 200)
    args = solve_args(p)
    _, part = fs.lti_solve_partials(*args)
    kernel_ms = {
        "lti_solve_partials": paired_median_ms(
            lambda: fs.lti_solve_partials(*args), lambda: fs.lti_solve_partials_reference(*args), 20, 3),
        "softmin_combine": paired_median_ms(
            lambda: fs.softmin_combine(part, 1.0, 200, 3),
            lambda: fs.softmin_combine_reference(part, 1.0, 200, 3), 20, 20),
        "noise_dump": paired_median_ms(
            lambda: fs.noise_dump(p["sigma"], 200, 10_000, 7, 3, 0, False, 0.0),
            lambda: philox.sample_eps(7, 3, 0, 200, 10_000, p["sigma"]), 20, 3),
    }
    for name, (k_ms, p_ms) in kernel_ms.items():
        print(f"[6] kernel {name} A=3 K=10000 T=200: {k_ms:.4f} ms, plain {p_ms:.4f} ms ({smi})")

    # [7] the main path: the closed-loop CLI, launches counted
    fs.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        _cli(["-c", os.path.join("configs", "point_mass2d.yaml"), "--device", "cuda",
              "-t", os.path.join(tmp, "traj2d.csv"), "-s", os.path.join(tmp, "dump"),
              "--dump-every", "100"])
        traj = os.path.join(tmp, "traj3d.csv")
        _cli(["-c", os.path.join("configs", "point_mass3d.yaml"), "--device", "cuda", "-t", traj])
        cols = read_csv_columns(traj)
    launches = fs.launch_counts()
    cfg3 = _config("point_mass3d")
    xs = np.stack([np.concatenate([[0.0], cols[f"x[{i}]"]]) for i in range(3)], axis=1)
    d = np.linalg.norm(xs - np.asarray(cfg3.goal[:3]), axis=1)
    steady = float(d[-max(len(d) // 4, 1):].mean())
    print(f"[7] cli closed loop: point_mass2d and point_mass3d episodes finished; point_mass3d "
          f"steady-state goal distance {steady:.4f} m (threshold {LTI_QUALITY_THRESHOLD_M}); "
          f"main-path launches {launches}")
    expect(steady < LTI_QUALITY_THRESHOLD_M, f"point_mass3d steady-state {steady} m")
    for name, n in launches.items():
        expect(n > 0, f"kernel {name} was not launched on the main path")

    replaces = {
        "lti_solve_partials": f"{PALLAS}:2342",
        "softmin_combine": f"{PALLAS}:1847",
        "noise_dump": f"{PALLAS}:2140",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": err[name],
         "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1]}
        for name in replaces
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
