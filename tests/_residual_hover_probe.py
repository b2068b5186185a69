"""Where the residual 3-D quadrotor example's closed-loop hover ends, in
both packages, on the CPU: the pipeline of ``examples/learn_quadrotor_residual.py``
(the JAX package's) and of ``mppi_gpu_tpu_torch/examples/learn_quadrotor_residual.py``
(the port's), each with its own seeded transitions and net (the examples'
fixed seeds), then the hybrid-model hover at the config's seed + s for s in
0 … seeds − 1 (s = 0 is the example's own run), at the sizes given.
Imports both packages.

Run:  python tests/_residual_hover_probe.py [--sizes 16384:4000:120,8192:2000:60]
      [--seeds 4] [--packages jax,torch] [--workers 6] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import multiprocessing as mp
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hover(job: tuple[str, int, int, int, int]) -> dict:
    pkg, transitions, fit_steps, loop_steps, s = job
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                                       "intra_op_parallelism_threads=1")
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import numpy as np

    t0 = time.perf_counter()
    if pkg == "jax":
        import dataclasses

        import jax
        import jax.numpy as jnp

        spec = importlib.util.spec_from_file_location(
            "jax_residual", os.path.join(ROOT, "examples", "learn_quadrotor_residual.py"))
        ex = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ex)
        cfg = ex.load_config("configs/quadrotor3d.yaml")
        base = ex.dynamics_for_config(cfg)
        xs, us, xn = ex.collect_transitions(cfg, transitions)
        n_tr = transitions * 3 // 4
        train = (xs[:n_tr], us[:n_tr], xn[:n_tr])
        mlp = ex.init_mlp_dynamics(jax.random.key(1), cfg.state_dim, cfg.action_dim,
                                   hidden=(128, 128))
        inputs = jnp.concatenate([train[0], train[1]], axis=1)
        mlp = dataclasses.replace(mlp, in_shift=jnp.mean(inputs, axis=0),
                                  in_scale=1.0 / (jnp.std(inputs, axis=0) + 1e-6))
        hybrid = ex.HybridResidualDynamics(base=base, mlp=mlp, unit_norm_slice=(3, 7))
        hybrid, _ = ex.fit_residual_dynamics(hybrid, train, lr=3e-3, steps=fit_steps,
                                             whiten=False)
        ctrl = ex.MPPIController(cfg.replace(seed=cfg.seed + s), dynamics=hybrid)
        res = ex.run_closed_loop(ctrl, max_steps=loop_steps)
    else:
        import torch

        torch.set_num_threads(1)
        from mppi_gpu_tpu_torch.examples import learn_quadrotor_residual as ex
        from mppi_gpu_tpu_torch.models.neural import MLPDynamics

        cfg = ex.load_config("configs/quadrotor3d.yaml")
        base = ex.dynamics_for_config(cfg, "cpu")
        xs, us, xn = ex.collect_transitions(cfg, transitions)
        n_tr = transitions * 3 // 4
        train = (xs[:n_tr], us[:n_tr], xn[:n_tr])
        mlp = ex.init_mlp_dynamics(cfg.state_dim, cfg.action_dim, hidden=(128, 128),
                                   generator=torch.Generator().manual_seed(1), device="cpu")
        inputs = torch.cat([train[0], train[1]], dim=1)
        mlp = MLPDynamics(mlp.weights, mlp.biases, mlp.residual_scale, torch.mean(inputs, dim=0),
                          1.0 / (torch.std(inputs, dim=0, correction=0) + 1e-6))
        hybrid = ex.HybridResidualDynamics(base, mlp, unit_norm_slice=(3, 7))
        hybrid, _ = ex.fit_residual_dynamics(hybrid, train, lr=3e-3, steps=fit_steps,
                                             whiten=False)
        ctrl = ex.MPPIController(cfg.replace(seed=cfg.seed + s), device="cpu", dynamics=hybrid)
        res = ex.run_closed_loop(ctrl, max_steps=loop_steps)
    d = float(np.linalg.norm(np.asarray(res.xs[-1])[:3] - np.asarray(cfg.goal[:3])))
    return dict(package=pkg, transitions=transitions, fit_steps=fit_steps,
                loop_steps=loop_steps, seed=cfg.seed + s, distance=d,
                seconds=round(time.perf_counter() - t0, 1))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", default="16384:4000:120,8192:2000:60",
                   help="transitions:fit-steps:loop-steps, comma-separated")
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--packages", default="jax,torch")
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sizes = [tuple(int(v) for v in sz.split(":")) for sz in args.sizes.split(",")]
    jobs = [(k, *sz, s) for sz in sizes for k in args.packages.split(",")
            for s in range(args.seeds)]
    with mp.get_context("spawn").Pool(args.workers) as pool:
        rows = pool.map(_hover, jobs, chunksize=1)
    for r in rows:
        print(f"{r['package']:5s} --transitions {r['transitions']} --fit-steps {r['fit_steps']} "
              f"--loop-steps {r['loop_steps']} seed {r['seed']}: distance to goal "
              f"{r['distance']:.3f} m ({r['seconds']} s)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
