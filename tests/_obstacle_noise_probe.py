"""Where the obstacle quality episode's clearance comes from: the controller
or the noise stream. CPU only; imports both packages.

The episode is bench._quality_cfg("obstacle") (point_mass3d, K=2048, T=50,
two spheres inflated by bench.QUALITY_OBSTACLE_MARGIN), run for the world's
whole episode (``num_control_steps()`` cycles, as ``run_episode_jit``). For
each seed and each of two noise streams,

* ``threefry``: the JAX package's own ε, ``controller.sample_noise`` under
  ``fold_in(jax.random.key(seed), step)`` (the stream ``run_episode_jit``'s
  scan solve draws),
* ``philox``: the port's own ε, ``mppi_gpu_tpu_torch.controller.sample_noise``
  for (seed, step, it=0) (the stream its eager and fused solves draw),

both controllers, the JAX one (scan backend) and the port's eager one, are
fed that same ε at every update through ``solve_with_eps``, each driving its
own world. A seed's episode is scored as ``bench.quality_row`` scores it:
steady distance (mean of the last quarter) and the least clearance to the
TRUE spheres. With ``--jax-row`` each seed also runs ``bench.quality_row``
itself, the reference's own whole-episode jit.

If the two controllers, fed one stream, clear in about as many seeds as each
other, a difference between the packages' own runs is the stream's, not the
port's code; if one controller clears more often on every stream, it is the
controller's.

Run:  python tests/_obstacle_noise_probe.py [--seeds 16] [--first-seed 0]
      [--workers 4] [--jax-row | --jax-row-only] [--out FILE.json]
(~20 s per port episode and ~5 s per JAX episode on one CPU core each.)
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = ("threefry", "philox")


def _episode(seed: int, stream: str) -> dict:
    """Both controllers on one stream for one seed: their clearances, steady
    distances, and the first cycle at which their states part by > 1e-3."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                                       "intra_op_parallelism_threads=1")
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import bench
    from mppi_gpu_tpu import controller as jctl
    from mppi_gpu_tpu.envs import make_jax_world, params_for_config
    from mppi_gpu_tpu_torch.config import MPPIConfig
    from mppi_gpu_tpu_torch.controller import MPPIController, sample_noise
    from mppi_gpu_tpu_torch.envs import make_world

    torch.set_num_threads(1)
    jcfg = bench._quality_cfg("obstacle").replace(seed=seed)
    fields = {f: getattr(jcfg, f) for f in MPPIConfig.__dataclass_fields__}
    tcfg = MPPIConfig(**fields)
    jc = jctl.MPPIController(jcfg, rollout_backend="scan")
    tc = MPPIController(tcfg, device="cpu")
    params = params_for_config(jcfg)
    n = params.num_control_steps()
    jworld, tworld = make_jax_world(jcfg), make_world(tcfg)
    jsim = jax.jit(jworld.simulate)
    key = jc.init_key()
    T, K, A = jcfg.horizon, jcfg.samples, jcfg.action_dim
    draw = jax.jit(lambda k: jctl.sample_noise(k, T, K, A, jc.sigma))
    js, ts = jworld.reset(), tworld.reset()
    jU, tU = jc.init_action_seq(), tc.init_action_seq()
    jxs, txs = [np.asarray(js.x)], [ts.x.numpy()]
    parted = None
    t0 = time.perf_counter()
    for step in range(n):
        if stream == "threefry":
            eps = np.asarray(draw(jax.random.fold_in(key, step)))
        else:
            eps = sample_noise(seed, step, 0, T, K, tc.sigma).numpy()
        rj = jc.solve_with_eps(js.x, jU, jnp.asarray(eps))
        rt = tc.solve_with_eps(ts.x, tU, torch.tensor(eps))
        jU, tU = rj.u_next, rt.u_next
        js, _ = jsim(js, rj.action)
        ts, _ = tworld.simulate(ts, rt.action)
        jxs.append(np.asarray(js.x))
        txs.append(ts.x.numpy())
        if parted is None and np.abs(jxs[-1] - txs[-1]).max() > 1e-3:
            parted = step
    goal = np.asarray(jcfg.goal[:3], np.float64)

    def score(xs) -> dict:
        xs = np.asarray(xs, np.float64)
        d = np.linalg.norm(xs[:, :3] - goal, axis=1)
        clear = min(float((np.linalg.norm(xs[:, :3] - np.asarray(ob[:3]), axis=1)
                           - (ob[3] - bench.QUALITY_OBSTACLE_MARGIN)).min())
                    for ob in jcfg.obstacles)
        return {"clear": clear, "steady": float(d[-max(len(d) // 4, 1):].mean())}

    return {"seed": seed, "stream": stream, "steps": n, "jax": score(jxs), "port": score(txs),
            "parted_at": parted, "s": time.perf_counter() - t0}


def _jax_row(seed: int) -> dict:
    """bench.quality_row("obstacle", backend="scan", seed=seed): the
    reference's own whole-episode jit and scoring."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                                       "intra_op_parallelism_threads=1")
    sys.path.insert(0, ROOT)
    import bench

    row = bench.quality_row("obstacle", backend="scan", seed=seed)
    return {"seed": seed, "stream": "jax_row", "clear": row["min_clearance"],
            "steady": row["steady"]}


def _job(job: tuple[int, str]) -> dict:
    seed, kind = job
    return _jax_row(seed) if kind == "jax_row" else _episode(seed, kind)


def _rate(clear: list[float]) -> dict:
    c = sorted(clear)
    return {"n_clear": sum(x > 0 for x in c), "n": len(c), "median_clear": c[len(c) // 2]}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, default=16)
    p.add_argument("--first-seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--jax-row", action="store_true",
                   help="also run bench.quality_row per seed (the reference's own loop)")
    p.add_argument("--jax-row-only", action="store_true",
                   help="run only bench.quality_row per seed: the reference's clearance rate")
    p.add_argument("--out", default=None, help="write every episode's scores here (JSON)")
    args = p.parse_args(argv)
    streams = () if args.jax_row_only else STREAMS
    seeds = range(args.first_seed, args.first_seed + args.seeds)
    jobs = [(s, stream) for s in seeds for stream in streams]
    if args.jax_row or args.jax_row_only:
        jobs += [(s, "jax_row") for s in seeds]
    with mp.get_context("spawn").Pool(args.workers) as pool:
        rows = pool.map(_job, jobs, chunksize=1)
    for r in rows:
        if r["stream"] == "jax_row":
            print(f"seed {r['seed']:2d} jax_row  clear {r['clear']:+.4f} steady {r['steady']:.4f}")
            continue
        print(f"seed {r['seed']:2d} {r['stream']:8s} jax clear {r['jax']['clear']:+.4f} steady "
              f"{r['jax']['steady']:.4f} | port clear {r['port']['clear']:+.4f} steady "
              f"{r['port']['steady']:.4f} | parted at {r['parted_at']}")
    summary = {f"{who}/{stream}": _rate([r[who]["clear"] for r in rows if r["stream"] == stream])
               for stream in streams for who in ("jax", "port")}
    if args.jax_row or args.jax_row_only:
        summary["jax_row"] = _rate([r["clear"] for r in rows if r["stream"] == "jax_row"])
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "episodes": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
