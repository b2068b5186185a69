"""Closed-loop CLI (torch counterpart of ``mppi_gpu_tpu.cli``, the
reference's `mppi_gpu` executable, src/main.cu:220-399):

    python -m mppi_gpu_tpu_torch.cli -c configs/point_mass2d.yaml --device cuda -t traj.csv

Flags: `-c` config, `-t` trajectory CSV, `-s` per-step dump dir with
`--dump-every`, `--max-steps`, `-v`, `--seed`, `--rollout-backend` and
`--device`. `--device` defaults to `cuda` and never falls back to the CPU:
without a GPU the run errors unless `--device cpu` is given. The JAX CLI's
other flags are recognised and rejected until they are ported.

Multi-GPU (``parallel/``): `--sharded` shards K over the ranks of torchrun's
process group (``torchrun --nproc-per-node N -m mppi_gpu_tpu_torch.cli ...
--sharded``), or over a world of one without torchrun; `--multihost` joins
the group from `--coordinator HOST:PORT`, `--num-processes` and
`--process-id` (all three, on every process) or from torchrun's
environment. One rank per GPU over NCCL, or per process over gloo with
`--device cpu`. Every rank runs the same closed loop; only the coordinator
(rank 0) writes the trajectory CSV and the dumps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# JAX CLI flags not ported yet (ROADMAP.md, Open items §1 items 4 and 6)
_UNPORTED = (
    ("--jit-episode", dict(action="store_true")),
    ("--world", dict(default=None)),
    ("--checkpoint", dict(default=None)),
    ("--checkpoint-every", dict(type=int, default=50)),
    ("--resume", dict(default=None)),
    ("--view", dict(action="store_true")),
    ("--compile-cache", dict(default=None, nargs="?", const="")),
    ("--profile", dict(default=None)),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mppi_gpu_tpu_torch",
        description="MPPI closed-loop runner (PyTorch + CUDA)",
    )
    p.add_argument("-c", "--config", required=True, help="YAML config file")
    p.add_argument("-t", "--traj", default=None, help="output trajectory CSV")
    p.add_argument(
        "-s", "--step-dump-dir", default=None,
        help="directory for per-step debug dumps (reference to_csv2 analog)",
    )
    p.add_argument("--dump-every", type=int, default=50, help="dump every N steps")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument(
        "--rollout-backend", choices=("auto", "eager", "fused"), default="auto",
        help="fused = the CUDA solve kernels; eager = plain torch; auto picks "
        "fused on a CUDA device",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument(
        "--sharded", action="store_true",
        help="shard K over the ranks: torchrun's process group, or a world of one",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="join a process group (--coordinator, or torchrun's environment), then shard K "
        "over its ranks; run the same command on every process",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="with --multihost: the group's address (requires --num-processes and --process-id)",
    )
    p.add_argument("--num-processes", type=int, default=None, help="with --coordinator")
    p.add_argument("--process-id", type=int, default=None, help="with --coordinator")
    for flag, kw in _UNPORTED:
        p.add_argument(flag, help=argparse.SUPPRESS, **kw)
    return p


def main(argv: list[str] | None = None) -> int:
    from mppi_gpu_tpu_torch.config import ConfigError

    args = build_parser().parse_args(argv)
    for flag, kw in _UNPORTED:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != kw.get("default", False):
            print(
                f"error: {flag} is not ported to mppi_gpu_tpu_torch yet (see ROADMAP.md)",
                file=sys.stderr,
            )
            return 2
    try:
        return _main(args)
    except (FileNotFoundError, ConfigError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(args) -> int:
    import torch

    from mppi_gpu_tpu_torch.config import ConfigError, load_config
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(
            f"error: --device {args.device}: CUDA is not available; "
            "pass --device cpu to run on the CPU",
            file=sys.stderr,
        )
        return 2
    cfg = load_config(args.config)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.coordinator is not None and (args.num_processes is None or args.process_id is None):
        raise ConfigError("--coordinator requires --num-processes and --process-id")
    if args.multihost and args.coordinator is None and "WORLD_SIZE" not in os.environ:
        raise ConfigError(
            "--multihost needs --coordinator, --num-processes and --process-id, or torchrun's "
            "environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)"
        )
    grouped = args.multihost or (args.sharded and "WORLD_SIZE" in os.environ)
    if grouped:
        from mppi_gpu_tpu_torch.parallel import init_multihost, is_coordinator

        rank, world = init_multihost(args.coordinator, args.num_processes, args.process_id,
                                     backend="nccl" if device.type == "cuda" else "gloo")
        print(f"multihost: process {rank}/{world}, world {world}")
        if not is_coordinator():
            # every rank runs the same closed loop; the coordinator owns the files
            args.traj = args.step_dump_dir = None
    try:
        if args.sharded or args.multihost:
            from mppi_gpu_tpu_torch.parallel import ShardedMPPIController
            from mppi_gpu_tpu_torch.parallel.mesh import make_mesh

            # bare "cuda": this rank's GPU, cuda:LOCAL_RANK
            mesh = make_mesh(None if device.type == "cuda" and device.index is None else device)
            ctrl = ShardedMPPIController(cfg, mesh=mesh, rollout_backend=args.rollout_backend)
        else:
            ctrl = MPPIController(cfg, device=device, rollout_backend=args.rollout_backend)
        if args.step_dump_dir:
            os.makedirs(args.step_dump_dir, exist_ok=True)
        return _run(args, ctrl)
    except ControllerDiverged as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    finally:
        if grouped:
            from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost

            shutdown_multihost()


def _run(args, ctrl) -> int:
    from mppi_gpu_tpu_torch.runner import run_closed_loop

    result = run_closed_loop(
        ctrl,
        max_steps=args.max_steps,
        traj_csv=args.traj,
        step_dump_every=args.dump_every if args.step_dump_dir else None,
        step_dump_dir=args.step_dump_dir,
        verbose=args.verbose,
    )
    print(f"episode finished: {len(result.us)} control steps")
    print(f"final state: {result.final_state}")
    if "mean_ms" in result.solve_ms:
        # the reference's closing metric (src/main.cu:376-379): warm mean;
        # the first solve (kernel build and load) is reported separately
        print(
            f"Average controller execution time: "
            f"{result.solve_ms['mean_ms']:.3f} ms"
            + (
                f" (warm; first call: "
                f"{result.solve_ms['first_ms'] / 1e3:.3f} s)"
                if "first_ms" in result.solve_ms else ""
            )
        )
        print(
            f"note: per-step time on {ctrl.device} ({ctrl.rollout_backend} backend) "
            "includes the host<->device copies of the state and the action"
        )
        print(json.dumps(result.solve_ms))
    if args.traj:
        print(f"trajectory written to {args.traj}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
