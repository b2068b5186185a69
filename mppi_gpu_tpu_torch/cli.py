"""Closed-loop CLI (torch counterpart of ``mppi_gpu_tpu.cli``, the
reference's `mppi_gpu` executable, src/main.cu:220-399):

    python -m mppi_gpu_tpu_torch.cli -c configs/point_mass2d.yaml --device cuda -t traj.csv

Flags: `-c` config, `-t` trajectory CSV, `-s` per-step dump dir with
`--dump-every`, `--max-steps`, `-v`, `--seed`, `--rollout-backend` and
`--device`. `--device` defaults to `cuda` and never falls back to the CPU:
without a GPU the run errors unless `--device cpu` is given.
On a CUDA device the host loop's every solve replays one CUDA graph of it
(``MPPIController.solve``). `--jit-episode` runs the whole episode on the
device (``runner.run_episode_jit``: one control cycle captured as a CUDA
graph and replayed; a loop on the CPU), with `--sharded` or `--multihost`
too. `--checkpoint PATH` with `--checkpoint-every N` writes the loop state
every N steps and `--resume PATH` goes on from it, bit for bit as the
uninterrupted run. `--profile DIR` writes a torch.profiler trace of the run
into DIR. `--world` picks the host loop's plant, `--view` opens MuJoCo's
viewer and `--compile-cache DIR` moves the kernel builds.

Multi-GPU (``parallel/``): `--sharded` shards K over the ranks of torchrun's
process group (``torchrun --nproc-per-node N -m mppi_gpu_tpu_torch.cli ...
--sharded``), or over a world of one without torchrun; `--multihost` joins
the group from `--coordinator HOST:PORT`, `--num-processes` and
`--process-id` (all three, on every process) or from torchrun's
environment. One rank per GPU over NCCL, or per process over gloo with
`--device cpu`. Every rank runs the same closed loop, or the same device
episode; only the coordinator (rank 0) writes the trajectory CSV, the dumps
and the profiler trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    p.add_argument(
        "--jit-episode", action="store_true",
        help="run the whole episode on the device: one control cycle captured as a CUDA "
        "graph and replayed (a loop on the CPU)",
    )
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", default=None, help="resume from checkpoint .npz")
    p.add_argument("--profile", default=None, help="torch.profiler trace dir")
    p.add_argument(
        "--world", choices=("torch", "native", "mujoco"), default="torch",
        help="the host loop's plant: the torch world, the native C++ twin, or real MuJoCo "
        "(mj_step; needs the optional mujoco package)",
    )
    p.add_argument(
        "--view", action="store_true",
        help="live interactive MuJoCo viewer (needs --world mujoco and a display)",
    )
    p.add_argument(
        "--compile-cache", default=None, metavar="DIR",
        help="build the CUDA kernel libraries and the native world library into DIR "
        "(default: build/mppi_gpu_tpu_torch/ under the checkout)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _main(args)
    except (FileNotFoundError, NotImplementedError, ValueError) as e:  # ConfigError is one
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
    if args.compile_cache is not None:
        from mppi_gpu_tpu_torch.ops import _build

        _build.set_build_dir(args.compile_cache)
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
            args.traj = args.step_dump_dir = args.checkpoint = args.profile = None
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
    import time

    from mppi_gpu_tpu_torch.config import ConfigError
    from mppi_gpu_tpu_torch.io.csvio import write_traj_csv
    from mppi_gpu_tpu_torch.runner import run_closed_loop, run_episode_jit
    from mppi_gpu_tpu_torch.utils.timing import profiler_trace

    if args.jit_episode:
        host_only = [flag for flag, given in (
            ("-s", args.step_dump_dir), ("--checkpoint", args.checkpoint),
            ("--resume", args.resume), ("-v", args.verbose), ("--view", args.view),
            (f"--world {args.world}", args.world != "torch")) if given]
        if host_only:
            raise ConfigError(f"{', '.join(host_only)}: options of the host loop, which "
                              "--jit-episode does not run")
    with profiler_trace(args.profile):
        if args.jit_episode:
            t0 = time.perf_counter()
            result = run_episode_jit(ctrl, num_steps=args.max_steps)
            wall = time.perf_counter() - t0
            if args.traj:
                write_traj_csv(args.traj, result.times, result.xs[1:], result.us)
        else:
            result = run_closed_loop(
                ctrl,
                world_backend=args.world,
                view=args.view,
                max_steps=args.max_steps,
                traj_csv=args.traj,
                step_dump_every=args.dump_every if args.step_dump_dir else None,
                step_dump_dir=args.step_dump_dir,
                verbose=args.verbose,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every if args.checkpoint else None,
                resume_from=args.resume,
            )
    print(f"episode finished: {len(result.us)} control steps")
    if args.jit_episode:
        graph = "one CUDA graph of a control cycle, replayed" if ctrl.device.type == "cuda" else "a loop"
        print(f"device episode on {ctrl.device} ({graph}): {wall:.3f} s, capture and kernel "
              "build included")
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
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
