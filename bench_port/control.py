"""The control of ``correct``: the reference computed in bfloat16 put in the
program's place, judged as a run judges the program. It must read above
the cell's limits. Run it on the GPU at a cell's own size:

    python3 -m bench_port.control --workload <cell> --seeds 11 12 13

For each seed it draws the run's inputs (``bench_port.drive.draw``), runs
the start of as many episodes as a run judges, every robot of each and as
many cycles as a run compares (a host-loop cell: one episode's steps), with
the bfloat16 controller and world, judges them as a run does and prints
each reading beside its limit, one JSON line per seed. The program's
readings on the same seeds are those of ``bench_port.run``'s result lines.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from bench_port import check, drive, run
from bench_port.reference import mppi, worlds


def episode_readings(cell: run.Cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    cfg = {**cell.config, "samples": int(cell.traffic["samples"])}
    noise_seed, starts, _ = drive.draw(cell.traffic, seed, int(cfg["state-dim"]))
    R, E, n = int(cell.traffic.get("robots", 1)), int(cell.check["episodes"]), int(cell.check["cycles"])
    seeds = check.robot_seeds(noise_seed, R).repeat(E)
    t0 = float(np.float32(cfg["world"]["timestep"]))
    x0 = starts[:E].reshape(E * R, -1)
    xs, us, clocks = check.control_episode(cfg, seeds, x0, n, t0, device, dtype)
    gaps, world = check.episode_gaps(cfg, seeds, xs, us, clocks, n, device)
    return check.episode_reading(cell.check, gaps, world)


def hostloop_readings(cell: run.Cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    cfg = {**cell.config, "samples": int(cell.traffic["samples"])}
    s, n = int(cfg["state-dim"]), int(cell.traffic["cycles"])
    noise_seed, starts, rng = drive.draw(cell.traffic, seed, s)
    seeds = torch.tensor([noise_seed], dtype=torch.int64)
    solver = mppi.Solver(cfg, seeds, device, dtype)
    f = dict(dtype=dtype, device=device)
    picks = set(rng.choice(n, size=min(n, cell.check["steps"]), replace=False).tolist())
    x, U = torch.as_tensor(starts[0], **f), solver.init_U()  # x (1, s)
    records = []
    for c in range(n):
        a, Un = solver.cycle(x, U, c)
        x_next = worlds.cycle(cfg["world"], x, a)
        if c in picks:
            rec = (x, U, a, Un, x_next)
            records.append((c, *(v[0].float().cpu().numpy() for v in rec)))
        x, U = x_next, Un
    return check.hostloop_gaps(cfg, noise_seed, records, device)


def readings(cell: run.Cell, seed: int, device) -> dict:
    if cell.traffic["kind"] == "hostloop":
        return hostloop_readings(cell, seed, device)
    return episode_readings(cell, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = run.load_cell(args.workload)
    device = run.require_chips(1)  # the reference runs on one chip, whatever the cell's
    limits = cell.check["limits"]
    for seed in args.seeds:
        got = readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "limits": limits, "control": got,
                          "fails": any(got[k] > limits[k] for k in limits)}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
