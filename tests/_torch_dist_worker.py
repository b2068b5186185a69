"""One rank of a gloo process group on the CPU, for tests/test_torch_sharded.py.

    python tests/_torch_dist_worker.py SPEC.pt RANK

SPEC.pt is a ``torch.save``d dict: ``world`` (the number of ranks),
``init`` (a ``file://`` URL the ranks meet at) and ``tasks``, a list of
(name, kwargs). The rank joins the group through
``parallel.multihost.init_multihost`` (task ``cli`` joins through the CLI's
``--multihost`` instead), runs the tasks in order and saves their results,
a list, to ``RANK.pt`` beside SPEC.pt. It imports neither JAX nor the JAX
package, so it starts in a few seconds.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from mppi_gpu_tpu_torch.parallel import (  # noqa: E402
    ShardedFleetController,
    ShardedMPPIController,
    global_mesh,
    init_multihost,
    is_coordinator,
)
from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost  # noqa: E402

_CALLS = {"all_reduce": 0, "all_gather": 0}


def _counting(name: str):
    """dist.<name>, counting its calls in _CALLS."""
    inner = getattr(dist, name)

    def call(*args, **kwargs):
        _CALLS[name] += 1
        return inner(*args, **kwargs)

    return call


def _leaves(res) -> dict:
    return dict(action=res.action, u_next=res.u_next, **res.info._asdict())


def _counted(fn) -> tuple[dict, dict]:
    """fn()'s result's leaves and the collectives it called."""
    for k in _CALLS:
        _CALLS[k] = 0
    out = _leaves(fn())
    return out, dict(_CALLS)


def solve(cfg, x, U, onepass: bool, eps=None, seed: int = 0, step: int = 0):
    """ShardedMPPIController over the group: solve_with_eps on `eps`, else
    the Philox solve for (seed, step); its leaves and collectives."""
    ctrl = ShardedMPPIController(cfg, mesh=global_mesh("cpu"), onepass=onepass)
    if eps is not None:
        return _counted(lambda: ctrl.solve_with_eps(x, U, eps))
    return _counted(lambda: ctrl.solve(x, U, seed, step))


def debug(cfg, x, U, step: int):
    """ShardedMPPIController.solve_debug over the group: the action and the
    dump (None off the coordinator)."""
    ctrl = ShardedMPPIController(cfg, mesh=global_mesh("cpu"))
    res, eps, xs = ctrl.solve_debug(x, U, step)
    return dict(action=res.action, eps=eps, xs=xs)


def fleet(cfg, n_robots, xs, goals=None, step: int = 1):
    """ShardedFleetController's solve of the fleet over the group."""
    ctrl = ShardedFleetController(cfg, n_robots, mesh=global_mesh("cpu"), goals=goals)
    return _counted(lambda: ctrl.solve(xs, ctrl.init_action_seqs(), ctrl.init_seeds(), step))


def fleet_episode(cfg, n_robots, num_steps: int):
    """``runner.run_fleet_episode`` of ShardedFleetController over the
    group: the histories of every robot."""
    from mppi_gpu_tpu_torch.runner import run_fleet_episode

    ctrl = ShardedFleetController(cfg, n_robots, mesh=global_mesh("cpu"))
    ep = run_fleet_episode(ctrl, num_steps=num_steps)
    return dict(xs=ep.xs, us=ep.us, times=ep.times)


def episode(cfg, num_steps: int):
    """``runner.run_episode_jit`` and ``run_closed_loop`` of
    ShardedMPPIController over the group, in each branch: the histories of
    both."""
    from mppi_gpu_tpu_torch.runner import run_closed_loop, run_episode_jit

    out = {}
    for onepass in (True, False):
        ctrl = ShardedMPPIController(cfg, mesh=global_mesh("cpu"), onepass=onepass)
        ep = run_episode_jit(ctrl, num_steps=num_steps)
        host = run_closed_loop(ctrl, max_steps=num_steps)
        out[onepass] = dict(xs=ep.xs, us=ep.us, times=ep.times, host_xs=host.xs, host_us=host.us)
    return out


def multihost(init: str, world: int, rank: int):
    """init_multihost's re-calls: the same arguments or none return the
    coordinates; other arguments raise RuntimeError."""
    same = init_multihost(init, world, rank)
    bare = init_multihost()
    try:
        init_multihost(init + "-other", world, rank)
        conflict = None
    except RuntimeError as e:
        conflict = str(e)
    return dict(same=same, bare=bare, conflict=conflict, coordinator=is_coordinator())


def cli(argv: list[str]):
    """The CLI in this process: its exit code and standard output."""
    from mppi_gpu_tpu_torch import cli as cli_mod

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_mod.main(argv)
    return dict(rc=rc, out=buf.getvalue())


def main(spec_path: str, rank: int) -> None:
    spec = torch.load(spec_path, weights_only=False)
    world, init = spec["world"], spec["init"]
    grouped = any(name != "cli" for name, _ in spec["tasks"])
    if grouped:
        init_multihost(init, world, rank, backend="gloo")
        dist.all_reduce = _counting("all_reduce")
        dist.all_gather = _counting("all_gather")
    out = []
    for name, kwargs in spec["tasks"]:
        if name == "multihost":
            out.append(multihost(init, world, rank))
        elif name == "cli":
            out.append(cli([*kwargs["argv"], "--process-id", str(rank)]))
        else:
            out.append({"solve": solve, "fleet": fleet, "debug": debug,
                        "fleet_episode": fleet_episode, "episode": episode}[name](**kwargs))
    if grouped:
        shutdown_multihost()
    torch.save(out, os.path.join(os.path.dirname(spec_path), f"{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
