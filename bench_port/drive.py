"""The traffic: one general generator of each mix's inputs, and the loops
that drive the port through its public entries with them. A traffic file
(``bench_port/traffic/<name>.json``) names its ``kind`` and its parameters:

* ``episode``: ``robots`` R, the rollouts per robot ``samples`` and the
  episode's ``cycles``; the window runs whole device episodes back to back
  (``runner.run_episode_jit`` for one robot, ``runner.run_fleet_episode``
  for a fleet), each from its own start state.
* ``hostloop``: ``samples`` and the episode's ``cycles``; the window runs the
  host loop of ``runner.run_closed_loop`` against the native plant,
  unpaced: the plant's state → ``MPPIController.solve_auto`` → the action in
  a host array → the plant's cycle. A new episode starts from its own start
  state where one ends, until the window closes.
* ``sharded_episode``: the ``episode`` kind's parameters for one robot, and
  ``ranks`` n (the cell's ``chips``) and ``onepass`` (the one-pass branch, or
  the two-kernel one): ``samples`` K sharded over n ranks of a process
  group, one process and one GPU each (``bench_port.ranks``), each rank's
  ``ShardedMPPIController`` running ``runner.run_episode_jit``; this
  process is rank 0, which alone times the window and keeps the episodes.

The start states are a pool of ``pool`` draws (``start`` + a uniform draw
in ±``spread`` per state entry, a fleet's robots each their own) from the
generator of ``pool_seed``: the same for every run, so every seed gives the
same work. The run's seed orders them (episode e starts from the pool's
entry order[e mod pool]) and draws the controller's noise seed. So a seed
fixes every input.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench_port import ranks

MAX_EPISODES = 4096  # start states drawn per run; a window ends long before


@dataclass
class Window:
    """What one window did: its wall seconds, the control cycles it
    completed, each host-loop step's latency, the episodes (xs, us, clocks)
    and the sampled host-loop steps, kept for the check."""

    wall_s: float = 0.0
    cycles: int = 0
    latencies_s: list = field(default_factory=list)
    episodes: list = field(default_factory=list)
    records: list = field(default_factory=list)
    failed: int = 0


def draw(traffic: dict, seed: int, s: int) -> tuple[int, np.ndarray, np.random.Generator]:
    """(noise seed, each episode's start states (MAX_EPISODES, R, s), the
    generator for later draws) of `seed`."""
    base = np.asarray(traffic["start"], np.float64)
    spread = np.asarray(traffic["spread"], np.float64)
    if base.shape != (s,) or spread.shape != (s,):
        raise ValueError(f"start and spread need {s} entries each")
    P, R = int(traffic["pool"]), int(traffic.get("robots", 1))
    pool = base + np.random.default_rng(traffic["pool_seed"]).uniform(-1.0, 1.0, (P, R, s)) * spread
    rng = np.random.default_rng(seed)
    noise_seed = int(rng.integers(1, 2**31))
    order = np.resize(rng.permutation(P), MAX_EPISODES)
    return noise_seed, pool[order].astype(np.float32), rng


def program_config(cfg_map: dict, traffic: dict, noise_seed: int):
    """The port's configuration: the file's keys, the traffic's rollouts
    per robot, the drawn noise seed."""
    from mppi_gpu_tpu_torch.config import config_from_mapping

    return config_from_mapping({**cfg_map, "samples": int(traffic["samples"]), "seed": noise_seed})


def span(on: bool):
    """A profiler span around a call into the port, when tracing."""
    if not on:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


class Driver:
    """What a kind's driver does besides ``warm``, ``window`` and ``close``,
    where it runs processes of its own: their reports once closed, a
    context around the traced window, and ``abort`` after a failure."""

    reports: tuple = ()

    def traced(self):
        return contextlib.nullcontext()

    def abort(self) -> None:
        pass


class Episodes(Driver):
    """Device episodes of one robot or a fleet."""

    def __init__(self, cfg_map: dict, traffic: dict, seed: int, device) -> None:
        from mppi_gpu_tpu_torch.batched import BatchedMPPIController
        from mppi_gpu_tpu_torch.controller import MPPIController
        from mppi_gpu_tpu_torch.envs import params_for_config

        s = int(cfg_map["state-dim"])
        self.noise_seed, self.starts, _ = draw(traffic, seed, s)
        self.R, self.n = int(traffic.get("robots", 1)), int(traffic["cycles"])
        cfg = program_config(cfg_map, traffic, self.noise_seed)
        self.fleet = self.R > 1
        self.ctrl = (BatchedMPPIController(cfg, self.R, device=device) if self.fleet
                     else MPPIController(cfg, device=device))
        self.t0 = float(np.float32(params_for_config(cfg).timestep))

    def run(self, i: int):
        from mppi_gpu_tpu_torch.runner import run_episode_jit, run_fleet_episode

        if self.fleet:
            return run_fleet_episode(self.ctrl, num_steps=self.n, xs0=self.starts[i])
        return run_episode_jit(self.ctrl, num_steps=self.n, x0=self.starts[i, 0])

    def warm(self) -> None:
        self.run(MAX_EPISODES - 1)

    def window(self, seconds: float, mark, tracing: bool) -> Window:
        w, sp = Window(), span(tracing)
        mark()
        t0 = time.perf_counter()
        i = 0
        while True:
            with sp("bench.episode"):
                res = self.run(i)
            w.episodes.append((res.xs, res.us, res.times))
            w.cycles += self.n
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        w.wall_s = time.perf_counter() - t0
        mark()
        for _, us, _ in w.episodes:
            w.failed += int(np.sum(~np.all(np.isfinite(us.reshape(self.n, -1)), axis=1)))
        return w

    def close(self) -> None:
        del self.ctrl


class HostLoop(Driver):
    """The host loop against the native plant."""

    def __init__(self, cfg_map: dict, traffic: dict, seed: int, device) -> None:
        from mppi_gpu_tpu_torch.controller import MPPIController
        from mppi_gpu_tpu_torch.envs import make_host_world

        s = int(cfg_map["state-dim"])
        self.noise_seed, self.starts, rng = draw(traffic, seed, s)
        self.n = int(traffic["cycles"])
        # the step of each episode whose inputs and outputs are kept for the check
        self.pick = rng.integers(0, self.n, size=MAX_EPISODES)
        cfg = program_config(cfg_map, traffic, self.noise_seed)
        self.ctrl = MPPIController(cfg, device=device)
        self.plant = make_host_world(cfg, None, "native")
        self.t0 = self.plant.time
        self.record = False

    def episode(self, e: int, deadline: float, w: Window, sp) -> bool:
        """Episode `e` until its end or `deadline`; True if it reached its end."""
        ctrl, plant = self.ctrl, self.plant
        plant.set_state(self.starts[e, 0], self.t0)
        U = ctrl.init_action_seq()
        for c in range(self.n):
            x = plant.get_x()
            t_a = time.perf_counter()
            with sp("bench.solve"):
                res = ctrl.solve_auto(torch.from_numpy(x), U, c)
            with sp("bench.read_back"):
                action = res.action.cpu().numpy()
            w.latencies_s.append(time.perf_counter() - t_a)
            keep = self.record and c == self.pick[e]
            U_in, U = U, res.u_next
            with sp("bench.plant"):
                done = plant.simulate(action)
            if done:
                raise RuntimeError(f"the plant ended its episode at step {c} of {self.n}")
            if not np.all(np.isfinite(action)):
                w.failed += 1
            if keep:
                w.records.append((c, x, U_in, action, U, plant.get_x()))
            w.cycles += 1
            if time.perf_counter() >= deadline:
                return False
        return True

    def warm(self) -> None:
        self.episode(MAX_EPISODES - 1, float("inf"), Window(), span(False))

    def window(self, seconds: float, mark, tracing: bool) -> Window:
        w, sp = Window(), span(tracing)
        self.record = True
        mark()
        t0 = time.perf_counter()
        e = 0
        while self.episode(e, t0 + seconds, w, sp):
            e += 1
        w.wall_s = time.perf_counter() - t0
        mark()
        self.record = False
        # the kept sequences to the host, after the window
        w.records = [(c, x, U.cpu().numpy(), a, Un.cpu().numpy(), xn)
                     for c, x, U, a, Un, xn in w.records]
        return w

    def close(self) -> None:
        del self.ctrl


def sharded_controller(cfg_map: dict, traffic: dict, noise_seed: int, device, onepass: bool):
    """One rank's ``ShardedMPPIController`` of the cell, on this process's
    rank of the default process group (``make_mesh``)."""
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController, make_mesh

    cfg = program_config(cfg_map, traffic, noise_seed)
    return ShardedMPPIController(cfg, mesh=make_mesh(device), onepass=onepass)


class ShardedEpisodes(Episodes):
    """Device episodes of one robot whose rollouts are sharded over the
    ranks of a process group (``bench_port.ranks``): before each of its
    episodes rank 0 sends the others the episode's index, and with a trace
    the markers and the trace's start and end."""

    entry = staticmethod(ranks.rank_main)  # what each spawned rank runs

    def __init__(self, cfg_map: dict, traffic: dict, seed: int, device) -> None:
        from mppi_gpu_tpu_torch.envs import params_for_config

        if int(traffic.get("robots", 1)) != 1:
            raise ValueError("a sharded episode runs one robot")
        s = int(cfg_map["state-dim"])
        self.noise_seed, self.starts, _ = draw(traffic, seed, s)
        self.R, self.n, self.fleet = 1, int(traffic["cycles"]), False
        onepass = bool(traffic["onepass"])
        self.group = ranks.Group(int(traffic["ranks"]), device, self.entry,
                                 (cfg_map, traffic, self.noise_seed, self.starts, onepass))
        try:
            self.ctrl = sharded_controller(cfg_map, traffic, self.noise_seed, device, onepass)
        except BaseException:
            self.group.abort()
            raise
        self.t0 = float(np.float32(params_for_config(self.ctrl.cfg).timestep))

    def run(self, i: int):
        self.group.send(i)
        return super().run(i)

    @contextlib.contextmanager
    def traced(self):
        self.group.send("trace")
        yield
        self.group.send("untrace")

    def window(self, seconds: float, mark, tracing: bool) -> Window:
        def marks():
            if tracing:
                self.group.send("mark")
            mark()

        return super().window(seconds, marks, tracing)

    def close(self) -> None:
        self.group.stop()
        del self.ctrl
        gc.collect()
        self.reports = self.group.close()

    def abort(self) -> None:
        self.group.abort()


KINDS = {"episode": Episodes, "hostloop": HostLoop, "sharded_episode": ShardedEpisodes}
