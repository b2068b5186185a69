"""The ranks of a cell across GPUs: the port's process group, one process
and one GPU per rank, as ``torchrun`` would start it for
``cli --sharded --jit-episode``.

Rank 0 is the harness's own process. It loads the port's libraries (so
that a fresh checkout builds them once, not in every rank at once), spawns
ranks 1 … n−1 (the ``spawn`` start method, daemonic), and joins them at a
``file://`` rendezvous in a temporary directory. Rank r runs
:func:`rank_main`: ``cuda:r`` as its device (the CPU and gloo in the tests),
``init_multihost``'s group, its ``ShardedMPPIController`` of the cell, and
then whatever rank 0 sends it over its pipe, a channel outside any graph:

* an int i: episode i (``runner.run_episode_jit`` from start state i);
* ``"trace"`` / ``"untrace"``: start torch.profiler / stop it and read the
  window between its two markers (``bench_port.trace``);
* ``"mark"``: a marker kernel on the rank's stream;
* ``None``: leave the group, report and exit.

So each rank runs the same episodes as rank 0, in the same order, and
traces the window rank 0 traces, without knowing which window it is. At
its end a rank sends one report: its peak memory, its traced windows' busy
and span seconds, and the JAX modules it loaded. A rank that raises prints
its traceback and exits non-zero; rank 0 watches every rank, and one that
ends before it was told to, or ends non-zero, makes rank 0 kill the others
and exit non-zero without a result. A rank whose parent is gone exits.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing import connection, get_context

JOIN_S = 60.0     # what closing waits for the ranks' reports and exits
FAILED_EXIT = 3   # rank 0's exit code when a rank failed


class Group:
    """Ranks 1 … n−1 of an n-rank process group, each a process that runs
    `entry(rank, n, init, device type, pipe, *args)`; this process joins as
    rank 0 (``init_multihost``) once they are started."""

    def __init__(self, n: int, device, entry, args: tuple) -> None:
        from mppi_gpu_tpu_torch.parallel import init_multihost

        if device.type == "cuda":
            from mppi_gpu_tpu_torch.ops import _build

            _build.load_library()
        self.tmp = tempfile.TemporaryDirectory(prefix="bench_port_ranks_")
        init = "file://" + os.path.join(self.tmp.name, "init")
        ctx = get_context("spawn")
        self.procs, self.conns = [], []
        self.closing = False
        for r in range(1, n):
            here, there = ctx.Pipe()
            p = ctx.Process(target=entry, args=(r, n, init, device.type, there, *args),
                            name=f"bench_port rank {r}", daemon=True)
            p.start()
            there.close()
            self.procs.append(p)
            self.conns.append(here)
        threading.Thread(target=self._watch, name="bench_port ranks", daemon=True).start()
        self.nccl = device.type == "cuda"
        try:
            init_multihost(init, n, 0, backend="nccl" if self.nccl else "gloo")
        except BaseException:
            self.abort()
            raise

    def send(self, msg) -> None:
        for c in self.conns:
            c.send(msg)

    def stop(self) -> None:
        """Tells every rank to leave; from now on a rank may end."""
        self.closing = True
        self.send(None)

    def _watch(self) -> None:
        """Ends this process when a rank ends before it was told to: rank 0
        may be waiting inside a collective that the rank will never join.
        Once the ranks are told to end, :meth:`close` judges how they end."""
        left = {p.sentinel: p for p in self.procs}
        while left:
            for s in connection.wait(list(left)):
                p = left.pop(s)
                if self.closing is not False:  # told to end, or killed: closing joins them
                    return
                p.join()
                print(f"bench_port: {p.name} ended with exit code {p.exitcode}; "
                      "ending the run", file=sys.stderr)
                self.kill()
                sys.stderr.flush()
                os._exit(FAILED_EXIT)

    def kill(self) -> None:
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
        for p in self.procs:
            p.join(JOIN_S)

    def close(self) -> list[dict]:
        """After :meth:`stop`, the ranks' reports once each has ended. A rank
        that sends none, or names a JAX module it loaded, raises
        RuntimeError, the ranks killed. A gloo group is left by every rank
        together (``shutdown_multihost``); an NCCL group is not torn down:
        each rank ends its process after its report, and rank 0 ends its
        own without Python's teardown (``bench_port.run``): on four H100s
        ``destroy_process_group`` did not return while a CUDA graph that
        holds captured collectives was alive, and the controllers' cached
        episode graphs live as long as whatever refers to them."""
        from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost

        if not self.nccl:
            shutdown_multihost()
        reports = []
        try:
            for p, c in zip(self.procs, self.conns):
                if not c.poll(JOIN_S):
                    raise RuntimeError(f"{p.name} sent no report in {JOIN_S:.0f} s")
                reports.append(c.recv())
            for p in self.procs:
                p.join(JOIN_S)
                if p.exitcode != 0:
                    raise RuntimeError(f"{p.name} ended with exit code {p.exitcode}")
        except BaseException:
            self.abort()
            raise
        self.tmp.cleanup()
        leaked = sorted({m for r in reports for m in r["forbidden"]})
        if leaked:
            raise RuntimeError(f"a rank loaded {', '.join(leaked)}")
        return reports

    def abort(self) -> None:
        """Kills every rank (after a failure in this process)."""
        self.closing = None
        self.kill()
        self.tmp.cleanup()


def _watch_parent() -> None:
    ppid = os.getppid()
    while os.getppid() == ppid:
        time.sleep(1.0)
    os._exit(FAILED_EXIT)


def rank_main(rank: int, world: int, init: str, device_type: str, conn, cfg_map: dict,
              traffic: dict, noise_seed: int, starts, onepass: bool) -> None:
    """Rank `rank` of `world`: joins the group at `init`, builds the cell's
    sharded controller and serves rank 0's messages (see the module's
    docstring) until None, then reports and exits."""
    threading.Thread(target=_watch_parent, daemon=True).start()
    try:
        _serve(rank, world, init, device_type, conn, cfg_map, traffic, noise_seed, starts,
               onepass)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _serve(rank, world, init, device_type, conn, cfg_map, traffic, noise_seed, starts,
           onepass) -> None:
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_port import drive, run, trace
    from mppi_gpu_tpu_torch.parallel import init_multihost
    from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost
    from mppi_gpu_tpu_torch.runner import run_episode_jit

    cuda = device_type == "cuda"
    if cuda:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)  # before NCCL meets: the rank's GPU, not cuda:0
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_multihost(init, world, rank, backend="nccl" if cuda else "gloo")
    ctrl = drive.sharded_controller(cfg_map, traffic, noise_seed, device, onepass)
    n = int(traffic["cycles"])
    prof, traces = None, []
    while (msg := conn.recv()) is not None:
        if isinstance(msg, int):
            run_episode_jit(ctrl, num_steps=n, x0=starts[msg, 0])
        elif not cuda:  # no device to trace or mark
            continue
        elif msg == "trace":
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        elif msg == "untrace":
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            tr = trace.read(prof)
            traces.append((tr.busy_s, tr.span_s))
            prof = None
        elif msg == "mark":
            torch.cuda._sleep(1000)
        else:
            raise ValueError(f"rank {rank}: unknown message {msg!r}")
    report = {"rank": rank, "traces": traces, "forbidden": run.forbidden_modules()}
    if cuda:  # NCCL's communicators are left to the process's end (Group.close)
        torch.cuda.synchronize()
        conn.send({**report, "peak": int(torch.cuda.max_memory_allocated(device))})
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    del ctrl
    gc.collect()
    shutdown_multihost()
    conn.send({**report, "peak": 0})
    conn.close()
