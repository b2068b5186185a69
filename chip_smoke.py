#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mppi_gpu_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``mppi_gpu_tpu_torch/csrc``, holds each one
against its plain PyTorch version and a float64 reference, times them, and
drives the port's three paths on the card: the point-mass robot
(``MPPIController`` and the closed-loop CLI, phases 3-7), the point-mass
fleet (``BatchedMPPIController``, ``run_fleet_episode`` and the fleet
example, phases 8-10), the pendulum and cart-pole families (K1's
pendulum and cart-pole instances against their plain versions, and the CLI
on configs/pendulum.yaml and configs/cartpole.yaml, phases 11-12), the
coupled A=2 families (K1's unicycle, quadrotor and arm instances, and the
CLI on configs/unicycle.yaml, quadrotor.yaml and arm.yaml, phases 13-14),
the costs-only sweep K4 for every family instance (phase 15), and the last
two families, the point mass with the obstacle cost and the 3-D quadrotor
(K1's LtiObstacle<2>, LtiObstacle<3> and Quadrotor3D instances and the
controller's pack after a cost reassignment, phase 16; the CLI on
configs/quadrotor3d.yaml, the obstacle quality episode and the ported
obstacle and flight examples, phase 17), and the multi-GPU path: K5, the
weighted update of the two-kernel sharded solve, against its plain version
(phase 18), and the sharded solve of ``parallel/`` in both branches on a
world of one NCCL rank and on four virtual ranks against the solo solve,
the sharded fleet, the ``--sharded`` CLI and the two-kernel closed loop
(phase 19), and K1's and K4's two bodies (the slab body of the main path's
K and the per-rollout body; ``ops/fused_solve.block_width`` picks one): S
bit-equal across both for every family instance, their partials against the
plain ones with few, about half and all of each block's rollouts weighing
(phase 4 replays K3's dump at those λ too), K2 at the nb of both widths and of K5, the
share of rollouts that weigh in closed loops, and both bodies timed across
K for every family, with the crossover each family's timings give beside
the rule's table (phase 20),
and the on-device episode: K1's step by pointer bit-equal to by value,
``run_episode_jit`` as a replayed CUDA graph of one control cycle for every
config and the flagship (bit-equal to the same cycle run eagerly on the
card, within each config's tolerance of the host loop at four seeds, under
each quality tripwire),
an R=8 ``run_fleet_episode`` of every family, a reassigned cost
re-capturing, checkpoint/resume and the CLI's ``--jit-episode``,
``--checkpoint``/``--resume`` and ``--profile`` on the card, with ms per
control cycle of the three loops, kernels per cycle and idle shares from a
trace of the graph's replays alone; K6 ``world_advance``
(``csrc/world_step.cu``, one launch per control cycle of a world) against
its plain loop for every world body, solo and R=8 and R=64, under one
shared clock and one per robot, crossing sim_end, with a NaN state and a
NaN action and its history rows at a non-zero counter, with a tolerance of
0 (WORLD_STEP_TOL: bit for bit, NaN bits included, since K6 repeats every
torch op of the plain loop in order, each rounded once alike), three world
cycles' device records (K6 alone, once each), its launches in the eager episodes
(one per cycle) and its records in the replay traces (one per cycle), and,
as the episode's cycle runs it, the new x written into the cycle's buffer and
the step counter advanced, both bit for bit; K7 ``solve_tail``
(``csrc/solve_tail.cu``, the tail of one update for R robots in one launch:
U + ΔU, the clamp, the action, the shift and the softmin weights, each only
where asked for) against its plain version, solo, R=8 and R=64, T=1 and 200,
A=1-4, clamp on and off, a NaN, in place, every output bit for bit
(TAIL_TOL, TAIL_WEIGHTS_TOL: 0), how torch divides by a Python float on the
card, K7's times beside its bound; and every graph cycle of a fused episode
four kernels (K1, K2, K7, K6) at one opt iteration and seven at two
(phase 21); then a fused family
registered from user code, the bicycle of
``mppi_gpu_tpu_torch/examples/custom_family.py``: its own library built from
its struct, K1 and K4 on it against their plain versions in every mode and
both bodies, its fleet, diverging rollouts, times beside the bound from that
library's SASS, and the example on the fused backend (phase 22); the planar
quadrotor's waypoint tour, fused, packing once (phase 23); and the learned
models: both learning examples on the card, the learned controller's graph
episode bit-equal to its eager cycle, its solve beside the fused LTI's
(phase 24); and the host plants: the CLI's closed loop on the native C++
twin (and on MuJoCo where ``import mujoco`` works) beside the torch world,
resume on the native plant and the ``miss`` harness (phase 25); and the
graphs: K5 with the step by pointer bit-equal to by value, the host loop's
solve as a replayed CUDA graph bit-equal to the op-by-op solve for every
config, the learned model, a fleet and the sharded controller, with each
loop's ms per control step both ways, and the sharded device episode, its
collectives captured, in both branches on a world of one NCCL rank and on
four virtual ranks (phase 26); and K8 ``sharded_scale`` and K9
``sharded_tail`` (``csrc/sharded_combine.cu``: the one-pass sharded
combine between its two all-reduces, and the division by η, the tail and
the world's step after them) bit-equal to their plain versions and to the
torch combine they replaced, also at rows on every boundary of K9's row
block, K9's world step for every world body at three horizons, and the
sharded solve and graph episode with them bit-equal to the torch-combine
cycle at point_mass2d and the flagship, both branches, both meshes, with
their times (phase 27).
``--time-commit ROOT`` instead times K1, K2, K4, K5, K3, K2', K8-K11, K7
and K6 of the package in the checkout at ROOT (with digests of their
outputs), and ``--episode-commit ROOT`` its device episodes (ms per cycle,
kernels per cycle, K1 + K2's share of busy, K2''s µs per cycle by world
body, K8's-K11's µs per sharded cycle), to compare two commits in one run;
``--sass-diff ROOT [REGEX]`` compares the built-in library's SASS with
ROOT's, kernel by kernel (the kernels REGEX names may differ);
``--bodies``, ``--episode``, ``--family``, ``--plants``, ``--graphs`` and
``--sharded-combine`` run the build and phase 20, 21, 22, 25, 26 or 27
alone. Every phase
prints one line (or a few) and how far into the run it ended; any failure raises and
the script exits non-zero without the final line. Without a CUDA device it
exits 1 at once. The last two lines are a JSON object describing every
kernel, K1 once per family instance, K2-K5, the bicycle's K1 and K4, K7,
K2', K6 once per world body, K8 and K9 (route, source, the TPU kernels it replaces or
the XLA fusion it stands for, launches on its path as its wrapper counted
them, max abs error
against its plain version, ms
on the card next to the plain version's and to its bound, the least time
the card could take: instructions per step from the built SASS, or bytes)
and ``{"ok": true, "device": {...}}``. A wrapper counts only the launches
it makes: on a CUDA device the host loop's solve is a replayed CUDA graph,
so a closed loop counts its graph's warm-up and its op-by-op dump steps,
and the records of the replayed kernels per control step are read from a
trace of the graphed loop (``solve_trace``), as an episode graph's are
(``replay_trace``).

The ``check_*`` functions are also called by the GPU tests
(``tests/test_torch_fused.py``, ``tests/test_torch_fleet.py``,
``tests/test_torch_families.py``, ``tests/test_torch_coupled.py``,
``tests/test_torch_obstacle_q3d.py``, ``tests/test_torch_sharded.py``,
``tests/test_torch_custom_family.py``, ``tests/test_torch_neural.py``) at
small shapes.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SOURCE = "mppi_gpu_tpu_torch/csrc/mppi_solve.cu"
PALLAS = "mppi_gpu_tpu/ops/pallas_rollout.py"
# steady-state tripwires (bench.QUALITY_THRESHOLDS): goal distance of the lti
# family, angle from upright of the pendulum and the cart-pole
LTI_QUALITY_THRESHOLD_M = 0.35
FAMILY_QUALITY_THRESHOLD_RAD = {"pendulum": 0.2, "cartpole": 0.35}
FAMILIES = ("pendulum", "cartpole")
# the coupled A=2 families and their steady-state tripwires
# (bench.QUALITY_THRESHOLDS): goal distance of the unicycle and the
# quadrotor, end-effector distance of the arm, in m
COUPLED = ("unicycle", "quadrotor", "arm")
COUPLED_QUALITY_THRESHOLD_M = {"unicycle": 0.4, "quadrotor": 0.5, "arm": 0.5}
# the last two families' instances: the point mass with the obstacle cost at
# A=2 (examples/obstacle_nav.py's config) and A=3 (the obstacle quality
# config below), and the 3-D quadrotor (configs/quadrotor3d.yaml); their K1
# entries in the kernels line
LAST = ("obstacle2d", "obstacle3d", "quadrotor3d")
# steady-state tripwires (bench.QUALITY_THRESHOLDS): the 3-D quadrotor's
# distance to the goal, the obstacle quality episode's, in m
LAST_QUALITY_THRESHOLD_M = {"quadrotor3d": 0.8, "obstacle": 0.5}
# bench._quality_cfg("obstacle") as literals (this script imports nothing of
# bench.py): point_mass3d's widths at K=2048, T=50 with two obstacles whose
# radii the planner sees inflated by bench.QUALITY_OBSTACLE_MARGIN; the
# clearance is scored against the true radii
OBSTACLES_3D = ((0.5, 0.25, 0.4, 0.2), (0.2, 0.4, 0.1, 0.15))
OBSTACLE_MARGIN = 0.06
# whether one episode clears the true surfaces is not a property of the
# controller: rounding alone flips it. The JAX package's own two loops over
# the same threefry noise (step by step, and bench.quality_row's whole-episode
# jit) disagree on its sign in 10 of seeds 0-31, and the two packages'
# controllers fed one noise stream part by 1e-3 within 10-33 control steps
# (tests/_obstacle_noise_probe.py on the CPU). So the clearance is held as a
# rate over seeds 0-63 against the reference's over the same seeds:
# bench.quality_row("obstacle", backend="scan", seed=s) clears in 43 of 64
# (the probe with --jax-row-only --seeds 64). The port's share must not be
# below it by a one-sided Fisher exact test at 1 %: 29 of 64 pass, 28 fail,
# and an obstacle term that does not fire sends every episode through the
# first sphere
OBSTACLE_SEEDS, OBSTACLE_REF_CLEAR, OBSTACLE_ALPHA = 64, 43, 0.01
# a second, finer bar: the median clearance over the same seeds. The
# reference's is np.median of the 64 clearances that
# `python tests/_obstacle_noise_probe.py --jax-row-only --seeds 64 --out F`
# writes to F (CPU; the same run gives the 43 of 64 above): +0.02535 m. The
# port's may lie below it by at most 3·√2 standard errors of a median of 64
# such episodes, 0.0106 m by a bootstrap of those 64 clearances (10⁴
# resamples, numpy seed 0): both medians carry that spread
OBSTACLE_REF_MEDIAN_M, OBSTACLE_MEDIAN_SLACK_M = 0.02535, 3 * math.sqrt(2) * 0.0106
# the angle's index in the state and the world's start (envs/*_world.py)
FAMILY_ANGLE = {"pendulum": 0, "cartpole": 1}
FAMILY_INIT_THETA = {"pendulum": 3.14159265, "cartpole": 0.15}
# the kernels JSON line: K1 once per family instance, then K2, K3, K4 and K5,
# the bicycle's K1 and K4, K7 and K2' (K6's entries, one per world body,
# follow)
KERNEL_ENTRIES = ("solve_partials<lti>", "solve_partials<pendulum>", "solve_partials<cartpole>",
                  "solve_partials<unicycle>", "solve_partials<quadrotor>", "solve_partials<arm>",
                  "solve_partials<lti-obstacle,A=2>", "solve_partials<lti-obstacle,A=3>",
                  "solve_partials<quadrotor3d>", "softmin_combine", "noise_dump", "rollout_costs",
                  "weighted_update", "solve_partials<bicycle-demo>", "rollout_costs<bicycle-demo>",
                  "solve_tail", "combine_tail")
# bar of the fleet's mean final goal distance (point_mass2d, R=8 on the circle
# of examples/fleet.py, full episode): the JAX package's own fleet ends that
# episode at 0.364 m on the CPU, so the bar is that figure + 0.05 m
FLEET_DISTANCE_BAR_M = 0.414
# the --sharded CLI's one-pass closed loop on a world of one against the solo
# CLI's, every column of the trajectory CSV (states in m and m/s, actions):
# its solve is the solo solve (S bit-equal, ΔU to f32), so the two loops
# differ by rounding alone
SHARDED_CLI_TOL = 1e-3
# tolerances of tests/test_parity_scale.py at K=10⁴, T=200
TOL = dict(
    S_rel=2e-4, beta=1e-6, eta=2e-3, u=dict(rtol=1e-4, atol=2e-5),
    dU=dict(rtol=2e-3, atol=2e-5),
)


# β against the float64 oracle across a fleet's random robots: β is the least
# rollout cost, and f32 rollouts of T=200 steps carry up to ~2e-6 relative
# error in S against the oracle (the plain version on the CPU: 2.1e-6 at most
# over 8 robots × 10⁴ rollouts), beyond the 1e-6 that TOL holds one fixed
# instance to; against the plain version β stays at TOL's 1e-6
FLEET_ORACLE_BETA_RTOL = 5e-6


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


def kernel_key(mangled: str, structs: dict[str, str] | None = None) -> str:
    """A kernel's readable name from its mangled one: K1 instances read
    solve_partials<family,A=..,inj=..>, K4's (K1's template without its
    second pass) rollout_costs<family,A=..,inj=..>, each with ",slab" for
    their slab body (slab_partials_kernel), K3's noise_dump<A=..>, K5's
    weighted_update<A=..,inj=..> (its softmin form softmin_update<A=..,inj=..>),
    K6's world_advance<World> (PointMass1-3 for the point mass), the check
    of its float substitutions world_identities, K7's solve_tail<threads>
    (solve_tail in a package before its two block widths), K2''s
    combine_tail<World> (NoWorld for the tail alone), K8's sharded_scale,
    K9's sharded_tail<World,divide=0|1>, K10's softmin_min<cluster=0|1>,
    K11's softmin_eta<cluster=0|1> (softmin_min and softmin_eta in a package
    before their cluster form);
    the family under its name in ops/families (the struct's name, lower
    case, is the family's without its hyphen), or, for a library built from
    a user family, under the name `structs` maps its struct's to."""
    from mppi_gpu_tpu_torch.ops.families import FAMILY_NAMES

    w = re.search(r"world_advance_kernel\S*?(PointMass|Pendulum|CartPole|Unicycle|Quadrotor3D|"
                  r"Quadrotor|Arm)(ILi(\d)E)?", mangled)
    if w:  # K6, one instance per world body
        return f"world_advance<{w.group(1)}{w.group(3) or ''}>"
    t = re.search(r"solve_tail_kernel(ILi(\d+)E)?", mangled)
    if t:  # K7, by its block width (one kernel in a package before its two widths)
        return "solve_tail" + (f"<{t.group(2)}>" if t.group(1) else "")
    if "world_identities_kernel" in mangled:  # the check of K6's float substitutions
        return "world_identities"
    if "sharded_scale_kernel" in mangled:  # K8
        return "sharded_scale"
    m = re.search(r"softmin_(min|eta)_kernel(ILb(\d)E)?", mangled)
    if m:  # K10, K11: a block or a ticket per row, or a cluster (a package before them: one kernel)
        return f"softmin_{m.group(1)}" + (f"<cluster={m.group(3)}>" if m.group(2) else "")
    t = re.search(r"sharded_tail_kernel\S*?(NoWorld|PointMass|Pendulum|CartPole|Unicycle|Quadrotor3D|"
                  r"Quadrotor|Arm)(ILi(\d)E)?\S*?Lb(\d)E", mangled)
    if t:  # K9, one instance per world body and one without, each with and without the division
        return f"sharded_tail<{t.group(1)}{t.group(3) or ''},divide={t.group(4)}>"
    e = re.search(r"combine_tail_kernel\S*?(NoWorld|PointMass|Pendulum|CartPole|Unicycle|Quadrotor3D|"
                  r"Quadrotor|Arm)(ILi(\d)E)?", mangled)
    if e:  # K2', one instance per world body and one without
        return f"combine_tail<{e.group(1)}{e.group(3) or ''}>"
    k = re.search(r"(solve_partials|slab_partials|softmin_combine|noise_dump|weighted_update|"
                  r"softmin_update)_kernel", mangled)
    name = k.group(1) if k else mangled
    names = {n.replace("-", ""): n for n in FAMILY_NAMES}
    if structs:
        names = {s.lower(): n for s, n in structs.items()}
    fam = re.search("(" + "|".join(sorted(structs or (
        "LtiObstacle", "Lti", "Pendulum", "CartPole", "Unicycle", "Quadrotor3D", "Quadrotor", "Arm"),
        key=len, reverse=True)) + ")", mangled)
    ints, bools = re.findall(r"Li(\d+)E", mangled), re.findall(r"Lb(\d)E", mangled)
    slab = name == "slab_partials"
    if len(bools) == 2:  # <..., INJ, PASS2>
        name = "solve_partials" if bools.pop() == "1" else "rollout_costs"
    family = names[fam.group(1).lower()] if fam else None
    args = (([family] if fam else []) + ([f"A={ints[-1]}"] if ints else [])
            + [f"inj={b}" for b in bools] + (["slab"] if slab else []))
    return name + (f"<{','.join(args)}>" if args else "")


def entry_key(fam) -> str:
    """The kernels line's K1 entry of a fused family: solve_partials<name>,
    with A for the obstacle family, whose main path runs two instances."""
    a = f",A={fam.action_dim}" if fam.name == "lti-obstacle" else ""
    return f"solve_partials<{fam.name}{a}>"


def ptxas_summary(log: str, structs: dict[str, str] | None = None) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v output:
    registers and spill bytes, under :func:`kernel_key`'s names."""
    out, name, spill = [], "?", "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_key(m.group(1), structs)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spill stores")
    return out


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work


def sass_functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """`cuobjdump -sass` text → {mangled kernel name: [(address, instruction)]}."""
    out: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return out


# a multiply by one of Philox4x32's two round constants, 0xD2511F53 and
# 0xCD9E8D57, which SASS prints as signed immediates
_PHILOX_MUL = re.compile(r"IMAD\S* .*(-0x2daee0ad|-0x326172a9|0xd2511f53|0xcd9e8d57)")


def _branch_target(ins: str) -> int | None:
    m = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def philox_loop_steps(instrs: list[tuple[int, str]]) -> list[float]:
    """Instructions per horizon step (per draw) of each loop of a kernel that
    draws Philox blocks in a loop (K1's two passes, K4's one), on its hot
    path.

    A loop is a backward branch with no EXIT or RET in its range (an
    out-of-line slow path that jumps back is not one); back edges to one
    target are one loop, to the farthest of them. A loop counts when it
    holds Philox rounds and no other loop inside it does: the draw loop of
    K1's per-rollout second pass, not the chunk loop around it; the
    per-step loop of pass 1, whose nested loops are slow paths without a
    Philox round. Inside one, a forward conditional branch over code
    that holds a nested loop or a CALL and no Philox round skips a slow path
    (the large-argument reduction of sinf/cosf, the special cases of
    division and sqrt) and that code is not counted; an unconditional forward branch skips to its
    target; NOPs are not counted. One Philox block is ten rounds of two
    multiplies by the round constants, of which the compiler hoists the
    first round's, drops those whose words A does not use and splits some
    into a low and a high half: 16 to 23 instructions remain per block in
    this kernel file (23 in K4's LtiObstacle<3>, <4> loops).
    A loop unrolled u times holds u blocks, 16·u to 23·u multiplies, so the
    count is divided by u = multiplies // 16 (at least 1), which is u itself
    for u ≤ 2 (none is unrolled in this build: every loop holds the MUFU
    instructions of one step or one draw; K1's per-rollout second pass draws
    two cells per lane, u = 2). Loops without them (shared-memory loads,
    partial writes, the shaping and summing loops of that pass) are left
    out."""
    ends: dict[int, int] = {}
    for a, ins in instrs:
        t = _branch_target(ins)
        if t is None or t >= a:
            continue
        body = [i for x, i in instrs if t <= x <= a]
        if not any(re.search(r"\b(EXIT|RET)\b", i) for i in body):
            ends[t] = max(ends.get(t, a), a)
    hot = [(s, e) for s, e in ends.items()
           if any(_PHILOX_MUL.search(i) for x, i in instrs if s <= x <= e)]
    inner = [(s, e) for s, e in hot if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                                                for s2, e2 in hot)]
    steps = []
    for s, e in sorted(inner):
        body = [(a, i) for a, i in instrs if s <= a <= e]
        mults = sum(bool(_PHILOX_MUL.search(i)) for _, i in body)
        if not mults:
            continue
        count, skip_to = 0, -1
        for a, ins in body:
            if a < skip_to or ins.startswith("NOP"):
                continue
            count += 1
            t = _branch_target(ins)
            if t is None or t <= a or t > e:
                continue
            if not ins.startswith("@"):
                skip_to = t
                continue
            region = [(x, i) for x, i in body if a < x < t]
            if any("CALL" in i or ((tt := _branch_target(i)) is not None and tt < x)
                   for x, i in region) and not any(_PHILOX_MUL.search(i) for _, i in region):
                skip_to = t
        steps.append(count / max(1, mults // 16))
    return steps


def obstacle_loop_step(instrs: list[tuple[int, str]]) -> float:
    """Instructions per obstacle per horizon step of `LtiObstacle<A>::cost`
    in a kernel's Philox loop. The obstacle count M arrives at run time, so
    the loop over the obstacles sits behind a forward branch (M < 1) that
    :func:`philox_loop_steps` skips as a slow path and leaves out. Here it is
    the loop nested in the Philox loop that holds float compares (FSETP, one
    per obstacle; the math slow paths nested there hold none): its body over
    its compares, since the compiler unrolls it (4× in this build)."""
    loops = [(t, a) for a, ins in instrs if (t := _branch_target(ins)) is not None and t < a]
    hot = [(s, e) for s, e in loops
           if any(_PHILOX_MUL.search(i) for x, i in instrs if s <= x <= e)]
    per = []
    for s, e in loops:
        if (s, e) in hot or not any(s2 < s and e <= e2 for s2, e2 in hot):
            continue
        body = [i for x, i in instrs if s <= x <= e and not i.startswith("NOP")]
        compares = sum(i.lstrip("@!P0123456 ").startswith("FSETP") for i in body)
        if compares:
            per.append(len(body) / compares)
    expect(bool(per), "no obstacle loop nested in the Philox loop")
    return min(per)


def library_steps(path, structs: dict[str, str] | None = None) -> dict[str, list[float]]:
    """{kernel_key: instructions per horizon step of each Philox loop} of
    the kernels of the library at `path` (`cuobjdump -sass`), the injected-ε
    instances left out; the obstacle family's loop over its M obstacles
    under obstacle_loop<...>. `structs` names a user family's struct (see
    :func:`kernel_key`)."""
    from mppi_gpu_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    kernels = {kernel_key(k, structs): v for k, v in sass_functions(sass).items()}
    steps = {k: s for k, v in kernels.items() if "inj=1" not in k and (s := philox_loop_steps(v))}
    for k, v in kernels.items():  # the obstacle family's loop over its M obstacles
        if k.startswith("rollout_costs<lti-obstacle,") and k.endswith("inj=0>"):
            steps[k.replace("rollout_costs", "obstacle_loop")] = [obstacle_loop_step(v)]
    return steps


def max_sm_clock() -> float:
    """The card's maximum SM clock in MHz (nvidia-smi)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


# one NVIDIA H100 SXM (NVIDIA's data sheet)
H100_SMS, H100_LANES, H100_BYTES_PER_S, H100_FP32_PER_S = 132, 128, 3.35e12, 67e12


def bound_ms(instructions: float, bytes_moved: float, clock_mhz: float) -> tuple[float, str]:
    """The least time the card could take for a kernel's work, and what
    bounds it: the larger of its thread instructions over 132 SMs × 128
    lanes × the SM clock ("operations") and its bytes over 3.35 TB/s
    ("bytes")."""
    t_ops = instructions / (H100_SMS * H100_LANES * clock_mhz * 1e6)
    t_bytes = bytes_moved / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def solve_bound(steps: dict, fam, K: int, T: int, clock_mhz: float, R: int = 1,
                pass2: bool = True, width: int | None = None,
                weighing: float = 1.0) -> tuple[float, str]:
    """:func:`bound_ms` of one Philox-mode launch of K1 (`pass2`) or K4 for
    R robots of family `fam`: the instructions per step its work needs × T
    × R·K threads, whichever body runs. K4's are the per-rollout body's
    loop (:func:`philox_loop_steps` of its SASS, `steps`): one draw, step
    and cost per rollout and step, in one loop the walker reads (the slab
    body splits the same work over two warps' loops). K1's are that same
    first pass plus the reduction that ΔU needs, A·(1 + 5 + 5) per rollout
    and step: the product e·ε and a five-level tree of adds and exchanges per
    action, for every rollout, or for the share `weighing` of them whose
    weight e_k is not 0 (the others add exact zeros; the per-rollout body
    sums only those). The per-rollout body's second noise draw is not counted: it is
    that body's choice (the slab body stores ε once and reads it back), not
    work the function needs. The obstacle family adds its M obstacles' loop
    (:func:`obstacle_loop_step`, under the key obstacle_loop<...> of
    `steps`) to every step. The bytes are x0, U, goal, the pack and S (K1
    also its partials, ceil(K / width) rows, `width` the rule's if None),
    each read or written once."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    A, S = fam.action_dim, fam.state_dim
    per_step = steps[f"rollout_costs<{fam.name},A={A},inj=0>"][0]
    if fam.name == "lti-obstacle":
        per_step += fam.cost.centers.shape[0] * steps[f"obstacle_loop<{fam.name},A={A},inj=0>"][0]
    floats = R * (S + T * A + (S if fam.has_goal else 0) + K) + fam.n_params
    if pass2:
        per_step += 11 * A * weighing
        width = fs.block_width(R, K, T, A, fam.name) if width is None else width
        floats += R * -(-K // width) * (2 + T * A)
    return bound_ms(per_step * T * R * K, 4 * floats, clock_mhz)


# instructions per horizon step of the loop from which K3's and K5's bounds
# count one draw, by A: K1's per-rollout second pass as nvcc built it for
# sm_90a when each thread walked its own rollout's horizon again (one Philox
# block, the Box-Muller pairs, shape_eps and a warp reduction of 11·A per
# step; philox_loop_steps of that build's SASS). Pinned, so that neither
# bound moves with K1's design
DRAW_LOOP_STEP = {1: 162.0, 2: 205.0, 3: 288.0, 4: 326.0}


def _draw_step(A: int) -> float:
    """Instructions per draw and step of DRAW_LOOP_STEP less its reduction
    (11·A): the draw and the shaping of A normals, all that K3 and K5 need
    besides their stores or multiply-adds."""
    return DRAW_LOOP_STEP[A] - 11 * A


def weighted_update_bound(K: int, T: int, A: int, clock_mhz: float,
                          antithetic: bool = False) -> tuple[float, str]:
    """:func:`bound_ms` of K5 in the Philox mode: per draw and step
    :func:`_draw_step` plus one multiply-add w·ε per action, which is all
    that ΔU = Σ w·ε needs, over its draws (K/2 under antithetic: the mirrors
    are weighed in, not drawn); bytes w, σ and the (T, A) result."""
    n = K // 2 if antithetic else K
    per = _draw_step(A) + A
    return bound_ms(per * T * n, 4 * (K + A + T * A), clock_mhz)


def noise_dump_bound(K: int, T: int, A: int, clock_mhz: float,
                     antithetic: bool = False, words: bool = False) -> tuple[float, str]:
    """:func:`bound_ms` of K3: per draw and step :func:`_draw_step` plus A
    stores of ε (2·A under antithetic, the mirror too) and 4 of the words
    when they are written; bytes σ, ε (T, K, A) and the words (T, K_draw,
    4)."""
    K_draw = K // 2 if antithetic else K
    per = _draw_step(A) + A * (2 if antithetic else 1) + (4 if words else 0)
    return bound_ms(per * T * K_draw, 4 * (A + T * K * A) + (16 * T * K_draw if words else 0),
                    clock_mhz)


def combine_bound(nb: int, T: int, A: int, R: int = 1) -> tuple[float, str]:
    """:func:`bound_ms` of K2: R·nb·(2 + T·A) partial floats read and
    R·(2 + T·A) written; ~2 float operations per partial float (a
    multiply-add), over the float32 peak (67 TFLOP/s) in place of the
    instruction count."""
    floats = R * (nb + 1) * (2 + T * A)
    return max(2 * floats / H100_FP32_PER_S, 4 * floats / H100_BYTES_PER_S) * 1e3, (
        "operations" if 2 / H100_FP32_PER_S > 4 / H100_BYTES_PER_S else "bytes")


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


def check_oracle(name: str, p: dict, got, beta_rtol: float = TOL["beta"]) -> None:
    """An injected-ε solve core (S, β, η, ΔU) and its controller result
    against the float64 oracle (tests/oracle.py) on the same inputs."""
    n = p["np"]
    S_o, _, action_o, shift_o, _, beta_o, eta_o = _oracle().oracle_solve(
        n["x0"], n["U"], n["eps"], p["dt"], n["w"], n["goal"], p["lam_cost"], n["inv_s"],
        max_a=np.ones(p["A"]),
    )
    rel = np.abs(_np(got[0]) - S_o) / np.abs(S_o)
    expect(rel.max() < TOL["S_rel"], f"{name}: worst S relative error {rel.max():.2e}")
    close(f"{name} beta", _np(got[1]), beta_o, beta_rtol)
    close(f"{name} eta", _np(got[2]), eta_o, TOL["eta"])
    res = finish(p, *got)
    close(f"{name} action", _np(res.action), action_o, **TOL["u"])
    close(f"{name} u_next", _np(res.u_next), shift_o, **TOL["u"])


def check_injected(A: int, K: int, T: int, device: str = "cuda") -> dict:
    """K1 + K2 in the injected-ε mode against the plain version on the card
    and against the float64 oracle (tests/oracle.py)."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    p = make_problem(A, K, T, device=device)
    got = fs.fused_solve(*solve_args(p, eps=p["eps"]))
    want = fs.fused_solve_reference(*solve_args(p, eps=p["eps"]))
    errs = compare_solves(f"injected A={A} K={K} T={T} vs plain", p, got, want, S_rtol=1e-5)
    check_oracle(f"injected A={A} K={K} T={T} vs oracle", p, got)
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
    return dict(solve_partials=e1, softmin_combine=e2)


def check_dump_replay(A: int, K: int, T: int, *, antithetic=False, ou_beta=0.0, k0: int = 0,
                      lams=(None,), device: str = "cuda") -> dict:
    """K3's words equal ops/philox.py's bit for bit, and its ε the plain
    stream on the same device bit for bit, drawn from counter word k0 on;
    the injected-ε solve on the dump equals the Philox-mode solve exactly
    (replay): on the card in each of K1's bodies that fits the shape (the
    slab body while its slab fits in shared memory), on the CPU the plain
    version; at each softmin λ of `lams` (None: the problem's; "mid":
    :func:`middle_lam` of its S), each returned with the share of rollouts
    that weigh at width BLOCK."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    p = make_problem(A, K, T, device=device)
    seed, step, it = 11, 5, 1
    name = f"dump A={A} K={K} T={T} anti={antithetic} ou={ou_beta} k0={k0}"
    eps, words = fs.noise_dump(p["sigma"], T, K, seed, step, it, antithetic, ou_beta, words=True,
                               k0=k0)
    K_draw = K // 2 if antithetic else K
    words_r = philox.philox_words(seed, step, it, T, K_draw, p["sigma"].device, k0)
    expect(torch.equal(words, words_r), f"{name}: Philox words differ from ops/philox.py")
    eps_r = philox.sample_eps(seed, step, it, T, K, p["sigma"], antithetic=antithetic,
                              ou_beta=ou_beta, k0=k0)
    err = close(f"{name} eps", _np(eps), _np(eps_r), 1e-6, 1e-6)
    bit_equal = bool(torch.equal(eps.view(torch.int32), eps_r.view(torch.int32)))
    expect(bit_equal, f"{name}: eps differs from the plain stream's bits")
    fam = fs.lti_family(p["sigma"], p["inv_s"], p["w"], p["dt"], p["lam_cost"])
    S0, _ = fs.family_solve_partials(fam, p["x0"], p["U"], p["goal"], p["lam"], K, seed, step, it,
                                     antithetic, ou_beta, None, k0)
    widths = [None] if device == "cpu" else [fs.BLOCK] + (
        [fs.SLAB_WIDTH] if fs.slab_bytes(T, A) <= fs._SMEM_BYTES else [])
    replays = []
    for lam in lams:
        lam = p["lam"] if lam is None else middle_lam(S0, fs.BLOCK) if lam == "mid" else lam
        args = (fam, p["x0"], p["U"], p["goal"], lam, K, seed, step, it, antithetic, ou_beta)
        for width in widths:
            def solve(e_in):
                if width is None:
                    S, part = fs.family_solve_partials(*args, e_in, k0)
                else:
                    S, part = fs._launch_solve_partials(*args, e_in, 1, (), k0, width)
                return (S, part, *fs.softmin_combine(part, lam, T, A))

            for label, a, b in zip(("S", "partials", "beta", "eta", "dU"), solve(None), solve(eps)):
                expect(torch.equal(a, b), f"{name} lambda={lam:.4g} width {width}: replay {label} "
                       "differs from the Philox-mode solve")
        replays.append((lam, weighing_share(S0, lam, fs.BLOCK)))
    return dict(noise_dump=err, eps_bit_identical=bit_equal, widths=widths, replays=replays)


# K3's and K5's shapes on the card (A, K, T, antithetic, OU β, k0): the
# main path's A=3 K=10⁴ T=200 in every noise mode and at a draw offset k0 =
# 3K; K past every block width (10⁴ + 17; 10⁴ + 34 under antithetic, so
# K_draw = 5017 is odd too) at T = 53, past every step tile; T = 1000, past
# the slab's shared memory; the point_mass2d shape under OU
DRAW_CASES = (
    (3, 10_000, 200, False, 0.0, 0), (3, 10_000, 200, True, 0.0, 0),
    (3, 10_000, 200, False, 0.5, 0), (3, 10_000, 200, False, 0.0, 30_000),
    (3, 10_017, 53, False, 0.0, 0), (3, 10_017, 53, False, 0.5, 0),
    (3, 10_034, 53, True, 0.0, 0), (3, 10_034, 53, True, 0.5, 30_102),
    (3, 10_000, 1000, False, 0.0, 0), (3, 10_000, 1000, False, 0.5, 0),
    (3, 10_034, 1000, True, 0.5, 0), (2, 3000, 50, False, 0.5, 0),
)


# the DRAW_CASES whose replay phase 4 also checks at each λ of WEIGH_LAMS:
# the main path's shape; T = 53 past the block under OU and antithetic with
# an odd K_draw; T = 1000 under OU and antithetic OU
WEIGH_DRAW_CASES = tuple(DRAW_CASES[i] for i in (0, 5, 6, 9, 10))


def check_edge_cases(device: str = "cuda") -> None:
    """K not a multiple of the block; one block of diverged rollouts among
    finite ones; every rollout diverged (NaN action, guard fires)."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    check_kernels(3, 1000, 50, device=device)
    p = make_problem(2, 1000, 50, device=device)
    W = fs.block_width(1, 1000, 50, 2, "lti")
    blk = np.s_[W:2 * W]  # block 1 at the rule's width
    eps = p["eps"].clone()
    eps[:, blk, :] = 1e30  # block 1 diverges: S = +inf
    got = fs.fused_solve(*solve_args(p, eps=eps))
    want = fs.fused_solve_reference(*solve_args(p, eps=eps))
    compare_solves("one diverged block", p, got, want, S_rtol=1e-5)
    S = _np(got[0])
    expect(np.isinf(S[blk]).all() and np.isfinite(np.delete(S, blk)).all(),
           "one diverged block: expected +inf exactly on block 1")
    res = finish(p, *got)
    expect(bool((res.info.weights[blk] == 0).all()), "diverged rollouts got weight")
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
# fleet checks (also called by tests/test_torch_fleet.py on the card)


def make_fleet(A: int, R: int, K: int, T: int, seed: int = 0, device: str = "cuda") -> dict:
    """R point-mass problems with make_problem's shared widths (σ, Σ⁻¹, w, dt,
    λ) and per-robot x0, U, goal and injected noise, all from `seed`."""
    import torch

    p = make_problem(A, 1, T, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    xs = np.concatenate([rng.uniform(-0.2, 0.2, (R, A)), rng.uniform(-0.1, 0.1, (R, A))], 1)
    phase = rng.uniform(0.0, 2 * np.pi, (R, 1))
    Us = 0.2 * np.sin(0.05 * np.arange(T * A)[None] + phase).reshape(R, T, A)
    goals = np.tile(p["np"]["goal"], (R, 1))
    goals[:, :A] += rng.uniform(-0.3, 0.3, (R, A))
    eps = np.empty((R, T, K, A), np.float32)
    for r in range(R):
        eps[r] = rng.standard_normal((T, K, A), np.float32) * p["np"]["sigma"]
    fleet = dict(xs=xs.astype(np.float32), Us=Us.astype(np.float32),
                 goals=goals.astype(np.float32), eps=eps)
    p.update({k: torch.as_tensor(v, device=device) for k, v in fleet.items()})
    p["np"].update(fleet)
    p.update(K=K, R=R)
    return p


def fleet_args(p: dict, *, seeds=7, step=3, it=0, antithetic=False, ou_beta=0.0, eps=None):
    return (
        p["xs"], p["Us"], p["sigma"], p["inv_s"], p["w"], p["goals"], p["lam_cost"],
        p["lam"], p["dt"], p["K"], seeds, step, it, antithetic, ou_beta, eps,
    )


def robot(p: dict, r: int) -> dict:
    """Robot r of a make_fleet problem as a make_problem one (views)."""
    n = p["np"]
    q = dict(p, x0=p["xs"][r], U=p["Us"][r], goal=p["goals"][r], eps=p["eps"][r])
    q["np"] = dict(n, x0=n["xs"][r], U=n["Us"][r], goal=n["goals"][r], eps=n["eps"][r])
    return q


def solo_at_width(fam, x0, U, goal, lam, K: int, seed: int, step: int, it: int, antithetic,
                  ou_beta, width: int):
    """One robot's solve core (S, β, η, ΔU): K1 at block width `width` (the
    launcher's private width) and K2. A fleet robot's solo twin runs at the
    fleet's width: a fleet past block_width's crossover runs the per-rollout
    body where one robot alone runs the slab body. On CPU tensors, the plain
    version at that width."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    if x0.device.type != "cuda":
        return fs.family_fused_solve_reference(fam, x0, U, goal, lam, K, int(seed), step, it,
                                               antithetic, ou_beta, width=width)
    S, part = fs._launch_solve_partials(fam, x0, U, goal, lam, K, int(seed), step, it, antithetic,
                                        ou_beta, None, 1, (), width=width)
    return (S, *fs.softmin_combine(part, lam, *U.shape))


def check_fleet_injected(A: int, R: int, K: int, T: int, device: str = "cuda") -> dict:
    """The fleet's K1 + K2 (one launch each) in the injected-ε mode against
    the plain fleet on the card and, robot by robot, against the float64
    oracle."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    p = make_fleet(A, R, K, T, device=device)
    got = fs.fleet_fused_solve(*fleet_args(p, eps=p["eps"]))
    want = fs.fleet_fused_solve_reference(*fleet_args(p, eps=p["eps"]))
    errs: dict = {}
    for r in range(R):
        name = f"fleet injected A={A} R={R} K={K} T={T} robot {r}"
        e = compare_solves(f"{name} vs plain", robot(p, r), [v[r] for v in got],
                           [v[r] for v in want], S_rtol=1e-5)
        check_oracle(f"{name} vs oracle", robot(p, r), [v[r] for v in got],
                     beta_rtol=FLEET_ORACLE_BETA_RTOL)
        errs = {k: max(errs.get(k, 0.0), v) for k, v in e.items()}
    return errs


def check_fleet_philox(A: int, R: int, K: int, T: int, *, antithetic=False, ou_beta=0.0,
                       device: str = "cuda") -> dict:
    """Philox mode, per-robot seeds (ops/philox.fleet_seeds): the fleet's K1
    and K2 against their plain versions, and every robot's (S, β, η, ΔU)
    bit-equal to the R = 1 launch with its seed, x0, U and goal at the
    fleet's block width (:func:`solo_at_width`)."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    p = make_fleet(A, R, K, T, device=device)
    fam = fs.lti_family(p["sigma"], p["inv_s"], p["w"], p["dt"], p["lam_cost"])
    width = fs.block_width(R, K, T, A, fam.name)
    seeds = philox.fleet_seeds(7, R).to(device)
    args = fleet_args(p, seeds=seeds, step=3, it=1, antithetic=antithetic, ou_beta=ou_beta)
    name = f"fleet philox A={A} R={R} K={K} T={T} anti={antithetic} ou={ou_beta}"
    S, part = fs.fleet_solve_partials(*args)
    S_r, part_r = fs.fleet_solve_partials_reference(*args)
    e1 = close(f"{name} K1 S", _np(S), _np(S_r), 1e-5)
    close(f"{name} K1 beta_b", _np(part[..., 0]), _np(part_r[..., 0]), 1e-5)
    close(f"{name} K1 eta_b", _np(part[..., 1]), _np(part_r[..., 1]), TOL["eta"])
    scale = float(part_r[..., 2:].abs().max())
    close(f"{name} K1 dU_b", _np(part[..., 2:]), _np(part_r[..., 2:]), TOL["dU"]["rtol"],
          TOL["dU"]["atol"] * max(scale, 1.0))
    b, e, dU = fs.fleet_softmin_combine(part, p["lam"], T, A)
    b_r, e_r, dU_r = fs.fleet_softmin_combine_reference(part, p["lam"], T, A)
    close(f"{name} K2 beta", _np(b), _np(b_r), 1e-7)
    close(f"{name} K2 eta", _np(e), _np(e_r), 1e-5)
    e2 = close(f"{name} K2 dU", _np(dU), _np(dU_r), 1e-4, 1e-6)
    fleet = fs.fleet_fused_solve(*args)
    for r, seed in enumerate(seeds.tolist()):
        q = robot(p, r)
        solo = solo_at_width(fam, q["x0"], q["U"], q["goal"], p["lam"], K, seed, 3, 1, antithetic,
                             ou_beta, width)
        for label, a, want in zip(("S", "beta", "eta", "dU"), (v[r] for v in fleet), solo):
            expect(torch.equal(a, want), f"{name} robot {r}: {label} differs from its solo solve "
                   f"at width {width}")
    return dict(solve_partials=e1, softmin_combine=e2)


def check_fleet_diverged(K: int = 1000, T: int = 50, device: str = "cuda") -> None:
    """One robot whose every rollout diverges (its goal at 1e30: every state
    cost is +inf): its β is +inf and its action NaN, while the other robots
    stay finite and equal to their solo solves."""
    import torch

    from mppi_gpu_tpu_torch.controller import _finish_fused
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    R, bad = 4, 1
    p = make_fleet(2, R, K, T, device=device)
    p["goals"][bad] = 1e30
    seeds = philox.fleet_seeds(3, R).to(device)
    args = fleet_args(p, seeds=seeds)
    fam = fs.lti_family(p["sigma"], p["inv_s"], p["w"], p["dt"], p["lam_cost"])
    width = fs.block_width(R, K, T, 2, fam.name)
    S, beta, eta, dU = fs.fleet_fused_solve(*args)
    res = _finish_fused(p["Us"], dU, S, beta, eta, p["lam"], p["max_a"], True)
    expect(bool(torch.isinf(S[bad]).all()) and float(beta[bad]) == float("inf"),
           "diverged robot: expected S = β = +inf")
    expect(bool(torch.isnan(res.action[bad]).all()), "diverged robot: action is not NaN")
    for r, seed in enumerate(seeds.tolist()):
        if r == bad:
            continue
        expect(bool(torch.isfinite(res.action[r]).all()), f"robot {r}: action not finite")
        q = robot(p, r)
        solo = solo_at_width(fam, q["x0"], q["U"], q["goal"], p["lam"], K, seed, 3, 0, False, 0.0,
                             width)
        for label, a, want in zip(("S", "beta", "eta", "dU"), (S[r], beta[r], eta[r], dU[r]), solo):
            expect(torch.equal(a, want), f"robot {r} beside a diverged robot: {label} differs")


# ---------------------------------------------------------------------------
# family checks: K1's pendulum and cart-pole instances (also called by
# tests/test_torch_families.py on the card)

# a live start of each task (tests/test_pallas.py::_setup_pendulum,
# _setup_cartpole; the worlds' starts of the coupled families, envs/*_world.py)
FAMILY_START = {
    "pendulum": (np.pi - 0.3, 0.4), "cartpole": (0.1, 0.25, -0.05, 0.3),
    "unicycle": (0.0, 0.0, 0.0), "quadrotor": (-1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    "arm": (-1.5707963, 0.0, 0.0, 0.0),
    "obstacle2d": (0.0,) * 4, "obstacle3d": (0.0,) * 6,
    "quadrotor3d": (-1.0, 0.0, 0.5, 1.0) + (0.0,) * 9,
    "bicycle": (0.1, -0.2, 0.3, 0.5),  # tests/test_custom_family.py::_setup
}
# K1 + K2 against the plain float64 version on the CPU: no further from it
# than the plain float32 version is, by a factor 2 plus this share of the
# quantity's magnitude. A fixed tolerance cannot hold here: f32 rollouts of
# the cart-pole over T = 200 (6 s about an unstable equilibrium) carry up to
# 6 % relative error in S against float64, the plain version's included
# (median 6e-7; 1e-7 at the config shapes).
F64_RTOL = 1e-5


def family_sequence(cfg, T: int, phase=0.0) -> np.ndarray:
    """A live nominal sequence (T, A) (or (R, T, A) for phases (R, 1)): the
    config's init-act plus 0.3·max-a·sin(0.2 t + phase + a) per action a."""
    t = np.arange(T)[:, None] + 0 * np.arange(cfg.action_dim)
    a = np.arange(cfg.action_dim)
    wave = np.sin(0.2 * t + a + np.asarray(phase)[..., None])
    return (np.asarray(cfg.init_act) + 0.3 * np.asarray(cfg.max_a) * wave).astype(np.float32)


def make_family_problem(name: str, K: int, T: int, seed: int = 0, device: str = "cuda") -> dict:
    """configs/<name>.yaml's model, cost, goal and σ as a fused family at K,
    T, a live start near the task's, a nominal sequence and injected noise,
    all from `seed`."""
    import torch

    from mppi_gpu_tpu_torch.models import dynamics_for_config
    from mppi_gpu_tpu_torch.ops import families
    from mppi_gpu_tpu_torch.ops.cost import make_cost

    cfg = _config(name).replace(samples=K, horizon=T)
    rng = np.random.default_rng(seed)
    start = np.asarray(FAMILY_START[name])
    x0 = (start + rng.uniform(-0.05, 0.05, start.shape)).astype(np.float32)
    U = family_sequence(cfg, T)
    eps = (rng.standard_normal((T, K, cfg.action_dim)) * np.asarray(cfg.noise)).astype(np.float32)
    if name == "bicycle":  # the family registered from user code
        from mppi_gpu_tpu_torch.examples.custom_family import bicycle_pair

        pair = bicycle_pair(cfg, device)
    else:
        pair = dynamics_for_config(cfg, device), make_cost(cfg, device)
    fam = families.family_for(*pair, torch.tensor(cfg.noise, dtype=torch.float32, device=device))
    arrays = dict(x0=x0, U=U, eps=eps)
    if fam.has_goal:
        arrays["goal"] = np.asarray(cfg.goal, np.float32)
    p = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    p.setdefault("goal", None)
    p.update(np=arrays, name=name, cfg=cfg, fam=fam, K=K, T=T, A=cfg.action_dim, lam=cfg.lambda_,
             max_a=torch.tensor(cfg.max_a, dtype=torch.float32, device=device))
    return p


def family_args(p: dict, *, seed=7, step=3, it=0, antithetic=False, ou_beta=0.0):
    return (p["fam"], p["x0"], p["U"], p["goal"], p["lam"], p["K"], seed, step, it, antithetic,
            ou_beta)


def _float64_family(fam):
    """`fam` with its eager model, cost and σ in float64 on the CPU."""
    import dataclasses

    import torch

    def f64(obj):  # every tensor field, those of a nested cost (a base) too
        return dataclasses.replace(obj, **{
            f.name: v.to("cpu", torch.float64) if isinstance(v, torch.Tensor) else f64(v)
            for f in dataclasses.fields(obj)
            if isinstance(v := getattr(obj, f.name), torch.Tensor) or dataclasses.is_dataclass(v)
        })

    return dataclasses.replace(fam, dynamics=f64(fam.dynamics), cost=f64(fam.cost),
                               sigma=fam.sigma.to("cpu", torch.float64))


def check_float64(name: str, p: dict, got, plain) -> dict:
    """An injected-ε solve core (S, β, η, ΔU) of K1 + K2 (`got`) and of the
    plain float32 version (`plain`) against the plain version in float64 on
    the CPU on the same inputs (F64_RTOL). Returns K1's relative S errors."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    n = p["np"]
    f64 = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in n.items()}
    ref = fs.family_fused_solve_reference(
        _float64_family(p["fam"]), f64["x0"], f64["U"], f64.get("goal"), p["lam"], p["K"], 0, 0, 0,
        False, 0.0, eps=f64["eps"])
    out = {}
    for label, g, pl, r in zip(("S", "beta", "eta", "dU"), got, plain, ref):
        g, pl, r = (_np(v).astype(np.float64) for v in (g, pl, r))
        expect(np.isfinite(g).all() and np.isfinite(r).all(), f"{name} {label}: not finite")
        eg, ep = np.abs(g - r), np.abs(pl - r)
        if label == "S":
            qg, qp = (np.quantile(e / np.abs(r), [0.5, 0.99, 1.0]) for e in (eg, ep))
            expect(bool(np.all(qg <= 2 * qp + F64_RTOL)),
                   f"{name} S vs float64: K1 relative error quantiles {qg}, plain f32 {qp}")
            out.update(S_rel_median=float(qg[0]), S_rel_p99=float(qg[1]), S_rel_max=float(qg[2]),
                       plain_S_rel_max=float(qp[2]))
        else:
            bad = eg > 2 * ep + F64_RTOL * max(float(np.abs(r).max()), 1e-30)
            expect(not bad.any(), f"{name} {label} vs float64: max err {eg.max():.3g}, plain f32 {ep.max():.3g}")
    return out


def check_family_injected(name: str, K: int, T: int, device: str = "cuda") -> dict:
    """K1's `name` instance + K2 in the injected-ε mode against the plain
    version on the same device and against the plain version in float64
    on the CPU."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    p = make_family_problem(name, K, T, device=device)
    got = fs.family_fused_solve(*family_args(p), eps=p["eps"])
    want = fs.family_fused_solve_reference(*family_args(p), eps=p["eps"])
    label = f"{name} injected K={K} T={T}"
    errs = compare_solves(f"{label} vs plain", p, got, want, S_rtol=1e-5)
    errs.update(check_float64(f"{label} vs float64", p, got, want))
    return errs


def check_family_philox(name: str, K: int, T: int, *, antithetic=False, ou_beta=0.0,
                        device: str = "cuda") -> dict:
    """Philox mode: K1's `name` instance against its plain version, K2 on its
    partials against K2's plain version, the whole solve against the plain
    solve; then K3's dump replayed through the injected-ε mode equals the
    Philox-mode solve exactly. K1's per-block partials are held against the
    plain partials of K1's own S on that ε: a block's softmin at λ = 0.2 and
    S ≈ 3·10³ (the pendulum at T = 200) turns the last-ulp differences of S
    (K1's Kahan sum against torch.sum) into 0.25 % of a weight, so S is held
    to the plain S on its own."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    p = make_family_problem(name, K, T, device=device)
    args = family_args(p, step=3, it=1, antithetic=antithetic, ou_beta=ou_beta)
    label = f"{name} philox K={K} T={T} anti={antithetic} ou={ou_beta}"
    S, part = fs.family_solve_partials(*args)
    S_r, _ = fs.family_solve_partials_reference(*args)
    e1 = close(f"{label} K1 S", _np(S), _np(S_r), 1e-5)
    eps = fs.noise_dump(p["fam"].sigma, T, K, 7, 3, 1, antithetic, ou_beta)
    own = fs.block_partials(S, eps, p["lam"])
    close(f"{label} K1 beta_b", _np(part[:, 0]), _np(own[:, 0]), 0.0)
    close(f"{label} K1 eta_b", _np(part[:, 1]), _np(own[:, 1]), TOL["eta"])
    scale = float(own[:, 2:].abs().max())
    close(f"{label} K1 dU_b", _np(part[:, 2:]), _np(own[:, 2:]), TOL["dU"]["rtol"],
          TOL["dU"]["atol"] * max(scale, 1.0))
    b, e, dU = fs.softmin_combine(part, p["lam"], T, p["A"])
    b_r, e_r, dU_r = fs.softmin_combine_reference(part, p["lam"], T, p["A"])
    close(f"{label} K2 beta", _np(b), _np(b_r), 1e-7)
    close(f"{label} K2 eta", _np(e), _np(e_r), 1e-5)
    e2 = close(f"{label} K2 dU", _np(dU), _np(dU_r), 1e-4, 1e-6)
    live = fs.family_fused_solve(*args)
    compare_solves(label, p, live, fs.family_fused_solve_reference(*args), S_rtol=1e-5)
    replay = fs.family_fused_solve(*args, eps=eps)
    for what, a, r in zip(("S", "beta", "eta", "dU"), live, replay):
        expect(torch.equal(a, r), f"{label}: replay {what} differs from the Philox-mode solve")
    return dict(solve_partials=e1, softmin_combine=e2)


def check_family_fleet(name: str, R: int, K: int, T: int, device: str = "cuda") -> dict:
    """A fleet of R robots of family `name` (per-robot x0, U, seed and, for a
    family with a goal, distinct goals) in one launch of K1 and K2: against
    the plain fleet, and every robot's (S, β, η, ΔU) bit-equal to its R = 1
    launch."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    p = make_family_problem(name, K, T, device=device)
    rng = np.random.default_rng(R)
    S_dim = p["fam"].state_dim
    xs = torch.as_tensor((p["np"]["x0"] + rng.uniform(-0.1, 0.1, (R, S_dim))).astype(np.float32),
                         device=device)
    phase = rng.uniform(0.0, 2 * np.pi, (R, 1))
    Us = torch.as_tensor(family_sequence(p["cfg"], T, phase), device=device)
    goals = None
    if p["fam"].has_goal:
        g = np.tile(p["np"]["goal"], (R, 1))
        g[:, :2] += rng.uniform(-0.3, 0.3, (R, 2))
        goals = torch.as_tensor(g, device=device)
    seeds = philox.fleet_seeds(7, R).to(device)
    args = (p["fam"], xs, Us, goals, p["lam"], K, seeds, 3, 1, False, 0.0)
    label = f"{name} fleet philox R={R} K={K} T={T}"
    S, part = fs.fleet_family_solve_partials(*args)
    S_r, _ = fs.fleet_family_solve_partials_reference(*args)
    e1 = close(f"{label} K1 S", _np(S), _np(S_r), 1e-5)
    fleet = fs.fleet_family_fused_solve(*args)
    width = fs.block_width(R, K, T, p["A"], p["fam"].name)
    for r, seed in enumerate(seeds.tolist()):
        solo = solo_at_width(p["fam"], xs[r], Us[r], None if goals is None else goals[r], p["lam"],
                             K, seed, 3, 1, False, 0.0, width)
        for what, a, want in zip(("S", "beta", "eta", "dU"), (v[r] for v in fleet), solo):
            expect(torch.equal(a, want), f"{label} robot {r}: {what} differs from its solo solve "
                   f"at width {width}")
    return dict(solve_partials=e1)


def check_family_diverged(device: str = "cuda") -> None:
    """Diverging rollouts on K1's family instances, against the plain version:
    a pendulum block driven by ε = 1e30 costs +inf (θ̇² overflows) and gets
    weight 0 while the others solve as before; a cart-pole from θ̇ = 1e4
    overflows into inf − inf in every rollout, so S and β are NaN, the
    action is NaN and the guard fires, on the fused and the eager backend
    alike; a cart-pole from the fast-spinning state of
    tests/test_pallas.py::test_taylor_delta_extreme_state_stays_finite
    (θ̇ = 40) stays finite and matches the plain version."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    p = make_family_problem("pendulum", 1000, 50, device=device)
    eps = p["eps"].clone()
    W = fs.block_width(1, 1000, 50, 1, "pendulum")
    blk = np.s_[W:2 * W]
    eps[:, blk] = 1e30
    got = fs.family_fused_solve(*family_args(p), eps=eps)
    want = fs.family_fused_solve_reference(*family_args(p), eps=eps)
    compare_solves("pendulum one diverged block", p, got, want, S_rtol=1e-5)
    S = _np(got[0])
    expect(np.isposinf(S[blk]).all() and np.isfinite(np.delete(S, blk)).all(),
           "pendulum one diverged block: expected +inf exactly on block 1")
    res = finish(p, *got)
    expect(bool((res.info.weights[blk] == 0).all()), "pendulum: diverged rollouts got weight")
    expect(bool(torch.isfinite(res.action).all()), "pendulum one diverged block: action not finite")

    cfg = _config("cartpole").replace(samples=1000, horizon=40)
    for backend in ("auto", "eager"):
        ctrl = MPPIController(cfg, device=device, rollout_backend=backend)
        res = ctrl.solve_auto(torch.tensor([0.0, 0.0, 0.0, 1e4]), ctrl.init_action_seq(), 0)
        info = res.info.cpu()
        expect(bool(torch.isnan(info.costs).all() and torch.isnan(info.beta)),
               f"cartpole from thd=1e4 ({ctrl.rollout_backend}): S and beta are not all NaN")
        try:
            check_solve(0, _np(res.action), info)
        except ControllerDiverged:
            continue
        raise SmokeFailure(f"cartpole from thd=1e4 ({ctrl.rollout_backend}): the guard did not fire")

    p = make_family_problem("cartpole", 1000, 30, device=device)
    p["x0"] = torch.tensor([0.0, 3.0, 0.0, 40.0], device=device)
    p["U"] = torch.zeros(30, 1, device=device)
    args = family_args(p, seed=2)
    got = fs.family_fused_solve(*args)
    expect(bool(torch.isfinite(got[0]).all()), "cartpole from thd=40: S not finite")
    compare_solves("cartpole from thd=40", p, got, fs.family_fused_solve_reference(*args),
                   S_rtol=1e-5)


def check_nan_guard(name: str, x0, label: str, device: str = "cuda") -> None:
    """From start `x0` every rollout of family `name` turns NaN: S and β are
    NaN, the action is NaN and the guard fires, on the fused (on a CUDA
    device; the plain version on the CPU) and the eager backend alike."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    cfg = _config(name).replace(samples=1000, horizon=40)
    for backend in ("auto", "eager"):
        ctrl = MPPIController(cfg, device=device, rollout_backend=backend)
        res = ctrl.solve_auto(torch.tensor(x0), ctrl.init_action_seq(), 0)
        info = res.info.cpu()
        expect(bool(torch.isnan(info.costs).all() and torch.isnan(info.beta)),
               f"{name} {label} ({ctrl.rollout_backend}): S and beta are not all NaN")
        try:
            check_solve(0, _np(res.action), info)
        except ControllerDiverged:
            continue
        raise SmokeFailure(f"{name} {label} ({ctrl.rollout_backend}): the guard did not fire")


def check_coupled_diverged(name: str, device: str = "cuda") -> str:
    """Diverging rollouts on K1's unicycle, quadrotor, arm, obstacle and 3-D
    quadrotor instances, against the plain version. All but the arm: a block
    driven by ε = 1e30 (the 3-D quadrotor's on its thrust alone: 1e30 on its
    torques would spin the quaternion past float range into inf·0 = NaN)
    diverges (+inf S, weight 0) while the others solve as before. Arm: its
    joint-rate saturation holds any torque to finite rates, so it starts
    instead from rates of 1e20 at q2 = 0, where B·sin q2 · q̇² is 0 · inf =
    NaN; the saturation keeps that NaN (torch.clamp does, fminf would not).
    The 3-D quadrotor also starts from a zero quaternion, which stays zero,
    so the renormalisation takes rsqrtf(0) = inf and the state turns NaN. In
    both NaN cases every rollout costs NaN, β and the action are NaN and the
    guard fires, on the fused and the eager backend alike (check_nan_guard).
    Returns what happened."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    if name == "arm":
        check_nan_guard("arm", [0.0, 0.0, 1e20, 1e20], "from rates 1e20", device)
        return "from rates 1e20 -> NaN S and beta, NaN action, ControllerDiverged (fused and eager)"
    p = make_family_problem(name, 1000, 50, device=device)
    eps = p["eps"].clone()
    W = fs.block_width(1, 1000, 50, p["A"], p["fam"].name)
    blk = np.s_[W:2 * W]
    eps[:, blk, 0 if name == "quadrotor3d" else slice(None)] = 1e30
    got = fs.family_fused_solve(*family_args(p), eps=eps)
    want = fs.family_fused_solve_reference(*family_args(p), eps=eps)
    compare_solves(f"{name} one diverged block", p, got, want, S_rtol=1e-5)
    S = _np(got[0])
    expect(np.isposinf(S[blk]).all() and np.isfinite(np.delete(S, blk)).all(),
           f"{name} one diverged block: expected +inf exactly on block 1")
    res = finish(p, *got)
    expect(bool((res.info.weights[blk] == 0).all()), f"{name}: diverged rollouts got weight")
    expect(bool(torch.isfinite(res.action).all()), f"{name} one diverged block: action not finite")
    out = "a block at eps=1e30 -> +inf, weight 0, the rest as plain"
    if name == "quadrotor3d":
        check_nan_guard(name, [0.0] * 13, "from a zero quaternion", device)
        out += ("; from a zero quaternion -> rsqrtf(0) = inf, NaN S and beta, NaN action, "
                "ControllerDiverged (fused and eager)")
    return out


def check_reassigned_cost(device: str = "cuda") -> str:
    """The controller's pack follows a reassigned cost: after
    ``ctrl.cost = dataclasses.replace(ctrl.cost, w=...)`` (the 3-D
    quadrotor's tour weights of examples/quadrotor3d_flight.py; the obstacle
    cost's base weights and penalty) the fused solve (K1 + K2 on a CUDA
    device) equals the eager solve with the new cost on the same ε, and
    differs from the solve with the old weights."""
    import dataclasses

    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController

    out = []
    for name in ("quadrotor3d", "obstacle2d"):
        cfg = _config(name).replace(samples=2048, horizon=30)
        fused = MPPIController(cfg, device=device, rollout_backend="auto")
        eager = MPPIController(cfg, device=device, rollout_backend="eager")
        x = torch.tensor(FAMILY_START[name], dtype=torch.float32, device=device)
        U = fused.init_action_seq()
        eps = fused._eps(5, 0, 0)
        before = fused.solve_with_eps(x, U, eps)
        c = fused.cost
        if name == "quadrotor3d":
            new = dataclasses.replace(c, w=torch.tensor([4.0, 4.0, 4.0, 10.0, 1.2, 1.2, 1.2, 0.5],
                                                        device=c.w.device))
        else:
            new = dataclasses.replace(c, base=dataclasses.replace(c.base, w=c.base.w * 3.0),
                                      penalty=c.penalty * 2.0)
        fused.cost = eager.cost = new
        got, want = fused.solve_with_eps(x, U, eps), eager.solve_with_eps(x, U, eps)
        label = f"{name} after a cost reassignment ({fused.rollout_backend} vs eager)"
        close(f"{label} S", _np(got.info.costs), _np(want.info.costs), 1e-5)
        close(f"{label} action", _np(got.action), _np(want.action), **TOL["u"])
        expect(not torch.equal(got.info.costs, before.info.costs), f"{label}: S did not move")
        out.append(name)
    return f"{', '.join(out)}: the fused solve after `ctrl.cost = replace(ctrl.cost, w=...)` equals the eager one"


def check_costs_only(name: str, K: int, T: int, *, A: int | None = None, antithetic=False,
                     ou_beta=0.0, device: str = "cuda") -> dict:
    """K4 (the costs-only sweep) of family `name` (an lti `A` for the point
    mass) in Philox mode: its S equal to K1's S for the same inputs, bit for
    bit, and to the plain version within 1e-5; the fleet form's robots equal
    to their R = 1 launches. Returns the max abs error against the plain
    version and the pieces to time it."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    if name == "lti":
        p = make_problem(A, K, T, device=device)
        fam = fs.lti_family(p["sigma"], p["inv_s"], p["w"], p["dt"], p["lam_cost"])
        x0, U, goal, lam = p["x0"], p["U"], p["goal"], p["lam"]
    else:
        p = make_family_problem(name, K, T, device=device)
        fam, x0, U, goal, lam = p["fam"], p["x0"], p["U"], p["goal"], p["lam"]
    label = f"costs-only {fam.name} A={fam.action_dim} K={K} T={T} anti={antithetic} ou={ou_beta}"
    args = (fam, x0, U, goal, K, 7, 3, 1, antithetic, ou_beta)
    S4 = fs.fused_rollout_costs(*args)
    S1, _ = fs.family_solve_partials(fam, x0, U, goal, lam, K, 7, 3, 1, antithetic, ou_beta)
    expect(torch.equal(S4, S1), f"{label}: S differs from K1's S")
    err = close(f"{label} vs plain", _np(S4), _np(fs.rollout_costs_reference(*args)), 1e-5)
    R = 3
    xs, Us = x0.expand(R, -1).contiguous(), U.expand(R, -1, -1).contiguous()
    goals = None if goal is None else goal.expand(R, -1).contiguous()
    seeds = philox.fleet_seeds(5, R).to(device)
    fleet = fs.fleet_rollout_costs(fam, xs, Us, goals, K, seeds, 3, 1, antithetic, ou_beta)
    for r, seed in enumerate(seeds.tolist()):
        solo = fs.fused_rollout_costs(fam, x0, U, goal, K, seed, 3, 1, antithetic, ou_beta)
        expect(torch.equal(fleet[r], solo), f"{label}: fleet robot {r} differs from its solo launch")
    return dict(err=err, fam=fam, args=args, lam=lam)


def check_reassigned_dynamics(device: str = "cuda") -> str:
    """The controller's pack follows a reassigned model: after
    ``ctrl.dynamics = dataclasses.replace(ctrl.dynamics, ...)`` (the
    cart-pole's pole mass, the point mass's dt) the fused solve (K1 + K2 on
    a CUDA device) equals the eager solve with the new model on the same ε
    and differs from the solve with the old one; on the fused backend a model
    the family cannot fuse raises and changes nothing."""
    import dataclasses

    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.models import PendulumDynamics

    out = []
    for name, edit in (("cartpole", dict(pole_mass=0.35)), ("point_mass3d", dict(dt=0.05))):
        cfg = _config(name).replace(samples=2048, horizon=30)
        fused = MPPIController(cfg, device=device, rollout_backend="auto")
        eager = MPPIController(cfg, device=device, rollout_backend="eager")
        x = torch.full((cfg.state_dim,), 0.1, device=device)
        U = fused.init_action_seq()
        eps = fused._eps(5, 0, 0)
        before = fused.solve_with_eps(x, U, eps)
        new = dataclasses.replace(fused.dynamics, **{
            k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in edit.items()})
        fused.dynamics = eager.dynamics = new
        got, want = fused.solve_with_eps(x, U, eps), eager.solve_with_eps(x, U, eps)
        label = f"{name} after a model reassignment ({fused.rollout_backend} vs eager)"
        close(f"{label} S", _np(got.info.costs), _np(want.info.costs), 1e-5)
        close(f"{label} action", _np(got.action), _np(want.action), **TOL["u"])
        expect(not torch.equal(got.info.costs, before.info.costs), f"{label}: S did not move")
        expect(fused._family.dynamics is new, f"{label}: the pack holds the old model")
        if fused.rollout_backend == "fused":
            try:
                fused.dynamics = PendulumDynamics.create(0.05, device=device)
            except ValueError:
                expect(fused.dynamics is new, f"{label}: a refused model was kept")
            else:
                raise SmokeFailure(f"{label}: an unfusable model was accepted on the fused backend")
        out.append(f"{name} ({', '.join(edit)})")
    return f"{', '.join(out)}: the fused solve after `ctrl.dynamics = replace(...)` equals the eager one"


def check_weighted_update(A: int, K: int, T: int, *, modes=None,
                          device: str = "cuda") -> float:
    """K5 (``fused_solve.weighted_update``: K5's per-block sums folded by K2)
    for three weights w (K,): drawn uniformly from a seed and normalized, so
    that every rollout's term counts (the softmin at the problem's λ is
    nearly one-hot at T = 200 and would test one term); all zero; one-hot at
    k = K − 1, the last row's edge (under antithetic a mirror). Each in the
    injected-ε mode against its plain version on the same device and a
    float64 einsum on the CPU, and in each Philox mode of `modes`
    ((antithetic, OU β, draw offset k0); None: iid, antithetic, OU 0.5 and
    iid at k0 = 3K) against the same on K3's dump of the same stream. Each
    entry is held to 1e-5 of Σ_k |w_k ε_k[t, a]|, its sum of magnitudes:
    float32 sums of K terms in two orders, and K5's OU filter runs on its
    blocks' sums (zero and one-hot weights: exact). Returns the max abs
    error against the plain version."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    p = make_problem(A, K, T, device=device)
    w_rand = torch.rand(K, generator=torch.Generator().manual_seed(K)).to(device)
    weights = {"uniform": w_rand / w_rand.sum(), "zero": torch.zeros(K, device=device),
               "one-hot K-1": torch.zeros(K, device=device)}
    weights["one-hot K-1"][K - 1] = 1.0

    def held(label: str, w, got, eps) -> float:
        e64, w64 = (_np(v).astype(np.float64) for v in (eps, w))
        tol = 1e-5 * np.einsum("tka,k->ta", np.abs(e64), np.abs(w64))
        plain = _np(fs.weighted_update_reference(w, eps))
        for what, want in (("plain", plain), ("float64", np.einsum("tka,k->ta", e64, w64))):
            bad = np.abs(_np(got) - want) > tol
            expect(not bad.any(), f"{label} vs {what}: {int(bad.sum())} entries beyond 1e-5 of "
                   f"sum |w eps|, max abs err {np.abs(_np(got) - want).max():.3g}")
        return float(np.abs(_np(got) - plain).max())

    if modes is None:
        modes = ((False, 0.0, 0), (True, 0.0, 0), (False, 0.5, 0), (False, 0.0, 3 * K))
    err = 0.0
    for wname, w in weights.items():
        err = max(err, held(f"K5 injected A={A} K={K} T={T} w {wname}", w,
                            fs.weighted_update(p["sigma"], w, T, K, 0, 0, 0, False, 0.0,
                                               eps=p["eps"]), p["eps"]))
    for anti, ou, k0 in modes:
        eps = fs.noise_dump(p["sigma"], T, K, 11, 5, 1, anti, ou, k0=k0)
        for wname, w in weights.items():
            got = fs.weighted_update(p["sigma"], w, T, K, 11, 5, 1, anti, ou, k0=k0)
            err = max(err, held(f"K5 philox A={A} K={K} T={T} anti={anti} ou={ou} k0={k0} "
                                f"w {wname}", w, got, eps))
    return err


def _leaves(res) -> list:
    return [res.action, res.u_next, *res.info]


def check_sharded(cfg, mesh, *, device: str = "cuda") -> dict:
    """The sharded solve (``parallel.ShardedMPPIController``) on `mesh`, in
    the one-pass and the two-kernel branch, against ``MPPIController``'s solo
    solve of the same K for one update: every rank's rollout costs are the
    solo solve's for the draws of its offset, bit for bit (in rollout order;
    under antithetic sampling a permutation of them), β equal, η and the
    action within TOL. Returns each branch's kernel launches per solve and
    the max abs error of the action."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController

    cfg = cfg.replace(opt_iters=1)
    solo = MPPIController(cfg, device=device)
    x = torch.full((cfg.state_dim,), 0.05, device=device)
    U = solo.init_action_seq()
    want = solo.solve(x, U, cfg.seed, 2)
    S_solo = want.info.costs
    K, n = cfg.samples, mesh.size
    k_loc = K // n
    if cfg.antithetic:  # rank d: draws d·k_loc/2 on, then their mirrors
        h = k_loc // 2
        idx = torch.cat([torch.cat([torch.arange(d * h, (d + 1) * h), K // 2 + torch.arange(d * h, (d + 1) * h)])
                         for d in mesh.local_ranks])
    else:
        idx = torch.cat([torch.arange(d * k_loc, (d + 1) * k_loc) for d in mesh.local_ranks])
    out = {}
    for onepass in (True, False):
        branch = "one-pass" if onepass else "two-kernel"
        ctrl = ShardedMPPIController(cfg, mesh=mesh, onepass=onepass)
        fs.reset_launch_counts()
        got = ctrl.solve(x, U, cfg.seed, 2)
        launches = {k: v for k, v in fs.launch_counts().items() if v}
        label = f"sharded {cfg.env} K={K} T={cfg.horizon} n={n} {branch} ({ctrl.rollout_backend})"
        expect(torch.equal(got.info.costs, S_solo[idx.to(S_solo.device)]),
               f"{label}: the ranks' costs differ from the solo solve's")
        expect(torch.equal(got.info.beta, want.info.beta), f"{label}: beta differs")
        close(f"{label} eta", _np(got.info.eta), _np(want.info.eta), TOL["eta"])
        e = close(f"{label} action", _np(got.action), _np(want.action), **TOL["u"])
        close(f"{label} u_next", _np(got.u_next), _np(want.u_next), **TOL["u"])
        out[branch] = dict(launches=launches, action_err=e)
    return out


def check_sharded_fleet(cfg, R: int, mesh, *, device: str = "cuda") -> None:
    """``parallel.ShardedFleetController`` on `mesh` bit-equal to
    ``BatchedMPPIController``, robot by robot, every leaf of the result."""
    import torch

    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.examples.fleet import circle_goals
    from mppi_gpu_tpu_torch.parallel import ShardedFleetController

    goals = torch.from_numpy(circle_goals(R, cfg.state_dim))
    fleet = BatchedMPPIController(cfg, R, goals=goals, device=device)
    sharded = ShardedFleetController(cfg, R, goals=goals, mesh=mesh)
    xs = 0.05 * torch.randn(R, cfg.state_dim, generator=torch.Generator().manual_seed(R)).to(device)
    Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
    want, got = fleet.solve(xs, Us, seeds, 1), sharded.solve(xs, Us, seeds, 1)
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        expect(torch.equal(g, w), f"sharded fleet R={R} n={mesh.size}: leaf {i} differs from the fleet's")


def _group_rank(rank: int, world: int, init: str, backend: str, device: str, cfg, out: str,
                episode: bool) -> None:
    """One rank of :func:`group_run` (a spawned process): joins the group,
    runs both branches on its device and saves its results."""
    import torch

    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController, global_mesh, init_multihost
    from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost
    from mppi_gpu_tpu_torch.runner import run_episode_jit

    dev = f"cuda:{rank}" if device == "cuda" else device
    if device == "cuda":
        torch.cuda.set_device(dev)  # before NCCL meets: the rank's GPU, not cuda:0
    init_multihost(init, world, rank, backend=backend)
    res = {}
    for onepass in (True, False):
        ctrl = ShardedMPPIController(cfg, mesh=global_mesh(dev), onepass=onepass)
        if episode:
            ep, eager = run_episode_jit(ctrl), run_episode_jit(ctrl, capture=False)
            res[onepass] = (ep.xs, ep.us, eager.xs, eager.us)
        else:
            x = torch.full((cfg.state_dim,), 0.05, device=dev)
            res[onepass] = [v.cpu() for v in _leaves(ctrl.solve(x, ctrl.init_action_seq(), cfg.seed,
                                                                 2))]
    shutdown_multihost()
    torch.save(res, os.path.join(out, f"{rank}.pt"))


def group_run(cfg, world: int, *, backend: str = "nccl", device: str = "cuda",
              episode: bool = False) -> list[dict]:
    """The sharded solve of `cfg` over a real process group of `world`
    ranks, one spawned process each (rank r on cuda:r under NCCL), both
    branches; with `episode`, its graph episode and the same cycle run
    eagerly (xs, us of each). Returns each rank's results."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "init")
        mp.start_processes(_group_rank, args=(world, init, backend, device, cfg, tmp, episode),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False) for r in range(world)]


def rsqrt_probe(device: str = "cuda", n: int = 1 << 20) -> tuple[int, int]:
    """How many of n float32 values torch.rsqrt on `device` gives other than
    1/sqrt on the same device, and other than torch.rsqrt on the CPU (which
    divides): both are nonzero when the device computes rsqrtf."""
    import torch

    x = torch.rand(n, generator=torch.Generator().manual_seed(0)) * 10 + 1e-3
    r = torch.rsqrt(x.to(device)).cpu()
    return (int((r != (1.0 / torch.sqrt(x.to(device))).cpu()).sum()),
            int((r != torch.rsqrt(x)).sum()))


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


def profile_steps(ctrl, x, U, steps: int = 50) -> dict:
    """Where a control step's time goes: `steps` warm solves of `ctrl` from
    (x, U), each followed by the copy of its action to the host as the
    closed loop makes it, under torch.profiler. Returns the wall ms per step
    (host clock around the window, synchronised), the device busy ms per
    step (the device time of every kernel and copy), the idle share
    1 − busy/wall, and K1's and K2's device µs per step."""
    import torch
    from torch.profiler import ProfilerActivity

    def step(i: int) -> None:
        ctrl.solve_auto(x, U, i).action.cpu()

    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, kernel_us = 0.0, {"solve_partials": 0.0, "softmin_combine": 0.0}
    names = {"solve_partials": ("solve_partials_kernel", "slab_partials_kernel"),  # K1's bodies
             "softmin_combine": ("softmin_combine_kernel",)}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0.0)
        busy_us += dev
        for k in kernel_us:
            if any(n in evt.key for n in names[k]):
                kernel_us[k] += dev
    wall_ms, busy_ms = wall * 1e3 / steps, busy_us / 1e3 / steps
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1.0 - busy_ms / wall_ms,
                K1_us=kernel_us["solve_partials"] / steps, K2_us=kernel_us["softmin_combine"] / steps)


def device_reading(fn, reps: int = 10, name: str | None = "_kernel",
                   launches: int = 1) -> tuple[float | None, str]:
    """Device ms per call of `fn` of the kernel of this file whose name holds
    `name` (by default the one kernel that `fn` launches; None: every kernel
    that `fn` launches, a library call's, summed per call), by torch.profiler
    over `reps` warm calls: the kernel alone, without the host's time
    between launches that CUDA events around a single call also count. The
    window holds one call, a marker kernel (``torch.cuda._sleep``, as in
    :func:`replay_trace`), the `reps` counted calls, a second marker and one
    more call, and only the records between the markers are read: the
    window's edges, where the profiler has dropped records, hold none of
    them. A call of one launch is read as the median of the records; a
    call that launches the kernel `launches` times as the median over the
    calls of each call's records summed, in start order, and only from a
    window that holds all `reps` × `launches` of them. A window that does
    not is read again, three windows at most. Returns (ms, how it was read);
    ms is None, and the text says what each window held, where no window
    gave a reading."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    held = []
    for _ in range(3):
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        dev = device_records(prof)
        marks = sorted((e.time_range for e in dev if "spin_kernel" in e.name), key=lambda r: r.start)
        if len(marks) != 2:
            held.append(f"{len(marks)} markers")
            continue
        t0, t1 = marks[0].end, marks[1].start
        records = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in dev
                         if (name is None or name in e.name) and e.time_range.start >= t0
                         and e.time_range.end <= t1)
        held.append(len(records))
        if name is None:
            if records and len(records) % reps == 0:
                return (sum(d for _, d in records) / reps / 1e3,
                        f"{len(records) // reps} records summed per call over {reps} calls")
            continue
        if records and launches == 1:
            return (float(np.median([d for _, d in records])) / 1e3,
                    f"median of {len(records)} records of {reps} calls")
        if len(records) == reps * launches:
            per_call = np.add.reduceat([d for _, d in records], range(0, len(records), launches))
            return (float(np.median(per_call)) / 1e3,
                    f"{launches} records summed per call, median of {reps} calls")
    return None, (f"not read: no window of 3 held the {reps * launches} records of its {reps} calls "
                  f"between the markers (they held {held})")


def device_ms(fn, reps: int = 10, name: str | None = "_kernel",
              launches: int = 1) -> float | None:
    """:func:`device_reading`'s ms alone."""
    return device_reading(fn, reps, name, launches)[0]


def paired_median_ms(kernel_fn, plain_fn, reps: int, plain_reps: int) -> tuple[float, float]:
    """Median ms of both, measured in turns (plain, kernel, kernel, plain,
    twice), each warmed up by two calls before the first turn only."""
    k, pl = [], []
    for turn in range(2):
        pl += time_ms(plain_fn, plain_reps, 2 if turn == 0 else 0)
        k += time_ms(kernel_fn, reps, 2 if turn == 0 else 0)
        k += time_ms(kernel_fn, reps, 0)
        pl += time_ms(plain_fn, plain_reps, 0)
    return float(np.median(k)), float(np.median(pl))


# ---------------------------------------------------------------------------
# the on-device episode (phase 21): run_episode_jit and run_fleet_episode as
# a replayed CUDA graph of one control cycle

# every shipped config, the two obstacle instances and the flagship
# point_mass3d K=10⁴ T=200
EPISODE_CONFIGS = ("point_mass1d", "point_mass2d", "point_mass3d", "mppi-config-test", "pendulum",
                   "cartpole", "unicycle", "quadrotor", "arm", "quadrotor3d", "obstacle2d",
                   "obstacle3d", "flagship")
# the R=8 fleet of every family at its quality config (bench._quality_cfg)
FLEET_EPISODE_CONFIGS = ("point_mass3d", "obstacle3d", "pendulum", "cartpole", "unicycle",
                         "quadrotor", "arm", "quadrotor3d")
# the tripwires of bench.QUALITY_THRESHOLDS were set at one fixed seed, and a
# fleet runs one seed per robot: the reference itself misses the bar at some
# seeds (the pendulum's swing-up at 6 of 64, up to 0.92 rad). So the robots
# of an R=64 fleet (seeds ops.philox.fleet_seeds(seed, 64), from the world's
# start) are held as a share under the bar against the JAX reference's share
# over seeds 0-63 (`python tests/_quality_seed_probe.py --seeds 64`,
# bench.quality_row on the CPU): not below it by a one-sided Fisher exact
# test at 1 %
FLEET_QUALITY_ROBOTS = 64
FLEET_QUALITY_REF_UNDER = {"point_mass3d": 64, "obstacle3d": 64, "pendulum": 58, "cartpole": 64,
                           "unicycle": 64, "quadrotor": 64, "arm": 64, "quadrotor3d": 64}
# the graph episode against the host loop on the card over its first
# EPISODE_HOST_CYCLES cycles, at the config's seed and the next
# EPISODE_HOST_SEEDS − 1: the world steps on the card in one (FMA
# contraction, the card's sin, cos and rsqrt) and on the CPU in the other,
# so the states part by rounding, which the solves and the plant feed back.
# Each config's (states' atol, actions' atol) is ten times the largest
# difference it showed over those seeds (NVIDIA H100 80GB HBM3, 700 W),
# rounded up to one digit and at least 1e-6; or the CPU tests' tolerance
# for two loops apart by rounding alone (2e-3 and 1e-2·σ; the arm 2e-2 and
# 1e-1·σ) where that is smaller and still twice the largest difference:
# point_mass2d, the cart-pole (whose unstable upright parted by 0.0118 in
# its action at seed 0), obstacle2d's actions and the flagship's states
EPISODE_HOST_CYCLES = 12
EPISODE_HOST_SEEDS = 4
EPISODE_HOST_TOL = {
    "point_mass1d": (1e-6, 1e-6), "point_mass2d": (2e-3, 2.5e-3), "point_mass3d": (1e-5, 3e-5),
    "mppi-config-test": (6e-6, 9e-6), "pendulum": (1e-6, 1e-6), "cartpole": (2e-3, 3e-2),
    "unicycle": (1e-6, 1e-6), "quadrotor": (2e-4, 2e-4), "arm": (3e-3, 2e-2),
    "quadrotor3d": (3e-2, 2e-1), "obstacle2d": (2e-3, 2.5e-3), "obstacle3d": (6e-4, 2e-3),
    "flagship": (2e-3, 3e-2),
}
# a fleet past the slab body's crossover runs K1's per-rollout body and its
# solo robot the slab body: S bit-equal, ΔU apart by rounding. Robots
# 0 .. EPISODE_HOST_SEEDS − 1 are held to their solo graph episodes over the
# first cycle (state after it, its action), where a robot given another's
# seed, goal or start would part by the noise's scale, within
# FLEET_SOLO_TOL (1e-6, the least of EPISODE_HOST_TOL's rule: readings at
# most 3e-8 and 9e-8); robot 0 also over EPISODE_HOST_CYCLES within
# FLEET_SOLO_LOOP_TOL: obstacle3d's ten times robots 0-3's largest
# difference, the 3-D quadrotor's the CPU tests' loop tolerance (2e-3,
# 1e-2·σ), since its loop amplifies the rounding past any bound over a few
# robots (robot 3's state parted by 0.72 after 12 cycles, robots 1-2 by 0
# and 1.9e-5, robot 0 by 1.3e-4); the others' 12-cycle differences are
# printed
FLEET_SOLO_TOL = {"obstacle3d": (1e-6, 1e-6), "quadrotor3d": (1e-6, 1e-6)}
FLEET_SOLO_LOOP_TOL = {"obstacle3d": (2e-4, 3e-4), "quadrotor3d": (2e-3, 1.2e-2)}
# control cycles of the torch.profiler window and of the timed host loop
EPISODE_PROFILE_CYCLES = 20
# graphed control steps of a host loop's torch.profiler window (solve_trace),
# and the steps on each side of its markers: late in this script the
# profiler has dropped the first marker of the quadrotor's window with 5 steps
# of lead-in, three windows in a row
SOLVE_TRACE_STEPS, SOLVE_TRACE_EDGE = 20, 20
# graph replays on each edge of :func:`replay_trace`'s window: a cycle of four
# kernels is ~0.02 ms, and late in this script the profiler has dropped every
# record of a window whose lead-in held 5 of them, three windows in a row
REPLAY_TRACE_EDGE = 40
EPISODE_HOST_TIMED = 100


def cycle_kernels(opt_iters: int) -> int:
    """Kernels per graph cycle of a fused episode: K1 and K2' (K2 with the
    tail, and in the last update the world's step, as its epilogue) per
    update."""
    return 2 * opt_iters
# K1's two bodies, K2 and K2', as their records in a trace are named
TRACE_NAMES = {"solve_partials": ("solve_partials_kernel", "slab_partials_kernel"),
               "softmin_combine": ("softmin_combine_kernel",),
               "combine_tail": ("combine_tail_kernel",)}
# and K5's; K4 is K1's template without its second pass, under K1's names;
# K6's, once per control cycle; K7's, once per update (a package before K2',
# and the sharded episodes of one before K8 and K9); K8's and K9's, once per
# update of a sharded episode; K10's and K11's, once per update of a
# two-kernel sharded episode, and K5's softmin form (softmin_update) once per
# local rank and update there
KERNEL_TRACE_NAMES = {**TRACE_NAMES, "weighted_update": ("weighted_update_kernel",),
                      "world_advance": ("world_advance_kernel",),
                      "solve_tail": ("solve_tail_kernel",),
                      "sharded_scale": ("sharded_scale_kernel",),
                      "sharded_tail": ("sharded_tail_kernel",),
                      "softmin_min": ("softmin_min_kernel",),
                      "softmin_eta": ("softmin_eta_kernel",),
                      "softmin_update": ("softmin_update_kernel",)}


def _episode_config(name: str):
    if name == "flagship":
        return _config("point_mass3d").replace(samples=10_000, horizon=200)
    return _config(name)


def episode_quality(name: str, cfg, xs: np.ndarray) -> tuple[float, float | None]:
    """(steady, bar): the mean over the last quarter of an episode's states
    (N+1, s) of the family's distance from solved (bench._goal_metric), and
    its bench.QUALITY_THRESHOLDS tripwire; None where the config has none
    (point_mass1d and point_mass2d end short of the goal in 500 steps, as
    phase 7 says; mppi-config-test runs K=3; obstacle2d's bar is its
    example's own, phase 17)."""
    g = np.asarray(cfg.goal, np.float64)
    if name in FAMILY_ANGLE:
        th = xs[:, FAMILY_ANGLE[name]]
        d, bar = np.abs(np.arctan2(np.sin(th), np.cos(th))), FAMILY_QUALITY_THRESHOLD_RAD[name]
    elif name in COUPLED:
        d, bar = coupled_distance(name, xs), COUPLED_QUALITY_THRESHOLD_M[name]
    elif name == "quadrotor3d":
        d, bar = np.linalg.norm(xs[:, :3] - g[:3], axis=1), LAST_QUALITY_THRESHOLD_M[name]
    else:
        n = cfg.action_dim
        d = np.linalg.norm(xs[:, :n] - g[:n], axis=1)
        bar = {"point_mass3d": LTI_QUALITY_THRESHOLD_M, "flagship": LTI_QUALITY_THRESHOLD_M,
               "obstacle3d": LAST_QUALITY_THRESHOLD_M["obstacle"]}.get(name)
    return float(d[-max(len(d) // 4, 1):].mean()), bar


def check_step_pointer(fam, x0, U, goal, lam, K: int, R: int = 8) -> None:
    """K1's (S and partials) and K4's (S) launches with the control step
    passed by its address (a 0-dim int64 on the card, ``step_ptr``) equal to
    the by-value launches, in both bodies, solo and for an R-robot fleet
    (robots apart in start and seed), iid and antithetic with OU 0.5; the step
    2³² + 3 checks that the kernel takes its low word as the by-value word
    is."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    word = 2**32 + 3
    step = torch.tensor(word, dtype=torch.int64, device="cuda")
    xs = (x0 + 0.01 * torch.arange(R, device="cuda")[:, None]).contiguous()
    Us = U.expand(R, -1, -1).contiguous()
    goals = None if goal is None else goal.expand(R, -1).contiguous()
    seeds = philox.fleet_seeds(7, R).cuda()
    for width in (fs.SLAB_WIDTH, fs.BLOCK):
        for anti, ou in ((False, 0.0), (True, 0.5)):
            for lam_s in (lam, None):
                for args in ((x0, U, goal, 7, 1, ()), (xs, Us, goals, seeds, R, (R,))):
                    a0, a1, a2, seed, n, lead = args

                    def run(s):
                        return fs._launch_solve_partials(fam, a0, a1, a2, lam_s, K, seed, s, 1, anti,
                                                         ou, None, n, lead, width=width)

                    by_value, by_ptr = run(word), run(step)
                    label = (f"{fam.name} A={fam.action_dim} K={K} R={n} width {width} anti={anti} "
                             f"ou={ou} {'K1' if lam_s is not None else 'K4'}")
                    for v, p in zip(*((o,) if lam_s is None else o for o in (by_value, by_ptr))):
                        expect(torch.equal(v, p), f"{label}: the step by pointer differs from by value")


def device_records(prof) -> list:
    """A torch.profiler window's device records."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def solve_records(records) -> dict[str, int]:
    """How many of `records` are K1's (either body) and K2's."""
    return {k: sum(any(n in e.name for n in names) for e in records)
            for k, names in TRACE_NAMES.items()}


def replay_trace(ctrl, label: str, cycles: int = EPISODE_PROFILE_CYCLES, fleet: bool = False,
                 per_update: dict | None = None, world_kernel: bool = True,
                 tail_kernel: bool = True, epilogue: bool = True,
                 sharded_tail: bool = False) -> dict:
    """torch.profiler over `cycles` replays of one captured control cycle
    and nothing else. An episode of `cycles` + 2·REPLAY_TRACE_EDGE cycles
    captures the cycle (outside the window) and its step counter is set
    back to 0; the window then holds REPLAY_TRACE_EDGE replays and a
    synchronisation, a marker kernel (``torch.cuda._sleep``, whose record
    is ``spin_kernel``), the `cycles` counted replays, a second marker and
    REPLAY_TRACE_EDGE more replays, as :func:`solve_trace`'s (with one replay
    on each edge, a cycle of K6's length lost its first marker late in this
    script in three windows in a row). Only the records between the two
    markers are read, so neither the episode's start and read-back nor the
    window's edges (where the profiler has dropped a record of a replay)
    enter. From
    them, per cycle: the records of each kernel of `per_update` (a key of
    KERNEL_TRACE_NAMES: its records per update; by default one of K1 and
    one of K2', with `epilogue` False one of K2) (checked: that many per
    update, opt_iters) and, with `epilogue` False (a sharded controller, a
    package before K2'), K6's (checked: one per cycle, the world's whole
    step; not with `world_kernel` False, for a package before K6) and K7's
    (checked: one per update, opt_iters per cycle, whatever the mesh; not
    with `tail_kernel` False, for a package before K7; with `sharded_tail`,
    a sharded episode whose tail and world step are K9, none of either);
    with `epilogue`, no record of K2, K6 or K7; NCCL's records
    and their µs, the kernels (memory copies and sets not counted), the device
    busy ms (Σ of the records' times) and the span ms (the first marker's
    end to the second one's start); the idle share 1 − busy/span, K1 +
    K2's share of busy and the four names with the most device µs; and,
    untraced, the ms per cycle of `cycles` replays
    by CUDA events, which the span exceeds by what the tracer adds to each
    kernel node; K2''s µs per cycle by record name (its world body),
    ``k2e_us``, and K8's, K9's, K10's and K11's, ``k8_us``, ``k9_us``,
    ``k10_us`` and ``k11_us``. A window
    without both markers, or whose K1 or K2 records fall short, is read
    again, five windows at most (a failure says
    what each held): a graph replays the same launches every time."""
    import torch
    from torch.profiler import ProfilerActivity

    from mppi_gpu_tpu_torch.runner import run_episode_jit, run_fleet_episode

    (run_fleet_episode if fleet else run_episode_jit)(ctrl, num_steps=cycles + 2 * REPLAY_TRACE_EDGE)
    cyc = ctrl._episode_cycles["fleet" if fleet else "single"][1]
    k2 = "combine_tail" if epilogue else "softmin_combine"
    per_update = {"softmin_combine": 0, "combine_tail": 0, "sharded_scale": 0, "sharded_tail": 0,
                  "softmin_min": 0, "softmin_eta": 0, "softmin_update": 0,
                  **(per_update or {"solve_partials": 1, k2: 1})}
    want = {k: cycles * ctrl.cfg.opt_iters * v for k, v in per_update.items()}
    standalone = not (epilogue or sharded_tail)
    want["world_advance"] = cycles if world_kernel and standalone else 0
    want["solve_tail"] = cycles * ctrl.cfg.opt_iters if tail_kernel and standalone else 0
    held = []
    for window in range(1, 6):
        cyc.step.zero_()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPLAY_TRACE_EDGE):
                cyc.graph.replay()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(cycles):
                cyc.graph.replay()
            torch.cuda._sleep(1000)
            for _ in range(REPLAY_TRACE_EDGE):
                cyc.graph.replay()
            torch.cuda.synchronize()
        dev = device_records(prof)
        marks = sorted((e.time_range for e in dev if "spin_kernel" in e.name), key=lambda r: r.start)
        held.append(f"{len(marks)} markers in {len(dev)} records")
        if len(marks) != 2:
            continue
        t0, t1 = marks[0].end, marks[1].start
        dev = [e for e in dev if e.time_range.start >= t0 and e.time_range.end <= t1]
        counts = {k: sum(any(n in e.name for n in KERNEL_TRACE_NAMES[k]) for e in dev) for k in want}
        if counts == want:
            break
    expect(len(marks) == 2, f"{label}: {len(marks)} marker records in the trace ({window} windows "
           f"read: {held})")
    cyc.step.zero_()  # the same replays untraced, by CUDA events: what the tracer adds
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(cycles):
        cyc.graph.replay()
    end.record()
    end.synchronize()
    for kernel, c in counts.items():
        expect(c == want[kernel], f"{label}: {c} {kernel} records in {cycles} graph replays, want "
               f"{want[kernel]} ({window} windows read)")
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    solve_us = sum(e.time_range.elapsed_us() for e in dev
                   if any(n in e.name for names in TRACE_NAMES.values() for n in names))
    kernels = [e for e in dev if not re.search(r"[Mm]emcpy|[Mm]emset", e.name)]
    nccl = [e for e in dev if "nccl" in e.name.lower()]
    by_name: dict[str, float] = {}
    for e in dev:  # device µs per cycle of each record's name, its first 48 characters
        key = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", e.name)[:48]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / cycles
    return dict(kernels=len(kernels) / cycles, busy_ms=busy_us / 1e3 / cycles,
                span_ms=(t1 - t0) / 1e3 / cycles, idle=1.0 - busy_us / (t1 - t0),
                untraced_ms=start.elapsed_time(end) / cycles,
                k12_share=solve_us / busy_us, k1_per_cycle=counts["solve_partials"] / cycles,
                k2_per_cycle=counts["softmin_combine"] / cycles,
                k2e_per_cycle=counts["combine_tail"] / cycles,
                k6_per_cycle=counts["world_advance"] / cycles,
                k7_per_cycle=counts["solve_tail"] / cycles,
                k8_per_cycle=counts["sharded_scale"] / cycles,
                k9_per_cycle=counts["sharded_tail"] / cycles, windows=window,
                records={k: c / cycles for k, c in counts.items()}, nccl_per_cycle=len(nccl) / cycles,
                nccl_us=sum(e.time_range.elapsed_us() for e in nccl) / cycles,
                nccl_names=sorted({e.name for e in nccl}),
                top=sorted(((round(v, 2), k) for k, v in by_name.items()), reverse=True)[:4],
                k2e_us={k: v for k, v in by_name.items() if k.startswith("combine_tail")},
                k8_us=sum(v for k, v in by_name.items() if k.startswith("sharded_scale")),
                k9_us=sum(v for k, v in by_name.items() if k.startswith("sharded_tail")),
                k10_us=sum(v for k, v in by_name.items() if k.startswith("softmin_min")),
                k11_us=sum(v for k, v in by_name.items() if k.startswith("softmin_eta")))


def solve_trace(label: str, ctrl, x, U, seed, per_update: dict | None = None,
                steps: int = SOLVE_TRACE_STEPS) -> dict:
    """torch.profiler over `steps` control steps of `ctrl`'s host loop as
    ``run_closed_loop`` runs it (``solve``, a replayed CUDA graph, U fed
    forward, the action read back to the host) and nothing else: the graph
    is captured and replayed once before the window, which holds a few steps,
    a marker kernel (as in :func:`replay_trace`), the `steps` counted steps,
    a second marker and a few more steps; only the records between the markers
    are read. Each edge holds SOLVE_TRACE_EDGE steps and the first ends
    with a synchronisation: on an H100, late in this script, three windows
    in a row with a one-step lead-in held only one of the two markers, and
    so did the quadrotor's with five.
    Checked: the kernels' wrappers launched nothing in the window (the
    replays launch from the graph), and each kernel of `per_update` (a
    key of KERNEL_TRACE_NAMES: its records per update, opt_iters per step;
    by default, per step, opt_iters of K1, one of K2 (the last update's,
    before K7) and opt_iters − 1 of K2' (the inner updates', the tail their
    epilogue)) has that many records; a window that falls short is read
    again, three at most. Returns the records per step of each, the device
    busy ms and the span ms per step and the idle share 1 − busy/span."""
    import torch
    from torch.profiler import ProfilerActivity

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    iters = ctrl.cfg.opt_iters
    want = ({k: steps * iters * v for k, v in per_update.items()} if per_update else
            {"solve_partials": steps * iters, "softmin_combine": steps,
             "combine_tail": steps * (iters - 1)})

    def loop(n: int) -> None:
        u = U
        for i in range(n):
            res = ctrl.solve(x, u, seed, i)
            res.action.cpu()
            u = res.u_next

    loop(2)
    torch.cuda.synchronize()
    before = fs.launch_counts()
    missed = []
    for window in range(1, 4):
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop(SOLVE_TRACE_EDGE)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            loop(steps)
            torch.cuda._sleep(1000)
            loop(SOLVE_TRACE_EDGE)
            torch.cuda.synchronize()
        dev = device_records(prof)
        marks = sorted((e.time_range for e in dev if "spin_kernel" in e.name), key=lambda r: r.start)
        if len(marks) != 2:
            missed.append(f"{len(marks)} markers in {len(dev)} records, the first "
                          f"{[e.name[:40] for e in sorted(dev, key=lambda e: e.time_range.start)[:3]]}")
            continue
        t0, t1 = marks[0].end, marks[1].start
        dev = [e for e in dev if e.time_range.start >= t0 and e.time_range.end <= t1]
        counts = {k: sum(any(n in e.name for n in KERNEL_TRACE_NAMES[k]) for e in dev) for k in want}
        if counts == want:
            break
    after = fs.launch_counts()
    expect(after == before, f"{label}: the kernels' wrappers launched {after} during the graphed "
           f"host loop, {before} before it")
    expect(len(marks) == 2, f"{label}: no window held both marker records ({missed})")
    for kernel, c in counts.items():
        expect(c == want[kernel], f"{label}: {c} {kernel} records in {steps} graphed control steps, "
               f"want {want[kernel]} ({window} windows read)")
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    return dict(records={k: c / steps for k, c in counts.items()}, busy_ms=busy_us / 1e3 / steps,
                span_ms=(t1 - t0) / 1e3 / steps, idle=1.0 - busy_us / (t1 - t0), windows=window)


def config_trace(name: str, per_update: dict | None = None) -> dict:
    """:func:`solve_trace` of config `name`'s controller on the card (the
    fused backend) from its world's start: the graph its CLI replays each
    step."""
    from mppi_gpu_tpu_torch.controller import MPPIController

    cfg = _config(name)
    ctrl = MPPIController(cfg, device="cuda", rollout_backend="fused")
    return solve_trace(name, ctrl, _start(cfg), ctrl.init_action_seq(), cfg.seed, per_update)


def _start(cfg):
    """The state config `cfg`'s world starts from, on the card."""
    from mppi_gpu_tpu_torch.envs import make_world, params_for_config

    return make_world(cfg, params_for_config(cfg), device="cuda").reset().x


def _records_line(traces: dict) -> str:
    return "; ".join(f"{n} {t['records']}" for n, t in traces.items())


def close_loops(label: str, a, b, tol: tuple[float, float]) -> tuple[float, float]:
    """Two episodes' first EPISODE_HOST_CYCLES cycles held to each other
    within `tol` (states' atol, actions' atol); returns the max abs
    differences (states, actions)."""
    m = EPISODE_HOST_CYCLES
    dx = close(f"{label} states, first {m} cycles", a.xs[:m + 1], b.xs[:m + 1], 0.0, tol[0])
    du = close(f"{label} actions, first {m} cycles", a.us[:m], b.us[:m], 0.0, tol[1])
    return dx, du


def _timed(fn) -> tuple[object, float]:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _pairs(readings) -> list[tuple[float, float]]:
    """(states, actions) differences to three digits, for a line."""
    return [(float(f"{a:.3g}"), float(f"{b:.3g}")) for a, b in readings]


def _trace_line(t: dict) -> str:
    return (f"{t['kernels']:.1f} kernels, K1 {t['k1_per_cycle']:g}, K2' {t['k2e_per_cycle']:g}, "
            f"K2 {t['k2_per_cycle']:g}, K7 {t['k7_per_cycle']:g}, K6 {t['k6_per_cycle']:g}, K8 "
            f"{t['k8_per_cycle']:g} and K9 {t['k9_per_cycle']:g} records per cycle; device busy {t['busy_ms']:.4f} of a {t['span_ms']:.4f} ms span per "
            f"cycle, idle share {t['idle']:.4f}; K1 + K2 (or K2') {t['k12_share']:.4f} of busy; the same "
            f"replays untraced (CUDA events) {t['untraced_ms']:.4f} ms per cycle; the largest device "
            f"µs per cycle {t['top']}")


def counted(fn) -> tuple[object, dict[str, int]]:
    """fn()'s result and the launches its kernels' wrappers counted (K1-K5,
    K2', K7, K6 by world body, K8-K11), each count set to 0 just before
    it; only the kernels that launched."""
    from mppi_gpu_tpu_torch.ops import combine_tail as ct
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc
    from mppi_gpu_tpu_torch.ops import solve_tail as st
    from mppi_gpu_tpu_torch.ops import world_step as ws

    mods = (fs, ct, st, ws, sc)
    for m in mods:
        m.reset_launch_counts()
    out = fn()
    counts = {}
    for m in mods:
        for k, v in m.launch_counts().items():
            counts[k if m is not ws else f"world_advance<{k}>"] = v
    return out, {k: v for k, v in counts.items() if v}


def episode_config_phase(name: str, smi: str) -> dict:
    """One config's on-device episode: the graph episode (captured, then
    timed warm; no wrapper launches a kernel during it), bit-equal to the
    same cycle run eagerly on the card over the whole episode (which
    launches K1 and K2 once per update); the host loop on the card (CPU
    world, its solve a replayed graph captured by a first step outside the
    timing) timed over EPISODE_HOST_TIMED cycles; the graph episode against
    the host loop over the first EPISODE_HOST_CYCLES cycles at
    EPISODE_HOST_SEEDS seeds, within the config's EPISODE_HOST_TOL; the graph
    episode's steady-state quality under its tripwire; a trace of the graph's
    replays (:func:`replay_trace`). Returns the row of PERF.md §5's episode
    table."""
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.envs import params_for_config
    from mppi_gpu_tpu_torch.runner import run_closed_loop, run_episode_jit

    cfg = _episode_config(name)
    n = params_for_config(cfg).num_control_steps()
    ctrl = MPPIController(cfg, device="cuda")
    expect(ctrl.rollout_backend == "fused", f"{name}: auto picked {ctrl.rollout_backend}")

    first, first_s = _timed(lambda: run_episode_jit(ctrl))
    (graph, graph_s), graph_counts = counted(lambda: _timed(lambda: run_episode_jit(ctrl)))
    (eager, eager_s), counts = counted(lambda: _timed(lambda: run_episode_jit(ctrl, capture=False)))
    expect(not graph_counts, f"{name}: launches {graph_counts} from the host in a warm graph "
           "episode")
    # the eager cycle: K1 and K2' per update, nothing else (no K2, K7 or K6)
    want = {"solve_partials": n * cfg.opt_iters, "combine_tail": n * cfg.opt_iters}
    expect(counts == want, f"{name}: launches {counts} in the eager episode of {n} cycles x "
           f"{cfg.opt_iters}, want {want}")
    k2e = counts["combine_tail"]
    for what, other in (("a second replay", first), ("the eager cycle on the card", eager)):
        for f in ("xs", "us", "times"):
            expect(np.array_equal(getattr(graph, f), getattr(other, f)),
                   f"{name}: the graph episode's {f} differ from {what}'s")
    expect(graph.xs.shape == (n + 1, cfg.state_dim) and np.isfinite(graph.xs).all(),
           f"{name}: graph episode states {graph.xs.shape}")
    host_ctrl = MPPIController(cfg, device="cuda")
    run_closed_loop(host_ctrl, max_steps=1)  # captures its solve graph, outside the timing
    host, host_s = _timed(lambda: run_closed_loop(host_ctrl, max_steps=EPISODE_HOST_TIMED))
    tol = EPISODE_HOST_TOL[name]
    readings = [close_loops(f"{name} graph vs host loop, seed {cfg.seed}", graph, host, tol)]
    for seed in range(cfg.seed + 1, cfg.seed + EPISODE_HOST_SEEDS):
        other = MPPIController(cfg.replace(seed=seed), device="cuda")
        readings.append(close_loops(
            f"{name} graph vs host loop, seed {seed}",
            run_episode_jit(other, num_steps=EPISODE_HOST_CYCLES),
            run_closed_loop(other, max_steps=EPISODE_HOST_CYCLES), tol))
    dx, du = (max(r[i] for r in readings) for i in (0, 1))
    steady, bar = episode_quality(name, cfg, graph.xs.astype(np.float64))
    if bar is not None:
        expect(steady < bar, f"{name}: graph episode steady-state {steady} (bar {bar})")
    trace = replay_trace(ctrl, name)
    expect(trace["kernels"] == cycle_kernels(cfg.opt_iters),
           f"{name}: {trace['kernels']} kernels per graph cycle, want K1 and K2' per update: "
           f"{cycle_kernels(cfg.opt_iters)} (the largest: {trace['top']})")
    row = dict(K=cfg.samples, T=cfg.horizon, opt_iters=cfg.opt_iters, cycles=n, k2e=k2e,
               graph_ms=graph_s * 1e3 / n, eager_ms=eager_s * 1e3 / n,
               host_ms=host_s * 1e3 / len(host.us), first_s=first_s, steady=steady, bar=bar,
               host_dx=dx, host_du=du, host_readings=readings, trace=trace)
    print(f"[21] episode {name} K={cfg.samples} T={cfg.horizon} x{cfg.opt_iters}, {n} cycles: "
          f"graph {row['graph_ms']:.4f} ms/cycle (first call {first_s:.3f} s with the capture), "
          f"eager on the card {row['eager_ms']:.4f}, host loop {row['host_ms']:.4f} "
          f"({EPISODE_HOST_TIMED} cycles); graph == eager over the whole episode; no host launch "
          f"in a warm graph episode, {n * cfg.opt_iters} each of K1 and K2' and none of K2, K7 or "
          f"K6 in the eager one; host "
          f"loop within (states, actions) {tol} over {EPISODE_HOST_CYCLES} cycles at "
          f"{EPISODE_HOST_SEEDS} seeds (max abs per seed {_pairs(readings)}); "
          f"steady {steady:.4f} (bar {bar}); trace of {EPISODE_PROFILE_CYCLES} graph replays: "
          f"{_trace_line(trace)} ({smi})")
    return row


def fleet_episode_phase(name: str, smi: str, R: int = 8) -> dict:
    """An R-robot fleet of a family at its quality config, every robot from
    the world's start under its own seed: the graph episode (timed warm),
    bit-equal to the eager cycle on the card, each robot's steady state;
    robot 0 against its solo graph episode (seed, goal) bit for bit where
    the fleet's K1 body is the solo one's, else (the fleet past the slab's
    crossover runs the per-rollout body: S bit-equal, ΔU to rounding)
    robots 0 .. EPISODE_HOST_SEEDS − 1 within the config's FLEET_SOLO_TOL
    over the first cycle, robot 0 within its FLEET_SOLO_LOOP_TOL over
    EPISODE_HOST_CYCLES; a trace of the graph's replays; then an
    R=FLEET_QUALITY_ROBOTS fleet's share of robots under the tripwire against
    the reference's (FLEET_QUALITY_REF_UNDER)."""
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.envs import params_for_config
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.runner import run_episode_jit, run_fleet_episode

    cfg = _episode_config(name)
    n = params_for_config(cfg).num_control_steps()
    fleet = BatchedMPPIController(cfg, R, device="cuda")
    _, first_s = _timed(lambda: run_fleet_episode(fleet))
    (ep, graph_s), graph_counts = counted(lambda: _timed(lambda: run_fleet_episode(fleet)))
    (eager, eager_s), counts = counted(lambda: _timed(lambda: run_fleet_episode(fleet,
                                                                                capture=False)))
    expect(not graph_counts, f"fleet {name}: launches {graph_counts} from the host in a warm "
           "graph episode")
    # one launch of K1 and one of K2' per update for the R robots, whatever R
    want = {"solve_partials": n * cfg.opt_iters, "combine_tail": n * cfg.opt_iters}
    expect(counts == want, f"fleet {name}: launches {counts} in the eager episode of {n} cycles "
           f"x {cfg.opt_iters}, want {want}")
    k2e = counts["combine_tail"]
    for f in ("xs", "us", "times"):
        expect(np.array_equal(getattr(ep, f), getattr(eager, f)),
               f"fleet {name}: the graph episode's {f} differ from the eager cycle's")
    expect(ep.xs.shape == (n + 1, R, cfg.state_dim) and np.isfinite(ep.xs).all(),
           f"fleet {name}: states {ep.xs.shape}")
    steady = [episode_quality(name, cfg, ep.xs[:, r].astype(np.float64)) for r in range(R)]
    seeds = [int(s) for s in fleet.init_seeds()]
    family = fleet._family.name
    one_width = (fs.block_width(R, cfg.samples, cfg.horizon, cfg.action_dim, family)
                 == fs.block_width(1, cfg.samples, cfg.horizon, cfg.action_dim, family))
    if one_width:
        one = run_episode_jit(MPPIController(cfg, device="cuda", cost=fleet._robot_cost(0)),
                              seed=seeds[0])
        expect(np.array_equal(ep.xs[:, 0], one.xs) and np.array_equal(ep.us[:, 0], one.us),
               f"fleet {name}: robot 0 differs from its solo graph episode")
        solo = "robot 0 bit-equal to its solo graph episode"
    else:
        tol, first, late, m = FLEET_SOLO_TOL[name], [], [], EPISODE_HOST_CYCLES
        for r in range(EPISODE_HOST_SEEDS):
            one = run_episode_jit(MPPIController(cfg, device="cuda", cost=fleet._robot_cost(r)),
                                  seed=seeds[r], num_steps=m)
            first.append((
                close(f"fleet {name} robot {r} vs solo, state after cycle 0", ep.xs[1, r], one.xs[1],
                      0.0, tol[0]),
                close(f"fleet {name} robot {r} vs solo, action of cycle 0", ep.us[0, r], one.us[0],
                      0.0, tol[1])))
            if r == 0:
                robot = type(one)(times=ep.times, xs=ep.xs[:, 0], us=ep.us[:, 0])
                late.append(close_loops(f"fleet {name} robot 0 vs solo", robot, one,
                                        FLEET_SOLO_LOOP_TOL[name]))
            else:
                late.append((float(np.abs(ep.xs[:m + 1, r] - one.xs).max()),
                             float(np.abs(ep.us[:m, r] - one.us).max())))
        solo = (f"robots 0-{EPISODE_HOST_SEEDS - 1} within (states, actions) {tol} of their solo "
                f"graph episodes over the first cycle (max abs per robot {_pairs(first)}), robot 0 "
                f"within {FLEET_SOLO_LOOP_TOL[name]} over {m} cycles (max abs per robot "
                f"{_pairs(late)}); the fleet runs K1's per-rollout body, the solo robot the slab "
                "body")
    trace = replay_trace(fleet, f"fleet {name}", fleet=True)
    expect(trace["kernels"] == cycle_kernels(cfg.opt_iters),
           f"fleet {name}: {trace['kernels']} kernels per graph cycle, want "
           f"{cycle_kernels(cfg.opt_iters)} (the largest: {trace['top']})")
    bar = steady[0][1]
    del fleet, eager
    many = BatchedMPPIController(cfg, FLEET_QUALITY_ROBOTS, device="cuda")
    big = run_fleet_episode(many)
    under = sum(episode_quality(name, cfg, big.xs[:, r].astype(np.float64))[0] < bar
                for r in range(FLEET_QUALITY_ROBOTS))
    ref = FLEET_QUALITY_REF_UNDER[name]
    p_below = fisher_below(under, FLEET_QUALITY_ROBOTS, ref, 64)
    expect(p_below >= 0.01, f"fleet {name}: {under} of {FLEET_QUALITY_ROBOTS} robots under the "
           f"bar {bar}, the reference {ref} of 64 seeds (one-sided Fisher p {p_below:.3g})")
    del many, big
    row = dict(R=R, K=cfg.samples, T=cfg.horizon, cycles=n, k2e=k2e, graph_ms=graph_s * 1e3 / n,
               eager_ms=eager_s * 1e3 / n, first_s=first_s, steady=[s for s, _ in steady], bar=bar,
               under=under, ref_under=ref, p_below=p_below, trace=trace)
    print(f"[21] fleet episode {name} R={R} K={cfg.samples} T={cfg.horizon} x{cfg.opt_iters}, {n} "
          f"cycles: graph {row['graph_ms']:.4f} ms/fleet cycle (first call {first_s:.3f} s), eager "
          f"on the card {row['eager_ms']:.4f}; graph == eager; no host launch in a warm graph "
          f"episode, K1 and K2' {k2e} each and no K2, K7 or K6 in the eager one; robots' steady {[round(s, 4) for s in row['steady']]} (bar {bar}); {solo}; "
          f"trace of {EPISODE_PROFILE_CYCLES} graph replays: {_trace_line(trace)}; an "
          f"R={FLEET_QUALITY_ROBOTS} fleet: {under} of {FLEET_QUALITY_ROBOTS} robots under the bar, "
          f"the reference {ref} of 64 seeds (one-sided Fisher p {p_below:.3g}) ({smi})")
    return row


# ---------------------------------------------------------------------------
# K6 world_advance (phase 21): one control cycle of a ground-truth world per
# launch, against its plain version (ops/world_step.plain_advance)

WORLD_SOURCE = "mppi_gpu_tpu_torch/csrc/world_step.cu"
WORLD_REPLACES = ("no Pallas kernel: XLA's fusion of the JAX world's simulate under lax.scan, "
                  "mppi_gpu_tpu/runner.py:375-383")
# a config of each world body, and point_mass2d's config on the reference XML
# (envs/xml.py), which packs its own parameters into the point-mass body
WORLD_CASES = ("point_mass1d", "point_mass2d", "point_mass3d", "point_mass_xml", "pendulum",
               "cartpole", "unicycle", "quadrotor", "arm", "quadrotor3d")
# how far K6 may part from the plain loop on the card, by world: not at all.
# Each torch op rounds once and K6 repeats them in order, rounded alike
# (csrc/world_step.cu); a NaN state stays NaN with the same bits
WORLD_STEP_TOL = dict.fromkeys(WORLD_CASES, 0.0)
# robots (None: one robot, no robot axis), clocks and states of each layout,
# named as in :func:`world_clocks` and :func:`world_inputs`
WORLD_LAYOUTS = (("solo", None, "dt", "task"), ("solo at sim_end", None, "end", "task"),
                 ("solo crossing sim_end", None, "last", "task"),
                 ("solo past sim_end", None, "past", "task"),
                 ("R=8 shared clock", 8, "dt", "task"),
                 ("R=8 shared clock crossing sim_end", 8, "last", "task"),
                 ("R=8 per-robot clocks", 8, "mixed", "task"),
                 ("R=64 shared clock", 64, "dt", "task"),
                 ("R=64 per-robot clocks", 64, "mixed", "task"),
                 ("R=8 hard states", 8, "dt", "hard"))
# the angles of the hard states: sinf's and cosf's large-argument path
# (|x| >= 105615 takes the full argument reduction)
WORLD_HARD_ANGLES = (1.0e5, -3.7e5, 1.5e7, 2.5e9, -7.77e12, 123456.7)
# each world's angles in its x (the arm: both joints)
WORLD_ANGLES = {"pendulum": (0,), "cartpole": (1,), "unicycle": (2,), "quadrotor": (2,),
                "arm": (0, 1)}
WORLD_CYCLES = 3      # cycles per layout, chained
WORLD_HIST_ROW = 5    # the history row of the first cycle (a non-zero counter)


def world_config(name: str):
    cfg = _config("point_mass2d" if name == "point_mass_xml" else name)
    return cfg.replace(env=os.path.join("envs_xml", "point_mass2d.xml")) if name == "point_mass_xml" \
        else cfg


def world_clocks(kind: str, n: int, p):
    """The clocks of a layout: dt (the world's start), end (at sim_end:
    held), last (one cycle before crossing sim_end: stepped once, then
    held), past (held), mixed (per robot, all of those)."""
    dt, end = np.float32(p.timestep), np.float32(p.sim_end)
    last = np.float32(p.sim_end - p.steps_per_control * p.timestep)
    one = {"dt": dt, "end": end, "last": last, "past": np.float32(p.sim_end + 0.5)}
    if kind != "mixed":
        return one[kind]
    return np.float32([dt, 1.0, last, end, one["past"], 4.0, dt, last] * (n // 8))


def world_inputs(name: str, cfg, n: int, seed: int = 3, states: str = "task"):
    """(n, s) states near the task's and (WORLD_CYCLES, n, a) actions up to
    1.5× the config's bounds (past every clamp), from a numpy seed; robot 0
    of a point mass or the cart-pole at its stop driving into it; with 64
    robots, robot 63's state NaN and robot 62's action NaN. With `states`
    "hard", the first eight robots' states are :func:`world_hard_states`'."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-0.6, 0.6, (n, cfg.state_dim)).astype(np.float32)
    if name == "quadrotor3d":
        xs[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + rng.uniform(-0.2, 0.2, (n, 4))
        xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=1, keepdims=True)
    bound = np.asarray(cfg.max_a, np.float32)
    us = rng.uniform(-1.5, 1.5, (WORLD_CYCLES, n, cfg.action_dim)).astype(np.float32) * bound
    if name.startswith("point_mass") or name == "cartpole":
        xs[0, 0], us[:, 0, 0] = (2.38 if name == "cartpole" else 1.39), 1.5 * bound[0]
    if n == 64:
        xs[63], us[:, 62] = np.nan, np.nan
    if states == "hard":
        world_hard_states(name, xs)
    return xs, us


def world_hard_states(name: str, xs: np.ndarray) -> np.ndarray:
    """Robots 0-7 of `xs` (n >= 8, s) in place, states where the world
    bodies' float substitutions (rcp, sin_cos) and their slow paths are
    reached: robots 0-5 with every angle of the world (WORLD_ANGLES) at one
    of WORLD_HARD_ANGLES (a world without one: its first coordinate, past
    its stop); the arm's robots 4 and 5 with q2 = 0 and π, where its mass
    matrix's determinant d11·D − d12² is smallest, nearest zero; robot 6's
    state all NaN, robot 7's coordinate s // 2 NaN."""
    for r, a in enumerate(WORLD_HARD_ANGLES):
        for i in WORLD_ANGLES.get(name, (0,)):
            xs[r, i] = a
    if name == "arm":
        xs[4, 1], xs[5, 1] = 0.0, np.pi
    xs[6] = np.nan
    xs[7, xs.shape[1] // 2] = np.nan
    return xs


def bits_equal(a, b) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    import torch

    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs_diff(a, b) -> float:
    """max |a − b| over entries finite in both; inf where one is NaN and the
    other not."""
    import torch

    a, b = a.double(), b.double()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return float("inf")
    ok = ~torch.isnan(a)
    return float((a[ok] - b[ok]).abs().max()) if ok.any() else 0.0


def check_world_step(name: str, device: str = "cuda", digests: dict | None = None) -> dict:
    """K6 against the plain loop on the card for one world, in every
    WORLD_LAYOUT over WORLD_CYCLES chained cycles from the same states and
    actions (a fleet's strided, a column of its sequences):
    ``world_step.advance`` (new buffers) and ``advance_into`` (the state's
    own buffers, the histories at rows WORLD_HIST_ROW … through a device
    counter, the new x into a buffer of its own and the counter advanced, as
    the device episode's cycle runs it) against ``plain_advance``; every
    leaf, xs[row + 1], us[row], ts[row], the x buffer, the counter and the
    untouched history rows. Returns the largest |Δ| (0.0: bit-equal
    everywhere) and the number of launches made; with `digests`, adds to it
    the digest of each layout's K6 outputs after its cycles (the new buffers'
    and the in-place leaves, the histories, the x buffer and the counter)."""
    import torch

    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import world_step as ws

    cfg = world_config(name)
    world = make_world(cfg, device=device)
    p = world.params
    worst, bit_equal, launches = 0.0, True, 0
    for label, n, clocks, states in WORLD_LAYOUTS:
        xs, us = world_inputs(name, cfg, n or 8, states=states)
        t = world_clocks(clocks, n or 8, p)
        if n is None:
            xs, us = xs[0], us[:, 0]
        start = world.from_x(torch.from_numpy(xs).to(device), torch.from_numpy(np.asarray(t)).to(device))
        plain = k6 = type(start)(*(leaf.contiguous() for leaf in start))
        into = type(start)(*(leaf.clone(memory_format=torch.contiguous_format) for leaf in start))
        rows = WORLD_HIST_ROW + WORLD_CYCLES + 2
        lead = () if n is None else (n,)
        f32 = dict(dtype=torch.float32, device=device)
        hx = torch.full((rows + 1, *lead, cfg.state_dim), -7.0, **f32)
        hu = torch.full((rows, *lead, cfg.action_dim), -7.0, **f32)
        ht = torch.full((rows, *start.time.shape), -7.0, **f32)
        step = torch.tensor(WORLD_HIST_ROW, dtype=torch.int64, device=device)
        x_buf = torch.full((*lead, cfg.state_dim), -7.0, **f32)
        before = sum(ws.launch_counts().values())
        # the actions as a controller gives them: a fleet's, a column of its
        # sequences (robots strided), a solo robot's one row of its own
        seqs = torch.from_numpy(np.ascontiguousarray(np.moveaxis(us, 0, -2))).to(device)
        for c in range(WORLD_CYCLES):
            u = seqs[..., c, :]
            plain = ws.plain_advance(world, plain, u)
            k6 = ws.advance(world, k6, u)
            ws.advance_into(world, into, u, hx, hu, ht, step, x_buf)
            row = WORLD_HIST_ROW + c
            pairs = [(f"{label} cycle {c} leaf {i}", a, b) for i, (a, b) in enumerate(zip(k6, plain))]
            pairs += [(f"{label} cycle {c} in place leaf {i}", a, b)
                      for i, (a, b) in enumerate(zip(into, plain))]
            pairs += [(f"{label} cycle {c} xs[{row + 1}]", hx[row + 1], plain.x),
                      (f"{label} cycle {c} us[{row}]", hu[row], u),
                      (f"{label} cycle {c} ts[{row}]", ht[row], plain.time),
                      (f"{label} cycle {c} x buffer", x_buf, plain.x)]
            for what, a, b in pairs:
                if not bits_equal(a, b):
                    bit_equal = False
                    d = max_abs_diff(a, b)
                    worst = max(worst, d)
                    expect(d <= WORLD_STEP_TOL[name],
                           f"K6 {name} {what}: max |K6 - plain| {d:.3g} (tolerance {WORLD_STEP_TOL[name]})")
            expect(int(step) == row + 1, f"K6 {name} {label} cycle {c}: the counter reads "
                   f"{int(step)} after the cycle at row {row}, want {row + 1}")
        launches += sum(ws.launch_counts().values()) - before
        if digests is not None:
            digests[f"K6 {name} {label}"] = digest(*k6, *into, hx, hu, ht, x_buf, step)
        untouched = [hx[:WORLD_HIST_ROW + 1], hx[WORLD_HIST_ROW + WORLD_CYCLES + 1:],
                     hu[:WORLD_HIST_ROW], hu[WORLD_HIST_ROW + WORLD_CYCLES:],
                     ht[:WORLD_HIST_ROW], ht[WORLD_HIST_ROW + WORLD_CYCLES:]]
        expect(all(bool((h == -7.0).all()) for h in untouched),
               f"K6 {name} {label}: a history row outside the cycles' was written")
    want = 2 * WORLD_CYCLES * len(WORLD_LAYOUTS) if device == "cuda" else 0  # the CPU: plain
    expect(launches == want, f"K6 {name}: {launches} launches counted, want {want}")
    return dict(max_abs_err=worst, bit_equal=bit_equal, launches=launches)


WORLD_OPS = ("add", "sub", "mul", "div", "neg", "sin", "cos", "rsqrt", "clamp", "abs", "gt", "ge",
             "where", "maximum", "minimum", "reciprocal", "pow", "sum")


def plain_world_ops(world, state, u) -> int:
    """The float operations of one plain cycle on these inputs: the output
    elements of every arithmetic, comparison and select op that
    ``plain_advance`` dispatches (a sin, a clamp or a where counted as one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from mppi_gpu_tpu_torch.ops import world_step as ws

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in WORLD_OPS:
                count[0] += out.numel()
            return out

    with Count():
        ws.plain_advance(world, state, u)
    return count[0]


def world_step_bound(world, state, u, hist: bool) -> tuple[float, str, int]:
    """The least time the card could take for one K6 cycle on these inputs:
    the larger of its operations (:func:`plain_world_ops`) over the float32
    peak (67 TFLOP/s) and its bytes (the state, the clock, u and the pack
    read once; the new state and clock written once, and with `hist` the
    history rows, the episode's x buffer and the counter) over 3.35 TB/s.
    Returns (ms, what bounds it, operations)."""
    ops = plain_world_ops(world, state, u)
    floats = 2 * sum(leaf.numel() for leaf in state) + u.numel() + world._packs[u.device].numel()
    if hist:  # the history rows, the x buffer, the counter read and written (2 floats each)
        floats += 2 * state.x.numel() + u.numel() + state.time.numel() + 4
    t_ops, t_bytes = ops / H100_FP32_PER_S, 4 * floats / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops


def world_step_times(name: str, R: int | None, device: str = "cuda") -> dict:
    """K6's times at one world's episode shape (R None: one robot, the solo
    episode's): ``advance_into`` as the episode's cycle calls it (the x
    buffer and the counter's advance too), CUDA events around a call (warm
    median of 50) and the device time alone; the plain cycle it replaced
    (``advance``, the history copies, the x copy and the counter's add as the
    cycle ran them before K6) by events; and the bound. The tensors lie on
    `device` (the card's; the CPU only where a test stubs the timers)."""
    import torch

    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import world_step as ws

    cfg = world_config(name)
    world = make_world(cfg, device=device)
    state = world.reset(R)
    state = type(state)(*(leaf.clone(memory_format=torch.contiguous_format) for leaf in state))
    lead = () if R is None else (R,)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.full((*lead, cfg.action_dim), 0.1, **f32)
    n = 4096  # history rows past every call's counter
    hx = torch.zeros((n + 1, *lead, cfg.state_dim), **f32)
    hu, ht = torch.zeros((n, *lead, cfg.action_dim), **f32), torch.zeros(n, **f32)
    step = torch.zeros((), dtype=torch.int64, device=device)
    x = torch.zeros((*lead, cfg.state_dim), **f32)

    def kernel():
        ws.advance_into(world, state, u, hx, hu, ht, step, x)

    def plain():
        new = ws.plain_advance(world, state, u)
        for buf, v in zip(state, new):
            buf.copy_(v)
        row = step.view(1)
        hx.index_copy_(0, row + 1, new.x.unsqueeze(0))
        hu.index_copy_(0, row, u.unsqueeze(0))
        ht.index_copy_(0, row, new.time.reshape(1))
        x.copy_(new.x)
        step.add_(1)

    ms, plain_ms = paired_median_ms(kernel, plain, 50, 10)
    step.zero_()
    bound, bound_by, ops = world_step_bound(world, state, u, hist=True)
    return dict(ms=ms, plain_ms=plain_ms, device_ms=device_ms(kernel, name="world_advance_kernel"),
                bound_ms=bound, bound_by=bound_by, ops=ops)


def world_cycle_records(name: str, calls: int = 3) -> list[str]:
    """The device records of `calls` world cycles on the card
    (``advance_into``, as an episode's cycle runs it) under torch.profiler:
    the names of every kernel and copy the world's part of a cycle launches.
    As in :func:`replay_trace`, the window holds REPLAY_TRACE_EDGE cycles, a
    marker kernel, the `calls` counted cycles, a second marker and
    REPLAY_TRACE_EDGE more, and only the records between the markers are
    read (late in this script a window's first records go missing: with 5
    cycles on each edge the arm's three windows in a row once held no
    marker, on an H100); a window without both markers is read
    again, five at most."""
    import torch
    from torch.profiler import ProfilerActivity

    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import world_step as ws

    cfg = world_config(name)
    world = make_world(cfg, device="cuda")
    state = world.reset()
    u = torch.zeros(cfg.action_dim, device="cuda")
    hx, hu = torch.zeros(3, cfg.state_dim, device="cuda"), torch.zeros(2, cfg.action_dim, device="cuda")
    ht, step = torch.zeros(2, device="cuda"), torch.zeros((), dtype=torch.int64, device="cuda")
    x = torch.zeros(cfg.state_dim, device="cuda")

    def cycles(n: int) -> None:
        for _ in range(n):
            ws.advance_into(world, state, u, hx, hu, ht, step, x)

    cycles(1)
    torch.cuda.synchronize()
    held = []
    for _ in range(5):
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cycles(REPLAY_TRACE_EDGE)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            cycles(calls)
            torch.cuda._sleep(1000)
            cycles(REPLAY_TRACE_EDGE)
            torch.cuda.synchronize()
        dev = device_records(prof)
        marks = sorted((e.time_range for e in dev if "spin_kernel" in e.name), key=lambda r: r.start)
        if len(marks) == 2:
            t0, t1 = marks[0].end, marks[1].start
            return [e.name for e in dev if e.time_range.start >= t0 and e.time_range.end <= t1]
        held.append(f"{len(marks)} markers in {len(dev)} records")
    raise SmokeFailure(f"K6 {name}: no profiler window of 5 held both markers ({held})")


def world_entries(episode: dict) -> list[dict]:
    """The kernels line's K6 entries, one per world body, from phase 21: its
    launches in the eager backend's device episodes (which must be at least
    one; the fused episodes step the world in K2''s epilogue), its largest
    difference from the plain loop, and its times at the solo and R=8
    episode shapes."""
    from mppi_gpu_tpu_torch.ops import world_step as ws

    out = []
    for kind, (_, _, _, line) in ws.WORLDS.items():
        cases = [c for c in WORLD_CASES if ws.pack_fields(_world_of(c))[0] == kind]
        r = episode["world"][cases[0]]
        launches = episode["k6_launches"][kind]
        expect(launches > 0, f"K6 {kind}: no launch in phase 21's eager-backend episodes")
        solo, fleet = r["solo"], r["fleet"]
        out.append({
            "name": f"world_advance<{kind}>", "route": "cuda", "source": WORLD_SOURCE,
            "replaces": WORLD_REPLACES, "launches": launches,
            "max_abs_err": max(episode["world"][c]["max_abs_err"] for c in cases),
            "ms": solo["ms"], "plain_ms": solo["plain_ms"], "bound_ms": solo["bound_ms"],
            "bound_by": solo["bound_by"], "library_ms": None, "device_ms": solo["device_ms"],
            "shape": f"{cases[0]} world, R=1 (a solo episode's cycle)", "worlds": cases,
            "bit_equal": all(episode["world"][c]["bit_equal"] for c in cases),
            "fleet_ms": fleet["ms"], "fleet_plain_ms": fleet["plain_ms"],
            "fleet_device_ms": fleet["device_ms"], "fleet_bound_ms": fleet["bound_ms"],
            "fleet_shape": "R=8, one shared clock"})
    return out


def _world_of(name: str, device: str = "cpu"):
    from mppi_gpu_tpu_torch.envs import make_world

    return make_world(world_config(name), device=device)


def world_step_phase(smi: str) -> dict:
    """K6 on the card: every world against its plain loop
    (:func:`check_world_step`; the tolerance WORLD_STEP_TOL), the device
    records of three world cycles (K6 alone, once each), and K6's times at the solo and
    R=8 episode shapes beside the plain cycle's and the bound. Returns
    {world: readings}."""
    from mppi_gpu_tpu_torch.ops import world_step as ws

    out = {}
    t0 = time.perf_counter()
    same = ws.identities()
    secs = time.perf_counter() - t0
    for k, (n, first) in same.items():
        expect(n == 0, f"K6's substitution {ws.IDENTITIES[k]}: {n} of the 2^32 float inputs give "
               f"other bits, the first 0x{first or 0:08x}")
    print(f"[21] K6's float substitutions over all 2^32 inputs on the card, in {secs:.2f} s: "
          + ", ".join(f"{ws.IDENTITIES[k]}: {n} differ" for k, (n, _) in same.items())
          + f" ({smi})")
    out["identities"] = same
    for name in WORLD_CASES:
        got = check_world_step(name)
        records = world_cycle_records(name)
        expect(len(records) == 3 and all("world_advance_kernel" in r for r in records),
               f"K6 {name}: three world cycles on the card launched {records}, want K6 alone, "
               "once each")
        solo, fleet = world_step_times(name, None), world_step_times(name, 8)
        out[name] = dict(got, solo=solo, fleet=fleet)
        agree = "bit-equal" if got["bit_equal"] else f"max |delta| {got['max_abs_err']:.3g}"
        print(f"[21] K6 world_advance {name}: {agree} to the plain loop over {len(WORLD_LAYOUTS)} "
              f"layouts x {WORLD_CYCLES} cycles (solo, R=8, R=64, shared and per-robot clocks, "
              f"crossing sim_end, NaN state and action; angles of 1e5-7.8e12, the arm at q2 = 0 "
              f"and pi; histories at rows {WORLD_HIST_ROW}-"
              f"{WORLD_HIST_ROW + WORLD_CYCLES - 1}, the rest untouched); three cycles' device "
              f"records: {len(records)} of {sorted(set(records))}; solo {solo['ms']:.4f} ms by events, device {solo['device_ms']}, the plain "
              f"cycle {solo['plain_ms']:.4f}, bound {solo['bound_ms']:.3g} ({solo['bound_by']}, "
              f"{solo['ops']} operations); R=8 {fleet['ms']:.4f}, device {fleet['device_ms']}, plain "
              f"{fleet['plain_ms']:.4f}, bound {fleet['bound_ms']:.3g} ({smi})")
    return out


# ---------------------------------------------------------------------------
# K7 solve_tail (phase 21): the tail of one MPPI update for R robots per
# launch, against its plain version (ops/solve_tail.solve_tail_reference)

TAIL_SOURCE = "mppi_gpu_tpu_torch/csrc/solve_tail.cu"
TAIL_REPLACES = ("no Pallas kernel: XLA's fusion of the solve's tail, mppi_gpu_tpu/controller.py:504, "
                 "522-531 (solve_from_costs :261-268)")
# how far K7 may part from the plain tail on the card: not at all. u_seq,
# u_next and action are one add and a min/max, each rounded once; the weights
# repeat torch's sub, neg, product with float32(1/λ) (torch's CUDA division
# by a Python float, :func:`reciprocal_probe`), expf and true division, each
# rounded once alike (csrc/solve_tail.cu)
TAIL_TOL = 0.0
TAIL_WEIGHTS_TOL = 0.0
# (robots, None: one robot), T, A and K of the cases; each runs with the
# clamp on and off, and with a NaN in ΔU and a diverged rollout (S = +inf).
# Past the configs' shapes: T·A at K7's round of 1024 entries ±1 (1023, 1024,
# 1025), two rounds and one entry (2049), and the row's limit in shared
# memory (58112 floats)
TAIL_SHAPES = tuple((R, T, A, 3000) for R in (None, 8, 64) for T in (1, 200) for A in range(1, 5)) + (
    (None, 341, 3, 3000), (None, 256, 4, 3000), (None, 1025, 1, 3000), (8, 205, 5, 3000),
    (None, 2049, 1, 3000), (None, 14528, 4, 3000), (8, 14528, 4, 3000))
TAIL_MODES = (("clamp", True, False), ("no clamp", False, False), ("clamp, NaN", True, True))
# the configs' λ and four others; at 1.1 and 1.7 the float32 reciprocal
# 1.0f/(float)λ and float32(1/λ) are two floats
TAIL_LAMS = (0.1, 0.2, 0.3, 1.0, 1.5, 0.7, 1.3, 1.1, 1.7)
# the divisors reciprocal_probe tries beside TAIL_LAMS and the worlds' packs
PROBE_LAMS = (1.1, 1.7, 0.064, 1.0 / 3.0)


def tail_inputs(R, T: int, A: int, K: int, lam: float, nan: bool, device: str, seed: int = 0):
    """U, ΔU (T, A) or (R, T, A), max_a (A,) and the softmin (S, β, η, λ) of
    one case, from a numpy seed; U past the bounds in places; β and η views
    of one (…, 2) tensor as K2 writes them (a fleet's strided); with `nan`, a
    NaN in ΔU at step T // 2 and one rollout's cost +inf (weight 0)."""
    import torch

    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    U = rng.uniform(-1.5, 1.5, lead + (T, A)).astype(np.float32)
    dU = rng.normal(0.0, 0.5, lead + (T, A)).astype(np.float32)
    max_a = rng.uniform(0.3, 1.2, A).astype(np.float32)
    S = rng.uniform(0.0, 50.0, lead + (K,)).astype(np.float32)
    if nan:
        dU[..., T // 2, 0] = np.nan
        S[..., K // 3] = np.inf
    beta = S.min(-1)
    eta = np.exp(-(S.astype(np.float64) - beta[..., None]) / lam).sum(-1).astype(np.float32)
    be = torch.from_numpy(np.stack([beta, eta], -1)).to(device)

    def t(a):
        return torch.from_numpy(a).to(device)

    return t(U), t(dU), t(max_a), (t(S), be[..., 0], be[..., 1], lam)


def check_solve_tail(device: str = "cuda", shapes=TAIL_SHAPES, digests: dict | None = None) -> dict:
    """K7 against its plain version on `device`'s tensors for every shape of
    `shapes` in every TAIL_MODES mode, each at one λ of TAIL_LAMS in turn:
    the full tail (u_seq, u_next, action and the weights, as ``solve``'s
    result), the updated sequence alone (an inner opt iteration) and the
    cycle's form (action, and u_next written over U itself); every output
    bit for bit against ``solve_tail_reference`` (TAIL_TOL, TAIL_WEIGHTS_TOL),
    an output not asked for None. Returns the largest |Δ| of the sequences
    and of the weights (0.0: bit-equal), whether all were bit-equal, and the
    launches made (three per case on the card, none on the CPU); with
    `digests`, adds to it the digest of each case's K7 outputs in its three
    forms."""
    import torch

    from mppi_gpu_tpu_torch.controller import CYCLE, FULL, ITERATE
    from mppi_gpu_tpu_torch.ops import solve_tail as st

    worst, worst_w, bit_equal = 0.0, 0.0, True
    before, cases = st.launch_counts()["solve_tail"], 0

    def hold(what, got, want, tol):
        nonlocal bit_equal
        if bits_equal(got, want):
            return 0.0
        bit_equal = False
        d = max_abs_diff(got, want)
        expect(d <= tol, f"K7 {what}: max |K7 - plain| {d:.3g} (tolerance {tol})")
        return d

    for i, (R, T, A, K) in enumerate(shapes):
        for j, (mode, clamp, nan) in enumerate(TAIL_MODES):
            lam = TAIL_LAMS[(i * len(TAIL_MODES) + j) % len(TAIL_LAMS)]
            U, dU, max_a, softmin = tail_inputs(R, T, A, K, lam, nan, device, seed=i)
            label = f"R={R or 1} T={T} A={A} K={K} {mode} lambda={lam}"
            want = st.solve_tail_reference(U, dU, max_a, clamp, FULL, softmin)
            full = st.solve_tail(U, dU, max_a, clamp, FULL, softmin)
            for name in ("u_seq", "u_next", "action"):
                worst = max(worst, hold(f"{label} {name}", getattr(full, name), getattr(want, name),
                                        TAIL_TOL))
            worst_w = max(worst_w, hold(f"{label} weights", full.weights, want.weights,
                                        TAIL_WEIGHTS_TOL))
            seq = st.solve_tail(U, dU, max_a, clamp, ITERATE)
            expect(seq.u_next is None and seq.action is None and seq.weights is None,
                   f"K7 {label}: the iteration's tail wrote more than u_seq")
            worst = max(worst, hold(f"{label} u_seq alone", seq.u_seq, want.u_seq, TAIL_TOL))
            inplace = U.clone()
            cyc = st.solve_tail(inplace, dU, max_a, clamp, CYCLE, into=inplace)
            expect(cyc.u_next is inplace and cyc.u_seq is None and cyc.weights is None,
                   f"K7 {label}: the cycle's tail did not shift U in place alone")
            worst = max(worst, hold(f"{label} u_next in place", inplace, want.u_next, TAIL_TOL),
                        hold(f"{label} action of the cycle", cyc.action, want.action, TAIL_TOL))
            if digests is not None:
                digests[f"K7 {label}"] = digest(*full, seq.u_seq, inplace, cyc.action)
            cases += 1
    launches = st.launch_counts()["solve_tail"] - before
    want_launches = 3 * cases if device == "cuda" else 0  # the CPU: the plain version
    expect(launches == want_launches, f"K7: {launches} launches counted, want {want_launches}")
    return dict(max_abs_err=worst, weights_max_abs_err=worst_w, bit_equal=bit_equal,
                launches=launches, cases=cases)


def reciprocal_probe(n: int = 1 << 20) -> dict:
    """How torch's CUDA division of a float32 tensor by a Python float c
    rounds, over n values of many magnitudes, at every divisor the worlds
    pack (``world_step.Reciprocal`` fields of WORLD_CASES' worlds), at
    PROBE_LAMS and at TAIL_LAMS: the share of quotients that differ from the
    product with 1.0f/(float)c, from the product with float32(1/c) (the
    double reciprocal rounded once), from the product with the factor of
    ``_rounding.scalar_reciprocal`` (which K6's packs and K7's λ take), and
    from the true division by a float32 device scalar c."""
    import torch

    from mppi_gpu_tpu_torch.ops import _rounding
    from mppi_gpu_tpu_torch.ops import world_step as ws

    g = torch.Generator(device="cuda").manual_seed(11)
    d = torch.randn(n, device="cuda", generator=g) * torch.exp2(
        torch.randint(-20, 20, (n,), device="cuda", generator=g).float())
    divisors = {f"lambda {lam}": lam for lam in (*PROBE_LAMS, *TAIL_LAMS)}
    for name in WORLD_CASES:
        world = _world_of(name)
        kind, own = world.kernel_params()
        divisors.update({f"{name} {k}": v.divisor for k, v in own.items()
                         if isinstance(v, ws.Reciprocal)})

    def share(q, factor) -> float:
        return float((q != d * torch.tensor(factor, dtype=torch.float32, device="cuda"))
                     .float().mean())

    out = {}
    for label, c in divisors.items():
        q = d / c
        out[label] = dict(
            c=c, recip_f32=share(q, float(np.float32(1.0) / np.float32(c))),
            recip_f64=share(q, float(np.float32(1.0 / c))),
            helper=share(q, _rounding.scalar_reciprocal(c)),
            true_div=float((q != d / torch.tensor(c, dtype=torch.float32, device="cuda"))
                           .float().mean()))
    return out


def tail_bound(R: int, T: int, A: int, K: int, outputs, clamp: bool = True) -> tuple[float, str]:
    """The least time the card could take for one tail: the larger of its
    bytes (U and ΔU read, max_a, and with the weights S, β and η; each output
    asked for written once) over 3.35 TB/s and its operations (an add and,
    clamped, two comparisons per entry; five per weight) over the float32
    peak. Returns (ms, what bounds it)."""
    n = R * T * A
    floats = 2 * n + A + n * (("u_seq" in outputs) + ("u_next" in outputs))
    floats += R * A * ("action" in outputs)
    ops = n * (3 if clamp else 1)
    if "weights" in outputs:
        floats += 2 * R * K + 2 * R
        ops += 5 * R * K
    t_bytes, t_ops = 4 * floats / H100_BYTES_PER_S, ops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def tail_times(R, T: int, A: int, K: int, outputs, lam: float = 1.0, device: str = "cuda") -> dict:
    """K7's times at one shape: CUDA events around a call (warm median) in
    turns with the plain tail's, the device time alone, and the bound; the
    cycle's form (no u_seq) writes u_next over U, as the episode does. The
    tensors lie on `device` (the card's; the CPU only where a test stubs the
    timers)."""
    from mppi_gpu_tpu_torch.ops import solve_tail as st

    U, dU, max_a, softmin = tail_inputs(R, T, A, K, lam, False, device)
    softmin = softmin if "weights" in outputs else None
    into = U if "u_seq" not in outputs else None

    def kernel():
        st.solve_tail(U, dU, max_a, True, outputs, softmin, into)

    def plain():
        st.solve_tail_reference(U, dU, max_a, True, outputs, softmin, into)

    ms, plain_ms = paired_median_ms(kernel, plain, 50, 20)
    bound, bound_by = tail_bound(R or 1, T, A, K, outputs)
    return dict(ms=ms, plain_ms=plain_ms, device_ms=device_ms(kernel, name="solve_tail_kernel"),
                bound_ms=bound, bound_by=bound_by)


def solve_tail_phase(smi: str) -> dict:
    """K7 on the card: every case of :func:`check_solve_tail` against the
    plain tail (TAIL_TOL, TAIL_WEIGHTS_TOL), how torch divides by a Python
    float (:func:`reciprocal_probe`), and K7's times beside the plain tail's
    and the bound at the flagship's shape (R=1, T=200, A=3, K=10⁴) as
    ``solve`` runs it (every output) and as the episode's cycle runs it
    (action and U shifted in place), and at the R=8 fleet's."""
    import torch

    from mppi_gpu_tpu_torch.controller import CYCLE, FULL

    probe = reciprocal_probe()
    for label, c in probe.items():
        expect(c["helper"] == 0, f"torch's division by the Python float {label} on the card is "
               f"not the product with _rounding.scalar_reciprocal's factor: {c}")
    apart = {k: v for k, v in probe.items() if v["recip_f32"] != v["recip_f64"]}
    got = check_solve_tail()
    times = {"full": tail_times(None, 200, 3, 10_000, FULL),
             "cycle": tail_times(None, 200, 3, 10_000, CYCLE),
             "fleet": tail_times(8, 200, 3, 10_000, FULL)}
    agree = ("bit-equal" if got["bit_equal"] else
             f"max |delta| {got['max_abs_err']:.3g}, weights {got['weights_max_abs_err']:.3g}")
    print(f"[21] K7 solve_tail: {agree} to the plain tail over {got['cases']} cases (R=1, 8, 64; "
          f"T=1, 200; A=1-4; T·A 1023-1025, 2049, 58112; clamp on and off; a NaN in dU and a diverged rollout; the full tail, "
          f"u_seq alone, the cycle's in place), {got['launches']} launches; torch's division by a "
          f"Python float c on the card (torch {torch.__version__}, CUDA {torch.version.cuda}): "
          f"at every one of {len(probe)} divisors "
          f"its quotient is the product with _rounding.scalar_reciprocal(c) = float32(1/c); "
          f"where 1.0f/(float)c is another float, the shares of quotients that differ from the "
          f"product with 1.0f/(float)c, with float32(1/c) and from the true division: "
          + ", ".join(f"{k} {v['recip_f32']:.4f} {v['recip_f64']:.4f} {v['true_div']:.4f}"
                      for k, v in apart.items()) + "; "
          + "; ".join(f"{k} {v['ms']:.4f} ms by events, device {v['device_ms']}, plain "
                      f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.3g} ({v['bound_by']})"
                      for k, v in times.items()) + f" ({smi})")
    return dict(got, probe=probe, times=times)


def tail_entry(tail: dict, launches: int) -> dict:
    """The kernels line's K7 entry: its launches on the main path (phase 7),
    its largest difference from the plain tail, and its times at the
    flagship shape as ``solve`` runs it, beside those of the cycle's form and
    the R=8 fleet's."""
    full, cyc, fleet = (tail["times"][k] for k in ("full", "cycle", "fleet"))
    return {"name": "solve_tail", "route": "cuda", "source": TAIL_SOURCE, "replaces": TAIL_REPLACES,
            "launches": launches, "max_abs_err": max(tail["max_abs_err"], tail["weights_max_abs_err"]),
            "ms": full["ms"], "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
            "bound_by": full["bound_by"], "library_ms": None, "device_ms": full["device_ms"],
            "shape": "R=1 T=200 A=3 K=10000, every output (solve)", "bit_equal": tail["bit_equal"],
            "cycle_ms": cyc["ms"], "cycle_plain_ms": cyc["plain_ms"],
            "cycle_device_ms": cyc["device_ms"], "cycle_bound_ms": cyc["bound_ms"],
            "cycle_shape": "R=1 T=200 A=3, action and u_next in place (the episode's cycle)",
            "fleet_ms": fleet["ms"], "fleet_plain_ms": fleet["plain_ms"],
            "fleet_device_ms": fleet["device_ms"], "fleet_bound_ms": fleet["bound_ms"],
            "fleet_shape": "R=8 T=200 A=3 K=10000, every output"}


# ---------------------------------------------------------------------------
# K2' combine_tail (phase 21): K2 with the tail and the world's step as its
# epilogue, against the cycle of four kernels it replaced (K1, K2, K7, K6)

EPILOGUE_SOURCE = "mppi_gpu_tpu_torch/csrc/combine_tail.cu"
EPILOGUE_REPLACES = (f"no Pallas kernel of its own: K2's fold ({PALLAS}:1847, 2257) with XLA's "
                     "fusion of the solve's tail and of the world's simulate, "
                     "mppi_gpu_tpu/controller.py:504, 522-531, mppi_gpu_tpu/runner.py:375-383")
# how far the epilogue cycle may part from the four-kernel cycle on the card:
# not at all. Its fold, tail and world step are the same device functions
# (softmin_combine.cuh, solve_tail.cuh, world_step.cuh) in the same order
EPILOGUE_TOL = 0.0
# against its plain version (ops/combine_tail.combine_tail_reference): β, η
# and ΔU within K2's tolerances of :func:`check_kernels` (K2 and its plain
# version sum in other orders); the tail and the world step on K2''s own ΔU
# and action bit for bit, as K7's and K6's
EPILOGUE_PLAIN_TOL = dict(beta=1e-7, eta=1e-5, dU=(1e-4, 1e-6))
# the fleets of the cycle check: (robots, None: one robot; clocks): a shared
# clock, per-robot clocks (some at or past sim_end: held) and a NaN state
EPILOGUE_FLEETS = ((None, "shared"), (8, "shared"), (8, "per-robot"), (64, "nan"))
EPILOGUE_CYCLES = 3


def four_kernel_cycle(ctrl, x, U, seed, step, advance) -> None:
    """One device-episode cycle as the parent ran it: each update K1 and K2
    (``family_fused_solve``, the fleet's for a fleet), then K7 (the inner
    updates' u_seq, the last one's action and U shifted in place), then K6
    (``advance_into``) under the action."""
    from mppi_gpu_tpu_torch.controller import CYCLE, ITERATE
    from mppi_gpu_tpu_torch.ops import families
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import solve_tail as st
    from mppi_gpu_tpu_torch.ops import world_step as ws

    cfg = ctrl.cfg
    goal = families.call_goal(ctrl._family, ctrl.cost)

    def update(Uin, it, outputs, into):
        args = (ctrl._family, x, Uin, goal, cfg.lambda_, cfg.samples, seed, step, it,
                cfg.antithetic, cfg.noise_beta)
        S, beta, eta, dU = (fs.fleet_family_fused_solve(*args, n_robots=ctrl.n_robots)
                            if Uin.dim() == 3 else fs.family_fused_solve(*args))
        return st.solve_tail(Uin, dU, ctrl.max_a, cfg.clamp_action, outputs, into=into)

    for j in range(cfg.opt_iters - 1):
        U_it = update(U if j == 0 else U_it, j, ITERATE, None).u_seq
    last = U if cfg.opt_iters == 1 else U_it
    action = update(last, cfg.opt_iters - 1, CYCLE, U).action
    ws.advance_into(advance.world, advance.state, action, advance.xs, advance.us, advance.ts, step,
                    advance.x)


def _episode_buffers(world, state0, U0, n: int, device: str):
    """An episode's buffers as ``runner.EpisodeCycle`` holds them: an
    ``Advance`` of the state's copy, histories of n rows and the x buffer,
    U's copy and the counter (0), on `device`."""
    import torch

    from mppi_gpu_tpu_torch.ops import world_step as ws

    state = type(state0)(*(leaf.clone(memory_format=torch.contiguous_format) for leaf in state0))
    f32 = dict(dtype=torch.float32, device=device)
    lead = tuple(U0.shape[:-2])
    adv = ws.Advance(world, state, torch.full((n + 1, *lead, state.x.shape[-1]), -7.0, **f32),
                     torch.full((n, *lead, U0.shape[-1]), -7.0, **f32),
                     torch.full((n, *state.time.shape), -7.0, **f32), state.x.clone())
    adv.xs[0].copy_(state.x)
    return adv, U0.clone(), torch.zeros((), dtype=torch.int64, device=device)


def check_epilogue_cycle(name: str, R, clocks: str, opt_iters: int, device: str = "cuda") -> dict:
    """EPILOGUE_CYCLES device-episode cycles of config `name` at `opt_iters`
    for R robots (None: one robot) under `clocks` (EPILOGUE_FLEETS), from
    the world's start (robots apart in their states, per-robot clocks from
    :func:`world_clocks`' mixed layout, the last robot's state NaN), through
    ``solve_in_place(..., advance)`` (K1 and K2' per update on the card)
    and through :func:`four_kernel_cycle` from the same buffers: x, U, the
    state and its clock, the histories and the counter bit for bit
    (EPILOGUE_TOL), the tickets 0 after every cycle, and the launches of
    each (K1 and K2' per update; K1, K2 and K7 per update and K6 per cycle;
    none on the CPU, where both run the plain versions). Returns whether all
    were bit-equal and the largest |Δ| otherwise."""
    import torch

    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.envs import make_world

    cfg = _episode_config(name).replace(opt_iters=opt_iters)
    ctrl = (MPPIController(cfg, device=device) if R is None
            else BatchedMPPIController(cfg, R, device=device))
    ctrl.rollout_backend = "fused"
    world = make_world(cfg, device=device)
    state0 = world.reset(R)
    if R is not None:  # robots apart, from the world's start
        x0 = state0.x + 0.01 * torch.arange(R, device=device)[:, None]
        if clocks == "nan":
            x0[-1] = float("nan")
        t0 = (torch.from_numpy(np.asarray(world_clocks("mixed", R, world.params))).to(device)
              if clocks == "per-robot" else state0.time)
        state0 = world.from_x(x0, t0)
    U0 = ctrl.init_action_seq() if R is None else ctrl.init_action_seqs()
    seed = cfg.seed if R is None else ctrl.init_seeds()
    n = EPILOGUE_CYCLES + 2
    epi, U_e, step_e = _episode_buffers(world, state0, U0, n, device)
    four, U_f, step_f = _episode_buffers(world, state0, U0, n, device)
    worst, equal = 0.0, True
    label = f"K2' {name} R={R or 1} {clocks} clock(s) x{opt_iters}"
    for c in range(EPILOGUE_CYCLES):
        _, got = counted(lambda: ctrl.solve_in_place(epi.x, U_e, seed, step_e, epi))
        _, want = counted(lambda: four_kernel_cycle(ctrl, four.x, U_f, seed, step_f, four))
        if device == "cuda":
            kind = f"world_advance<{world._kernel_kind}>"
            expect(got == {"solve_partials": opt_iters, "combine_tail": opt_iters},
                   f"{label} cycle {c}: the epilogue cycle launched {got}")
            expect(want == {"solve_partials": opt_iters, "softmin_combine": opt_iters,
                            "solve_tail": opt_iters, kind: 1},
                   f"{label} cycle {c}: the four-kernel cycle launched {want}")
        expect(not bool(ctrl._tickets.any()), f"{label} cycle {c}: tickets {ctrl._tickets} left")
        pairs = [("x", epi.x, four.x), ("U", U_e, U_f), ("xs", epi.xs, four.xs),
                 ("us", epi.us, four.us), ("ts", epi.ts, four.ts)]
        pairs += [(f"state leaf {i}", a, b) for i, (a, b) in enumerate(zip(epi.state, four.state))]
        for what, a, b in pairs:
            if not bits_equal(a, b):
                equal = False
                d = max_abs_diff(a, b)
                worst = max(worst, d)
                expect(d <= EPILOGUE_TOL, f"{label} cycle {c} {what}: max |K2' cycle - four-kernel "
                       f"cycle| {d:.3g} (tolerance {EPILOGUE_TOL})")
        expect(int(step_e) == int(step_f) == c + 1, f"{label} cycle {c}: the counters read "
               f"{int(step_e)} and {int(step_f)}, want {c + 1}")
    return dict(bit_equal=equal, max_abs_err=worst)


def check_epilogue_plain(name: str, R, device: str = "cuda") -> dict:
    """K2' (the cycle's form, with the world's step) against its plain
    version on the same inputs (K1's partials at config `name`'s shape, R
    robots, None: one): β, η and ΔU against K2's plain version within
    EPILOGUE_PLAIN_TOL; the action and U shifted in place against K7's plain
    version on K2''s own ΔU, and the world's state, histories, x buffer and
    counter against the plain loop under K2''s own action, bit for bit.
    Returns ΔU's largest |Δ|."""
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import CYCLE, MPPIController
    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import combine_tail as ct
    from mppi_gpu_tpu_torch.ops import families
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import solve_tail as st
    from mppi_gpu_tpu_torch.ops import world_step as ws

    cfg = _episode_config(name)
    ctrl = (MPPIController(cfg, device=device) if R is None
            else BatchedMPPIController(cfg, R, device=device))
    world = make_world(cfg, device=device)
    state0 = world.reset(R)
    U0 = ctrl.init_action_seq() if R is None else ctrl.init_action_seqs()
    goal = families.call_goal(ctrl._family, ctrl.cost)
    args = (ctrl._family, state0.x, U0, goal, cfg.lambda_, cfg.samples,
            cfg.seed if R is None else ctrl.init_seeds(), 3, 0, cfg.antithetic, cfg.noise_beta)
    _, partials = (fs.family_solve_partials(*args) if R is None
                   else fs.fleet_family_solve_partials(*args, None, R))
    adv, U, step = _episode_buffers(world, state0, U0, 4, device)
    beta, eta, dU, tail = ct.combine_tail(partials, cfg.lambda_, U, ctrl.max_a, cfg.clamp_action,
                                          CYCLE, ctrl._tickets, into=U, step=step, advance=adv)
    combine = fs.softmin_combine_reference if R is None else fs.fleet_softmin_combine_reference
    b_r, e_r, dU_r = combine(partials, cfg.lambda_, cfg.horizon, cfg.action_dim)
    label = f"K2' {name} R={R or 1} vs plain"
    close(f"{label} beta", _np(beta), _np(b_r), EPILOGUE_PLAIN_TOL["beta"])
    close(f"{label} eta", _np(eta), _np(e_r), EPILOGUE_PLAIN_TOL["eta"])
    err = close(f"{label} dU", _np(dU), _np(dU_r), *EPILOGUE_PLAIN_TOL["dU"])
    want = st.solve_tail_reference(U0, dU, ctrl.max_a, cfg.clamp_action, CYCLE)
    plain = ws.plain_advance(world, state0, want.action)
    pairs = [("action", tail.action, want.action), ("U shifted", U, want.u_next),
             ("xs[1]", adv.xs[1], plain.x), ("us[0]", adv.us[0], want.action),
             ("ts[0]", adv.ts[0], plain.time), ("x", adv.x, plain.x)]
    pairs += [(f"state leaf {i}", a, b) for i, (a, b) in enumerate(zip(adv.state, plain))]
    for what, a, b in pairs:
        expect(bits_equal(a, b), f"{label} {what}: not bit-equal to the plain version "
               f"(max |delta| {max_abs_diff(a, b):.3g})")
    expect(int(step) == 1 and not bool(ctrl._tickets.any()),
           f"{label}: counter {int(step)}, tickets {ctrl._tickets}")
    return dict(max_abs_err=err)


def epilogue_bound(nb: int, T: int, A: int, R: int, world, state, u) -> tuple[float, str]:
    """The least time the card could take for one K2' of the cycle's form:
    the larger of its bytes (K2's partials read and its β, η, ΔU written, U
    and max_a read, U shifted and the action written, and K6's bytes of the
    world's step with the histories) over 3.35 TB/s and its operations (K2's
    multiply-add per partial float, the tail's add and clamp per entry, the
    world's operations, :func:`plain_world_ops`) over the float32 peak."""
    n = R * T * A
    floats = R * (nb + 1) * (2 + T * A) + 2 * n + A + n + R * A
    floats += 2 * sum(leaf.numel() for leaf in state) + u.numel() + world._packs[u.device].numel()
    floats += 2 * state.x.numel() + u.numel() + state.time.numel() + 4
    ops = 2 * R * (nb + 1) * (2 + T * A) + 3 * n + plain_world_ops(world, state, u)
    t_bytes, t_ops = 4 * floats / H100_BYTES_PER_S, ops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def epilogue_times(name: str, R) -> dict:
    """K2''s times in the cycle's form at config `name`'s shape for R robots
    (None: one): CUDA events around a call (warm median) in turns with the
    plain version's (``combine_tail_reference``: K2's, K7's and the world's
    torch ops), the device time alone, and the bound, on K1's partials; U
    shifted in place, the world stepped and its history rows written at the
    counter, as an episode's cycle runs it."""
    import torch

    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import CYCLE, MPPIController
    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import combine_tail as ct
    from mppi_gpu_tpu_torch.ops import families
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    cfg = _episode_config(name)
    ctrl = (MPPIController(cfg, device="cuda") if R is None
            else BatchedMPPIController(cfg, R, device="cuda"))
    world = make_world(cfg, device="cuda")
    state0 = world.reset(R)
    U0 = ctrl.init_action_seq() if R is None else ctrl.init_action_seqs()
    goal = families.call_goal(ctrl._family, ctrl.cost)
    args = (ctrl._family, state0.x, U0, goal, cfg.lambda_, cfg.samples,
            cfg.seed if R is None else ctrl.init_seeds(), 3, 0, cfg.antithetic, cfg.noise_beta)
    _, partials = (fs.family_solve_partials(*args) if R is None
                   else fs.fleet_family_solve_partials(*args, None, R))
    adv, U, step = _episode_buffers(world, state0, U0, 4096, "cuda")  # rows past every call's

    def kernel():
        ct.combine_tail(partials, cfg.lambda_, U, ctrl.max_a, cfg.clamp_action, CYCLE,
                        ctrl._tickets, into=U, step=step, advance=adv)

    def plain():
        ct.combine_tail_reference(partials, cfg.lambda_, U, ctrl.max_a, cfg.clamp_action, CYCLE,
                                  into=U, step=step, advance=adv)

    ms, plain_ms = paired_median_ms(kernel, plain, 50, 10)
    u = torch.zeros(*state0.x.shape[:-1], cfg.action_dim, device="cuda")
    bound, bound_by = epilogue_bound(partials.shape[-2], cfg.horizon, cfg.action_dim, R or 1,
                                     world, adv.state, u)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                device_ms=device_ms(kernel, name="combine_tail_kernel"), nb=partials.shape[-2])


def latency_floor(nodes: int = 200) -> dict:
    """What a kernel that does next to nothing costs on this card: the
    device µs of a one-element torch add (its record an elementwise kernel:
    one launch, one load and one store) and the ms per node of a CUDA graph
    of `nodes` such adds, replayed, by CUDA events (median of five)."""
    import torch

    one = torch.zeros(1, device="cuda")

    def tiny():
        one.add_(1.0)

    reading = device_ms(tiny, name="elementwise_kernel")
    return dict(device_us=None if reading is None else reading * 1e3,
                graph_ms_per_node=graph_us(tiny, calls=nodes) / 1e3)


def epilogue_phase(smi: str) -> dict:
    """K2' on the card: the epilogue cycle against the four-kernel cycle bit
    for bit (:func:`check_epilogue_cycle`) for every config of
    EPISODE_CONFIGS at one and two opt iterations in every layout of
    EPILOGUE_FLEETS; K2' against its plain version at every config, solo and
    R=8 (:func:`check_epilogue_plain`); its times at the flagship's shape
    (solo) and the R=8 point_mass3d fleet's; and the latency floor of a
    kernel that does next to nothing (:func:`latency_floor`)."""
    t0 = time.perf_counter()
    cases, equal, worst = 0, True, 0.0
    for name in EPISODE_CONFIGS:
        for opt_iters in (1, 2):
            for R, clocks in EPILOGUE_FLEETS:
                got = check_epilogue_cycle(name, R, clocks, opt_iters)
                equal &= got["bit_equal"]
                worst = max(worst, got["max_abs_err"])
                cases += 1
    cycle_s = time.perf_counter() - t0
    plain = max(check_epilogue_plain(name, R)["max_abs_err"]
                for name in EPISODE_CONFIGS for R in (None, 8))
    times = {"solo": epilogue_times("flagship", None), "fleet": epilogue_times("point_mass3d", 8)}
    floor = latency_floor()
    agree = "bit-equal" if equal else f"max |delta| {worst:.3g}"
    print(f"[21] K2' combine_tail: the epilogue cycle {agree} to the four-kernel cycle (K1, K2, K7, "
          f"K6) over {cases} cases x {EPILOGUE_CYCLES} cycles (the {len(EPISODE_CONFIGS)} configs, "
          f"opt_iters 1 and 2, R=1, R=8 with a shared and with per-robot clocks, R=64 with a NaN "
          f"state: x, U, the state and its clock, the histories, the counter; tickets 0), K1 and "
          f"K2' alone launched per update, {cycle_s:.1f} s; against its plain version (every config, "
          f"R=1 and 8): beta, eta, dU within {EPILOGUE_PLAIN_TOL} (dU max |delta| {plain:.3g}), the "
          f"tail and the world step on its own dU and action bit-equal; "
          + "; ".join(f"{k} (nb {v['nb']}) {v['ms']:.4f} ms by events, device {v['device_ms']}, "
                      f"plain {v['plain_ms']:.4f}, bound {v['bound_ms']:.3g} ({v['bound_by']})"
                      for k, v in times.items())
          + f"; a one-element add (the latency floor of a kernel): device "
          f"{floor['device_us']} us, {floor['graph_ms_per_node']:.5f} graph ms per node "
          f"({smi})")
    return dict(bit_equal=equal, max_abs_err=worst, plain_max_abs_err=plain, cases=cases,
                times=times, floor=floor)


def epilogue_entry(epi: dict, launches: int) -> dict:
    """The kernels line's K2' entry: its launches in phase 21's eager
    episodes, its largest difference from its plain version, its times at the
    flagship's shape and the R=8 fleet's, and the forms' check."""
    solo, fleet = epi["times"]["solo"], epi["times"]["fleet"]
    return {"name": "combine_tail", "route": "cuda", "source": EPILOGUE_SOURCE,
            "replaces": EPILOGUE_REPLACES, "launches": launches,
            "max_abs_err": epi["plain_max_abs_err"], "ms": solo["ms"], "plain_ms": solo["plain_ms"],
            "bound_ms": solo["bound_ms"], "bound_by": solo["bound_by"], "library_ms": None,
            "device_ms": solo["device_ms"],
            "shape": f"flagship R=1 T=200 A=3 K=10000 (nb {solo['nb']}), the cycle's form with "
                     "the point mass's world step",
            "cycle_bit_equal": epi["bit_equal"], "cycle_max_abs_err": epi["max_abs_err"],
            "fleet_ms": fleet["ms"], "fleet_plain_ms": fleet["plain_ms"],
            "fleet_device_ms": fleet["device_ms"], "fleet_bound_ms": fleet["bound_ms"],
            "fleet_shape": f"point_mass3d R=8 (nb {fleet['nb']})",
            "floor_kernel_device_us": epi["floor"]["device_us"],
            "floor_graph_ms_per_node": epi["floor"]["graph_ms_per_node"],
            "forms_cases": epi["forms"]["check"]["cases"],
            "forms_both": epi["forms"]["check"]["both_forms"]}



# ---------------------------------------------------------------------------
# K2's fold in its two forms (phase 21, and alone with --combine): K2 in
# column tiles; K2' in tiles and in one block per robot, the same floats bit
# for bit; K2 and K2' held to their plain versions and K2' to K2 + K7 + K6 in
# both; the crossover

# the shapes of the check: nb partial rows (1, 7, the configs' 32 and 94, the
# flagship's 313, K=10⁵'s 782), (T, A) of T·A 1, 31, 33, 100 and 600
COMBINE_NBS = (1, 7, 32, 94, 313, 782)
COMBINE_SHAPES = ((1, 1), (31, 1), (11, 3), (50, 2), (200, 3))
COMBINE_LAMS = (1.0, 1.1, 1.7, 0.064, 1e9)
# the partials: spread β_b; one block's rows all at +inf (η_b = 0, ΔŨ_b = 0);
# every rollout at +inf (β = +inf: NaN everywhere, the guard's signal)
COMBINE_CASES = ("finite", "inf block", "every rollout inf")
COMBINE_ROBOTS = (None, 8)
# K2 against its plain version, as check_combine: β exact, η, ΔU (rtol, atol
# per unit of ΔU's scale)
COMBINE_PLAIN_TOL = dict(beta=0.0, eta=1e-5, dU=(1e-4, 1e-6))
# the crossover's sweep: nb, (T, A) of T·A 40, 100, 240, 600, robots
COMBINE_SWEEP_NBS = (16, 32, 64, 94, 157, 313)
COMBINE_SWEEP_SHAPES = ((20, 2), (50, 2), (80, 3), (200, 3))
COMBINE_SWEEP_ROBOTS = (1, 8)
COMBINE_GRAPH_CALLS = 50  # launches per timed graph


def combine_partials(R, nb: int, T: int, A: int, case: str, seed: int = 0) -> np.ndarray:
    """(R or 1, nb, 2 + T·A) float32 partials from a numpy seed, as K1 writes
    them: β_b = 50 + Exp(2), η_b in [0.5, 32], ΔŨ_b = η_b · 0.25·N(0, 1);
    `case` one of COMBINE_CASES."""
    rng = np.random.default_rng(seed)
    n, TA = R or 1, T * A
    part = np.zeros((n, nb, 2 + TA), np.float32)
    part[..., 0] = 50.0 + rng.exponential(2.0, (n, nb))
    part[..., 1] = rng.uniform(0.5, 32.0, (n, nb))
    part[..., 2:] = 0.25 * rng.standard_normal((n, nb, TA)) * part[..., 1:2]
    rows = {"finite": slice(0, 0), "inf block": slice(nb // 2, nb // 2 + 1),
            "every rollout inf": slice(0, nb)}[case]
    part[:, rows] = 0.0
    part[:, rows, 0] = np.inf
    return part


def combine_forms(nb: int, TA: int, device: str) -> tuple:
    """The forms a check launches K2' in: on the card the tiled one and,
    where its shared memory holds the robot, the one-block one; on the CPU
    the plain version alone (None)."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    if device != "cuda":
        return (None,)
    fits = max(fs.combine_smem(nb, TA, True), 4 * TA) <= fs._SMEM_BYTES
    return (False, True) if fits else (False,)


def run_k2(parts, lam: float, T: int, A: int) -> tuple:
    """K2 on (nb, 2 + T·A) or (R, nb, 2 + T·A) partials through its wrapper
    (the tiles on the card, the plain version on the CPU). Returns (β, η,
    ΔU)."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    return (fs.fleet_softmin_combine if parts.dim() == 3 else fs.softmin_combine)(parts, lam, T, A)


def run_k2e(parts, lam: float, U, max_a, clamp: bool, outputs, tickets, form, into=None,
            step=None, advance=None) -> tuple:
    """K2' in `form` (True: one block, False: tiles; None: through
    ``combine_tail``, the rule's form on the card, the plain version on the
    CPU)."""
    from mppi_gpu_tpu_torch.ops import combine_tail as ct

    if form is None:
        return ct.combine_tail(parts, lam, U, max_a, clamp, outputs, tickets, into, step, advance)
    lead = tuple(U.shape[:-2])
    return ct._launch_combine_tail(parts, lam, U, max_a, clamp, outputs, tickets, into, step,
                                   advance, lead[0] if lead else 1, lead, one_block=form)


def combine_case_inputs(R, nb: int, T: int, A: int, case: str, device: str, seed: int = 0):
    """The partials of a case, U in [-1.5, 1.5] and max_a in [0.3, 1.2]
    (some entries clamped), and the point mass of A axes (its world and a
    state apart per robot) for K2''s world step."""
    import torch

    rng = np.random.default_rng(seed + 1)
    lead = () if R is None else (R,)
    parts = torch.as_tensor(combine_partials(R, nb, T, A, case, seed), device=device)
    if R is None:
        parts = parts[0]
    U = torch.as_tensor(rng.uniform(-1.5, 1.5, lead + (T, A)).astype(np.float32), device=device)
    max_a = torch.as_tensor(rng.uniform(0.3, 1.2, A).astype(np.float32), device=device)
    world = _world_of(f"point_mass{A}d", device)
    state = world.reset(R)
    if R is not None:
        state = world.from_x(state.x + 0.01 * torch.arange(R, device=device)[:, None], state.time)
    return parts, U, max_a, world, state


def k2e_four_kernels(parts, lam, U, max_a, clamp, world, state, device: str) -> dict:
    """K2' of the cycle's form in every form against K2 + K7 + K6 (K2, K7's tail with U shifted in place, K6's step under the action) from
    the same buffers: β, η, ΔU, the action, U, the state, the histories, the
    x buffer and the counter bit for bit; the tickets 0 after each."""
    import torch

    from mppi_gpu_tpu_torch.controller import CYCLE
    from mppi_gpu_tpu_torch.ops import solve_tail as st
    from mppi_gpu_tpu_torch.ops import world_step as ws

    T, A = U.shape[-2:]
    R = U.shape[0] if U.dim() == 3 else 1
    tickets = torch.zeros(R + 1, dtype=torch.int32, device=device)
    ref, U_r, step_r = _episode_buffers(world, state, U, 2, device)
    beta, eta, dU = run_k2(parts, lam, T, A)
    tail = st.solve_tail(U_r, dU.view(U.shape), max_a, clamp, CYCLE, into=U_r)
    ws.advance_into(world, ref.state, tail.action, ref.xs, ref.us, ref.ts, step_r, ref.x)
    want = [beta, eta, dU.view(U.shape), tail.action, U_r, ref.xs, ref.us, ref.ts, ref.x,
            *ref.state]
    equal = True
    for form in combine_forms(parts.shape[-2], T * A, device):
        adv, U_e, step_e = _episode_buffers(world, state, U, 2, device)
        b, e, d, t = run_k2e(parts, lam, U_e, max_a, clamp, CYCLE, tickets, form, into=U_e,
                             step=step_e, advance=adv)
        got = [b, e, d, t.action, U_e, adv.xs, adv.us, adv.ts, adv.x, *adv.state]
        equal &= all(bits_equal(g, w) for g, w in zip(got, want)) and int(step_e) == int(step_r)
        expect(not bool(tickets.any()), f"K2' form {form}: tickets {tickets} left")
    return dict(bit_equal=equal)


def check_combine_forms_case(nb: int, T: int, A: int, lam: float, case: str, R,
                             device: str = "cuda") -> dict:
    """One case of the forms' check: K2 within COMBINE_PLAIN_TOL of its
    plain version, a fleet's robots bit-equal to their R = 1 launches; K2'
    of an inner iteration (u_seq) in every form of :func:`combine_forms`
    bit-equal to K2 + K7 and within EPILOGUE_PLAIN_TOL of its plain version;
    K2' of the cycle's form with the point mass's world step in every form
    bit-equal to K2 + K7 + K6 (:func:`k2e_four_kernels`). Returns dU's
    largest |Δ| from plain for K2 and K2' and the forms K2' ran in."""
    import torch

    from mppi_gpu_tpu_torch.controller import ITERATE
    from mppi_gpu_tpu_torch.ops import combine_tail as ct
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import solve_tail as st

    label = f"K2 forms nb={nb} T={T} A={A} lambda={lam} {case} R={R or 1}"
    parts, U, max_a, world, state = combine_case_inputs(R, nb, T, A, case, device)
    forms = combine_forms(nb, T * A, device)

    def near_plain(what: str, got, want, tol) -> float:
        """β, η and ΔU of `got` within `tol` of the plain `want`."""
        close(f"{label} {what} beta", _np(got[0]), _np(want[0]), tol["beta"])
        close(f"{label} {what} eta", _np(got[1]), _np(want[1]), tol["eta"])
        fin = want[2][torch.isfinite(want[2])]
        scale = max(float(fin.abs().max()), 1.0) if fin.numel() else 1.0
        return close(f"{label} {what} dU", _np(got[2]), _np(want[2].reshape(got[2].shape)),
                     tol["dU"][0], tol["dU"][1] * scale)

    plain = (fs.fleet_softmin_combine_reference(parts, lam, T, A) if R is not None
             else fs.softmin_combine_reference(parts, lam, T, A))
    beta, eta, dU = first = run_k2(parts, lam, T, A)
    err = near_plain("K2", first, plain, COMBINE_PLAIN_TOL)
    if R is not None:
        for r in range(R):
            solo = run_k2(parts[r], lam, T, A)
            expect(all(bits_equal(a[r], b) for a, b in zip(first, solo)),
                   f"{label}: robot {r} differs from its R=1 launch")
    tickets = torch.zeros((R or 1) + 1, dtype=torch.int32, device=device)
    want = st.solve_tail(U, dU.view(U.shape), max_a, True, ITERATE).u_seq
    plain_e = ct.combine_tail_reference(parts, lam, U, max_a, True, ITERATE)
    e_err = 0.0
    for form in forms:
        b, e, d, tail = run_k2e(parts, lam, U, max_a, True, ITERATE, tickets, form)
        expect(all(bits_equal(g, w) for g, w in zip((b, e, d, tail.u_seq),
                                                     (beta, eta, dU.view(U.shape), want))),
               f"{label}: K2' (u_seq) in form {form} differs from K2 + K7")
        expect(not bool(tickets.any()), f"{label}: K2' form {form} left tickets {tickets}")
        e_err = max(e_err, near_plain("K2'", (b, e, d), plain_e, EPILOGUE_PLAIN_TOL))
    cycle = k2e_four_kernels(parts, lam, U, max_a, False, world, state, device)
    expect(cycle["bit_equal"], f"{label}: K2' of the cycle differs from K2 + K7 + K6")
    return dict(k2_err=err, k2e_err=e_err, forms=len(forms))


def check_combine_forms(device: str = "cuda", nbs=COMBINE_NBS, shapes=COMBINE_SHAPES,
                        lams=COMBINE_LAMS, cases=COMBINE_CASES, robots=COMBINE_ROBOTS) -> dict:
    """:func:`check_combine_forms_case` over every nb, (T, A), λ, case and
    robot count. Returns the cases, those run in both forms, and the largest
    |Δ| of K2's and K2''s ΔU from their plain versions."""
    out = dict(cases=0, both_forms=0, k2_err=0.0, k2e_err=0.0)
    for nb in nbs:
        for T, A in shapes:
            for lam in lams:
                for case in cases:
                    for R in robots:
                        got = check_combine_forms_case(nb, T, A, lam, case, R, device)
                        out["cases"] += 1
                        out["both_forms"] += got["forms"] == 2
                        out["k2_err"] = max(out["k2_err"], got["k2_err"])
                        out["k2e_err"] = max(out["k2e_err"], got["k2e_err"])
    return out


def graph_us(fn, calls: int = COMBINE_GRAPH_CALLS, reps: int = 5) -> float:
    """µs per call of `fn` replayed in a CUDA graph of `calls` calls (warmed
    on a side stream, captured, replayed once), by CUDA events, median of
    `reps` replays: the device time of a launch as a graph cycle pays it,
    its launch gap included."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / calls)
    return float(np.median(out))


def combine_crossover() -> dict:
    """K2' (an inner iteration's tail, u_seq) in both forms, and K2 beside
    it, over COMBINE_SWEEP_NBS × COMBINE_SWEEP_SHAPES × COMBINE_SWEEP_ROBOTS
    where one block holds the robot: µs per launch in a replayed graph
    (:func:`graph_us`), and the rule's form beside the faster one. Returns
    the rows and the largest nb·(2 + T·A) below the smallest at which K2''s
    one-block form was slower than the tiled one."""
    import torch

    from mppi_gpu_tpu_torch.controller import ITERATE
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    rows = []
    for R in COMBINE_SWEEP_ROBOTS:
        for nb in COMBINE_SWEEP_NBS:
            for T, A in COMBINE_SWEEP_SHAPES:
                TA = T * A
                if combine_forms(nb, TA, "cuda") != (False, True):
                    continue
                parts, U, max_a, _, _ = combine_case_inputs(None if R == 1 else R, nb, T, A,
                                                            "finite", "cuda")
                tickets = torch.zeros(R + 1, dtype=torch.int32, device="cuda")
                row = dict(R=R, nb=nb, TA=TA, floats=nb * (2 + TA),
                           rule="one block" if fs.combine_one_block(nb, TA) else "tiles",
                           k2_us=graph_us(lambda: run_k2(parts, 1.0, T, A)))
                for form in (False, True):
                    row[f"k2e_{'block' if form else 'tiles'}_us"] = graph_us(
                        lambda: run_k2e(parts, 1.0, U, max_a, True, ITERATE, tickets, form))
                rows.append(row)
    slower = min((r["floats"] for r in rows if r["k2e_block_us"] > r["k2e_tiles_us"]),
                 default=float("inf"))
    agree = sum((r["rule"] == "one block") == (r["k2e_block_us"] <= r["k2e_tiles_us"])
                for r in rows)
    return dict(rows=rows, rule_agrees=agree, rule_max_floats=fs.COMBINE_ONE_BLOCK_FLOATS,
                measured_max_floats=max((r["floats"] for r in rows if r["floats"] < slower),
                                        default=0))


def _us(reading: tuple) -> float | str:
    """A :func:`device_reading` in µs, or why it gave none."""
    ms, how = reading
    return how if ms is None else ms * 1e3


def combine_times() -> dict:
    """Device µs (torch.profiler) of K2 and K2' (the inner iteration's form,
    in the rule's form) at the flagship's partials (nb 313, T·A 600) and an
    R=8 point_mass3d fleet's, and beside them, as a yardstick of the fold's
    product alone (not of the kernels' function), ``torch.mv(P.T, f)`` on
    one robot's ΔŨ columns with f its factors f_b."""
    import torch

    from mppi_gpu_tpu_torch.controller import ITERATE
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    out = {}
    for label, name, R in (("flagship", "flagship", None), ("point_mass3d R=8", "point_mass3d", 8)):
        cfg = _episode_config(name)
        T, A, K = cfg.horizon, cfg.action_dim, cfg.samples
        nb = -(-K // fs.block_width(R or 1, K, T, A, "lti"))
        parts, U, max_a, _, _ = combine_case_inputs(R, nb, T, A, "finite", "cuda")
        tickets = torch.zeros((R or 1) + 1, dtype=torch.int32, device="cuda")
        P = parts if R is None else parts[0]
        f = torch.exp((P[:, 0].min() - P[:, 0]) / 1.0).contiguous()
        out[label] = dict(
            nb=nb, TA=T * A, form="one block" if fs.combine_one_block(nb, T * A) else "tiles",
            k2_us=_us(device_reading(lambda: run_k2(parts, 1.0, T, A),
                                     name="softmin_combine_kernel")),
            k2e_us=_us(device_reading(lambda: run_k2e(parts, 1.0, U, max_a, True, ITERATE,
                                                      tickets, None), name="combine_tail_kernel")),
            mv_us=_us(device_reading(lambda: torch.mv(P[:, 2:].T, f), name="gemv")),
            bound_us=combine_bound(nb, T, A, R or 1)[0] * 1e3)
    return out


@contextlib.contextmanager
def k2e_form(one_block: bool):
    """K2' launched in `one_block`'s form wherever it fits (the tiles where
    one block cannot hold the robot) while the context is open, through
    every path: ``fused_solve.combine_one_block`` answers for the rule.
    Yields the list of the (nb, T·A) it was asked about."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    rule, asked = fs.combine_one_block, []

    def forced(nb: int, TA: int) -> bool:
        asked.append((nb, TA))
        return one_block and combine_forms(nb, TA, "cuda") == (False, True)

    fs.combine_one_block = forced
    try:
        yield asked
    finally:
        fs.combine_one_block = rule


def episode_forms() -> dict:
    """K2' in the graph episode in both forms: for every config of
    EPISODE_CONFIGS and the R=8 fleet of every FLEET_EPISODE_CONFIGS, a
    controller captured with K2' in one block (where it fits) and one
    captured in tiles, in turns (one block, tiles, tiles, one block), each
    read by :func:`replay_trace`: K2''s device µs per cycle by record name
    (its world body, and ``NoWorld`` for an inner update) and the untraced
    ms per cycle. Returns {label: {"rule", "block", "tiles"}}: the rule's
    form for the episode's shapes, and each form's readings in turn order."""
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    out = {}
    cases = [(name, None) for name in EPISODE_CONFIGS] + [(n, 8) for n in FLEET_EPISODE_CONFIGS]
    for name, R in cases:
        cfg = _episode_config(name)
        label = name if R is None else f"fleet {name}"
        row = out[label] = dict(block=[], tiles=[])
        for one_block in (True, False, False, True):
            with k2e_form(one_block) as asked:
                ctrl = (MPPIController(cfg, device="cuda") if R is None
                        else BatchedMPPIController(cfg, R, device="cuda"))
                t = replay_trace(ctrl, f"{label} K2' {'one block' if one_block else 'tiles'}",
                                 fleet=R is not None)
            row["block" if one_block else "tiles"].append(
                dict(k2e_us=t["k2e_us"], untraced_ms=t["untraced_ms"]))
        row["rule"] = "/".join(sorted({"one block" if fs.combine_one_block(*a) else "tiles"
                                       for a in asked}))
    return out


def _forms_line(label: str, row: dict) -> str:
    """One episode's K2' µs per cycle by world body in each form, turn by
    turn, and its untraced ms per cycle."""
    def form(runs):
        bodies = sorted({k for r in runs for k in r["k2e_us"]})
        return ("; ".join(f"{re.sub(r'[(].*', '', b)} "
                          + "/".join(f"{r['k2e_us'].get(b, 0.0):.2f}" for r in runs)
                          for b in bodies)
                + ", untraced ms " + "/".join(f"{r['untraced_ms']:.4f}" for r in runs))
    return (f"{label} (rule: {row['rule']}): one block {form(row['block'])} | tiles "
            f"{form(row['tiles'])}")


def combine_phase(smi: str, measure: bool = True) -> dict:
    """K2's fold in its forms on the card: :func:`check_combine_forms` over
    every case and, with `measure` (``--combine``), :func:`combine_crossover`,
    :func:`combine_times` and :func:`episode_forms`. The whole run leaves the
    measurements out: their profiler windows, late in the run, made the
    profiler drop the first records of later phases' trace windows."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    t0 = time.perf_counter()
    check = check_combine_forms()
    check_s = time.perf_counter() - t0
    print(f"[21] K2 in tiles and K2' in both forms (one block per robot where it fits, column "
          f"tiles): {check['cases']} cases ({check['both_forms']} with K2' in both forms; nb "
          f"{COMBINE_NBS}, (T, A) {COMBINE_SHAPES}, lambda {COMBINE_LAMS}, {COMBINE_CASES}, R=1 "
          f"and 8), {check_s:.1f} s: fleets' robots bit-equal to their R=1 launches, K2 within "
          f"{COMBINE_PLAIN_TOL} of plain (dU max |delta| {check['k2_err']:.3g}), K2' within "
          f"{EPILOGUE_PLAIN_TOL} (dU {check['k2e_err']:.3g}), K2' in each form bit-equal to "
          f"K2 + K7 and, with the point mass's world step, to K2 + K7 + K6; the rule "
          f"(fused_solve.combine_one_block): K2' in one block up to "
          f"{fs.COMBINE_ONE_BLOCK_FLOATS} floats of at most {fs.COMBINE_ONE_BLOCK_COLUMNS} "
          f"columns, K2 always in tiles ({smi})")
    if not measure:
        print(f"    (K2 forms phase {time.perf_counter() - t0:.1f} s)")
        return dict(check=check)
    cross = combine_crossover()
    for r in cross["rows"]:
        print(f"[21] crossover R={r['R']} nb={r['nb']} T*A={r['TA']} ({r['floats']} floats, rule: "
              f"{r['rule']}): graph us per launch K2' tiles {r['k2e_tiles_us']:.3f} one block "
              f"{r['k2e_block_us']:.3f}; K2 (tiles) {r['k2_us']:.3f}")
    print(f"[21] crossover: K2''s one-block form at most the tiled one's below "
          f"{cross['measured_max_floats']} floats and up to them; the rule picks the faster form "
          f"at {cross['rule_agrees']} of {len(cross['rows'])} shapes ({smi})")
    times = combine_times()
    for k, v in times.items():
        print(f"[21] {k} (nb {v['nb']}, T*A {v['TA']}, K2' {v['form']}): device us K2 "
              f"{v['k2_us']}, K2' {v['k2e_us']}; torch.mv(P.T, f) on the same partials "
              f"{v['mv_us']} (the fold's product alone); bound {v['bound_us']:.3g} us ({smi})")
    forms = episode_forms()
    for label, row in forms.items():
        print(f"[21] episode K2' us per cycle by world body, turns one block, tiles, tiles, one "
              f"block: {_forms_line(label, row)} ({smi})")
    print(f"    (K2 forms phase {time.perf_counter() - t0:.1f} s)")
    return dict(check=check, crossover=cross, times=times, episode_forms=forms)


# a config of each world body, whose eager-backend device episode runs K6 and
# K7 standalone, for EAGER_EPISODE_CYCLES cycles each
EAGER_EPISODE_CONFIGS = ("point_mass1d", "point_mass2d", "point_mass3d", "pendulum", "cartpole",
                         "unicycle", "quadrotor", "quadrotor3d", "arm")
EAGER_EPISODE_CYCLES = 5


def episode_phase(smi: str) -> dict:
    """Phase 21: K1's step by pointer against by value for every family
    instance; the on-device episode of every config (:func:`episode_config_phase`)
    and the R=8 fleet of every family (:func:`fleet_episode_phase`); a
    reassigned cost re-captures; checkpoint/resume on the card; the CLI's
    --jit-episode, --checkpoint/--resume and --profile on cuda."""
    import torch

    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.envs import params_for_config
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import world_step as ws
    from mppi_gpu_tpu_torch.ops.cost import goal_of, with_goal
    from mppi_gpu_tpu_torch.runner import run_closed_loop, run_episode_jit, run_fleet_episode

    t_phase = time.perf_counter()
    for A in range(1, 5):
        q = make_problem(A, 3000, 50)
        fam = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"])
        check_step_pointer(fam, q["x0"], q["U"], q["goal"], q["lam"], 3000)
    q = make_problem(3, 10_000, 200)
    check_step_pointer(fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"]),
                       q["x0"], q["U"], q["goal"], q["lam"], 10_000)
    for name in FAMILIES + COUPLED + LAST:
        cfg = _config(name)
        q = make_family_problem(name, cfg.samples, cfg.horizon)
        check_step_pointer(q["fam"], q["x0"], q["U"], q["goal"], q["lam"], cfg.samples)
    del q
    print("[21] K1 and K4 S (and K1's partials) bit-equal with the step by pointer and by value, "
          "both bodies, solo and R=8 fleets, iid and antithetic + OU 0.5: lti A=1-4 at K=3000 "
          "T=50, A=3 at K=10000 T=200, every other family instance at its config")
    world = world_step_phase(smi)
    tail = solve_tail_phase(smi)
    epi = epilogue_phase(smi)
    epi["forms"] = combine_phase(smi, measure=False)

    rows = {name: episode_config_phase(name, smi) for name in EPISODE_CONFIGS}
    fleets = {name: fleet_episode_phase(name, smi) for name in FLEET_EPISODE_CONFIGS}

    # K6 and K7 stand alone on the eager backend's device episode (a learned
    # model's, or any model's with rollout_backend="eager"): its solve ends
    # in K7, its world step is K6. Each world body's config, a few eager
    # cycles, the counts set to 0 just before and read just after
    k6_launches, k7_eager = dict.fromkeys(ws.WORLDS, 0), 0
    for name in EAGER_EPISODE_CONFIGS:
        ctrl = MPPIController(_config(name), device="cuda", rollout_backend="eager")
        _, got = counted(lambda: run_episode_jit(ctrl, num_steps=EAGER_EPISODE_CYCLES,
                                                 capture=False))
        kind = ws.pack_fields(_world_of(name))[0]
        want = {f"world_advance<{kind}>": EAGER_EPISODE_CYCLES,
                "solve_tail": EAGER_EPISODE_CYCLES * ctrl.cfg.opt_iters}
        expect(got == want, f"{name} eager-backend episode: launches {got}, want {want}")
        k6_launches[kind] += got[f"world_advance<{kind}>"]
        k7_eager += got["solve_tail"]
    print(f"[21] the eager backend's device episode ({EAGER_EPISODE_CYCLES} cycles of each world "
          f"body's config): K6 launched by world body {k6_launches}, K7 {k7_eager} times, no K2 or "
          "K2'")
    # the eager backend's solve reads nothing from the card either: its graph
    # episode (Philox noise drawn by torch ops at the step tensor, the fleet's
    # seeds kept on the card) equals the same cycle run eagerly
    cfg = _config("pendulum")
    for ctrl, run in ((MPPIController(cfg, device="cuda", rollout_backend="eager"), run_episode_jit),
                      (BatchedMPPIController(cfg, 4, device="cuda", rollout_backend="eager"),
                       run_fleet_episode)):
        graph, eager = run(ctrl, num_steps=20), run(ctrl, num_steps=20, capture=False)
        expect(np.array_equal(graph.xs, eager.xs) and np.array_equal(graph.us, eager.us),
               f"eager backend: the graph episode differs from the eager cycle ({type(ctrl).__name__})")
    print("[21] eager backend (pendulum, solo and R=4 fleet, 20 cycles): the graph episode equals the "
          "same cycle run eagerly on the card")

    # a reassigned cost re-captures: the episode then equals a fresh
    # controller's with that cost, not the old goal's
    cfg = _config("point_mass2d")
    ctrl = MPPIController(cfg, device="cuda")
    old = run_episode_jit(ctrl, num_steps=120)
    cycle = ctrl._episode_cycles["single"][1]
    goal = goal_of(ctrl.cost).clone()
    goal[:2] = torch.tensor([-0.6, 0.4], device="cuda")
    ctrl.cost = with_goal(ctrl.cost, goal)
    moved = run_episode_jit(ctrl, num_steps=120)
    fresh = run_episode_jit(MPPIController(cfg, device="cuda", cost=ctrl.cost), num_steps=120)
    expect(ctrl._episode_cycles["single"][1] is not cycle, "a reassigned cost did not re-capture")
    expect(np.array_equal(moved.xs, fresh.xs) and np.array_equal(moved.us, fresh.us),
           "after a reassigned cost the graph episode differs from a fresh controller's")
    expect(not np.array_equal(moved.us, old.us), "the reassigned goal did not move the episode")
    print("[21] ctrl.cost = with_goal(...) re-captured; the episode equals a fresh controller's with "
          "that cost bit for bit (point_mass2d, 120 cycles)")

    # checkpoint/resume on the card: the resumed steps equal the uninterrupted run's
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        cfg = _config("quadrotor3d")
        full = run_closed_loop(MPPIController(cfg, device="cuda"), max_steps=40,
                               checkpoint_path=ck, checkpoint_every=25)
        resumed = run_closed_loop(MPPIController(cfg, device="cuda"), max_steps=40, resume_from=ck)
        expect(len(resumed.us) == 15 and np.array_equal(resumed.us, full.us[25:])
               and np.array_equal(resumed.xs, full.xs[25:]),
               "checkpoint resume on the card differs from the uninterrupted run")
        # the CLI on cuda: --jit-episode, --checkpoint then --resume, --profile
        base = ["-c", os.path.join("configs", "pendulum.yaml"), "--device", "cuda"]
        trajs = {k: os.path.join(tmp, f"{k}.csv") for k in ("jit", "host", "resumed")}
        _cli([*base, "--jit-episode", "-t", trajs["jit"]])
        _cli([*base, "--max-steps", "120", "-t", trajs["host"], "--checkpoint", ck,
              "--checkpoint-every", "50", "--profile", os.path.join(tmp, "prof")])
        out = _cli([*base, "--max-steps", "120", "-t", trajs["resumed"], "--resume", ck])
        cols = {k: read_csv_columns(v) for k, v in trajs.items()}
        expect("episode finished: 20 control steps" in out, "the resumed CLI run did not run 20 steps")
        expect(all(np.array_equal(cols["resumed"][c], cols["host"][c][100:]) for c in cols["host"]),
               "the CLI's resumed trajectory differs from the uninterrupted run's")
        n_pendulum = params_for_config(_config("pendulum")).num_control_steps()
        expect(len(cols["jit"]["time"]) == n_pendulum and os.listdir(os.path.join(tmp, "prof")),
               "the CLI's --jit-episode trajectory or --profile trace is missing")
    print("[21] checkpoint resume on the card (quadrotor3d, step 25 of 40) bit-equal to the "
          "uninterrupted run; the CLI on cuda: --jit-episode wrote the whole pendulum episode, "
          "--checkpoint/--resume continued bit for bit (step 100 of 120), --profile wrote a trace")
    # K2''s launches on the main path: the eager episodes of every config and
    # fleet, each counted from 0 just before it and read just after
    k2e_launches = sum(row["k2e"] for row in (*rows.values(), *fleets.values()))
    print(f"[21] K2''s launches in the fused eager episodes of every config and fleet: "
          f"{k2e_launches}")
    print(f"[21] phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return dict(configs=rows, fleets=fleets, world=world, tail=tail, epi=epi,
                k6_launches=k6_launches, k2e_launches=k2e_launches)


# ---------------------------------------------------------------------------
# main


def _config(name: str):
    """configs/<name>.yaml, or an obstacle instance's config:
    examples/obstacle_nav.py's (point_mass2d with its obstacles) for
    obstacle2d, the obstacle quality config (OBSTACLES_3D) for obstacle3d;
    the bicycle example's (K=1024, T=40) for the user family "bicycle"."""
    from mppi_gpu_tpu_torch.config import MPPIConfig, load_config

    root = os.path.dirname(os.path.abspath(__file__))
    if name == "bicycle":
        from mppi_gpu_tpu_torch.examples.custom_family import bicycle_config

        return bicycle_config()
    if name == "obstacle2d":
        from mppi_gpu_tpu_torch.examples.obstacle_nav import OBSTACLES

        return load_config(os.path.join(root, "configs", "point_mass2d.yaml")).replace(
            cost_type="obstacle", obstacles=OBSTACLES, obstacle_w=800.0, noise_beta=0.5)
    if name == "obstacle3d":
        return MPPIConfig(
            env="point_mass3d", samples=2048, state_dim=6, action_dim=3, horizon=50, dt=0.1,
            lambda_=1.0, noise=(0.25, 0.25, 0.25), init_act=(0.0, 0.0, 0.0), max_a=(1.0, 1.0, 1.0),
            goal=(1.0, 0.5, 0.75, 0.0, 0.0, 0.0), cost_type="obstacle",
            cost_w=(1.0, 1.0, 1.0, 5.0, 5.0, 5.0),
            obstacles=tuple((*o[:-1], o[-1] + OBSTACLE_MARGIN) for o in OBSTACLES_3D))
    return load_config(os.path.join(root, "configs", f"{name}.yaml"))


def coupled_distance(name: str, xs: np.ndarray) -> np.ndarray:
    """Distance from solved of each state of a trajectory (N, S) of a coupled
    family, as bench._goal_metric: the position's distance to the config's
    goal for the unicycle and the quadrotor, the end effector's (by the
    port's TwoLinkArmDynamics.end_effector) for the arm."""
    import torch

    from mppi_gpu_tpu_torch.models import TwoLinkArmDynamics

    cfg = _config(name)
    g = np.asarray(cfg.goal, np.float64)
    if name == "arm":
        xs = TwoLinkArmDynamics.create(cfg.dt).end_effector(
            torch.as_tensor(xs, dtype=torch.float32)).numpy()
    return np.hypot(xs[:, 0] - g[0], xs[:, 1] - g[1])


def steady_distance(cols: dict, goal) -> float:
    """A CLI trajectory's steady-state distance to `goal` (its positions'
    length), as bench.quality_row scores an episode: the mean over the last
    quarter of the states, the start at the origin prepended to the CSV's."""
    n = len(goal)
    xs = np.stack([np.concatenate([[0.0], cols[f"x[{i}]"]]) for i in range(n)], axis=1)
    d = np.linalg.norm(xs - np.asarray(goal), axis=1)
    return float(d[-max(len(d) // 4, 1):].mean())


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


def family_phase(tag: str, name: str, modes, err: dict, smi: str) -> tuple[dict, dict, dict]:
    """One family's K1 checks and times on the card, at its config's shape
    and at K=10⁵, T=200: injected ε vs plain and float64, Philox mode in
    each (antithetic, OU β) of `modes` vs plain with exact replay, an R=8
    fleet bit-equal to its solo launches; K1 and K2 times vs plain; the
    R=8 fleet's K1 and K2 times at the config's shape; then the controller's
    solve fused vs eager and a profiler window of its control steps at both
    shapes. Folds K1's and K2's errors into `err`; returns the K1/K2 (ms,
    plain ms) at the two shapes and at the fleet's."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    cfg = _config(name)
    key = entry_key(make_family_problem(name, 128, 8)["fam"])
    out = []
    for K, T in ((cfg.samples, cfg.horizon), (100_000, 200)):
        e = check_family_injected(name, K, T)
        print(f"{tag} {name} injected K={K} T={T}: ok vs plain (max abs err "
              + ", ".join(f"{k} {e[k]:.3g}" for k in ("S", "beta", "eta", "dU", "action"))
              + f") and float64 (S relative error median {e['S_rel_median']:.3g}, p99 "
              f"{e['S_rel_p99']:.3g}, max {e['S_rel_max']:.3g}; plain f32 max "
              f"{e['plain_S_rel_max']:.3g})")
        for anti, ou in modes:
            e = check_family_philox(name, K, T, antithetic=anti, ou_beta=ou)
            err[key] = max(err[key], e["solve_partials"])
            err["softmin_combine"] = max(err["softmin_combine"], e["softmin_combine"])
            print(f"{tag} {name} philox K={K} T={T} anti={anti} ou={ou}: K1 S err "
                  f"{e['solve_partials']:.3g}, K2 dU err {e['softmin_combine']:.3g}; replay exact")
        e = check_family_fleet(name, 8, K, T)
        print(f"{tag} {name} fleet R=8 K={K} T={T}: K1 S err {e['solve_partials']:.3g} vs plain; "
              "every robot bit-equal to its R=1 launch")
        p = make_family_problem(name, K, T)
        args = family_args(p)
        _, part = fs.family_solve_partials(*args)
        A = p["A"]
        times = {
            key: paired_median_ms(
                lambda: fs.family_solve_partials(*args),
                lambda: fs.family_solve_partials_reference(*args), 20, 3),
            "softmin_combine": paired_median_ms(
                lambda: fs.softmin_combine(part, p["lam"], T, A),
                lambda: fs.softmin_combine_reference(part, p["lam"], T, A), 20, 20),
        }
        out.append(times)
        for k, (k_ms, p_ms) in times.items():
            print(f"{tag} kernel {k} K={K} T={T}: {k_ms:.4f} ms, plain {p_ms:.4f} ms ({smi})")
        del p, args, part
    # the R=8 fleet at the config's shape, the robots' goals and starts apart
    K, T = cfg.samples, cfg.horizon
    p = make_family_problem(name, K, T)
    R = 8
    xs = p["x0"].expand(R, -1).contiguous()
    Us = p["U"].expand(R, -1, -1).contiguous()
    goals = None if p["goal"] is None else (
        p["goal"] + 0.1 * torch.arange(R, device="cuda")[:, None]).contiguous()
    fargs = (p["fam"], xs, Us, goals, p["lam"], K, philox.fleet_seeds(7, R).cuda(), 3, 0, False, 0.0)
    _, fpart = fs.fleet_family_solve_partials(*fargs)
    fleet_times = {
        key: paired_median_ms(
            lambda: fs.fleet_family_solve_partials(*fargs),
            lambda: fs.fleet_family_solve_partials_reference(*fargs), 20, 1),
        "softmin_combine": paired_median_ms(
            lambda: fs.fleet_softmin_combine(fpart, p["lam"], T, p["A"]),
            lambda: fs.fleet_softmin_combine_reference(fpart, p["lam"], T, p["A"]), 20, 5),
    }
    fleet_device = {key: device_ms(lambda: fs.fleet_family_solve_partials(*fargs),
                                   name="partials_kernel"),
                    "softmin_combine": device_ms(
                        lambda: fs.fleet_softmin_combine(fpart, p["lam"], T, p["A"]),
                        name="softmin_combine_kernel")}
    out.append(fleet_times)
    for k, (k_ms, p_ms) in fleet_times.items():
        print(f"{tag} fleet kernel {k} R={R} K={K} T={T}: {k_ms:.4f} ms, device {fleet_device[k]} "
              f"ms, plain {p_ms:.4f} ms ({smi})")
    del p, fargs, fpart
    ctrl = MPPIController(cfg, device="cuda", rollout_backend="auto")
    plain = MPPIController(cfg, device="cuda", rollout_backend="eager")
    expect(ctrl.rollout_backend == "fused", f"{name}: auto picked {ctrl.rollout_backend} on cuda")
    x = torch.tensor(FAMILY_START[name], dtype=torch.float32, device="cuda")
    U = ctrl.init_action_seq()
    k_ms, p_ms = paired_median_ms(lambda: ctrl.solve_auto(x, U, 1), lambda: plain.solve_auto(x, U, 1),
                                  reps=20, plain_reps=5)
    close(f"controller {name} action", _np(ctrl.solve_auto(x, U, 1).action),
          _np(plain.solve_auto(x, U, 1).action), **TOL["u"])
    print(f"{tag} MPPIController {name} K={cfg.samples} T={cfg.horizon} opt_iters={cfg.opt_iters}: "
          f"fused {k_ms:.4f} ms/solve, eager {p_ms:.4f} ms/solve (CUDA events, warm median; {smi})")
    large = MPPIController(cfg.replace(samples=100_000, horizon=200), device="cuda")
    for c, shape in ((ctrl, f"K={cfg.samples} T={cfg.horizon}"), (large, "K=100000 T=200")):
        prof = profile_steps(c, x, c.init_action_seq())
        print(f"{tag} profile {name} {shape} x{cfg.opt_iters}, 50 control steps (solve + action to "
              f"host): wall {prof['wall_ms']:.4f} ms/step, device busy {prof['busy_ms']:.4f} ms, "
              f"idle share {prof['idle']:.4f}, K1 {prof['K1_us']:.2f} us, K2 {prof['K2_us']:.2f} us "
              f"per step ({smi})")
    return out[0], out[1], out[2]


def obstacle_quality_episodes(smi: str, seeds: int = OBSTACLE_SEEDS) -> int:
    """The obstacle quality episode (obstacle3d, fused) under seeds 0 ..
    `seeds` − 1, each launch counted from 0 before it and read after it (the
    warm-up of the episode's solve graph; its replays launch nothing from
    the host): every steady distance under its bar, and the share of episodes whose
    clearance to the true spheres is above 0 not below the JAX reference's
    over the same seeds (OBSTACLE_REF_CLEAR of OBSTACLE_SEEDS) at
    OBSTACLE_ALPHA (:func:`fisher_below`). Returns K1's launches in the
    configured episode (seed 0), the main path's."""
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.examples.obstacle_nav import min_clearance
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.runner import run_closed_loop

    cfg = _config("obstacle3d")
    steady, clear = [], []
    for seed in range(seeds):
        fs.reset_launch_counts()
        t0 = time.perf_counter()
        ep = run_closed_loop(MPPIController(cfg.replace(seed=seed), device="cuda",
                                            rollout_backend="fused"))
        ep_s = time.perf_counter() - t0
        by_family = fs.family_launch_counts()
        expect(by_family == dict(dict.fromkeys(by_family, 0), **{"lti-obstacle": cfg.opt_iters}),
               f"obstacle quality episode: K1 by family {by_family} for {len(ep.us)} steps, want "
               "its solve graph's warm-up alone")
        d = np.linalg.norm(ep.xs[:, :3] - np.asarray(cfg.goal[:3]), axis=1)
        steady.append(float(d[-max(len(d) // 4, 1):].mean()))
        clear.append(min_clearance(ep.xs, OBSTACLES_3D))
        if seed == 0:  # the configured episode: the main path's launches
            main_launches = by_family["lti-obstacle"]
            print(f"[17] obstacle quality episode (obstacle3d K={cfg.samples} T={cfg.horizon}, "
                  f"obstacles inflated by {OBSTACLE_MARGIN}, fused): {len(ep.us)} steps in "
                  f"{ep_s:.2f} s, steady {steady[0]:.4f} m from the goal (threshold "
                  f"{LAST_QUALITY_THRESHOLD_M['obstacle']}), least clearance to the true surfaces "
                  f"{clear[0]:+.4f} m, average controller execution time "
                  f"{ep.solve_ms['mean_ms']:.3f} ms ({smi}); K1 by family {by_family}")
    n_clear = sum(c > 0 for c in clear)
    p_below = fisher_below(n_clear, seeds, OBSTACLE_REF_CLEAR, OBSTACLE_SEEDS)
    print(f"[17] obstacle quality episodes, seeds 0-{seeds - 1}: steady max {max(steady):.4f} m; "
          f"clearance > 0 in {n_clear} of {seeds} (JAX reference {OBSTACLE_REF_CLEAR} of "
          f"{OBSTACLE_SEEDS}; one-sided Fisher p {p_below:.4f}, bar {OBSTACLE_ALPHA}), median "
          f"{np.median(clear):+.4f} m, min {min(clear):+.4f} m; per seed "
          f"{[round(c, 4) for c in clear]}")
    expect(max(steady) < LAST_QUALITY_THRESHOLD_M["obstacle"],
           f"obstacle quality episodes: steady {steady} m")
    expect(p_below > OBSTACLE_ALPHA,
           f"obstacle quality episodes: clear in {n_clear} of {seeds}, below the JAX reference's "
           f"{OBSTACLE_REF_CLEAR} of {OBSTACLE_SEEDS} (p {p_below:.4g}): clearances {clear} m")
    median_bar = OBSTACLE_REF_MEDIAN_M - OBSTACLE_MEDIAN_SLACK_M
    print(f"[17] obstacle median clearance {np.median(clear):+.4f} m against the JAX reference's "
          f"{OBSTACLE_REF_MEDIAN_M:+.5f} m over the same seeds; bar {median_bar:+.4f} m (the "
          f"reference's less {OBSTACLE_MEDIAN_SLACK_M:.4f}, 3·√2 bootstrap standard errors)")
    expect(np.median(clear) >= median_bar,
           f"obstacle quality episodes: median clearance {np.median(clear)} m below {median_bar} m")
    return main_launches


def fisher_below(k: int, n: int, k_ref: int, n_ref: int) -> float:
    """One-sided Fisher exact test: the probability that k or fewer of n
    trials succeed when the k + k_ref successes of the n + n_ref trials fall
    at random between the two samples (hypergeometric), that is, the p-value
    of "the rate of the first sample is below the reference's"."""
    total, hits = n + n_ref, k + k_ref
    lo = max(0, hits - n_ref)
    return sum(math.comb(hits, j) * math.comb(total - hits, n - j)
               for j in range(lo, k + 1)) / math.comb(total, n)


def sharded_phase(smi: str, cols2d: dict) -> tuple[dict, int]:
    """Phase 19, in this process's world of one NCCL rank: the sharded solve
    (point_mass3d K=10⁴ and 10⁵ T=200, antithetic at 10⁴, quadrotor3d at its
    config) on the world of one and on four virtual ranks in both branches
    against the solo solve (:func:`check_sharded`) with its launches per
    solve, its times beside the solo solve's and the cost of one NCCL
    all-reduce; the R=64 sharded fleet; the ``--sharded`` CLI (one-pass) and
    the two-kernel closed loop on configs/point_mass2d.yaml, each with the
    counts set to 0 just before it, against the solo CLI's trajectory
    (`cols2d`, phase 7): the one-pass loop's every column within
    SHARDED_CLI_TOL of it (on a world of one it is the solo solve to f32),
    the two-kernel loop's steady distance within 0.05 m of its steady
    distance (its ΔU is summed in another order, so the loops part); a real
    two-rank NCCL run where the machine has two GPUs. Returns the times and
    K5's launches in the two-kernel closed loop."""
    import torch
    import torch.distributed as dist

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController, global_mesh
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh
    from mppi_gpu_tpu_torch.runner import run_closed_loop

    meshes = {"world of one (NCCL)": global_mesh("cuda:0"), "4 virtual ranks": virtual_mesh(4, "cuda:0")}
    per_solve = {"one-pass": ("solve_partials", "softmin_combine"),
                 "two-kernel": ("rollout_costs", "weighted_update", "softmin_combine")}
    for cfg in (_config("point_mass3d").replace(samples=10_000, horizon=200),
                _config("point_mass3d").replace(samples=100_000, horizon=200),
                _config("point_mass3d").replace(samples=10_000, horizon=200, antithetic=True),
                _config("quadrotor3d")):
        for mname, mesh in meshes.items():
            out = check_sharded(cfg, mesh)
            for branch, o in out.items():
                want = dict.fromkeys(per_solve[branch], mesh.size)
                expect(o["launches"] == want, f"{branch} launches {o['launches']}, expected {want}")
            print(f"[19] sharded {cfg.env} K={cfg.samples} T={cfg.horizon}"
                  f"{' anti' if cfg.antithetic else ''}, {mname}: both branches equal the solo solve "
                  "(each rank's S bit-equal, beta equal; action max abs err "
                  + ", ".join(f"{b} {o['action_err']:.3g}" for b, o in out.items())
                  + "); launches per solve " + "; ".join(f"{b} {o['launches']}" for b, o in out.items()))
    sharded_ms = {}
    for K in (10_000, 100_000):
        cfg = _config("point_mass3d").replace(samples=K, horizon=200)
        solo = MPPIController(cfg, device="cuda")
        x, U = torch.zeros(6, device="cuda"), solo.init_action_seq()
        for mname, mesh in meshes.items():
            for onepass in (True, False):
                ctrl = ShardedMPPIController(cfg, mesh=mesh, onepass=onepass)
                s_ms, o_ms = paired_median_ms(lambda: ctrl.solve_auto(x, U, 1),
                                              lambda: solo.solve_auto(x, U, 1), 20, 20)
                branch = "one-pass" if onepass else "two-kernel"
                sharded_ms[f"K={K} {mname} {branch}"] = dict(ms=s_ms, solo_ms=o_ms)
                print(f"[19] sharded solve point_mass3d K={K} T=200, {mname}, {branch}: {s_ms:.4f} "
                      f"ms/solve, solo {o_ms:.4f} ms/solve (CUDA events, warm median; {smi})")
    # what one all-reduce costs on the world of one: the host's time per call
    # (the solve waits on it) and the device's, for β's one float and for the
    # one-pass branch's η packed with ΔU (1 + T·A floats at T=200, A=3)
    for n_floats in (1, 601):
        t = torch.ones(n_floats, device="cuda")
        dev = float(np.median(time_ms(lambda: dist.all_reduce(t), 50, 5)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(t)
        host = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        sharded_ms[f"all_reduce {n_floats} floats"] = dict(ms=dev, host_ms=host)
        print(f"[19] NCCL all_reduce of {n_floats} float(s), world of one: {dev:.4f} ms (CUDA events, "
              f"warm median), {host:.4f} ms of host time per call ({smi})")
    check_sharded_fleet(_config("point_mass3d").replace(samples=10_000, horizon=200), 64,
                        meshes["world of one (NCCL)"])
    print("[19] ShardedFleetController point_mass3d R=64 K=10000 T=200, world of one (NCCL): every "
          "leaf bit-equal to BatchedMPPIController's")
    # the sharded paths: the --sharded CLI (one-pass), then the two-kernel
    # closed loop, each with the counts set to 0 just before it
    cfg2 = _config("point_mass2d")
    steady2d = steady_distance(cols2d, cfg2.goal[:2])
    fs.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "sharded.csv")
        out = _cli(["-c", os.path.join("configs", "point_mass2d.yaml"), "--device", "cuda",
                    "--sharded", "-t", traj])
        cols = read_csv_columns(traj)
    onepass_launches = fs.launch_counts()
    steady = steady_distance(cols, cfg2.goal[:2])
    expect(cols.keys() == cols2d.keys() and all(len(cols[k]) == len(cols2d[k]) for k in cols),
           "--sharded CLI: its trajectory's columns and rows differ from the solo CLI's")
    traj_err = max(float(np.max(np.abs(cols[k] - cols2d[k]))) for k in cols)
    expect(traj_err <= SHARDED_CLI_TOL,
           f"--sharded CLI: trajectory {traj_err} from the solo CLI's (bar {SHARDED_CLI_TOL})")
    n_steps = int(re.search(r"episode finished: (\d+) control steps", out).group(1))
    fs.reset_launch_counts()
    ep = run_closed_loop(ShardedMPPIController(cfg2, mesh=meshes["world of one (NCCL)"],
                                               onepass=False))
    two_launches = fs.launch_counts()
    d2 = np.linalg.norm(ep.xs[:, :2] - np.asarray(cfg2.goal[:2]), axis=1)
    steady2 = float(d2[-max(len(d2) // 4, 1):].mean())
    print(f"[19] --sharded CLI configs/point_mass2d.yaml (world of one, one-pass): {n_steps} steps, "
          f"steady {steady:.4f} m from the goal (the solo CLI's {steady2d:.4f} m); every column of "
          f"its trajectory within {traj_err:.3g} of the solo CLI's (bar {SHARDED_CLI_TOL}); "
          f"launches {onepass_launches}. Two-kernel closed loop (run_closed_loop, world of one): "
          f"{len(ep.us)} steps, steady {steady2:.4f} m (the solo CLI's + 0.05 the bar), average "
          f"controller execution time {ep.solve_ms['mean_ms']:.3f} ms ({smi}); launches {two_launches}")
    # each loop's launches from the host: its solve graph's warm-up (one
    # update, one rank); the graphed steps' records from a trace
    world1 = meshes["world of one (NCCL)"]
    sharded_traces = {
        branch: solve_trace(f"sharded point_mass2d world of one {branch}", c, _start(cfg2),
                            c.init_action_seq(), cfg2.seed, per_update=dict(
                                solve_partials=1, softmin_combine=1,
                                softmin_update=int(not onepass), softmin_min=int(not onepass),
                                softmin_eta=int(not onepass)))
        for branch, onepass in (("one-pass", True), ("two-kernel", False))
        for c in (ShardedMPPIController(cfg2, mesh=world1, onepass=onepass),)}
    print(f"[19] records per graphed step of the sharded host loops in a trace of "
          f"{SOLVE_TRACE_STEPS} (K4 under solve_partials): {_records_line(sharded_traces)}")
    expect(onepass_launches["solve_partials"] == onepass_launches["softmin_combine"] == 1
           and onepass_launches["weighted_update"] == onepass_launches["rollout_costs"] == 0,
           f"--sharded CLI: launches {onepass_launches} for {n_steps} steps, want the graph warm-up's")
    expect(two_launches["rollout_costs"] == two_launches["weighted_update"]
           == two_launches["softmin_combine"] == 1 and two_launches["solve_partials"] == 0,
           f"two-kernel closed loop: launches {two_launches} for {len(ep.us)} steps, want the graph "
           "warm-up's")
    expect(steady2 < steady2d + 0.05,
           f"two-kernel closed loop point_mass2d steady {steady2} m, solo {steady2d} m")
    if torch.cuda.device_count() >= 2:
        cfg = _config("point_mass3d").replace(samples=10_000, horizon=200)
        ranks = group_run(cfg, 2)
        solo = MPPIController(cfg, device="cuda")
        want = solo.solve(torch.full((6,), 0.05, device="cuda"), solo.init_action_seq(), cfg.seed, 2)
        for onepass in (True, False):
            S = torch.cat([r[onepass][2] for r in ranks])
            expect(torch.equal(S, want.info.costs.cpu()), f"n=2 NCCL onepass={onepass}: S differs")
            for r in ranks:
                close(f"n=2 NCCL onepass={onepass} action", _np(r[onepass][0]), _np(want.action),
                      **TOL["u"])
        print("[19] n=2 NCCL ranks (torch.multiprocessing, cuda:0 and cuda:1): both branches equal "
              "the solo solve (S bit-equal, action within TOL)")
    else:
        print(f"[19] n=2 NCCL: not run: this machine has {torch.cuda.device_count()} CUDA device(s), "
              "and NCCL refuses two ranks on one GPU; the virtual ranks above stand in")
    return sharded_ms, two_launches["weighted_update"]


def _blocks(S, width: int):
    """S (K,) or (R, K) as (R, nb, width) blocks of `width` rollouts, the
    pad +inf, and each block's least cost β_b (keepdim)."""
    import torch

    S = S.reshape(-1, S.shape[-1]).float()
    R, K = S.shape
    pad = torch.full((R, -(-K // width) * width - K), math.inf, device=S.device)
    blocks = torch.cat([S, pad], 1).view(R, -1, width)
    return blocks, blocks.amin(dim=2, keepdim=True)


def weighing_share(S, lam: float, width: int) -> float:
    """The share of rollouts whose weight in their block of `width`,
    exp(−(S_k − β_b)/λ) in float32 with β_b the block's least S as K1
    computes it (0 in a block whose rollouts all cost +inf), is not 0: the
    rollouts whose e·ε the per-rollout body's second pass draws again and
    sums. S (K,) or (R, K)."""
    import torch

    K = S.shape[-1]
    blocks, beta = _blocks(S, width)
    e = torch.where(beta == math.inf, 0.0, torch.exp(-(blocks - beta) / lam))
    return float((e.flatten(1)[:, :K] != 0).float().mean())


def middle_lam(S, width: int) -> float:
    """A softmin λ at which about half of each block's rollouts weigh: the
    median over the finite rollouts of S_k − β_b (β_b the least S of the
    rollout's block of `width`) over 80, since float32 exp(−x) is 0 past x
    ≈ 104 (87 where denormals flush)."""
    import torch

    blocks, beta = _blocks(S, width)
    d = (blocks - beta)[torch.isfinite(blocks)]
    return float(d.median()) / 80.0


# the softmin λ of K1's checks on the card besides the problem's own, at
# which most weights underflow to 0: "mid" (:func:`middle_lam`, about half
# of each block weighs) and 1e9 (every rollout weighs: e_k = 1 to float32)
WEIGH_LAMS = ("mid", 1e9)


def check_bodies(label: str, fam, x0, U, goal, lam, K: int, modes, eps) -> tuple[float, dict]:
    """K1 and K4 in both bodies on one robot at one shape, in the Philox mode
    under each (antithetic, OU β) of `modes` and in the injected-ε mode on
    `eps`: the four launches' S bit-equal, within 1e-5 of the plain version;
    each K1 body's partials against :func:`block_partials` of its width on
    its own S and ε (K3's dump of the stream), at the softmin λ `lam` and at
    each of WEIGH_LAMS, so that the per-rollout body's second pass runs with
    few, about half and all of each block's rollouts weighing. Returns the
    max abs error of S against the plain version and, per λ, the least and
    the largest :func:`weighing_share` over the modes at width BLOCK."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    T, A = U.shape
    err, shares = 0.0, {}
    for anti, ou, inj in [(a, o, False) for a, o in modes] + [(False, 0.0, True)]:
        e_in = eps if inj else None
        name = f"{label} K={K} T={T} anti={anti} ou={ou}{' injected' if inj else ''}"

        def run(width: int, lam_softmin):
            return fs._launch_solve_partials(fam, x0, U, goal, lam_softmin, K, 7, 3, 1, anti, ou,
                                             e_in, 1, (), width=width)

        S4 = run(fs.SLAB_WIDTH, None)
        expect(torch.equal(run(fs.BLOCK, None), S4),
               f"{name}: K4 per-rollout body's S differs from the K4 slab body's")
        S_r = fs.rollout_costs_reference(fam, x0, U, goal, K, 7, 3, 1, anti, ou, e_in)
        err = max(err, close(f"{name} S vs plain", _np(S4), _np(S_r), 1e-5))
        noise = e_in if inj else fs.noise_dump(fam.sigma, T, K, 7, 3, 1, anti, ou)
        for lam_k in (lam,) + WEIGH_LAMS:
            lam_k = middle_lam(S4, fs.BLOCK) if lam_k == "mid" else lam_k
            at = f"{name} lambda={lam_k:.4g}"
            (S1, part_slab), (S1_old, part_old) = run(fs.SLAB_WIDTH, lam_k), run(fs.BLOCK, lam_k)
            for what, S in (("K1 slab body", S1), ("K1 per-rollout body", S1_old)):
                expect(torch.equal(S, S4), f"{at}: {what}'s S differs from K4's")
            for width, part in ((fs.SLAB_WIDTH, part_slab), (fs.BLOCK, part_old)):
                own = fs.block_partials(S4, noise, lam_k, width)
                close(f"{at} width {width} beta_b", _np(part[:, 0]), _np(own[:, 0]), 0.0)
                close(f"{at} width {width} eta_b", _np(part[:, 1]), _np(own[:, 1]), TOL["eta"])
                scale = float(own[:, 2:].abs().max())
                close(f"{at} width {width} dU_b", _np(part[:, 2:]), _np(own[:, 2:]),
                      TOL["dU"]["rtol"], TOL["dU"]["atol"] * max(scale, 1.0))
            share = weighing_share(S4, lam_k, fs.BLOCK)
            key = "own" if lam_k == lam else "1e9" if lam_k == 1e9 else "mid"
            lo, hi = shares.get(key, (share, share))
            shares[key] = (min(lo, share), max(hi, share))
    return err, shares


def _shares_line(shares: dict) -> str:
    return ", ".join(f"lambda {k} {lo:.3g}-{hi:.3g}" for k, (lo, hi) in shares.items())


def check_combine(T: int, A: int, nb: int, *, normalize: bool, R: int = 3, seed: int = 0,
                  device: str = "cuda") -> float:
    """K2 on made-up partials of nb rows against its plain version: β exact,
    η within 1e-5, ΔU within 1e-4 (plus 1e-6 of its scale). With
    `normalize` the rows carry spread β_b, η_b and one all-+inf block (η_b
    = 0, ΔŨ_b = 0); without it β_b = η_b = 0, as K5 writes them. Every
    robot of an R-robot launch bit-equal to its R = 1 launch. Returns the
    max abs error of ΔU."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    rng = np.random.default_rng(seed)
    TA = T * A
    part = np.zeros((R, nb, 2 + TA), np.float32)
    part[..., 2:] = 0.25 * rng.standard_normal((R, nb, TA))
    if normalize:
        part[..., 0] = 50.0 + rng.exponential(2.0, (R, nb))
        part[..., 1] = rng.uniform(0.5, 32.0, (R, nb))
        part[..., 2:] *= part[..., 1:2]
        part[:, nb // 2] = 0.0
        part[:, nb // 2, 0] = np.inf
    parts = torch.as_tensor(part, device=device)
    err, label = 0.0, f"K2 nb={nb} T={T} A={A} normalize={int(normalize)}"
    fleet = fs.fleet_softmin_combine(parts, 1.0, T, A) if normalize else None
    for r in range(R):
        b, e, dU = fs.softmin_combine(parts[r], 1.0, T, A, normalize)
        b_r, e_r, dU_r = fs.softmin_combine_reference(parts[r], 1.0, T, A, normalize)
        close(f"{label} beta", _np(b), _np(b_r), 0.0)
        close(f"{label} eta", _np(e), _np(e_r), 1e-5)
        scale = max(float(dU_r.abs().max()), 1.0)
        err = max(err, close(f"{label} dU", _np(dU), _np(dU_r), 1e-4, 1e-6 * scale))
        if fleet is not None:
            for what, a, want in zip(("beta", "eta", "dU"), (v[r] for v in fleet), (b, e, dU)):
                expect(torch.equal(a, want), f"{label} robot {r} of {R}: {what} differs from its R=1 launch")
    return err


def body_times(fam, x0, U, goal, lam, R: int, K: int, kernels=("K1", "K4"),
               at_lam: bool = False) -> dict:
    """Both bodies of K1 and K4 (`kernels`) for R robots of K rollouts on
    (x0, U, goal), Philox mode: CUDA events around each call, the bodies in
    turns (warm median; the per-rollout body in the plain slot of
    :func:`paired_median_ms`), and the device time alone
    (:func:`device_ms`, read up to three times where the profiler missed
    the records). K1 runs at λ = 1e9, where every rollout weighs: the most
    work the per-rollout body's second pass can be given (the slab body's
    work does not depend on the weights); with `at_lam` its per-rollout
    body also at `lam`, the device time alone, beside
    :func:`weighing_share` there. Returns {kernel: {slab_ms, per_rollout_ms,
    slab_device_ms, per_rollout_device_ms[, per_rollout_lam_device_ms,
    weighing]}} and the rule's width."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    if R > 1:
        x0, U, goal = (None if v is None else v.expand(R, *v.shape).contiguous() for v in (x0, U, goal))
    seeds = philox.fleet_seeds(7, R).to(U.device) if R > 1 else 7
    T, A = U.shape[-2:]
    row = {"rule_width": fs.block_width(R, K, T, A, fam.name)}
    for kernel in kernels:
        def run(width, lam_softmin=1e9 if kernel == "K1" else None):
            return fs._launch_solve_partials(fam, x0, U, goal, lam_softmin, K, seeds, 3, 0, False,
                                             0.0, None, R, (R,) if R > 1 else (), width=width)

        def dev(width, lam_softmin=1e9 if kernel == "K1" else None):
            # read again where the profiler missed the records: a K with a
            # missing reading neither wins nor loses, which would move the
            # crossover to the K before it
            for _ in range(3):
                ms = device_ms(lambda: run(width, lam_softmin))
                if ms is not None:
                    return ms
            return None

        slab_ms, per_ms = paired_median_ms(lambda: run(fs.SLAB_WIDTH), lambda: run(fs.BLOCK), 20, 20)
        row[kernel] = dict(slab_ms=slab_ms, per_rollout_ms=per_ms,
                           slab_device_ms=dev(fs.SLAB_WIDTH), per_rollout_device_ms=dev(fs.BLOCK))
        if kernel == "K1" and at_lam:
            row[kernel].update(per_rollout_lam_device_ms=dev(fs.BLOCK, lam),
                               weighing=weighing_share(run(fs.BLOCK, lam)[0], lam, fs.BLOCK))
    return row


SWEEP_K = (1024, 3000, 10_000, 20_000, 30_000, 50_000, 100_000)


# the closed loops whose solves phase 20 reads the share of rollouts that
# weigh from (config, R, K or the config's): the R=8 fleet of every family's
# quality config and of obstacle2d at the configs' K and T, the R=8 flagship
# fleet (K=10⁴, T=200) and the flagship alone at K=10⁵
WEIGHING_LOOPS = tuple((n, 8, None) for n in FLEET_EPISODE_CONFIGS + ("obstacle2d", "flagship")) + (
    ("flagship", 1, 100_000),)


def closed_loop_shares(name: str, R: int, K: int | None = None, device: str = "cuda",
                       width: int | None = None) -> dict:
    """:func:`weighing_share` at `width` (BLOCK, the per-rollout body's
    blocks, if None) of the last update's S in the first, middle and last
    cycle of a closed
    loop of config `name`: R robots under the fleet's seeds from the world's
    start, K rollouts (the config's if None), each cycle the fleet's solve
    and the batched world step, run_fleet_episode's cycle
    (``runner.EpisodeCycle``, a replayed graph on a CUDA device) with every
    cycle's S kept."""
    import torch

    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.envs import make_world, params_for_config
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import world_step as ws
    from mppi_gpu_tpu_torch.runner import EpisodeCycle

    cfg = _episode_config(name)
    cfg = cfg if K is None else cfg.replace(samples=K)
    params = params_for_config(cfg)
    n = params.num_control_steps()
    fleet = BatchedMPPIController(cfg, R, device=device)
    world = make_world(cfg, params, device=device)
    state0, Us0, seeds = world.reset(R), fleet.init_action_seqs(), fleet.init_seeds()
    costs = torch.empty((n, R, cfg.samples), device=device)

    def solve(xs, Us, step, advance):  # the cycle's: U shifted in place, then the world step
        res = fleet.solve_batch(xs, Us, seeds, step, capture=False)
        costs.index_copy_(0, step.view(1), res.info.costs.reshape(1, R, -1))
        Us.copy_(res.u_next)
        ws.advance_after(advance, res.action, step)

    EpisodeCycle(fleet, world, state0, Us0, n, solve).run(state0, Us0)
    marks = {"first": 0, "middle": n // 2, "last": n - 1}
    return dict(R=R, K=cfg.samples, T=cfg.horizon, A=cfg.action_dim, family=fleet._family.name,
                cycles=n, **{k: weighing_share(costs[i], cfg.lambda_, width or fs.BLOCK)
                             for k, i in marks.items()})


def bodies_phase(smi: str, err: dict, sass_steps: dict, clock_mhz: float) -> dict:
    """Phase 20, K1's and K4's two bodies: S bit-equal across both bodies of
    both kernels for every family instance at its config's shape (Philox
    iid, antithetic, OU 0.5; injected), each body's partials against the
    plain ones of its width at the problem's λ and each of WEIGH_LAMS
    (:func:`check_bodies`); K2 against its plain version at the nb that each
    width writes and at K5's; the share of rollouts that weigh in closed
    loops (:func:`closed_loop_shares`); both bodies timed across K for
    every family (:func:`sweep_bodies`), which it returns."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    body_cases = [("lti", A, 3000, 50) for A in range(1, 5)] + [
        (n, None, _config(n).samples, _config(n).horizon) for n in FAMILIES + COUPLED + LAST]
    for name, A, K, T in body_cases:
        if name == "lti":
            q = make_problem(A, K, T)
            fam = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"])
            args = (fam, q["x0"], q["U"], q["goal"], q["lam"], K)
        else:
            q = make_family_problem(name, K, T)
            args = (q["fam"], q["x0"], q["U"], q["goal"], q["lam"], K)
        e, shares = check_bodies(f"bodies {args[0].name} A={args[0].action_dim}", *args,
                                 ((False, 0.0), (True, 0.0), (False, 0.5)), q["eps"])
        err["rollout_costs"] = max(err["rollout_costs"], e)
        print(f"[20] bodies {args[0].name} A={args[0].action_dim} K={K} T={T}: K1 and K4 S bit-equal "
              f"in the slab and the per-rollout body (iid, antithetic, OU 0.5, injected); partials "
              f"of both widths as plain at the problem's lambda, a middle one and 1e9 (share of "
              f"rollouts weighing at width {fs.BLOCK}: {_shares_line(shares)}); S max abs err vs "
              f"plain {e:.3g}")
        del q, args
    for nb, normalize, what in ((-(-10_000 // fs.SLAB_WIDTH), True, "K1 slab body, K=10000"),
                                (-(-10_000 // fs.BLOCK), True, "K1 per-rollout body, K=10000"),
                                (-(-100_000 // fs.BLOCK), True, "K1 per-rollout body, K=100000"),
                                (fs.weighted_update_rows(200, 10_000, 3, False), False,
                                 "K5, K=10000")):
        e = check_combine(200, 3, nb, normalize=normalize)
        err["softmin_combine"] = max(err["softmin_combine"], e)
        print(f"[20] K2 at nb={nb} ({what}), A=3 T=200, normalize={int(normalize)}: ok vs plain "
              f"(beta exact), fleet robots bit-equal to their R=1 launches; dU max abs err {e:.3g}")
    loops = {}
    for name, R, K in WEIGHING_LOOPS:
        v = loops[f"{name} R={R}" + (f" K={K}" if K else "")] = closed_loop_shares(name, R, K)
        print(f"[20] closed loop {name} R={R} K={v['K']} T={v['T']}, {v['cycles']} cycles: share of "
              f"rollouts weighing at width {fs.BLOCK} in the first, middle and last cycle's solve "
              f"{v['first']:.3g}, {v['middle']:.3g}, {v['last']:.3g}; K1 runs width "
              f"{fs.block_width(R, v['K'], v['T'], v['A'], v['family'])}")
    sweep = sweep_bodies(smi, sass_steps, clock_mhz)
    sweep["closed_loops"] = loops
    return sweep


def sweep_bodies(smi: str, sass_steps: dict, clock_mhz: float) -> dict:
    """Both bodies of K1 and K4 (:func:`body_times`) for the instances lti
    A=2, A=3 and every other family's at T=200 for each K of SWEEP_K, K1 of
    Lti<3> fleets of R=8 and R=64 at K=10⁴ and of the R=8 fleets of the
    obstacle2d, obstacle3d and quadrotor3d configs at their own K and T;
    each family's crossover by the criterion of
    ``fused_solve.SLAB_MAX_ROLLOUTS``: the largest K up to which the slab
    body's device time is at most the per-rollout body's for K1 with every
    rollout weighing and at most 5 % above it for K4, the least over a
    family's instances. At K=10⁵ and in the Lti<3> fleets, K1's bound
    (:func:`solve_bound`) with every rollout weighing and with its
    reduction scaled by the share that weighs at the problem's λ. Returns
    {"bodies": rows, "crossover": by family}."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    def dev(v):
        return "not measured" if v is None else f"{v:.4f}"

    def k1_line(v):
        return (f"K1 at lambda 1e9 slab {v['slab_ms']:.4f} ms ({dev(v['slab_device_ms'])} on the "
                f"device), per-rollout {v['per_rollout_ms']:.4f} ms ({dev(v['per_rollout_device_ms'])})"
                + (f", per-rollout at the problem's lambda {dev(v['per_rollout_lam_device_ms'])} on "
                   f"the device (share weighing {v['weighing']:.3g})" if "weighing" in v else ""))

    rows, crossover = {}, {}
    for name, A in (("lti", 2), ("lti", 3)) + tuple((n, None) for n in FAMILIES + COUPLED + LAST):
        if name == "lti":
            q = make_problem(A, 128, 200)
            case = (fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"]), q["x0"],
                    q["U"], q["goal"], q["lam"])
        else:
            q = make_family_problem(name, 128, 200)
            case = (q["fam"], q["x0"], q["U"], q["goal"], q["lam"])
        fleets = ((8, 10_000), (64, 10_000)) if (name, A) == ("lti", 3) else ()
        last, lost = 0, False
        for R, K in [(1, K) for K in SWEEP_K] + list(fleets):
            row = body_times(*case, R, K, ("K1", "K4") if R == 1 else ("K1",),
                             at_lam=K == 100_000 or R > 1)
            key = f"{case[0].name} A={case[0].action_dim} R={R} K={K} T=200"
            rows[key] = row
            bound = ""
            if K == 100_000 or R > 1:
                v = row["K1"]
                v["bound_ms"] = solve_bound(sass_steps, case[0], K, 200, clock_mhz, R, width=fs.BLOCK)[0]
                v["bound_weighed_ms"] = solve_bound(sass_steps, case[0], K, 200, clock_mhz, R,
                                                    width=fs.BLOCK, weighing=v["weighing"])[0]
                bound = (f"; K1 bound {v['bound_ms']:.4f} ms every rollout weighing, "
                         f"{v['bound_weighed_ms']:.4f} ms at the problem's lambda")
            print(f"[20] bodies {key}: " + k1_line(row["K1"]) + "".join(
                f"; K4 slab {v['slab_ms']:.4f} ms ({dev(v['slab_device_ms'])} on the device), "
                f"per-rollout {v['per_rollout_ms']:.4f} ms ({dev(v['per_rollout_device_ms'])})"
                for k, v in row.items() if k == "K4")
                + f"{bound}; the rule picks width {row['rule_width']} ({smi})")
            t = [row[k][f] for k in ("K1", "K4") for f in ("slab_device_ms", "per_rollout_device_ms")
                 if k in row]
            if R == 1 and None not in t:  # a K the profiler missed neither wins nor loses
                lost = lost or not (t[0] <= t[1] and t[2] <= 1.05 * t[3])
                last = last if lost else K
        crossover[case[0].name] = min(crossover.get(case[0].name, last), last)
    for name in LAST:  # their configs' R=8 fleets at the configs' T, K1 in both bodies
        cfg = _config(name)
        q = make_family_problem(name, 128, cfg.horizon)
        row = body_times(q["fam"], q["x0"], q["U"], q["goal"], q["lam"], 8, cfg.samples, ("K1",),
                         at_lam=True)
        key = f"{q['fam'].name} A={cfg.action_dim} R=8 K={cfg.samples} T={cfg.horizon}"
        rows[key] = row
        print(f"[20] bodies {key} ({name}'s fleet): {k1_line(row['K1'])}; the rule picks width "
              f"{row['rule_width']} ({smi})")
    print(f"[20] crossover by family (largest swept R·K at which the slab body is no slower, K1 "
          f"with every rollout weighing): {crossover}; the rule's table "
          f"{dict(fs.SLAB_MAX_ROLLOUTS)} ({smi})")
    return dict(bodies=rows, crossover=crossover)


# ---------------------------------------------------------------------------
# a fused family registered from user code (phase 22): the kinematic bicycle
# of mppi_gpu_tpu_torch/examples/custom_family.py, K1 and K4 built from its
# struct into a library of their own (ops/_build.build_family)

BICYCLE_STRUCTS = {"Bicycle": "bicycle-demo"}  # the struct's name → the family's
BICYCLE_ENTRIES = ("solve_partials<bicycle-demo>", "rollout_costs<bicycle-demo>")
BICYCLE_SOURCE = ("mppi_gpu_tpu_torch/examples/custom_family.py (struct Bicycle, built on "
                  "mppi_gpu_tpu_torch/csrc/mppi_solve.cuh)")
BICYCLE_REACH_M = 0.3  # the example's exit rule (examples/custom_family.py)


def check_bicycle_diverged(device: str = "cuda") -> str:
    """Diverging rollouts on the bicycle, against the plain version: a block
    driven by an acceleration ε of 1e30 costs +inf (its speed term
    overflows) and gets weight 0 while the others solve as before; from a
    speed of 1e20 every rollout costs +inf, so K2's β is +inf, the action is
    NaN and the guard fires, on the fused backend (on a CUDA device) and the
    eager one alike, as for the built-in families."""
    import torch

    from mppi_gpu_tpu_torch.examples.custom_family import make_controller
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.utils.guard import ControllerDiverged, check_solve

    p = make_family_problem("bicycle", 1000, 50, device=device)
    eps = p["eps"].clone()
    W = fs.block_width(1, 1000, 50, 2, p["fam"].name)
    blk = np.s_[W:2 * W]
    eps[:, blk, 0] = 1e30
    got = fs.family_fused_solve(*family_args(p), eps=eps)
    want = fs.family_fused_solve_reference(*family_args(p), eps=eps)
    compare_solves("bicycle one diverged block", p, got, want, S_rtol=1e-5)
    S = _np(got[0])
    expect(np.isposinf(S[blk]).all() and np.isfinite(np.delete(S, blk)).all(),
           "bicycle one diverged block: expected +inf exactly on block 1")
    res = finish(p, *got)
    expect(bool((res.info.weights[blk] == 0).all()), "bicycle: diverged rollouts got weight")
    expect(bool(torch.isfinite(res.action).all()), "bicycle one diverged block: action not finite")
    for backend in ("auto", "eager"):
        ctrl, _ = make_controller(1000, 40, backend, device)
        res = ctrl.solve_auto(torch.tensor([0.0, 0.0, 0.0, 1e20]), ctrl.init_action_seq(), 0)
        info = res.info.cpu()
        expect(bool(torch.isposinf(info.costs).all() and torch.isposinf(info.beta)
                    and torch.isnan(res.action).all()),
               f"bicycle from v=1e20 ({ctrl.rollout_backend}): S and beta not all +inf, or the "
               "action not NaN")
        try:
            check_solve(0, _np(res.action), info)
        except ControllerDiverged:
            continue
        raise SmokeFailure(f"bicycle from v=1e20 ({ctrl.rollout_backend}): the guard did not fire")
    return ("a block at eps=1e30 -> +inf, weight 0, the rest as plain; from v=1e20 -> +inf S and "
            "beta, NaN action, ControllerDiverged (fused and eager)")


def build_bicycle() -> tuple[object, float]:
    """Build (or find) and load the bicycle's library; (its path, seconds)."""
    from mppi_gpu_tpu_torch.examples.custom_family import BicycleFamily
    from mppi_gpu_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build_family(BicycleFamily.cuda_source, BicycleFamily.cuda_struct, 2)
    _build.load_family_library(BicycleFamily.cuda_source, BicycleFamily.cuda_struct, 2)
    return path, time.perf_counter() - t0


def bicycle_phase(smi: str, err: dict, clock_mhz: float, builtin_log: str) -> dict:
    """Phase 22: the bicycle, a family registered from user code. Its
    library's build (seconds, ptxas registers and spills beside the built-in
    unicycle's, A=2 too, and its SASS); at the example's shape (K=1024, T=40)
    and at K=10⁵, T=200: K1 + K2 in the injected-ε mode against the plain
    version and float64, the Philox mode (iid, antithetic, OU 0.5 at the
    example's shape; iid at K=10⁵) against the plain version with K3's dump
    replayed exactly, an R=8 fleet
    bit-equal to its solo launches; K1 and K4 in both bodies (S bit-equal,
    partials as plain at each width); K4's S equal to K1's; diverging
    rollouts; K1 and K4 times (CUDA events and device) beside the plain
    version and the bound from the library's SASS. Then the example at its
    defaults on the fused backend and a costs-only sweep, launches counted
    from 0 before each and read after it. Folds the errors into `err`;
    returns the kernels line's fields of both entries."""
    import torch

    from mppi_gpu_tpu_torch.examples import custom_family
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    key1, key4 = BICYCLE_ENTRIES
    path, build_s = build_bicycle()
    print(f"[22] build of the bicycle family's library: {build_s:.2f} s -> {path.name}")
    for line in ptxas_summary(path.with_suffix(".log").read_text(), BICYCLE_STRUCTS):
        print(f"    ptxas {line}")
    print("    ptxas of the built-in unicycle (A=2): " + "; ".join(
        line for line in ptxas_summary(builtin_log) if re.search(r"<unicycle,", line)))
    steps = library_steps(path, BICYCLE_STRUCTS)
    print("    SASS instructions per horizon step (Philox mode; K4 its loop; K1's per-rollout "
          "body pass 1, pass 2 with every rollout weighing, pass 2 over fewer slots): "
          + "; ".join(f"{k} {v}" for k, v in sorted(steps.items())))
    cfg = _config("bicycle")
    for K, T in ((cfg.samples, cfg.horizon), (100_000, 200)):
        # every noise mode at the example's shape, iid alone at K=10⁵
        modes = ((False, 0.0), (True, 0.0), (False, 0.5)) if K == cfg.samples else ((False, 0.0),)
        e = check_family_injected("bicycle", K, T)
        print(f"[22] bicycle injected K={K} T={T}: ok vs plain (max abs err "
              + ", ".join(f"{k} {e[k]:.3g}" for k in ("S", "beta", "eta", "dU", "action"))
              + f") and float64 (S relative error median {e['S_rel_median']:.3g}, max "
              f"{e['S_rel_max']:.3g}; plain f32 max {e['plain_S_rel_max']:.3g})")
        for anti, ou in modes:
            e = check_family_philox("bicycle", K, T, antithetic=anti, ou_beta=ou)
            err[key1] = max(err[key1], e["solve_partials"])
            err["softmin_combine"] = max(err["softmin_combine"], e["softmin_combine"])
            print(f"[22] bicycle philox K={K} T={T} anti={anti} ou={ou}: K1 S err "
                  f"{e['solve_partials']:.3g}, K2 dU err {e['softmin_combine']:.3g}; K3's dump "
                  "replayed through K1 exact")
        e = check_family_fleet("bicycle", 8, K, T)
        print(f"[22] bicycle fleet R=8 K={K} T={T}: K1 S err {e['solve_partials']:.3g} vs plain; "
              "every robot bit-equal to its R=1 launch")
        for anti, ou in modes:
            e = check_costs_only("bicycle", K, T, antithetic=anti, ou_beta=ou)
            err[key4] = max(err[key4], e["err"])
        print(f"[22] bicycle costs-only K={K} T={T}: K4's S bit-equal to K1's (anti, ou) {modes}; "
              "fleet robots equal to their R=1 launches")
    q = make_family_problem("bicycle", cfg.samples, cfg.horizon)
    e, shares = check_bodies("bodies bicycle-demo A=2", q["fam"], q["x0"], q["U"], q["goal"],
                             q["lam"], cfg.samples, ((False, 0.0), (True, 0.0), (False, 0.5)), q["eps"])
    err[key4] = max(err[key4], e)
    print(f"[22] bodies bicycle-demo K={cfg.samples} T={cfg.horizon}: K1 and K4 S bit-equal in the "
          "slab and the per-rollout body (widths 32 and 128; iid, antithetic, OU 0.5, injected); "
          f"partials of both widths as plain at the problem's lambda, a middle one and 1e9 (share "
          f"of rollouts weighing at width 128: {_shares_line(shares)}); S max abs err vs plain "
          f"{e:.3g}")
    print(f"[22] bicycle diverging rollouts: {check_bicycle_diverged()}")
    out = {key1: {}, key4: {}}
    for K, T, pre in ((cfg.samples, cfg.horizon, ""), (100_000, 200, "large_")):
        p = make_family_problem("bicycle", K, T)
        fam, x0, U = p["fam"], p["x0"], p["U"]
        args = family_args(p, step=3, it=0)
        k4_args = (fam, x0, U, None, K, 7, 3, 0, False, 0.0)
        plain_reps = 3 if K < 100_000 else 2
        for key, run, plain, pass2 in (
                (key1, lambda: fs.family_solve_partials(*args),
                 lambda: fs.family_solve_partials_reference(*args), True),
                (key4, lambda: fs.fused_rollout_costs(*k4_args),
                 lambda: fs.rollout_costs_reference(*k4_args), False)):
            ms, plain_ms = paired_median_ms(run, plain, 20, plain_reps)
            dev = device_ms(run, name="partials_kernel")
            b_ms, b_by = solve_bound(steps, fam, K, T, clock_mhz, pass2=pass2)
            out[key].update({f"{pre}ms": ms, f"{pre}plain_ms": plain_ms, f"{pre}device_ms": dev,
                             f"{pre}bound_ms": b_ms, f"{pre}bound_by": b_by,
                             f"{pre}shape": f"K={K} T={T}",
                             f"{pre}width": fs.block_width(1, K, T, 2, fam.name)})
            print(f"[22] kernel {key} K={K} T={T} (width {fs.block_width(1, K, T, 2, fam.name)}): "
                  f"{ms:.4f} ms, device {dev} ms, plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by}) ({smi})")
        del p, args, k4_args
    # the example at its defaults (K=1024, T=40, 120 steps) on the fused backend
    fs.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = custom_family.main(["--device", "cuda", "--backend", "fused"])
    ex_s = time.perf_counter() - t0
    print("\n".join("    " + line for line in buf.getvalue().strip().splitlines()))
    by_family, launches = fs.family_launch_counts(), fs.launch_counts()
    d = float(re.search(r"dist-to-waypoint ([\d.]+) m", buf.getvalue()).group(1))
    print(f"[22] example custom_family (fused, K=1024 T=40, 120 steps): exit {rc}, distance {d} m "
          f"(bar {BICYCLE_REACH_M}), {ex_s:.2f} s; launches {launches}, K1 by family {by_family}")
    expect(rc == 0 and d < BICYCLE_REACH_M, f"custom_family exited {rc} at {d} m")
    # the warm-up of its solve graph; the replays' records from a trace
    expect(by_family["bicycle-demo"] == 1 and sum(by_family.values()) == 1
           and launches["softmin_combine"] == 1,
           f"custom_family: K1 by family {by_family}, launches {launches} for 120 solves, want "
           "the graph warm-up's")
    out[key1]["launches"] = by_family["bicycle-demo"]
    ctrl, _ = custom_family.make_controller(1024, backend="fused", device="cuda")
    trace = solve_trace("custom_family", ctrl, torch.zeros(4, device="cuda"), ctrl.init_action_seq(),
                        ctrl.cfg.seed)
    print(f"[22] custom_family: records per graphed step in a trace of {SOLVE_TRACE_STEPS}: "
          f"{trace['records']}")
    # the costs-only path: one K4 sweep of the bicycle at K=10⁵, T=200
    q = make_family_problem("bicycle", 100_000, 200)
    fs.reset_launch_counts()
    fs.fused_rollout_costs(q["fam"], q["x0"], q["U"], None, 100_000, 7, 3, 0, False, 0.0)
    torch.cuda.synchronize()
    k4_by_family = fs.family_launch_counts("rollout_costs")
    expect(k4_by_family["bicycle-demo"] == 1 and sum(k4_by_family.values()) == 1,
           f"bicycle costs-only sweep: K4 by family {k4_by_family}")
    out[key4]["launches"] = k4_by_family["bicycle-demo"]
    for entry in out.values():
        entry["build_s"] = build_s
    return out


# ---------------------------------------------------------------------------
# the planar quadrotor's waypoint tour (phase 23) and the learned models
# (phase 24): examples/quadrotor_waypoints, learn_dynamics and
# learn_quadrotor_residual of mppi_gpu_tpu_torch/examples

WAYPOINT_FINAL_M = 0.4  # examples/quadrotor_waypoints.py's exit rule
# learn_quadrotor_residual's size on the card: half the example's defaults,
# which take about a minute of this script's time limit on an H100 (the
# held-out RMSE there 20x below the analytic model's)
RESIDUAL_ARGV = ("--transitions", "8192", "--fit-steps", "2000", "--loop-steps", "60")


def _run_example(module, argv: list[str]) -> tuple[int, str, float]:
    """`module.main(argv)` with its output captured and echoed indented:
    (exit code, output, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    print("\n".join("    " + line for line in out.strip().splitlines()))
    return rc, out, secs


def waypoints_phase(smi: str) -> int:
    """Phase 23: the planar quadrotor's waypoint tour at its defaults (600
    steps) on the fused backend, launches counted from 0 before it and read
    after it, and the packs counted by wrapping ``families.family_for``: the
    tour visits all three waypoints and ends within 0.4 m of the last, K1
    and K2 launch from the host only for the warm-up of its one solve graph
    (a trace of the quadrotor's graphed steps holds one of each per update),
    and the controller packs once, at its init:
    re-aiming the cost every step (a new cost of the old w, λ and Σ⁻¹
    tensors) keeps the pack. Returns K1's launches."""
    from mppi_gpu_tpu_torch.examples import quadrotor_waypoints
    from mppi_gpu_tpu_torch.ops import families
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    packs = []
    family_for = families.family_for

    def counted(*args, **kwargs):
        packs.append(1)
        return family_for(*args, **kwargs)

    fs.reset_launch_counts()
    families.family_for = counted
    try:
        rc, out, secs = _run_example(quadrotor_waypoints,
                                     ["--device", "cuda", "--rollout-backend", "fused"])
    finally:
        families.family_for = family_for
    steps = int(re.search(r"(\d+) steps,", out).group(1))
    visited = re.search(r"waypoints visited: (\[.*?\])", out).group(1)
    d = float(re.search(r"final distance to last waypoint: ([\d.]+) m", out).group(1))
    by_family, launches = fs.family_launch_counts(), fs.launch_counts()
    updates = steps * _config("quadrotor").opt_iters
    print(f"[23] example quadrotor_waypoints (fused, {steps} steps): exit {rc}, waypoints visited "
          f"{visited}, final distance {d} m (bar {WAYPOINT_FINAL_M}), {secs:.2f} s "
          f"({1e3 * secs / steps:.3f} ms per step with the host world; {smi}); packs built "
          f"{len(packs)}; launches {launches}, K1 by family {by_family}")
    expect(rc == 0 and d < WAYPOINT_FINAL_M, f"quadrotor_waypoints exited {rc} at {d} m")
    expect(len(packs) == 1, f"quadrotor_waypoints: {len(packs)} packs, re-aiming re-packed")
    # the warm-up of its one solve graph (the goal re-aimed every step is
    # among the graph's inputs); the replays' records from a trace
    warm = _config("quadrotor").opt_iters
    expect(by_family["quadrotor"] == warm and sum(by_family.values()) == warm
           and launches["softmin_combine"] == warm,
           f"quadrotor_waypoints: K1 by family {by_family}, launches {launches} for {updates} "
           f"updates, want the graph warm-up's {warm}")
    trace = config_trace("quadrotor")
    print(f"[23] quadrotor: records per graphed step in a trace of {SOLVE_TRACE_STEPS}: "
          f"{trace['records']}")
    return by_family["quadrotor"]


def check_learned_episode(steps: int = 120, fit_steps: int = 800, device: str = "cuda") -> dict:
    """A controller over a learned model on the card: the point_mass2d
    surrogate of examples/learn_dynamics (its 2000 transitions, `fit_steps`
    Adam steps) on the eager backend; ``run_episode_jit`` of `steps` cycles
    as a replayed CUDA graph (cuBLAS's products inside the capture) equal
    bit for bit to the same cycle run eagerly on the card, every state
    finite. Returns the controller and both loops' ms per cycle (host clock
    around a warm episode)."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.examples import learn_dynamics
    from mppi_gpu_tpu_torch.runner import run_episode_jit

    cfg = _config("point_mass2d")
    mlp, _, _ = learn_dynamics.fit(
        cfg, learn_dynamics.collect_transitions(cfg, 2000, device=device), fit_steps, device)
    ctrl = MPPIController(cfg, device=device, dynamics=mlp, rollout_backend="eager")
    expect(ctrl.rollout_backend == "eager", f"learned model: backend {ctrl.rollout_backend}")
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    run_episode_jit(ctrl, num_steps=steps)  # warm-up and capture
    out = {"ctrl": ctrl}
    for label, capture in (("graph", True), ("eager", False)):
        sync()
        t0 = time.perf_counter()
        ep = run_episode_jit(ctrl, num_steps=steps, capture=capture)
        sync()
        out[f"{label}_ms"] = 1e3 * (time.perf_counter() - t0) / steps
        out[label] = ep
    g, e = out["graph"], out["eager"]
    expect(np.isfinite(g.xs).all() and g.xs.shape == (steps + 1, cfg.state_dim),
           "learned episode: states")
    expect(np.array_equal(g.xs, e.xs) and np.array_equal(g.us, e.us),
           f"learned episode: the graph parts from the eager cycle by "
           f"{np.abs(g.xs - e.xs).max()} in a state")
    return out


def learned_phase(smi: str) -> dict:
    """Phase 24: the learned models on the card. examples/learn_dynamics at
    its defaults (2000 transitions, 800 Adam steps, 120 episode steps): exit
    0, both final distances finite, the fit's ms per Adam step; the learned
    controller's device episode (:func:`check_learned_episode`); its solve's
    ms per control step on the eager backend beside the fused LTI's at the
    same K, T (point_mass2d, K=3000, T=50), and a profiler window of its
    control steps; examples/learn_quadrotor_residual at RESIDUAL_ARGV: the
    example's exit rule (the hybrid's held-out RMSE below the analytic
    model's, a finite closed-loop distance)."""
    import torch

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.examples import learn_dynamics, learn_quadrotor_residual

    rc, out, secs = _run_example(learn_dynamics, ["--device", "cuda"])
    dists = [float(v) for v in re.findall(r"final distance to goal: (\S+) m", out)]
    fit_ms = float(re.search(r"\(([\d.]+) ms per step\)", out).group(1))
    print(f"[24] example learn_dynamics (2000 transitions, 800 Adam steps, 120 episode steps): "
          f"exit {rc} in {secs:.2f} s; fit {fit_ms:.4f} ms per Adam step; final distance analytic "
          f"{dists[0]:.4f} m, learned {dists[1]:.4f} m ({smi})")
    expect(rc == 0 and len(dists) == 2 and np.isfinite(dists).all(),
           f"learn_dynamics exited {rc} with distances {dists}")
    e = check_learned_episode()
    ctrl = e["ctrl"]
    print(f"[24] learned controller's device episode (point_mass2d K=3000 T=50, 120 cycles): graph "
          f"== eager cycle bit for bit; graph {e['graph_ms']:.4f} ms per cycle, eager on the card "
          f"{e['eager_ms']:.4f} ms ({smi})")
    cfg = ctrl.cfg
    lti = MPPIController(cfg, device="cuda")
    expect(lti.rollout_backend == "fused", f"point_mass2d: auto picked {lti.rollout_backend}")
    x = torch.zeros(cfg.state_dim, device="cuda")
    U = ctrl.init_action_seq()
    lti_ms, mlp_ms = paired_median_ms(lambda: lti.solve_auto(x, U, 1),
                                      lambda: ctrl.solve_auto(x, U, 1), 20, 10)
    prof = profile_steps(ctrl, x, U)
    # the net's products per solve: 2·K·T·Σ in·out over its layers
    flops = 2 * cfg.samples * cfg.horizon * cfg.opt_iters * sum(
        w.shape[0] * w.shape[1] for w in ctrl.dynamics.weights)
    print(f"[24] solve point_mass2d K={cfg.samples} T={cfg.horizon}: learned model, eager "
          f"{mlp_ms:.4f} ms per control step; LTI, fused {lti_ms:.4f} ms (CUDA events, warm "
          f"median); learned, 50 control steps: wall {prof['wall_ms']:.4f} ms/step, device busy "
          f"{prof['busy_ms']:.4f} ms, idle share {prof['idle']:.4f}; the net's products "
          f"{flops / 1e9:.3f} GFLOP per solve, {1e3 * flops / H100_FP32_PER_S:.4f} ms at the "
          f"float32 peak ({smi})")
    rc, out, secs = _run_example(learn_quadrotor_residual, ["--device", "cuda", *RESIDUAL_ARGV])
    e_a = float(re.search(r"analytic model : (\S+)", out).group(1))
    e_h = float(re.search(r"hybrid model   : (\S+)", out).group(1))
    d = float(re.search(r"cycles: (\S+) m", out).group(1))
    fit_q_ms = float(re.search(r"\(([\d.]+) ms per step\)", out).group(1))
    print(f"[24] example learn_quadrotor_residual ({' '.join(RESIDUAL_ARGV)}): exit {rc} in "
          f"{secs:.2f} s; held-out RMSE analytic {e_a:.5f}, hybrid {e_h:.5f}; closed-loop distance "
          f"{d:.3f} m; fit {fit_q_ms:.4f} ms per Adam step ({smi})")
    expect(rc == 0 and e_h < e_a and np.isfinite(d),
           f"learn_quadrotor_residual exited {rc}: RMSE {e_h} vs {e_a}, distance {d}")
    return dict(fit_ms=fit_ms, residual_fit_ms=fit_q_ms, mlp_ms=mlp_ms, lti_ms=lti_ms,
                graph_ms=e["graph_ms"], eager_ms=e["eager_ms"])


# ---------------------------------------------------------------------------
# the host plants (phase 25): the CLI's closed loop against the native C++
# twin (envs/native.py, the root csrc/world.cpp built with g++) and, where
# the machine has it, real MuJoCo, beside the torch world; checkpoint/resume
# on the native plant; the miss harness

PLANT_FAMILIES = ("pendulum", "cartpole", "quadrotor", "quadrotor3d")
PLANT_LOOP_STEPS, PLANT_EARLY_CYCLES = 100, 10
# How far the loop on a host plant may part from the loop on the torch world.
# Both draw one noise stream; the plants differ by f32 rounding (~1e-7 a
# cycle), which the feedback loop amplifies. tests/test_closed_loop.py:47's
# rtol 5e-3, atol 5e-4 and tests/test_mujoco_xval.py:326's per-family 1e-2
# hold over 100 steps in the JAX package's own two loops only for the
# pendulum (its largest gap over seeds 0-7 4.72e-4), so the pendulum is held
# to 1e-2 over its 100 steps. Every other config's loops part in the JAX
# package too, by the largest gaps over seeds 0-7 in PLANT_JAX_GAP
# (tests/_plant_gap_probe.py on the CPU: about the distance between two
# seeds' loops once they have parted), so their 100-step gap is printed
# beside that range and not held; their first PLANT_EARLY_CYCLES cycles,
# before the rounding has grown, are held to ten times the JAX package's
# largest gap there over seeds 0-7 (the rule of EPISODE_HOST_TOL)
PLANT_LOOP_BAR = {"pendulum": 1e-2}
PLANT_EARLY_BAR = {"point_mass2d": 9.81e-4, "point_mass2d-mujoco": 2.28e-3,
                   "point_mass3d": 2.24e-5, "cartpole": 4.54e-3, "quadrotor": 1.02e-4,
                   "quadrotor3d": 1.17}
PLANT_JAX_GAP = {"point_mass2d": (0.723, 0.902), "point_mass2d-mujoco": (0.615, 0.85),
                 "point_mass3d": (4.01e-6, 0.0217), "cartpole": (0.611, 1.17),
                 "quadrotor": (0.787, 1.32), "quadrotor3d": (2.35, 3.57)}
# the miss harness's plant-to-plant gap (tests/test_mujoco_xval.py:119)
MISS_PLANT_GAP = 1e-4


def _trajectory(path: str) -> tuple[dict, np.ndarray]:
    """A CLI trajectory CSV's columns and its states (N, s)."""
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns

    cols = read_csv_columns(path)
    s = sum(1 for k in cols if k.startswith("x["))
    return cols, np.stack([cols[f"x[{i}]"] for i in range(s)], axis=1)


def _average_line(out: str) -> str:
    return next(line.strip() for line in out.splitlines() if "Average controller" in line)


def plant_loop(name: str, plant: str, tmp: str, steps: int | None = None) -> dict:
    """The CLI on configs/<name>.yaml, fused, against `plant` and against the
    torch world (`steps` control steps, or the whole episode): the largest
    |Δx| over the first PLANT_LOOP_STEPS steps, the plant loop's K1/K2
    launches and both loops' average controller times."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", f"{name}.yaml")
    more = [] if steps is None else ["--max-steps", str(steps)]
    out, xs, cols = {}, {}, {}
    for world in (plant, "torch"):
        csv = os.path.join(tmp, f"{name}_{world}.csv")
        before = fs.launch_counts()
        out[world] = _cli(["-c", cfg, "--world", world, "--rollout-backend", "fused", "-t", csv,
                           *more])
        after = fs.launch_counts()
        if world == plant:
            k12 = {k: after[k] - before[k] for k in ("solve_partials", "softmin_combine")}
        cols[world], xs[world] = _trajectory(csv)
    n = min(PLANT_LOOP_STEPS, len(xs[plant]), len(xs["torch"]))
    gap = np.abs(xs[plant][:n] - xs["torch"][:n]).max(axis=1)
    expect(min(k12.values()) > 0, f"{name} --world {plant}: K1/K2 launches {k12}")
    return dict(gap=float(gap.max()), early=float(gap[:PLANT_EARLY_CYCLES].max()),
                steps=(len(xs[plant]), len(xs["torch"])), launches=k12, cols=cols[plant],
                avg={w: _average_line(o) for w, o in out.items()})


def plants_phase(smi: str) -> None:
    """Phase 25: the host plants on the card's host, the solve on the card."""
    from mppi_gpu_tpu_torch import miss
    from mppi_gpu_tpu_torch.config import load_config
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.envs import mujoco_available, native
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns
    from mppi_gpu_tpu_torch.runner import run_closed_loop

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = native.build()
    native.load_library()
    print(f"[25] native world library: g++ {time.perf_counter() - t0:.2f} s -> {lib.name} "
          f"(from csrc/world.cpp, into {lib.parent})")
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plants_")
    try:
        # point_mass2d's 500 steps end short of its goal in both packages (the
        # JAX package's loop on its native plant at 0.4820-0.5026 m at seeds
        # 0-3, tests/_plant_gap_probe.py --whole; phase 7 prints it with no
        # bar), so the steady-state bar is held on point_mass3d, the quality
        # tripwire's config
        loops = [("point_mass2d", "native", None), ("point_mass3d", "native", None)]
        loops += [(name, "native", PLANT_LOOP_STEPS) for name in PLANT_FAMILIES]
        if mujoco_available():
            loops.append(("point_mass2d", "mujoco", None))
        for name, plant, steps in loops:
            r = plant_loop(name, plant, tmp, steps)
            key = name if plant == "native" else f"{name}-{plant}"
            line = (f"[25] CLI {name} --world {plant} vs --world torch, fused, "
                    f"{r['steps'][0]} / {r['steps'][1]} steps: max |dx| ")
            if key in PLANT_LOOP_BAR:
                line += (f"over the first {PLANT_LOOP_STEPS} steps {r['gap']:.3g} (bar "
                         f"{PLANT_LOOP_BAR[key]})")
                expect(r["gap"] < PLANT_LOOP_BAR[key], f"{key}: max |dx| {r['gap']}")
            else:
                lo, hi = PLANT_JAX_GAP[key]
                line += (f"over the first {PLANT_EARLY_CYCLES} cycles {r['early']:.3g} (bar "
                         f"{PLANT_EARLY_BAR[key]}), over {PLANT_LOOP_STEPS} {r['gap']:.3g} (the "
                         f"JAX package's own loops {lo}-{hi} over seeds 0-7; not held)")
                expect(r["early"] < PLANT_EARLY_BAR[key], f"{key}: first cycles' |dx| {r['early']}")
            line += f"; K1/K2 launches {r['launches']}"
            if steps is None:  # a whole point-mass episode
                n = _config(name).action_dim
                steady = steady_distance(r["cols"], _config(name).goal[:n])
                bar3 = f"threshold {LTI_QUALITY_THRESHOLD_M}" if n == 3 else "no bar"
                line += f"; steady-state goal distance {steady:.4f} m ({bar3})"
                expect(n != 3 or steady < LTI_QUALITY_THRESHOLD_M,
                       f"{name} --world {plant}: steady {steady} m")
                expect(r["steps"][0] == r["steps"][1], f"{name} --world {plant}: {r['steps']} steps")
            print(line)
            print(f"    {plant}: {r['avg'][plant]} | torch: {r['avg']['torch']} | {smi}")
        if not mujoco_available():
            print("[25] MuJoCo part not run: `import mujoco` fails on this machine (not counted "
                  "as passed; tier-1 on the CPU holds the MuJoCo plants)")

        # checkpoint/resume on the native plant: the CLI's flags, and the
        # runner's arrays bit for bit
        pm = os.path.join(root, "configs", "point_mass2d.yaml")
        ck, full, res = (os.path.join(tmp, f) for f in ("ck.npz", "full.csv", "res.csv"))
        _cli(["-c", pm, "--world", "native", "--max-steps", "60", "--checkpoint", ck,
              "--checkpoint-every", "25", "-t", full])
        _cli(["-c", pm, "--world", "native", "--max-steps", "60", "--resume", ck, "-t", res])
        rows_full, rows_res = (open(f).read().splitlines() for f in (full, res))
        expect(rows_res[1:] == rows_full[1 + 50:], "--world native --resume: the resumed "
               "trajectory CSV differs from the uninterrupted one's last 10 rows")
        cfg = load_config(pm)
        ck2 = os.path.join(tmp, "ck2.npz")
        a = run_closed_loop(MPPIController(cfg, device="cuda"), world_backend="native",
                            max_steps=60, checkpoint_path=ck2, checkpoint_every=25)
        b = run_closed_loop(MPPIController(cfg, device="cuda"), world_backend="native",
                            max_steps=60, resume_from=ck2)
        expect(np.array_equal(b.xs, a.xs[50:]) and np.array_equal(b.us, a.us[50:]),
               "run_closed_loop(world_backend='native') resumed at step 50 is not bit-equal")
        print("[25] --world native --checkpoint/--resume (point_mass2d, step 50 of 60): the "
              "resumed CSV rows and run_closed_loop's xs and us bit-equal to the uninterrupted run")

        # the miss harness: the native plant against the torch world
        for name in ("point_mass2d", "pendulum"):
            cfgp = os.path.join(root, "configs", f"{name}.yaml")
            cols, lines = {}, {}
            for w in ("native", "torch"):
                path = os.path.join(tmp, f"miss_{name}_{w}.csv")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = miss.main(["-c", cfgp, "--world", w, "-o", path])
                expect(rc == 0, f"miss -c {name} --world {w} exited {rc}")
                lines[w] = buf.getvalue().splitlines()[0]
                cols[w] = read_csv_columns(path)
            gap = max(float(np.abs(cols["native"][k] - cols["torch"][k]).max())
                      for k in cols["native"] if k.endswith("_w"))
            print(f"[25] miss -c configs/{name}.yaml --world native (model on cuda): "
                  f"{lines['native']}; --world torch: {lines['torch']}; plant-to-plant max "
                  f"|dx| {gap:.3g} (bar {MISS_PLANT_GAP})")
            expect(gap < MISS_PLANT_GAP, f"miss {name}: native vs torch world {gap}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[25] phase 25 took {time.perf_counter() - t_phase:.1f} s")


def plants_only() -> int:
    """``python3 chip_smoke.py --plants``: the build (phase 2), then phase
    25 alone, and no contract line: the quickest check of the host plants on
    the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s")
    plants_phase(smi)
    return 0


# ---------------------------------------------------------------------------
# the graphs (phase 26): the host loop's solve as one replayed CUDA graph
# (graphs.SolveGraph) and the sharded device episode, its collectives inside
# the captured cycle

LEAF_NAMES = ("action", "u_next", "costs", "beta", "eta", "weights", "u_seq")
GRAPH_HOST_STEPS = 100       # control steps per timed host loop, each mode
GRAPH_LEARNED_STEPS = 20     # the learned model's (~28 ms per op-by-op step)
SHARDED_EPISODE_CONFIGS = ("point_mass2d", "flagship")
# the flagship's loop amplifies rounding (phase 21: the host loop parts from
# the graph episode by 1e-3 in 12 cycles), so after 500 cycles the sharded
# episode, whose η and ΔU are summed in another order, is another draw of
# the closed loop than the solo one: at the config's seed the CPU's solo,
# one-pass and two-kernel episodes over 1 and 4 ranks ended 0.199-0.327 m
# from the goal (tests/_sharded_quality_probe.py). The tripwire, set at one
# seed, is held over SHARDED_QUALITY_SEEDS seeds from the config's, paired
# seed by seed with the solo graph episode at the same seed: the sharded
# episode must not end farther from the goal at more seeds than chance
# allows (one-sided sign test at SHARDED_SIGN_ALPHA, :func:`sign_test_worse`)
SHARDED_QUALITY_SEEDS = 32
SHARDED_SIGN_ALPHA = 0.01
K5_STEP_MODES = (("iid", False, 0.0), ("antithetic", True, 0.0), ("ou0.5", False, 0.5))


def check_graphed_solve(label: str, ctrl, x, U, seed, steps: int = 3, reaim=None) -> int:
    """`steps` control steps, U fed forward: the graphed solve (``ctrl.solve``,
    a replayed CUDA graph on a CUDA device) against ``solve(capture=False)``,
    every leaf ``torch.equal``; ``reaim(step)``, if given, re-aims the cost
    before each step. Returns how many solve graphs the steps built."""
    import torch

    built, last = 0, None
    for step in range(steps):
        if reaim is not None:
            reaim(step)
        want = ctrl.solve(x, U, seed, step, capture=False)
        got = ctrl.solve(x, U, seed, step)
        graph = ctrl._solve_graphs["solve"][1]
        built += graph is not last
        last = graph
        for name, a, b in zip(LEAF_NAMES, _leaves(got), _leaves(want)):
            expect(torch.equal(a, b), f"{label} step {step}: the graphed solve's {name} differs "
                   "from the op-by-op solve's")
        U = got.u_next
    return built


def check_weighted_update_step_pointer(A: int, K: int, T: int, device: str = "cuda") -> None:
    """K4's S, K5's partials and ΔU (K5 + K2's fold) with the control step
    passed by its address (a 0-dim int64 on the card) equal to the by-value
    launches, in every noise mode of K5_STEP_MODES, at draw offset K; the
    step 2³² + 3 checks that K5 takes its low word as the by-value word is."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    p = make_problem(A, K, T, device=device)
    fam = fs.lti_family(p["sigma"], p["inv_s"], p["w"], p["dt"], p["lam_cost"])
    w = torch.rand(K, generator=torch.Generator().manual_seed(K)).to(device)
    w /= w.sum()
    word = 2**32 + 3
    step = torch.tensor(word, dtype=torch.int64, device=device)
    inner = fs._launch_softmin_combine
    for mode, anti, ou in K5_STEP_MODES:
        out = {}
        for form, s in (("value", word), ("pointer", step)):
            seen = []

            def spy(partials, *a, **k):
                seen.append(partials.clone())
                return inner(partials, *a, **k)

            fs._launch_softmin_combine = spy
            try:
                dU = fs.weighted_update(p["sigma"], w, T, K, 7, s, 1, anti, ou, k0=K)
            finally:
                fs._launch_softmin_combine = inner
            S = fs.fused_rollout_costs(fam, p["x0"], p["U"], p["goal"], K, 7, s, 1, anti, ou, k0=K)
            out[form] = (S, *seen, dU)
        for what, a, b in zip(("K4 S", "K5 partials", "dU"), out["value"], out["pointer"]):
            expect(torch.equal(a, b), f"A={A} K={K} T={T} {mode}: {what} by pointer differs from "
                   "by value")


def host_loop_ms(ctrl, x, U, seed, steps: int) -> tuple[float, float]:
    """ms per control step of a host loop of `steps` solves, the state sent
    from the host (`x` on the CPU) and the action read back each step, U fed
    forward: (graphed, op by op), host clock around each loop, in turns (op
    by op, graphed, graphed, op by op), the median of each mode's two; a warm
    step of each first."""
    import torch

    def loop(capture: bool, n: int) -> float:
        u = U
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            res = ctrl.solve(x, u, seed, i, capture=capture)
            res.action.cpu()
            u = res.u_next
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    loop(True, 2)
    loop(False, 2)
    op = [loop(False, steps)]
    graph = [loop(True, steps), loop(True, steps)]
    op.append(loop(False, steps))
    return float(np.median(graph)), float(np.median(op))


def sign_test_worse(diffs) -> tuple[int, int, float]:
    """One-sided sign test on paired differences (sharded − solo steady
    distance, one per seed): of the n differences that are not 0, k are
    above 0; p = P(X ≥ k) for X ~ Binomial(n, 1/2), the p-value of "the
    sharded episode ends farther from the goal than the solo one at more
    seeds than not". Returns (k, n, p); p = 1 when n = 0."""
    nz = [float(d) for d in diffs if d != 0]
    n, k = len(nz), sum(d > 0 for d in nz)
    return k, n, sum(math.comb(n, j) for j in range(k, n + 1)) / 2**n if n else 1.0


def quality_over_seeds(name: str, ctrl) -> list[float]:
    """The steady state of `ctrl`'s graph episode of config `name` at
    SHARDED_QUALITY_SEEDS seeds from the config's."""
    from mppi_gpu_tpu_torch.runner import run_episode_jit

    cfg = ctrl.cfg
    return [episode_quality(name, cfg, run_episode_jit(ctrl, seed=cfg.seed + i).xs
                            .astype(np.float64))[0] for i in range(SHARDED_QUALITY_SEEDS)]


# ---------------------------------------------------------------------------
# K8 sharded_scale and K9 sharded_tail (phase 27): the one-pass sharded
# combine between its two all-reduces, and the sharded controller's tail and
# world step after them, against their plain versions and against the torch
# combine, K7 and K6 they replaced

SHARDED_SOURCE = "mppi_gpu_tpu_torch/csrc/sharded_combine.cu"
SHARDED_REPLACES = ("no Pallas kernel: XLA's fusion of the one-pass sharded combine, "
                    "mppi_gpu_tpu/controller.py:493-500, 522-531, under jax.jit, "
                    "mppi_gpu_tpu/parallel/sharded.py:157")
# how far K8 and K9 may part from their plain versions and from the torch
# combine on the card: not at all. Each torch op is repeated in order, rounded
# once alike, and the cross-rank sums are the mesh's own
SHARDED_TOL = 0.0
SHARDED_RANKS = (1, 2, 4)  # local ranks of a virtual mesh
SHARDED_SHAPES = ((6, 2), (50, 2), (60, 4), (200, 3))  # (T, A): T·A 12, 100, 240, 600
# λ = 1.1, 1.7 and 0.064: where 1.0f/λ and float32(1/λ) are two floats
SHARDED_LAMS = (1.0, 1.1, 1.7, 0.064, 1e9)
# a rank whose rollouts all cost +inf (its η_d and ΔŨ_d NaN), every rank so
# (β +inf, η and ΔU NaN), and a rank whose f_d underflows to 0
SHARDED_CASES = ("finite", "inf rank", "every rank inf", "underflow")
SHARDED_K_LOC = 64  # rollouts per rank behind the weights
SHARDED_WORLD_CYCLES = 3  # K9's world step, chained cycles per world body
# rows on each boundary of K9's row block (256 threads, 4 entries each: 1024
# per pass) and past 48 KB of shared memory up to the largest, 227 KB: T·A 1,
# 31, 32, 33, 255, 256, 257, 1023, 1024, 1025, 2049, 12291 and 58112, A 1-4
SHARDED_EDGE_SHAPES = ((1, 1), (31, 1), (16, 2), (11, 3), (85, 3), (64, 4), (257, 1), (341, 3),
                       (256, 4), (1025, 1), (683, 3), (4097, 3), (14528, 4))
SHARDED_EDGE_RANKS = (1, 4)
SHARDED_EDGE_LAMS = (1.1,)
SHARDED_EDGE_CASES = ("finite", "inf rank")
# K9's world step at each world body's config horizon (None), at T = 1 and at
# a row of two passes (T·A 1100-4400)
SHARDED_WORLD_HORIZONS = (None, 1, 1100)
# K10, K11 and K5's softmin form: rollouts per rank K/n on the boundaries of
# K11's 4096-entry chunk, a block of K10 and K11 (one entry, a ragged warp,
# one chunk less one, one, one more) and at the point_mass2d shape; rows in
# a cluster of 2-8 blocks (two chunks, the flagship's three on a world of
# one, four, eight) and one chunk past it (nine: scratch and a ticket); then
# one case at the K = 10⁶ cell's (a block per chunk, 245, and the ticket),
# the point-mass (T, A) behind K5
SOFTMIN_K_LOCS = (1, 7, 4095, 4096, 4097, 3000, 8192, 10_000, 16_384, 32_768, 32_769)
SOFTMIN_LARGE = (1, 1_000_000, 1.1, "finite")  # (n, K/n, λ, case)
SOFTMIN_SHAPE = (8, 2)
# a row with a NaN cost besides SHARDED_CASES: β and η NaN where it is (K10
# is torch.amin's, a NaN wins); held by where the NaNs are and every other
# bit
SOFTMIN_CASES = SHARDED_CASES + ("nan",)
SOFTMIN_SOURCE = SHARDED_SOURCE
SOFTMIN_REPLACES = ("no Pallas kernel: XLA's fusion of softmin_weights around its pmin and psum, "
                    "mppi_gpu_tpu/ops/softmin.py:30-43, in mppi_gpu_tpu/controller.py:508-521, "
                    "under jax.jit, mppi_gpu_tpu/parallel/sharded.py:157")


def sharded_inputs(n: int, T: int, A: int, lam: float, case: str, device: str, seed: int = 0):
    """The local ranks' rows [β_d, η_d, ΔŨ_d] (n, 2 + T·A) as K2 writes them
    unnormalized, their costs S (n, SHARDED_K_LOC) with min β_d, U (T, A)
    past the bounds in places and max_a (A,), from a numpy seed; `case` of
    SHARDED_CASES."""
    import torch

    rng = np.random.default_rng(seed)
    beta_d = (5.0 + lam * rng.uniform(0.0, 3.0, n)).astype(np.float32)
    if case == "underflow" and n > 1:  # f_0 = exp(−150) is 0 in float32
        beta_d[0] = np.float32(beta_d[1:].min() + 150.0 * lam)
    S = (beta_d[:, None] + lam * rng.uniform(0.0, 8.0, (n, SHARDED_K_LOC))).astype(np.float32)
    S[:, 0] = beta_d
    eta_d = rng.uniform(1.0, SHARDED_K_LOC, n).astype(np.float32)
    dU_d = rng.normal(0.0, 1.0, (n, T * A)).astype(np.float32)
    inf = {"inf rank": [n - 1], "every rank inf": list(range(n))}.get(case, [])
    for d in inf:
        beta_d[d], S[d], eta_d[d], dU_d[d] = np.inf, np.inf, np.nan, np.nan
    rows = np.concatenate([beta_d[:, None], eta_d[:, None], dU_d], 1)
    U = rng.uniform(-1.5, 1.5, (T, A)).astype(np.float32)
    max_a = rng.uniform(0.3, 1.2, A).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in (rows, S, U, max_a))


def check_sharded_combine(device: str = "cuda", ranks=SHARDED_RANKS, shapes=SHARDED_SHAPES,
                          lams=SHARDED_LAMS, cases=SHARDED_CASES) -> dict:
    """K8 and K9 against their plain versions and against the torch combine
    (``parallel/sharded.onepass_combine``, then K7's plain tail and K7
    itself, ``solve_tail``) on the same rows, for n local ranks of a virtual
    mesh (the MIN and the SUM its reductions), every (T, A), λ and case:
    K8's rows, β, η, ΔU = Σ/η, and K9's every output with the weights, the
    cycle's form (U shifted in place) and the two-kernel branch's form (ΔU
    given, no division), bit for bit (SHARDED_TOL). Returns whether all
    were, the largest |Δ| otherwise, the cases and the launches (one of K8
    and three of K9 per case on the card, none on the CPU)."""
    from mppi_gpu_tpu_torch.controller import CYCLE, FULL
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc
    from mppi_gpu_tpu_torch.ops import solve_tail as st
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh
    from mppi_gpu_tpu_torch.parallel.sharded import onepass_combine

    sc.reset_launch_counts()
    worst, equal, n_cases = 0.0, True, 0

    def hold(label: str, got, want) -> None:
        nonlocal worst, equal
        if bits_equal(got, want):
            return
        equal = False
        d = max_abs_diff(got, want)
        worst = max(worst, d)
        expect(d <= SHARDED_TOL, f"{label}: max |kernel - plain| {d:.3g} (tolerance {SHARDED_TOL})")

    for n in ranks:
        reduce = virtual_mesh(n, device).all_reduce
        for T, A in shapes:
            for lam in lams:
                for case in cases:
                    label = f"K8/K9 n={n} T={T} A={A} lambda={lam} {case}"
                    rows, S, U, max_a = sharded_inputs(n, T, A, lam, case, device, seed=n_cases)
                    beta = reduce(rows[:, 0], "min", keep=True)
                    scaled = sc.sharded_scale(rows, beta, lam)
                    hold(f"{label} K8", scaled, sc.sharded_scale_reference(rows, beta, lam))
                    sums = reduce(scaled, "sum")
                    b_t, e_t, dU_t = onepass_combine(rows[:, 0].contiguous(), rows[:, 1].contiguous(),
                                                     rows[:, 2:].reshape(n, T, A), lam, reduce)
                    hold(f"{label} beta", beta, b_t)
                    hold(f"{label} eta", sums[0], e_t)
                    S_all = S.reshape(-1)
                    dU, full = sc.sharded_tail(U, sums, max_a, True, FULL, (S_all, beta, sums[0], lam),
                                               divide=True, keep_dU=True)
                    want = st.solve_tail_reference(U, dU_t, max_a, True, FULL, (S_all, b_t, e_t, lam))
                    k7 = st.solve_tail(U, dU_t, max_a, True, FULL, (S_all, b_t, e_t, lam))
                    hold(f"{label} dU", dU, dU_t)
                    for k in FULL:
                        hold(f"{label} {k}", getattr(full, k), getattr(want, k))
                        hold(f"{label} {k} vs K7", getattr(full, k), getattr(k7, k))
                    U_c = U.clone()
                    _, cyc = sc.sharded_tail(U_c, sums, max_a, True, CYCLE, into=U_c, divide=True)
                    hold(f"{label} U shifted in place", U_c, want.u_next)
                    hold(f"{label} cycle action", cyc.action, want.action)
                    _, two = sc.sharded_tail(U, dU_t, max_a, False, FULL, (S_all, b_t, e_t, lam))
                    want = st.solve_tail_reference(U, dU_t, max_a, False, FULL, (S_all, b_t, e_t, lam))
                    for k in FULL:
                        hold(f"{label} two-kernel {k}", getattr(two, k), getattr(want, k))
                    n_cases += 1
    launches = {k: v for k, v in sc.launch_counts().items() if k in ("sharded_scale", "sharded_tail")}
    if device == "cuda":
        expect(launches == {"sharded_scale": n_cases, "sharded_tail": 3 * n_cases},
               f"K8/K9: launches {launches} over {n_cases} cases")
    return dict(bit_equal=equal, max_abs_err=worst, cases=n_cases, launches=launches)


def softmin_inputs(n: int, k_loc: int, lam: float, case: str, device: str, seed: int = 0):
    """The local ranks' costs S (n, k_loc) from a numpy seed, each row's
    least cost 5-8·λ and the rest up to 8·λ above it; `case` of
    SOFTMIN_CASES: a rank at +inf, every rank so, rank 0 150·λ above the
    others (its e_k underflow to 0), a NaN in rank 0's last entry."""
    import torch

    rng = np.random.default_rng(seed)
    beta_d = (5.0 + lam * rng.uniform(0.0, 3.0, n)).astype(np.float32)
    if case == "underflow" and n > 1:
        beta_d[0] = np.float32(beta_d[1:].min() + 150.0 * lam)
    S = (beta_d[:, None] + lam * rng.uniform(0.0, 8.0, (n, k_loc))).astype(np.float32)
    S[np.arange(n), rng.integers(0, k_loc, n)] = beta_d
    for d in {"inf rank": [n - 1], "every rank inf": list(range(n))}.get(case, []):
        S[d] = np.inf
    if case == "nan":
        S[0, -1] = np.nan
    return torch.from_numpy(S).to(device)


def check_sharded_softmin(device: str = "cuda", ranks=SHARDED_RANKS, k_locs=SOFTMIN_K_LOCS,
                          lams=SHARDED_LAMS, cases=SOFTMIN_CASES, large=SOFTMIN_LARGE) -> dict:
    """K10, K11 and K5's softmin form against their plain version
    (``parallel/sharded.softmin_across``) on the same costs, for n local
    ranks of a virtual mesh (the MIN and the SUM its reductions), every
    K/n, λ and case, and the `large` case (n, K/n, λ, case): β and η bit for
    bit, and each rank's ΔU from K5's softmin form (+ K2's fold, T·A of
    SOFTMIN_SHAPE) bit-equal to K5's w form on softmin_across's weights, in
    iid, antithetic (even K/n), OU 0.5 and injected mode by turns; the row
    tickets zero after each call. The "nan" case holds β, η and ΔU by where
    their NaNs are and every other bit. Returns whether all were bit-equal,
    the largest |Δ|, the cases and the launches (one of K10 and K11, n of K5
    in each form per case on the card, none on the CPU)."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh
    from mppi_gpu_tpu_torch.parallel.sharded import softmin_across

    sc.reset_launch_counts()
    fs.reset_launch_counts()
    worst, equal, n_cases, updates = 0.0, True, 0, 0
    T, A = SOFTMIN_SHAPE
    sigma = torch.tensor([0.3, 0.7], device=device)
    modes = ("iid", "antithetic", "ou", "injected")

    def hold(label: str, got, want, nan: bool) -> None:
        nonlocal worst, equal
        if nan:  # where the NaNs are, and every other bit
            same = torch.equal(torch.isnan(got), torch.isnan(want))
            ok = ~torch.isnan(want)
            if same and bits_equal(got[ok], want[ok]):
                return
        elif bits_equal(got, want):
            return
        equal = False
        d = max_abs_diff(got, want)
        worst = max(worst, d)
        expect(d <= SHARDED_TOL, f"{label}: max |kernel - plain| {d:.3g} (tolerance {SHARDED_TOL})")

    grid = [(n, k, lam, case) for n in ranks for k in k_locs for lam in lams for case in cases]
    for n, k_loc, lam, case in grid + ([large] if large else []):
        label = f"K10/K11/K5 n={n} K/n={k_loc} lambda={lam} {case}"
        mesh = virtual_mesh(n, device)
        S = softmin_inputs(n, k_loc, lam, case, device, seed=n_cases)
        tickets = torch.zeros(n, dtype=torch.int32, device=device)
        beta = mesh.all_reduce(sc.softmin_min(S, tickets), "min")
        eta = mesh.all_reduce(sc.softmin_eta(S, beta, lam, tickets), "sum")
        b_t, e_t, w_t = softmin_across(S, lam, mesh.all_reduce)
        nan = case == "nan"
        hold(f"{label} beta", beta, b_t, nan)
        hold(f"{label} eta", eta, e_t, nan)
        expect(not bool(tickets.any()), f"{label}: row tickets {tickets} after K10 and K11")
        mode = modes[n_cases % len(modes)]
        if mode == "antithetic" and k_loc % 2:
            mode = "iid"
        anti, ou = mode == "antithetic", 0.5 if mode == "ou" else 0.0
        for i in range(n):
            eps = None
            if mode == "injected":
                g = torch.Generator().manual_seed(n_cases * 8 + i)
                eps = (0.4 * torch.randn(T, k_loc, A, generator=g)).to(device)
            args = (T, k_loc, 7, 3, 1, anti, ou)
            got = fs.weighted_update(sigma, (S[i], beta, eta, lam), *args, eps=eps, k0=i * k_loc)
            want = fs.weighted_update(sigma, w_t[i].contiguous(), *args, eps=eps, k0=i * k_loc)
            hold(f"{label} rank {i} {mode} dU", got, want, nan)
            updates += 1
        n_cases += 1
    launches = {k: v for k, v in sc.launch_counts().items() if k.startswith("softmin_")}
    launches["weighted_update"] = fs.launch_counts()["weighted_update"]
    if device == "cuda":
        expect(launches == {"softmin_min": n_cases, "softmin_eta": n_cases,
                            "weighted_update": 2 * updates},
               f"K10/K11/K5: launches {launches} over {n_cases} cases, {updates} updates")
    return dict(bit_equal=equal, max_abs_err=worst, cases=n_cases, launches=launches)


def softmin_row_bound(n: int, k_loc: int, eta: bool) -> tuple[float, str]:
    """The least time the card could take for one K10 (`eta` False) or K11:
    the larger of its bytes (S read once, β with K11, the n results written
    once) over 3.35 TB/s and its operations (a compare per entry; K11 a
    subtraction, a product, an exp and an add) over the float32 peak."""
    floats = n * k_loc + n + int(eta)
    ops = n * k_loc * (4 if eta else 1)
    t_bytes, t_ops = 4 * floats / H100_BYTES_PER_S, ops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# the shapes K10, K11 and K5's softmin form are timed at: the flagship's
# (point_mass3d K=10⁴ T=200) and point_mass2d's (K=3000 T=50), on the world
# of one and on four virtual ranks
SOFTMIN_TIME_SHAPES = (("flagship", 1), ("flagship", 4), ("point_mass2d", 1), ("point_mass2d", 4))


def sharded_softmin_times() -> dict:
    """K10 and K11 at SOFTMIN_TIME_SHAPES: CUDA events around a call (warm
    median) in turns with the plain version's, the device time alone, the
    bound, and the torch calls for the same work, ``torch.amin(S, 1)`` (one
    call, K10's library yardstick) and ``torch.exp(-(S - β) / λ).sum(1)``
    (three), each by events and by the device time of every kernel it
    launches (``torch_device_ms``); K5's softmin form beside its w form at
    each config's (A, K, T) on one rank, iid: events and device time."""
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc

    out = {}
    for name, n in SOFTMIN_TIME_SHAPES:
        cfg = _episode_config(name)
        k_loc, lam = cfg.samples // n, cfg.lambda_
        S = softmin_inputs(n, k_loc, lam, "finite", "cuda")
        tickets = torch.zeros(n, dtype=torch.int32, device="cuda")
        beta = sc.softmin_min(S, tickets).amin(0)
        for key, kernel, plain, torch_fn, trace, eta in (
                ("K10", lambda: sc.softmin_min(S, tickets), lambda: sc.softmin_min_reference(S),
                 lambda: torch.amin(S, 1), "softmin_min_kernel", False),
                ("K11", lambda: sc.softmin_eta(S, beta, lam, tickets),
                 lambda: sc.softmin_eta_reference(S, beta, lam),
                 lambda: torch.exp(-(S - beta) / lam).sum(1), "softmin_eta_kernel", True)):
            ms, plain_ms = paired_median_ms(kernel, plain, 50, 10)
            bound, by = softmin_row_bound(n, k_loc, eta)
            out[f"{key} {name} n={n} K/n={k_loc}"] = dict(
                ms=ms, plain_ms=plain_ms, torch_ms=float(np.median(time_ms(torch_fn, 50))),
                bound_ms=bound, bound_by=by, device_ms=device_ms(kernel, name=trace),
                torch_device_ms=device_ms(torch_fn, name=None))
        if n == 1:
            T, A, K = cfg.horizon, cfg.action_dim, cfg.samples
            sigma = torch.full((A,), 0.25, device="cuda")
            eta = sc.softmin_eta(S, beta, lam, tickets)[0]
            w = fs.softmin_weights_of((S[0], beta, eta, lam))
            forms = {"softmin": (lambda: fs.weighted_update(sigma, (S[0], beta, eta, lam), T, K, 7,
                                                            3, 0, False, 0.0), "softmin_update_kernel"),
                     "w": (lambda: fs.weighted_update(sigma, w, T, K, 7, 3, 0, False, 0.0),
                           "weighted_update_kernel")}
            reads = {f: [] for f in forms}
            for f in ("w", "softmin", "softmin", "w"):
                fn, trace = forms[f]
                reads[f].append((float(np.median(time_ms(fn, 20))), device_ms(fn, name=trace)))
            out[f"K5 {name} A={A} K={K} T={T}"] = {
                f"{f}_{k}": float(np.median([r[j] for r in v if r[j] is not None]))
                for f, v in reads.items() for j, k in enumerate(("ms", "device_ms"))}
    return out


def check_sharded_tail_world(name: str, device: str = "cuda",
                             horizons=SHARDED_WORLD_HORIZONS) -> bool:
    """K9's world step for config `name`'s world body, one robot from the
    world's start, at each horizon of `horizons` (None: the config's):
    SHARDED_WORLD_CYCLES chained cycles in the episode's form (the action, U
    shifted in place, the world stepped in its buffers, the histories at the
    counter's row, the x buffer, the counter advanced), dividing by η in the
    first and last and given ΔU in between, against the plain version and
    against K7 and K6 launched one after the other (the torch division
    first), each from the same buffers: all of it bit for bit, the tickets 0
    after every cycle. Returns True (a difference raises)."""
    import torch

    from mppi_gpu_tpu_torch.controller import CYCLE
    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc
    from mppi_gpu_tpu_torch.ops import solve_tail as st
    from mppi_gpu_tpu_torch.ops import world_step as ws

    cfg = _config(name)
    A = cfg.action_dim
    world = make_world(cfg, device=device)
    state0 = world.reset()
    max_a = torch.tensor(cfg.max_a, dtype=torch.float32, device=device)
    n = SHARDED_WORLD_CYCLES + 2
    for T in horizons:
        T = T or cfg.horizon
        rng = np.random.default_rng(len(name) + T)
        U0 = torch.from_numpy(rng.uniform(-1.0, 1.0, (T, A)).astype(np.float32)).to(device)
        kern, U_k, step_k = _episode_buffers(world, state0, U0, n, device)
        plain, U_p, step_p = _episode_buffers(world, state0, U0, n, device)
        two, U_2, step_2 = _episode_buffers(world, state0, U0, n, device)
        tickets = torch.zeros(2, dtype=torch.int32, device=device)
        for c in range(SHARDED_WORLD_CYCLES):
            divide = c != 1
            if divide:
                dU = rng.normal(0.0, 0.5, 1 + T * A).astype(np.float32)
                dU[0] = np.float32(rng.uniform(1.0, 50.0))
            else:
                dU = rng.normal(0.0, 0.3, (T, A)).astype(np.float32)
            dU = torch.from_numpy(dU).to(device)
            sc.sharded_tail(U_k, dU, max_a, cfg.clamp_action, CYCLE, into=U_k, divide=divide,
                            step=step_k, advance=kern, tickets=tickets)
            sc.sharded_tail_reference(U_p, dU, max_a, cfg.clamp_action, CYCLE, into=U_p,
                                      divide=divide, step=step_p, advance=plain)
            dU_2 = (dU[1:] / dU[0]).view(T, A) if divide else dU
            action = st.solve_tail(U_2, dU_2, max_a, cfg.clamp_action, CYCLE, into=U_2).action
            ws.advance_into(two.world, two.state, action, two.xs, two.us, two.ts, step_2, two.x)
            for other, U_o, step_o, side in ((plain, U_p, step_p, "the plain version"),
                                             (two, U_2, step_2, "K7 + K6")):
                pairs = [("x", kern.x, other.x), ("U", U_k, U_o), ("xs", kern.xs, other.xs),
                         ("us", kern.us, other.us), ("ts", kern.ts, other.ts)]
                pairs += [(f"state leaf {i}", a, b)
                          for i, (a, b) in enumerate(zip(kern.state, other.state))]
                for what, a, b in pairs:
                    expect(bits_equal(a, b), f"K9 {name} T={T} world step, cycle {c} "
                           f"({'divide' if divide else 'dU'}) {what}: not bit-equal to {side} "
                           f"(max |delta| {max_abs_diff(a, b):.3g})")
                expect(int(step_k) == int(step_o) == c + 1 and not bool(tickets.any()),
                       f"K9 {name} T={T} cycle {c}: counters {int(step_k)}, {int(step_o)} "
                       f"({side}), tickets {tickets}")
    return True


def check_sharded_episode_combine(name: str, mesh, onepass: bool, device: str = "cuda",
                                  steps: int | None = None) -> dict:
    """Config `name`'s sharded controller on `mesh` in one branch, on the
    fused backend, against the same controller with the torch combine forced
    (``_torch_combine``: the combine's torch ops, K5 on torch's weights, K7
    and K6, as the cycle ran before K8-K11): one solve with every output
    (action, u_next, S, β, η, the weights, u_seq) and the whole graph
    episode (run_episode_jit: x, u and the clock of every cycle; `steps`
    cycles, the config's if None) bit for bit; then three eager cycles of
    each with their launches counted (the new: K1 or K4, K2 and K5 per local
    rank, K8 one-pass or K10 and K11 two-kernel, and K9 per update, and no
    K7, no K6; the forced one: K7 per update and K6 per cycle), and
    ``onepass_combine`` and ``softmin_across`` (the torch ops between the
    collectives) called by the forced cycle of their branch alone. On the
    CPU both run the plain versions and launch nothing. Returns the launches
    per update and per cycle of each."""
    import torch

    import mppi_gpu_tpu_torch.parallel.sharded as shd
    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController
    from mppi_gpu_tpu_torch.runner import run_episode_jit

    cfg = _episode_config(name)
    branch = "one-pass" if onepass else "two-kernel"
    label = f"sharded {name} n={mesh.size} ({len(mesh.local_ranks)} local) {branch}"
    ctrls = []
    for torch_combine in (False, True):
        c = ShardedMPPIController(cfg, mesh=mesh, onepass=onepass)
        c.rollout_backend = "fused"
        c._torch_combine = torch_combine
        ctrls.append(c)
    new, old = ctrls
    world = make_world(cfg, device=device)
    x0 = world.reset().x
    U0 = new.init_action_seq()
    combine = "onepass_combine" if onepass else "softmin_across"
    calls = {"new": 0, "old": 0}
    orig = getattr(shd, combine)
    side = ["new"]

    def spy(*args, **kwargs):
        calls[side[0]] += 1
        return orig(*args, **kwargs)

    setattr(shd, combine, spy)
    try:
        results, eps, launches = {}, {}, {}
        for key, c in (("new", new), ("old", old)):
            side[0] = key
            results[key] = c.solve(x0, U0, cfg.seed, 3, capture=False)
            eps[key] = run_episode_jit(c, num_steps=steps)
            _, launches[key] = counted(lambda: run_episode_jit(c, num_steps=3, capture=False))
    finally:
        setattr(shd, combine, orig)
    for i, (a, b) in enumerate(zip(_leaves(results["new"]), _leaves(results["old"]))):
        expect(bits_equal(a, b), f"{label}: solve leaf {LEAF_NAMES[i]} differs from the torch "
               f"combine's (max |delta| {max_abs_diff(a, b):.3g})")
    for f in ("xs", "us", "times"):
        a, b = (np.ascontiguousarray(getattr(eps[k], f), np.float32).view(np.int32)
                for k in ("new", "old"))
        expect(np.array_equal(a, b), f"{label}: the graph episode's {f} differ from the torch "
               "combine's")
    expect(calls["new"] == 0, f"{label}: {combine} called {calls['new']} times by the kernels' "
           "controller")
    expect(calls["old"] > 0, f"{label}: the forced torch combine never ran {combine}")
    if device == "cuda":
        n, it = len(mesh.local_ranks), cfg.opt_iters
        k1 = "solve_partials" if onepass else "rollout_costs"
        per_rank = {k1: 3 * it * n, "softmin_combine": 3 * it * n}
        if not onepass:
            per_rank["weighted_update"] = 3 * it * n
        kind = f"world_advance<{world._kernel_kind}>"
        between = {"sharded_scale": 3 * it} if onepass else {"softmin_min": 3 * it,
                                                             "softmin_eta": 3 * it}
        want_new = {**per_rank, "sharded_tail": 3 * it, **between}
        want_old = {**per_rank, "solve_tail": 3 * it, kind: 3}
        expect(launches["new"] == want_new, f"{label}: the kernels' cycle launched "
               f"{launches['new']}, want {want_new}")
        expect(launches["old"] == want_old, f"{label}: the torch-combine cycle launched "
               f"{launches['old']}, want {want_old}")
    return dict(launches=launches, episode_cycles=len(eps["new"].us))


def sharded_scale_bound(n: int, TA: int) -> tuple[float, str]:
    """The least time the card could take for one K8: the larger of its
    bytes (the rows and β read once, the scaled rows written once) over 3.35
    TB/s and its operations (a sub, a multiply and an exp per row, a
    compare and a multiply per entry) over the float32 peak."""
    floats = n * (2 + TA) + 1 + n * (1 + TA)
    ops = 3 * n + 2 * n * (1 + TA)
    t_bytes, t_ops = 4 * floats / H100_BYTES_PER_S, ops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sharded_tail_bound(T: int, A: int, K: int, outputs, world=None, state=None,
                       u=None) -> tuple[float, str]:
    """The least time the card could take for one K9 with the division:
    K7's (:func:`tail_bound`) plus η read and a division per entry, and with
    a world its step's bytes (the state, the pack, the histories, the x
    buffer and the counter) and operations (:func:`plain_world_ops`), as
    :func:`epilogue_bound` counts them."""
    n = T * A
    floats = 2 * n + A + 1 + n * (("u_seq" in outputs) + ("u_next" in outputs)) + A * ("action" in outputs)
    ops = 4 * n
    if "weights" in outputs:
        floats += 2 * K + 2
        ops += 5 * K
    if world is not None:
        floats += 2 * sum(leaf.numel() for leaf in state) + u.numel() + world._packs[u.device].numel()
        floats += 2 * state.x.numel() + u.numel() + state.time.numel() + 4
        ops += plain_world_ops(world, state, u)
    t_bytes, t_ops = 4 * floats / H100_BYTES_PER_S, ops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sharded_combine_times() -> dict:
    """K8's and K9's times at the flagship's shape (T=200, A=3, K=10⁴): K8
    on one local rank's row (a world of one) and on four (a virtual mesh);
    K9 in the episode's form (the division, the action, U shifted in place,
    the point mass's world step with its history rows at the counter) and
    in ``solve``'s (every output with the weights over K): CUDA events around
    a call (warm median) in turns with the plain version's, the device time
    alone, and the bound."""
    import torch

    from mppi_gpu_tpu_torch.controller import CYCLE, FULL
    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh

    cfg = _episode_config("flagship")
    T, A, K, lam = cfg.horizon, cfg.action_dim, cfg.samples, cfg.lambda_
    out = {}
    for n in (1, 4):
        rows, _, _, _ = sharded_inputs(n, T, A, lam, "finite", "cuda")
        beta = virtual_mesh(n, "cuda").all_reduce(rows[:, 0], "min", keep=True)
        ms, plain_ms = paired_median_ms(lambda: sc.sharded_scale(rows, beta, lam),
                                        lambda: sc.sharded_scale_reference(rows, beta, lam), 50, 20)
        bound, by = sharded_scale_bound(n, T * A)
        out[f"K8 n={n}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                device_ms=device_ms(lambda: sc.sharded_scale(rows, beta, lam),
                                                    name="sharded_scale_kernel"))
    rows, S, U, max_a = sharded_inputs(1, T, A, lam, "finite", "cuda")
    sums = sc.sharded_scale(rows, rows[0, 0].clone(), lam)[0]
    world = make_world(cfg, device="cuda")
    state0 = world.reset()
    adv, U_c, step = _episode_buffers(world, state0, U, 4096, "cuda")  # rows past every call's
    tickets = torch.zeros(2, dtype=torch.int32, device="cuda")
    S_full = torch.cat([S.reshape(-1)] * -(-K // S.numel()))[:K].contiguous()
    softmin = (S_full, rows[0, 0].clone(), sums[0], lam)
    forms = {
        "K9 cycle": (lambda: sc.sharded_tail(U_c, sums, max_a, True, CYCLE, into=U_c, divide=True,
                                             step=step, advance=adv, tickets=tickets),
                     lambda: sc.sharded_tail_reference(U_c, sums, max_a, True, CYCLE, into=U_c,
                                                       divide=True, step=step, advance=adv),
                     sharded_tail_bound(T, A, K, CYCLE, world, adv.state,
                                        torch.zeros(A, device="cuda"))),
        "K9 full": (lambda: sc.sharded_tail(U, sums, max_a, True, FULL, softmin, divide=True),
                    lambda: sc.sharded_tail_reference(U, sums, max_a, True, FULL, softmin,
                                                      divide=True),
                    sharded_tail_bound(T, A, K, FULL)),
    }
    for key, (kernel, plain, (bound, by)) in forms.items():
        ms, plain_ms = paired_median_ms(kernel, plain, 50, 10)
        step.zero_()
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        device_ms=device_ms(kernel, name="sharded_tail_kernel"))
        step.zero_()
    return out


def sharded_combine_phase(smi: str) -> dict:
    """Phase 27, in this process's world of one NCCL rank: K8 and K9 against
    their plain versions and the torch combine over every case of
    :func:`check_sharded_combine`, and over the rows on the boundaries of
    K9's row block (SHARDED_EDGE_SHAPES); K9's world step for every world
    body (:func:`check_sharded_tail_world`); the sharded solve and graph episode
    with K8 and K9 bit-equal to the torch-combine cycle at
    SHARDED_EPISODE_CONFIGS, both branches, on the world of one and on four
    virtual ranks, with each cycle's launches
    (:func:`check_sharded_episode_combine`); K10, K11 and K5's softmin form
    against their plain version over every case of
    :func:`check_sharded_softmin`; K8's, K9's, K10's and K11's times beside
    their plain versions, their bounds and the latency floor of a kernel,
    K10's and K11's beside the torch calls for their work, and K5's softmin
    form beside its w form."""
    from mppi_gpu_tpu_torch.parallel import global_mesh
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh

    t0 = time.perf_counter()
    got = check_sharded_combine()
    edge = check_sharded_combine(ranks=SHARDED_EDGE_RANKS, shapes=SHARDED_EDGE_SHAPES,
                                 lams=SHARDED_EDGE_LAMS, cases=SHARDED_EDGE_CASES)
    t_soft = time.perf_counter()
    soft = check_sharded_softmin()
    soft_s = time.perf_counter() - t_soft
    worlds = [name for name in EAGER_EPISODE_CONFIGS if check_sharded_tail_world(name)]
    meshes = {"world of one (NCCL)": global_mesh("cuda:0"), "4 virtual ranks": virtual_mesh(4, "cuda:0")}
    episodes = {}
    for name in SHARDED_EPISODE_CONFIGS:
        for mname, mesh in meshes.items():
            for onepass in (True, False):
                label = f"{name} {mname} {'one-pass' if onepass else 'two-kernel'}"
                episodes[label] = check_sharded_episode_combine(name, mesh, onepass)
    checks_s = time.perf_counter() - t0
    times = sharded_combine_times()
    soft_times = sharded_softmin_times()
    floor = latency_floor()
    agree = "bit-equal" if got["bit_equal"] else f"max |delta| {got['max_abs_err']:.3g}"
    agree_edge = "bit-equal" if edge["bit_equal"] else f"max |delta| {edge['max_abs_err']:.3g}"
    print(f"[27] K8 sharded_scale and K9 sharded_tail: {agree} to their plain versions and to the "
          f"torch combine over {got['cases']} cases (n = {SHARDED_RANKS} local ranks, (T, A) "
          f"{SHARDED_SHAPES}, lambda {SHARDED_LAMS}, {SHARDED_CASES}: K8's rows, beta, eta, dU, "
          f"every output with the weights, also against K7, the cycle's in place, the two-kernel "
          f"form), launches {got['launches']}; {agree_edge} over {edge['cases']} cases on the "
          f"boundaries of K9's row block (n = {SHARDED_EDGE_RANKS}, T*A "
          f"{[T * A for T, A in SHARDED_EDGE_SHAPES]}, lambda {SHARDED_EDGE_LAMS}, "
          f"{SHARDED_EDGE_CASES}), launches {edge['launches']}; K9's world step bit-equal to the "
          f"plain cycle and to K7 + K6 for {', '.join(worlds)} ({SHARDED_WORLD_CYCLES} cycles at "
          f"each horizon {SHARDED_WORLD_HORIZONS}, None the config's); the sharded solve (every "
          f"output) and graph "
          f"episode with K8 and K9 bit-equal to the torch-combine cycle (x, u, the clock) for "
          f"{len(episodes)} cases ({', '.join(episodes)}; "
          + "; ".join(f"{k} {v['episode_cycles']} cycles, eager launches over 3 cycles "
                      f"{v['launches']['new']} vs {v['launches']['old']}" for k, v in episodes.items())
          + f"); checks {checks_s:.1f} s; "
          + "; ".join(f"{k} {v['ms']:.4f} ms by events, device {v['device_ms']}, plain "
                      f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.3g} ({v['bound_by']})"
                      for k, v in times.items())
          + f"; a one-element add (the latency floor of a kernel): device {floor['device_us']} us, "
          f"{floor['graph_ms_per_node']:.5f} graph ms per node ({smi})")
    agree_soft = "bit-equal" if soft["bit_equal"] else f"max |delta| {soft['max_abs_err']:.3g}"
    print(f"[27] K10 softmin_min, K11 softmin_eta and K5's softmin form: {agree_soft} to their plain "
          f"version (softmin_across: beta, eta, and each rank's dU against K5's w form on its "
          f"weights) over {soft['cases']} cases (n = {SHARDED_RANKS} local ranks, K/n "
          f"{SOFTMIN_K_LOCS}, lambda {SHARDED_LAMS}, {SOFTMIN_CASES}; and n, K/n, lambda, case = "
          f"{SOFTMIN_LARGE}; T, A = {SOFTMIN_SHAPE}, iid/antithetic/OU 0.5/injected by turns), "
          f"launches {soft['launches']}, {soft_s:.1f} s of the checks; "
          + "; ".join(f"{k} " + (f"{v['ms']:.4f} ms by events, device {v['device_ms']}, plain "
                                 f"{v['plain_ms']:.4f}, torch {v['torch_ms']:.4f} (device "
                                 f"{v['torch_device_ms']}), bound "
                                 f"{v['bound_ms']:.3g} ({v['bound_by']})" if "ms" in v else
                                 ", ".join(f"{f} {x:.4f}" for f, x in v.items()))
                      for k, v in soft_times.items())
          + f" ({smi})")
    return dict(got, bit_equal=got["bit_equal"] and edge["bit_equal"],
                max_abs_err=max(got["max_abs_err"], edge["max_abs_err"]),
                cases=got["cases"] + edge["cases"], edge=edge, worlds=worlds, episodes=episodes,
                times=times, floor=floor, softmin=soft, softmin_times=soft_times)


def sharded_entries(phase: dict, launches: dict) -> list[dict]:
    """The kernels line's K8, K9, K10 and K11 entries: their launches on the
    sharded paths of phase 26 (the ``--sharded --jit-episode`` CLI and the
    two-kernel episode, the counts set to 0 around each), their largest
    difference from their plain versions (phase 27), and their times at the
    flagship's shape beside their bounds and the latency floor (K10 and K11
    on the world of one, K/n = 10⁴, the four virtual ranks' as "other",
    K10's library call ``torch.amin(S, 1)``, by events and on the device;
    K11 has no one torch call for its work, so its ``torch_ms``, three
    calls, stands beside it)."""
    floor = phase["floor"]
    out = []
    soft = phase["softmin"]
    for name, key in (("softmin_min", "K10"), ("softmin_eta", "K11")):
        m = phase["softmin_times"][f"{key} flagship n=1 K/n=10000"]
        o = phase["softmin_times"][f"{key} flagship n=4 K/n=2500"]
        out.append({
            "name": name, "route": "cuda", "source": SOFTMIN_SOURCE, "replaces": SOFTMIN_REPLACES,
            "launches": launches[name], "max_abs_err": soft["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["torch_ms"] if name == "softmin_min" else None,
            "library_device_ms": m["torch_device_ms"] if name == "softmin_min" else None,
            "torch_ms": m["torch_ms"], "torch_device_ms": m["torch_device_ms"],
            "device_ms": m["device_ms"],
            "shape": "flagship K=10000, one local rank's row of S (a world of one)",
            "bit_equal": soft["bit_equal"], "other_ms": o["ms"], "other_plain_ms": o["plain_ms"],
            "other_device_ms": o["device_ms"], "other_bound_ms": o["bound_ms"],
            "other_shape": "four local ranks' rows of 2500 (a virtual mesh)",
            "floor_kernel_device_us": floor["device_us"],
            "floor_graph_ms_per_node": floor["graph_ms_per_node"]})
    for name, main, other in (("sharded_scale", "K8 n=1", "K8 n=4"), ("sharded_tail", "K9 cycle", "K9 full")):
        m, o = phase["times"][main], phase["times"][other]
        out.append({
            "name": name, "route": "cuda", "source": SHARDED_SOURCE, "replaces": SHARDED_REPLACES,
            "launches": launches[name], "max_abs_err": phase["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "device_ms": m["device_ms"],
            "shape": ("flagship T=200 A=3, one local rank's row (a world of one)" if name == "sharded_scale"
                      else "flagship T=200 A=3, the episode's form: the division, the action, U "
                           "shifted in place, the point mass's world step"),
            "bit_equal": phase["bit_equal"], "other_ms": o["ms"], "other_plain_ms": o["plain_ms"],
            "other_device_ms": o["device_ms"], "other_bound_ms": o["bound_ms"],
            "other_shape": ("four local ranks' rows (a virtual mesh)" if name == "sharded_scale"
                            else "every output with the weights over K=10000 (solve)"),
            "floor_kernel_device_us": floor["device_us"],
            "floor_graph_ms_per_node": floor["graph_ms_per_node"]})
    return out


def sharded_per_update(mesh, onepass: bool, softmin_kernels: bool = True) -> dict:
    """The records per update of a sharded episode's graph cycle: K1 or K4
    and K2 once per local rank, K9 once; one-pass K8 once; two-kernel K5
    once per local rank, in its softmin form with K10 and K11 once each
    (`softmin_kernels`; a package before them: K5's w form, no K10, K11)."""
    n = len(mesh.local_ranks)
    two = not onepass
    return {"solve_partials": n, "softmin_combine": n,
            "weighted_update": n if two and not softmin_kernels else 0,
            "softmin_update": n if two and softmin_kernels else 0,
            "softmin_min": int(two and softmin_kernels), "softmin_eta": int(two and softmin_kernels),
            "sharded_scale": int(onepass), "sharded_tail": 1}


def sharded_cycle_kernels(mesh, opt_iters: int, onepass: bool = True) -> int:
    """Kernels per graph cycle of a sharded episode, per update: one-pass K1
    and K2 per local rank, K8 and K9; two-kernel K4, K5 and K2 per local
    rank, K10, K11 and K9; and the reductions of its collectives over two or
    more local ranks (a virtual mesh: two one-pass, three two-kernel; a real
    rank's are NCCL's, which on a world of one launches none). The copy of
    β_d that a real rank's one-pass MIN takes is a memory copy, not a
    kernel."""
    n = len(mesh.local_ranks)
    if onepass:
        return opt_iters * (2 * n + (2 if n > 1 else 0) + 2)
    return opt_iters * (3 * n + (3 if n > 1 else 0) + 3)


def sharded_episode_row(name: str, mesh_name: str, mesh, onepass: bool, solo, smi: str) -> dict:
    """The sharded device episode of config `name` on `mesh`: the graph
    episode (captured, then timed warm) bit-equal to a second replay and to
    the same cycle run eagerly on the card over the whole episode; within
    the config's EPISODE_HOST_TOL of the solo graph episode `solo` over its
    first EPISODE_HOST_CYCLES cycles (each cycle's S is the solo S; η and
    ΔU are summed in another order); where the config has a tripwire, its
    steady distance over SHARDED_QUALITY_SEEDS seeds paired with the solo
    episode's (:func:`sign_test_worse`); a trace of its replays. Returns its
    row."""
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController
    from mppi_gpu_tpu_torch.runner import run_episode_jit

    cfg = _episode_config(name)
    branch = "one-pass" if onepass else "two-kernel"
    label = f"sharded episode {name} {mesh_name} {branch}"
    ctrl = ShardedMPPIController(cfg, mesh=mesh, onepass=onepass)
    first, first_s = _timed(lambda: run_episode_jit(ctrl))
    graph, graph_s = _timed(lambda: run_episode_jit(ctrl))
    eager, eager_s = _timed(lambda: run_episode_jit(ctrl, capture=False))
    for what, other in (("a second replay", first), ("the eager cycle on the card", eager)):
        for f in ("xs", "us", "times"):
            expect(np.array_equal(getattr(graph, f), getattr(other, f)),
                   f"{label}: the graph episode's {f} differ from {what}'s")
    dx, du = close_loops(f"{label} vs the solo graph episode", graph, solo["ep"], EPISODE_HOST_TOL[name])
    steady, bar = episode_quality(name, cfg, graph.xs.astype(np.float64))
    quality = ""
    if bar is not None:
        seeds = quality_over_seeds(name, ctrl)
        diffs = np.asarray(seeds) - np.asarray(solo["seeds"])
        worse, n_nz, p_worse = sign_test_worse(diffs)
        under, ref = sum(d < bar for d in seeds), sum(d < bar for d in solo["seeds"])
        se = float(diffs.std(ddof=1) / np.sqrt(len(diffs)))
        expect(p_worse >= SHARDED_SIGN_ALPHA,
               f"{label}: farther from the goal than the solo episode at {worse} of {n_nz} seeds "
               f"that differ (one-sided sign test p {p_worse:.3g}, bar {SHARDED_SIGN_ALPHA}); "
               f"per-seed differences {[round(float(d), 4) for d in diffs]}")
        quality = (f"; paired with the solo episode over {len(seeds)} seeds: farther at {worse} of "
                   f"{n_nz} that differ (sign test p {p_worse:.3g}, bar {SHARDED_SIGN_ALPHA}), mean "
                   f"difference {diffs.mean():+.4f} m (standard error {se:.4f}); mean steady "
                   f"{np.mean(seeds):.4f}, solo {np.mean(solo['seeds']):.4f}; {under} and {ref} "
                   "seeds under the bar")
    # K1 or K4, K2 and K5 (its softmin form) once per rank and update; K8
    # (one-pass) or K10 and K11 (two-kernel) and K9 once per update, K9 with
    # the world's step; no K7, no K6
    trace = replay_trace(ctrl, label, epilogue=False, sharded_tail=True,
                         per_update=sharded_per_update(mesh, onepass))
    want = sharded_cycle_kernels(mesh, cfg.opt_iters, onepass)
    expect(trace["kernels"] == want, f"{label}: {trace['kernels']:g} kernels per graph cycle, "
           f"want {want} ({'K1 and K2 per rank, K8' if onepass else 'K4, K5 and K2 per rank, K10, K11'}"
           f" and K9, and on {mesh.size} virtual ranks the reductions of the collectives, per "
           "update)")
    n = len(graph.us)
    row = dict(graph_ms=graph_s * 1e3 / n, eager_ms=eager_s * 1e3 / n, solo_ms=solo["ms"],
               first_s=first_s, dx=dx, du=du, steady=steady, bar=bar, trace=trace)
    print(f"[26] {label} K={cfg.samples} T={cfg.horizon}, {n} cycles: graph {row['graph_ms']:.4f} "
          f"ms/cycle (first call {first_s:.3f} s with the capture), eager on the card "
          f"{row['eager_ms']:.4f}, the solo graph episode {solo['ms']:.4f}; graph == eager; within "
          f"(states, actions) {dx:.3g}, {du:.3g} of the solo episode over {EPISODE_HOST_CYCLES} "
          f"cycles (tol {EPISODE_HOST_TOL[name]}); steady {steady:.4f} (bar {bar}){quality}; trace of "
          f"{EPISODE_PROFILE_CYCLES} replays: {trace['kernels']:g} kernels per cycle, records per "
          f"cycle {trace['records']} (K4 under solve_partials, K5's softmin form as "
          f"softmin_update), K10 {trace['k10_us']:.2f} us, K11 {trace['k11_us']:.2f} us per "
          f"cycle, NCCL {trace['nccl_per_cycle']:g} records, {trace['nccl_us']:.2f} us per "
          f"cycle {trace['nccl_names']}; {_trace_line(trace)} ({smi})")
    return row


def graphs_phase(smi: str) -> dict:
    """Phase 26: K5's step by pointer (:func:`check_weighted_update_step_pointer`,
    and its device ms by value and by pointer); the host loop's graphed solve
    against the op-by-op solve (:func:`check_graphed_solve`) for every
    config's controller at its shape and the flagship, the learned model,
    an R=8 fleet, the sharded controller in both branches on a world of one
    NCCL rank and on four virtual ranks, a cost re-tuned mid-loop (a new
    graph) and a goal re-aimed every step (none), with each loop's ms per
    control step graphed and op by op, profiler windows of the graphed loop,
    and the CLI's average controller execution time; the sharded device
    episode in both branches on both meshes at point_mass2d and the
    flagship (:func:`sharded_episode_row`) and the sharded fleet's, against
    the unsharded fleet's; ``--sharded --jit-episode`` on the card with the
    counts set to 0 around it, and the two-kernel episode's; ``entry`` and
    ``dryrun_multichip(4)``; a two-rank NCCL episode where the machine has
    two GPUs. Needs this process's world of one NCCL rank."""
    import dataclasses

    import torch

    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.entry import dryrun_multichip, entry
    from mppi_gpu_tpu_torch.examples.fleet import circle_goals
    from mppi_gpu_tpu_torch.models.neural import init_mlp_dynamics
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops.cost import goal_of, with_goal
    from mppi_gpu_tpu_torch.parallel import ShardedFleetController, ShardedMPPIController, global_mesh
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh
    from mppi_gpu_tpu_torch.runner import run_episode_jit, run_fleet_episode

    t_phase = time.perf_counter()
    out = {"k5": {}, "host": {}, "profile": {}, "sharded": {}}
    # (a) K5 with the step by address
    for A, K, T in ((3, 10_000, 200), (2, 3000, 50), (3, 100_000, 200)):
        check_weighted_update_step_pointer(A, K, T)
    for K in (10_000, 100_000):
        sigma = torch.full((3,), 0.25, device="cuda")
        w = torch.rand(K, generator=torch.Generator().manual_seed(K)).cuda()
        w /= w.sum()
        step = torch.tensor(3, dtype=torch.int64, device="cuda")
        reads = {"value": [], "pointer": []}
        for form in ("value", "pointer", "pointer", "value"):
            s = 3 if form == "value" else step
            reads[form].append(device_ms(lambda: fs.weighted_update(sigma, w, 200, K, 7, s, 0, False,
                                                                    0.0), name="weighted_update_kernel"))
        out["k5"][K] = {f: float(np.median([v for v in r if v is not None])) for f, r in reads.items()}
    print("[26] K5 by pointer == by value (K4 S, K5 partials, dU bit-equal; iid, antithetic, OU 0.5; "
          "A=3 K=10^4 and 10^5 T=200, A=2 K=3000 T=50); device ms A=3 T=200, iid, in turns "
          + "; ".join(f"K={K}: by value {v['value']:.4f}, by pointer {v['pointer']:.4f}"
                      for K, v in out["k5"].items()) + f" ({smi})")

    # (b) the host loop's solve: graphed == op by op, and its ms per step
    for name in EPISODE_CONFIGS:
        cfg = _episode_config(name)
        ctrl = MPPIController(cfg, device="cuda")
        x0 = _start(cfg)
        built = check_graphed_solve(name, ctrl, x0, ctrl.init_action_seq(), cfg.seed)
        expect(built == 1, f"{name}: {built} solve graphs in 3 steps")
        out["host"][name] = host_loop_ms(ctrl, x0.cpu(), ctrl.init_action_seq(), cfg.seed,
                                         GRAPH_HOST_STEPS)
    cfg = _config("point_mass2d")
    gen = torch.Generator().manual_seed(0)
    mlp = init_mlp_dynamics(cfg.state_dim, cfg.action_dim, generator=gen, device="cuda")
    mlp = mlp.replace([*mlp.weights[:-1], 0.01 * torch.randn(mlp.weights[-1].shape, generator=gen)
                       .cuda()], mlp.biases)
    learned = MPPIController(cfg, device="cuda", dynamics=mlp, rollout_backend="eager")
    x0 = _start(cfg)
    expect(check_graphed_solve("learned", learned, x0, learned.init_action_seq(), cfg.seed) == 1,
           "learned: more than one solve graph")
    out["host"]["learned"] = host_loop_ms(learned, x0.cpu(), learned.init_action_seq(), cfg.seed,
                                          GRAPH_LEARNED_STEPS)
    fcfg = _episode_config("flagship")
    fleet = BatchedMPPIController(fcfg, 8, goals=torch.from_numpy(circle_goals(8, 6)), device="cuda")
    xs0 = _start(fcfg).expand(8, -1).contiguous()
    expect(check_graphed_solve("fleet R=8", fleet, xs0, fleet.init_action_seqs(),
                               fleet.init_seeds()) == 1, "fleet: more than one solve graph")
    out["host"]["fleet R=8"] = host_loop_ms(fleet, xs0.cpu(), fleet.init_action_seqs(),
                                            fleet.init_seeds(), GRAPH_HOST_STEPS)
    meshes = {"world of one (NCCL)": global_mesh("cuda:0"), "4 virtual ranks": virtual_mesh(4, "cuda:0")}
    for mname, mesh in meshes.items():
        for onepass in (True, False):
            sh = ShardedMPPIController(fcfg, mesh=mesh, onepass=onepass)
            label = f"sharded flagship {mname} {'one-pass' if onepass else 'two-kernel'}"
            x0 = _start(fcfg)
            expect(check_graphed_solve(label, sh, x0, sh.init_action_seq(), fcfg.seed) == 1,
                   f"{label}: more than one solve graph")
            out["host"][label] = host_loop_ms(sh, x0.cpu(), sh.init_action_seq(), fcfg.seed,
                                              GRAPH_HOST_STEPS)
    # a cost re-tuned mid-loop re-captures; a goal re-aimed every step does not
    ctrl = MPPIController(cfg, device="cuda")
    x0, U0 = _start(cfg), ctrl.init_action_seq()
    check_graphed_solve("point_mass2d before re-tuning", ctrl, x0, U0, cfg.seed)
    before = ctrl._solve_graphs["solve"][1]
    ctrl.cost = dataclasses.replace(ctrl.cost, w=ctrl.cost.w * 2.0)
    check_graphed_solve("point_mass2d re-tuned", ctrl, x0, U0, cfg.seed)
    expect(ctrl._solve_graphs["solve"][1] is not before, "a re-tuned cost did not re-capture")
    goal = goal_of(ctrl.cost)
    aims = [goal + torch.tensor([0.3 * i, -0.2 * i, 0.0, 0.0], device="cuda") for i in range(4)]

    def reaim(step: int) -> None:
        ctrl.cost = with_goal(ctrl.cost, aims[step % len(aims)])

    kept = ctrl._solve_graphs["solve"][1]
    built = check_graphed_solve("point_mass2d re-aimed", ctrl, x0, U0, cfg.seed, steps=8, reaim=reaim)
    expect(built == 1 and ctrl._solve_graphs["solve"][1] is kept,
           f"a goal re-aimed every step built {built} graph(s)")
    print("[26] graphed solve == op by op (every leaf, 3 steps fed forward, one capture) for "
          f"{', '.join(EPISODE_CONFIGS)}, the learned MLP (eager backend), an R=8 fleet of the "
          "flagship, the sharded flagship in both branches on a world of one NCCL rank and on four "
          "virtual ranks; a re-tuned cost re-captured; a goal re-aimed every step (8 steps) kept "
          "its graph")
    for label, (g_ms, o_ms) in out["host"].items():
        print(f"[26] host loop {label}: graphed {g_ms:.4f} ms per control step, op by op "
              f"{o_ms:.4f} ms (state from the host, action to the host; host clock, "
              f"{GRAPH_LEARNED_STEPS if label == 'learned' else GRAPH_HOST_STEPS} steps, median of "
              f"two loops in turns; {smi})")
    for label, c in (("point_mass2d", MPPIController(cfg, device="cuda")),
                     ("flagship", MPPIController(fcfg, device="cuda")), ("learned", learned)):
        x0 = _start(c.cfg)
        prof = profile_steps(c, x0, c.init_action_seq())
        out["profile"][label] = prof
        print(f"[26] profile {label}, 50 graphed control steps: wall {prof['wall_ms']:.4f} ms/step, "
              f"device busy {prof['busy_ms']:.4f} ms, idle share {prof['idle']:.4f}; K1 "
              f"{prof['K1_us']:.2f} us, K2 {prof['K2_us']:.2f} us per step ({smi})")
    cli_out = _cli(["-c", os.path.join("configs", "point_mass2d.yaml"), "--device", "cuda"])
    out["cli_avg_ms"] = float(re.search(r"Average controller execution time: ([\d.]+) ms",
                                        cli_out).group(1))
    print(f"[26] cli configs/point_mass2d.yaml (graphed host loop): {_average_line(cli_out)} ({smi})")

    # (c) the sharded device episode
    for name in SHARDED_EPISODE_CONFIGS:
        c = _episode_config(name)
        solo_ctrl = MPPIController(c, device="cuda")
        run_episode_jit(solo_ctrl)
        ep, s = _timed(lambda: run_episode_jit(solo_ctrl))
        solo = dict(ep=ep, ms=s * 1e3 / len(ep.us))
        if episode_quality(name, c, ep.xs)[1] is not None:
            solo["seeds"] = quality_over_seeds(name, solo_ctrl)
            print(f"[26] solo graph episode {name}: steady {episode_quality(name, c, ep.xs)[0]:.4f} "
                  f"at the config's seed; over {SHARDED_QUALITY_SEEDS} seeds mean "
                  f"{np.mean(solo['seeds']):.4f}, max {max(solo['seeds']):.4f}")
        for mname, mesh in meshes.items():
            for onepass in (True, False):
                out["sharded"][f"{name} {mname} {'one-pass' if onepass else 'two-kernel'}"] = (
                    sharded_episode_row(name, mname, mesh, onepass, solo, smi))
    xs0 = torch.from_numpy(0.05 * np.random.default_rng(8).standard_normal((8, 6))).float()
    goals = torch.from_numpy(circle_goals(8, 6))
    pm3 = _episode_config("point_mass3d")
    want = run_fleet_episode(BatchedMPPIController(pm3, 8, goals=goals, device="cuda"), xs0=xs0)
    for mname, mesh in meshes.items():
        got = run_fleet_episode(ShardedFleetController(pm3, 8, goals=goals, mesh=mesh), xs0=xs0)
        for f in ("xs", "us", "times"):
            expect(np.array_equal(getattr(got, f), getattr(want, f)),
                   f"sharded fleet episode {mname}: {f} differ from the unsharded fleet's")
    print(f"[26] run_fleet_episode ShardedFleetController point_mass3d R=8 K={pm3.samples} "
          f"T={pm3.horizon}, {len(want.us)} cycles, on the world of one (NCCL, the all_gather "
          "captured) and on four virtual ranks: graph episode bit-equal to the unsharded fleet's")
    # the sharded episode's paths, each with the counts set to 0 around it
    onepass_launches = counted(lambda: _cli(["-c", os.path.join("configs", "point_mass2d.yaml"),
                                             "--device", "cuda", "--sharded", "--jit-episode"]))
    cli_out, onepass_launches = onepass_launches
    _, two_launches = counted(lambda: run_episode_jit(ShardedMPPIController(
        _config("point_mass2d"), mesh=meshes["world of one (NCCL)"], onepass=False)))
    expect(min(onepass_launches.get(k, 0) for k in ("solve_partials", "softmin_combine",
                                                     "sharded_scale", "sharded_tail")) > 0
           and not {"solve_tail", "weighted_update"} & onepass_launches.keys()
           and not any(k.startswith("world_advance") for k in onepass_launches),
           f"--sharded --jit-episode: launches {onepass_launches}")
    expect(min(two_launches.get(k, 0) for k in ("rollout_costs", "weighted_update",
                                                 "softmin_combine", "softmin_min", "softmin_eta",
                                                 "sharded_tail")) > 0
           and not {"solve_tail", "sharded_scale"} & two_launches.keys()
           and not any(k.startswith("world_advance") for k in two_launches),
           f"two-kernel sharded episode: launches {two_launches}")
    print(f"[26] cli --sharded --jit-episode configs/point_mass2d.yaml (world of one, one-pass): "
          f"{re.search(r'episode finished: .*', cli_out).group(0)}; launches {onepass_launches} (the "
          f"warm-up cycle; the replays are in the traces above); two-kernel episode: launches "
          f"{two_launches}")
    out["launches"] = dict(onepass=onepass_launches, two_kernel=two_launches)
    # the harness entry points
    fn, args = entry()
    fn(*args)
    e_ms = float(np.median(time_ms(lambda: fn(*args), 20)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4)
    print(f"[26] entry(): the flagship's graphed solve {e_ms:.4f} ms per call (CUDA events, warm "
          f"median; {smi}); dryrun_multichip(4): " + " | ".join(buf.getvalue().strip().splitlines()))
    out["entry_ms"] = e_ms
    if torch.cuda.device_count() >= 2:
        ranks = group_run(_config("point_mass2d"), 2, episode=True)
        for onepass in (True, False):
            for r in ranks:
                xs, us, exs, eus = r[onepass]
                expect(np.array_equal(xs, exs) and np.array_equal(us, eus),
                       f"n=2 NCCL onepass={onepass}: the graph episode differs from its eager cycle")
                expect(np.array_equal(xs, ranks[0][onepass][0]), "n=2 NCCL: the ranks differ")
        print("[26] n=2 NCCL ranks: the sharded graph episode == its eager cycle on each rank, both "
              "branches, the ranks equal")
    else:
        print(f"[26] n=2 NCCL episode: not run: this machine has {torch.cuda.device_count()} CUDA "
              "device(s), and NCCL refuses two ranks on one GPU")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[26] phase 26 took {out['seconds']:.1f} s")
    return out


def sharded_combine_only() -> int:
    """``python3 chip_smoke.py --sharded-combine``: the build (phase 2), then
    phase 27 alone in a world of one NCCL rank, and no contract line: the
    quickest check of K8-K11 and K5's softmin form and of the sharded
    episode's cycle with them."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    for line in ptxas_summary(lib_path.with_suffix(".log").read_text()):
        if line.startswith(("sharded_", "softmin_min", "softmin_eta", "softmin_update")):
            print(f"    ptxas {line}")
    with nccl_world_of_one():
        sharded_combine_phase(smi)
    _stamp(t0, 27)
    return 0


def graphs_only() -> int:
    """``python3 chip_smoke.py --graphs``: the build (phase 2), then phase
    26 alone in a world of one NCCL rank, and no contract line: the quickest
    check of the graphed solve and the sharded device episode on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s")
    with nccl_world_of_one():
        graphs_phase(smi)
    return 0


@contextlib.contextmanager
def nccl_world_of_one():
    """This process as a world of one NCCL rank (``parallel.init_multihost``
    at a ``file://`` store in a temporary directory), left on exit."""
    from mppi_gpu_tpu_torch.parallel import init_multihost
    from mppi_gpu_tpu_torch.parallel.multihost import shutdown_multihost

    with tempfile.TemporaryDirectory() as group_dir:
        init_multihost("file://" + os.path.join(group_dir, "init"), 1, 0, backend="nccl")
        try:
            yield
        finally:
            shutdown_multihost()


def bicycle_entry(name: str, b: dict, err: float) -> dict:
    """The kernels line's entry of the bicycle's K1 or K4 from phase 22's
    readings: at the example's shape, and at K=10⁵, T=200 as large_*."""
    k1 = name.startswith("solve_partials")
    replaces = (", ".join(f"{PALLAS}:{line}" for line in (2342, 2287, 3121, 2973)) if k1
                else f"{PALLAS}:1952") + f" (a family registered with {PALLAS}:1676)"
    entry = {"name": name, "route": "cuda", "source": BICYCLE_SOURCE, "replaces": replaces,
             "launches": b["launches"], "max_abs_err": err, "ms": b["ms"],
             "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "library_ms": None}
    entry.update({k: v for k, v in b.items() if k not in entry})
    return entry


def _stamp(t_start: float, phase: int) -> None:
    print(f"    (phase {phase} done {time.perf_counter() - t_start:.1f} s into the run)")


def family_only() -> int:
    """``python3 chip_smoke.py --family``: the build (phase 2), then phase 22
    alone, and no contract line: the quickest check of a family registered
    from user code on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s")
    err = dict.fromkeys(KERNEL_ENTRIES, 0.0)
    bicycle_phase(smi, err, max_sm_clock(), lib_path.with_suffix(".log").read_text())
    return 0


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def episode_only() -> int:
    """``python3 chip_smoke.py --episode``: the build (phase 2), then phase
    21 alone, and no contract line: the quickest check of the on-device
    episode on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s")
    episode_phase(smi)
    return 0


def combine_only() -> int:
    """``python3 chip_smoke.py --combine``: the build (phase 2), then K2's
    forms alone (:func:`combine_phase`: both forms against each other, their
    plain versions and K2 + K7 + K6, the crossover, the device times), and
    no contract line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_summary(lib_path.with_suffix(".log").read_text()):
        if re.match(r"(softmin_combine|combine_tail)", line):
            print(f"    ptxas {line}")
    combine_phase(smi)
    return 0


def bodies_only() -> int:
    """``python3 chip_smoke.py --bodies``: the build (phase 2), then phase
    20 alone, and no contract line: K1's and K4's two bodies checked and
    timed, the crossovers of ``fused_solve.SLAB_MAX_ROLLOUTS`` read again."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s")
    err = {name: 0.0 for name in KERNEL_ENTRIES}
    bodies_phase(smi, err, library_steps(lib_path), max_sm_clock())
    _stamp(t0, 20)
    return 0


# K1's and K4's slab body alone (``--slab``, ``--slab-digests``): its shapes
# (family, A, K, T; None: the config's): the flagship (point_mass3d K=10⁴
# T=200, 313 blocks), the point_mass2d config and the 3-D quadrotor's (K=2048
# T=60, 64 blocks), and its noise modes (antithetic, OU β, injected ε)
SLAB_CASES = (("lti", 3, 10_000, 200), ("lti", 2, 3000, 50), ("quadrotor3d", None, None, None))
SLAB_MODES = ((False, 0.0, False), (True, 0.0, False), (False, 0.5, False), (False, 0.0, True))


def slab_problem(name: str, A: int | None, K: int | None, T: int | None) -> tuple:
    """(fam, x0, U, goal, λ, K) of a SLAB_CASES shape: :func:`make_problem`
    for "lti", else :func:`make_family_problem` at the config's K and T."""
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    if name == "lti":
        q = make_problem(A, K, T)
        fam = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"])
        return fam, q["x0"], q["U"], q["goal"], q["lam"], K
    cfg = _config(name)
    q = make_family_problem(name, cfg.samples, cfg.horizon)
    return q["fam"], q["x0"], q["U"], q["goal"], q["lam"], cfg.samples


def slab_digests(root: str) -> int:
    """``python3 chip_smoke.py --slab-digests ROOT``: through the package in
    the checkout at ROOT (its kernels built there), the digests of K4's S and
    of K1's S, β_b and η_b (the partials' first two columns) from the slab
    body, and of K1's S and whole partials from the per-rollout body, at
    every SLAB_CASES shape in every SLAB_MODES mode (injected: K3's dump of
    the iid stream), K1 at the problem's λ and at each of WEIGH_LAMS; one
    JSON line. Run on two checkouts in one call and compared with
    ``--same-digests``: a change to the slab body's ΔŨ_b alone leaves every
    digest equal."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    out = {}
    for case in SLAB_CASES:
        fam, x0, U, goal, lam, K = slab_problem(*case)
        T, A = U.shape
        for anti, ou, inj in SLAB_MODES:
            e_in = fs.noise_dump(fam.sigma, T, K, 7, 3, 1, False, 0.0) if inj else None

            def run(lam_softmin):
                return fs._launch_solve_partials(fam, x0, U, goal, lam_softmin, K, 7, 3, 1, anti,
                                                 ou, e_in, 1, (), width=fs.SLAB_WIDTH)

            S4 = run(None)
            key = f"{fam.name} A={A} K={K} T={T} anti={anti} ou={ou} injected={inj}"
            out[f"K4 S {key}"] = digest(S4)
            for lam_k in (lam,) + WEIGH_LAMS:
                lam_k = middle_lam(S4, fs.BLOCK) if lam_k == "mid" else lam_k
                S1, part = run(lam_k)
                out[f"K1 S beta_b eta_b {key} lambda={lam_k:.6g}"] = digest(S1, part[:, :2])
                out[f"K1 per-rollout S partials {key} lambda={lam_k:.6g}"] = digest(
                    *fs._launch_solve_partials(fam, x0, U, goal, lam_k, K, 7, 3, 1, anti, ou, e_in,
                                               1, (), width=fs.BLOCK))
    print(json.dumps({"root": root, "kind": torch.cuda.get_device_name(0), "digest": out}))
    return 0


def slab_phase(smi: str, log: str) -> dict:
    """K1's and K4's slab body on the card: ptxas's registers and spills of
    every slab instance (from the build's `log`); at each SLAB_CASES shape
    the waves of K1's and K4's grids (``fused_solve.wave_launch_counts``,
    from the runtime's residency of the instance) beside the residency model
    (``fused_solve.resident_blocks`` at the instance's ptxas registers);
    :func:`check_bodies` at the flagship and at phase 20's body cases (S of
    both bodies and of K4 bit-equal; partials against ``block_partials``,
    which sums ΔŨ_b in the slab body's order, at the problem's λ, a middle
    one and 1e9); phase 4's replay of K3's dump at WEIGH_DRAW_CASES and
    WEIGH_LAMS, now with the slab body at T=1000 too; the share of rollouts
    weighing in 32-wide blocks at the flagship, alone and in its closed
    loop; both bodies' device times at every SLAB_CASES shape (K1 at the
    problem's λ and at 1e9, K4). Returns the rows."""
    import torch

    from mppi_gpu_tpu_torch.ops import _build
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    regs = {}
    for line in ptxas_summary(log):
        if ",slab>" in line:
            print(f"[slab] ptxas {line}")
            name, rest = line.split(": ", 1)
            regs[name] = int(rest.split()[0])
    rows = {}
    for case in SLAB_CASES:
        fam, x0, U, goal, lam, K = slab_problem(*case)
        T, A = U.shape
        label = f"{fam.name} A={A} K={K} T={T}"
        row = rows[label] = {}
        for kernel, lam_k in (("solve_partials", lam), ("rollout_costs", None)):
            fs.reset_launch_counts()
            fs._launch_solve_partials(fam, x0, U, goal, lam_k, K, 7, 3, 0, False, 0.0, None, 1, (),
                                      width=fs.SLAB_WIDTH)
            key = f"{kernel}<{fam.name},A={A},inj=0,slab>"
            model = fs.resident_blocks(fs.SLAB_THREADS, regs.get(key, 255), fs.slab_bytes(T, A))
            row[f"{kernel} waves"] = fs.wave_launch_counts(kernel)
            row[f"{kernel} model blocks per SM"] = model
            print(f"[slab] {label} {kernel}: {-(-K // fs.SLAB_WIDTH)} blocks, waves "
                  f"{fs.wave_launch_counts(kernel)} (runtime residency); model at "
                  f"{regs.get(key)} registers, {fs.slab_bytes(T, A)} B: {model} blocks per SM, "
                  f"{fs.waves(-(-K // fs.SLAB_WIDTH), model)} wave(s)")
        lib = _build.load_library()
        print(f"[slab] residency read (instance → blocks per SM, SMs): "
              f"{ {k[:7]: v for k, v in lib.__dict__.get('k1_residency', {}).items()} }")
    body_cases = [("lti", 3, 10_000, 200)] + [("lti", A, 3000, 50) for A in range(1, 5)] + [
        (n, None, _config(n).samples, _config(n).horizon) for n in FAMILIES + COUPLED + LAST]
    for name, A, K, T in body_cases:
        if name == "lti":
            q = make_problem(A, K, T)
            fam = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"])
        else:
            q = make_family_problem(name, K, T)
            fam = q["fam"]
        e, shares = check_bodies(f"slab {fam.name} A={fam.action_dim}", fam, q["x0"], q["U"],
                                 q["goal"], q["lam"], K, ((False, 0.0), (True, 0.0), (False, 0.5)),
                                 q["eps"])
        print(f"[slab] bodies {fam.name} A={fam.action_dim} K={K} T={T}: S of both bodies of K1 "
              f"and K4 bit-equal (iid, antithetic, OU 0.5, injected); partials of both widths as "
              f"plain at lambda {q['lam']}, a middle one and 1e9 ({_shares_line(shares)} at width "
              f"{fs.BLOCK}); S max abs err vs plain {e:.3g}")
        del q
    for case in WEIGH_DRAW_CASES:
        A, K, T, anti, ou, k0 = case
        d = check_dump_replay(A, K, T, antithetic=anti, ou_beta=ou, k0=k0,
                              lams=(None,) + WEIGH_LAMS)
        print(f"[slab] dump A={A} K={K} T={T} anti={anti} ou={ou} k0={k0}: replay through K1 "
              f"exact at widths {d['widths']}, lambda "
              + ", ".join(f"{lam:.4g}" for lam, _ in d["replays"]))
    fam, x0, U, goal, lam, K = slab_problem(*SLAB_CASES[0])
    S = fs._launch_solve_partials(fam, x0, U, goal, None, K, 7, 3, 0, False, 0.0, None, 1, (),
                                  width=fs.SLAB_WIDTH)
    loop = closed_loop_shares("flagship", 1, width=fs.SLAB_WIDTH)
    rows["weighing"] = dict(problem=weighing_share(S, lam, fs.SLAB_WIDTH), closed_loop=loop)
    print(f"[slab] flagship: share of rollouts weighing in 32-wide blocks at lambda {lam}: "
          f"{rows['weighing']['problem']:.4g} (the check's problem); its closed loop's first, "
          f"middle and last cycle {loop['first']:.4g}, {loop['middle']:.4g}, {loop['last']:.4g}")
    for case in SLAB_CASES:
        fam, x0, U, goal, lam, K = slab_problem(*case)
        T, A = U.shape
        label = f"{fam.name} A={A} K={K} T={T}"
        for kernel, lam_k in (("K1", lam), ("K1 lambda=1e9", 1e9), ("K4", None)):
            for width in (fs.SLAB_WIDTH, fs.BLOCK):
                ms = device_ms(lambda: fs._launch_solve_partials(
                    fam, x0, U, goal, lam_k, K, 7, 3, 0, False, 0.0, None, 1, (), width=width))
                rows[label][f"{kernel} width {width} device_ms"] = ms
        row = rows[label]
        print(f"[slab] {label} device ms (slab / per-rollout): " + "; ".join(
            f"{k} {row[f'{k} width 32 device_ms']} / {row[f'{k} width 128 device_ms']}"
            for k in ("K1", "K1 lambda=1e9", "K4")) + f" ({smi})")
    return rows


def slab_only() -> int:
    """``python3 chip_smoke.py --slab``: the build (phase 2), then
    :func:`slab_phase` alone, and one JSON line of its rows."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.ops import _build

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s")
    rows = slab_phase(smi, lib_path.with_suffix(".log").read_text())
    print(json.dumps({"slab": rows, "kind": torch.cuda.get_device_name(0), "smi": smi},
                     default=str))
    print(f"[slab] done {time.perf_counter() - t0:.1f} s into the run")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.io.csvio import read_csv_columns
    from mppi_gpu_tpu_torch.ops import _build, philox
    from mppi_gpu_tpu_torch.ops import combine_tail as ct
    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import solve_tail as st

    # [1] device
    smi = _smi()
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
    # the per-step instructions of every Philox loop, from the built SASS
    sass_steps = library_steps(lib_path)
    clock_mhz = max_sm_clock()
    print(f"    SASS instructions per horizon step (Philox mode; K4 its loop; K1's per-rollout "
          f"body pass 1, pass 2 with every rollout weighing, pass 2 over fewer slots), max SM clock "
          f"{clock_mhz:.0f} MHz: " + "; ".join(f"{k} {v}" for k, v in sorted(sass_steps.items())))
    _stamp(t_start, 2)

    # [3] injected ε vs plain and oracle
    err = {name: 0.0 for name in KERNEL_ENTRIES}
    for A, K, T in ((2, 3000, 50), (3, 10_000, 200)):
        e = check_injected(A, K, T)
        print(f"[3] injected A={A} K={K} T={T}: ok vs plain and oracle; max abs err "
              + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    _stamp(t_start, 3)

    # [4] Philox mode, kernel by kernel; K3's dump bit-equal to the plain
    # stream and its replay through K1 exact, at every shape of DRAW_CASES
    # (those of WEIGH_DRAW_CASES also at each λ of WEIGH_LAMS)
    for A, K, T, anti, ou in ((3, 10_000, 200, False, 0.0), (3, 10_000, 200, True, 0.0),
                              (2, 3000, 50, False, 0.5)):
        e = check_kernels(A, K, T, antithetic=anti, ou_beta=ou)
        err["solve_partials<lti>"] = max(err["solve_partials<lti>"], e["solve_partials"])
        err["softmin_combine"] = max(err["softmin_combine"], e["softmin_combine"])
        print(f"[4] philox A={A} K={K} T={T} anti={anti} ou={ou}: K1 S err {e['solve_partials']:.3g}, "
              f"K2 dU err {e['softmin_combine']:.3g}")
    for case in DRAW_CASES:
        A, K, T, anti, ou, k0 = case
        d = check_dump_replay(A, K, T, antithetic=anti, ou_beta=ou, k0=k0, lams=(None,) + (
            WEIGH_LAMS if case in WEIGH_DRAW_CASES else ()))
        err["noise_dump"] = max(err["noise_dump"], d["noise_dump"])
        print(f"[4] dump A={A} K={K} T={T} anti={anti} ou={ou} k0={k0}: K3 words and eps bit-equal "
              f"to ops/philox.py; replay through K1 exact at widths {d['widths']} at lambda "
              + ", ".join(f"{lam:.4g} ({share:.3g} of rollouts weighing at width {fs.BLOCK})"
                          for lam, share in d["replays"]))
    _stamp(t_start, 4)

    # [5] edge cases
    check_edge_cases()
    print("[5] edges: K=1000 ok; one diverged block matches plain, weight 0; "
          "all diverged -> NaN action, ControllerDiverged")
    _stamp(t_start, 5)

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
        before = fs.launch_counts()["solve_partials"]
        k_ms, p_ms = paired_median_ms(
            lambda: ctrl.solve_auto(x, U, 1), lambda: plain.solve_auto(x, U, 1),
            reps=20, plain_reps=3 if K >= 100_000 else 5,
        )
        expect(fs.launch_counts()["solve_partials"] > before, "K1 launch count did not go up")
        a_k, a_p = _np(ctrl.solve_auto(x, U, 1).action), _np(plain.solve_auto(x, U, 1).action)
        close(f"controller {cfg_name} K={K} action", a_k, a_p, **TOL["u"])
        timing[f"{cfg_name} K={K} T={T}"] = (k_ms, p_ms)
        print(f"[6] MPPIController {cfg_name} A={cfg.action_dim} K={K} T={T}: fused {k_ms:.4f} "
              f"ms/solve, eager {p_ms:.4f} ms/solve (CUDA events, warm median; {smi})")
        prof = profile_steps(ctrl, x, U)
        print(f"[6] profile {cfg_name} K={K} T={T} (K1 width {fs.block_width(1, K, T, cfg.action_dim, 'lti')})"
              f", 50 control steps (solve + action to host): wall {prof['wall_ms']:.4f} ms/step, "
              f"device busy {prof['busy_ms']:.4f} ms, idle share {prof['idle']:.4f}, K1 "
              f"{prof['K1_us']:.2f} us, K2 {prof['K2_us']:.2f} us per step ({smi})")

    # per-kernel times at the flagship shape (point_mass3d, K=10⁴, T=200), the
    # LTI family packed once as the controller packs it
    p = make_problem(3, 10_000, 200)
    fam = fs.lti_family(p["sigma"], p["inv_s"], p["w"], p["dt"], p["lam_cost"])
    args = (fam, p["x0"], p["U"], p["goal"], p["lam"], p["K"], 7, 3, 0, False, 0.0)
    _, part = fs.family_solve_partials(*args)
    kernel_ms = {
        "solve_partials<lti>": paired_median_ms(
            lambda: fs.family_solve_partials(*args),
            lambda: fs.family_solve_partials_reference(*args), 20, 3),
        "softmin_combine": paired_median_ms(
            lambda: fs.softmin_combine(part, 1.0, 200, 3),
            lambda: fs.softmin_combine_reference(part, 1.0, 200, 3), 20, 20),
        "noise_dump": paired_median_ms(
            lambda: fs.noise_dump(p["sigma"], 200, 10_000, 7, 3, 0, False, 0.0),
            lambda: philox.sample_eps(7, 3, 0, 200, 10_000, p["sigma"]), 20, 3),
    }
    for name, (k_ms, p_ms) in kernel_ms.items():
        print(f"[6] kernel {name} A=3 K=10000 T=200: {k_ms:.4f} ms, plain {p_ms:.4f} ms ({smi})")
    dump_device_ms = device_ms(lambda: fs.noise_dump(p["sigma"], 200, 10_000, 7, 3, 0, False, 0.0))
    print(f"[6] kernel noise_dump A=3 K=10000 T=200: {dump_device_ms} ms on the device ({smi})")
    _stamp(t_start, 6)

    # [7] the main path: the closed-loop CLI, launches counted. Its host loop
    # replays one solve graph per episode: the wrappers count the warm-up of
    # that graph's capture and every dump step, op by op; a trace of each
    # config's graphed steps gives K1's and K2's records per step
    fs.reset_launch_counts()
    st.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        _cli(["-c", os.path.join("configs", "point_mass2d.yaml"), "--device", "cuda",
              "-t", os.path.join(tmp, "traj2d.csv"), "-s", os.path.join(tmp, "dump"),
              "--dump-every", "100"])
        dumps2d = sum(f.startswith("step_") for f in os.listdir(os.path.join(tmp, "dump")))
        cols2d = read_csv_columns(os.path.join(tmp, "traj2d.csv"))
        steady2d = steady_distance(cols2d, _config("point_mass2d").goal[:2])
        traj = os.path.join(tmp, "traj3d.csv")
        _cli(["-c", os.path.join("configs", "point_mass3d.yaml"), "--device", "cuda", "-t", traj])
        cols = read_csv_columns(traj)
    # the point-mass path's kernels (K4 runs on the costs-only path, phase
    # 15, and with K5 on the two-kernel sharded path, phase 19)
    launches = {k: n for k, n in fs.launch_counts().items()
                if k not in ("rollout_costs", "weighted_update")}
    launches["solve_partials<lti>"] = fs.family_launch_counts()["lti"]
    launches["solve_tail"] = st.launch_counts()["solve_tail"]
    main_widths = fs.width_launch_counts()
    main_traces = {n: config_trace(n) for n in ("point_mass2d", "point_mass3d")}
    steady = steady_distance(cols, _config("point_mass3d").goal[:3])
    updates = _config("point_mass2d").opt_iters * (1 + dumps2d) + _config("point_mass3d").opt_iters
    print(f"[7] cli closed loop: point_mass2d and point_mass3d episodes finished; point_mass3d "
          f"steady-state goal distance {steady:.4f} m (threshold {LTI_QUALITY_THRESHOLD_M}); "
          f"point_mass2d {steady2d:.4f} m (its 500 steps end short of the goal; no bar); "
          f"main-path launches {launches} (each episode's graph warm-up and point_mass2d's "
          f"{dumps2d} dump steps), K1 by block width {main_widths}; records per graphed step in a "
          f"trace of {SOLVE_TRACE_STEPS}: {_records_line(main_traces)}")
    expect(steady < LTI_QUALITY_THRESHOLD_M, f"point_mass3d steady-state {steady} m")
    for name, n in launches.items():
        expect(n > 0, f"kernel {name} was not launched on the main path")
    expect(launches["solve_partials"] == launches["softmin_combine"] == launches["solve_tail"]
           == updates and launches["noise_dump"] == dumps2d,
           f"main path: launches {launches}, want K1, K2 and K7 {updates} (two graph warm-ups, "
           f"{dumps2d} dump steps) and K3 {dumps2d}")
    # the configs' K = 3000 runs K1's slab body, every launch of it
    expect(main_widths == {fs.SLAB_WIDTH: launches["solve_partials"], fs.BLOCK: 0},
           f"K1 by block width {main_widths} on the main path")
    _stamp(t_start, 7)

    # [8] the fleet kernels: injected ε vs plain and oracle; Philox mode vs
    # plain and bit-equal to each robot's solo launch; a diverged robot
    for A, R, K, T in ((2, 4, 3000, 50), (3, 8, 10_000, 200)):
        e = check_fleet_injected(A, R, K, T)
        print(f"[8] fleet injected A={A} R={R} K={K} T={T}: ok vs plain and oracle (every "
              "robot); max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    for anti, ou in ((False, 0.0), (True, 0.5)):
        e = check_fleet_philox(3, 8, 10_000, 200, antithetic=anti, ou_beta=ou)
        err["solve_partials<lti>"] = max(err["solve_partials<lti>"], e["solve_partials"])
        err["softmin_combine"] = max(err["softmin_combine"], e["softmin_combine"])
        print(f"[8] fleet philox A=3 R=8 K=10000 T=200 anti={anti} ou={ou}: K1 S err "
              f"{e['solve_partials']:.3g}, K2 dU err {e['softmin_combine']:.3g}; every "
              "robot's (S, beta, eta, dU) bit-equal to its R=1 launch")
    check_fleet_diverged()
    print("[8] fleet edges: a diverged robot -> +inf beta, NaN action; the others finite "
          "and bit-equal to their solo solves")
    _stamp(t_start, 8)

    # [9] fleet solve timings: one fleet solve vs a loop of R solo solves
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.examples.fleet import circle_goals

    for cfg_name, R, K, T, anti in (("point_mass2d", 8, 3000, 50, False),
                                    ("point_mass3d", 8, 100_000, 200, False),
                                    ("point_mass3d", 8, 100_000, 200, True),
                                    ("point_mass3d", 64, 10_000, 200, False)):
        cfg = _config(cfg_name).replace(samples=K, horizon=T, antithetic=anti)
        fleet = BatchedMPPIController(cfg, R, goals=torch.from_numpy(circle_goals(R, cfg.state_dim)),
                                      device="cuda", rollout_backend="auto")
        expect(fleet.rollout_backend == "fused", f"auto picked {fleet.rollout_backend} on cuda")
        solos = [MPPIController(cfg, device="cuda", cost=fleet._robot_cost(r)) for r in range(R)]
        xs = 0.05 * torch.randn(R, cfg.state_dim, generator=torch.Generator().manual_seed(R)).cuda()
        Us, seeds = fleet.init_action_seqs(), fleet.init_seeds()
        seed_list = seeds.tolist()
        before = fs.launch_counts()
        res = fleet.solve_batch(xs, Us, seeds, 1)
        after = fs.launch_counts()
        for name in ("solve_partials", "softmin_combine"):
            expect(after[name] - before[name] == cfg.opt_iters,
                   f"{name}: {after[name] - before[name]} launches for one fleet solve")
        # robot r is its solo solve bit for bit at one block width; past the
        # crossover the fleet runs the per-rollout body and a solo robot the
        # slab body: S and β bit for bit, the action to rounding
        one_width = fs.block_width(R, K, T, cfg.action_dim, "lti") == fs.block_width(1, K, T, cfg.action_dim, "lti")
        for r in range(R):
            solo = solos[r].solve(xs[r], Us[r], seed_list[r], 1)
            label = f"fleet {cfg_name} R={R}: robot {r}"
            if one_width:
                expect(torch.equal(res.action[r], solo.action) and torch.equal(res.u_next[r], solo.u_next),
                       f"{label} differs from its solo solve")
            else:
                expect(torch.equal(res.info.costs[r], solo.info.costs)
                       and torch.equal(res.info.beta[r], solo.info.beta),
                       f"{label}: S or beta differs from its solo solve's")
                close(f"{label} action", _np(res.action[r]), _np(solo.action), **TOL["u"])
                close(f"{label} u_next", _np(res.u_next[r]), _np(solo.u_next), **TOL["u"])

        def loop():
            for r in range(R):
                solos[r].solve(xs[r], Us[r], seed_list[r], 1)

        f_ms, l_ms = paired_median_ms(lambda: fleet.solve_batch(xs, Us, seeds, 1), loop, 20, 5)
        label = f"{cfg_name} R={R} K={K} T={T}{' anti' if anti else ''}"
        line = (f"[9] fleet solve {label}: fused {f_ms:.4f} ms/fleet-solve, loop of {R} solo "
                f"fused solves {l_ms:.4f} ms")
        if R == 8 and K == 3000:
            eager = BatchedMPPIController(cfg, R, goals=fleet.cost.goal, device="cuda",
                                          rollout_backend="eager")
            e_ms = float(np.median(time_ms(lambda: eager.solve_batch(xs, Us, seeds, 1), 3, 1)))
            line += f", eager fleet {e_ms:.4f} ms"
        print(f"{line} (CUDA events, warm median; {smi})")

    # per-kernel fleet times at R=8, point_mass3d K=10⁴, T=200
    p = make_fleet(3, 8, 10_000, 200)
    seeds = philox.fleet_seeds(7, 8).cuda()
    fargs = fleet_args(p, seeds=seeds)
    _, fpart = fs.fleet_solve_partials(*fargs)
    seed_list = seeds.tolist()
    fleet_kernel_ms = {
        "solve_partials<lti>": paired_median_ms(
            lambda: fs.fleet_solve_partials(*fargs),
            lambda: fs.fleet_solve_partials_reference(*fargs), 20, 2),
        "softmin_combine": paired_median_ms(
            lambda: fs.fleet_softmin_combine(fpart, 1.0, 200, 3),
            lambda: fs.fleet_softmin_combine_reference(fpart, 1.0, 200, 3), 20, 10),
        # a fleet's debug dump: K3 once per robot stream
        "noise_dump": paired_median_ms(
            lambda: [fs.noise_dump(p["sigma"], 200, 10_000, s_, 3, 0, False, 0.0) for s_ in seed_list],
            lambda: [philox.sample_eps(s_, 3, 0, 200, 10_000, p["sigma"]) for s_ in seed_list], 10, 2),
    }
    for name, (k_ms, p_ms) in fleet_kernel_ms.items():
        print(f"[9] fleet kernel {name} R=8 A=3 K=10000 T=200: {k_ms:.4f} ms, plain {p_ms:.4f} ms ({smi})")
    fleet_device_ms = {
        "solve_partials<lti>": device_ms(lambda: fs.fleet_solve_partials(*fargs),
                                         name="partials_kernel"),
        "softmin_combine": device_ms(lambda: fs.fleet_softmin_combine(fpart, 1.0, 200, 3),
                                     name="softmin_combine_kernel"),
    }
    print("[9] fleet kernels R=8 A=3 K=10000 T=200 on the device: " + ", ".join(
        f"{k} {v} ms" for k, v in fleet_device_ms.items()) + f" ({smi})")
    # the fleet's dump: eight K3 launches, their records summed per call
    fleet_dump_device_ms, how = device_reading(
        lambda: [fs.noise_dump(p["sigma"], 200, 10_000, s_, 3, 0, False, 0.0) for s_ in seed_list],
        name="noise_dump_kernel", launches=len(seed_list))
    print(f"[9] fleet kernel noise_dump R=8: {fleet_dump_device_ms} ms on the device ({how}) "
          f"({smi})")
    del p, fargs, fpart
    _stamp(t_start, 9)

    # [10] the fleet path: the fleet example in both modes and a full-length
    # episode, launches counted
    from torch.profiler import ProfilerActivity

    from mppi_gpu_tpu_torch.examples import fleet as fleet_example
    from mppi_gpu_tpu_torch.runner import run_fleet_episode

    fs.reset_launch_counts()
    ct.reset_launch_counts()
    steps = 120
    for mode in ([], ["--episode"]):
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(contextlib.redirect_stdout(buf))
            if mode:  # the device episode's replays are seen only in a trace
                prof = stack.enter_context(torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            rc = fleet_example.main(["-c", os.path.join("configs", "point_mass2d.yaml"), "-n", "8",
                                     "--steps", str(steps), "--device", "cuda", *mode])
            torch.cuda.synchronize()
        out = buf.getvalue()
        print("\n".join("    " + line for line in out.strip().splitlines()))
        expect(rc == 0, f"fleet example {mode} exited {rc}")
    cfg2 = _config("point_mass2d")
    episode_records = solve_records(device_records(prof))
    del prof
    goals = circle_goals(8, cfg2.state_dim)
    fleet = BatchedMPPIController(cfg2, 8, goals=torch.from_numpy(goals), device="cuda")
    t0 = time.perf_counter()
    ep = run_fleet_episode(fleet, capture=False)
    ep_s = time.perf_counter() - t0
    fleet_launches = fs.launch_counts()
    fleet_launches["solve_partials<lti>"] = fs.family_launch_counts()["lti"]
    fleet_launches["combine_tail"] = ct.launch_counts()["combine_tail"]
    # launched from the host: the warm-up of the host loop's solve graph
    # (its last update K2 and K7, its inner ones K2'), the one warm-up cycle
    # the example's --episode runs before it captures its cycle, and every
    # cycle of the full episode, run without capture (K1 and K2' per
    # update); the --episode run's trace holds the warm-up and its replays,
    # and a trace of the fleet's graphed host loop its records per step
    n_solves = (1 + 1 + len(ep.us)) * cfg2.opt_iters
    n_epilogues = (1 + len(ep.us)) * cfg2.opt_iters + cfg2.opt_iters - 1
    fleet_trace = solve_trace("fleet R=8 point_mass2d", fleet, torch.zeros(8, cfg2.state_dim, device="cuda"),
                              fleet.init_action_seqs(), fleet.init_seeds())
    dist = np.linalg.norm(ep.xs[-1][:, :2] - goals[:, :2], axis=1)
    print(f"[10] fleet closed loop: example host loop and --episode exited 0; full episode "
          f"point_mass2d R=8 on the card without capture, {len(ep.us)} steps in {ep_s:.2f} s, mean "
          f"final goal distance {dist.mean():.4f} m (bar {FLEET_DISTANCE_BAR_M}); fleet-path launches "
          f"{fleet_launches}; K1, K2 and K2' records in the --episode run's trace {episode_records}; per "
          f"step of the graphed host loop in a trace of {SOLVE_TRACE_STEPS} {fleet_trace['records']}")
    expect(np.isfinite(ep.xs).all() and ep.xs.shape == (len(ep.us) + 1, 8, 4), "episode states")
    expect(dist.mean() < FLEET_DISTANCE_BAR_M, f"fleet mean final distance {dist.mean()} m")
    want = {"solve_partials<lti>": n_solves, "softmin_combine": 1, "combine_tail": n_epilogues}
    for name, n in want.items():
        expect(fleet_launches[name] == n,
               f"{name}: {fleet_launches[name]} launches on the fleet path, want {n} (two "
               f"warm-ups and {len(ep.us)} eager cycles)")
    want = {k: 0 if k == "softmin_combine" else (steps + 1) * cfg2.opt_iters
            for k in episode_records}
    expect(episode_records == want, f"records in the --episode run's trace {episode_records}, "
           f"want {want} ({steps + 1} cycles: K1 and K2' per update)")
    _stamp(t_start, 10)

    # [11] K1's pendulum and cart-pole instances: injected ε vs plain and
    # float64, Philox mode vs plain with exact replay, an R=8 fleet bit-equal
    # to its solo launches, diverging rollouts; K1 and K2 times, the
    # controller's solve fused vs eager
    family_ms, family_large_ms, family_fleet_ms = {}, {}, {}
    for name in FAMILIES:
        family_ms[name], family_large_ms[name], family_fleet_ms[name] = family_phase(
            "[11]", name, ((False, 0.0), (True, 0.55)), err, smi)
    check_family_diverged()
    print("[11] family edges: a pendulum block at eps=1e30 -> +inf, weight 0, the rest as plain; "
          "cartpole from thd=1e4 -> NaN S and beta, NaN action, ControllerDiverged (fused and eager); "
          "cartpole from thd=40 finite and as plain")
    _stamp(t_start, 11)

    # [12] the families' path: the CLI on configs/pendulum.yaml and
    # configs/cartpole.yaml, fused, launches counted (each episode's graph
    # warm-up and the dump steps; the graphed steps' records from a trace)
    fs.reset_launch_counts()
    ct.reset_launch_counts()
    steady, avg_ms, steps, dumps = {}, {}, {}, dict.fromkeys(FAMILIES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name in FAMILIES:
            traj = os.path.join(tmp, f"{name}.csv")
            dump = ["-s", os.path.join(tmp, "dump"), "--dump-every", "100"] if name == "cartpole" else []
            out = _cli(["-c", os.path.join("configs", f"{name}.yaml"), "--device", "cuda",
                        "--rollout-backend", "fused", "-t", traj, *dump])
            if dump:
                dumps[name] = sum(f.startswith("step_") for f in os.listdir(os.path.join(tmp, "dump")))
            steps[name] = int(re.search(r"episode finished: (\d+) control steps", out).group(1))
            avg_ms[name] = float(re.search(r"Average controller execution time: ([\d.]+) ms", out).group(1))
            idx = FAMILY_ANGLE[name]
            th = np.concatenate([[FAMILY_INIT_THETA[name]], read_csv_columns(traj)[f"x[{idx}]"]])
            d = np.abs(np.arctan2(np.sin(th), np.cos(th)))
            steady[name] = float(d[-max(len(d) // 4, 1):].mean())
    family_launches, family_k2e = fs.launch_counts(), ct.launch_counts()["combine_tail"]
    by_family = fs.family_launch_counts()
    family_traces = {n: config_trace(n) for n in FAMILIES}
    print(f"[12] cli closed loops (fused): pendulum {steps['pendulum']} steps x 2 iterations, steady "
          f"{steady['pendulum']:.4f} rad from upright (threshold {FAMILY_QUALITY_THRESHOLD_RAD['pendulum']}), "
          f"average controller execution time {avg_ms['pendulum']:.3f} ms; cartpole {steps['cartpole']} "
          f"steps, steady {steady['cartpole']:.4f} rad (threshold {FAMILY_QUALITY_THRESHOLD_RAD['cartpole']}), "
          f"average {avg_ms['cartpole']:.3f} ms ({smi}); family-path launches {family_launches}, "
          f"K1 by family {by_family} (graph warm-ups and {dumps['cartpole']} cartpole dump steps); "
          f"records per graphed step in a trace of {SOLVE_TRACE_STEPS}: {_records_line(family_traces)}")
    for name in FAMILIES:
        expect(steady[name] < FAMILY_QUALITY_THRESHOLD_RAD[name], f"{name} steady-state {steady[name]} rad")
    # one graph warm-up per episode and each dump step, opt_iters updates each
    expect(by_family == dict(dict.fromkeys(by_family, 0), **{
        n: _config(n).opt_iters * (1 + dumps[n]) for n in FAMILIES}),
        f"K1 launches by family {by_family}, {dumps} dump steps")
    expect(family_launches["softmin_combine"] + family_k2e == family_launches["solve_partials"],
           f"K2 and K2' launches ({family_k2e}) add up to other than K1's on the family path")
    expect(family_launches["noise_dump"] == dumps["cartpole"],
           f"K3: {family_launches['noise_dump']} launches, {dumps['cartpole']} dumps")
    launches.update({f"solve_partials<{n}>": by_family[n] for n in FAMILIES})
    _stamp(t_start, 12)

    # [13] K1's unicycle, quadrotor and arm instances (A=2; S = 3, 6, 4 with
    # per-robot goals of that length): as phase 11, the arm also under its
    # config's OU noise, plus a diverging rollout for each
    print("[13] ptxas " + "; ".join(line for line in ptxas_summary(
        lib_path.with_suffix(".log").read_text()) if re.search(r"(unicycle|quadrotor|arm),", line)))
    n_sqrt, n_cpu = rsqrt_probe()
    print(f"[13] torch.rsqrt on the card gives other values than 1/sqrt for {n_sqrt} of 2^20 "
          f"floats, and than the CPU's torch.rsqrt for {n_cpu}: it is rsqrtf, as in K1's unicycle")
    expect(n_sqrt > 0, "torch.rsqrt on the card divides: K1's unicycle cost takes rsqrtf")
    for name in COUPLED:
        cfg = _config(name)
        modes = ((False, 0.0), (True, 0.0)) + (((False, cfg.noise_beta),) if cfg.noise_beta else ())
        family_ms[name], family_large_ms[name], family_fleet_ms[name] = family_phase(
            "[13]", name, modes, err, smi)
        print(f"[13] {name} diverging rollouts: {check_coupled_diverged(name)}")
    _stamp(t_start, 13)

    # [14] the coupled families' path: the CLI on configs/unicycle.yaml,
    # quadrotor.yaml and arm.yaml (opt-iters 2, OU 0.8, dumps), fused, full
    # episodes, launches counted as in [12]
    fs.reset_launch_counts()
    ct.reset_launch_counts()
    steady, avg_ms, steps, dumps = {}, {}, {}, dict.fromkeys(COUPLED, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name in COUPLED:
            traj = os.path.join(tmp, f"{name}.csv")
            dump = ["-s", os.path.join(tmp, "dump"), "--dump-every", "100"] if name == "arm" else []
            out = _cli(["-c", os.path.join("configs", f"{name}.yaml"), "--device", "cuda",
                        "--rollout-backend", "fused", "-t", traj, *dump])
            if dump:
                dumps[name] = sum(f.startswith("step_") for f in os.listdir(os.path.join(tmp, "dump")))
            steps[name] = int(re.search(r"episode finished: (\d+) control steps", out).group(1))
            avg_ms[name] = float(re.search(r"Average controller execution time: ([\d.]+) ms", out).group(1))
            cols = read_csv_columns(traj)
            start = FAMILY_START[name]
            xs = np.stack([np.concatenate([[start[i]], cols[f"x[{i}]"]]) for i in range(len(start))], 1)
            d = coupled_distance(name, xs)
            steady[name] = float(d[-max(len(d) // 4, 1):].mean())
    coupled_launches, coupled_k2e = fs.launch_counts(), ct.launch_counts()["combine_tail"]
    by_family = fs.family_launch_counts()
    coupled_traces = {n: config_trace(n) for n in COUPLED}
    print("[14] cli closed loops (fused, full episodes): " + "; ".join(
        f"{n} {steps[n]} steps x {_config(n).opt_iters} iteration(s), steady {steady[n]:.4f} m "
        f"{'(end effector) ' if n == 'arm' else ''}from the goal (threshold "
        f"{COUPLED_QUALITY_THRESHOLD_M[n]}), average controller execution time {avg_ms[n]:.3f} ms"
        for n in COUPLED) + f" ({smi}); coupled-path launches {coupled_launches}, K1 by family "
        f"{by_family} (graph warm-ups and {dumps['arm']} arm dump steps); records per graphed "
        f"step in a trace of {SOLVE_TRACE_STEPS}: {_records_line(coupled_traces)}")
    for name in COUPLED:
        expect(steady[name] < COUPLED_QUALITY_THRESHOLD_M[name], f"{name} steady-state {steady[name]} m")
    expect(by_family == dict(dict.fromkeys(by_family, 0), **{
        n: _config(n).opt_iters * (1 + dumps[n]) for n in COUPLED}),
        f"K1 launches by family {by_family}, {dumps} dump steps")
    expect(coupled_launches["softmin_combine"] + coupled_k2e == coupled_launches["solve_partials"],
           f"K2 and K2' launches ({coupled_k2e}) add up to other than K1's on the coupled path")
    expect(coupled_launches["noise_dump"] == dumps["arm"],
           f"K3: {coupled_launches['noise_dump']} launches, {dumps['arm']} dumps")
    launches.update({f"solve_partials<{n}>": by_family[n] for n in COUPLED})
    _stamp(t_start, 14)

    # [15] K4, the costs-only sweep, for every family instance at K=10⁵,
    # T=200: the sweep itself (launches counted), then its S equal to K1's,
    # the plain version and K4 beside K1 on the card
    instances = [("lti", A) for A in range(1, 5)] + [(n, None) for n in FAMILIES + COUPLED + LAST]
    problems = {}
    for name, A in instances:
        if name == "lti":
            q = make_problem(A, 100_000, 200)
            fam = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"])
            problems[(name, A)] = (fam, q["x0"], q["U"], q["goal"])
        else:
            q = make_family_problem(name, 100_000, 200)
            problems[(name, A)] = (q["fam"], q["x0"], q["U"], q["goal"])
    fs.reset_launch_counts()
    for fam, x0, U, goal in problems.values():
        fs.fused_rollout_costs(fam, x0, U, goal, 100_000, 7, 3, 0, False, 0.0)
    torch.cuda.synchronize()
    k4_launches = fs.launch_counts()["rollout_costs"]
    k4_by_family = fs.family_launch_counts("rollout_costs")
    expect(k4_launches == len(instances) and all(
        k4_by_family[fam.name] > 0 for fam, *_ in problems.values()), f"K4 launches {k4_by_family}")
    launches["rollout_costs"] = k4_launches
    floor = {}
    for name, A in instances:
        modes = ((False, 0.0), (True, 0.0)) + (
            ((False, 0.8),) if name == "arm" else ((False, 0.5),) if name == "quadrotor3d" else ())
        for anti, ou in modes:
            e = check_costs_only(name, 100_000, 200, A=A, antithetic=anti, ou_beta=ou)
            err["rollout_costs"] = max(err["rollout_costs"], e["err"])
        fam, x0, U, goal = problems[(name, A)]
        lam = e["lam"]
        k4_ms, k1_ms = paired_median_ms(
            lambda: fs.fused_rollout_costs(fam, x0, U, goal, 100_000, 7, 3, 0, False, 0.0),
            lambda: fs.family_solve_partials(fam, x0, U, goal, lam, 100_000, 7, 3, 0, False, 0.0),
            20, 20)
        label = f"{fam.name} A={fam.action_dim}"
        floor[label] = dict(ms=k4_ms, k1_ms=k1_ms, ratio=k4_ms / k1_ms,
                            bound_ms=solve_bound(sass_steps, fam, 100_000, 200, clock_mhz, pass2=False)[0])
        if name in LAST:  # this PR's instances: K4 beside its plain version too
            floor[label]["plain_ms"] = paired_median_ms(
                lambda: fs.fused_rollout_costs(fam, x0, U, goal, 100_000, 7, 3, 0, False, 0.0),
                lambda: fs.rollout_costs_reference(fam, x0, U, goal, 100_000, 7, 3, 0, False, 0.0),
                5, 2)[1]
        print(f"[15] costs-only {label} K=100000 T=200: S bit-equal to K1's (iid, antithetic"
              f"{''.join(f', OU {ou}' for _, ou in modes if ou)}; fleet robots equal to their R=1 "
              f"launches), "
              f"max abs err vs plain {e['err']:.3g}; K4 {k4_ms:.4f} ms, K1 {k1_ms:.4f} ms, floor/K1 "
              f"{k4_ms / k1_ms:.3f}; bound {floor[label]['bound_ms']:.4f} ms"
              + (f"; plain K4 {floor[label]['plain_ms']:.4f} ms" if name in LAST else "")
              + f" ({smi})")
    fam, x0, U, goal = problems[("lti", 3)]
    floor_ms = paired_median_ms(
        lambda: fs.fused_rollout_costs(fam, x0, U, goal, 100_000, 7, 3, 0, False, 0.0),
        lambda: fs.rollout_costs_reference(fam, x0, U, goal, 100_000, 7, 3, 0, False, 0.0), 20, 3)
    print(f"[15] kernel rollout_costs lti A=3 K=100000 T=200: {floor_ms[0]:.4f} ms, plain "
          f"{floor_ms[1]:.4f} ms ({smi}); main-path launches {k4_by_family}")
    lti_large_ms = paired_median_ms(
        lambda: fs.family_solve_partials(fam, x0, U, goal, 1.0, 100_000, 7, 3, 0, False, 0.0),
        lambda: fs.family_solve_partials_reference(fam, x0, U, goal, 1.0, 100_000, 7, 3, 0, False,
                                                   0.0), 20, 3)
    print(f"[15] kernel solve_partials<lti> A=3 K=100000 T=200: {lti_large_ms[0]:.4f} ms, plain "
          f"{lti_large_ms[1]:.4f} ms ({smi})")
    _stamp(t_start, 15)

    # [16] K1's LtiObstacle<2>, LtiObstacle<3> and Quadrotor3D instances (the
    # obstacles counted from the pack at run time; 13 states at A=4): as
    # phase 13, each also under OU 0.5 (the obstacle2d config's own);
    # diverging rollouts; the controller's pack after a cost reassignment
    print("[16] ptxas " + "; ".join(line for line in ptxas_summary(
        lib_path.with_suffix(".log").read_text()) if re.search(r"(lti-obstacle|quadrotor3d),", line)))
    for name in LAST:
        family_ms[name], family_large_ms[name], family_fleet_ms[name] = family_phase(
            "[16]", name, ((False, 0.0), (True, 0.0), (False, 0.5)), err, smi)
        print(f"[16] {name} diverging rollouts: {check_coupled_diverged(name)}")
    print(f"[16] cost reassignment: {check_reassigned_cost()}")
    print(f"[16] model reassignment: {check_reassigned_dynamics()}")
    _stamp(t_start, 16)

    # [17] the last families' path, fused, launches counted from 0 before each
    # run and read after it (each run's solve-graph warm-up), the graphed
    # steps' records from a trace: the CLI on configs/quadrotor3d.yaml (opt-iters
    # 2) for a full episode; the obstacle quality episode (obstacle3d, A=3)
    # and the ported obstacle example (obstacle2d, A=2) with its own exit
    # criterion; the ported flight example, which assigns ctrl.cost every step
    from mppi_gpu_tpu_torch.examples import obstacle_nav, quadrotor3d_flight

    fs.reset_launch_counts()
    ct.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "quadrotor3d.csv")
        out = _cli(["-c", os.path.join("configs", "quadrotor3d.yaml"), "--device", "cuda",
                    "--rollout-backend", "fused", "-t", traj])
        cols = read_csv_columns(traj)
    q3d_launches, q3d_by_family = fs.launch_counts(), fs.family_launch_counts()
    q3d_k2e = ct.launch_counts()["combine_tail"]
    q3d_steps = int(re.search(r"episode finished: (\d+) control steps", out).group(1))
    q3d_ms = float(re.search(r"Average controller execution time: ([\d.]+) ms", out).group(1))
    cfg = _config("quadrotor3d")
    start = FAMILY_START["quadrotor3d"]
    xs = np.stack([np.concatenate([[start[i]], cols[f"x[{i}]"]]) for i in range(3)], 1)
    d = np.linalg.norm(xs - np.asarray(cfg.goal[:3]), axis=1)
    q3d_steady = float(d[-max(len(d) // 4, 1):].mean())
    print(f"[17] cli closed loop configs/quadrotor3d.yaml (fused, full episode): {q3d_steps} steps x "
          f"{cfg.opt_iters} iterations, steady {q3d_steady:.4f} m from the goal (threshold "
          f"{LAST_QUALITY_THRESHOLD_M['quadrotor3d']}), average controller execution time "
          f"{q3d_ms:.3f} ms ({smi}); launches {q3d_launches}, K1 by family {q3d_by_family}")
    expect(q3d_steady < LAST_QUALITY_THRESHOLD_M["quadrotor3d"], f"quadrotor3d steady-state {q3d_steady} m")
    # the warm-up of the episode's solve graph; the replays' records from a trace
    expect(q3d_by_family == dict(dict.fromkeys(q3d_by_family, 0), quadrotor3d=cfg.opt_iters)
           and q3d_launches["softmin_combine"] + q3d_k2e == q3d_launches["solve_partials"],
           f"quadrotor3d path: launches {q3d_launches}, K1 by family {q3d_by_family}")
    launches["solve_partials<quadrotor3d>"] = q3d_by_family["quadrotor3d"]
    last_traces = {n: config_trace(n) for n in ("quadrotor3d", "obstacle3d")}
    print(f"[17] records per graphed step in a trace of {SOLVE_TRACE_STEPS}: "
          f"{_records_line(last_traces)}")

    launches["solve_partials<lti-obstacle,A=3>"] = obstacle_quality_episodes(smi)

    for tag, example, argv in (
            ("obstacle2d", obstacle_nav, ["--device", "cuda", "--rollout-backend", "fused"]),
            ("quadrotor3d", quadrotor3d_flight, ["--device", "cuda", "--rollout-backend", "fused"])):
        fs.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = example.main(argv)
        print("\n".join("    " + line for line in buf.getvalue().strip().splitlines()))
        by_family = fs.family_launch_counts()
        fam_name = "lti-obstacle" if tag == "obstacle2d" else "quadrotor3d"
        print(f"[17] example {example.__name__.rsplit('.', 1)[1]} (fused): exit {rc}; K1 by family "
              f"{by_family}")
        expect(rc == 0, f"example {example.__name__} exited {rc}")
        expect(by_family[fam_name] > 0 and sum(by_family.values()) == by_family[fam_name],
               f"example {example.__name__}: K1 by family {by_family}")
        if tag == "obstacle2d":
            launches["solve_partials<lti-obstacle,A=2>"] = by_family[fam_name]
    _stamp(t_start, 17)

    # [18] K5, the weighted update (TPU kernel #7): injected ε vs plain and
    # float64; Philox mode vs plain on K3's dump of the same stream; times
    wu_shapes = {}
    for A, K, T, anti, ou, k0 in DRAW_CASES:
        wu_shapes.setdefault((A, K, T), []).append((anti, ou, k0))
    wu_shapes[(3, 10_000, 200)] += [(True, 0.5, 0)]
    for (A, K, T), modes in wu_shapes.items():
        e = check_weighted_update(A, K, T, modes=modes)
        err["weighted_update"] = max(err["weighted_update"], e)
        print(f"[18] K5 A={A} K={K} T={T}: injected and philox (anti, ou, k0) {modes} ok vs plain "
              "and float64 (philox on K3's dump of the same stream), weights uniform, zero and "
              f"one-hot at K-1 (each entry within 1e-5 of sum |w eps|); max abs err vs plain {e:.3g}")
    wu = {}
    for K in (10_000, 100_000):
        q = make_problem(3, K, 200)
        w = torch.rand(K, generator=torch.Generator().manual_seed(K)).cuda()
        w /= w.sum()
        k_ms, p_ms = paired_median_ms(
            lambda: fs.weighted_update(q["sigma"], w, 200, K, 7, 3, 0, False, 0.0),
            lambda: fs.weighted_update_reference(w, philox.sample_eps(7, 3, 0, 200, K, q["sigma"])),
            20, 3)
        d_ms = device_ms(lambda: fs.weighted_update(q["sigma"], w, 200, K, 7, 3, 0, False, 0.0),
                         name="weighted_update_kernel")
        b_ms, b_by = weighted_update_bound(K, 200, 3, clock_mhz)
        wu[K] = (k_ms, p_ms, b_ms, b_by, d_ms)
        print(f"[18] kernel weighted_update A=3 K={K} T=200 (K5 + K2's fold): {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms; K5 alone {d_ms} ms on the device; bound {b_ms:.4f} ms ({b_by}) ({smi})")
        del q, w
    _stamp(t_start, 18)

    # [19] the sharded solve on the card: a world of one NCCL rank and four
    # virtual ranks (each at its draw offset, combined by the collective
    # path's combine), both branches, against the solo solve; times; the
    # sharded fleet; the sharded closed loops, launches counted
    with nccl_world_of_one():
        sharded_ms, launches["weighted_update"] = sharded_phase(smi, cols2d)
    _stamp(t_start, 19)

    # [20] K1's and K4's two bodies (:func:`bodies_phase`)
    sweep = bodies_phase(smi, err, sass_steps, clock_mhz)
    _stamp(t_start, 20)

    # [21] the on-device episode: K1's step by pointer; run_episode_jit and
    # run_fleet_episode as a replayed CUDA graph of one control cycle for
    # every config and an R=8 fleet of every family; a reassigned cost;
    # checkpoint/resume and the CLI's new flags on the card
    episode = episode_phase(smi)
    _stamp(t_start, 21)

    # [22] a family registered from user code: the bicycle's own library,
    # its K1 and K4 against their plain versions, times, the example
    bicycle = bicycle_phase(smi, err, clock_mhz, lib_path.with_suffix(".log").read_text())
    _stamp(t_start, 22)

    # [23] the planar quadrotor's waypoint tour, fused, the pack kept
    waypoints_phase(smi)
    _stamp(t_start, 23)

    # [24] the learned models on the card
    learned_phase(smi)
    _stamp(t_start, 24)

    # [25] the host plants: the CLI's closed loop on the native C++ twin and
    # real MuJoCo beside the torch world, resume, the miss harness
    plants_phase(smi)
    _stamp(t_start, 25)

    # [26] the graphs: K5's step by pointer; the host loop's solve as a
    # replayed CUDA graph against the op-by-op solve, its ms per step; the
    # sharded device episode, its collectives captured
    with nccl_world_of_one():
        graphs = graphs_phase(smi)
        _stamp(t_start, 26)

        # [27] K8 and K9: the one-pass sharded combine between its
        # all-reduces and the sharded tail with the world's step, against
        # their plain versions and the torch combine, K7 and K6
        sharded = sharded_combine_phase(smi)
    _stamp(t_start, 27)

    # the kernels JSON line: times at each kernel's shape, beside its bound
    k12 = ", ".join(f"{PALLAS}:{line}" for line in (2342, 2686, 2287, 3121, 2973, 3078))
    k_fam = ", ".join(f"{PALLAS}:{line}" for line in (2342, 2287, 3121, 2973))
    replaces = {
        "solve_partials<lti>": f"{k12} (family {PALLAS}:490)",
        "solve_partials<pendulum>": f"{k_fam} (family {PALLAS}:648)",
        "solve_partials<cartpole>": f"{k_fam} (family {PALLAS}:739)",
        "solve_partials<unicycle>": f"{k12} (family {PALLAS}:1152)",
        "solve_partials<quadrotor>": f"{k12} (family {PALLAS}:980)",
        "solve_partials<arm>": f"{k12} (family {PALLAS}:1318)",
        "solve_partials<lti-obstacle,A=2>": f"{k12} (family {PALLAS}:805)",
        "solve_partials<lti-obstacle,A=3>": f"{k12} (family {PALLAS}:805)",
        "solve_partials<quadrotor3d>": f"{k12} (family {PALLAS}:1468)",
        "softmin_combine": k12,
        "noise_dump": f"{PALLAS}:2140, {PALLAS}:2872",
        "rollout_costs": f"{PALLAS}:1952, {PALLAS}:2813",
        "weighted_update": f"{PALLAS}:1966",
    }
    q = make_problem(3, 10_000, 200)
    lti3 = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"])
    nb_main = -(-10_000 // fs.block_width(1, 10_000, 200, 3, "lti"))  # K2's rows as K1 writes them
    nb_fleet = -(-10_000 // fs.block_width(8, 10_000, 200, 3, "lti"))
    bounds = {
        "solve_partials<lti>": solve_bound(sass_steps, lti3, 10_000, 200, clock_mhz),
        "softmin_combine": combine_bound(nb_main, 200, 3),
        "noise_dump": noise_dump_bound(10_000, 200, 3, clock_mhz),
        "rollout_costs": solve_bound(sass_steps, problems[("lti", 3)][0], 100_000, 200, clock_mhz,
                                     pass2=False),
        "weighted_update": wu[10_000][2:4],
    }
    # the fleet kernels at R=8 of phase 9's shape (point_mass3d K=10⁴, T=200)
    fleet_bounds = {
        "solve_partials<lti>": solve_bound(sass_steps, lti3, 10_000, 200, clock_mhz, R=8)[0],
        "softmin_combine": combine_bound(nb_fleet, 200, 3, R=8)[0],
        "noise_dump": 8 * bounds["noise_dump"][0],
    }
    instance_of = {}  # K1 entry -> its family instance's config name
    for name in FAMILIES + COUPLED + LAST:
        cfg = _config(name)
        fam = make_family_problem(name, 128, 8)["fam"]
        key = entry_key(fam)
        instance_of[key] = name
        bounds[key] = solve_bound(sass_steps, fam, cfg.samples, cfg.horizon, clock_mhz)
        fleet_bounds[key] = solve_bound(sass_steps, fam, cfg.samples, cfg.horizon, clock_mhz, R=8)[0]
    entries = []
    for name in KERNEL_ENTRIES:
        if name in bicycle:  # the family registered from user code (phase 22)
            entries.append(bicycle_entry(name, bicycle[name], err[name]))
            continue
        if name == "solve_tail":  # K7, checked and timed in phase 21
            entries.append(tail_entry(episode["tail"], launches[name]))
            continue
        if name == "combine_tail":  # K2', checked and timed in phase 21
            expect(episode["k2e_launches"] > 0, "K2' was not launched in phase 21's episodes")
            entries.append(epilogue_entry(episode["epi"], episode["k2e_launches"]))
            continue
        b_ms, b_by = bounds[name]
        entry = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
                 "launches": launches[name], "max_abs_err": err[name], "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None}
        fam = instance_of.get(name)
        if name.startswith("solve_partials<"):  # which body ran: K1's block width at each shape
            f_name = name[len("solve_partials<"):-1].split(",")[0]
            if fam is None:  # the point mass at the flagship shape
                A_f, K_f, T_f = 3, 10_000, 200
            else:
                A_f, K_f, T_f = _config(fam).action_dim, _config(fam).samples, _config(fam).horizon
            entry.update(width=fs.block_width(1, K_f, T_f, A_f, f_name),
                         large_width=fs.block_width(1, 100_000, 200, A_f, f_name),
                         fleet_width=fs.block_width(8, K_f, T_f, A_f, f_name),
                         bodies={k: v for k, v in sweep["bodies"].items() if k.startswith(f"{f_name} ")},
                         slab_max_rollouts=fs.SLAB_MAX_ROLLOUTS[f_name],
                         crossover=sweep["crossover"].get(f_name))
        if fam is not None:
            (ms, plain_ms), (lms, lplain_ms) = family_ms[fam][name], family_large_ms[fam][name]
            fms, fplain_ms = family_fleet_ms[fam][name]
            shape = f"K={_config(fam).samples} T={_config(fam).horizon}"
            entry.update(ms=ms, plain_ms=plain_ms, shape=shape,
                         large_ms=lms, large_plain_ms=lplain_ms, large_shape="K=100000 T=200",
                         large_bound_ms=solve_bound(
                             sass_steps, make_family_problem(fam, 128, 8)["fam"], 100_000, 200,
                             clock_mhz)[0],
                         fleet_ms=fms, fleet_plain_ms=fplain_ms, fleet_bound_ms=fleet_bounds[name],
                         fleet_shape=f"R=8 {shape}")
        elif name == "rollout_costs":
            entry.update(ms=floor_ms[0], plain_ms=floor_ms[1], shape="lti A=3 K=100000 T=200",
                         per_family=floor)
        elif name == "weighted_update":
            entry.update(ms=wu[10_000][0], plain_ms=wu[10_000][1], device_ms=wu[10_000][4],
                         shape="A=3 K=10000 T=200, K5 + K2's fold", large_ms=wu[100_000][0],
                         large_plain_ms=wu[100_000][1], large_bound_ms=wu[100_000][2],
                         large_device_ms=wu[100_000][4],
                         large_shape="A=3 K=100000 T=200", sharded_solve_ms=sharded_ms,
                         step_pointer_device_ms=graphs["k5"],
                         softmin_form={k: v for k, v in sharded["softmin_times"].items()
                                       if k.startswith("K5 ")})
        else:
            entry.update(ms=kernel_ms[name][0], plain_ms=kernel_ms[name][1], shape="A=3 K=10000 T=200",
                         fleet_launches=fleet_launches[name], fleet_ms=fleet_kernel_ms[name][0],
                         fleet_plain_ms=fleet_kernel_ms[name][1], fleet_bound_ms=fleet_bounds[name],
                         fleet_shape="R=8 A=3 K=10000 T=200")
            if name in fleet_device_ms:
                entry["fleet_device_ms"] = fleet_device_ms[name]
            if name == "solve_partials<lti>":
                entry.update(large_ms=lti_large_ms[0], large_plain_ms=lti_large_ms[1],
                             large_shape="A=3 K=100000 T=200", large_bound_ms=solve_bound(
                                 sass_steps, problems[("lti", 3)][0], 100_000, 200, clock_mhz)[0],
                             launches_by_width=main_widths)
            if name == "softmin_combine":
                entry.update(nb=nb_main, fleet_nb=nb_fleet)
            if name == "noise_dump":
                entry.update(device_ms=dump_device_ms, fleet_device_ms=fleet_dump_device_ms)
            if not name.startswith("solve_partials<"):
                entry.update(family_path_launches=family_launches[name],
                             coupled_path_launches=coupled_launches[name],
                             quadrotor3d_path_launches=q3d_launches[name])
        entries.append(entry)
    entries += world_entries(episode)
    path = graphs["launches"]  # the sharded paths of phase 26, counted from 0 around each
    sharded_launches = {k: path["onepass"].get(k, 0) + path["two_kernel"].get(k, 0)
                        for k in ("sharded_scale", "sharded_tail", "softmin_min", "softmin_eta")}
    for name, n in sharded_launches.items():
        expect(n > 0, f"kernel {name} was not launched on the sharded paths")
    entries += sharded_entries(sharded, sharded_launches)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def time_commit(root: str) -> int:
    """``python3 chip_smoke.py --time-commit ROOT``: through the public
    wrappers of the package in the checkout at ROOT (its kernels built
    there), K1 and K2 at the main path's shapes (point_mass3d K=10⁴ T=200
    and every family instance's config) and K1 and K4 of every family
    instance at K=10⁵, T=200; K5 (``weighted_update``, with K2's fold) and
    K3 (``noise_dump``) at A=3 T=200 K=10⁴ and 10⁵ and at the point_mass2d
    shape A=2 K=3000 T=50, iid, antithetic and OU 0.5 (K5 also injected),
    and K3 as the R=8 fleet's dump (eight streams at A=3 K=10⁴ T=200); K1's
    per-rollout body at LTI A=3 K=10⁵ under antithetic, OU 0.5 and with
    every rollout weighing, in the R=8 flagship fleet, and the bicycle's K1
    and K4 from its own library at K=10⁵ (``per_rollout``, each with the
    share of rollouts that weigh): CUDA events around a call (warm median
    of 20) and the device time alone (K5 and K3 by their kernels' records);
    where the package's K1 reads the control step by pointer, K1 so too at
    the main path's shapes (``K1_step_ptr``); where the package has K2'
    (``ops/combine_tail.py``), K2' at K2's shapes in an inner iteration's
    form (``K2e``); and the digests of K2's and K2''s outputs on the fixed
    partials of :func:`combine_digests` (``digest``); where the package has
    K8 and K9 (``ops/sharded_combine.py``), their times
    (:func:`sharded_commit_times`, ``sharded``) and the digests of their
    outputs (:func:`sharded_digests`), and of K10's and K11's where it has
    them (:func:`softmin_digests`); K7 and K6 at their paths' shapes
    (:func:`tail_world_commit_times`, ``world_tail``) and the digests of
    their outputs over every case of :func:`check_solve_tail` and
    :func:`check_world_step` (each held to its plain version there too); one
    JSON line. Run on this checkout and on an earlier one in turns within one
    call, it compares two commits on one card (``--same-digests`` their
    outputs)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import importlib.util

    from mppi_gpu_tpu_torch.ops import fused_solve as fs
    from mppi_gpu_tpu_torch.ops import philox

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    k2e = importlib.util.find_spec("mppi_gpu_tpu_torch.ops.combine_tail") is not None
    if k2e:
        from mppi_gpu_tpu_torch.controller import CYCLE, ITERATE
        from mppi_gpu_tpu_torch.envs import make_world
        from mppi_gpu_tpu_torch.ops import combine_tail as ct
        from mppi_gpu_tpu_torch.ops import world_step as ws

    def times(fn, name: str = "_kernel", launches: int = 1) -> dict:
        return dict(ms=float(np.median(time_ms(fn, 20))),
                    device_ms=device_ms(fn, name=name, launches=launches))

    main_path, large = {}, {}
    cases = [("lti", A, None, 100_000, 200) for A in range(1, 5)] + [("lti", 3, "point_mass3d", 10_000, 200)] + [
        (n, None, n, 100_000, 200) for n in FAMILIES + COUPLED + LAST] + [
        (n, None, n, _config(n).samples, _config(n).horizon) for n in FAMILIES + COUPLED + LAST]
    for name, A, label, K, T in cases:
        q = make_problem(A, 128, T) if name == "lti" else make_family_problem(name, 128, T)
        fam = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"]) if name == "lti" else q["fam"]
        args = (fam, q["x0"], q["U"], q["goal"])
        key = f"{label or fam.name} A={fam.action_dim} K={K} T={T}"
        k1 = times(lambda: fs.family_solve_partials(*args, q["lam"], K, 7, 3, 0, False, 0.0))
        if K == 100_000:
            large[key] = dict(K1=k1, K4=times(lambda: fs.fused_rollout_costs(*args, K, 7, 3, 0, False, 0.0)))
        else:
            _, part = fs.family_solve_partials(*args, q["lam"], K, 7, 3, 0, False, 0.0)
            main_path[key] = dict(K1=k1, nb=part.shape[0], K2=times(
                lambda: fs.softmin_combine(part, q["lam"], T, fam.action_dim)))
            if k2e:  # K2' at K2's shapes: an inner iteration's tail (u_seq), and the
                # cycle's with the config's world step where its world has a K6 body
                tickets = torch.zeros(2, dtype=torch.int32, device="cuda")
                max_a = torch.full((fam.action_dim,), 1e9, device="cuda")
                main_path[key]["K2e"] = times(lambda: ct.combine_tail(
                    part, q["lam"], q["U"], max_a, True, ITERATE, tickets))
                world = make_world(_episode_config("flagship" if label == "point_mass3d"
                                                   else label), device="cuda")
                if ws.has_kernel(world) and ws.WORLDS[world._kernel_kind][2] == fam.action_dim:
                    adv, U_c, step = _episode_buffers(world, world.reset(None), q["U"], 4096,
                                                      "cuda")
                    main_path[key]["K2e_cycle"] = times(lambda: ct.combine_tail(
                        part, q["lam"], U_c, max_a, False, CYCLE, tickets, into=U_c, step=step,
                        advance=adv), "combine_tail_kernel")
            if hasattr(fs, "_step_tensors"):  # a package whose K1 reads the step by pointer
                step = torch.tensor(3, dtype=torch.int64, device="cuda")
                main_path[key]["K1_step_ptr"] = times(
                    lambda: fs.family_solve_partials(*args, q["lam"], K, 7, step, 0, False, 0.0))
    draws = {}
    for A, K, T in ((3, 10_000, 200), (3, 100_000, 200), (2, 3000, 50)):
        sigma = torch.full((A,), 0.25, device="cuda")
        w = torch.rand(K, generator=torch.Generator().manual_seed(K)).cuda()
        w /= w.sum()
        for mode, (anti, ou) in (("iid", (False, 0.0)), ("antithetic", (True, 0.0)),
                                 ("ou0.5", (False, 0.5))):
            draws[f"A={A} K={K} T={T} {mode}"] = dict(
                K5=times(lambda: fs.weighted_update(sigma, w, T, K, 7, 3, 0, anti, ou),
                         "weighted_update_kernel"),
                K3=times(lambda: fs.noise_dump(sigma, T, K, 7, 3, 0, anti, ou), "noise_dump_kernel"))
        eps = 0.25 * torch.randn(T, K, A, generator=torch.Generator().manual_seed(0)).cuda()
        draws[f"A={A} K={K} T={T} injected"] = dict(K5=times(
            lambda: fs.weighted_update(sigma, w, T, K, 0, 0, 0, False, 0.0, eps=eps),
            "weighted_update_kernel"))
        del eps
    sigma, seeds = torch.full((3,), 0.25, device="cuda"), range(8)
    draws["fleet R=8 A=3 K=10000 T=200 iid"] = dict(K3=times(
        lambda: [fs.noise_dump(sigma, 200, 10_000, s_, 3, 0, False, 0.0) for s_ in seeds],
        "noise_dump_kernel", launches=len(seeds)))
    # K1's per-rollout body where its second pass differs most: LTI A=3
    # K=10⁵ under antithetic and OU 0.5, and with every rollout weighing
    # (λ = 1e9); the R=8 flagship fleet (A=3, K=10⁴, T=200); the bicycle's K1
    # and K4 from its own library at K=10⁵. "weighing": the share of
    # rollouts whose weight in their block is not 0
    per_rollout = {}
    q = make_problem(3, 128, 200)
    fam = fs.lti_family(q["sigma"], q["inv_s"], q["w"], q["dt"], q["lam_cost"])
    args = (fam, q["x0"], q["U"], q["goal"])
    for mode, lam, anti, ou in (("antithetic", q["lam"], True, 0.0), ("ou0.5", q["lam"], False, 0.5),
                                ("iid lambda=1e9", 1e9, False, 0.0)):
        def run():
            return fs.family_solve_partials(*args, lam, 100_000, 7, 3, 0, anti, ou)
        per_rollout[f"lti A=3 K=100000 T=200 {mode}"] = dict(
            K1=times(run), weighing=weighing_share(run()[0], lam, fs.BLOCK))
    xs, Us, goals = (v.expand(8, *v.shape).contiguous() for v in args[1:])
    fleet_seeds = philox.fleet_seeds(7, 8).cuda()
    for mode, lam in (("iid", q["lam"]), ("iid lambda=1e9", 1e9)):
        def run():
            return fs.fleet_family_solve_partials(fam, xs, Us, goals, lam, 10_000, fleet_seeds,
                                                  3, 0, False, 0.0)
        per_rollout[f"fleet R=8 lti A=3 K=10000 T=200 {mode}"] = dict(
            K1=times(run), weighing=weighing_share(run()[0], lam, fs.BLOCK))
    b = make_family_problem("bicycle", 128, 200)
    bargs = (b["fam"], b["x0"], b["U"], b["goal"])

    def run():
        return fs.family_solve_partials(*bargs, b["lam"], 100_000, 7, 3, 0, False, 0.0)
    per_rollout["bicycle-demo A=2 K=100000 T=200"] = dict(
        K1=times(run), K4=times(lambda: fs.fused_rollout_costs(*bargs, 100_000, 7, 3, 0, False, 0.0)),
        weighing=weighing_share(run()[0], b["lam"], fs.BLOCK))
    digests = combine_digests(k2e)
    # K7 and K6 at the shapes their paths run, and their outputs over every
    # case of phase 21's checks (each also held there to its plain version)
    world_tail = tail_world_commit_times()
    check_solve_tail(digests=digests)
    for name in WORLD_CASES:
        check_world_step(name, digests=digests)
    smi = _smi()
    for key, r in world_tail.items():  # to read parent → change by eye
        print(f"[time-commit] {root} {key}: {r['ms']:.4f} ms by events, device {r['device_ms']} "
              f"ms ({smi})")
    sharded = {}
    if importlib.util.find_spec("mppi_gpu_tpu_torch.ops.sharded_combine") is not None:
        sharded = sharded_commit_times(times)
        digests.update(sharded_digests())
        digests.update(softmin_digests())
        for key, r in sharded.items():  # to read parent → change by eye
            print(f"[time-commit] {root} {key}: {r['ms']:.4f} ms by events, device {r['device_ms']} "
                  f"ms ({smi})")
    print(json.dumps({"root": root, "kind": torch.cuda.get_device_name(0), "main": main_path,
                      "large": large, "draws": draws, "per_rollout": per_rollout,
                      "sharded": sharded, "world_tail": world_tail, "digest": digests}))
    return 0


def tail_world_commit_times(device: str = "cuda") -> dict:
    """K7 and K6 through the package on ``sys.path``, each by
    :func:`tail_times` or :func:`world_step_times` (CUDA events in turns with
    the plain version, the device time alone, the bound): K7 at the flagship
    (R=1, T=200, A=3, K=10⁴) with every output (``solve``) and in the
    cycle's form (action, U shifted in place), at the R=8 fleet's with every
    output and at point_mass2d's (T=50, A=2, K=3000) with every output; K6
    for every world of WORLD_CASES at its solo and R=8 episode shapes. The
    tensors lie on `device` (the card's; the CPU only where a test stubs the
    timers and the C entries)."""
    from mppi_gpu_tpu_torch.controller import CYCLE, FULL

    out = {f"K7 {label}": tail_times(R, T, A, K, outputs, device=device)
           for label, (R, T, A, K, outputs) in {
               "full R=1 T=200 A=3 K=10000": (None, 200, 3, 10_000, FULL),
               "cycle R=1 T=200 A=3": (None, 200, 3, 10_000, CYCLE),
               "full R=8 T=200 A=3 K=10000": (8, 200, 3, 10_000, FULL),
               "full R=1 T=50 A=2 K=3000": (None, 50, 2, 3000, FULL)}.items()}
    for name in WORLD_CASES:
        for R in (None, 8):
            out[f"K6 {name} R={R or 1}"] = world_step_times(name, R, device)
    return out


def sharded_commit_times(times) -> dict:
    """K8 and K9 through the package on ``sys.path``, each by `times` (CUDA
    events and the kernel's device time): K8 on the flagship's rows of one
    and four local ranks; K9 at the flagship (T=200, A=3, K=10⁴) in
    ``solve``'s form (every output, the weights over K), an inner update's
    (u_seq alone) and the two-kernel branch's cycle (ΔU given, the point
    mass's world step), and in the one-pass cycle's form (the division, the
    action, U shifted in place, the world step at the counter) for the
    world body of every EAGER_EPISODE_CONFIGS config at its (T, A) and for
    the flagship's; where the package has K10 and K11, those at
    SOFTMIN_TIME_SHAPES beside K10's library call ``torch.amin(S, 1)``, and
    K5's softmin form at the flagship's and point_mass2d's (A, K, T) on one
    rank, iid."""
    import torch

    from mppi_gpu_tpu_torch.controller import CYCLE, FULL, ITERATE
    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh

    out = {}
    cfg = _episode_config("flagship")
    T, A, K, lam = cfg.horizon, cfg.action_dim, cfg.samples, cfg.lambda_
    for n in (1, 4):
        rows, _, _, _ = sharded_inputs(n, T, A, lam, "finite", "cuda")
        beta = virtual_mesh(n, "cuda").all_reduce(rows[:, 0], "min", keep=True)
        out[f"K8 n={n} T={T} A={A}"] = times(lambda: sc.sharded_scale(rows, beta, lam),
                                             "sharded_scale_kernel")
    rows, S, U, max_a = sharded_inputs(1, T, A, lam, "finite", "cuda")
    sums = sc.sharded_scale(rows, rows[0, 0].clone(), lam)[0]
    S_full = torch.cat([S.reshape(-1)] * -(-K // S.numel()))[:K].contiguous()
    softmin = (S_full, rows[0, 0].clone(), sums[0], lam)
    out[f"K9 full T={T} A={A} K={K}"] = times(
        lambda: sc.sharded_tail(U, sums, max_a, True, FULL, softmin, divide=True), "sharded_tail_kernel")
    out[f"K9 iterate T={T} A={A}"] = times(
        lambda: sc.sharded_tail(U, sums, max_a, True, ITERATE, divide=True), "sharded_tail_kernel")
    tickets = torch.zeros(2, dtype=torch.int32, device="cuda")
    dU = (sums[1:] / sums[0]).view(T, A)
    for name in ("flagship",) + EAGER_EPISODE_CONFIGS:
        c = _episode_config(name)
        world = make_world(c, device="cuda")
        rows, _, U, max_a = sharded_inputs(1, c.horizon, c.action_dim, c.lambda_, "finite", "cuda")
        sums_c = sc.sharded_scale(rows, rows[0, 0].clone(), c.lambda_)[0]
        adv, U_c, step = _episode_buffers(world, world.reset(), U, 4096, "cuda")  # past every call
        out[f"K9 cycle {name} {world._kernel_kind} T={c.horizon} A={c.action_dim}"] = times(
            lambda: sc.sharded_tail(U_c, sums_c, max_a, c.clamp_action, CYCLE, into=U_c,
                                    divide=True, step=step, advance=adv, tickets=tickets),
            "sharded_tail_kernel")
        if name == "flagship":
            step.zero_()
            out[f"K9 two-kernel cycle {name} T={T} A={A}"] = times(
                lambda: sc.sharded_tail(U_c, dU, max_a, c.clamp_action, CYCLE, into=U_c,
                                        step=step, advance=adv, tickets=tickets),
                "sharded_tail_kernel")
    if not hasattr(sc, "softmin_eta"):
        return out
    from mppi_gpu_tpu_torch.ops import fused_solve as fs

    for name, n in SOFTMIN_TIME_SHAPES:
        c = _episode_config(name)
        k_loc = c.samples // n
        S = softmin_inputs(n, k_loc, c.lambda_, "finite", "cuda")
        row_tickets = torch.zeros(n, dtype=torch.int32, device="cuda")
        beta = sc.softmin_min(S, row_tickets).amin(0)
        out[f"K10 {name} n={n} K/n={k_loc}"] = times(lambda: sc.softmin_min(S, row_tickets),
                                                      "softmin_min_kernel")
        out[f"K11 {name} n={n} K/n={k_loc}"] = times(
            lambda: sc.softmin_eta(S, beta, c.lambda_, row_tickets), "softmin_eta_kernel")
        out[f"torch.amin {name} n={n} K/n={k_loc}"] = times(lambda: torch.amin(S, 1), None)
        if n == 1:
            sigma = torch.full((c.action_dim,), 0.25, device="cuda")
            softmin = (S[0], beta, sc.softmin_eta(S, beta, c.lambda_, row_tickets)[0], c.lambda_)
            out[f"K5 softmin form {name} A={c.action_dim} K={c.samples} T={c.horizon}"] = times(
                lambda: fs.weighted_update(sigma, softmin, c.horizon, c.samples, 7, 3, 0, False,
                                           0.0), "softmin_update_kernel")
    return out


def sharded_digests(device: str = "cuda") -> dict:
    """Through the public wrappers of the package on ``sys.path``: the
    digest of K8's and K9's outputs at every shape of SHARDED_SHAPES and
    SHARDED_EDGE_SHAPES (one and four local ranks, λ 1.1, a finite case and
    a rank at +inf; K8's rows, ΔU, every output with the weights, the cycle
    in place, the two-kernel form) and of K9's world step for the world body
    of every EAGER_EPISODE_CONFIGS config at each of SHARDED_WORLD_HORIZONS
    (SHARDED_WORLD_CYCLES chained cycles: U, the state, the histories, x
    and the counter), on `device`. Run on two packages, equal digests say
    their K8 and K9 give the same bits."""
    import torch

    from mppi_gpu_tpu_torch.controller import CYCLE, FULL
    from mppi_gpu_tpu_torch.envs import make_world
    from mppi_gpu_tpu_torch.ops import sharded_combine as sc
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh

    out = {}
    for n in (1, 4):
        reduce = virtual_mesh(n, device).all_reduce
        for T, A in SHARDED_SHAPES + SHARDED_EDGE_SHAPES:
            for case in ("finite", "inf rank"):
                rows, S, U, max_a = sharded_inputs(n, T, A, 1.1, case, device, seed=T * A)
                beta = reduce(rows[:, 0], "min", keep=True)
                scaled = sc.sharded_scale(rows, beta, 1.1)
                sums = reduce(scaled, "sum")
                dU, full = sc.sharded_tail(U, sums, max_a, True, FULL,
                                           (S.reshape(-1), beta, sums[0], 1.1), divide=True,
                                           keep_dU=True)
                U_c = U.clone()
                _, cyc = sc.sharded_tail(U_c, sums, max_a, True, CYCLE, into=U_c, divide=True)
                _, two = sc.sharded_tail(U, dU, max_a, False, FULL,
                                         (S.reshape(-1), beta, sums[0], 1.1))
                out[f"K8/K9 n={n} T={T} A={A} {case}"] = digest(
                    scaled, dU, *(getattr(full, k) for k in FULL), U_c, cyc.action,
                    *(getattr(two, k) for k in FULL))
    for name in EAGER_EPISODE_CONFIGS:
        cfg = _config(name)
        world = make_world(cfg, device=device)
        for T in SHARDED_WORLD_HORIZONS:
            T = T or cfg.horizon
            rng = np.random.default_rng(T)
            U0 = rng.uniform(-1.0, 1.0, (T, cfg.action_dim)).astype(np.float32)
            U0 = torch.from_numpy(U0).to(device)
            adv, U_k, step = _episode_buffers(world, world.reset(), U0, SHARDED_WORLD_CYCLES + 2, device)
            tickets = torch.zeros(2, dtype=torch.int32, device=device)
            max_a = torch.tensor(cfg.max_a, dtype=torch.float32, device=device)
            for c in range(SHARDED_WORLD_CYCLES):
                dU = rng.normal(0.0, 0.5, 1 + T * cfg.action_dim).astype(np.float32)
                dU[0] = np.float32(rng.uniform(1.0, 50.0))
                sc.sharded_tail(U_k, torch.from_numpy(dU).to(device), max_a, cfg.clamp_action, CYCLE,
                                into=U_k, divide=True, step=step, advance=adv, tickets=tickets)
            out[f"K9 world {name} T={T}"] = digest(U_k, *adv.state, adv.xs, adv.us, adv.ts, adv.x,
                                                   step)
    return out


def softmin_digests(device: str = "cuda") -> dict:
    """Through the public wrappers of the package on ``sys.path``, where it
    has K10 and K11: the digest of K10's β_d and K11's η_d (against the
    MIN's β) on one, two and four local ranks' rows at every SOFTMIN_K_LOCS
    (each row form: a block, a cluster, a ticket) and every SOFTMIN_CASES
    case at λ 1.1, and at SOFTMIN_LARGE, on `device`. Run on two packages,
    equal digests say their K10 and K11 give the same bits."""
    import torch

    from mppi_gpu_tpu_torch.ops import sharded_combine as sc

    if not hasattr(sc, "softmin_eta"):
        return {}
    out = {}
    grid = [(n, k, 1.1, case) for n in SHARDED_RANKS for k in SOFTMIN_K_LOCS
            for case in SOFTMIN_CASES]
    for n, k_loc, lam, case in grid + [SOFTMIN_LARGE]:
        S = softmin_inputs(n, k_loc, lam, case, device, seed=n * k_loc)
        tickets = torch.zeros(n, dtype=torch.int32, device=device)
        beta_d = sc.softmin_min(S, tickets)
        out[f"K10/K11 n={n} K/n={k_loc} lambda={lam} {case}"] = digest(
            beta_d, sc.softmin_eta(S, beta_d.amin(), lam, tickets))
    return out


def digest(*arrays) -> str:
    """The first 16 hex digits of the SHA-256 of the arrays' bytes (tensors
    or numpy arrays, in order, each with its dtype and shape): equal digests
    mean equal bits."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(_np(a) if hasattr(a, "detach") else np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def combine_digests(k2e: bool = True) -> dict:
    """Through the public wrappers of the package on ``sys.path``, on the
    partials of every case of :func:`check_combine_forms` (λ 1.1 where the
    case is finite; all of COMBINE_LAMS otherwise would be 900 cases): the
    digest of K2's (β, η, ΔU) and, with K2' (`k2e`), of K2''s (β, η, ΔU,
    u_seq) of an inner iteration and of its cycle with the point mass's
    world step (β, η, ΔU, the action, U shifted in place, the state, the
    histories, x and the counter). Run on two packages, equal digests say
    their kernels give the same bits."""
    import torch

    out = {}
    for nb in COMBINE_NBS:
        for T, A in COMBINE_SHAPES:
            for case in COMBINE_CASES:
                for lam in (COMBINE_LAMS if case == "finite" else (1.1,)):
                    for R in COMBINE_ROBOTS:
                        parts, U, max_a, world, state = combine_case_inputs(R, nb, T, A, case,
                                                                            "cuda")
                        key = f"nb={nb} T={T} A={A} {case} lambda={lam} R={R or 1}"
                        k2 = run_k2(parts, lam, T, A)
                        out[f"K2 {key}"] = digest(*k2)
                        if not k2e:
                            continue
                        from mppi_gpu_tpu_torch.controller import CYCLE, ITERATE

                        tickets = torch.zeros((R or 1) + 1, dtype=torch.int32, device="cuda")
                        b, e, d, tail = run_k2e(parts, lam, U, max_a, True, ITERATE, tickets, None)
                        out[f"K2' {key}"] = digest(b, e, d, tail.u_seq)
                        adv, U_e, step = _episode_buffers(world, state, U, 2, "cuda")
                        b, e, d, tail = run_k2e(parts, lam, U_e, max_a, False, CYCLE, tickets, None,
                                                into=U_e, step=step, advance=adv)
                        out[f"K2' cycle {key}"] = digest(b, e, d, tail.action, U_e, *adv.state,
                                                         adv.xs, adv.us, adv.ts, adv.x, step)
    return out


def same_digests(paths: list[str]) -> int:
    """``python3 chip_smoke.py --same-digests FILE...``: the last JSON line
    holding "digest" in each file (a ``--time-commit`` or
    ``--episode-commit`` run's), compared key by key: prints how many agree
    in all files and which differ or are missing in one; exits 1 if any."""
    runs = []
    for path in paths:
        with open(path) as f:
            lines = [ln for ln in f if ln.startswith("{") and '"digest"' in ln]
        expect(bool(lines), f"{path}: no JSON line with digests")
        runs.append(json.loads(lines[-1])["digest"])
    keys = set().union(*runs)
    differ = sorted(k for k in keys if len({r.get(k) for r in runs}) != 1)
    print(f"same-digests {paths}: {len(keys) - len(differ)} of {len(keys)} digests equal in all "
          f"{len(runs)}; differ or missing: {differ}")
    return 1 if differ else 0


def episode_commit(root: str) -> int:
    """``python3 chip_smoke.py --episode-commit ROOT``: the device episode
    of the package in the checkout at ROOT (its kernels built there), to
    compare two commits in one run: for every config of EPISODE_CONFIGS and
    the R=8 fleet of every FLEET_EPISODE_CONFIGS, the graph's ms per cycle
    (host clock around a warm episode) and the eager cycle's, and from a
    trace of its replays (:func:`replay_trace`) kernels, busy ms, K1 + K2's
    share of busy and K2''s µs (by its world body) per cycle and the
    untraced ms per cycle; the sharded
    episode's graph ms per cycle at SHARDED_EPISODE_CONFIGS, both branches, on
    a world of one NCCL rank and on four virtual ranks, with K8's, K9's,
    K10's and K11's device µs per cycle from the trace (a package before
    K10 and K11 traced with K5's w form in its two-kernel cycle); the
    digest of each
    graph episode's histories (xs, us, times: the final state is xs[-1]),
    ``digest``; one JSON line. A package before K6 or K7 is traced without
    their records, one before K2' (``ops/combine_tail.py``) with K2, K7 and
    K6 in its cycle."""
    sys.path.insert(0, os.path.abspath(root))
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mppi_gpu_tpu_torch.batched import BatchedMPPIController
    from mppi_gpu_tpu_torch.controller import MPPIController
    from mppi_gpu_tpu_torch.parallel import ShardedMPPIController, global_mesh
    from mppi_gpu_tpu_torch.parallel.mesh import virtual_mesh
    from mppi_gpu_tpu_torch.runner import run_episode_jit, run_fleet_episode

    k6 = importlib.util.find_spec("mppi_gpu_tpu_torch.ops.world_step") is not None
    k7 = importlib.util.find_spec("mppi_gpu_tpu_torch.ops.solve_tail") is not None
    k2e = importlib.util.find_spec("mppi_gpu_tpu_torch.ops.combine_tail") is not None
    k9 = importlib.util.find_spec("mppi_gpu_tpu_torch.ops.sharded_combine") is not None
    k11 = k9 and hasattr(importlib.import_module("mppi_gpu_tpu_torch.ops.sharded_combine"),
                         "softmin_eta")
    digests = {}  # each graph episode's xs, us and times

    def row(ctrl, run, label: str, fleet: bool = False, per_update=None,
            epilogue: bool = k2e, sharded_tail: bool = False) -> dict:
        run(ctrl)  # captures
        graph = _timed(lambda: run(ctrl))
        eager = _timed(lambda: run(ctrl, capture=False))
        n = len(graph[0].us)
        t = replay_trace(ctrl, label, fleet=fleet, per_update=per_update, world_kernel=k6,
                         tail_kernel=k7, epilogue=epilogue, sharded_tail=sharded_tail)
        res = graph[0]
        digests[label] = digest(res.xs, res.us, res.times)
        return dict(graph_ms=graph[1] * 1e3 / n, eager_ms=eager[1] * 1e3 / n, kernels=t["kernels"],
                    busy_ms=t["busy_ms"], k12_share=t["k12_share"], idle=t["idle"],
                    untraced_ms=t["untraced_ms"], k6_per_cycle=t["k6_per_cycle"],
                    k7_per_cycle=t["k7_per_cycle"], k2e_per_cycle=t["k2e_per_cycle"],
                    k8_per_cycle=t["k8_per_cycle"], k9_per_cycle=t["k9_per_cycle"],
                    k2e_us=t["k2e_us"], k8_us=t["k8_us"], k9_us=t["k9_us"],
                    k10_us=t["k10_us"], k11_us=t["k11_us"], nccl_per_cycle=t["nccl_per_cycle"],
                    top=t["top"])

    configs = {name: row(MPPIController(_episode_config(name), device="cuda"), run_episode_jit, name)
               for name in EPISODE_CONFIGS}
    fleets = {name: row(BatchedMPPIController(_episode_config(name), 8, device="cuda"),
                        run_fleet_episode, f"fleet {name}", fleet=True)
              for name in FLEET_EPISODE_CONFIGS}
    sharded = {}
    with nccl_world_of_one():
        meshes = {"world of one (NCCL)": global_mesh("cuda:0"),
                  "4 virtual ranks": virtual_mesh(4, "cuda:0")}
        for name in SHARDED_EPISODE_CONFIGS:
            for mname, mesh in meshes.items():
                for onepass in (True, False):
                    label = f"{name} {mname} {'one-pass' if onepass else 'two-kernel'}"
                    ctrl = ShardedMPPIController(_episode_config(name), mesh=mesh, onepass=onepass)
                    per_update = sharded_per_update(mesh, onepass, softmin_kernels=k11)
                    if not k9:  # a package before K8 and K9: K7 per update, K6 per cycle
                        per_update.update(sharded_scale=0, sharded_tail=0)
                    sharded[label] = row(ctrl, run_episode_jit, label, epilogue=False,
                                         per_update=per_update, sharded_tail=k9)
    smi = _smi()
    for label, r in sharded.items():  # the sharded rows, to read parent → change by eye
        print(f"[episode-commit] {root} sharded {label}: {r['kernels']:g} kernels per cycle (K7 "
              f"{r['k7_per_cycle']:g}, K6 {r['k6_per_cycle']:g}, K8 {r['k8_per_cycle']:g}, K9 "
              f"{r['k9_per_cycle']:g}; device K8 {r['k8_us']:.2f} us, K9 {r['k9_us']:.2f} us, K10 "
              f"{r['k10_us']:.2f} us, K11 {r['k11_us']:.2f} us per cycle), graph "
              f"{r['graph_ms']:.4f} ms per cycle, untraced "
              f"{r['untraced_ms']:.4f}, idle {r['idle']:.4f}, eager {r['eager_ms']:.4f} ({smi})")
    print(json.dumps({"root": root, "kind": torch.cuda.get_device_name(0), "smi": smi,
                      "world_kernel": k6, "tail_kernel": k7, "epilogue": k2e, "sharded_tail": k9,
                      "configs": configs, "fleets": fleets, "sharded": sharded,
                      "digest": digests}))
    return 0


def sass_diff(root: str, changed: str | None = None) -> int:
    """``python3 chip_smoke.py --sass-diff ROOT [REGEX]``: the built-in
    library of this checkout and the one of the checkout at ROOT, each built
    from its own sources, compared kernel by kernel (:func:`kernel_key`
    names, SASS instruction streams without their addresses): prints how
    many are identical and exits 1 if any kernel differs or is missing on
    one side, except a kernel whose name REGEX matches, which a change to
    that kernel alone is expected to alter or add (``'^solve_partials<(?!.*slab)'``:
    K1's per-rollout body, every other kernel identical; ``'^world_advance'``:
    K6's instances, new beside K1-K5). A change that
    moves kernel code without changing it leaves every stream identical,
    and so every result bit for bit."""
    import importlib.util

    from mppi_gpu_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(root, "mppi_gpu_tpu_torch", "ops", "_build.py"))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")

    def streams(path) -> dict[str, list[str]]:
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        return {kernel_key(k): [i for _, i in v] for k, v in sass_functions(sass).items()}

    mine, theirs = streams(_build.build()), streams(other.build())
    both = mine.keys() & theirs.keys()
    differ = sorted(k for k in mine.keys() | theirs.keys() if mine.get(k) != theirs.get(k))
    same = len(both) - sum(k in both for k in differ)
    expected = [k for k in differ if changed and re.search(changed, k)]
    others = [k for k in differ if k not in expected]
    print(f"sass-diff {root}: {len(mine)} kernels here, {len(theirs)} there, {same} identical "
          f"instruction streams; differ as expected ({changed!r}): {expected}; differ otherwise "
          f"or missing: {others}")
    return 1 if others else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time-commit"]:
        sys.exit(time_commit(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--episode"]:
        sys.exit(episode_only())
    if sys.argv[1:2] == ["--episode-commit"]:
        sys.exit(episode_commit(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--family"]:
        sys.exit(family_only())
    if sys.argv[1:2] == ["--plants"]:
        sys.exit(plants_only())
    if sys.argv[1:2] == ["--graphs"]:
        sys.exit(graphs_only())
    if sys.argv[1:2] == ["--sharded-combine"]:
        sys.exit(sharded_combine_only())
    if sys.argv[1:2] == ["--bodies"]:
        sys.exit(bodies_only())
    if sys.argv[1:2] == ["--combine"]:
        sys.exit(combine_only())
    if sys.argv[1:2] == ["--same-digests"]:
        sys.exit(same_digests(sys.argv[2:]))
    if sys.argv[1:2] == ["--sass-diff"]:
        sys.exit(sass_diff(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--slab"]:
        sys.exit(slab_only())
    if sys.argv[1:2] == ["--slab-digests"]:
        sys.exit(slab_digests(sys.argv[2] if len(sys.argv) > 2 else "."))
    sys.exit(main())
