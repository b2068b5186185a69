"""Checkpoint / resume for the closed control loop (torch counterpart of
``mppi_gpu_tpu.io.checkpoint``, which imports jax; this is the port's own
copy).

The reference has no checkpointing at all — its closest analog is the
per-step full-state CSV dump (reference src/main.cu:256, 355-367) from which
a solve could only be inspected, not resumed. Here the loop state is small
and explicit — (step index, nominal sequence U, seed, world state) — so a
checkpoint is a single `.npz` with the config embedded, and resuming
reproduces the exact future of an uninterrupted run: the port's noise is a
pure function of (seed, step, it) (``ops/philox.py``), so no RNG stream state
beyond the seed needs saving. The fields are the JAX package's, with the
seed (int64) in place of the JAX key's data.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

import numpy as np

from mppi_gpu_tpu_torch.config import MPPIConfig


@dataclass(frozen=True)
class Checkpoint:
    step: int               # next control step to execute
    U: np.ndarray           # (T, a) nominal action sequence
    seed: int               # the noise stream's seed
    x: np.ndarray           # (s,) world state at `step`
    time: float             # world sim time at `step`
    cfg: MPPIConfig


def save_checkpoint(
    path: str | os.PathLike,
    *,
    step: int,
    U,
    seed: int,
    x,
    time: float,
    cfg: MPPIConfig,
) -> None:
    """Write the loop state to `path` atomically (a temporary file renamed
    into place), so an interrupted write never leaves a torn checkpoint."""
    tmp = f"{path}.tmp"
    np.savez(
        tmp,
        step=np.int64(step),
        U=np.asarray(U, np.float32),
        seed=np.int64(seed),
        x=np.asarray(x, np.float32),
        time=np.float64(time),
        cfg_json=np.bytes_(json.dumps(asdict(cfg)).encode()),
    )
    # np.savez appends .npz to paths without it; normalize then atomic-rename
    written = tmp if str(tmp).endswith(".npz") else f"{tmp}.npz"
    os.replace(written, path)


def load_checkpoint(path: str | os.PathLike) -> Checkpoint:
    with np.load(path, allow_pickle=False) as z:
        cfg_raw = json.loads(bytes(z["cfg_json"]).decode())

        def detuple(v):
            # json round-trips tuples as lists, recursively (e.g. the nested
            # obstacles tuples); MPPIConfig must stay fully hashable
            return tuple(detuple(x) for x in v) if isinstance(v, list) else v

        cfg = MPPIConfig(**{k: detuple(v) for k, v in cfg_raw.items()})
        return Checkpoint(
            step=int(z["step"]),
            U=z["U"],
            seed=int(z["seed"]),
            x=z["x"],
            time=float(z["time"]),
            cfg=cfg,
        )
