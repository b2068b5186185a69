"""Config system.

Honors the reference's YAML schema (reference src/main.cu:455-628 `parse_config`):
keys ``env, samples, state-dim, action-dim, horizon, dt, lambda, noise,
init-act, max-a, goal, cost: {type, w}`` — and, unlike the reference, actually
*wires* every one of them:

  * ``noise``    — per-action-dim sampling std (the reference hardcodes 0.025 at
                   src/point_mass_gpu.cu:86 and ignores the YAML value);
  * ``lambda``   — MPPI temperature (reference hardcodes 1.0, src/point_mass.cu:53);
  * ``max-a``    — action clamp (reference parses it but never clamps);
  * ``init-act`` — initial nominal action sequence (reference zeroes it,
                   src/main.cu:678-684);
  * ``cost.type``— cost registry lookup (reference has only quadratic).

Extra (new) optional keys: ``antithetic`` (bool, default false: mirrored
noise pairs for variance reduction), ``noise-beta`` (float in [0,1), default
0: OU time-correlated noise), ``opt-iters`` (int ≥ 1, default 1: iterated
MPPI — that many softmin updates per control cycle), ``clamp-action``
(bool, default true), ``seed`` (int), ``inv-sigma`` ("identity" |
"from-noise": whether the uᵀΣ⁻¹ε cost term uses Σ⁻¹=I like the reference,
src/point_mass_gpu.cu:58-61, or the MPPI-paper Σ⁻¹=diag(1/σ²)).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

try:
    import yaml

    _HAVE_YAML = True
except Exception:  # pragma: no cover - yaml is in the image, but stay robust
    _HAVE_YAML = False


class ConfigError(ValueError):
    """Raised on a missing/invalid config key (analog of the reference's
    exit(1) paths in src/main.cu:479-524)."""


REQUIRED_KEYS = (
    "env",
    "samples",
    "state-dim",
    "action-dim",
    "horizon",
    "dt",
    "lambda",
    "noise",
    "init-act",
    "max-a",
    "goal",
    "cost",
)


@dataclass(frozen=True)
class MPPIConfig:
    """Static MPPI problem description. Frozen: hashable, safe as a jit static."""

    env: str
    samples: int                      # K — number of rollouts
    state_dim: int                    # s
    action_dim: int                   # a
    horizon: int                      # T
    dt: float
    lambda_: float                    # temperature λ
    noise: tuple[float, ...]          # per-dim sampling std σ (len a)
    init_act: tuple[float, ...]       # initial nominal action (len a)
    max_a: tuple[float, ...]          # action bound (len a)
    goal: tuple[float, ...]           # goal state (len s)
    cost_type: str = "quadratic"
    cost_w: tuple[float, ...] = ()    # state-cost diag weights (len s)
    clamp_action: bool = True
    inv_sigma: str = "identity"       # "identity" | "from-noise"
    seed: int = 0
    antithetic: bool = False          # mirrored noise pairs (ε, −ε): variance
                                      # reduction + half the PRNG work; K must
                                      # be even
    obstacles: tuple[tuple[float, ...], ...] = ()  # (x.., radius) per obstacle
    obstacle_w: float = 1000.0        # penalty for being inside an obstacle
    noise_beta: float = 0.0           # OU noise correlation (0 = iid like the
                                      # reference; 0<β<1 = smoother controls)
    opt_iters: int = 1                # iterated MPPI: softmin-update the
                                      # nominal sequence this many times per
                                      # control cycle (fresh noise each
                                      # iteration) before executing U[0];
                                      # 1 = the reference's single update

    def __post_init__(self) -> None:
        if self.samples < 1:
            raise ConfigError(f"samples must be >= 1, got {self.samples}")
        if self.horizon < 1:
            raise ConfigError(f"horizon must be >= 1, got {self.horizon}")
        if self.dt <= 0:
            raise ConfigError(f"dt must be > 0, got {self.dt}")
        if self.inv_sigma not in ("identity", "from-noise"):
            raise ConfigError(f"inv-sigma must be 'identity' or 'from-noise'")
        if not 0.0 <= self.noise_beta < 1.0:
            raise ConfigError(
                f"noise-beta must be in [0, 1), got {self.noise_beta}"
            )
        if self.antithetic and self.samples % 2 != 0:
            raise ConfigError(
                f"antithetic sampling needs an even number of samples, got {self.samples}"
            )
        if self.opt_iters < 1:
            raise ConfigError(f"opt-iters must be >= 1, got {self.opt_iters}")
        # Dimension warnings in the reference (src/main.cu:530-612) are hard
        # errors here: silent dim mismatch is never what the user wants.
        checks = [
            ("noise", self.noise, self.action_dim),
            ("init-act", self.init_act, self.action_dim),
            ("max-a", self.max_a, self.action_dim),
            ("goal", self.goal, self.state_dim),
        ]
        if self.cost_type in ("quadratic", "obstacle"):
            # only for costs where w IS the state diagonal; the other cost
            # factories (ops/cost.py registry) validate their own w lengths
            # (e.g. quadrotor3d takes 8 weights over a 13-dim state)
            checks.append(("cost.w", self.cost_w, self.state_dim))
        for name, seq, want in checks:
            if len(seq) != want:
                raise ConfigError(
                    f"{name} has {len(seq)} entries, expected {want} "
                    f"(state-dim={self.state_dim}, action-dim={self.action_dim})"
                )

    @property
    def K(self) -> int:
        return self.samples

    @property
    def T(self) -> int:
        return self.horizon

    def replace(self, **kw: Any) -> "MPPIConfig":
        return dataclasses.replace(self, **kw)


def _as_float_tuple(v: Any, key: str) -> tuple[float, ...]:
    if isinstance(v, (int, float)):
        return (float(v),)
    if isinstance(v, Sequence):
        return tuple(float(x) for x in v)
    raise ConfigError(f"config key '{key}' must be a number or list, got {type(v)}")


def config_from_mapping(doc: Mapping[str, Any]) -> MPPIConfig:
    """Build an :class:`MPPIConfig` from a parsed YAML mapping (reference keys)."""
    missing = [k for k in REQUIRED_KEYS if k not in doc]
    if missing:
        raise ConfigError(f"missing required config keys: {missing}")
    cost = doc["cost"]
    if not isinstance(cost, Mapping) or "type" not in cost or "w" not in cost:
        raise ConfigError("config key 'cost' must be a mapping with 'type' and 'w'")
    return MPPIConfig(
        env=str(doc["env"]),
        samples=int(doc["samples"]),
        state_dim=int(doc["state-dim"]),
        action_dim=int(doc["action-dim"]),
        horizon=int(doc["horizon"]),
        dt=float(doc["dt"]),
        lambda_=float(doc["lambda"]),
        noise=_as_float_tuple(doc["noise"], "noise"),
        init_act=_as_float_tuple(doc["init-act"], "init-act"),
        max_a=_as_float_tuple(doc["max-a"], "max-a"),
        goal=_as_float_tuple(doc["goal"], "goal"),
        cost_type=str(cost["type"]),
        cost_w=_as_float_tuple(cost["w"], "cost.w"),
        obstacles=tuple(
            _as_float_tuple(o, "cost.obstacles[i]") for o in cost.get("obstacles", ())
        ),
        obstacle_w=float(cost.get("obstacle-w", 1000.0)),
        clamp_action=bool(doc.get("clamp-action", True)),
        inv_sigma=str(doc.get("inv-sigma", "identity")),
        seed=int(doc.get("seed", 0)),
        antithetic=bool(doc.get("antithetic", False)),
        noise_beta=float(doc.get("noise-beta", 0.0)),
        opt_iters=int(doc.get("opt-iters", 1)),
    )


def _mini_yaml(text: str) -> dict[str, Any]:
    """Tiny fallback parser for the reference's YAML subset (flat mapping +
    one nested 'cost' block + '- item' lists). Only used if PyYAML is absent."""
    root: dict[str, Any] = {}
    stack: list[tuple[int, Any]] = [(-1, root)]
    last_key: list[tuple[int, dict, str]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        indent = len(line) - len(line.lstrip())
        body = line.strip()
        while stack and indent <= stack[-1][0]:
            stack.pop()
        container = stack[-1][1]
        if body.startswith("- "):
            val = body[2:].strip()
            if last_key and isinstance(container, dict):
                _, d, k = last_key[-1]
                if not isinstance(d.get(k), list):
                    d[k] = []
                d[k].append(_scalar(val))
            continue
        if ":" in body:
            k, _, v = body.partition(":")
            k, v = k.strip(), v.strip()
            if v == "":
                sub: dict[str, Any] = {}
                container[k] = sub
                stack.append((indent, sub))
                last_key.append((indent, container, k))
            else:
                container[k] = _scalar(v)
                last_key.append((indent, container, k))
    return root


def _scalar(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def load_config(path: str | os.PathLike) -> MPPIConfig:
    """Load an MPPI config from a YAML file using the reference schema."""
    with open(path, "r") as f:
        text = f.read()
    if _HAVE_YAML:
        doc = yaml.safe_load(text)
    else:  # pragma: no cover
        doc = _mini_yaml(text)
    if not isinstance(doc, Mapping):
        raise ConfigError(f"config file {path} did not parse to a mapping")
    return config_from_mapping(doc)
