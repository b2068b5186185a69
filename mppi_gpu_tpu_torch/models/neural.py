"""Learned dynamics: a residual MLP and an analytic model with a learned
correction (torch counterpart of ``mppi_gpu_tpu.models.neural``).

* :class:`MLPDynamics` — ``x' = x + scale · MLP([x, u])``, tanh hidden
  layers, optional input standardisation; an untrained net (zero output
  layer, :func:`init_mlp_dynamics`) is the identity model.
* :class:`HybridResidualDynamics` — ``x' = base.step(x, u) + (mlp.step(x, u)
  − x)``: physics where it is known, a net for the gap, with an optional
  renormalised state slice (the 3-D quadrotor's quaternion).
* :func:`fit_mlp_dynamics`, :func:`fit_residual_dynamics` — full-batch Adam
  (``torch.optim.Adam``) under the cosine decay of
  ``optax.cosine_decay_schedule(lr, steps)``, step 0 at the first update, as
  the JAX package's optax fits; each returns a new model and its per-step
  loss history (the loss before each update).

The weights keep the JAX package's (in, out) layout, ``h @ W + b``. They are
buffers, not parameters: a solve rolls the model out without building an
autograd graph over its horizon, and only the fits take gradients, of
copies they make. Both models step on the eager backend (no fused family
takes them); their products are plain ``torch.matmul``, as the JAX package
leaves them to XLA outside any Pallas kernel. On a CUDA device keep float32
products in float32 (``torch.backends.cuda.matmul.allow_tf32`` False, the
default): TF32 would part a fit on the card from the CPU's by more than
float32 rounding.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def _mlp_delta(weights, biases, h: torch.Tensor) -> torch.Tensor:
    """The net's output for inputs h (..., in): tanh hidden layers, a linear
    output layer."""
    for w, b in zip(weights[:-1], biases[:-1]):
        h = torch.tanh(h @ w + b)
    return h @ weights[-1] + biases[-1]


class MLPDynamics(nn.Module):
    """Residual MLP dynamics: ``x_{t+1} = x_t + residual_scale · MLP([x_t,
    u_t])``, the net seeing ``(concat([x, u]) − in_shift) · in_scale`` when
    both are set. Weights (in, out), biases (out,)."""

    def __init__(
        self,
        weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor],
        residual_scale: torch.Tensor | float = 1.0,
        in_shift: torch.Tensor | None = None,
        in_scale: torch.Tensor | None = None,
    ) -> None:
        super().__init__()
        if len(weights) != len(biases) or not weights:
            raise ValueError(f"{len(weights)} weights and {len(biases)} biases")
        if (in_shift is None) != (in_scale is None):
            raise ValueError("in_shift and in_scale must be set together (got exactly one)")
        self.n_layers = len(weights)
        for i, (w, b) in enumerate(zip(weights, biases)):
            self.register_buffer(f"w{i}", w)
            self.register_buffer(f"b{i}", b)
        like = weights[0]
        self.register_buffer("residual_scale", torch.as_tensor(
            residual_scale, dtype=like.dtype, device=like.device))
        self.register_buffer("in_shift", in_shift)
        self.register_buffer("in_scale", in_scale)
        self.state_dim = int(weights[-1].shape[1])
        self.action_dim = int(weights[0].shape[0]) - self.state_dim

    @property
    def weights(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"w{i}") for i in range(self.n_layers))

    @property
    def biases(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"b{i}") for i in range(self.n_layers))

    def _step(self, weights, biases, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        x = x.expand(*batch, self.state_dim)
        h = torch.cat([x, u.expand(*batch, self.action_dim)], dim=-1)
        if self.in_shift is not None:
            # standardised inputs keep the tanh layers out of saturation when
            # raw components span decades (hover thrust ~8 beside rates ~0.1)
            h = (h - self.in_shift) * self.in_scale
        return x + self.residual_scale * _mlp_delta(weights, biases, h)

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """(..., s), (..., a) → (..., s); leading dims broadcast."""
        return self._step(self.weights, self.biases, x, u)

    def replace(self, weights, biases) -> "MLPDynamics":
        """This model with other weights and biases (the fits' result)."""
        return MLPDynamics(weights, biases, self.residual_scale, self.in_shift, self.in_scale)


def init_mlp_dynamics(
    state_dim: int,
    action_dim: int,
    hidden: Sequence[int] = (128, 128),
    residual_scale: float = 1.0,
    *,
    generator: torch.Generator | None = None,
    device: torch.device | str = "cpu",
) -> MLPDynamics:
    """Glorot-normal hidden layers drawn from `generator` (on the CPU, then
    moved to `device`) and a zero output layer, so the fresh model is the
    identity map, safe to drop into a running controller."""
    dims = [state_dim + action_dim, *hidden, state_dim]
    weights, biases = [], []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        if i == len(dims) - 2:
            w = torch.zeros(din, dout)
        else:
            w = math.sqrt(2.0 / (din + dout)) * torch.randn(din, dout, generator=generator)
        weights.append(w.to(device))
        biases.append(torch.zeros(dout, device=device))
    return MLPDynamics(weights, biases, residual_scale)


class HybridResidualDynamics(nn.Module):
    """Analytic model + learned residual: ``x' = base.step(x, u) +
    (mlp.step(x, u) − x)``, the correction scaled by the MLP's
    ``residual_scale``; a zero-init net leaves the analytic model untouched.
    ``unit_norm_slice`` (lo, hi) renormalises ``x'[lo:hi]`` after the
    correction (the 3-D quadrotor's quaternion, which the analytic step keeps
    unit but a raw residual would let drift)."""

    def __init__(self, base, mlp: MLPDynamics,
                 unit_norm_slice: tuple[int, int] | None = None) -> None:
        super().__init__()
        self.base = base
        self.mlp = mlp
        self.unit_norm_slice = unit_norm_slice

    @property
    def state_dim(self) -> int:
        return self.mlp.state_dim

    @property
    def action_dim(self) -> int:
        return self.mlp.action_dim

    @property
    def dt(self) -> torch.Tensor:
        return self.base.dt

    def _step(self, weights, biases, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        x = x.expand(*batch, self.state_dim)
        xn = self.base.step(x, u) + (self.mlp._step(weights, biases, x, u) - x)
        if self.unit_norm_slice is not None:
            lo, hi = self.unit_norm_slice
            q = xn[..., lo:hi]
            q = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True))
            xn = torch.cat([xn[..., :lo], q, xn[..., hi:]], dim=-1)
        return xn

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """(..., s), (..., a) → (..., s); leading dims broadcast."""
        return self._step(self.mlp.weights, self.mlp.biases, x, u)

    def replace(self, weights, biases) -> "HybridResidualDynamics":
        """This model with its net's weights and biases replaced."""
        return HybridResidualDynamics(self.base, self.mlp.replace(weights, biases),
                                      self.unit_norm_slice)


def cosine_decay(steps: int):
    """``optax.cosine_decay_schedule(lr, steps)`` as a multiplier of lr for
    ``torch.optim.lr_scheduler.LambdaLR``: ½(1 + cos(π·min(n, steps)/steps))
    at update n = 0, 1, …"""
    return lambda n: 0.5 * (1.0 + math.cos(math.pi * min(n, steps) / steps))


def _fit(model, loss_of, lr: float, steps: int):
    """Full-batch Adam on copies of `model`'s net weights and biases,
    minimising ``loss_of(step, weights, biases)`` where ``step(weights,
    biases, x, u)`` is the model's step under those weights; the learning
    rate follows :func:`cosine_decay`, step 0 at the first update. Returns
    (the model with the fitted weights, the loss before each update)."""
    net = model.mlp if isinstance(model, HybridResidualDynamics) else model
    weights = [w.detach().clone().requires_grad_(True) for w in net.weights]
    biases = [b.detach().clone().requires_grad_(True) for b in net.biases]
    opt = torch.optim.Adam(weights + biases, lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps))
    losses = []
    with torch.enable_grad():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_of(model._step, weights, biases)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
    loss_history = torch.stack(losses) if losses else torch.zeros(0)
    return model.replace([w.detach() for w in weights], [b.detach() for b in biases]), loss_history


def fit_mlp_dynamics(
    model: MLPDynamics,
    transitions: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    *,
    lr: float = 1e-3,
    steps: int = 500,
) -> tuple[MLPDynamics, torch.Tensor]:
    """Full-batch Adam fit of the surrogate on (x, u, x_next) transitions,
    the loss the mean over transitions of Σ (x̂' − x')². Returns (model,
    per-step loss history)."""
    xs, us, xn = transitions

    def loss_of(step, w, b):
        return torch.mean(torch.sum((step(w, b, xs, us) - xn) ** 2, dim=-1))

    return _fit(model, loss_of, lr, steps)


def fit_residual_dynamics(
    model: HybridResidualDynamics,
    transitions: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    *,
    lr: float = 1e-3,
    steps: int = 500,
    whiten: bool = True,
) -> tuple[HybridResidualDynamics, torch.Tensor]:
    """Full-batch Adam fit of the residual net so the hybrid's prediction
    matches the observed next states; the analytic part stays frozen. With
    `whiten` each state dimension's error is divided by the analytic
    residual's population std there, floored at 5 % of the largest (else one
    dominant gap component soaks up the net). Returns (model, per-step loss
    history)."""
    xs, us, xn = transitions
    if whiten:
        with torch.no_grad():
            std = torch.std(xn - model.base.step(xs, us), dim=0, correction=0)
        err_w = 1.0 / (std + 0.05 * torch.max(std) + 1e-12)
    else:
        err_w = torch.ones(xn.shape[-1], dtype=xn.dtype, device=xn.device)

    def loss_of(step, w, b):
        return torch.mean(torch.sum(((step(w, b, xs, us) - xn) * err_w) ** 2, dim=-1))

    return _fit(model, loss_of, lr, steps)
