"""Dynamics interface (torch counterpart of ``mppi_gpu_tpu.models.base``)."""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class Dynamics(Protocol):
    """A discrete-time dynamics model ``x_{t+1} = f(x_t, u_t)``.

    ``step`` broadcasts over leading batch dims:
    ``x: (..., state_dim)``, ``u: (..., action_dim)`` → ``(..., state_dim)``.
    """

    state_dim: int
    action_dim: int

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        ...
