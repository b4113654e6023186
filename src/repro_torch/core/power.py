"""Transmit power control (paper Sec. 2, "Power Control").

Each worker computes α_n with α_n² · Σ_i |s_{n,i}|² = P; the PS takes
α = min_n α_n.  Everyone transmits α·s and the PS divides by α, so the
effective receiver noise is z/α.  A worker with nothing to send (Σ|s|² = 0)
imposes no constraint: its α_n is +inf, and if every worker is energy-free
the round's 1/α is exactly 0.  Counterpart of ``repro/core/power.py``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def alpha_from_energy(energy: Tensor, power_budget: float) -> Tensor:
    """α_n = sqrt(P / E_n) with the zero-energy guard (E_n = 0 ⇒ +inf)."""
    return torch.where(energy > 0.0,
                       torch.sqrt(power_budget / torch.clamp_min(energy, 1e-30)),
                       torch.full_like(energy, float("inf")))


def retry_power_budget(power_budget: float, attempt: int,
                       backoff: float) -> float:
    """Budget ``P·γ^attempt`` of the guard's retransmission ``attempt``
    (``faults.guards``).  Attempt 0 is the original slot: γ⁰ = 1 exactly,
    so its budget is ``power_budget`` itself and a guarded round with no
    retry is the unguarded round.  ``attempt`` is a host integer (the
    guard runs every attempt); with γ a power of two the f32 budget the
    kernels see is the JAX package's ``f32(P)·γ^attempt`` exactly."""
    return power_budget * float(backoff) ** int(attempt)
