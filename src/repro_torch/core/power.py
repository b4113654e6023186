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
