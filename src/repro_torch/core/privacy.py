"""Privacy attack harness: Theorems 2 and 3 and Definition 1, executable.
Counterpart of ``repro/core/privacy.py``.

The paper's privacy argument counts equations: at every iteration, the
honest-but-curious PS (or any eavesdropper of the global-model trajectory)
must solve an inverse problem with more unknowns than equations, so no
local model θ_{n,i} or gradient ∂f_n can be uniquely derived
(Definition 1).

* :func:`eavesdropper_view` — what the PS observes in one A-FADMM round:
  the workers' signals (``transport.modulate``, B1 on the card) through the
  air's both complex planes (``transport.superpose``);
* :func:`underdetermination` — unknowns − equations for the A-FADMM inverse
  problem at a given round (Thm 2's counting);
* :func:`construct_ambiguity` — a *constructive* refutation of uniqueness:
  from one true (θ, λ, h) consistent with the PS's observation, a second,
  distinct (θ', λ', h) that produces the same observation;
* :func:`observation_gap` and :func:`model_inversion_attack` — how far
  apart two observations are, and the PS's best guess of one worker's θ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core import transport
from repro_torch.core.cplx import Complex

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EavesdropperView:
    """What the PS can record in one A-FADMM round."""

    y: Complex          # aggregate received signal Σ h s            (d,)
    sumh2: Tensor       # pilot aggregate Σ|h|²                      (d,)
    Theta_prev: Tensor  # global model it broadcast last round       (d,)
    Theta_new: Tensor   # global model it computes now               (d,)


def eavesdropper_view(theta: Tensor, lam: Complex, h: Complex, rho: float,
                      Theta_prev: Tensor, Theta_new: Tensor
                      ) -> EavesdropperView:
    """The PS's observation of workers (θ, λ, h), all (W, d)."""
    y, sumh2 = transport.superpose(transport.modulate(theta, lam, h, rho), h)
    return EavesdropperView(y=y, sumh2=sumh2, Theta_prev=Theta_prev,
                            Theta_new=Theta_new)


def underdetermination(n_workers: int, per_element: bool = True
                       ) -> Dict[str, int]:
    """Thm 2 equation counting for one element i and one worker n.

    Observations give E = 2 usable equations (the primal stationarity
    relation and the global-update relation).  Unknowns per (n, i):
    h¹_{n,i}, λ⁰_{n,i}, ∇_i f_n(θ¹), Σ_{m≠n}|h|²θ_m, θ⁰_{n,i} → V = 5 > E = 2.
    """
    return {"equations": 2, "unknowns": 5, "slack": 3}


def construct_ambiguity(key: int, theta: Tensor, lam: Complex, h: Complex,
                        rho: float, delta: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Complex, Complex]:
    """A second witness (θ', λ', h) with the *same* PS observation.

    The PS observes, per element i:  y_i = Σ_n (|h_{n,i}|² θ_{n,i} +
    h_{n,i} λ*_{n,i}/ρ)  and  p_i = Σ_n |h_{n,i}|².  Every worker can trade
    primal mass against its own dual:

        θ'_n = θ_n + δ_n ,   λ'_n = λ_n − ρ δ_n h_n

    so that |h|²θ' + hλ'*/ρ = |h|²θ + |h|²δ + hλ*/ρ − |h|²δ: each worker's
    contribution, and so the observation, is unchanged.  δ ~ N(0, 1) of θ's
    shape is drawn from ``key`` on θ's device, or passed in as ``delta``.
    Returns (θ', λ', h) with θ' ≠ θ and the same h.
    """
    if delta is None:
        delta = torch.randn(theta.shape, dtype=theta.dtype,
                            generator=rng.generator(key, theta.device),
                            device=theta.device)
    lam2 = Complex(lam.re - rho * delta * h.re, lam.im - rho * delta * h.im)
    return theta + delta, lam2, h


def observation_gap(view_a: EavesdropperView,
                    view_b: EavesdropperView) -> Tensor:
    """Max elementwise distance between two PS observations (a 0-d
    tensor)."""
    return torch.maximum(
        torch.max(torch.abs(view_a.y.re - view_b.y.re)),
        torch.maximum(torch.max(torch.abs(view_a.y.im - view_b.y.im)),
                      torch.max(torch.abs(view_a.sumh2 - view_b.sumh2))))


def model_inversion_attack(view: EavesdropperView, n_workers: int,
                           rho: float, key: int,
                           ridge: float = 1e-6) -> Tensor:
    """Best-effort PS attack: a least-squares guess of one worker's θ.

    Without h or λ the PS's minimum-variance estimate of θ_{n,i}
    degenerates to Θ_i itself (the aggregate mean), which is returned, so
    a caller can measure the reconstruction error against the digital
    baseline's (where θ_n is received verbatim and the error is 0).
    """
    del n_workers, rho, key, ridge
    return view.Theta_new
