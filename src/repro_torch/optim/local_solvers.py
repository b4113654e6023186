"""Local primal-step solvers for the ADMM subproblem (Eq. 6 / Eq. 20).

Every solver is called as

    local_solve(theta, lam, h, Theta, batch_idx) -> theta'   # all (W, d)

and minimises, per worker n (elementwise penalty weights from the channel),

    f_n(θ) + Σ_i Re{λ*_{n,i} h_{n,i}} θ_i + (ρ/2) Σ_i |h_{n,i}|² (θ_i − Θ_i)².

* :func:`exact_quadratic_solver` — closed form for f_n(θ)=‖y−Xθ‖² (the
  paper's linear-regression task); a batched d×d solve.
* :func:`prox_sgd_solver` / :func:`prox_adam_solver` — the stochastic
  variants (paper: 20 local Adam iterations, lr 0.01, batch 100).  With a
  ``batch_fn`` they take minibatches: ``draw_batches(gen)`` makes a round's
  ``(n_steps, W, B)`` indices and step ``s`` trains on ``batch_fn(idx[s])``.

Counterpart of ``repro/optim/local_solvers.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import cplx
from repro_torch.core.cplx import Complex
from repro_torch.core.transport import penalty_grad
from repro_torch.optim.optimizers import Optimizer

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ExactQuadraticSolver:
    """Closed-form primal for f_n(θ) = ‖y_n − X_n θ‖².

    Stationarity: 2XᵀXθ − 2Xᵀy + Re{λ*h} + ρ|h|²(θ−Θ) = 0
      ⇒ (2XᵀX + ρ diag(|h|²)) θ = 2Xᵀy − Re{λ*h} + ρ|h|²Θ.
    """

    XtX2: Tensor   # (W, d, d)
    Xty2: Tensor   # (W, d)
    rho: float

    def __call__(self, theta: Tensor, lam: Complex, h: Complex, Theta: Tensor,
                 batch_idx: Optional[Tensor] = None) -> Tensor:
        if batch_idx is not None:
            raise ValueError("the exact solver uses every sample; it takes "
                             "no minibatch indices")
        h2 = cplx.abs2(h)                                  # (W, d)
        mu = cplx.cmul_conj(h, lam).re                     # Re{λ* h}
        A = self.XtX2 + self.rho * torch.diag_embed(h2)    # (W, d, d)
        b = self.Xty2 - mu + self.rho * h2 * Theta[None, :]
        return torch.linalg.solve(A, b)


def exact_quadratic_solver(X: Tensor, y: Tensor,
                           rho: float) -> ExactQuadraticSolver:
    """X: (W, m, d), y: (W, m) — per-worker data shards."""
    return ExactQuadraticSolver(
        XtX2=2.0 * torch.einsum("wmi,wmj->wij", X, X),
        Xty2=2.0 * torch.einsum("wmi,wm->wi", X, y),
        rho=rho)


@dataclasses.dataclass(frozen=True)
class ProxSolver:
    """``n_steps`` of a first-order optimizer on the augmented local loss.

    ``loss_grad_fn(theta)`` (full batch) or, with ``batch_fn``,
    ``loss_grad_fn(theta, batch)`` gives ∂f per worker, (W, d)."""

    loss_grad_fn: Callable
    opt: Optimizer
    n_steps: int
    rho: float
    batch_fn: Optional[Callable] = None

    def draw_batches(self, gen: torch.Generator) -> Optional[Tensor]:
        if self.batch_fn is None:
            return None
        return self.batch_fn.draw(gen, self.n_steps)

    def __call__(self, theta: Tensor, lam: Complex, h: Complex, Theta: Tensor,
                 batch_idx: Optional[Tensor] = None) -> Tensor:
        if (batch_idx is None) != (self.batch_fn is None):
            raise ValueError("a solver with a batch_fn needs batch_idx, and "
                             "one without takes none")
        opt_state = self.opt.init(theta)
        for step in range(self.n_steps):
            if self.batch_fn is None:
                g_f = self.loss_grad_fn(theta)
            else:
                g_f = self.loss_grad_fn(theta, self.batch_fn(batch_idx[step]))
            g = g_f + penalty_grad(theta, lam, h, Theta, self.rho)
            theta, opt_state = self.opt.update(g, opt_state, theta)
        return theta


def prox_sgd_solver(loss_grad_fn: Callable, opt: Optimizer, n_steps: int,
                    rho: float) -> ProxSolver:
    """First-order approximate primal: n_steps of opt on f_n + penalty."""
    return ProxSolver(loss_grad_fn, opt, n_steps, rho)


def prox_adam_solver(loss_grad_fn: Callable, opt: Optimizer, n_steps: int,
                     rho: float, batch_fn=None) -> ProxSolver:
    """Paper's stochastic variant: local Adam steps with minibatch draws."""
    return ProxSolver(loss_grad_fn, opt, n_steps, rho, batch_fn)
