"""Per-round cohort sampling from an N-worker population.

The phy scenario evolves the wireless state of all N workers, but each round
only a W-worker *cohort* transmits: its ``(θ, λ, h)`` rows are gathered into
the ordinary ``(W, d)`` buffers, the round runs at cohort width, and the
duals scatter back with the non-sampled ones frozen.  Counterpart of
``repro/core/cohort.py``.

Policies:

* ``uniform``  — W indices uniform without replacement (classic FL client
  sampling);
* ``top-gain`` — the W strongest channels by mean |h|²;
* ``prop-h2``  — W indices without replacement with probability ∝ mean
  |h|², by the Gumbel-top-k trick.

The draw is split from its use, as everywhere in the port:
:func:`draw_cohort` makes the round's random plane from the
:data:`COHORT_SALT` side branch of the round key (so sampling changes no draw
of the base schedule), and :func:`sample_cohort` turns it and the channel
weight into the indices deterministically, so a test can inject the JAX
package's draw.  ``uniform`` never reads the weight, so a sampled round
under it makes no (N, d) |h|² pass.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.core import cplx
from repro_torch.core.cplx import Complex

Tensor = torch.Tensor

#: ``fold_in`` salt of the per-round cohort draw (a side branch of the key)
COHORT_SALT = 0xC0407

POLICIES = ("uniform", "top-gain", "prop-h2")


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Which W of the N population transmit each round.  ``cohort ==
    population`` is the identity: nothing is drawn or gathered, and the
    round is the ordinary one bit for bit."""

    #: workers that exist (phy state and duals are this wide)
    population: int
    #: workers sampled a round (the uplink buffers are this wide)
    cohort: int
    #: one of :data:`POLICIES`
    policy: str = "uniform"

    def __post_init__(self):
        if not 0 < self.cohort <= self.population:
            raise ValueError(
                f"need 0 < cohort <= population, got cohort={self.cohort} "
                f"population={self.population}")
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown cohort policy {self.policy!r}; want one of "
                f"{POLICIES}")


def cohort_active(cfg: Optional[CohortConfig]) -> bool:
    """True when sampling subsets the population."""
    return cfg is not None and int(cfg.cohort) < int(cfg.population)


#: elements of h a :func:`channel_weight` pass squares at a time
WEIGHT_CHUNK = 1 << 26


def channel_weight(h: Complex) -> Tensor:
    """Per-worker scheduling weight: mean |h|² over the packed dim, (N,).
    Rows are squared a block at a time, so at an LLM's (N, D) the pass
    holds one row's |h|², not the whole plane's."""
    re = h.re.reshape(h.re.shape[0], -1)
    im = h.im.reshape(h.im.shape[0], -1)
    step = max(1, WEIGHT_CHUNK // max(1, re.shape[1]))
    return torch.cat([torch.mean(cplx.abs2(Complex(re[i:i + step],
                                                   im[i:i + step])), dim=-1)
                      for i in range(0, re.shape[0], step)])


def draw_cohort(key: int, cfg: CohortConfig, device) -> Optional[Tensor]:
    """The round's cohort plane from round key ``key``'s ``COHORT_SALT``
    branch: a permutation of the N workers (int64) for ``uniform``, a
    standard Gumbel (N,) f32 plane for ``prop-h2``, None for ``top-gain``
    (deterministic)."""
    gen = rng.generator(rng.fold_in(key, COHORT_SALT), device)
    n = int(cfg.population)
    if cfg.policy == "uniform":
        return torch.randperm(n, generator=gen, device=device)
    if cfg.policy == "prop-h2":
        u = torch.rand(n, generator=gen, device=device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    return None


def sample_cohort(cfg: CohortConfig, draw: Optional[Tensor],
                  weight: Optional[Tensor] = None) -> Tensor:
    """The round's cohort: (W,) int64 indices into the N population, from
    the :func:`draw_cohort` plane ``draw`` and, for the channel-aware
    policies, the (N,) :func:`channel_weight`.  The strongest come first
    under ``top-gain`` and ``prop-h2``, as ``lax.top_k`` orders them."""
    w = int(cfg.cohort)
    if cfg.policy == "uniform":
        if draw is None:
            raise ValueError("cohort policy 'uniform' needs the drawn "
                             "permutation")
        return draw[:w].to(torch.int64)
    if weight is None:
        raise ValueError(
            f"cohort policy {cfg.policy!r} needs the (N,) channel weight")
    wt = weight.to(torch.float32)
    if cfg.policy == "top-gain":
        return torch.topk(wt, w).indices
    if draw is None:
        raise ValueError("cohort policy 'prop-h2' needs the drawn Gumbel "
                         "plane")
    # Gumbel-top-k: w indices without replacement, inclusion ∝ weight
    return torch.topk(torch.log(torch.clamp_min(wt, 1e-30)) + draw, w).indices


def take_rows(x, idx: Tensor):
    """Gather worker rows of a (N, ...) tensor or Complex; None and 0-d
    values (scalar fault flags, the burst std) pass through."""
    if x is None:
        return None
    if isinstance(x, Complex):
        return Complex(x.re[idx], x.im[idx])
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x[idx]


def put_rows(full, idx: Tensor, rows):
    """A copy of the (N, ...) buffer with the cohort's rows scattered in;
    the other rows keep their values (the frozen-dual semantics)."""
    if full is None:
        return None
    if isinstance(full, Complex):
        return Complex(put_rows(full.re, idx, rows.re),
                       put_rows(full.im, idx, rows.im))
    out = full.clone()
    out[idx] = rows.to(full.dtype)
    return out


def cohort_metrics(cfg: CohortConfig) -> dict:
    """The ``obs/`` keys a sampled round contributes (static per config)."""
    return {"obs/cohort_size": float(cfg.cohort),
            "obs/population_sampled_frac":
            float(cfg.cohort) / float(cfg.population)}
