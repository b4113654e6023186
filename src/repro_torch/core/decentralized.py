"""Decentralized analog GADMM: the paper's §6 "Decentralized Architecture"
extension, on the authors' GADMM chain topology [ref 28, JMLR'20].
Counterpart of ``repro/core/decentralized.py``.

No parameter server: workers form a chain θ_1 — θ_2 — ... — θ_N with edge
constraints θ_n = θ_{n+1}.  Even-ranked *heads* update first given their
neighbours' models, odd-ranked *tails* respond, duals live on edges.
Wireless realisation: all head→tail transmissions share the same
subcarriers at once (spatial reuse: each link is short-range), so one round
costs **2 analog slot groups whatever N is**, with per-link Rayleigh fading
equalised at the receiver, which knows its channel (point-to-point links:
A-FADMM's privacy by superposition does not apply here).

Keys are integers (``repro_torch.rng``); the device is that of θ.  Each
half-round's link draws a Rayleigh h and AWGN z of θ's shape; ``round``
takes them ready-made as a :class:`GadmmDraws` (``draws=``), so a test can
replay the JAX package's planes.  The round runs no OTA kernel: the links
are elementwise and the local solve is a batched d × d solve
(:func:`gadmm_quadratic_solver`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core import cplx
from repro_torch.core.aggregators import ScanRounds
from repro_torch.core.channel import ChannelConfig, awgn, rayleigh
from repro_torch.core.cplx import Complex
from repro_torch.core.subcarrier import SubcarrierPlan

Tensor = torch.Tensor


class GadmmState(NamedTuple):
    theta: Tensor   # (W, d)
    lam: Tensor     # (W-1, d): the dual of chain edge (n, n+1) at row n
    step: int


class GadmmDraws(NamedTuple):
    """A round's link planes, each of θ's shape: the heads' receptions
    (``h1``, ``z1``) and the tails' (``h2``, ``z2``).  All None on a
    noise-free link, which draws nothing."""

    h1: Optional[Complex]
    z1: Optional[Complex]
    h2: Optional[Complex]
    z2: Optional[Complex]


@dataclasses.dataclass(frozen=True)
class AnalogGadmm(ScanRounds):
    """Decentralized chain ADMM with analog neighbour links.

    ``mask`` (optional, (W,) bool) is the participation mask shared with
    the PS-side algorithms: a dead worker degrades to a **pass-through
    hop**, its alive neighbours splice together into a shorter chain
    (nearest-alive gathers) instead of the dead row poisoning both
    adjacent edges.  The dead worker's model freezes and edges with a dead
    endpoint zero their dual.  ``mask=None`` is the unmasked round."""

    ccfg: ChannelConfig
    plan: SubcarrierPlan
    rho: float = 0.5
    mask: Optional[Tensor] = None

    name = "analog_gadmm"

    def init(self, key: int, theta0: Tensor) -> GadmmState:
        W, d = theta0.shape
        return GadmmState(theta=theta0,
                          lam=torch.zeros((W - 1, d), dtype=theta0.dtype,
                                          device=theta0.device),
                          step=0)

    def draw(self, key: int, st: GadmmState) -> GadmmDraws:
        """Round key ``key``'s planes: the first half's link from the first
        half of the key, the second's from the second, each link's h from
        its key's first half and z from its second (as JAX's
        ``_noisy_link``)."""
        if not self.ccfg.noisy:
            return GadmmDraws(None, None, None, None)
        shape, dev = st.theta.shape, st.theta.device
        planes = []
        for k in rng.split(key):
            kh, kz = rng.split(k)
            planes += [rayleigh(rng.generator(kh, dev), shape),
                       awgn(rng.generator(kz, dev), shape,
                            self.ccfg.noise_var_matched)]
        return GadmmDraws(*planes)

    def _noisy_link(self, x: Tensor, h: Optional[Complex],
                    z: Optional[Complex]) -> Tensor:
        """Point-to-point analog link: fade, add AWGN, equalise at the
        receiver, which knows h (local pilot): y = (h x + z) conj(h)/|h|²."""
        if not self.ccfg.noisy:
            return x
        hx = cplx.scale(h, x)
        y = cplx.cmul_conj(Complex(hx.re + z.re, hx.im + z.im), h)
        return y.re / torch.clamp(cplx.abs2(h), min=1e-12)

    def round(self, key: int, st: GadmmState,
              quad_solve_neighbors: Callable, grad_fn: Optional[Callable],
              draws: Optional[GadmmDraws] = None
              ) -> Tuple[GadmmState, dict]:
        """quad_solve_neighbors(theta, left, right, lam_l, lam_r, n_nbrs)
        -> theta' minimises f_n + the edge penalties (see
        :func:`gadmm_quadratic_solver`)."""
        del grad_fn
        if draws is None:
            draws = self.draw(key, st)
        if self.mask is not None:
            return self._round_masked(st, quad_solve_neighbors, draws)
        W, d = st.theta.shape
        rho = self.rho
        dev = st.theta.device
        zero = torch.zeros((1, d), dtype=st.theta.dtype, device=dev)
        lam_l = torch.cat([zero, st.lam], 0)      # λ_{n-1}
        lam_r = torch.cat([st.lam, zero], 0)      # λ_n

        def neighbours(theta: Tensor) -> Tuple[Tensor, Tensor]:
            """Left and right neighbour models, zero-padded at the ends."""
            return (torch.cat([zero, theta[:-1]], 0),
                    torch.cat([theta[1:], zero], 0))

        idx = torch.arange(W, device=dev)
        n_nbrs = torch.where((idx == 0) | (idx == W - 1), 1.0, 2.0)
        is_head = (idx % 2 == 0)[:, None]

        # heads (even rows) update on noisy neighbour receptions
        left, right = neighbours(self._noisy_link(st.theta, draws.h1,
                                                  draws.z1))
        theta_heads = quad_solve_neighbors(st.theta, left, right, lam_l,
                                           lam_r, n_nbrs)
        theta_mid = torch.where(is_head, theta_heads, st.theta)

        # tails respond
        left, right = neighbours(self._noisy_link(theta_mid, draws.h2,
                                                  draws.z2))
        theta_tails = quad_solve_neighbors(theta_mid, left, right, lam_l,
                                           lam_r, n_nbrs)
        theta_new = torch.where(is_head, theta_mid, theta_tails)

        # edge duals
        diffs = theta_new[:-1] - theta_new[1:]
        lam_new = st.lam + rho * diffs
        metrics = {
            "consensus_gap": torch.sqrt(torch.mean(diffs ** 2)),
            # spatial reuse: 2 half-rounds × n_slots, independent of N
            "channel_uses": 2.0 * self.plan.n_slots,
        }
        return GadmmState(theta=theta_new, lam=lam_new,
                          step=st.step + 1), metrics

    def _round_masked(self, st: GadmmState, quad_solve_neighbors: Callable,
                      draws: GadmmDraws) -> Tuple[GadmmState, dict]:
        """Masked round: dead workers become pass-through hops.

        Nearest-alive gathers (an exclusive cummax from the left, a
        reversed cummin from the right) splice each alive worker to its
        closest alive neighbours; head/tail parity is the worker's RANK
        among the alive, so the masked chain is the compacted (alive-only)
        chain elementwise.  The dual of edge (u, v) lives at row u (its
        left endpoint); edges with a dead endpoint are zeroed, dead
        workers' models freeze."""
        W, d = st.theta.shape
        rho = self.rho
        dev = st.theta.device
        alive = self.mask.to(device=dev, dtype=torch.bool)
        idx = torch.arange(W, device=dev)
        zero = torch.zeros((), dtype=st.theta.dtype, device=dev)

        # nearest alive strictly left / right of each worker
        left_of = torch.cummax(torch.where(alive, idx, -1), 0).values
        l = torch.cat([idx.new_full((1,), -1), left_of[:-1]])
        right_of = torch.cummin(torch.where(alive, idx, W).flip(0),
                                0).values.flip(0)
        r = torch.cat([right_of[1:], idx.new_full((1,), W)])
        has_l, has_r = (l >= 0)[:, None], (r < W)[:, None]
        lc, rc = l.clamp(0, W - 1), r.clamp(0, W - 1)
        n_nbrs = torch.clamp(has_l[:, 0].float() + has_r[:, 0].float(),
                             min=1.0)
        pos = torch.cumsum(alive.to(torch.int32), 0) - 1  # rank among alive
        is_head = (alive & (pos % 2 == 0))[:, None]
        is_tail = (alive & (pos % 2 == 1))[:, None]
        lam_pad = torch.cat([st.lam, torch.zeros((1, d), dtype=st.lam.dtype,
                                                 device=dev)], 0)
        lam_l = torch.where(has_l, lam_pad[lc], zero)   # edge (l_n, n)
        lam_r = torch.where(has_r, lam_pad, zero)       # edge (n, r_n)

        def neighbours(theta_rx: Tensor) -> Tuple[Tensor, Tensor]:
            return (torch.where(has_l, theta_rx[lc], zero),
                    torch.where(has_r, theta_rx[rc], zero))

        # heads (even rank) update on noisy neighbour receptions
        left, right = neighbours(self._noisy_link(st.theta, draws.h1,
                                                  draws.z1))
        theta_heads = quad_solve_neighbors(st.theta, left, right, lam_l,
                                           lam_r, n_nbrs)
        theta_mid = torch.where(is_head, theta_heads, st.theta)

        # tails respond
        left, right = neighbours(self._noisy_link(theta_mid, draws.h2,
                                                  draws.z2))
        theta_tails = quad_solve_neighbors(theta_mid, left, right, lam_l,
                                           lam_r, n_nbrs)
        theta_new = torch.where(is_tail, theta_tails, theta_mid)

        # edge duals: row n holds edge (n, r_n); a dead endpoint zeroes it
        valid_e = (alive & (r < W))[:W - 1, None]
        diffs = theta_new[:W - 1] - theta_new[rc[:W - 1]]
        lam_new = torch.where(valid_e, st.lam + rho * diffs, zero)

        n_edges = torch.clamp(valid_e.float().sum(), min=1.0)
        metrics = {
            "consensus_gap": torch.sqrt(
                torch.where(valid_e, diffs ** 2, zero).sum()
                / (n_edges * d)),
            "channel_uses": 2.0 * self.plan.n_slots,
            "gadmm_alive": alive.float().sum(),
        }
        return GadmmState(theta=theta_new, lam=lam_new,
                          step=st.step + 1), metrics

    def global_model(self, st: GadmmState) -> Tensor:
        """The mean of the alive workers' models."""
        if self.mask is None:
            return st.theta.mean(0)
        alive = self.mask.to(device=st.theta.device, dtype=torch.bool)
        kept = torch.where(alive[:, None], st.theta,
                           torch.zeros((), dtype=st.theta.dtype,
                                       device=st.theta.device))
        return kept.sum(0) / torch.clamp(alive.float().sum(), min=1.0)


@dataclasses.dataclass(frozen=True)
class GadmmQuadraticSolver:
    """Closed-form head/tail update for f_n(θ) = ‖y − Xθ‖² on the chain.

    argmin f_n + λ_{n-1}ᵀ(left − θ) + λ_nᵀ(θ − right)
              + ρ/2 (‖left − θ‖² + ‖θ − right‖²)
    ⇒ (2XᵀX + n_nbrs·ρ I) θ = 2Xᵀy + λ_{n-1} − λ_n + ρ(left + right).
    Chain ends contribute a single neighbour (the zero-padded side drops
    out: its λ and neighbour are zero and n_nbrs is 1).
    """

    XtX2: Tensor   # (W, d, d)
    Xty2: Tensor   # (W, d)
    rho: float

    def __call__(self, theta: Tensor, left: Tensor, right: Tensor,
                 lam_l: Tensor, lam_r: Tensor, n_nbrs: Tensor) -> Tensor:
        d = self.XtX2.shape[-1]
        eye = torch.eye(d, dtype=self.XtX2.dtype, device=self.XtX2.device)
        A = self.XtX2 + self.rho * n_nbrs[:, None, None] * eye[None]
        b = self.Xty2 + lam_l - lam_r + self.rho * (left + right)
        return torch.linalg.solve(A, b)


def gadmm_quadratic_solver(X: Tensor, y: Tensor,
                           rho: float) -> GadmmQuadraticSolver:
    """:class:`GadmmQuadraticSolver` of X (W, m, d) and y (W, m): XᵀX and
    Xᵀy are formed once."""
    return GadmmQuadraticSolver(
        XtX2=2.0 * torch.einsum("wmi,wmj->wij", X, X),
        Xty2=2.0 * torch.einsum("wmi,wm->wi", X, y), rho=rho)
