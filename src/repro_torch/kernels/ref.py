"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function is the mathematical definition, written with no regard for
the card: the CPU tests hold them against the JAX package, ``chip_smoke.py``
holds each CUDA kernel against them on the card, and the kernel wrappers
take them for CPU tensors only.  Counterpart of ``repro/kernels/ref.py``,
plus a plain receive, masked receive, fading step and population step,
which the JAX oracle file does not have.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def ota_modulate(theta: Tensor, lam_re: Tensor, lam_im: Tensor, h_re: Tensor,
                 h_im: Tensor, rho: float) -> Tuple[Tensor, Tensor]:
    """s = conj(h)·θ + conj(λ)/ρ  (Alg. 1 l.14), in (re, im) planes.
    Multiplies by 1/ρ, as the kernels do."""
    inv_rho = 1.0 / rho
    t = theta.float()
    return h_re * t + lam_re * inv_rho, -h_im * t - lam_im * inv_rho


def ota_receive(s_re: Tensor, s_im: Tensor, h_re: Tensor, h_im: Tensor,
                noise_re: Tensor, inv_alpha: Tensor | float) -> Tensor:
    """Θ = (Σ_w Re{h_w ⊙ s_w} + z·α⁻¹) / max(Σ_w |h_w|², 1e-12)  (Eq. 24).
    s/h: (W, d); noise_re: (d,); returns (d,)."""
    y = (h_re * s_re - h_im * s_im).sum(0)
    p2 = (h_re * h_re + h_im * h_im).sum(0)
    return (y + noise_re * inv_alpha) / torch.clamp_min(p2, 1e-12)


def ota_receive_masked(s_re: Tensor, s_im: Tensor, h_re: Tensor,
                       h_im: Tensor, mask: Tensor, noise_re: Tensor,
                       inv_alpha: Tensor | float) -> Tensor:
    """:func:`ota_receive` over the active workers only: a worker with
    ``mask`` (W,) False contributes exactly zero to the superposition and
    the pilot sum, whatever its planes hold.  Its rows are zeroed by
    ``where``, never by a product: NaN·0 is NaN."""
    active = mask[:, None]
    zero = torch.zeros((), dtype=s_re.dtype, device=s_re.device)
    return ota_receive(*(torch.where(active, x, zero)
                         for x in (s_re, s_im, h_re, h_im)),
                       noise_re, inv_alpha)


def fading_step(h_re: Tensor, h_im: Tensor, w_re: Tensor, w_im: Tensor,
                rho: float, scale: float, redraw: bool
                ) -> Tuple[Tensor, Tensor]:
    """AR(1) fading update h' = ρ·h + s·w where ``redraw``, else h."""
    if not redraw:
        return h_re.clone(), h_im.clone()
    return rho * h_re + scale * w_re, rho * h_im + scale * w_im


def population_step(h_re: Tensor, h_im: Tensor, w_re: Tensor, w_im: Tensor,
                    pos_x: Tensor, pos_y: Tensor, dest_x: Tensor,
                    dest_y: Tensor, fresh_x: Tensor, fresh_y: Tensor,
                    shadow: Tensor, shadow_fresh: Tensor, rho: float,
                    scale: float, redraw: bool, step: float, ref_d: float,
                    norm_d: float, pexp: float, shadow_redraw: bool
                    ) -> Tuple[Tensor, ...]:
    """One population slot over flat (N,) planes: AR(1) fading, a
    random-waypoint move, the shadowing redraw on arrival, and the path gain
    at the new position as exp(pexp·log(norm_d/max(|pos'|, ref_d)))·shadow'
    (the kernels' form).  Returns (h_re', h_im', pos_x', pos_y', dest_x',
    dest_y', shadow', gain)."""
    hre, him = fading_step(h_re, h_im, w_re, w_im, rho, scale, redraw)
    ddx, ddy = dest_x - pos_x, dest_y - pos_y
    dist = torch.sqrt(ddx * ddx + ddy * ddy)
    arrived = dist <= step
    denom = torch.clamp_min(dist, 1e-9)
    px = torch.where(arrived, dest_x, pos_x + step * (ddx / denom))
    py = torch.where(arrived, dest_y, pos_y + step * (ddy / denom))
    dx = torch.where(arrived, fresh_x, dest_x)
    dy = torch.where(arrived, fresh_y, dest_y)
    sh = torch.where(arrived & bool(shadow_redraw), shadow_fresh, shadow)
    r = torch.clamp_min(torch.sqrt(px * px + py * py), ref_d)
    gain = torch.exp(pexp * torch.log(norm_d / r)) * sh
    return hre, him, px, py, dx, dy, sh, gain


def admm_dual_update(lam_re: Tensor, lam_im: Tensor, h_re: Tensor,
                     h_im: Tensor, theta: Tensor, Theta: Tensor, rho: float,
                     noise_re: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """λ' = λ + ρ·h·(θ − Θ) − ρ·Re{z}  (Eq. 11).  Θ (d,) broadcasts over the
    (W, d) planes; ``noise_re`` is a (W, d) plane or None (no noise)."""
    r = theta.float() - Theta.float()
    z = 0.0 if noise_re is None else noise_re
    return lam_re + rho * (h_re * r - z), lam_im + rho * h_im * r


def admm_flip_lambda(grad: Tensor, theta: Tensor, Theta_prev: Tensor,
                     h_re: Tensor, h_im: Tensor, rho: float
                     ) -> Tuple[Tensor, Tensor]:
    """λ = t·h/max(|h|², 1e-12), t = −(∂f + ρ|h|²(θ − Θ))  (Sec. 2 flip
    rule).  Θ (d,) broadcasts over the (W, d) planes."""
    h2 = h_re * h_re + h_im * h_im
    t = -(grad.float() + rho * h2 * (theta.float() - Theta_prev.float()))
    s = t / torch.clamp_min(h2, 1e-12)
    return h_re * s, h_im * s
