"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function is the mathematical definition, written with no regard for
the card: the CPU tests hold them against the JAX package, ``chip_smoke.py``
holds each CUDA kernel against them on the card, and the kernel wrappers
take them for CPU tensors only.  Counterpart of ``repro/kernels/ref.py``,
plus a plain receive, masked receive, one-pass round, fading step,
population step and worker-at-a-time accumulate, which the JAX oracle file
does not have (the one-pass round's and the accumulate's oracle there is
``repro/core/transport.py``'s jnp path), the flash-attention forward with
its log-sum-exp residual, and the linear scan's backward.
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
    return ota_demodulate(y, noise_re, p2, inv_alpha)


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


def ota_demodulate(y_re: Tensor, noise_re: Tensor, sumh2: Tensor,
                   inv_alpha: Tensor | float) -> Tensor:
    """Θ = (y + z·α⁻¹) / max(Σ|h|², 1e-12) over (d,) planes (Eq. 24), the
    last step of :func:`ota_receive`."""
    return (y_re + noise_re * inv_alpha) / torch.clamp_min(sumh2, 1e-12)


#: B3 reads α⁻¹ on the device, B3′ takes a host float: one function
ota_demodulate_dyn = ota_demodulate


def ota_accumulate(y_re: Tensor, sumh2: Tensor, s_re: Tensor, s_im: Tensor,
                   h_re: Tensor, h_im: Tensor) -> Tuple[Tensor, Tensor]:
    """One worker's term added to the running receiver sums (B13):
    y += Re{h ⊙ s} = h_re·s_re − h_im·s_im and Σ|h|² += h_re² + h_im², in
    ``repro/core/transport.py``'s ``ota_accumulate`` order (the term first,
    then the add)."""
    return (y_re + (h_re * s_re - h_im * s_im),
            sumh2 + (h_re * h_re + h_im * h_im))


def ota_round_stats(theta: Tensor, lam_re: Tensor, lam_im: Tensor,
                    h_re: Tensor, h_im: Tensor, rho: float,
                    mask: Optional[Tensor] = None,
                    htx: Optional[Tuple[Tensor, Tensor]] = None,
                    chan: Optional[tuple] = None) -> Tuple[Tensor, ...]:
    """One pass of the round over (W, d) planes: [AR(1) step of h] →
    modulate with ``htx`` (else the channel) → per-worker energy of the
    unmasked signal → ``where``-mask → y = Re{Σ_w h⊙s}, p2 = Σ_w |h|².

    ``chan = (w_re, w_im, rho_f, scale, redraw)``.  Returns ``(y, p2,
    energy)``, plus the stepped channel's planes with ``chan``.  The same
    expressions as :func:`ota_modulate`, the composed path's energy and
    :func:`ota_receive_masked`, so the fused round equals the composed one
    bit for bit."""
    if chan is not None:
        w_re, w_im, rho_f, scale, redraw = chan
        h_re, h_im = fading_step(h_re, h_im, w_re, w_im, rho_f, scale, redraw)
    tx_re, tx_im = (h_re, h_im) if htx is None else htx
    s_re, s_im = ota_modulate(theta, lam_re, lam_im, tx_re, tx_im, rho)
    e = s_re * s_re + s_im * s_im
    energy = e.reshape(e.shape[0], -1).sum(1)
    hm_re, hm_im = h_re, h_im
    if mask is not None:
        active = mask[:, None]
        zero = torch.zeros((), dtype=s_re.dtype, device=s_re.device)
        s_re, s_im, hm_re, hm_im = (torch.where(active, x, zero)
                                    for x in (s_re, s_im, h_re, h_im))
    y = (hm_re * s_re - hm_im * s_im).sum(0)
    p2 = (hm_re * hm_re + hm_im * hm_im).sum(0)
    out = (y, p2, energy)
    return out if chan is None else out + (h_re, h_im)


def ota_round_theta(theta: Tensor, lam_re: Tensor, lam_im: Tensor,
                    h_re: Tensor, h_im: Tensor, noise_re: Tensor,
                    inv_alpha: Tensor | float, rho: float,
                    mask: Optional[Tensor] = None,
                    htx: Optional[Tuple[Tensor, Tensor]] = None,
                    chan: Optional[tuple] = None) -> Tuple[Tensor, ...]:
    """:func:`ota_round_stats` with the demodulate epilogue: returns
    ``(Theta,)``, plus the stepped channel's planes with ``chan``."""
    out = ota_round_stats(theta, lam_re, lam_im, h_re, h_im, rho, mask=mask,
                          htx=htx, chan=chan)
    return (ota_demodulate(out[0], noise_re, out[1], inv_alpha),) + out[3:]


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


#: the masked score of the attention kernels (the TPU kernel's NEG_INF)
NEG_INF = -1e30


def _attention_scores(q: Tensor, k: Tensor, causal: bool,
                      scale: float) -> Tensor:
    """Masked f32 scores of q (B,H,S,hd) against k (B,H,T,hd)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        S, T = s.shape[-2:]
        rows = torch.arange(S, device=s.device)[:, None]
        mask = torch.arange(T, device=s.device)[None, :] <= rows
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    return s


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Exact softmax attention in f32: ``(o, lse)`` with o in q's dtype and
    the f32 residual lse = m + log(max(l, 1e-30)) per query row (m the row
    max of the masked scores, l the sum of exp(s − m)).  q (B,H,S,hd), k/v
    (B,H,T,hd); causal masks col > row."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    s = _attention_scores(q, k, causal, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    lc = torch.clamp_min(p.sum(dim=-1), 1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / lc[..., None]
    return o.to(q.dtype), m + torch.log(lc)


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        lse: Optional[Tensor] = None,
                        delta: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Closed-form backward of :func:`flash_attention_fwd` in the residual
    form of ``repro/kernels/ref.py`` ``attention_vjp``: p, δ = Σ_d do∘o,
    ds = p∘(dp − δ), f32 accumulation, cotangents in the primal dtypes.

    With the forward's residuals, as the kernels take them, p =
    exp(s − lse) (0 where masked) and ``delta`` is δ; without them p is the
    softmax and δ comes from o recomputed in f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = _attention_scores(q, k, causal, scale)
    p = (torch.softmax(s, dim=-1) if lse is None
         else torch.exp(s - lse[..., None]))
    del s
    if delta is None:
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        delta = torch.sum(dof * o, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """Gated linear recurrence h_t = a_t ⊙ h_{t−1} + b_t, h_0 = b_0, over
    axis 1 of (B, S, D), in f32.

    A loop over S: each step rounds the product, then the sum, as the B12
    kernel does, so the two agree bit for bit.  The JAX package's oracle is
    an associative scan, whose products of gates are grouped differently:
    the two agree to float tolerance only."""
    a, b = a.float(), b.float()
    h = torch.empty_like(b)
    h[:, 0] = b[:, 0]
    for t in range(1, b.shape[1]):
        h[:, t] = a[:, t] * h[:, t - 1] + b[:, t]
    return h


def linear_scan_bwd(a: Tensor, h: Tensor, dh: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Cotangents ``(da, db)`` of :func:`linear_scan` from its gates ``a``,
    its output ``h`` and the output's cotangent ``dh``: the reversed
    recurrence g_t = dh_t + a_{t+1}·g_{t+1} (g_{S−1} = dh_{S−1}), then
    da_t = g_t·h_{t−1} with h_{−1} = 0, and db = g (f32).  A loop over S in
    the B12 backward kernel's rounding order."""
    a, h, dh = a.float(), h.float(), dh.float()
    g = torch.empty_like(dh)
    S = dh.shape[1]
    g[:, S - 1] = dh[:, S - 1]
    for t in range(S - 2, -1, -1):
        g[:, t] = dh[:, t] + a[:, t + 1] * g[:, t + 1]
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g
