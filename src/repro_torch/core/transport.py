"""OTA transport layer, main-path half: the paper's analog signal path (Alg. 1:
modulate → power-scale → superpose → matched-filter → demodulate) on the
flat ``(W, d)`` problem.  Counterpart of ``repro/core/transport.py``.

The backend follows the tensors' device (:func:`resolve_backend`): CUDA
tensors go through the hand-written kernels (B1 ``ota_modulate``, B2
``ota_receive``, B8 ``ota_receive_masked``, B4 ``admm_dual_update``, B5
``admm_flip_lambda``), CPU tensors through their plain versions.  There is
no switch that sends CUDA tensors to the plain versions.

A participation ``mask`` ((W,) bool, ``repro_torch.phy`` deep-fade
truncation) drops workers from the round: a masked worker contributes
exactly zero to the superposition and the pilot sum (B8 never reads its
rows) and is left out of the min-α consensus.  ``h_tx`` is the channel the
workers precode with under imperfect CSI; the air applies ``h``.

All OTA arithmetic is f32 whatever the parameter dtype.  The round's random
planes are arguments (the matched-filter noise ``noise_re``), so a test can
replay the JAX package's draws.  The receiver only samples the real plane
(Θ = Re{y}/Σ|h|², Eq. 24), so only ``noise.re`` is ever passed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import cplx
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.cplx import Complex
from repro_torch.core.power import alpha_from_energy
from repro_torch.kernels import admm_update as _admm_k
from repro_torch.kernels import ota as _ota_k
from repro_torch.kernels import phy_channel as _phy_k
from repro_torch.kernels.build import BACKENDS, resolve_backend  # noqa: F401

Tensor = torch.Tensor


def _f32(x: Tensor) -> Tensor:
    return x.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Signal primitives
# ---------------------------------------------------------------------------

def modulate(theta: Tensor, lam: Complex, h: Complex, rho: float) -> Complex:
    """Worker TX signal s = h*·θ + λ*/ρ  (Alg. 1 line 14).  Shapes (W, d)."""
    s_re, s_im = _ota_k.ota_modulate(_f32(theta), _f32(lam.re), _f32(lam.im),
                                     _f32(h.re), _f32(h.im), rho)
    return Complex(s_re, s_im)


def demodulate(y_re: Tensor, sumh2: Tensor, noise_re: Tensor,
               inv_alpha: Tensor | float = 1.0) -> Tensor:
    """PS global update Θ = (y + z/α) / max(Σ|h|², 1e-12)  (Eq. 24), from an
    already superposed ``y``.  The main path never calls it (:func:`receive`
    fuses it into B2); its TPU kernel, B3 ``ota_demodulate_dyn``, is not
    ported yet, so CUDA tensors raise instead of running plain PyTorch."""
    if resolve_backend(y_re.device) == "cuda":
        raise NotImplementedError("demodulate on CUDA needs the B3 kernel "
                                  "(ota_demodulate_dyn), not ported yet")
    return (y_re + noise_re * inv_alpha) / torch.clamp_min(sumh2, 1e-12)


def receive(signals: Complex, h: Complex, noise_re: Tensor,
            inv_alpha: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Fused superpose → matched-filter → demodulate (B2; B8 with a
    ``mask``).  (W, d) -> (d,).

    ``noise_re`` is the real plane of this round's matched-filter noise
    ``CN(0, N0/T)`` (zeros on a noise-free link); ``inv_alpha`` a 0-d tensor.
    An all-masked round divides zero signal by the clamped zero pilot: the
    round driver keeps the previous Θ then.
    """
    planes = (_f32(signals.re), _f32(signals.im), _f32(h.re), _f32(h.im))
    if mask is None:
        return _ota_k.ota_receive(*planes, _f32(noise_re), _f32(inv_alpha))
    return _phy_k.ota_receive_masked(*planes, mask.to(torch.bool).contiguous(),
                                     _f32(noise_re), _f32(inv_alpha))


def dual_update(lam: Complex, h: Complex, theta: Tensor, Theta: Tensor,
                rho: float, noise_re: Optional[Tensor] = None) -> Complex:
    """Eq. (11): λ' = λ + ρ h (θ − Θ) − ρ Re{z} (B4).  Θ (d,) broadcasts over
    the worker dim; ``noise_re`` is a (W, d) plane under an analog downlink,
    else None."""
    ore, oim = _admm_k.admm_dual_update(
        _f32(lam.re), _f32(lam.im), _f32(h.re), _f32(h.im), _f32(theta),
        _f32(Theta), rho, None if noise_re is None else _f32(noise_re))
    return Complex(ore, oim)


def flip_lambda(grad_f: Tensor, theta: Tensor, Theta_prev: Tensor, h: Complex,
                rho: float) -> Complex:
    """Re-solve stationarity (Eq. 6) for λ when the channel changed (B5).

    Target: λ* h = t := −(∂f(θ) + ρ|h|²(θ − Θ^k)).  The minimum-norm complex
    solution is λ = t · h / |h|²  (then λ* h = t, real, exactly).
    """
    ore, oim = _admm_k.admm_flip_lambda(_f32(grad_f), _f32(theta),
                                        _f32(Theta_prev), _f32(h.re),
                                        _f32(h.im), rho)
    return Complex(ore, oim)


def penalty_grad(theta: Tensor, lam: Complex, h: Complex, Theta: Tensor,
                 rho: float) -> Tensor:
    """∇ of the augmented-Lagrangian terms added to f_n (prox local steps):
    Re{λ* h} + ρ|h|²(θ − Θ).  Returns theta's dtype."""
    mu = cplx.cmul_conj(h, lam).re  # Re{λ* h} == Re{h λ*}
    g = mu + rho * cplx.abs2(h) * (theta.float() - Theta.float())
    return g.to(theta.dtype)


# ---------------------------------------------------------------------------
# Power control (min-α protocol, paper Sec. 2)
# ---------------------------------------------------------------------------

def worker_energy(signals: Complex) -> Tensor:
    """Σ over all elements of |s|² per worker: (W, ...) -> (W,)."""
    e = cplx.abs2(signals)
    return e.reshape(e.shape[0], -1).sum(1)


def inv_alpha_from_energy(energy: Tensor, budget: float,
                          mask: Optional[Tensor] = None) -> Tensor:
    """1/α with α = min_n sqrt(P_budget / E_n) over the active workers, a
    0-d tensor.

    A zero-energy worker's α_n is +inf, so it never binds the min; a masked
    worker does not transmit and is left out (its α_n is +inf too).  If no
    worker binds, α = +inf and 1/α = 0 exactly (demodulate then adds no
    noise).
    """
    alphas = alpha_from_energy(energy, budget)
    if mask is not None:
        alphas = torch.where(mask, alphas, torch.full_like(alphas,
                                                           float("inf")))
    return 1.0 / torch.min(alphas)


def power_scale(signals: Complex, ccfg: ChannelConfig,
                mask: Optional[Tensor] = None) -> Tensor:
    """inv_alpha for a single-leaf uplink.  Budget: per-subcarrier power P
    × elements uploaded per worker."""
    d = signals.re.numel() // signals.re.shape[0]
    return inv_alpha_from_energy(worker_energy(signals),
                                 ccfg.transmit_power * d, mask=mask)


# ---------------------------------------------------------------------------
# The full uplink (Alg. 1, the "transport" entry point)
# ---------------------------------------------------------------------------

def ota_uplink(theta: Tensor, lam: Complex, h: Complex, noise_re: Tensor,
               rho: float, ccfg: ChannelConfig, *,
               power_control: bool = True, mask: Optional[Tensor] = None,
               h_tx: Optional[Complex] = None) -> Tuple[Tensor, Tensor]:
    """modulate → power-scale → superpose → matched-filter → demodulate.

    theta/lam/h: (W, d) worker-major; ``noise_re``: (d,) real plane of the
    round's matched-filter noise.  ``mask``: optional (W,) participation
    mask; ``h_tx``: the workers' CSI (None = perfect), which modulates while
    the air applies ``h``.  Energies are those of the unmasked signals.
    Returns (Theta (d,), inv_alpha 0-d), both on the device, with no host
    synchronisation.
    """
    signals = modulate(theta, lam, h if h_tx is None else h_tx, rho)
    if power_control:
        inv_alpha = power_scale(signals, ccfg, mask=mask)
    else:
        inv_alpha = torch.ones((), dtype=torch.float32, device=theta.device)
    return receive(signals, h, noise_re, inv_alpha, mask), inv_alpha
