"""OTA transport layer: the paper's analog signal path (Alg. 1: modulate →
power-scale → superpose → matched-filter → demodulate) on the flat ``(W, d)``
problem, composed (:func:`ota_uplink`) or in one pass over the worker planes
(:func:`ota_round_fused`).  Counterpart of ``repro/core/transport.py``.

The backend follows the tensors' device (:func:`resolve_backend`): CUDA
tensors go through the hand-written kernels (B1 ``ota_modulate``, B2
``ota_receive``, B3/B3′ ``ota_demodulate(_dyn)``, B6/B7 ``ota_round_stats``/
``ota_round_theta``, B8 ``ota_receive_masked``, B13 ``ota_accumulate``, B4
``admm_dual_update``, B5 ``admm_flip_lambda``), CPU tensors through their
plain versions.  There is no switch that sends CUDA tensors to the plain
versions.

A participation ``mask`` ((W,) bool, ``repro_torch.phy`` deep-fade
truncation or ``repro_torch.faults`` liveness) drops workers from the
round: a masked worker contributes exactly zero to the superposition and
the pilot sum and is left out of the min-α consensus.  ``h_tx`` is the
channel the workers precode with under imperfect CSI; the air applies
``h``.

All OTA arithmetic is f32 whatever the parameter dtype.  The round's random
planes are arguments (the matched-filter noise ``noise_re``, the fading
innovations of a fused channel step), so a test can replay the JAX
package's draws.  The receiver only samples the real plane (Θ =
Re{y}/Σ|h|², Eq. 24), so only ``noise.re`` is ever passed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import math

import torch

from repro_torch.core import cplx
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.cplx import Complex
from repro_torch.core.power import alpha_from_energy
from repro_torch.device import resolve_device
from repro_torch.kernels import admm_update as _admm_k
from repro_torch.kernels import ota as _ota_k
from repro_torch.kernels import ota_round as _round_k
from repro_torch.kernels import phy_channel as _phy_k
from repro_torch.kernels.build import BACKENDS, resolve_backend  # noqa: F401

Tensor = torch.Tensor


def check_backend_choice(backend: Optional[str]) -> None:
    """The JAX package's OTA backend switch (``backend=``,
    ``REPRO_OTA_BACKEND``, ``FLConfig.transport_backend``) as the port reads
    it: None or ``"pallas"`` is the route the port always takes, the
    hand-written kernels on CUDA tensors and their plain versions on CPU
    tensors.  ``"jnp"`` asked JAX for its plain versions on any device; the
    port keeps those for its tests and never sends CUDA tensors to them, so
    it refuses ``"jnp"``."""
    if backend in (None, "pallas"):
        return
    if backend == "jnp":
        raise ValueError(
            "OTA backend 'jnp' asks for the plain versions on the card; in "
            "the port they serve the tests only and a tensor's device picks "
            "the route ('pallas', the hand-written kernels on CUDA tensors, "
            "is the one it takes)")
    raise ValueError(f"unknown OTA backend {backend!r}; want None, 'pallas' "
                     f"or 'jnp'")


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
    already superposed ``y``: B3 for a tensor ``inv_alpha`` (read on the
    device), B3′ for a host float."""
    planes = (_f32(y_re), _f32(noise_re), _f32(sumh2))
    if isinstance(inv_alpha, torch.Tensor):
        return _ota_k.ota_demodulate_dyn(*planes, _f32(inv_alpha))
    return _ota_k.ota_demodulate(*planes, float(inv_alpha))


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
    Re{λ* h} + ρ|h|²(θ − Θ).  Returns theta's dtype.  Only the real part of
    λ*h is formed, and the products accumulate in place, in the order and
    rounding of the plain expression: at an LLM's widths each temporary is
    a (W, leaf) f32 plane."""
    g = h.re * lam.re + h.im * lam.im   # Re{λ* h} == Re{h λ*}
    pen = cplx.abs2(h).mul_(rho)
    pen.mul_(theta.float() - Theta.float())
    return g.add_(pen).to(theta.dtype)


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


# ---------------------------------------------------------------------------
# Worker-at-a-time receive: the superposition accumulated one worker a call
# ---------------------------------------------------------------------------

class OtaAccumulator(NamedTuple):
    """Running receiver state of a time-multiplexed uplink, whose workers
    transmit one after another: the two sums the receiver needs, f32 on one
    device.  :func:`ota_receive_accumulated` demodulates them once a
    round."""

    y_re: Tensor    # running Re{Σ_n h_n ⊙ s_n}
    sumh2: Tensor   # running Σ_n |h_n|² (the pilot aggregate)


def ota_accumulate_init(shape, device="cuda") -> OtaAccumulator:
    """Zero sums of ``shape`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)
    return OtaAccumulator(torch.zeros(shape, device=dev),
                          torch.zeros(shape, device=dev))


def ota_accumulate(acc: OtaAccumulator, signal: Complex,
                   h: Complex) -> OtaAccumulator:
    """Add ONE worker's term: y += Re{h ⊙ s}, Σ|h|² += |h|², elementwise
    over the worker's signal shape, in one pass (B13)."""
    shape = acc.y_re.shape
    y, p2 = _ota_k.ota_accumulate(
        *(_f32(x).reshape(-1) for x in (acc.y_re, acc.sumh2, signal.re,
                                        signal.im, h.re, h.im)))
    return OtaAccumulator(y.reshape(shape), p2.reshape(shape))


def ota_receive_accumulated(acc: OtaAccumulator, noise_re: Tensor,
                            inv_alpha: Tensor | float = 1.0) -> Tensor:
    """Θ = (y + z·α⁻¹)/max(Σ|h|², 1e-12) of accumulated sums: the
    worker-at-a-time twin of :func:`receive`, with one matched-filter noise
    plane ``noise_re`` (the JAX package draws it from the round key) and one
    :func:`demodulate` (B3 for a tensor α⁻¹, B3′ for a float) a round."""
    return demodulate(acc.y_re, acc.sumh2, noise_re, inv_alpha)


# ---------------------------------------------------------------------------
# The fused one-pass round: each worker plane read once per round
# ---------------------------------------------------------------------------

def snr_db_from_power(sig: Tensor, npow: Tensor) -> Tensor:
    """Receive SNR in dB from signal and noise power sums, as the round
    health guard measures it: both clamped to 1e-30 (an all-masked round
    gives 0 dB, not NaN), non-finite results mapped to ±1e3 dB."""
    snr = 10.0 * torch.log10(torch.clamp_min(sig, 1e-30)
                             / torch.clamp_min(npow, 1e-30))
    return torch.nan_to_num(snr, nan=-1e3, posinf=1e3, neginf=-1e3)


def matched_filter_noise_re(gen: torch.Generator, shape,
                            ccfg: ChannelConfig) -> Tensor:
    """The real plane of ``channel.matched_filter_noise(gen, shape, ccfg)``
    without drawing the imaginary plane: the same values, since the real
    plane is drawn first.  Zeros on a noise-free link."""
    if not ccfg.noisy:
        return torch.zeros(shape, device=gen.device)
    s = math.sqrt(ccfg.noise_var_matched / 2.0)
    return torch.randn(shape, generator=gen, device=gen.device) * s


#: ``(w, rho_f, redraw)``: an AR(1) fading step fused into the round, with
#: innovations ``w`` (h's shape) and ``redraw`` a host bool
ChanStep = Tuple[Complex, float, bool]


def _round_operands(theta: Tensor, lam: Complex, h: Complex,
                    mask: Optional[Tensor], h_tx: Optional[Complex],
                    chan_step: Optional[ChanStep]):
    """(planes, keyword operands, h_air) of the round kernels.  ``h_air`` is
    None when the kernel steps the channel and returns it; on the CPU a
    step at ρ_f = 0 is JAX's exact ``where(redraw, w, h)``, taken here."""
    h_air = h
    chan = None
    if chan_step is not None:
        w, rho_f, redraw = chan_step
        if resolve_backend(theta.device) == "torch" and float(rho_f) == 0.0:
            h_air = w if redraw else h
        else:
            h_air = None
            chan = (_f32(w.re), _f32(w.im), float(rho_f),
                    math.sqrt(max(1.0 - float(rho_f) ** 2, 0.0)),
                    bool(redraw))
    h_k = h if h_air is None else h_air
    planes = (_f32(theta), _f32(lam.re), _f32(lam.im), _f32(h_k.re),
              _f32(h_k.im))
    kw = dict(mask=None if mask is None else mask.to(torch.bool).contiguous(),
              htx=None if h_tx is None else (_f32(h_tx.re), _f32(h_tx.im)),
              chan=chan)
    return planes, kw, h_air


def ota_round_stats(theta: Tensor, lam: Complex, h: Complex, rho: float, *,
                    mask: Optional[Tensor] = None,
                    h_tx: Optional[Complex] = None,
                    chan_step: Optional[ChanStep] = None
                    ) -> Tuple[Tensor, Tensor, Tensor, Complex]:
    """One pass over the (W, d) worker planes (B6): modulate → per-worker
    energy → (mask) → superpose → pilot sum.

    Returns ``(y_re (d,), sumh2 (d,), energy (W,), h_air)``: everything of
    the round that touches the worker planes.  ``h_air`` is the channel the
    air applied: ``h``, or the AR(1)-stepped channel when ``chan_step``
    fuses the fading update into the pass.  Energies are those of the
    unmasked signals, for every row."""
    planes, kw, h_air = _round_operands(theta, lam, h, mask, h_tx, chan_step)
    out = _round_k.ota_round_stats(*planes, rho, **kw)
    if h_air is None:
        h_air = Complex(out[3], out[4])
    return out[0], out[1], out[2], h_air


def _inv_alpha(energy: Tensor, d: int, ccfg: ChannelConfig,
               power_control: bool, mask: Optional[Tensor]) -> Tensor:
    if power_control:
        return inv_alpha_from_energy(energy, ccfg.transmit_power * d,
                                     mask=mask)
    return torch.ones((), dtype=torch.float32, device=energy.device)


def _ota_round_streamed(theta: Tensor, lam: Complex, h: Complex,
                        noise_re: Tensor, rho: float, ccfg: ChannelConfig,
                        chunk: int, *, power_control: bool,
                        mask: Optional[Tensor], h_tx: Optional[Complex],
                        chan_step: Optional[ChanStep]
                        ) -> Tuple[Tensor, Tensor, Complex]:
    """The round over ``ceil(W/chunk)`` worker cohorts, one B6 pass each,
    summing y/p2 and concatenating the energies, so the signal planes of
    only one cohort live at a time.  The last cohort is zero-padded to the
    chunk: an all-zero row adds exactly zero to the sums, has zero energy
    (α = +inf, never binding) and a padded mask row is False.  The sums
    group differently from the monolithic pass: tolerance-equal."""
    W, d = theta.shape
    n_chunks = -(-W // chunk)

    def rows(x: Tensor, i: int) -> Tensor:
        part = x[i * chunk:(i + 1) * chunk]
        short = chunk - part.shape[0]
        if short:
            part = torch.cat([part, part.new_zeros((short,) + part.shape[1:])])
        return part

    def crows(z: Complex, i: int) -> Complex:
        return Complex(rows(_f32(z.re), i), rows(_f32(z.im), i))

    y = torch.zeros(d, dtype=torch.float32, device=theta.device)
    p2 = torch.zeros_like(y)
    energies, h_re, h_im = [], [], []
    for i in range(n_chunks):
        cs = None if chan_step is None else (crows(chan_step[0], i),
                                             chan_step[1], chan_step[2])
        yi, p2i, ei, hi = ota_round_stats(
            rows(_f32(theta), i), crows(lam, i), crows(h, i), rho,
            mask=None if mask is None else rows(mask.to(torch.bool), i),
            h_tx=None if h_tx is None else crows(h_tx, i), chan_step=cs)
        y = y + yi
        p2 = p2 + p2i
        energies.append(ei)
        h_re.append(hi.re)
        h_im.append(hi.im)
    energy = torch.cat(energies)[:W]
    h_air = h if chan_step is None else Complex(torch.cat(h_re)[:W],
                                                torch.cat(h_im)[:W])
    inv_alpha = _inv_alpha(energy, d, ccfg, power_control, mask)
    return demodulate(y, p2, noise_re, inv_alpha), inv_alpha, h_air


def ota_round_fused(theta: Tensor, lam: Complex, h: Complex,
                    noise_re: Tensor, rho: float, ccfg: ChannelConfig, *,
                    power_control: bool = True,
                    mask: Optional[Tensor] = None,
                    h_tx: Optional[Complex] = None,
                    chan_step: Optional[ChanStep] = None,
                    worker_chunk: int = 0
                    ) -> Tuple[Tensor, Tensor, Complex]:
    """The whole uplink in one pass over the worker planes: the fused twin
    of :func:`ota_uplink`, on the same inputs and noise plane.

    With power control, B6 reads each (W, d) plane once, the min-α
    consensus runs over its (W,) energies, and B3 demodulates over (d,).
    With ``power_control=False`` α is known before the pass and B7 does the
    whole round in one launch.  ``chan_step = (w, rho_f, redraw)`` fuses
    the AR(1) fading step into the pass; ``worker_chunk`` > 0 (and < W)
    streams the workers in cohorts of that size.

    Returns ``(Theta (d,), inv_alpha 0-d, h_air)``, with no host
    synchronisation.  On the CPU the result is the composed path's bit for
    bit given equal inputs (monolithic pass)."""
    W, d = theta.shape
    chunk = int(worker_chunk)
    if 0 < chunk < W:
        return _ota_round_streamed(theta, lam, h, noise_re, rho, ccfg, chunk,
                                   power_control=power_control, mask=mask,
                                   h_tx=h_tx, chan_step=chan_step)
    if not power_control:
        planes, kw, h_air = _round_operands(theta, lam, h, mask, h_tx,
                                            chan_step)
        inv_alpha = torch.ones((), dtype=torch.float32, device=theta.device)
        out = _round_k.ota_round_theta(*planes, _f32(noise_re), inv_alpha,
                                       rho, **kw)
        if h_air is None:
            h_air = Complex(out[1], out[2])
        return out[0], inv_alpha, h_air
    y, p2, energy, h_air = ota_round_stats(theta, lam, h, rho, mask=mask,
                                           h_tx=h_tx, chan_step=chan_step)
    inv_alpha = _inv_alpha(energy, d, ccfg, True, mask)
    return demodulate(y, p2, noise_re, inv_alpha), inv_alpha, h_air
