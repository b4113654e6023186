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

The fused round also returns the ``obs/`` telemetry of
:func:`round_telemetry` when asked, and :func:`autotune_ota_round` (with
its JSON cache, :func:`autotune_ota_round_cached`) sweeps its kernels'
plans (``block_cols``) and its worker cohort (``worker_chunk``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import json
import math
import os
import statistics
import time

import torch

from repro_torch import obs as _obs
from repro_torch import optflags, rng
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


def applied_alpha(inv_alpha: Tensor) -> Tensor:
    """The min-α power scale behind a receive's 1/α (``obs/min_alpha``):
    1/α == 0 exactly means nobody transmitted, and then α reads 0."""
    return torch.where(inv_alpha > 0, 1.0 / torch.clamp_min(inv_alpha, 1e-38),
                       torch.zeros_like(inv_alpha))


def active_workers(mask: Optional[Tensor], n_workers: int,
                   device) -> Tensor:
    """Workers that transmitted (``obs/active_workers``): the mask's count,
    or all ``n_workers`` without one."""
    if mask is None:
        return torch.full((), float(n_workers), dtype=torch.float32,
                          device=device)
    return mask.to(torch.float32).sum()


def round_telemetry(tel: _obs.TelemetryConfig, y_re: Tensor, noise_re: Tensor,
                    inv_alpha: Tensor, energy: Optional[Tensor],
                    mask: Optional[Tensor], n_workers: int) -> dict:
    """``obs/`` channel telemetry (the ``repro_torch.obs`` schema) from what
    the receive already holds: the superposed ``y`` and the noise plane
    (d,), the accepted 1/α and the (W,) energies B6 wrote.  Two O(d)
    dot products, which read y and the noise once and write no (d,)
    temporary, and O(W) arithmetic; no pass over the (W, d) worker planes.
    The effective noise power Σ(z·α⁻¹)² is formed as α⁻²·Σz² (the same
    value up to rounding).  Every value is a tensor on the device."""
    y = y_re.reshape(-1)
    z = noise_re.reshape(-1)
    sig = torch.dot(y, y)
    npw = torch.dot(z, z) * (inv_alpha * inv_alpha)
    alpha = applied_alpha(inv_alpha)
    out = {
        "obs/rx_snr_db": snr_db_from_power(sig, npw),
        "obs/min_alpha": alpha,
        "obs/active_workers": active_workers(mask, n_workers, y_re.device),
    }
    if tel.per_worker and energy is not None:
        # the energy each worker radiated: it transmits α·s, so
        # E_tx = α²·Σ|s|², a (W,) VECTOR leaf
        e_tx = energy * (alpha * alpha)
        if mask is not None:
            e_tx = torch.where(mask, e_tx, torch.zeros_like(e_tx))
        out["obs/tx_energy"] = e_tx
    return out


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


def _plan(block_cols: Optional[int], planes: tuple, kw: dict,
          *extra: Tensor) -> Optional[_round_k.Tiling]:
    """B6/B7's plan for a column tile: the caller's ``block_cols``, else
    ``REPRO_OTA_BLOCK_COLS`` (read when called), mapped onto the kernels'
    grid (``kernels/ota_round.tiling_for_cols``) for these planes' card and
    alignment.  The tile is checked on every device; None (no tile, or the
    CPU, where no kernel runs) leaves the kernels their own plan."""
    cols = optflags.ota_block_cols() if block_cols is None else block_cols
    if cols is None:
        return None
    W, d = planes[0].shape
    _round_k.check_block_cols(W, d, cols)
    if planes[0].device.type != "cuda":
        return None
    return _round_k.tiling_for_cols(
        W, d, cols, _round_k.sm_count(planes[0].device),
        _round_k.aligned16(*planes, *extra, *(kw["htx"] or ()),
                           *(kw["chan"] or ())[:2]))


def ota_round_stats(theta: Tensor, lam: Complex, h: Complex, rho: float, *,
                    mask: Optional[Tensor] = None,
                    h_tx: Optional[Complex] = None,
                    chan_step: Optional[ChanStep] = None,
                    block_cols: Optional[int] = None
                    ) -> Tuple[Tensor, Tensor, Tensor, Complex]:
    """One pass over the (W, d) worker planes (B6): modulate → per-worker
    energy → (mask) → superpose → pilot sum.

    Returns ``(y_re (d,), sumh2 (d,), energy (W,), h_air)``: everything of
    the round that touches the worker planes.  ``h_air`` is the channel the
    air applied: ``h``, or the AR(1)-stepped channel when ``chan_step``
    fuses the fading update into the pass.  Energies are those of the
    unmasked signals, for every row.  ``block_cols`` picks B6's plan
    (``kernels/ota_round.tiling_for_cols``); None defers to
    ``REPRO_OTA_BLOCK_COLS``, and unset, to the kernel's own plan."""
    planes, kw, h_air = _round_operands(theta, lam, h, mask, h_tx, chan_step)
    out = _round_k.ota_round_stats(*planes, rho,
                                   plan=_plan(block_cols, planes, kw), **kw)
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
                        chan_step: Optional[ChanStep],
                        block_cols: Optional[int] = None,
                        telemetry: Optional[_obs.TelemetryConfig] = None):
    """The round over ``ceil(W/chunk)`` worker cohorts, one B6 pass each,
    summing y/p2 and concatenating the energies, so the signal planes of
    only one cohort live at a time.  The last cohort is zero-padded to the
    chunk: an all-zero row adds exactly zero to the sums, has zero energy
    (α = +inf, never binding) and a padded mask row is False.  The sums
    group differently from the monolithic pass: tolerance-equal.  With
    ``telemetry`` the result gains the ``obs/`` dict of
    :func:`round_telemetry` over the summed y and the concatenated
    energies."""
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
            h_tx=None if h_tx is None else crows(h_tx, i), chan_step=cs,
            block_cols=block_cols)
        y = y + yi
        p2 = p2 + p2i
        energies.append(ei)
        h_re.append(hi.re)
        h_im.append(hi.im)
    energy = torch.cat(energies)[:W]
    h_air = h if chan_step is None else Complex(torch.cat(h_re)[:W],
                                                torch.cat(h_im)[:W])
    inv_alpha = _inv_alpha(energy, d, ccfg, power_control, mask)
    Theta = demodulate(y, p2, noise_re, inv_alpha)
    if telemetry is not None:
        return Theta, inv_alpha, h_air, round_telemetry(
            telemetry, y, noise_re, inv_alpha, energy, mask, W)
    return Theta, inv_alpha, h_air


def ota_round_fused(theta: Tensor, lam: Complex, h: Complex,
                    noise_re: Tensor, rho: float, ccfg: ChannelConfig, *,
                    power_control: bool = True,
                    mask: Optional[Tensor] = None,
                    h_tx: Optional[Complex] = None,
                    chan_step: Optional[ChanStep] = None,
                    worker_chunk: Optional[int] = None,
                    block_cols: Optional[int] = None,
                    telemetry=None) -> Tuple:
    """The whole uplink in one pass over the worker planes: the fused twin
    of :func:`ota_uplink`, on the same inputs and noise plane.

    With power control, B6 reads each (W, d) plane once, the min-α
    consensus runs over its (W,) energies, and B3 demodulates over (d,).
    With ``power_control=False`` α is known before the pass and B7 does the
    whole round in one launch.  ``chan_step = (w, rho_f, redraw)`` fuses
    the AR(1) fading step into the pass; ``worker_chunk`` > 0 (and < W)
    streams the workers in cohorts of that size (None:
    ``REPRO_OTA_WORKER_CHUNK``, 0 unset); ``block_cols`` picks B6/B7's plan
    (None: ``REPRO_OTA_BLOCK_COLS``, else the kernels' own).

    Returns ``(Theta (d,), inv_alpha 0-d, h_air)``, with no host
    synchronisation.  On the CPU the result is the composed path's bit for
    bit given equal inputs (monolithic pass).  With ``telemetry`` on (True
    or a live ``repro_torch.obs.TelemetryConfig``) the return gains a
    fourth element, the ``obs/`` dict of :func:`round_telemetry`, and the
    three others are unchanged; without power control the round then takes
    B6 and B3′ in place of B7, which exposes no y."""
    tel = _obs.resolve(telemetry)
    W, d = theta.shape
    chunk = int(optflags.ota_worker_chunk() if worker_chunk is None
                else worker_chunk)
    if 0 < chunk < W:
        return _ota_round_streamed(theta, lam, h, noise_re, rho, ccfg, chunk,
                                   power_control=power_control, mask=mask,
                                   h_tx=h_tx, chan_step=chan_step,
                                   block_cols=block_cols, telemetry=tel)
    if not power_control and tel is None:
        planes, kw, h_air = _round_operands(theta, lam, h, mask, h_tx,
                                            chan_step)
        inv_alpha = torch.ones((), dtype=torch.float32, device=theta.device)
        noise = _f32(noise_re)
        out = _round_k.ota_round_theta(
            *planes, noise, inv_alpha, rho,
            plan=_plan(block_cols, planes, kw, noise), **kw)
        if h_air is None:
            h_air = Complex(out[1], out[2])
        return out[0], inv_alpha, h_air
    y, p2, energy, h_air = ota_round_stats(theta, lam, h, rho, mask=mask,
                                           h_tx=h_tx, chan_step=chan_step,
                                           block_cols=block_cols)
    inv_alpha = _inv_alpha(energy, d, ccfg, power_control, mask)
    Theta = demodulate(y, p2, noise_re, inv_alpha)
    if tel is not None:
        return Theta, inv_alpha, h_air, round_telemetry(
            tel, y, noise_re, inv_alpha, energy, mask, W)
    return Theta, inv_alpha, h_air


# ---------------------------------------------------------------------------
# Autotuning the fused round's plan and worker cohort
# ---------------------------------------------------------------------------

def median_ms(fn, iters: int, dev: torch.device) -> float:
    """Median of ``iters`` timings of ``fn()`` after one warm-up call: CUDA
    events on a card, the host clock (around the finished call) on the
    CPU."""
    fn()
    ts = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def autotune_ota_round(W: int, d: int, ccfg: Optional[ChannelConfig] = None,
                       *, rho: float = 1.0, block_cols_grid=None,
                       worker_chunks=(0, 8, 32), iters: int = 10,
                       device="cuda", seed: int = 0) -> dict:
    """Sweep the fused round's plan and worker cohort on random (W, d)
    planes on ``device``.

    For each ``worker_chunk`` (those ≥ W skipped: they are the monolithic
    pass) and each ``block_cols`` the kernels can honour at the chunk's
    width (``kernels/ota_round.block_cols_choices``; only those in
    ``block_cols_grid`` when it is given), times :func:`ota_round_fused`
    (median of ``iters`` after a warm-up, CUDA events on a card) and
    returns ``{"best": row, "table": [row, ...]}``.  A row carries the
    plan's fields (``plan``, ``k``, ``rows_per_slice``, ``n_tiles``,
    ``n_slices``) beside ``block_cols``, ``worker_chunk`` and ``us``.  The
    winner maps onto ``REPRO_OTA_BLOCK_COLS`` / ``REPRO_OTA_WORKER_CHUNK``
    and ``FLConfig.ota_block_cols``/``ota_worker_chunk``.  On the CPU
    ``block_cols`` reaches no kernel, so one plan (the kernels' own) is
    kept a chunk."""
    from repro_torch.core.channel import ChannelConfig as _CC, rayleigh
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if ccfg is None:
        ccfg = _CC(n_workers=W)
    gen = rng.generator(seed, dev)
    theta = torch.randn((W, d), generator=gen, device=dev)
    lam = rayleigh(gen, (W, d))
    h = rayleigh(gen, (W, d))
    noise = matched_filter_noise_re(gen, (d,), ccfg)
    table = []
    for wc in worker_chunks:
        if wc and wc >= W:
            continue
        width = wc or W
        cols = _round_k.block_cols_choices(width, d)
        if block_cols_grid is not None:
            cols = tuple(c for c in cols if c in block_cols_grid)
        if dev.type != "cuda":
            # the kernels' own plan, the one row kept
            cols = (_round_k.block_cols_of(_round_k.tiling(width, d)),)
        for bc in cols:
            t = _round_k.tiling_for_cols(width, d, bc)
            ms = median_ms(lambda: ota_round_fused(
                theta, lam, h, noise, rho, ccfg, worker_chunk=wc,
                block_cols=bc)[0], iters, dev)
            table.append({"block_cols": int(bc), "worker_chunk": int(wc),
                          "plan": t.plan, "k": t.k,
                          "rows_per_slice": t.rows_per_slice,
                          "n_tiles": t.n_tiles, "n_slices": t.n_slices,
                          "us": 1e3 * ms})
    if not table:
        raise ValueError(f"autotune_ota_round: no configuration to time for "
                         f"W={W} (worker_chunks {tuple(worker_chunks)})")
    best = min(table, key=lambda r: r["us"])
    return {"best": best, "table": table}


def autotune_ota_round_cached(W: int, d: int,
                              ccfg: Optional[ChannelConfig] = None, *,
                              cache_path: str, device="cuda", **kw) -> dict:
    """:func:`autotune_ota_round` behind a JSON file cache.

    Results key on ``"{W}x{d}:{device type}"`` (``"…:cuda"`` on the card):
    one sweep per problem shape per machine, then every later launch
    (``launch/train.py --autotune-cache``) reads the winner instead of
    measuring again.  The write is atomic (a temporary file renamed into
    place), so launchers can share one cache file; a corrupt or unreadable
    cache counts as empty, never as an error.  The returned dict is the
    sweep's result plus ``"cached": True`` on a hit."""
    from repro_torch.device import resolve_device

    cache_key = f"{int(W)}x{int(d)}:{resolve_device(device).type}"
    cache = {}
    if os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
            if not isinstance(cache, dict):
                cache = {}
        except (OSError, ValueError):
            cache = {}
    if cache_key in cache:
        return dict(cache[cache_key], cached=True)
    res = autotune_ota_round(W, d, ccfg, device=device, **kw)
    cache[cache_key] = res
    tmp = f"{cache_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, cache_path)
    return dict(res, cached=False)
