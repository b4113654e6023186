"""Wireless channel substrate: Rayleigh block fading + AWGN + matched filter.

Counterpart of ``repro/core/channel.py``:

* **Rayleigh fading** ``h ~ CN(0, 1)`` per (worker, coefficient), redrawn
  every ``coherence_iters`` rounds ("block fading");
* **AWGN** after the matched filter (Appendix B, Eq. 23): ``CN(0, N0/T)``;
* **SNR** as in Appendix H: ``SNR = P / (N0 · W_hz)``;
* the digital baseline's per-subcarrier **Shannon rate** (Appendix H).

Draws take an explicit ``torch.Generator``.  :func:`step_channel` takes the
fresh block as an argument instead of drawing it, so a round's random planes
can be replayed (``core.admm.RoundDraws``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import rng
from repro_torch.core.cplx import Complex, abs2

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Static description of the simulated wireless link (the i.i.d.
    block-fading substrate)."""

    n_workers: int
    n_subcarriers: int = 4096
    #: iterations per coherence block (paper Sec. 5: 10)
    coherence_iters: int = 10
    #: average SNR in dB (paper default: 40 dB)
    snr_db: float = 40.0
    #: subcarrier bandwidth in Hz (LTE numerology, Appendix H)
    subcarrier_hz: float = 15e3
    #: noise power spectral density W/Hz (paper Sec. 5 scalability: 1e-9)
    noise_psd: float = 1e-9
    #: matched-filter integration time T in seconds (slot length, 1 ms)
    slot_seconds: float = 1e-3
    #: uplink AWGN on/off (noise-free channels for the convergence theory)
    noisy: bool = True
    #: model downlink as digital (paper Sec. 5 default) or analog
    analog_downlink: bool = False

    @property
    def transmit_power(self) -> float:
        """P implied by the SNR definition SNR = P/(N0*W)."""
        return (10.0 ** (self.snr_db / 10.0)) * self.noise_psd * self.subcarrier_hz

    @property
    def noise_var_matched(self) -> float:
        """Post-matched-filter complex noise variance N0/T (Eq. 23)."""
        return self.noise_psd / self.slot_seconds


@dataclasses.dataclass
class ChannelBlock:
    """One block-fading realisation.

    Attributes:
      h: fading coefficients (n_workers, n_coeffs) as Complex planes.
      h_prev: the previous block's coefficients (for the flip rule).
      changed: bool (n_workers, n_coeffs), True where h != h_prev this round.
      age: rounds since this block was drawn (a host integer).
    """

    h: Complex
    h_prev: Complex
    changed: Tensor
    age: int


def rayleigh(gen: torch.Generator, shape: Tuple[int, ...]) -> Complex:
    """CN(0, 1) on ``gen``'s device: re, im ~ N(0, 1/2)."""
    s = math.sqrt(0.5)
    return Complex(torch.randn(shape, generator=gen, device=gen.device) * s,
                   torch.randn(shape, generator=gen, device=gen.device) * s)


def rayleigh_rows(key: int, rows: Sequence[int], d: int,
                  device) -> Complex:
    """CN(0, 1) rows of a packed ``(W, d)`` plane: worker ``w``'s row from
    ``fold_in(key, w)`` (re, then im), so any subset of the rows (a mesh
    rank's workers) is bit for bit those rows of the whole plane, and no
    rank draws rows it does not hold.  A row costs a generator and two
    launches, so this is the LLM trainer's draw (a few workers, wide
    rows); the flat trainer's thousands of narrow rows draw the whole
    plane at once (:func:`rayleigh`)."""
    s = math.sqrt(0.5)
    re = torch.empty((len(rows), d), device=device)
    im = torch.empty((len(rows), d), device=device)
    for i, w in enumerate(rows):
        gen = rng.generator(rng.fold_in(key, w), device)
        torch.randn((d,), generator=gen, device=device, out=re[i])
        torch.randn((d,), generator=gen, device=device, out=im[i])
    return Complex(re.mul_(s), im.mul_(s))


def awgn(gen: torch.Generator, shape: Tuple[int, ...], var: float) -> Complex:
    """CN(0, var): matched-filter-reduced receiver noise."""
    s = math.sqrt(var / 2.0)
    return Complex(torch.randn(shape, generator=gen, device=gen.device) * s,
                   torch.randn(shape, generator=gen, device=gen.device) * s)


def init_channel(gen: torch.Generator, cfg: ChannelConfig,
                 n_coeffs: Optional[int] = None) -> ChannelBlock:
    """Draw the first fading block on ``gen``'s device.  ``n_coeffs``
    defaults to n_subcarriers."""
    n = cfg.n_subcarriers if n_coeffs is None else n_coeffs
    h = rayleigh(gen, (cfg.n_workers, n))
    return ChannelBlock(
        h=h, h_prev=h,
        changed=torch.zeros((cfg.n_workers, n), dtype=torch.bool,
                            device=gen.device),
        age=0)


def redraws(blk: ChannelBlock, cfg: ChannelConfig) -> bool:
    """Whether the next :func:`step_channel` starts a new coherence block."""
    return blk.age + 1 >= cfg.coherence_iters


def step_channel(blk: ChannelBlock, cfg: ChannelConfig,
                 fresh: Optional[Complex]) -> ChannelBlock:
    """Advance one round: every ``coherence_iters`` rounds ``h`` becomes
    ``fresh`` (a Rayleigh block of h's shape, needed only then)."""
    redraw = redraws(blk, cfg)
    if redraw and fresh is None:
        raise ValueError("step_channel: this round redraws the channel but "
                         "no fresh block was given")
    shape = blk.h.re.shape
    return ChannelBlock(
        h=fresh if redraw else blk.h,
        h_prev=blk.h,
        changed=torch.full((), redraw, dtype=torch.bool,
                           device=blk.h.re.device).expand(shape),
        age=0 if redraw else blk.age + 1)


def matched_filter_noise(gen: torch.Generator, shape: Tuple[int, ...],
                         cfg: ChannelConfig) -> Complex:
    """Receiver noise after the correlator (Eq. 23): CN(0, N0/T), or zero
    when the link is noise-free."""
    if not cfg.noisy:
        z = torch.zeros(shape, device=gen.device)
        return Complex(z, z)
    return awgn(gen, shape, cfg.noise_var_matched)


def shannon_rate(h: Complex, cfg: ChannelConfig) -> Tensor:
    """Per-subcarrier achievable rate (bits/slot) for the *digital*
    baseline.  Appendix H: R = W log2(1 + P|h|²/(N0 W)) bits/s; one slot is
    ``slot_seconds``."""
    snr_lin = cfg.transmit_power * abs2(h) / (cfg.noise_psd
                                              * cfg.subcarrier_hz)
    bits_per_sec = cfg.subcarrier_hz * torch.log2(1.0 + snr_lin)
    return bits_per_sec * cfg.slot_seconds
