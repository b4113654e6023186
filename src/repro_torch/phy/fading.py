"""Time-correlated small-scale fading: the Gauss–Markov (AR(1)) process.

    h_{k+1} = rho · h_k + sqrt(1 − rho²) · w_k,      w_k ~ CN(0, 1)

with ``rho = J0(2·pi·f_d·T_update)`` (Jakes' model).  ``rho = 0`` is an
i.i.d. redraw: the legacy block-fading channel applied at coherence
boundaries.  Counterpart of ``repro/phy/fading.py``.

The innovations ``w`` are an argument, so a round's draws can be replayed.
On CUDA tensors the update is the B9 kernel (``kernels/phy_channel.py``);
on CPU tensors its plain version, except that ``rho == 0`` takes the exact
``w``-where-redraw arithmetic, as the JAX jnp path does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.core.cplx import Complex
from repro_torch.kernels import phy_channel as _k
from repro_torch.kernels.build import resolve_backend


def bessel_j0(x: float) -> float:
    """J0(x) for host-side floats (Abramowitz & Stegun 9.4.1 / 9.4.3).

    Polynomial approximations, |error| < 5e-8 — plenty for a correlation
    coefficient, with no scipy dependency.
    """
    ax = abs(float(x))
    if ax <= 3.0:
        t = (ax / 3.0) ** 2
        return (1.0 + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
                + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100))))))
    t = 3.0 / ax
    f0 = (0.79788456 + t * (-0.00000077 + t * (-0.00552740 + t * (-0.00009512
          + t * (0.00137237 + t * (-0.00072805 + t * 0.00014476))))))
    th0 = (ax - 0.78539816 + t * (-0.04166397 + t * (-0.00003954
           + t * (0.00262573 + t * (-0.00054125 + t * (-0.00029333
           + t * 0.00013558))))))
    return f0 * math.cos(th0) / math.sqrt(ax)


def doppler_rho(doppler_hz: float, update_seconds: float) -> float:
    """Jakes-model AR(1) coefficient ``rho = J0(2·pi·f_d·T)``, clamped to
    [0, 1]: past the first Bessel zero the channel is decorrelated and the
    AR(1) step is an i.i.d. redraw rather than a negative correlation."""
    rho = bessel_j0(2.0 * math.pi * float(doppler_hz) * float(update_seconds))
    return min(max(rho, 0.0), 1.0)


def innovation_scale(rho: float) -> float:
    """sqrt(1 − rho²): keeps the recurrence CN(0,1)-stationary."""
    return math.sqrt(max(1.0 - float(rho) ** 2, 0.0))


def gauss_markov_step(h: Complex, w: Complex, rho: float,
                      redraw: bool = True) -> Complex:
    """One AR(1) fading update with innovations ``w`` (h's shape), gated by
    the host bool ``redraw`` (a coherence boundary)."""
    if resolve_backend(h.re.device) == "torch" and float(rho) == 0.0:
        return w if redraw else h
    ore, oim = _k.fading_step(h.re, h.im, w.re, w.im, float(rho),
                              innovation_scale(rho), redraw)
    return Complex(ore, oim)


def redraws(age: int, coherence_iters: int) -> bool:
    """Whether the next :func:`correlated_step` from ``age`` updates h."""
    return age + 1 >= coherence_iters


def correlated_step(h: Complex, w: Optional[Complex], age: int, rho: float,
                    coherence_iters: int) -> Tuple[Complex, int, bool]:
    """Advance one round: AR(1)-mix the fading at coherence boundaries.

    ``age`` is a host integer, so whether this round redraws is known on the
    host: between boundaries h is kept as it is, no kernel runs and ``w`` may
    be None.  Returns ``(h_new, age_new, redraw)``.
    """
    redraw = redraws(age, coherence_iters)
    if not redraw:
        return h, age + 1, False
    if w is None:
        raise ValueError("correlated_step: this round redraws the fading but "
                         "no innovations were given")
    return gauss_markov_step(h, w, rho, True), 0, True
