"""Imperfect channel state information (CSI).

A worker estimates its channel from pilots and holds

    h_hat = h + e,      e ~ CN(0, sigma_e²)

It precodes, solves and dual-updates with ``h_hat`` while the air applies
the true ``h`` (and the parameter server's pilot sum Σ|h|² is the true one).
Counterpart of ``repro/phy/csi.py``; the error ``e`` is an argument, so a
round can be replayed.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.cplx import Complex


def estimate(h: Complex, e: Optional[Complex], sigma_e: float) -> Complex:
    """Worker-side channel estimate ``h_hat = h + e``, ``e`` a CN(0, σ_e²)
    draw of h's shape.  ``sigma_e == 0`` returns ``h`` itself (perfect CSI:
    the same tensors, and ``e`` may be None)."""
    if float(sigma_e) == 0.0:
        return h
    return Complex(h.re + e.re, h.im + e.im)
