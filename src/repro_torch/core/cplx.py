"""Complex arithmetic as explicit (re, im) planes.

Every complex tensor of the port (fading coefficients ``h``, duals ``λ``,
analog signals, noise) is a :class:`Complex` pair of two real tensors, as in
the JAX package: the CUDA kernels read and write the planes directly.
Counterpart of ``repro/core/cplx.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Complex(NamedTuple):
    """A complex tensor as explicit real/imaginary planes (same shape/dtype)."""

    re: Tensor
    im: Tensor


def czero(shape, *, dtype=torch.float32, device=None) -> Complex:
    return Complex(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def cmul(a: Complex, b: Complex) -> Complex:
    """(a.re + i a.im)(b.re + i b.im)."""
    return Complex(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cmul_conj(a: Complex, b: Complex) -> Complex:
    """a * conj(b), without materialising conj(b)."""
    return Complex(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def scale(a: Complex, s) -> Complex:
    """a · s for a real tensor or float ``s``."""
    return Complex(a.re * s, a.im * s)


def abs2(x: Complex) -> Tensor:
    """|x|² elementwise (a real tensor)."""
    return x.re * x.re + x.im * x.im


def cwhere(mask: Tensor, a: Complex, b: Complex) -> Complex:
    return Complex(torch.where(mask, a.re, b.re), torch.where(mask, a.im, b.im))
