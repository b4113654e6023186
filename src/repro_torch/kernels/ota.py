"""Wrappers of the over-the-air CUDA kernels in ``csrc/ota.cu``.

On CUDA tensors each wrapper checks its operands, allocates its outputs with
``torch.empty``, launches its kernel on the current stream and counts the
launch in ``build.launches``; it raises on anything the kernel does not
take.  On CPU tensors it returns the plain version from ``kernels/ref.py``
and launches nothing.  Counterpart of ``repro/kernels/ota.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor


def ota_modulate(theta: Tensor, lam_re: Tensor, lam_im: Tensor, h_re: Tensor,
                 h_im: Tensor, rho: float) -> Tuple[Tensor, Tensor]:
    """Fused s = conj(h)·θ + conj(λ)/ρ over planes of one shape (B1)."""
    if build.resolve_backend(theta.device) == "torch":
        return ref.ota_modulate(theta, lam_re, lam_im, h_re, h_im, rho)
    dev = build.check_cuda_f32("ota_modulate", theta=theta, lam_re=lam_re,
                               lam_im=lam_im, h_re=h_re, h_im=h_im)
    for name, t in (("lam_re", lam_re), ("lam_im", lam_im), ("h_re", h_re),
                    ("h_im", h_im)):
        if t.shape != theta.shape:
            raise ValueError(f"ota_modulate: {name} has shape "
                             f"{tuple(t.shape)}, theta {tuple(theta.shape)}")
    s_re = torch.empty_like(theta)
    s_im = torch.empty_like(theta)
    build.launch("ota", "ota_modulate", dev, theta.data_ptr(),
                 lam_re.data_ptr(), lam_im.data_ptr(), h_re.data_ptr(),
                 h_im.data_ptr(), s_re.data_ptr(), s_im.data_ptr(),
                 theta.numel(), 1.0 / rho)
    return s_re, s_im


def ota_receive(s_re: Tensor, s_im: Tensor, h_re: Tensor, h_im: Tensor,
                noise_re: Tensor, inv_alpha: Tensor) -> Tensor:
    """Fused receive chain (B2): Θ = (Re{Σ_w h_w⊙s_w} + z·α⁻¹)/max(Σ|h|², 1e-12).

    s/h: (W, d) planes; noise_re: (d,); inv_alpha: a one-element tensor,
    read by the kernel on the device so the host never waits for it.
    Returns (d,) float32."""
    if build.resolve_backend(s_re.device) == "torch":
        return ref.ota_receive(s_re, s_im, h_re, h_im, noise_re, inv_alpha)
    if not isinstance(inv_alpha, torch.Tensor) or inv_alpha.numel() != 1:
        raise ValueError("ota_receive: inv_alpha must be a one-element tensor "
                         "on the device")
    dev = build.check_cuda_f32("ota_receive", s_re=s_re, s_im=s_im, h_re=h_re,
                               h_im=h_im, noise_re=noise_re,
                               inv_alpha=inv_alpha)
    if s_re.dim() != 2:
        raise ValueError(f"ota_receive: want (W, d) planes, got "
                         f"{tuple(s_re.shape)}")
    W, d = s_re.shape
    for name, t in (("s_im", s_im), ("h_re", h_re), ("h_im", h_im)):
        if t.shape != s_re.shape:
            raise ValueError(f"ota_receive: {name} has shape "
                             f"{tuple(t.shape)}, s_re {tuple(s_re.shape)}")
    if noise_re.shape != (d,):
        raise ValueError(f"ota_receive: noise_re has shape "
                         f"{tuple(noise_re.shape)}, want ({d},)")
    out = torch.empty(d, dtype=torch.float32, device=dev)
    build.launch("ota", "ota_receive", dev, s_re.data_ptr(), s_im.data_ptr(),
                 h_re.data_ptr(), h_im.data_ptr(), noise_re.data_ptr(),
                 inv_alpha.data_ptr(), out.data_ptr(), W, d)
    return out


def _demod_operands(name: str, y_re: Tensor, noise_re: Tensor,
                    sumh2: Tensor, **scalars: Tensor) -> torch.device:
    dev = build.check_cuda_f32(name, y_re=y_re, noise_re=noise_re,
                               sumh2=sumh2, **scalars)
    for arg, t in (("noise_re", noise_re), ("sumh2", sumh2)):
        if t.shape != y_re.shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"y_re {tuple(y_re.shape)}")
    return dev


def ota_demodulate_dyn(y_re: Tensor, noise_re: Tensor, sumh2: Tensor,
                       inv_alpha: Tensor) -> Tensor:
    """Θ = (y + z·α⁻¹)/max(Σ|h|², 1e-12) elementwise (B3), with α⁻¹ a
    one-element tensor read by the kernel on the device."""
    if build.resolve_backend(y_re.device) == "torch":
        return ref.ota_demodulate_dyn(y_re, noise_re, sumh2, inv_alpha)
    if not isinstance(inv_alpha, torch.Tensor) or inv_alpha.numel() != 1:
        raise ValueError("ota_demodulate_dyn: inv_alpha must be a "
                         "one-element tensor on the device")
    dev = _demod_operands("ota_demodulate_dyn", y_re, noise_re, sumh2,
                          inv_alpha=inv_alpha)
    out = torch.empty_like(y_re)
    build.launch("ota", "ota_demodulate_dyn", dev, y_re.data_ptr(),
                 noise_re.data_ptr(), sumh2.data_ptr(), inv_alpha.data_ptr(),
                 out.data_ptr(), y_re.numel())
    return out


def ota_demodulate(y_re: Tensor, noise_re: Tensor, sumh2: Tensor,
                   inv_alpha: float) -> Tensor:
    """B3 with α⁻¹ a host float (B3′): Θ = (y + z·α⁻¹)/max(Σ|h|², 1e-12)."""
    if build.resolve_backend(y_re.device) == "torch":
        return ref.ota_demodulate(y_re, noise_re, sumh2, float(inv_alpha))
    dev = _demod_operands("ota_demodulate", y_re, noise_re, sumh2)
    out = torch.empty_like(y_re)
    build.launch("ota", "ota_demodulate", dev, y_re.data_ptr(),
                 noise_re.data_ptr(), sumh2.data_ptr(), out.data_ptr(),
                 y_re.numel(), float(inv_alpha))
    return out


def ota_accumulate(y_re: Tensor, sumh2: Tensor, s_re: Tensor, s_im: Tensor,
                   h_re: Tensor, h_im: Tensor) -> Tuple[Tensor, Tensor]:
    """One worker's term added to the receiver's running sums (B13):
    ``(y + h_re·s_re − h_im·s_im, Σ|h|² + h_re² + h_im²)`` over flat planes
    of one shape, in one pass; new tensors, the inputs are left as they
    are."""
    if build.resolve_backend(y_re.device) == "torch":
        return ref.ota_accumulate(y_re, sumh2, s_re, s_im, h_re, h_im)
    dev = build.check_cuda_f32("ota_accumulate", y_re=y_re, sumh2=sumh2,
                               s_re=s_re, s_im=s_im, h_re=h_re, h_im=h_im)
    for name, t in (("sumh2", sumh2), ("s_re", s_re), ("s_im", s_im),
                    ("h_re", h_re), ("h_im", h_im)):
        if t.shape != y_re.shape:
            raise ValueError(f"ota_accumulate: {name} has shape "
                             f"{tuple(t.shape)}, y_re {tuple(y_re.shape)}")
    y = torch.empty_like(y_re)
    p2 = torch.empty_like(y_re)
    build.launch("ota", "ota_accumulate", dev, y_re.data_ptr(),
                 sumh2.data_ptr(), s_re.data_ptr(), s_im.data_ptr(),
                 h_re.data_ptr(), h_im.data_ptr(), y.data_ptr(),
                 p2.data_ptr(), y_re.numel())
    return y, p2
