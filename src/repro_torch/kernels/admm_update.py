"""Wrappers of the ADMM-update CUDA kernels in ``csrc/admm_update.cu``.

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version.  The global model Θ is passed as
its (d,) vector, not broadcast to (W, d).  Counterpart of
``repro/kernels/admm_update.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor


def _check_worker_planes(name: str, Theta: Tensor, **planes: Tensor) -> None:
    ref_name, first = next(iter(planes.items()))
    if first.dim() != 2:
        raise ValueError(f"{name}: want (W, d) planes, {ref_name} has shape "
                         f"{tuple(first.shape)}")
    for arg, t in planes.items():
        if t.shape != first.shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"{ref_name} {tuple(first.shape)}")
    if Theta.shape != first.shape[1:]:
        raise ValueError(f"{name}: Theta has shape {tuple(Theta.shape)}, "
                         f"want ({first.shape[1]},)")


def admm_dual_update(lam_re: Tensor, lam_im: Tensor, h_re: Tensor,
                     h_im: Tensor, theta: Tensor, Theta: Tensor, rho: float,
                     noise_re: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """Fused λ' = λ + ρ·h·(θ−Θ) − ρ·Re{z} (B4).  (W, d) planes, Θ (d,);
    ``noise_re`` is a (W, d) plane under an analog downlink, else None."""
    if build.resolve_backend(lam_re.device) == "torch":
        return build.plain("admm_dual_update", ref.admm_dual_update,
                           lam_re, lam_im, h_re, h_im, theta, Theta, rho,
                           noise_re)
    planes = dict(lam_re=lam_re, lam_im=lam_im, h_re=h_re, h_im=h_im,
                  theta=theta)
    if noise_re is not None:
        planes["noise_re"] = noise_re
    dev = build.check_cuda_f32("admm_dual_update", Theta=Theta, **planes)
    _check_worker_planes("admm_dual_update", Theta, **planes)
    out_re = torch.empty_like(lam_re)
    out_im = torch.empty_like(lam_re)
    build.launch("admm_update", "admm_dual_update", dev, lam_re.data_ptr(),
                 lam_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(),
                 theta.data_ptr(), Theta.data_ptr(),
                 None if noise_re is None else noise_re.data_ptr(),
                 out_re.data_ptr(), out_im.data_ptr(), lam_re.numel(),
                 lam_re.shape[1], rho)
    return out_re, out_im


def admm_flip_lambda(grad: Tensor, theta: Tensor, Theta_prev: Tensor,
                     h_re: Tensor, h_im: Tensor, rho: float
                     ) -> Tuple[Tensor, Tensor]:
    """Fused flip rule (B5): λ = t·h/max(|h|², 1e-12),
    t = −(∂f + ρ|h|²(θ−Θ)).  (W, d) planes, Θ_prev (d,)."""
    if build.resolve_backend(grad.device) == "torch":
        return build.plain("admm_flip_lambda", ref.admm_flip_lambda, grad,
                           theta, Theta_prev, h_re, h_im, rho)
    planes = dict(grad=grad, theta=theta, h_re=h_re, h_im=h_im)
    dev = build.check_cuda_f32("admm_flip_lambda", Theta_prev=Theta_prev,
                               **planes)
    _check_worker_planes("admm_flip_lambda", Theta_prev, **planes)
    out_re = torch.empty_like(grad)
    out_im = torch.empty_like(grad)
    build.launch("admm_update", "admm_flip_lambda", dev, grad.data_ptr(),
                 theta.data_ptr(), Theta_prev.data_ptr(), h_re.data_ptr(),
                 h_im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
                 grad.numel(), grad.shape[1], rho)
    return out_re, out_im
