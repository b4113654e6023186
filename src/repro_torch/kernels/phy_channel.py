"""Wrappers of the wireless-scenario channel kernels in ``csrc/phy_channel.cu``:
B9 ``fading_step`` and B8 ``ota_receive_masked``.

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version from ``kernels/ref.py``.
Counterpart of ``repro/kernels/phy_channel.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor


def fading_step(h_re: Tensor, h_im: Tensor, w_re: Tensor, w_im: Tensor,
                rho: float, scale: float, redraw: bool
                ) -> Tuple[Tensor, Tensor]:
    """Fused AR(1) fading update (B9): h' = ρ·h + scale·w where ``redraw``,
    else h, over four planes of one shape.  ``redraw`` is a host bool."""
    if build.resolve_backend(h_re.device) == "torch":
        return build.plain("fading_step", ref.fading_step, h_re, h_im,
                           w_re, w_im, rho, scale, redraw)
    dev = build.check_cuda_f32("fading_step", h_re=h_re, h_im=h_im, w_re=w_re,
                               w_im=w_im)
    for name, t in (("h_im", h_im), ("w_re", w_re), ("w_im", w_im)):
        if t.shape != h_re.shape:
            raise ValueError(f"fading_step: {name} has shape "
                             f"{tuple(t.shape)}, h_re {tuple(h_re.shape)}")
    o_re = torch.empty_like(h_re)
    o_im = torch.empty_like(h_re)
    build.launch("phy_channel", "fading_step", dev, h_re.data_ptr(),
                 h_im.data_ptr(), w_re.data_ptr(), w_im.data_ptr(),
                 o_re.data_ptr(), o_im.data_ptr(), h_re.numel(), float(rho),
                 float(scale), int(bool(redraw)))
    return o_re, o_im


def ota_receive_masked(s_re: Tensor, s_im: Tensor, h_re: Tensor, h_im: Tensor,
                       mask: Tensor, noise_re: Tensor,
                       inv_alpha: Tensor) -> Tensor:
    """Participation-aware fused receive (B8):
    Θ = (Re{Σ_{w: mask_w} h_w⊙s_w} + z·α⁻¹)/max(Σ_{w: mask_w} |h_w|², 1e-12).

    s/h: (W, d) planes; mask: (W,) bool; noise_re: (d,); inv_alpha: a
    one-element tensor on the device.  A masked worker's planes are never
    read into the sums, so NaN or Inf there is harmless.  Returns (d,)."""
    if build.resolve_backend(s_re.device) == "torch":
        return build.plain("ota_receive_masked", ref.ota_receive_masked,
                           s_re, s_im, h_re, h_im, mask, noise_re, inv_alpha)
    if not isinstance(inv_alpha, torch.Tensor) or inv_alpha.numel() != 1:
        raise ValueError("ota_receive_masked: inv_alpha must be a one-element "
                         "tensor on the device")
    dev = build.check_cuda_f32("ota_receive_masked", s_re=s_re, s_im=s_im,
                               h_re=h_re, h_im=h_im, noise_re=noise_re,
                               inv_alpha=inv_alpha)
    if s_re.dim() != 2:
        raise ValueError(f"ota_receive_masked: want (W, d) planes, got "
                         f"{tuple(s_re.shape)}")
    W, d = s_re.shape
    for name, t in (("s_im", s_im), ("h_re", h_re), ("h_im", h_im)):
        if t.shape != s_re.shape:
            raise ValueError(f"ota_receive_masked: {name} has shape "
                             f"{tuple(t.shape)}, s_re {tuple(s_re.shape)}")
    if noise_re.shape != (d,):
        raise ValueError(f"ota_receive_masked: noise_re has shape "
                         f"{tuple(noise_re.shape)}, want ({d},)")
    if (mask.dtype != torch.bool or mask.shape != (W,)
            or mask.device != dev or not mask.is_contiguous()):
        raise ValueError(f"ota_receive_masked: mask must be a contiguous "
                         f"({W},) bool tensor on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    out = torch.empty(d, dtype=torch.float32, device=dev)
    build.launch("phy_channel", "ota_receive_masked", dev, s_re.data_ptr(),
                 s_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(),
                 mask.data_ptr(), noise_re.data_ptr(), inv_alpha.data_ptr(),
                 out.data_ptr(), W, d)
    return out
