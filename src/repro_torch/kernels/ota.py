"""Wrappers of the over-the-air CUDA kernels in ``csrc/ota.cu``.

On CUDA tensors each wrapper checks its operands, allocates its outputs with
``torch.empty``, launches its kernel on the current stream and counts the
launch in ``build.launches``; it raises on anything the kernel does not
take.  On CPU tensors it returns the plain version from ``kernels/ref.py``
and launches nothing.  ``ota_receive`` has two plans
(:func:`receive_tiling`), each one counted launch.  Counterpart of
``repro/kernels/ota.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ota_round, ref
from repro_torch.kernels.ota_round import Tiling

Tensor = torch.Tensor

#: threads of a block of the unsplit receive (the kernel's kThreads) and
#: its most blocks (kMaxBlocks)
RECEIVE_THREADS = 256
RECEIVE_MAX_BLOCKS = 1 << 20
#: the split receive needs at least this many workers: at d = 32 it is
#: faster from W = 32 up (8.3 against 10.6 µs; tools/sweep_ota_round.py);
#: below that one thread walks its rows in a few µs and the finalize's
#: second launch costs as much
RECEIVE_SPLIT_MIN_ROWS = 32
#: blocks the split receive aims for (tools/sweep_ota_round.py)
RECEIVE_TARGET_BLOCKS = ota_round.TARGET_BLOCKS


def ota_modulate(theta: Tensor, lam_re: Tensor, lam_im: Tensor, h_re: Tensor,
                 h_im: Tensor, rho: float) -> Tuple[Tensor, Tensor]:
    """Fused s = conj(h)·θ + conj(λ)/ρ over planes of one shape (B1)."""
    if build.resolve_backend(theta.device) == "torch":
        return build.plain("ota_modulate", ref.ota_modulate, theta,
                           lam_re, lam_im, h_re, h_im, rho)
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


def receive_tiling(n_workers: int, d: int,
                   n_sm: int = ota_round.SMS) -> Tiling:
    """B2's plan: one thread per column (``"unsplit"``) where the columns'
    blocks fill the card's ``n_sm`` SMs or the workers are few; else the
    worker axis split as B6's row plan splits it (``"split"``, its grid
    from :func:`ota_round.row_tiling`).  (100, 109,386) stays unsplit;
    (65,536, 32) splits into 525 slices of 125 rows."""
    blocks = -(-d // RECEIVE_THREADS)
    if blocks < n_sm and n_workers >= RECEIVE_SPLIT_MIN_ROWS:
        t = ota_round.row_tiling(n_workers, d, RECEIVE_TARGET_BLOCKS)
        if t.n_slices > 1:
            return t._replace(plan="split")
    return Tiling("unsplit", 1, n_workers,
                  max(1, min(blocks, RECEIVE_MAX_BLOCKS)), 1)


def ota_receive(s_re: Tensor, s_im: Tensor, h_re: Tensor, h_im: Tensor,
                noise_re: Tensor, inv_alpha: Tensor, *,
                plan: Optional[Tiling] = None) -> Tensor:
    """Fused receive chain (B2): Θ = (Re{Σ_w h_w⊙s_w} + z·α⁻¹)/max(Σ|h|², 1e-12).

    s/h: (W, d) planes; noise_re: (d,); inv_alpha: a one-element tensor,
    read by the kernel on the device so the host never waits for it.
    ``plan``: the kernel's grid, :func:`receive_tiling`'s by default.
    Returns (d,) float32; one counted launch whichever plan runs."""
    if build.resolve_backend(s_re.device) == "torch":
        return build.plain("ota_receive", ref.ota_receive, s_re, s_im,
                           h_re, h_im, noise_re, inv_alpha)
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
    if plan is None:
        plan = receive_tiling(W, d, ota_round.sm_count(dev))
    ota_round.check_tiling("ota_receive", plan, W, d)
    out = torch.empty(d, dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (s_re, s_im, h_re, h_im, noise_re,
                                   inv_alpha)]
    if plan.plan == "unsplit":
        build.launch("ota", "ota_receive", dev, *ptrs, out.data_ptr(), W, d)
        return out
    parts = (None, None)          # (d, n_slices) y/p2 partials
    if plan.n_slices > 1:
        parts = tuple(torch.empty((d, plan.n_slices), dtype=torch.float32,
                                  device=dev) for _ in range(2))
    build.launch("ota", "ota_receive_split", dev, *ptrs,
                 *(None if p is None else p.data_ptr() for p in parts),
                 out.data_ptr(), W, d, plan.k, plan.rows_per_slice,
                 count="ota_receive")
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
        return build.plain("ota_demodulate_dyn", ref.ota_demodulate_dyn,
                           y_re, noise_re, sumh2, inv_alpha)
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
        return build.plain("ota_demodulate", ref.ota_demodulate, y_re,
                           noise_re, sumh2, float(inv_alpha))
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
        return build.plain("ota_accumulate", ref.ota_accumulate, y_re,
                           sumh2, s_re, s_im, h_re, h_im)
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
