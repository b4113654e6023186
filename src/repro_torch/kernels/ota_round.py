"""Wrappers of the one-pass OTA round kernels in ``csrc/ota_round.cu``: B6
``ota_round_stats`` and B7 ``ota_round_theta``.

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version from ``kernels/ref.py``.  The
wrapper picks the kernel's 2-D tiling from the shape (:func:`tiling`) and
allocates the partial-sum scratch it needs.  Counterpart of
``repro/kernels/ota_round.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor

#: warps of a block (the kernel's kWarps)
WARPS = 8
#: most columns a lane takes (the kernel's kMaxK)
MAX_COLS_PER_LANE = 4
#: blocks to aim for: four per SM of an H100's 132
TARGET_BLOCKS = 4 * 132
#: gridDim.y, the most worker slices
MAX_SLICES = 65535


class Tiling(NamedTuple):
    k: int               # columns per lane: a block's tile is 32·k columns
    rows_per_slice: int  # worker rows of a block
    n_tiles: int
    n_slices: int


def tiling(n_workers: int, d: int) -> Tiling:
    """The kernel's grid for (W, d) planes: column tiles as wide as the
    row allows, then the worker axis split until about
    :data:`TARGET_BLOCKS` blocks are in flight (at least one row per warp
    in a slice).  (100, 109,386) gives 855 tiles of one slice; (65,536, 32)
    one tile of 525 slices."""
    k = max(1, min(MAX_COLS_PER_LANE, -(-d // 32)))
    n_tiles = -(-d // (32 * k))
    want = max(1, min(-(-TARGET_BLOCKS // n_tiles), -(-n_workers // WARPS),
                      MAX_SLICES))
    rows = -(-n_workers // want)
    return Tiling(k, rows, n_tiles, -(-n_workers // rows))


def _operands(name: str, theta, lam_re, lam_im, h_re, h_im, mask, htx, chan):
    planes = dict(theta=theta, lam_re=lam_re, lam_im=lam_im, h_re=h_re,
                  h_im=h_im)
    if htx is not None:
        planes.update(tx_re=htx[0], tx_im=htx[1])
    if chan is not None:
        planes.update(w_re=chan[0], w_im=chan[1])
    dev = build.check_cuda_f32(name, **planes)
    if theta.dim() != 2:
        raise ValueError(f"{name}: want (W, d) planes, got "
                         f"{tuple(theta.shape)}")
    for arg, t in planes.items():
        if t.shape != theta.shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"theta {tuple(theta.shape)}")
    W = theta.shape[0]
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (W,)
                             or mask.device != dev
                             or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be a contiguous ({W},) bool "
                         f"tensor on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    return dev


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def _empty(dev: torch.device, *shape: int) -> Tensor:
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _common_args(theta, lam_re, lam_im, h_re, h_im, mask, htx, chan):
    tx = (None, None) if htx is None else htx
    w = (None, None) if chan is None else chan[:2]
    return [_ptr(t) for t in (theta, lam_re, lam_im, h_re, h_im, *tx, *w,
                              mask)]


def _chan_scalars(chan) -> list:
    if chan is None:
        return [0.0, 0.0, 0]
    _, _, rho_f, scale, redraw = chan
    return [float(rho_f), float(scale), int(bool(redraw))]


def ota_round_stats(theta: Tensor, lam_re: Tensor, lam_im: Tensor,
                    h_re: Tensor, h_im: Tensor, rho: float, *,
                    mask: Optional[Tensor] = None,
                    htx: Optional[Tuple[Tensor, Tensor]] = None,
                    chan: Optional[tuple] = None) -> Tuple[Tensor, ...]:
    """One pass over the (W, d) worker planes (B6): [AR(1) step] →
    modulate → per-worker energy → mask → y = Re{Σ h⊙s}, p2 = Σ|h|².

    ``mask``: (W,) bool; ``htx = (re, im)``: the workers' CSI, which
    modulates while the air applies h; ``chan = (w_re, w_im, rho_f, scale,
    redraw)`` fuses the fading step, with ``redraw`` a host bool.  Returns
    ``(y (d,), p2 (d,), energy (W,))``, plus the stepped channel's (W, d)
    planes with ``chan``."""
    if build.resolve_backend(theta.device) == "torch":
        return ref.ota_round_stats(theta, lam_re, lam_im, h_re, h_im, rho,
                                   mask=mask, htx=htx, chan=chan)
    dev = _operands("ota_round_stats", theta, lam_re, lam_im, h_re, h_im,
                    mask, htx, chan)
    W, d = theta.shape
    t = tiling(W, d)
    y, p2, energy = _empty(dev, d), _empty(dev, d), _empty(dev, W)
    y_part = p2_part = e_part = None
    if t.n_slices > 1:
        y_part, p2_part = _empty(dev, d, t.n_slices), _empty(dev, d,
                                                             t.n_slices)
    if t.n_tiles > 1:
        e_part = _empty(dev, W, t.n_tiles)
    h_new = ((_empty(dev, W, d), _empty(dev, W, d)) if chan is not None
             else (None, None))
    build.launch("ota_round", "ota_round_stats", dev,
                 *_common_args(theta, lam_re, lam_im, h_re, h_im, mask, htx,
                               chan),
                 *map(_ptr, (y_part, p2_part, e_part, y, p2, energy,
                             *h_new)),
                 W, d, t.k, t.rows_per_slice, 1.0 / rho, *_chan_scalars(chan))
    out = (y, p2, energy)
    return out if chan is None else out + h_new


def ota_round_theta(theta: Tensor, lam_re: Tensor, lam_im: Tensor,
                    h_re: Tensor, h_im: Tensor, noise_re: Tensor,
                    inv_alpha: Tensor, rho: float, *,
                    mask: Optional[Tensor] = None,
                    htx: Optional[Tuple[Tensor, Tensor]] = None,
                    chan: Optional[tuple] = None) -> Tuple[Tensor, ...]:
    """The whole round in one launch for an α known before the pass (B7):
    :func:`ota_round_stats` with the epilogue Θ = (y + z·α⁻¹)/max(p2,
    1e-12).  ``noise_re``: (d,); ``inv_alpha``: a one-element tensor on the
    device.  Returns ``(Theta,)``, plus the stepped channel's planes with
    ``chan``."""
    if build.resolve_backend(theta.device) == "torch":
        return ref.ota_round_theta(theta, lam_re, lam_im, h_re, h_im,
                                   noise_re, inv_alpha, rho, mask=mask,
                                   htx=htx, chan=chan)
    if not isinstance(inv_alpha, torch.Tensor) or inv_alpha.numel() != 1:
        raise ValueError("ota_round_theta: inv_alpha must be a one-element "
                         "tensor on the device")
    dev = _operands("ota_round_theta", theta, lam_re, lam_im, h_re, h_im,
                    mask, htx, chan)
    build.check_cuda_f32("ota_round_theta", theta=theta, noise_re=noise_re,
                         inv_alpha=inv_alpha)
    W, d = theta.shape
    if noise_re.shape != (d,):
        raise ValueError(f"ota_round_theta: noise_re has shape "
                         f"{tuple(noise_re.shape)}, want ({d},)")
    t = tiling(W, d)
    Theta = _empty(dev, d)
    y_part = p2_part = None
    if t.n_slices > 1:
        y_part, p2_part = _empty(dev, d, t.n_slices), _empty(dev, d,
                                                             t.n_slices)
    h_new = ((_empty(dev, W, d), _empty(dev, W, d)) if chan is not None
             else (None, None))
    build.launch("ota_round", "ota_round_theta", dev,
                 *_common_args(theta, lam_re, lam_im, h_re, h_im, mask, htx,
                               chan),
                 *map(_ptr, (noise_re, inv_alpha, y_part, p2_part, Theta,
                             *h_new)),
                 W, d, t.k, t.rows_per_slice, 1.0 / rho, *_chan_scalars(chan))
    return (Theta,) if chan is None else (Theta,) + h_new
