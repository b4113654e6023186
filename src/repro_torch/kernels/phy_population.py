"""Wrapper of the population-scale phy kernel in ``csrc/phy_population.cu``
(B10 ``population_step``).

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version from ``kernels/ref.py``.
Counterpart of ``repro/kernels/phy_population.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import optflags
from repro_torch.kernels import build, ref

Tensor = torch.Tensor

_PLANES = ("h_re", "h_im", "w_re", "w_im", "pos_x", "pos_y", "dest_x",
           "dest_y", "fresh_x", "fresh_y", "shadow", "shadow_fresh")


def population_step(h_re: Tensor, h_im: Tensor, w_re: Tensor, w_im: Tensor,
                    pos_x: Tensor, pos_y: Tensor, dest_x: Tensor,
                    dest_y: Tensor, fresh_x: Tensor, fresh_y: Tensor,
                    shadow: Tensor, shadow_fresh: Tensor, rho: float,
                    scale: float, redraw: bool, step: float, ref_d: float,
                    norm_d: float, pexp: float, shadow_redraw: bool, *,
                    block_rows: Optional[int] = None) -> Tuple[Tensor, ...]:
    """One fused phy slot over twelve flat (N,) planes (B10).

    Inputs: the fading planes and their innovations, position, waypoint and
    fresh-waypoint x/y planes, shadowing and fresh shadowing.  Scalars: the
    AR(1) ``rho``/``scale``/``redraw`` gate, the waypoint ``step`` =
    speed·slot, the path-loss ``ref_d``/``norm_d``/``pexp``, and the
    ``shadow_redraw`` switch.  Returns ``(h_re', h_im', pos_x', pos_y',
    dest_x', dest_y', shadow', gain)``, each (N,) float32; on CUDA they are
    the rows of one (8, N) buffer.  ``block_rows``: the kernel's threads a
    block, a multiple of 32 up to 1024 (None: ``REPRO_OTA_BLOCK_ROWS``,
    256 by default; the knob ``phy.population.autotune_population_step``
    sweeps)."""
    planes = (h_re, h_im, w_re, w_im, pos_x, pos_y, dest_x, dest_y, fresh_x,
              fresh_y, shadow, shadow_fresh)
    scalars = (rho, scale, redraw, step, ref_d, norm_d, pexp, shadow_redraw)
    threads = check_block_rows(optflags.ota_block_rows() if block_rows is None
                               else block_rows)
    if build.resolve_backend(h_re.device) == "torch":
        return ref.population_step(*planes, *scalars)
    dev = build.check_cuda_f32("population_step", **dict(zip(_PLANES, planes)))
    n = h_re.numel()
    for name, t in zip(_PLANES, planes):
        if t.shape != (n,):
            raise ValueError(f"population_step: {name} has shape "
                             f"{tuple(t.shape)}, want ({n},)")
    out = torch.empty((8, n), dtype=torch.float32, device=dev)
    base = out.data_ptr()
    build.launch("phy_population", "population_step", dev,
                 *(t.data_ptr() for t in planes),
                 *(base + 4 * n * k for k in range(8)), n, float(rho),
                 float(scale), int(bool(redraw)), float(step), float(ref_d),
                 float(norm_d), float(pexp), int(bool(shadow_redraw)), threads)
    return tuple(out.unbind(0))


def check_block_rows(block_rows: int) -> int:
    """``block_rows`` if the kernel takes it as its block size (a multiple
    of 32 from 32 to 1024), else ValueError naming what it takes."""
    b = int(block_rows)
    if b < 32 or b > 1024 or b % 32:
        raise ValueError(f"population_step: block_rows {block_rows} is not "
                         f"a block size the kernel takes (a multiple of 32 "
                         f"from 32 to 1024)")
    return b
