"""Wrappers of the one-pass OTA round kernels in ``csrc/ota_round.cu``: B6
``ota_round_stats`` and B7 ``ota_round_theta``.

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version from ``kernels/ref.py``.  The
wrapper picks the kernel's plan and grid from the shape (:func:`tiling`):
the row plan for many workers, the column plan for few, and allocates the
partial-sum scratch it needs.  Either plan is one counted launch.  A caller
may hand a wrapper its ``plan`` instead.  The transport layer maps a column
tile (the autotuner's, ``FLConfig.ota_block_cols``, ``REPRO_OTA_BLOCK_COLS``)
onto a plan with :func:`tiling_for_cols`: 32, 64, 96 or 128 columns a block
for the row plan, 256 or 1,024 for the column plan at W ≤ 16.  Counterpart of
``repro/kernels/ota_round.py``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor

#: warps of a row-plan block (the kernel's kWarps)
WARPS = 8
#: most columns a lane takes in the row plan (the kernel's kMaxK)
MAX_COLS_PER_LANE = 4
#: SMs of an H100, for the row plan's grid and a default elsewhere
SMS = 132
#: blocks the row plan aims for: four per SM of an H100
TARGET_BLOCKS = 4 * SMS
#: gridDim.y, the most worker slices
MAX_SLICES = 65535
#: the most workers the column plan takes (the kernel's kColMaxWorkers)
MAX_COLUMN_WORKERS = 16
#: W below this takes the column plan: it beats the row plan at every W
#: from 2 to 16 (tools/sweep_ota_round.py)
COLUMN_BELOW = MAX_COLUMN_WORKERS + 1
#: threads of a column-plan block (the kernel's kColThreads)
COLUMN_THREADS = 256
#: column-plan blocks per SM: the blocks that fit an SM at once (the
#: kernel's kColMinBlocksPerSm), one wave (tools/sweep_ota_round.py)
COLUMN_BLOCKS_PER_SM = 3


class Tiling(NamedTuple):
    """A kernel's plan and grid.  ``plan`` is ``"row"`` or ``"column"`` for
    B6/B7, ``"split"`` or ``"unsplit"`` for B2 (``kernels/ota.py``).

    * row / split: a block is 8 warps over a tile of 32·``k`` columns and
      ``rows_per_slice`` worker rows; ``n_tiles`` × ``n_slices`` blocks.
    * column: each thread loads ``k`` floats at once (4: 16-byte loads, or
      1) and walks all ``rows_per_slice`` = W rows; ``n_tiles`` blocks
      stride over the columns, ``n_slices`` = 1.
    * unsplit: one thread per column, ``n_tiles`` blocks."""
    plan: str
    k: int
    rows_per_slice: int
    n_tiles: int
    n_slices: int


#: the ``block_cols`` of each plan: a row-plan block covers 32·k columns
#: of a tile (k = 1 … 4), a column-plan block 256·vec per stride (vec 1 or
#: 4, the float4 loads)
ROW_BLOCK_COLS = (32, 64, 96, 128)
COLUMN_BLOCK_COLS = (256, 1024)


def row_tiling(n_workers: int, d: int,
               target_blocks: int = TARGET_BLOCKS,
               k: Optional[int] = None) -> Tiling:
    """The row plan's grid for (W, d) planes: column tiles as wide as the
    row allows (or 32·``k`` columns), then the worker axis split until
    about ``target_blocks`` blocks are in flight (at least one row per warp
    in a slice).  (100, 109,386) gives 855 tiles of one slice; (65,536, 32)
    one tile of 525 slices."""
    if k is None:
        k = max(1, min(MAX_COLS_PER_LANE, -(-d // 32)))
    n_tiles = -(-d // (32 * k))
    want = max(1, min(-(-target_blocks // n_tiles), -(-n_workers // WARPS),
                      MAX_SLICES))
    rows = -(-n_workers // want)
    return Tiling("row", k, rows, n_tiles, -(-n_workers // rows))


def column_tiling(n_workers: int, d: int, n_sm: int = SMS,
                  aligned: bool = True,
                  blocks_per_sm: int = COLUMN_BLOCKS_PER_SM,
                  vec: Optional[int] = None) -> Tiling:
    """The column plan's grid: 16-byte loads where d % 4 == 0 and the
    planes are ``aligned`` (or ``vec`` floats a load), and
    ``blocks_per_sm`` blocks an SM, fewer where the columns run out
    first."""
    if vec is None:
        vec = 4 if aligned and d % 4 == 0 else 1
    groups = -(-d // vec)
    blocks = max(1, min(blocks_per_sm * n_sm, -(-groups // COLUMN_THREADS)))
    return Tiling("column", vec, n_workers, blocks, 1)


def tiling(n_workers: int, d: int, n_sm: int = SMS,
           aligned: bool = True) -> Tiling:
    """The plan for (W, d) planes on a card of ``n_sm`` SMs: the column
    plan for W < :data:`COLUMN_BELOW`, where the row plan's warps take too
    few rows to keep the loads in flight, else the row plan."""
    if n_workers < COLUMN_BELOW:
        return column_tiling(n_workers, d, n_sm, aligned)
    return row_tiling(n_workers, d)


def block_cols_choices(n_workers: int, d: int) -> Tuple[int, ...]:
    """The ``block_cols`` values the kernels can honour for (W, d) planes:
    the row plan's always, the column plan's for W ≤ 16 (1,024, its float4
    loads, only where d % 4 == 0)."""
    out = ROW_BLOCK_COLS
    if n_workers <= MAX_COLUMN_WORKERS:
        out += tuple(c for c in COLUMN_BLOCK_COLS if c == 256 or d % 4 == 0)
    return out


def check_block_cols(n_workers: int, d: int, block_cols: int) -> None:
    """ValueError naming the values the plans take, unless they take
    ``block_cols`` for (W, d) planes."""
    ok = block_cols_choices(n_workers, d)
    if block_cols not in ok:
        raise ValueError(f"ota_block_cols={block_cols}: the one-pass round "
                         f"kernels take {ok} for ({n_workers}, {d}) planes "
                         f"(32·k columns a row-plan block, 256·vec a "
                         f"column-plan block)")


def tiling_for_cols(n_workers: int, d: int, block_cols: int,
                    n_sm: int = SMS, aligned: bool = True) -> Tiling:
    """The plan whose block covers ``block_cols`` columns
    (:func:`block_cols_choices`); the column plan's 1,024 needs planes
    that start 16-byte ``aligned``."""
    check_block_cols(n_workers, d, block_cols)
    if block_cols in ROW_BLOCK_COLS:
        return row_tiling(n_workers, d, k=block_cols // 32)
    if block_cols == 1024 and not aligned:
        raise ValueError("ota_block_cols=1024 loads float4s and needs planes "
                         "that start on a 16-byte boundary")
    return column_tiling(n_workers, d, n_sm, aligned,
                         vec=block_cols // COLUMN_THREADS)


def block_cols_of(t: Tiling) -> int:
    """The columns a block of plan ``t`` covers (inverse of
    :func:`tiling_for_cols`)."""
    return (COLUMN_THREADS if t.plan == "column" else 32) * t.k


def check_tiling(name: str, t: Tiling, n_workers: int, d: int) -> None:
    """``t`` is a grid the kernels take for (W, d): the scratch the wrapper
    allocates follows from it."""
    plans = ("split", "unsplit") if name == "ota_receive" else ("row",
                                                                "column")
    if t.plan not in plans:
        ok = False
    elif t.plan in ("row", "split"):
        ok = (1 <= t.k <= MAX_COLS_PER_LANE and t.rows_per_slice >= 1
              and t.n_tiles == -(-d // (32 * t.k))
              and t.n_slices == -(-n_workers // t.rows_per_slice)
              and t.n_slices <= MAX_SLICES)
    elif t.plan == "column":
        ok = (t.k in (1, 4) and (t.k == 1 or d % 4 == 0)
              and t.rows_per_slice == n_workers
              and n_workers <= MAX_COLUMN_WORKERS and t.n_tiles >= 1
              and t.n_slices == 1)
    else:
        ok = (t.k == 1 and t.rows_per_slice == n_workers and t.n_tiles >= 1
              and t.n_slices == 1)
    if not ok:
        raise ValueError(f"{name}: no kernel takes {t} for ({n_workers}, "
                         f"{d}) planes")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count (cached per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned16(*tensors: Optional[Tensor]) -> bool:
    """Every given tensor starts on a 16-byte boundary."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


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


def _plan(name: str, plan: Optional[Tiling], dev: torch.device, W: int,
          d: int, *planes: Tensor) -> Tiling:
    """The given grid, checked; or :func:`tiling`'s for this card and these
    planes' alignment (the outputs are fresh allocations, 16-byte
    aligned)."""
    if plan is None:
        return tiling(W, d, sm_count(dev), aligned16(*planes))
    check_tiling(name, plan, W, d)
    return plan


def _chan_scalars(chan) -> list:
    if chan is None:
        return [0.0, 0.0, 0]
    _, _, rho_f, scale, redraw = chan
    return [float(rho_f), float(scale), int(bool(redraw))]


def ota_round_stats(theta: Tensor, lam_re: Tensor, lam_im: Tensor,
                    h_re: Tensor, h_im: Tensor, rho: float, *,
                    mask: Optional[Tensor] = None,
                    htx: Optional[Tuple[Tensor, Tensor]] = None,
                    chan: Optional[tuple] = None,
                    plan: Optional[Tiling] = None) -> Tuple[Tensor, ...]:
    """One pass over the (W, d) worker planes (B6): [AR(1) step] →
    modulate → per-worker energy → mask → y = Re{Σ h⊙s}, p2 = Σ|h|².

    ``mask``: (W,) bool; ``htx = (re, im)``: the workers' CSI, which
    modulates while the air applies h; ``chan = (w_re, w_im, rho_f, scale,
    redraw)`` fuses the fading step, with ``redraw`` a host bool.
    ``plan``: the kernel's grid, else :func:`tiling`'s.  Returns ``(y (d,),
    p2 (d,), energy (W,))``, plus the stepped channel's (W, d) planes with
    ``chan``."""
    if build.resolve_backend(theta.device) == "torch":
        return build.plain("ota_round_stats", ref.ota_round_stats, theta,
                           lam_re, lam_im, h_re, h_im, rho, mask=mask,
                           htx=htx, chan=chan)
    dev = _operands("ota_round_stats", theta, lam_re, lam_im, h_re, h_im,
                    mask, htx, chan)
    W, d = theta.shape
    t = _plan("ota_round_stats", plan, dev, W, d, theta, lam_re,
              lam_im, h_re, h_im, *(htx or ()), *(chan or ())[:2])
    y, p2, energy = _empty(dev, d), _empty(dev, d), _empty(dev, W)
    h_new = ((_empty(dev, W, d), _empty(dev, W, d)) if chan is not None
             else (None, None))
    common = _common_args(theta, lam_re, lam_im, h_re, h_im, mask, htx, chan)
    e_part = _empty(dev, W, t.n_tiles) if t.n_tiles > 1 else None
    if t.plan == "column":
        build.launch("ota_round", "ota_round_stats_cols", dev, *common,
                     *map(_ptr, (e_part, y, p2, energy, *h_new)),
                     W, d, t.k, t.n_tiles, 1.0 / rho, *_chan_scalars(chan),
                     count="ota_round_stats")
    else:
        y_part = p2_part = None
        if t.n_slices > 1:
            y_part, p2_part = (_empty(dev, d, t.n_slices),
                               _empty(dev, d, t.n_slices))
        build.launch("ota_round", "ota_round_stats", dev, *common,
                     *map(_ptr, (y_part, p2_part, e_part, y, p2, energy,
                                 *h_new)),
                     W, d, t.k, t.rows_per_slice, 1.0 / rho,
                     *_chan_scalars(chan))
    out = (y, p2, energy)
    return out if chan is None else out + h_new


def ota_round_theta(theta: Tensor, lam_re: Tensor, lam_im: Tensor,
                    h_re: Tensor, h_im: Tensor, noise_re: Tensor,
                    inv_alpha: Tensor, rho: float, *,
                    mask: Optional[Tensor] = None,
                    htx: Optional[Tuple[Tensor, Tensor]] = None,
                    chan: Optional[tuple] = None,
                    plan: Optional[Tiling] = None) -> Tuple[Tensor, ...]:
    """The whole round in one launch for an α known before the pass (B7):
    :func:`ota_round_stats` with the epilogue Θ = (y + z·α⁻¹)/max(p2,
    1e-12).  ``noise_re``: (d,); ``inv_alpha``: a one-element tensor on the
    device; ``plan`` as there.  Returns ``(Theta,)``,
    plus the stepped channel's planes with ``chan``."""
    if build.resolve_backend(theta.device) == "torch":
        return build.plain("ota_round_theta", ref.ota_round_theta, theta,
                           lam_re, lam_im, h_re, h_im, noise_re, inv_alpha,
                           rho, mask=mask, htx=htx, chan=chan)
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
    t = _plan("ota_round_theta", plan, dev, W, d, theta, lam_re,
              lam_im, h_re, h_im, noise_re, *(htx or ()),
              *(chan or ())[:2])
    Theta = _empty(dev, d)
    h_new = ((_empty(dev, W, d), _empty(dev, W, d)) if chan is not None
             else (None, None))
    common = _common_args(theta, lam_re, lam_im, h_re, h_im, mask, htx, chan)
    if t.plan == "column":
        build.launch("ota_round", "ota_round_theta_cols", dev, *common,
                     *map(_ptr, (noise_re, inv_alpha, Theta, *h_new)),
                     W, d, t.k, t.n_tiles, 1.0 / rho, *_chan_scalars(chan),
                     count="ota_round_theta")
    else:
        y_part = p2_part = None
        if t.n_slices > 1:
            y_part, p2_part = (_empty(dev, d, t.n_slices),
                               _empty(dev, d, t.n_slices))
        build.launch("ota_round", "ota_round_theta", dev, *common,
                     *map(_ptr, (noise_re, inv_alpha, y_part, p2_part, Theta,
                                 *h_new)),
                     W, d, t.k, t.rows_per_slice, 1.0 / rho,
                     *_chan_scalars(chan))
    return (Theta,) if chan is None else (Theta,) + h_new
