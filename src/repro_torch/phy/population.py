"""Population-scale phy: advance every worker's wireless state in one step —
AR(1) fading, random-waypoint mobility, the on-arrival shadowing redraw and
the path gain.  Counterpart of ``repro/phy/population.py``.

* Frequency-flat fading (``h.numel() == N``): one B10 launch
  (``kernels/phy_population.py``) over the flat (N,) planes on CUDA, its
  plain version on the CPU.
* Wideband (N, d) fading: the planes do not share the (N,) grid, so the
  composed chain runs — ``fading.correlated_step`` (B9 on CUDA) →
  ``geometry.waypoint_shadow_step`` → ``geometry.worker_gains``, as the JAX
  package does.

Every random input (innovations, fresh waypoints, fresh shadowing) is an
argument.  :func:`autotune_population_step` sweeps B10's block size
(``block_rows``, ``REPRO_OTA_BLOCK_ROWS``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core.cplx import Complex
from repro_torch.kernels import phy_population as _k
from repro_torch.phy import fading as _fading
from repro_torch.phy import geometry as _geo
from repro_torch.phy.geometry import GeometryConfig

Tensor = torch.Tensor


def population_step(h: Complex, w: Optional[Complex], age: int, pos: Tensor,
                    dest: Tensor, shadow: Tensor, dest_fresh: Tensor,
                    shadow_fresh: Optional[Tensor], gcfg: GeometryConfig, *,
                    rho: float, coherence_iters: int,
                    block_rows: Optional[int] = None
                    ) -> Tuple[Complex, int, Tensor, Tensor, Tensor, Tensor]:
    """Advance fading + mobility + shadowing + path gain one slot.

    Args:
      h: small-scale fading, (N, d) (``(N, 1)`` when frequency-flat).
      w: AR(1) innovations of h's shape, needed only on a round that
        redraws (``fading.redraws(age, coherence_iters)``).
      age: host int, rounds since the last fading update.
      pos / dest: (N, 2) positions and waypoints; shadow: (N,) linear.
      dest_fresh: (N, 2) waypoints for the workers that arrive;
        shadow_fresh: (N,) shadowing for them (None when the shadowing std
        is 0).
      block_rows: B10's threads a block (None: ``REPRO_OTA_BLOCK_ROWS``);
        the frequency-flat case only.

    Returns ``(h', age', pos', dest', shadow', gain)`` with ``gain`` the
    (N,) linear power gains at the new positions.
    """
    n = pos.shape[0]
    if h.re.numel() == n:
        return _population_step_fused(h, w, age, pos, dest, shadow,
                                      dest_fresh, shadow_fresh, gcfg,
                                      rho=rho,
                                      coherence_iters=coherence_iters,
                                      block_rows=block_rows)
    h_new, age_new, _ = _fading.correlated_step(h, w, age, rho,
                                                coherence_iters)
    pos_n, dest_n, shadow_n = _geo.waypoint_shadow_step(
        pos, dest, shadow, dest_fresh, shadow_fresh, gcfg)
    return (h_new, age_new, pos_n, dest_n, shadow_n,
            _geo.worker_gains(pos_n, shadow_n, gcfg))


def _population_step_fused(h, w, age, pos, dest, shadow, dest_fresh,
                           shadow_fresh, gcfg, *, rho, coherence_iters,
                           block_rows=None):
    """One launch over the twelve (N,) planes.  On a round that holds the
    fading the kernel's gate ignores its innovation planes, so h stands in
    for them.  The x/y rows are contiguous when the positions are (N, 2)
    views of (2, N) buffers, which is how this function returns them."""
    shape = h.re.shape
    redraw = _fading.redraws(age, coherence_iters)
    if redraw and w is None:
        raise ValueError("population_step: this round redraws the fading "
                         "but no innovations were given")
    if not redraw:
        w = h
    sigma_on = gcfg.shadowing_sigma_db > 0.0
    pos_t, dest_t, fresh_t = (p.T.contiguous() for p in (pos, dest,
                                                         dest_fresh))
    hre, him, px, py, dx, dy, sh, gain = _k.population_step(
        h.re.reshape(-1), h.im.reshape(-1), w.re.reshape(-1),
        w.im.reshape(-1), pos_t[0], pos_t[1], dest_t[0], dest_t[1],
        fresh_t[0], fresh_t[1], shadow.contiguous(),
        (shadow_fresh if sigma_on else shadow).contiguous(),
        float(rho), _fading.innovation_scale(rho), redraw,
        gcfg.speed_mps * gcfg.slot_seconds, gcfg.ref_distance_m,
        gcfg.norm_distance_m, gcfg.pathloss_exp, sigma_on,
        block_rows=block_rows)
    return (Complex(hre.reshape(shape), him.reshape(shape)),
            0 if redraw else age + 1, torch.stack([px, py]).T,
            torch.stack([dx, dy]).T, sh, gain)


def autotune_population_step(n: int, gcfg: Optional[GeometryConfig] = None,
                             *, rho: float = 0.95, coherence_iters: int = 4,
                             block_rows_grid=(128, 256, 512, 1024),
                             iters: int = 10, device="cuda",
                             seed: int = 0) -> dict:
    """Sweep B10's block size (``block_rows``, threads a block) over
    ``block_rows_grid`` on a random frequency-flat N-worker population on
    ``device``: :func:`population_step` on a round that redraws the fading
    (the kernel's whole work), timed as the median of ``iters`` after a
    warm-up (CUDA events on a card).  Returns ``{"best": {"block_rows",
    "us"}, "table": [...]}``; the winner maps onto
    ``REPRO_OTA_BLOCK_ROWS``.  On the CPU the knob reaches no kernel, so
    one row is kept."""
    from repro_torch.core.channel import rayleigh
    from repro_torch.core.transport import median_ms
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if gcfg is None:
        gcfg = GeometryConfig(speed_mps=15.0, shadowing_sigma_db=6.0,
                              slot_seconds=1.0)
    gen = rng.generator(seed, dev)
    h = rayleigh(gen, (n, 1))
    w = rayleigh(gen, (n, 1))
    pos, dest = _geo.init_positions(gen, n, gcfg)
    fresh, _ = _geo.init_positions(gen, n, gcfg)
    shadow = _geo.shadowing(gen, n, gcfg)
    shadow_fresh = _geo.shadowing(gen, n, gcfg)
    grid = tuple(block_rows_grid) if dev.type == "cuda" \
        else tuple(block_rows_grid)[:1]
    table = []
    for br in grid:
        ms = median_ms(lambda: population_step(
            h, w, coherence_iters - 1, pos, dest, shadow, fresh,
            shadow_fresh, gcfg, rho=rho, coherence_iters=coherence_iters,
            block_rows=br), iters, dev)
        table.append({"block_rows": int(br), "us": 1e3 * ms})
    best = min(table, key=lambda r: r["us"])
    return {"best": best, "table": table}
