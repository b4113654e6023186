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
argument.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.cplx import Complex
from repro_torch.kernels import phy_population as _k
from repro_torch.phy import fading as _fading
from repro_torch.phy import geometry as _geo
from repro_torch.phy.geometry import GeometryConfig

Tensor = torch.Tensor


def population_step(h: Complex, w: Optional[Complex], age: int, pos: Tensor,
                    dest: Tensor, shadow: Tensor, dest_fresh: Tensor,
                    shadow_fresh: Optional[Tensor], gcfg: GeometryConfig, *,
                    rho: float, coherence_iters: int
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

    Returns ``(h', age', pos', dest', shadow', gain)`` with ``gain`` the
    (N,) linear power gains at the new positions.
    """
    n = pos.shape[0]
    if h.re.numel() == n:
        return _population_step_fused(h, w, age, pos, dest, shadow,
                                      dest_fresh, shadow_fresh, gcfg,
                                      rho=rho,
                                      coherence_iters=coherence_iters)
    h_new, age_new, _ = _fading.correlated_step(h, w, age, rho,
                                                coherence_iters)
    pos_n, dest_n, shadow_n = _geo.waypoint_shadow_step(
        pos, dest, shadow, dest_fresh, shadow_fresh, gcfg)
    return (h_new, age_new, pos_n, dest_n, shadow_n,
            _geo.worker_gains(pos_n, shadow_n, gcfg))


def _population_step_fused(h, w, age, pos, dest, shadow, dest_fresh,
                           shadow_fresh, gcfg, *, rho, coherence_iters):
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
        gcfg.norm_distance_m, gcfg.pathloss_exp, sigma_on)
    return (Complex(hre.reshape(shape), him.reshape(shape)),
            0 if redraw else age + 1, torch.stack([px, py]).T,
            torch.stack([dx, dy]).T, sh, gain)
