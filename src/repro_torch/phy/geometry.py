"""Large-scale channel gains: path loss, shadowing, and worker mobility.

Log-distance path loss with log-normal shadowing from per-worker positions
in a circular cell (the parameter server at the origin), plus a
random-waypoint mobility step.  The effective channel is
``h_eff = sqrt(g_n) · h_small``; gains are normalised to 1 at half the cell
radius, so the ``ChannelConfig`` SNR keeps meaning the average SNR at the
nominal link budget.  Counterpart of ``repro/phy/geometry.py``.

The draw functions take a ``torch.Generator``; the steps take their fresh
draws (waypoints, shadowing) as arguments, so a round can be replayed.
Positions are (n, 2) views of (2, n) buffers where the port makes them, so
the x and y rows that the population kernel reads are contiguous.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

#: ``fold_in`` salt of the on-arrival shadowing redraw: a side branch of the
#: waypoint key, so the redraw changes no draw of the mobility schedule
SHADOW_SALT = 0x5AD0


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Cell geometry + mobility parameters (3GPP-flavoured defaults)."""

    cell_radius_m: float = 500.0
    #: close-in reference distance d0 (gains saturate below it)
    ref_distance_m: float = 1.0
    #: log-distance path-loss exponent (urban macro ~3–4)
    pathloss_exp: float = 3.0
    #: log-normal shadowing std in dB (0 disables)
    shadowing_sigma_db: float = 0.0
    #: random-waypoint speed in m/s (0 freezes the workers)
    speed_mps: float = 0.0
    #: wall-clock seconds advanced per round (slot length)
    slot_seconds: float = 1e-3

    @property
    def norm_distance_m(self) -> float:
        """Distance at which the relative gain is 1 (mid-cell)."""
        return self.cell_radius_m / 2.0


def uniform_disk(gen: torch.Generator, n: int, radius: float) -> Tensor:
    """n points uniform over a disk of the given radius, on ``gen``'s
    device -> (n, 2)."""
    dev = gen.device
    r = radius * torch.sqrt(torch.rand(n, generator=gen, device=dev))
    ang = 2.0 * math.pi * torch.rand(n, generator=gen, device=dev)
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)]).T


def path_gain(dist_m: Tensor, gcfg: GeometryConfig) -> Tensor:
    """Relative linear power gain (d_norm / max(d, d0))^n, elementwise."""
    d = torch.clamp_min(dist_m, gcfg.ref_distance_m)
    return (gcfg.norm_distance_m / d) ** gcfg.pathloss_exp


def shadowing(gen: torch.Generator, n: int, gcfg: GeometryConfig) -> Tensor:
    """Per-worker log-normal shadowing as a linear power factor (n,), on
    ``gen``'s device; ones (and no draw) when the std is 0."""
    if gcfg.shadowing_sigma_db <= 0.0:
        return torch.ones(n, dtype=torch.float32, device=gen.device)
    db = gcfg.shadowing_sigma_db * torch.randn(n, generator=gen,
                                               device=gen.device)
    return 10.0 ** (db / 10.0)


def worker_gains(pos: Tensor, shadow_lin: Tensor,
                 gcfg: GeometryConfig) -> Tensor:
    """Linear power gain per worker from position + shadowing: (n,)."""
    dist = torch.sqrt(torch.sum(pos * pos, dim=-1))
    return (path_gain(dist, gcfg) * shadow_lin).to(torch.float32)


def init_positions(gen: torch.Generator, n: int,
                   gcfg: GeometryConfig) -> Tuple[Tensor, Tensor]:
    """(positions, waypoints), both (n, 2), uniform over the cell."""
    return (uniform_disk(gen, n, gcfg.cell_radius_m),
            uniform_disk(gen, n, gcfg.cell_radius_m))


def _advance(pos: Tensor, dest: Tensor, fresh: Tensor,
             gcfg: GeometryConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """Shared random-waypoint arithmetic: (pos', dest', arrived)."""
    step = gcfg.speed_mps * gcfg.slot_seconds
    delta = dest - pos
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1, keepdim=True))
    arrived = dist[:, 0] <= step
    unit = delta / torch.clamp_min(dist, 1e-9)
    pos_new = torch.where(arrived[:, None], dest, pos + step * unit)
    dest_new = torch.where(arrived[:, None], fresh, dest)
    return pos_new, dest_new, arrived


def waypoint_step(pos: Tensor, dest: Tensor, fresh: Tensor,
                  gcfg: GeometryConfig) -> Tuple[Tensor, Tensor]:
    """One random-waypoint move: advance ``speed·slot`` toward the waypoint;
    a worker that arrives takes its row of ``fresh`` (n, 2) as the next."""
    pos_new, dest_new, _ = _advance(pos, dest, fresh, gcfg)
    return pos_new, dest_new


def waypoint_shadow_step(pos: Tensor, dest: Tensor, shadow: Tensor,
                         fresh: Tensor, shadow_fresh: Optional[Tensor],
                         gcfg: GeometryConfig
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`waypoint_step` plus the shadowing redraw on arrival: a worker
    reaching its waypoint takes its row of ``shadow_fresh``; one that does
    not keeps its shadowing bitwise.  With ``shadowing_sigma_db <= 0``
    there is nothing to redraw (``shadow_fresh`` may be None) and ``shadow``
    passes through untouched."""
    pos_new, dest_new, arrived = _advance(pos, dest, fresh, gcfg)
    if gcfg.shadowing_sigma_db > 0.0:
        shadow = torch.where(arrived, shadow_fresh, shadow)
    return pos_new, dest_new, shadow
