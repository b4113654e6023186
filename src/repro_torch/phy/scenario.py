"""Wireless scenario engine: composable channel dynamics + participation.

A :class:`Scenario` advances a :class:`PhyState` over the ``(W, d)`` worker
planes: time-correlated (Jakes-Doppler) fading, path loss + shadowing from
per-worker positions with random-waypoint mobility, imperfect CSI
(``h_hat = h + CN(0, σ_e²)``), and deep-fade truncation (a worker whose RMS
channel amplitude falls below ``h_min`` skips the round).  Counterpart of
``repro/phy/scenario.py``.

JAX's keyed ``step`` is split in two so a round can be replayed:
:meth:`Scenario.draw` makes the round's random planes (:class:`PhyDraws`)
from the round key with the JAX package's key layout, and
:meth:`Scenario.step` does the arithmetic on given draws.  ``age`` is a host
integer, so whether a round redraws the fading is known on the host: the
innovations are drawn, and the B9 kernel launched, only on such rounds.

Presets (``make_scenario(name, ccfg)``):

======================  =====================================================
``static-iid``          one Rayleigh draw, frozen forever (convergence theory)
``block-fading``        the legacy block-fading channel (``rho = 0``)
``markov-doppler``      AR(1) fading, ``rho = J0(2π f_d T_slot)``, per round
``urban-mobility``      markov fading × path loss × shadowing × waypoint walk
``deep-fade-truncation``frequency-flat markov fading + ``|h| < h_min`` dropout
======================  =====================================================
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core import cplx
from repro_torch.core.channel import (ChannelConfig, awgn, rayleigh,
                                      rayleigh_rows)
from repro_torch.core.cplx import Complex
from repro_torch.phy import csi as _csi
from repro_torch.phy import fading as _fading
from repro_torch.phy import geometry as _geo
from repro_torch.phy import population as _pop
from repro_torch.phy.geometry import SHADOW_SALT, GeometryConfig

Tensor = torch.Tensor

#: "never" for the static preset
STATIC_COHERENCE = 1 << 30


@dataclasses.dataclass(frozen=True)
class PhyConfig:
    """Static description of one scenario's physics."""

    #: AR(1) fading correlation at coherence boundaries (0 = block fading)
    rho: float = 0.0
    #: rounds per fading update (legacy coherence block; 1 = every round)
    coherence_iters: int = 10
    #: wall-clock slots the physics advances per round.  A record of what
    #: :func:`make_scenario` resolved into ``rho`` and
    #: ``geometry.slot_seconds``; ``step`` never reads it.
    slots_per_round: int = 1
    #: worker CSI error std σ_e (0 = perfect CSI)
    csi_err: float = 0.0
    #: participation threshold on the per-worker RMS |h| (0 = everyone
    #: transmits every round)
    h_min: float = 0.0
    #: frequency-flat small-scale fading: one scalar fade per worker,
    #: broadcast over the coefficients
    freq_flat: bool = False
    #: large-scale gains + mobility (None = unit gains, no positions)
    geometry: Optional[GeometryConfig] = None


class PhyState(NamedTuple):
    """Per-round channel state over the ``(W, d)`` planes.  Optional fields
    are None when the scenario's physics does not use them."""

    h: Complex                       # effective air channel (W, d)
    h_small: Optional[Complex]       # unit-power AR(1) state (None: h is it)
    h_hat: Optional[Complex]         # worker-side CSI (None: perfect)
    gain: Optional[Tensor]           # (W,) linear power gains
    shadow: Optional[Tensor]         # (W,) shadowing factors
    pos: Optional[Tensor]            # (W, 2) worker positions
    dest: Optional[Tensor]           # (W, 2) random-waypoint targets
    mask: Optional[Tensor]           # (W,) bool participation this round
    age: int                         # rounds since the last fading update


class PhyDraws(NamedTuple):
    """Every random plane one :meth:`Scenario.step` reads (None where the
    scenario or the round needs none).

    w: AR(1) innovations CN(0, 1) of ``h_small``'s shape, on rounds that
      update the fading.
    dest_fresh: (W, 2) waypoints for workers that arrive (mobile).
    shadow_fresh: (W,) shadowing for workers that arrive (mobile, with a
      shadowing std > 0).
    csi_err: CN(0, σ_e²) CSI error, (W, 1) when frequency-flat else (W, d)
      (imperfect CSI).
    """

    w: Optional[Complex] = None
    dest_fresh: Optional[Tensor] = None
    shadow_fresh: Optional[Tensor] = None
    csi_err: Optional[Complex] = None


def h_tx(state: PhyState) -> Complex:
    """The channel the workers act on: their CSI if imperfect, else h."""
    return state.h if state.h_hat is None else state.h_hat


def participation_mask(h: Complex, h_min: float) -> Tensor:
    """Paper-style truncation: sqrt(mean_i |h_{n,i}|²) >= h_min -> (W,) bool.
    For frequency-flat fading the RMS is the scalar ``|h_n|``."""
    return torch.sqrt(torch.mean(cplx.abs2(h), dim=-1)) >= h_min


def _broadcast_flat(h_small: Complex, d: int) -> Complex:
    """(W, 1) scalar fades -> (W, d) planes, as broadcast views.  The
    transport copies them into contiguous planes before each kernel."""
    W = h_small.re.shape[0]
    return Complex(h_small.re.expand(W, d), h_small.im.expand(W, d))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, immutable scenario: ``init``, ``draw`` and ``step`` over
    :class:`PhyState`."""

    name: str
    cfg: PhyConfig
    #: the fading's rows keyed by worker (``channel.rayleigh_rows``: the
    #: LLM trainer's draw, so its ``block-fading`` scenario is its packed
    #: block bit for bit); else the whole plane from one key (the flat
    #: trainer's, whose legacy channel draws so)
    row_keyed: bool = False

    @property
    def truncating(self) -> bool:
        return self.cfg.h_min > 0.0

    @property
    def imperfect_csi(self) -> bool:
        return self.cfg.csi_err > 0.0

    @property
    def has_geometry(self) -> bool:
        return self.cfg.geometry is not None

    @property
    def mobile(self) -> bool:
        g = self.cfg.geometry
        return g is not None and g.speed_mps > 0.0

    @property
    def _plain_fading(self) -> bool:
        """The only randomness is the fading draw: the key then feeds it
        whole, as the legacy channel's redraw does."""
        return not (self.has_geometry or self.imperfect_csi)

    @property
    def _static(self) -> bool:
        """static-iid: the channel never moves, so a round draws nothing."""
        return (self.cfg.coherence_iters >= STATIC_COHERENCE
                and self._plain_fading and not self.mobile)

    def _keys(self, key: int,
              shard: Optional[int] = None) -> Tuple[int, int, int]:
        """(fading, geometry, CSI) keys.  With ``shard`` (a mesh rank's
        shard of the (W, d) planes) the per-element fading and CSI draw
        from the shard's folds, and what is per worker (the geometry, a
        frequency-flat fade) from the keys every shard shares."""
        if self._plain_fading:
            kf = kg = kc = key  # geometry/csi keys unused
        else:
            kf, kg, kc = rng.split(key, 3)
        if shard is not None and not self.cfg.freq_flat:
            kf, kc = rng.fold_in(kf, shard), rng.fold_in(kc, shard)
        return kf, kg, kc

    def changed(self, state: PhyState) -> bool:
        """Did the channel redraw discontinuously this round?  This drives
        the flip rule, whose premise is a fresh i.i.d. block: only the
        ``rho = 0`` redraw is such a jump.  AR(1) mixing and mobility drift
        continuously, and flagging them would freeze θ every round."""
        if self.cfg.rho > 0.0:
            return False
        return state.age == 0

    def _fading(self, key: int, n_workers: int, d: int, device) -> Complex:
        """A (W, d) Rayleigh plane of the fading, by :attr:`row_keyed`'s
        rule."""
        if self.row_keyed:
            return rayleigh_rows(key, range(n_workers), d, device)
        return rayleigh(rng.generator(key, device), (n_workers, d))

    def _csi_shape(self, n_workers: int, d: int) -> Tuple[int, int]:
        # narrowband: ONE error per worker, drawn on the (W, 1) scalar
        return (n_workers, 1) if self.cfg.freq_flat else (n_workers, d)

    def _draw_csi(self, kc: int, shape, device) -> Optional[Complex]:
        if not self.imperfect_csi:
            return None
        return awgn(rng.generator(kc, device), shape, self.cfg.csi_err ** 2)

    def init(self, key: int, n_workers: int, d: int, device,
             shard: Optional[int] = None,
             mask_fn: Optional[Callable[[Complex], Tensor]] = None
             ) -> PhyState:
        """The scenario's first state over (``n_workers``, ``d``) planes.
        ``mask_fn`` replaces :func:`participation_mask` (a shard grid's
        planes hold a slice of each row, so its RMS needs the grid's
        sum)."""
        cfg = self.cfg
        kf, kg, kc = self._keys(key, shard)
        h_small = self._fading(kf, n_workers, 1 if cfg.freq_flat else d,
                               device)
        gain = shadow = pos = dest = None
        if self.has_geometry:
            kp, ks = rng.split(kg)
            pos, dest = _geo.init_positions(rng.generator(kp, device),
                                            n_workers, cfg.geometry)
            shadow = _geo.shadowing(rng.generator(ks, device), n_workers,
                                    cfg.geometry)
            gain = _geo.worker_gains(pos, shadow, cfg.geometry)
        return self._assemble(h_small, gain, shadow, pos, dest, 0, d,
                              self._draw_csi(kc, self._csi_shape(n_workers, d),
                                             device), mask_fn)

    def draw(self, key: int, state: PhyState,
             shard: Optional[int] = None) -> PhyDraws:
        """The random planes of one :meth:`step` from ``state``, drawn from
        ``key`` on the state's device.  The key splits three ways (fading,
        geometry, CSI) unless the fading is the only randomness; the fresh
        shadowing is the ``SHADOW_SALT`` side branch of the geometry key.
        ``shard``: as :meth:`init`'s, a mesh rank's shard of the planes."""
        if self._static:
            return PhyDraws()
        cfg = self.cfg
        dev = state.h.re.device
        kf, kg, kc = self._keys(key, shard)
        h_small = state.h if state.h_small is None else state.h_small
        w = None
        if _fading.redraws(state.age, cfg.coherence_iters):
            w = self._fading(kf, *h_small.re.shape, dev)
        dest_fresh = shadow_fresh = None
        if self.mobile:
            n = state.pos.shape[0]
            dest_fresh = _geo.uniform_disk(rng.generator(kg, dev), n,
                                           cfg.geometry.cell_radius_m)
            if cfg.geometry.shadowing_sigma_db > 0.0:
                shadow_fresh = _geo.shadowing(
                    rng.generator(rng.fold_in(kg, SHADOW_SALT), dev), n,
                    cfg.geometry)
        W, d = state.h.re.shape
        return PhyDraws(w=w, dest_fresh=dest_fresh, shadow_fresh=shadow_fresh,
                        csi_err=self._draw_csi(kc, self._csi_shape(W, d), dev))

    def step(self, state: PhyState, draws: PhyDraws,
             mask_fn: Optional[Callable[[Complex], Tensor]] = None
             ) -> PhyState:
        """Advance one round on the given draws (:meth:`draw`); ``mask_fn``
        as :meth:`init`'s."""
        cfg = self.cfg
        if self._static:
            return state._replace(age=state.age + 1)
        h_small = state.h if state.h_small is None else state.h_small
        gain, shadow, pos, dest = (state.gain, state.shadow, state.pos,
                                   state.dest)
        if self.mobile:
            h_small, age, pos, dest, shadow, gain = _pop.population_step(
                h_small, draws.w, state.age, pos, dest, shadow,
                draws.dest_fresh, draws.shadow_fresh, cfg.geometry,
                rho=cfg.rho, coherence_iters=cfg.coherence_iters)
        else:
            h_small, age, _ = _fading.correlated_step(
                h_small, draws.w, state.age, cfg.rho, cfg.coherence_iters)
        return self._assemble(h_small, gain, shadow, pos, dest, age,
                              state.h.re.shape[-1], draws.csi_err, mask_fn)

    def _assemble(self, h_small: Complex, gain, shadow, pos, dest, age: int,
                  d: int, csi_err: Optional[Complex],
                  mask_fn: Optional[Callable[[Complex], Tensor]] = None
                  ) -> PhyState:
        """Derive (h, h_hat, mask) from the independent state components."""
        cfg = self.cfg
        if cfg.freq_flat:
            h_narrow = (cplx.scale(h_small, torch.sqrt(gain)[:, None])
                        if gain is not None else h_small)
            hat_narrow = (_csi.estimate(h_narrow, csi_err, cfg.csi_err)
                          if self.imperfect_csi else None)
            h = _broadcast_flat(h_narrow, d)
            h_hat = (None if hat_narrow is None
                     else _broadcast_flat(hat_narrow, d))
            # the (W, 1) plane carries the mask's full information
            known = h_narrow if hat_narrow is None else hat_narrow
        else:
            h = (cplx.scale(h_small, torch.sqrt(gain)[:, None])
                 if gain is not None else h_small)
            h_hat = (_csi.estimate(h, csi_err, cfg.csi_err)
                     if self.imperfect_csi else None)
            known = h if h_hat is None else h_hat
        # the truncation decision is the worker's: it knows only its CSI
        mask = None
        if self.truncating:
            mask = (participation_mask(known, cfg.h_min) if mask_fn is None
                    else mask_fn(known))
        keep_small = cfg.freq_flat or gain is not None
        return PhyState(h=h, h_small=h_small if keep_small else None,
                        h_hat=h_hat, gain=gain, shadow=shadow, pos=pos,
                        dest=dest, mask=mask, age=age)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: preset -> PhyConfig overrides; ``doppler_hz`` resolves to ``rho`` via
#: the Jakes model at build time (rho = J0(2π f_d · slot · coherence)).
PRESETS: Dict[str, Dict[str, Any]] = {
    "static-iid": dict(rho=0.0, coherence_iters=STATIC_COHERENCE),
    "block-fading": dict(rho=0.0),
    "markov-doppler": dict(doppler_hz=50.0, coherence_iters=1),
    "urban-mobility": dict(
        doppler_hz=100.0, coherence_iters=1,
        geometry=GeometryConfig(speed_mps=15.0, shadowing_sigma_db=6.0,
                                pathloss_exp=3.2)),
    "deep-fade-truncation": dict(doppler_hz=50.0, coherence_iters=1,
                                 freq_flat=True, h_min=0.5),
}


def list_scenarios() -> Tuple[str, ...]:
    return tuple(PRESETS)


def make_scenario(name: str, ccfg: Optional[ChannelConfig] = None, *,
                  doppler_hz: Optional[float] = None,
                  csi_err: Optional[float] = None,
                  h_min: Optional[float] = None,
                  coherence_iters: Optional[int] = None,
                  rho: Optional[float] = None,
                  geometry: Optional[GeometryConfig] = None,
                  freq_flat: Optional[bool] = None,
                  slots_per_round: Optional[int] = None,
                  row_keyed: bool = False) -> Scenario:
    """Build a preset scenario, with per-experiment overrides.

    ``ccfg`` supplies the slot length (Doppler → rho conversion) and the
    default coherence block; explicit keyword overrides win over the preset,
    which wins over the ``ChannelConfig`` defaults.  There is one slot
    clock: the geometry's ``slot_seconds`` is set to the slot the Doppler
    conversion uses, scaled by ``slots_per_round``, so fading decorrelation
    and waypoint mobility advance in lock-step.  ``row_keyed``: the
    fading drawn by :attr:`Scenario.row_keyed`'s rule (the LLM trainer's).
    """
    if name not in PRESETS:
        raise ValueError(
            f"unknown scenario {name!r}; want one of {list_scenarios()}")
    p = dict(PRESETS[name])
    spr = int(slots_per_round if slots_per_round is not None
              else p.get("slots_per_round", 1))
    if spr < 1:
        raise ValueError(f"slots_per_round must be >= 1, got {spr}")
    slot = (ccfg.slot_seconds if ccfg is not None else 1e-3) * spr
    coh = coherence_iters if coherence_iters is not None else p.get(
        "coherence_iters", ccfg.coherence_iters if ccfg is not None else 10)

    f_d = doppler_hz if doppler_hz is not None else p.get("doppler_hz")
    if rho is not None:
        rho_val = float(rho)
    elif f_d is not None:
        rho_val = _fading.doppler_rho(f_d, slot * coh)
    else:
        rho_val = float(p.get("rho", 0.0))

    geom = geometry if geometry is not None else p.get("geometry")
    if geom is not None and geom.slot_seconds != slot:
        geom = dataclasses.replace(geom, slot_seconds=slot)

    cfg = PhyConfig(
        rho=rho_val,
        coherence_iters=int(coh),
        csi_err=float(csi_err if csi_err is not None else p.get("csi_err", 0.0)),
        h_min=float(h_min if h_min is not None else p.get("h_min", 0.0)),
        freq_flat=bool(freq_flat if freq_flat is not None
                       else p.get("freq_flat", False)),
        geometry=geom,
        slots_per_round=spr,
    )
    return Scenario(name=name, cfg=cfg, row_keyed=row_keyed)
