"""Fault injection for OTA rounds: crash, straggle, corrupt, interfere.

A :class:`FaultPlan` is a static description of the fault process; the
evolving part lives in a :class:`FaultState` that rides in
``AFadmmState.flt``, as ``PhyState`` rides in ``phys``.  Counterpart of
``repro/faults/plan.py``.

* **crash** — permanent departure (``FaultState.alive`` only ever loses
  workers): a per-round hazard ``crash_prob`` from round ``crash_start``,
  capped at ``max_crash_frac`` dead, and/or the deterministic ``crash_at =
  ((round, worker), ...)`` schedule.  The last live worker is never crashed.
* **straggler staleness** — a straggler uploads the snapshot taken at the
  last round that is a multiple of ``straggler_delay``.
* **corrupted uplink** — a row's transmitted planes become NaN, Inf or
  ``spike_gain``·θ; workers ``[0, nan_workers)`` corrupt every upload.
* **burst interference** — with probability ``burst_prob`` the round's
  receiver picks up a burst of std ``burst_std`` on its noise plane.

Faults apply to what the air sees, never to a worker's own state.  The
round's uniforms arrive ready-made in a :class:`FaultDraws`
(:func:`draw_uniforms` makes them with JAX's key layout), so a test can
replay the JAX package's draws; the round counter is a host integer.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import rng

Tensor = torch.Tensor

#: fold_in salt separating the fault process from batch/noise/channel keys
FAULT_SALT = 0x0FA17

_CORRUPT_MODES = ("nan", "inf", "spike")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Static fault-process description.  All-zero defaults mean "no faults
    of that kind"."""

    crash_prob: float = 0.0          # per-round per-worker hazard
    crash_start: int = 0             # first round the hazard is active
    max_crash_frac: float = 0.5      # hazard stops once this frac is dead
    crash_at: Tuple[Tuple[int, int], ...] = ()   # ((round, worker), ...)
    straggler_prob: float = 0.0      # per-round per-worker staleness
    straggler_delay: int = 4         # snapshot cadence; staleness < delay
    nan_workers: int = 0             # workers [0, k) corrupt every round
    corrupt_prob: float = 0.0        # transient corruption hazard
    corrupt_mode: str = "nan"        # "nan" | "inf" | "spike"
    spike_gain: float = 1e4          # gain for corrupt_mode="spike"
    burst_prob: float = 0.0          # per-round receiver interference hazard
    burst_std: float = 10.0          # interference std at the matched filter

    def __post_init__(self):
        if self.corrupt_mode not in _CORRUPT_MODES:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}; "
                             f"expected one of {_CORRUPT_MODES}")
        if self.straggler_prob > 0 and self.straggler_delay < 1:
            raise ValueError("straggler_delay must be >= 1")

    @property
    def has_stragglers(self) -> bool:
        return self.straggler_prob > 0.0

    @property
    def has_corruption(self) -> bool:
        return self.corrupt_prob > 0.0 or self.nan_workers > 0

    @property
    def has_bursts(self) -> bool:
        return self.burst_prob > 0.0


class FaultState(NamedTuple):
    """Evolving fault-process state."""

    alive: Tensor                # (W,) bool, only ever loses workers
    stale: Optional[Tensor]      # (W, d) f32 snapshot; None: no stragglers
    round: int                   # global round counter (host)
    n_evicted: Tensor            # () int32 guard evictions so far


class FaultDraws(NamedTuple):
    """One round's uniforms on [0, 1): ``crash``, ``straggler`` and
    ``corrupt`` (W,) and ``burst`` (), each only where the plan has that
    kind of fault, else None."""

    crash: Optional[Tensor] = None
    straggler: Optional[Tensor] = None
    corrupt: Optional[Tensor] = None
    burst: Optional[Tensor] = None


class RoundFaults(NamedTuple):
    """One round's fault draw: everything :func:`apply_uplink` and the
    transport need, with no dependence on θ."""

    alive: Tensor                 # (W,) bool, post-crash
    straggler: Optional[Tensor]   # (W,) bool
    corrupt: Optional[Tensor]     # (W,) bool
    snapshot_due: Optional[bool]  # refresh the stale buffer this round
    burst_std: Optional[Tensor]   # () f32, 0.0 on burst-free rounds


def init(plan: FaultPlan, n_workers: int, d: int, device) -> FaultState:
    """Fresh state: everyone alive, stale buffer zeroed (round 0 is always
    a snapshot round, so the zeros are never uploaded)."""
    stale = (torch.zeros((n_workers, d), dtype=torch.float32, device=device)
             if plan.has_stragglers else None)
    return FaultState(
        alive=torch.ones(n_workers, dtype=torch.bool, device=device),
        stale=stale, round=0,
        n_evicted=torch.zeros((), dtype=torch.int32, device=device))


def draw_uniforms(plan: FaultPlan, key: int, n_workers: int,
                  device) -> FaultDraws:
    """The round's uniforms from the fault key ``key``, with JAX's layout:
    ``split(fold_in(key, FAULT_SALT), 4)`` gives the crash, straggler,
    corruption and burst keys."""
    kc, ks, kx, kb = rng.split(rng.fold_in(key, FAULT_SALT), 4)

    def uniform(k: int, shape):
        return torch.rand(shape, generator=rng.generator(k, device),
                          device=device)

    return FaultDraws(
        crash=uniform(kc, (n_workers,)) if plan.crash_prob > 0.0 else None,
        straggler=uniform(ks, (n_workers,)) if plan.has_stragglers else None,
        corrupt=uniform(kx, (n_workers,)) if plan.has_corruption else None,
        burst=uniform(kb, ()) if plan.has_bursts else None)


def _need(u: Optional[Tensor], what: str) -> Tensor:
    if u is None:
        raise ValueError(f"the fault plan needs the {what} uniforms; "
                         f"FaultDraws.{what} is None")
    return u


def draw(plan: FaultPlan, st: FaultState, fd: FaultDraws
         ) -> Tuple[RoundFaults, FaultState, dict]:
    """Draw one round's faults from the uniforms ``fd``.

    Returns ``(rf, st_mid, metrics)``; ``st_mid`` has the post-crash
    ``alive`` and the bumped round counter but not the snapshot refresh or
    evictions (those land in :func:`apply_uplink` / :func:`commit`)."""
    W = st.alive.shape[0]
    dev = st.alive.device
    r = st.round
    crashed = torch.zeros(W, dtype=torch.bool, device=dev)
    if plan.crash_prob > 0.0 and r >= plan.crash_start:
        hazard = _need(fd.crash, "crash") < plan.crash_prob
        # coarse cap: no new hazard crashes once the dead fraction is hit
        dead = W - st.alive.to(torch.int32).sum()
        crashed = hazard & (dead < int(plan.max_crash_frac * W))
    for rr, ww in plan.crash_at:
        if r == rr and 0 <= ww < W:
            crashed = crashed.clone()
            crashed[ww] = True
    alive = st.alive & ~crashed
    # never crash the last live worker
    alive = torch.where(alive.any(), alive, st.alive)

    straggler = snapshot_due = None
    if plan.has_stragglers:
        straggler = _need(fd.straggler, "straggler") < plan.straggler_prob
        snapshot_due = r % plan.straggler_delay == 0

    corrupt = None
    if plan.has_corruption:
        corrupt = ((_need(fd.corrupt, "corrupt") < plan.corrupt_prob)
                   | (torch.arange(W, device=dev) < plan.nan_workers))

    burst = None
    if plan.has_bursts:
        hit = _need(fd.burst, "burst") < plan.burst_prob
        burst = hit.to(torch.float32) * float(plan.burst_std)

    rf = RoundFaults(alive=alive, straggler=straggler, corrupt=corrupt,
                     snapshot_due=snapshot_due, burst_std=burst)
    st_mid = st._replace(alive=alive, round=r + 1)

    def count(x: Tensor) -> Tensor:
        return x.to(torch.float32).sum()

    metrics = {"fault/alive": count(alive)}
    if straggler is not None:
        metrics["fault/stragglers"] = count(straggler & alive)
    if corrupt is not None:
        metrics["fault/corrupt"] = count(corrupt & alive)
    if burst is not None:
        metrics["fault/burst"] = (burst > 0).to(torch.float32)
    return rf, st_mid, metrics


def apply_uplink(plan: FaultPlan, rf: RoundFaults, theta_p: Tensor,
                 stale: Optional[Tensor]
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """The planes a round uplinks: snapshot-refresh the stale buffer, swap
    straggler rows for it, then corrupt.  Crashed rows are untouched: they
    never transmit (the participation mask handles that)."""
    t = theta_p
    stale_next = stale
    if rf.straggler is not None:
        if stale is None:
            raise ValueError("straggler faults need a stale buffer "
                             "(FaultState.stale), got None")
        if rf.snapshot_due:
            # no copy: the rounds never write into their θ planes
            stale_next = theta_p.to(torch.float32)
        t = torch.where(rf.straggler[:, None], stale_next, t)
    if rf.corrupt is not None:
        if plan.corrupt_mode == "spike":
            bad = t * plan.spike_gain
        else:
            fill = float("nan") if plan.corrupt_mode == "nan" else float("inf")
            bad = torch.full_like(t, fill)
        t = torch.where(rf.corrupt[:, None], bad, t)
    return t, stale_next


def commit(st_mid: FaultState, stale_next: Optional[Tensor],
           evicted: Optional[Tensor]) -> FaultState:
    """Fold a round's outcomes back into the state: the refreshed stale
    buffer and the guard's evictions (an evicted worker is departed for
    good, like a crash, but detected rather than injected)."""
    st = st_mid if stale_next is None else st_mid._replace(stale=stale_next)
    if evicted is None:
        return st
    ev = evicted & st.alive
    return st._replace(alive=st.alive & ~ev,
                       n_evicted=st.n_evicted + ev.sum(dtype=torch.int32))
