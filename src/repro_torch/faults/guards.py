"""Round health guards: detect a bad OTA round and recover, on the device.

After the fused pass (B6) produced ``(y, Σ|h|², energy)`` the receiver
checks the would-be global model: every Θ entry finite, and the measured
receive SNR ``Σy² / Σ(z_eff)²`` (``z_eff = z/α``, plus an interference
burst) at least ``snr_floor_db``, tested division-free so that 0/0 cannot
pass and NaN fails.  Recovery, by ``policy``:

* ``evict`` — rows with non-finite energy or channel planes are cut from
  the participation mask and the slot is received again without them, on
  the same noise: the receiver excises a transmitter from the
  superposition, it is not a new slot.
* ``retransmit`` — the slot's O(d) epilogue runs again on fresh noise
  (``fold_in(key, RETRY_SALT + attempt)``) with the power budget raised by
  ``power_backoff`` per attempt, up to ``max_retries``; bursts do not recur.
* ``skip`` — the terminal fallback: ``healthy`` is False and
  ``core.admm.afadmm_round`` keeps the previous Θ and freezes every dual.

Counterpart of ``repro/faults/guards.py``, whose cascade is a ``lax.cond``
and a ``while_loop``.  Here it is branch-free, so the host never waits for
a verdict: the evict pass always runs and is selected by
``torch.where(ok0, …)``, and every retry epilogue runs and the first healthy
attempt (or the last) is taken, which is what the while loop yields.  A
guarded round therefore launches B6 ``1 + evicts`` times and B3′ ``1 +
evicts + retries`` times.  The retry and burst noise planes arrive in a
:class:`GuardDraws` (:func:`draw` makes them with JAX's key layout).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch import rng
from repro_torch.core import power, transport
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.cplx import Complex

Tensor = torch.Tensor

#: fold_in salts of the guard's draws (disjoint from plan.FAULT_SALT)
RETRY_SALT = 0x0E77
BURST_SALT = 0x0B57

_POLICIES = ("skip", "retransmit", "evict", "evict-retransmit")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Static guard description."""

    policy: str = "skip"                  # one of _POLICIES
    snr_floor_db: Optional[float] = None  # None: finiteness check only
    max_retries: int = 2                  # retransmission budget
    power_backoff: float = 2.0            # per-retry power ramp γ

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown guard policy {self.policy!r}; "
                             f"expected one of {_POLICIES}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    @property
    def evicts(self) -> bool:
        return self.policy in ("evict", "evict-retransmit")

    @property
    def retries(self) -> int:
        if self.policy in ("retransmit", "evict-retransmit"):
            return self.max_retries
        return 0


class GuardedRound(NamedTuple):
    """Result of a guarded receive."""

    Theta: Tensor       # global model (valid iff healthy)
    inv_alpha: Tensor   # the accepted slot's 1/α
    healthy: Tensor     # () bool — False: the caller applies the skip policy
    evicted: Tensor     # (W,) bool — offenders cut this round
    metrics: dict       # guard/retries, guard/snr_db, ...


class GuardDraws(NamedTuple):
    """The guard's random planes for one round: the burst's standard-normal
    (d,) plane (only under a plan with bursts) and the matched-filter noise
    of retries 1 … max_retries."""

    burst: Optional[Tensor] = None
    retry_noise: Tuple[Tensor, ...] = ()


def draw(gcfg: GuardConfig, key: int, d: int, ccfg: ChannelConfig, device,
         bursts: bool) -> GuardDraws:
    """The guard's planes from the round's noise key ``key``, as the JAX
    guard draws them: the burst from ``fold_in(key, BURST_SALT)``, retry
    ``a`` from ``fold_in(key, RETRY_SALT + a)``."""
    burst = None
    if bursts:
        burst = torch.randn(d, generator=rng.generator(
            rng.fold_in(key, BURST_SALT), device), device=device)
    retry = tuple(transport.matched_filter_noise_re(
        rng.generator(rng.fold_in(key, RETRY_SALT + a), device), (d,), ccfg)
        for a in range(1, gcfg.retries + 1))
    return GuardDraws(burst=burst, retry_noise=retry)


class _Attempt(NamedTuple):
    ok: Tensor
    Theta: Tensor
    inv_alpha: Tensor
    sig: Tensor
    npow: Tensor


def _pick(cond: Tensor, a, b):
    """Field by field ``where(cond, a, b)`` of two like NamedTuples."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def guarded_receive(gcfg: GuardConfig, *, stats_fn: Callable,
                    inv_alpha_fn: Callable, demod_fn: Callable,
                    mask: Optional[Tensor], n_workers: int,
                    noise_re: Tensor, retry_noise: Tuple[Tensor, ...] = (),
                    burst_std: Optional[Tensor] = None,
                    burst_plane: Optional[Tensor] = None,
                    offender_fn: Optional[Callable] = None,
                    telemetry=None) -> GuardedRound:
    """The guarded-receive cascade.

    * ``stats_fn(mask) -> (y, p2, energy)`` — the worker-plane pass (B6).
    * ``inv_alpha_fn(energy, mask, attempt) -> inv_alpha`` — min-α with the
      attempt's backed-off budget.
    * ``demod_fn(y, p2, n_eff) -> Theta``.
    * ``noise_re``: the slot's matched-filter noise; ``retry_noise``: that
      of each retry; ``burst_std`` () and ``burst_plane`` (d,): the burst,
      added on attempt 0 and on the evict pass.
    * ``offender_fn() -> (W,) bool`` — more per-row offender evidence (non-
      finite channel planes) on top of the non-finite-energy test.
    * ``telemetry`` (True or a ``repro_torch.obs.TelemetryConfig``) adds the
      accepted attempt's ``obs/`` keys: its SNR (``guard/snr_db``'s value,
      the burst included), α, the workers that transmitted and, per
      worker, their energy α²·Σ|s|² (zero for a masked or evicted one).
    """
    tel = _obs.resolve(telemetry)
    if gcfg.retries > len(retry_noise):
        raise ValueError(f"the guard retries {gcfg.retries} times but "
                         f"{len(retry_noise)} retry noise planes were given")
    if burst_std is not None and burst_plane is None:
        raise ValueError("a burst needs its noise plane (GuardDraws.burst)")
    dev = noise_re.device
    base_mask = (torch.ones(n_workers, dtype=torch.bool, device=dev)
                 if mask is None else mask)
    thr = (None if gcfg.snr_floor_db is None
           else 10.0 ** (gcfg.snr_floor_db / 10.0))

    def epilogue(y, p2, energy, sig, m, attempt, noise, burst) -> _Attempt:
        ia = inv_alpha_fn(energy, m, attempt)
        n = noise
        if burst:
            # interference enters at the receiver's antenna, so the 1/α
            # division scales it exactly like the matched-filter noise
            n = n + burst_std * burst_plane
        n_eff = n * ia
        del n
        Theta = demod_fn(y, p2, n_eff)
        ok = torch.isfinite(Theta).all()
        npow = torch.sum(n_eff * n_eff)
        if thr is not None:
            # division-free: 0/0 impossible, NaN fails
            ok = ok & (sig >= thr * npow)
        return _Attempt(ok, Theta, ia, sig, npow)

    def power(y):
        # the slot's signal power: a function of y only, so computed once a
        # pass rather than once an attempt
        return torch.sum(y * y)

    bursty = burst_std is not None
    y, p2, energy = stats_fn(mask)
    sig = power(y)
    first = epilogue(y, p2, energy, sig, mask, 0, noise_re, bursty)
    cur, m_cur = first, base_mask
    evicted = torch.zeros(n_workers, dtype=torch.bool, device=dev)
    if gcfg.evicts:
        off = ~torch.isfinite(energy)
        if offender_fn is not None:
            off = off | offender_fn()
        off = off & base_mask
        m2 = base_mask & ~off
        y2, p22, e2 = stats_fn(m2)
        sig2 = power(y2)
        cut = epilogue(y2, p22, e2, sig2, m2, 0, noise_re, bursty)
        keep = first.ok
        cur = _pick(keep, first, cut)
        y, p2, energy, sig = (torch.where(keep, a, b) for a, b in
                              ((y, y2), (p2, p22), (energy, e2),
                               (sig, sig2)))
        m_cur = torch.where(keep, base_mask, m2)
        evicted = off & ~keep
        del y2, p22, e2, sig2, cut
    retries = torch.zeros((), dtype=torch.float32, device=dev)
    if gcfg.retries > 0:
        # every retry runs; the first healthy attempt (else the last) wins.
        # Folded one attempt at a time, so two live at once: at an LLM's D
        # each holds a (D,) Θ
        done = cur.ok
        for a in range(1, gcfg.retries + 1):
            att = epilogue(y, p2, energy, sig, m_cur, a, retry_noise[a - 1],
                           False)
            cur = _pick(done, cur, att)
            retries = torch.where(done, retries, float(a))
            done = done | att.ok
            del att
    snr_db = transport.snr_db_from_power(cur.sig, cur.npow)
    metrics = {
        "guard/retries": retries,
        "guard/snr_db": snr_db,
        "guard/ok_first": first.ok.to(torch.float32),
        "guard/healthy": cur.ok.to(torch.float32),
        "guard/evicted": evicted.to(torch.float32).sum(),
    }
    if tel is not None:
        # the accepted attempt's channel telemetry, from the cascade's own
        # tensors: obs/rx_snr_db is guard/snr_db under its other name
        alpha = transport.applied_alpha(cur.inv_alpha)
        metrics["obs/rx_snr_db"] = snr_db
        metrics["obs/min_alpha"] = alpha
        metrics["obs/active_workers"] = transport.active_workers(
            m_cur, n_workers, dev)
        if tel.per_worker:
            metrics["obs/tx_energy"] = torch.where(
                m_cur, energy * (alpha * alpha), torch.zeros_like(energy))
    return GuardedRound(cur.Theta, cur.inv_alpha, cur.ok, evicted, metrics)


def _rows_nonfinite(*planes: Tensor) -> Tensor:
    """(W,) True where any plane's row holds a non-finite entry."""
    bad = None
    for p in planes:
        b = ~torch.isfinite(p).reshape(p.shape[0], -1).all(dim=1)
        bad = b if bad is None else bad | b
    return bad


def guarded_ota_round(theta: Tensor, lam: Complex, h: Complex,
                      noise_re: Tensor, rho: float, ccfg: ChannelConfig,
                      gcfg: GuardConfig, *, power_control: bool = True,
                      mask: Optional[Tensor] = None,
                      h_tx: Optional[Complex] = None,
                      burst_std: Optional[Tensor] = None,
                      draws: GuardDraws = GuardDraws(),
                      block_cols: Optional[int] = None,
                      telemetry=None,
                      min_reduce_fn: Optional[Callable] = None
                      ) -> GuardedRound:
    """Guarded twin of ``transport.ota_round_fused`` (monolithic pass) on
    the flat (W, d) problem.  On a healthy slot (no burst, finite planes,
    SNR above the floor) Θ and α⁻¹ are the unguarded fused round's, bit for
    bit on the CPU: the guard only adds its O(d) checks.  ``block_cols``
    picks B6's plan (``transport.ota_round_stats``); ``telemetry``: as
    :func:`guarded_receive`; ``min_reduce_fn`` carries each attempt's min-α
    to other ranks' workers (``transport.inv_alpha_from_energy``)."""
    W, d = theta.shape
    budget = ccfg.transmit_power * d

    def stats_fn(m):
        y, p2, e, _ = transport.ota_round_stats(theta, lam, h, rho, mask=m,
                                                h_tx=h_tx,
                                                block_cols=block_cols)
        return y, p2, e

    def inv_alpha_fn(energy, m, attempt):
        if not power_control:
            return torch.ones((), dtype=torch.float32, device=energy.device)
        b = power.retry_power_budget(budget, attempt, gcfg.power_backoff)
        return transport.inv_alpha_from_energy(energy, b, mask=m,
                                               min_reduce_fn=min_reduce_fn)

    def demod_fn(y, p2, n_eff):
        return transport.demodulate(y, p2, n_eff, 1.0)

    def offender_fn():
        planes = [h.re, h.im]
        if h_tx is not None:
            planes += [h_tx.re, h_tx.im]
        return _rows_nonfinite(*planes)

    return guarded_receive(gcfg, stats_fn=stats_fn, inv_alpha_fn=inv_alpha_fn,
                           demod_fn=demod_fn, mask=mask, n_workers=W,
                           noise_re=noise_re, retry_noise=draws.retry_noise,
                           burst_std=burst_std, burst_plane=draws.burst,
                           offender_fn=offender_fn, telemetry=telemetry)
