"""repro_torch.obs — observability for OTA-FL rounds, off by default and then
free.  Counterpart of ``repro/obs/__init__.py``.

Three tiers, matching the three places a run can be observed:

1. **Round telemetry** (``TelemetryConfig``): channel and round statistics
   computed inside the round from tensors the fused receive already holds
   (the energies B6 writes, the superposed ``y``, the noise plane), threaded
   through ``transport.ota_round_fused`` → ``admm.afadmm_round`` /
   ``tree_ota.ota_tree_round_packed_state`` → ``AFadmm`` → the trainers.
   With telemetry off (the default everywhere) every path is bitwise the
   path without it; with telemetry on the training math is unchanged and
   only extra metric entries ride the metrics dict.
2. **Structured run logs** (``repro_torch.obs.sink.MetricsSink``): one JSONL
   event per round plus a run manifest under ``--run-dir``.
3. **Profiling hooks** (``repro_torch.obs.profiling``): ``torch.profiler``
   ranges and traces, and wall-clock spans.

Canonical metric-key schema
---------------------------

Every per-round metrics dict is a flat ``str -> scalar-or-(W,)-vector``
mapping.  Keys are namespaced by producer; ``merge_disjoint`` is the ONE
place collisions are rejected, so a producer can never silently clobber
another's keys:

``(no prefix)`` — ADMM/trainer math (always present):
    ``loss``             mean (sketched) / last (replicated) worker loss
    ``primal_residual``  mean ||theta_w - Theta||
    ``dual_residual``    rho * ||Theta - Theta_prev||
    ``inv_alpha``        receive-side 1/sqrt(alpha_min) equaliser gain
    ``channel_uses``     cumulative real-dimension channel uses
    ``participation``    fraction of workers transmitting this round
    ``theta_drift``      RMS gap between local models and consensus
    ``grad_norm``        (analog-GD paths) global gradient norm

``fault/`` — fault-injection events (``repro_torch.faults.plan``; present
when a ``FaultPlan`` is active):
    ``fault/alive``      workers not permanently crashed
    ``fault/stragglers`` workers uploading a stale snapshot this round
    ``fault/corrupt``    workers with corrupted (NaN/Inf/spike) uploads
    ``fault/burst``      1.0 when a PS interference burst hit this round

``guard/`` — round health-guard verdicts (``repro_torch.faults.guards``;
present when a ``GuardConfig`` is active):
    ``guard/ok_first``   attempt-0 receive passed the health check
    ``guard/retries``    retransmission attempts consumed
    ``guard/snr_db``     effective receive SNR of the accepted attempt
    ``guard/healthy``    final verdict (round committed vs skipped)
    ``guard/evicted``    workers evicted by the offender policy

``obs/`` — channel telemetry (present when ``TelemetryConfig`` is on):
    ``obs/rx_snr_db``    effective receive SNR:  10 log10(sum y^2 /
                         sum (noise * inv_alpha)^2), the guard's exact
                         division-free formula
    ``obs/min_alpha``    min-alpha transmit power scale actually applied
                         (0.0 when nobody transmitted)
    ``obs/tx_energy``    per-worker transmit energy alpha^2 * sum|s|^2,
                         a (W,) VECTOR leaf (sinks store it as a list)
    ``obs/active_workers``  number of workers transmitting this round
    ``obs/theta_update_norm``  l2 norm of the committed Theta update
    ``obs/cohort_size``  workers sampled this round (population/cohort
                         sampling active — ``core.cohort``)
    ``obs/population_sampled_frac``  cohort / population

Keys starting with ``_`` (e.g. ``_fault_aux``) are private plumbing that
callers pop before metrics reach a sink.

JSONL event schema (one object per line, ``metrics.jsonl``):
    ``{"event": "round",  "round": r, "metrics": {key: float|[float]}}``
    ``{"event": "block",  "round": r, "seconds": s, "rounds": n}``
    ``{"event": "resume", "round": r}``
    ``{"event": "done",   "rounds": n, "seconds": s}``
non-finite values are serialised as ``null``.  The manifest
(``manifest.json``) records the resolved FLConfig, ADMM/channel knobs, the
device, the torch version, the git SHA and the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["TelemetryConfig", "resolve", "is_on", "merge_disjoint"]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Round telemetry knobs.

    ``enabled``    master switch; ``False`` is bitwise the path without it.
    ``per_worker`` emit the (W,) ``obs/tx_energy`` vector leaf (off →
                   only scalar telemetry keys).
    """

    enabled: bool = True
    per_worker: bool = True


def resolve(tel: Any) -> Optional[TelemetryConfig]:
    """Normalise a telemetry knob (None/bool/TelemetryConfig) to either a
    live ``TelemetryConfig`` or ``None`` (off)."""
    if tel is None or tel is False:
        return None
    if tel is True:
        return TelemetryConfig()
    if isinstance(tel, TelemetryConfig):
        return tel if tel.enabled else None
    raise TypeError(f"telemetry must be None, bool or TelemetryConfig, "
                    f"got {type(tel).__name__}")


def is_on(tel: Any) -> bool:
    return resolve(tel) is not None


def merge_disjoint(dst: Dict[str, Any], *srcs: Dict[str, Any],
                   who: str = "metrics") -> Dict[str, Any]:
    """Merge metric dicts, rejecting key collisions.

    THE single disjointness assertion of the metric-key schema: every
    producer merge (ADMM + guard + fault + obs) goes through here, so a
    new key can never silently clobber an existing one.  Keys are python
    strings, so the check reads no tensor and never waits for the card.
    """
    out = dict(dst)
    for src in srcs:
        clash = out.keys() & src.keys()
        if clash:
            raise ValueError(
                f"{who}: metric key collision {sorted(clash)} — namespace "
                f"the producer's keys (see repro_torch.obs docstring)")
        out.update(src)
    return out
