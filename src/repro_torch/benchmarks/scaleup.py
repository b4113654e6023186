"""Log-scale worker sweep: how far does one OTA round scale?  Torch twin of
``benchmarks/scaleup.py``.

Full-transmit rounds at W ∈ {16, 256, 4096, 65536} plus a 10⁶-population /
256-cohort sampled round (``core.cohort``), all the same flat A-FADMM round
over the frequency-flat ``urban-mobility`` scenario, so the population phy
step (B10) and the transport are what is scaled.  Per sweep point:

* ``seconds_per_round``   wall clock, median of ``iters`` rounds (the card
  synchronised after each);
* ``consensus_gap_*``     RMS ‖θ_n − Θ‖ before and after ``rounds`` rounds;
* ``peak_above_state_bytes`` on the card: the most a round allocated above
  the state it carries (``torch.cuda.max_memory_allocated``).

Telemetry is not ported, so there is no ``rx_snr_db``.  The structural pin
behind the 10⁶ point is :func:`max_compute_out_elems`: no compute op of a
sampled round may output O(N·d) elements, population-wide buffers being
only carried state, (N,) phy planes and row gathers and scatters.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only scaleup \\
        [--device cpu]
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import rng
from repro_torch.benchmarks import common
from repro_torch.core import cplx
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.aggregators import AFadmm
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.cohort import CohortConfig
from repro_torch.core.subcarrier import SubcarrierPlan
from repro_torch.device import resolve_device
from repro_torch.phy import make_scenario

D = 32          #: model dim: small on purpose, the sweep scales workers
N_SUB = 32
RHO = 0.5
SNR_DB = 20.0

#: (population, cohort); cohort == population: everyone transmits
SWEEP = ((16, 16), (256, 256), (4096, 4096), (65536, 65536),
         (1_000_000, 256))
SWEEP_FAST = ((16, 16), (64, 64), (256, 32))

#: ops that move or make buffers without computing on them (views, copies,
#: casts, concatenation, creation) and the cohort's row gathers and
#: scatters: the JAX benchmark's layout primitives, as aten names
LAYOUT_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "alias", "detach",
    "as_strided", "split", "split_with_sizes", "unbind", "clone", "copy_",
    "_to_copy", "contiguous", "cat", "stack", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "fill_", "zero_", "lift_fresh", "index", "index_select",
    "gather", "index_put", "index_put_", "scalar_tensor",
    "_local_scalar_dense",
})


def proximal_solver(rho: float):
    """Closed-form primal of the proximal-point objective
    f_n(θ) = ‖θ − θ_n^prev‖²: a data-free consensus task whose solver takes
    any worker count (the population's or a gathered cohort's).
    Stationarity: 2(θ − θ_prev) + Re{λ*h} + ρ|h|²(θ − Θ) = 0."""
    def solve(theta, lam, h, Theta, batch_idx=None):
        h2 = cplx.abs2(h)
        mu = cplx.cmul_conj(h, lam).re
        return (2.0 * theta - mu + rho * h2 * Theta[None, :]) \
            / (2.0 + rho * h2)
    return solve


def zero_grad(theta):
    return torch.zeros_like(theta)


def make_alg(population: int, cohort: int, d: int = D) -> AFadmm:
    """The sweep's A-FADMM: flip rule off, power control on, 32 subcarriers
    at 20 dB, the frequency-flat ``urban-mobility`` scenario, and a uniform
    cohort when ``cohort < population``."""
    acfg = AdmmConfig(rho=RHO, flip_on_change=False, power_control=True)
    ccfg = ChannelConfig(n_workers=population, n_subcarriers=N_SUB,
                         snr_db=SNR_DB)
    plan = SubcarrierPlan.build(d, N_SUB)
    scn = make_scenario("urban-mobility", ccfg, freq_flat=True)
    coh = (CohortConfig(population=population, cohort=cohort)
           if cohort < population else None)
    return AFadmm(acfg, ccfg, plan, scenario=scn, cohort=coh)


class _OutputSizes(TorchDispatchMode):
    """Records the largest output (elements) of any op outside
    :data:`LAYOUT_OPS`."""

    def __init__(self):
        super().__init__()
        self.worst = 0
        self.worst_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if name not in LAYOUT_OPS:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for o in outs:
                if isinstance(o, torch.Tensor) and o.numel() > self.worst:
                    self.worst, self.worst_op = o.numel(), func.__name__
        return out


def max_compute_out_elems(fn: Callable, *args):
    """(largest output of any non-layout op of ``fn(*args)``, that op's
    name).  The port has no trace to walk, so this runs ``fn``: the twin of
    the JAX benchmark's jaxpr walk."""
    with _OutputSizes() as rec:
        fn(*args)
    return rec.worst, rec.worst_op


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_point(population: int, cohort: int, rounds: int, iters: int,
              seed: int = 0, device="cuda") -> dict:
    """One sweep point on ``device``: the median of ``iters`` timed rounds
    from the state after one round, and ``rounds`` rounds from the initial
    state for the consensus gap."""
    dev = resolve_device(device)
    alg = make_alg(population, cohort)
    solve = proximal_solver(RHO)
    key = seed
    theta0 = torch.randn((population, D), device=dev,
                         generator=rng.generator(rng.fold_in(key, 1), dev))
    st = alg.init(key, theta0)

    def gap(s) -> float:
        return float(torch.sqrt(torch.mean((s.theta - s.Theta[None]) ** 2)))

    gap0 = gap(st)
    st1, _ = alg.round(key, st, solve, zero_grad)        # warm-up
    _sync(dev)
    state_bytes = peak = None
    ts = []
    for i in range(iters):
        k = rng.fold_in(key, 100 + i)
        if dev.type == "cuda":
            state_bytes = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = alg.round(k, st1, solve, zero_grad)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            peak = max(peak or 0, torch.cuda.max_memory_allocated(dev)
                       - state_bytes)
        del out
    stN = st                # round r on fold_in(key, r + 1), as train's
    for r in range(rounds):
        stN, _ = alg.round(rng.fold_in(key, r + 1), stN, solve, zero_grad)
    out = {
        "workers": int(cohort),
        "population": int(population),
        "cohort": int(cohort),
        "sampled": cohort < population,
        "rounds": int(rounds),
        "seconds_per_round": statistics.median(ts),
        "consensus_gap_first": gap0,
        "consensus_gap_last": gap(stN),
        "optimised_metric": "seconds_per_round",
    }
    if peak is not None:
        out["peak_above_state_bytes"] = int(peak)
    return out


def scaleup(device="cuda", rounds: int = 12, iters: int = 5) -> dict:
    """The sweep (:data:`SWEEP_FAST` at the benchmarks' FAST scale, else
    :data:`SWEEP`), keyed as the JAX benchmark keys it."""
    pts = SWEEP_FAST if common.FAST else SWEEP
    sweep = {}
    for population, cohort in pts:
        name = (f"W{cohort}" if cohort == population
                else f"N{population}_c{cohort}")
        sweep[name] = run_point(population, cohort, rounds, iters,
                                device=device)
    return {"config": {"d": D, "n_subcarriers": N_SUB, "rho": RHO,
                       "snr_db": SNR_DB,
                       "scenario": "urban-mobility/freq-flat",
                       "rounds": rounds, "iters": iters,
                       "fast": bool(common.FAST)},
            "sweep": sweep}
