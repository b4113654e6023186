"""Schema validation for bench artefacts and run logs — the CI linter.
Counterpart of ``repro/obs/validate.py``, which imports no JAX; a copy, so
that the port stands alone.

Usage::

    python -m repro_torch.obs.validate --bench BENCH_a.json [BENCH_b.json ...]
    python -m repro_torch.obs.validate --run-dir RUN_DIR [RUN_DIR ...]

* ``--bench``: every ``BENCH_*.json`` must carry at least one
  ``optimised_metric`` — a string naming a numeric field of the object
  holding it, dotted paths allowed (``"uplink_mlp.speedup"``) — and every
  one present must resolve (the repo-wide bench convention; a bench that
  forgets it can't be regression-tracked).  Multi-section artefacts tag
  each section; purely informational sections may omit it.
* ``--run-dir``: ``manifest.json`` must be a JSON object and every
  ``metrics.jsonl`` line must match the event schema documented in the
  :mod:`repro_torch.obs` docstring (known ``event`` tag, int ``round``,
  ``metrics`` a flat str -> number|null|list mapping).

Exit code 0 = all clean; 1 = violations (printed one per line).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, List

__all__ = ["validate_bench", "validate_run_dir"]

_EVENTS = {"round", "block", "resume", "done"}


def _is_num(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_bench(path: str) -> List[str]:
    """Lint one BENCH_*.json; returns a list of violation strings."""
    errs = []
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable JSON ({e})"]
    if not isinstance(d, dict):
        return [f"{path}: top level must be a JSON object"]

    n_found = 0

    def walk(where: str, sec: dict) -> None:
        nonlocal n_found
        if "optimised_metric" in sec:
            n_found += 1
            om = sec["optimised_metric"]
            if not isinstance(om, str):
                errs.append(f"{where}: non-string 'optimised_metric'")
            else:
                v: Any = sec
                for part in om.split("."):
                    v = v.get(part) if isinstance(v, dict) else None
                if v is None:
                    errs.append(f"{where}: optimised_metric {om!r} names "
                                "no field")
                elif not _is_num(v):
                    errs.append(f"{where}: optimised_metric field {om!r} "
                                f"is not numeric (got {type(v).__name__})")
        for name, sub in sec.items():
            if isinstance(sub, dict):
                walk(f"{where}[{name}]", sub)

    walk(path, d)
    if n_found == 0:
        errs.append(f"{path}: no 'optimised_metric' anywhere (the bench "
                    "convention: every artefact tags its headline number)")
    if os.path.basename(path) == "BENCH_scaleup.json":
        errs.extend(_check_scaleup(path, d))
    return errs


def _check_scaleup(path: str, d: dict) -> List[str]:
    """Extra shape for the worker-sweep artefact (benchmarks/scaleup.py):
    every sweep point carries its width + wall-clock + receive SNR, and the
    O(cohort*D) signal-memory pin must have held when it was generated."""
    errs = []
    sweep = d.get("sweep")
    if not isinstance(sweep, dict) or not sweep:
        return [f"{path}: BENCH_scaleup needs a non-empty 'sweep' object"]
    for name, pt in sorted(sweep.items()):
        if not isinstance(pt, dict):
            errs.append(f"{path}[sweep.{name}]: sweep point must be an "
                        "object")
            continue
        for fld in ("workers", "population", "seconds_per_round",
                    "rx_snr_db"):
            if not _is_num(pt.get(fld)):
                errs.append(f"{path}[sweep.{name}]: needs numeric "
                            f"{fld!r}")
    pin = d.get("memory_pin")
    if not isinstance(pin, dict) or pin.get("ok") is not True:
        errs.append(f"{path}: 'memory_pin.ok' must be true — the sweep "
                    "only counts if peak signal memory stayed O(cohort*D)")
    return errs


def _check_metrics(path: str, ln: int, metrics: Any) -> List[str]:
    if not isinstance(metrics, dict):
        return [f"{path}:{ln}: 'metrics' must be an object"]
    errs = []
    for k, v in metrics.items():
        if not isinstance(k, str):
            errs.append(f"{path}:{ln}: non-string metric key {k!r}")
        elif k.startswith("_"):
            errs.append(f"{path}:{ln}: private key {k!r} leaked into the "
                        "log (callers pop _-keys before the sink)")
        if v is None or _is_num(v):
            continue
        if isinstance(v, list) and all(x is None or _is_num(x) for x in v):
            continue
        errs.append(f"{path}:{ln}: metric {k!r} must be number|null|"
                    f"[number|null], got {type(v).__name__}")
    return errs


def validate_run_dir(run_dir: str) -> List[str]:
    """Lint one MetricsSink run directory; returns violation strings."""
    errs = []
    man = os.path.join(run_dir, "manifest.json")
    if not os.path.exists(man):
        errs.append(f"{man}: missing manifest")
    else:
        try:
            with open(man) as f:
                if not isinstance(json.load(f), dict):
                    errs.append(f"{man}: manifest must be a JSON object")
        except (OSError, ValueError) as e:
            errs.append(f"{man}: unreadable JSON ({e})")
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return errs + [f"{path}: missing metrics.jsonl"]
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError as e:
                errs.append(f"{path}:{ln}: invalid JSON ({e})")
                continue
            if not isinstance(ev, dict) or ev.get("event") not in _EVENTS:
                errs.append(f"{path}:{ln}: unknown event "
                            f"{ev.get('event')!r}")
                continue
            tag = ev["event"]
            if tag in ("round", "block", "resume") \
                    and not isinstance(ev.get("round"), int):
                errs.append(f"{path}:{ln}: {tag} event needs int 'round'")
            if tag == "round":
                errs.extend(_check_metrics(path, ln, ev.get("metrics")))
            if tag in ("block", "done") and not _is_num(ev.get("seconds")):
                errs.append(f"{path}:{ln}: {tag} event needs numeric "
                            "'seconds'")
            if tag in ("block", "done") and not isinstance(
                    ev.get("rounds"), int):
                errs.append(f"{path}:{ln}: {tag} event needs int 'rounds'")
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="lint BENCH_*.json artefacts and run-dir logs")
    p.add_argument("--bench", nargs="*", default=[],
                   help="BENCH json files (globs ok)")
    p.add_argument("--run-dir", nargs="*", default=[],
                   help="MetricsSink run directories")
    args = p.parse_args(argv)
    errs: List[str] = []
    n = 0
    for pat in args.bench:
        paths = sorted(glob.glob(pat)) or [pat]
        for path in paths:
            n += 1
            errs.extend(validate_bench(path))
    for rd in args.run_dir:
        n += 1
        errs.extend(validate_run_dir(rd))
    for e in errs:
        print(e, file=sys.stderr)
    print(f"validated {n} artefact(s): "
          f"{'OK' if not errs else f'{len(errs)} violation(s)'}")
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
