"""Render a text/CSV summary from one or more run directories.
Counterpart of ``repro/obs/report.py``, which imports no JAX; a copy, so
that the port stands alone.

Usage::

    python -m repro_torch.obs.report RUN_DIR [RUN_DIR ...] [--csv] [--keys k1,k2]

Reads each run's ``metrics.jsonl`` (written by ``MetricsSink``) and prints
the loss + receive-SNR + participation trajectories: first/last values, a
coarse sparkline over rounds, and — with ``--csv`` — the full per-round
table on stdout (one row per round, one column block per run).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

#: default trajectory columns, in display order (missing keys are skipped)
DEFAULT_KEYS = ("loss", "obs/rx_snr_db", "participation",
                "obs/active_workers", "guard/retries", "fault/alive")

_SPARK = "▁▂▃▄▅▆▇█"


def load_rounds(run_dir: str) -> List[Dict[str, Any]]:
    """``metrics.jsonl`` -> ordered list of round events (resume-safe:
    a later event for the same round wins, so a resumed run that re-emits
    its restart round is not double-counted)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    by_round: Dict[int, Dict[str, Any]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if ev.get("event") == "round":
                by_round[int(ev["round"])] = ev.get("metrics", {})
    return [{"round": r, **{"metrics": by_round[r]}}
            for r in sorted(by_round)]


def _scalar(v: Any) -> Optional[float]:
    """Metric value -> scalar (vectors reduce to their sum; null -> None)."""
    if v is None:
        return None
    if isinstance(v, list):
        vals = [x for x in v if x is not None]
        return float(sum(vals)) if vals else None
    return float(v)


def series(rounds: List[Dict[str, Any]], key: str) -> List[Optional[float]]:
    return [_scalar(ev["metrics"].get(key)) for ev in rounds]


def sparkline(xs: List[Optional[float]], width: int = 40) -> str:
    vals = [x for x in xs if x is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo or 1.0
    # resample to `width` buckets (mean of present values per bucket)
    n = len(xs)
    out = []
    for b in range(min(width, n)):
        i0, i1 = b * n // min(width, n), (b + 1) * n // min(width, n)
        bucket = [x for x in xs[i0:max(i1, i0 + 1)] if x is not None]
        if not bucket:
            out.append(" ")
            continue
        v = sum(bucket) / len(bucket)
        out.append(_SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)),
                              len(_SPARK) - 1)])
    return "".join(out)


def summarise(run_dir: str, keys) -> List[str]:
    rounds = load_rounds(run_dir)
    man_path = os.path.join(run_dir, "manifest.json")
    lines = [f"== {run_dir} ({len(rounds)} rounds)"]
    if os.path.exists(man_path):
        with open(man_path) as f:
            man = json.load(f)
        bits = [str(man[k]) for k in ("arch", "mode", "backend", "driver")
                if k in man]
        if "git_sha" in man:
            bits.append(str(man["git_sha"])[:12])
        if bits:
            lines.append("   " + " | ".join(bits))
    for key in keys:
        xs = series(rounds, key)
        vals = [x for x in xs if x is not None]
        if not vals:
            continue
        lines.append(
            f"  {key:<22} first={vals[0]:<12.6g} last={vals[-1]:<12.6g} "
            f"min={min(vals):<12.6g} max={max(vals):<12.6g} "
            f"{sparkline(xs)}")
    return lines


def emit_csv(run_dirs, keys, out=None) -> None:
    out = sys.stdout if out is None else out   # read when called
    header = ["run", "round"] + list(keys)
    out.write(",".join(header) + "\n")
    for rd in run_dirs:
        for ev in load_rounds(rd):
            row = [rd, str(ev["round"])]
            for key in keys:
                v = _scalar(ev["metrics"].get(key))
                row.append("" if v is None else repr(v))
            out.write(",".join(row) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="summarise MetricsSink run directories")
    p.add_argument("run_dirs", nargs="+", metavar="RUN_DIR")
    p.add_argument("--csv", action="store_true",
                   help="emit the full per-round table as CSV on stdout")
    p.add_argument("--keys", default=None,
                   help="comma-separated metric keys "
                        f"(default: {','.join(DEFAULT_KEYS)})")
    args = p.parse_args(argv)
    keys = tuple(args.keys.split(",")) if args.keys else DEFAULT_KEYS
    if args.csv:
        emit_csv(args.run_dirs, keys)
        return 0
    for rd in args.run_dirs:
        print("\n".join(summarise(rd, keys)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
