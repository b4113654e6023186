"""Roofline table of the dry run: aggregates the results of
``python -m repro_torch.launch.dryrun`` (``results/dryrun_torch/*.json``,
or ``$REPRO_DRYRUN_DIR``) into one row per (arch × shape × mesh).
Counterpart of ``benchmarks/roofline.py``.

Every term is derived from a trace on ``meta`` with the published rates of
one NVIDIA H100 80GB HBM3 at its 700 W power limit
(``launch/dryrun.HARDWARE``); nothing here ran on a card.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

RESULTS_DIR = os.environ.get("REPRO_DRYRUN_DIR", "results/dryrun_torch")


def load_all(results_dir: Optional[str] = None) -> List[Dict]:
    results_dir = results_dir or RESULTS_DIR
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def table(results_dir: Optional[str] = None) -> List[Dict]:
    rows = []
    for r in load_all(results_dir):
        rf = r["roofline"]
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"], "dominant": rf["dominant"],
            "model_flops": rf["model_flops"],
            "trace_flops_global": rf["trace_flops_global"],
            "useful_flop_fraction": rf["useful_flop_fraction"],
            "trace_s": r["timings"]["trace_s"],
        })
    return rows


def markdown_table(results_dir: Optional[str] = None,
                   mesh: str = "16x16") -> str:
    rows = [r for r in table(results_dir) if r["mesh"] == mesh]
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | useful FLOP frac |",
             "|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        uf = r["useful_flop_fraction"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['dominant']} | "
            + (f"{uf:.3f} |" if uf is not None else "- |"))
    return "\n".join(lines)


def roofline_summary(results_dir: Optional[str] = None, device=None) -> Dict:
    """The dominant-term census and the worst training row's useful FLOP
    fraction.  ``device`` is the benchmark driver's and is not used: the
    summary reads files."""
    del device
    rows = table(results_dir)
    if not rows:
        return {"n_results": 0}
    dominant_counts: Dict[str, int] = {}
    for r in rows:
        dominant_counts[r["dominant"]] = \
            dominant_counts.get(r["dominant"], 0) + 1
    worst = min((r for r in rows if r["shape"] == "train_4k"
                 and r["useful_flop_fraction"]),
                key=lambda r: r["useful_flop_fraction"], default=None)
    return {
        "n_results": len(rows),
        "dominant_counts": dominant_counts,
        "worst_useful_flop_fraction":
            {k: worst[k] for k in ("arch", "shape", "useful_flop_fraction")}
            if worst else None,
    }
