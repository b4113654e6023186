"""The dry run's two report sections, from ``results/dryrun_torch/*.json``
(``$REPRO_DRYRUN_DIR``).  Counterpart of ``benchmarks/report.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.report [RESULTS_DIR]

Every number is derived from a trace of one rank on ``meta``
(``launch/dryrun.py``) with the published rates of one NVIDIA H100 80GB
HBM3 at its 700 W power limit; nothing here ran on a card.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.models.registry import get_config

RESULTS = os.environ.get("REPRO_DRYRUN_DIR", "results/dryrun_torch")
HEADING_HW = ("NVIDIA H100 80GB HBM3, 700 W: 989 TFLOP/s bf16 dense, "
              "3.35 TB/s HBM, 80 GB, NVLink 450 GB/s each way")
TRACED = "derived from a trace on `meta`, H100 constants"


def corrected_model_flops(r: dict) -> float:
    cfg = get_config(r["arch"])
    n_eff = cfg.active_param_count() if cfg.family == "moe" \
        else cfg.param_count()
    m = r["meta"]
    if m["kind"] == "train":
        return 6.0 * n_eff * m["global_batch"] * m["seq"]
    if m["kind"] == "prefill":
        return 2.0 * n_eff * m["global_batch"] * m["seq"]
    return 2.0 * n_eff * m["global_batch"]


def load(mesh: str, results: str = RESULTS):
    rows = []
    for p in sorted(glob.glob(os.path.join(results, "*.json"))):
        if "_opt-" in p:
            continue
        with open(p) as f:
            r = json.load(f)
        if r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        mf = corrected_model_flops(r)
        tg = rf["trace_flops_global"]
        mem = r["memory"]
        rows.append(dict(
            arch=r["arch"], shape=r["shape"],
            compute=rf["compute_s"], memory=rf["memory_s"],
            coll=rf["collective_s"], dom=rf["dominant"],
            model_flops=mf, trace_global=tg,
            useful=(mf / tg if tg else float("nan")),
            trace_s=r["timings"]["trace_s"],
            temp_gb=mem.get("temp_size_in_bytes", 0) / 1e9,
            arg_gb=mem.get("argument_size_in_bytes", 0) / 1e9,
            peak_gb=mem.get("peak_size_in_bytes", 0) / 1e9,
            coll_kinds=r["collectives"]["by_kind_bytes"],
            fl_mode=r["meta"].get("fl_mode", "-"),
        ))
    return rows


def failures(mesh: str, results: str = RESULTS):
    """``(tag, last line of the traceback)`` of each failed combination."""
    tail = "16x16" if mesh == "16x16" else "2x16x16"
    out = []
    for p in sorted(glob.glob(os.path.join(results, f"*_{tail}.json.err"))):
        with open(p) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        out.append((os.path.basename(p)[:-len(".json.err")],
                    lines[-1] if lines else ""))
    return out


def dryrun_section(results: str = RESULTS) -> str:
    out = [f"## §Dry-run ({TRACED}; {HEADING_HW})", ""]
    for mesh in ("16x16", "2x16x16"):
        rows = load(mesh, results)
        fails = failures(mesh, results)
        out.append(f"### mesh {mesh} ({256 if mesh == '16x16' else 512} "
                   f"ranks) — {len(rows)}/40 combinations traced")
        out.append("")
        out.append("| arch | shape | mode | trace s | args GB/dev | "
                   "temp GB/dev | peak GB/dev | fits 80 GB | "
                   "top collective |")
        out.append("|---|---|---|---|---|---|---|---|---|")
        for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
            top = max(r["coll_kinds"].items(), key=lambda kv: kv[1],
                      default=("-", 0))
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['fl_mode']} | "
                f"{r['trace_s']:.1f} | {r['arg_gb']:.2f} | "
                f"{r['temp_gb']:.1f} | {r['peak_gb']:.1f} | "
                f"{'yes' if r['peak_gb'] <= 80.0 else 'no'} | "
                f"{top[0]} {top[1]:.2e} B |")
        for tag, why in fails:
            out.append(f"| {tag} | failed: {why} ||||||||")
        out.append("")
    return "\n".join(out)


def roofline_section(results: str = RESULTS) -> str:
    rows = load("16x16", results)
    out = [f"## §Roofline (single-pod 16x16, 256 ranks; {TRACED}; "
           f"{HEADING_HW})", "",
           "Terms are seconds a step per rank, derived from one rank's "
           "trace on `meta` (launch/trace_analysis.py): flops over the bf16 "
           "peak, HBM bytes over the HBM rate, collective bytes over one "
           "NVLink direction. model_FLOPs = 6·N·D (train), 2·N·D "
           "(prefill), 2·N·B (decode); N = active params for MoE.", "",
           "| arch | shape | compute s | memory s | collective s | dominant "
           "| useful FLOP frac |",
           "|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute']:.3e} | "
            f"{r['memory']:.3e} | {r['coll']:.3e} | {r['dom']} | "
            f"{r['useful']:.3f} |")
    out.append("")
    doms: dict = {}
    for r in rows:
        doms[r["dom"]] = doms.get(r["dom"], 0) + 1
    out.append(f"Dominant-term census: {doms}.")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    results = argv[0] if argv else RESULTS
    print(dryrun_section(results))
    print()
    print(roofline_section(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
