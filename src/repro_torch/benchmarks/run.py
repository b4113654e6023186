"""Benchmark driver of the torch twins — one function per paper table or
figure, under the names of ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV (us_per_call = wall time of the whole
benchmark in microseconds; derived = the figure's headline numbers as JSON);
a benchmark that fails prints ``name,-1,{"error": ...}`` and the run exits
1.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \
        [--only fig2a_comm_efficiency] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _benchmarks():
    from repro_torch.benchmarks import (ablation_noniid, fig2_linreg,
                                        fig3_classification, fig5_rho,
                                        kernels_microbench, roofline, scaleup,
                                        serve_microbench)
    return {
        "ablation_noniid": ablation_noniid.ablation_noniid,
        "ablation_decentralized": ablation_noniid.ablation_decentralized,
        "fig2a_comm_efficiency": fig2_linreg.fig2a_comm_efficiency,
        "fig2b_energy": fig2_linreg.fig2b_energy,
        "fig2c_scalability": fig2_linreg.fig2c_scalability,
        "fig3a_comm_efficiency": fig3_classification.fig3a_comm_efficiency,
        "fig3b_energy": fig3_classification.fig3b_energy,
        "fig3c_scalability": fig3_classification.fig3c_scalability,
        "fig5_rho_sensitivity": fig5_rho.fig5_rho_sensitivity,
        "roofline_summary": roofline.roofline_summary,
        "scaleup": scaleup.scaleup,
        "serve_microbench": serve_microbench.serve_microbench,
        "kernels_microbench": kernels_microbench.microbench,
        "transport_microbench": kernels_microbench.transport_microbench,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu' (the plain "
                    "versions)")
    args = ap.parse_args(argv)

    benches = _benchmarks()
    if args.only:
        benches = {k: v for k, v in benches.items() if args.only in k}

    print("name,us_per_call,derived")
    ok = True
    for name, fn in benches.items():
        t0 = time.time()
        try:
            derived = fn(device=args.device)
            us = (time.time() - t0) * 1e6
            print(f"{name},{us:.0f},{json.dumps(derived, default=str)}",
                  flush=True)
        except Exception as e:
            ok = False
            print(f"{name},-1,{json.dumps({'error': repr(e)})}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
