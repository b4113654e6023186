"""Dry run: trace one rank of every (arch × shape × mesh) combination and
derive the roofline terms from the trace.  Counterpart of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out results/dryrun_torch]

Where the reference lowers and compiles one partition of the SPMD program
on 512 host devices, this runs the port's own code for rank 0 of the
production mesh (``launch.mesh.make_production_mesh``: fake ranks, no
process group) on ``meta`` tensors at that rank's resident shapes
(``launch/specs.py``) and counts it (``launch/trace_analysis.py``).  The
training step of every family is the partitioned program (each model
rank its heads, ff columns, experts, inner or RG-LRU channels and vocab
rows, ``models/partition.py``), as XLA partitions the reference's, and so
is its serving.  It needs no card and allocates no
tensor memory.

Every number comes from that trace and the published rates of one NVIDIA
H100 SXM at its 700 W power limit (:data:`HARDWARE`): the compute term is
the trace's flops over the bf16 dense peak, the memory term its HBM bytes
over the HBM rate, the collective term its collective bytes over one
direction of NVLink, a lower bound for a mesh that spans hosts.  The JSON
keys and file tags are the reference's; ``timings`` holds ``trace_s`` and
the flops sit under ``trace`` and ``trace_flops_global``.  A combination
that fails writes ``<tag>.json.err`` with its traceback.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

from repro_torch.launch import trace_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, build_spec, leaves, spec_bytes
from repro_torch.models.registry import get_config, list_archs

#: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), at 700 W
HARDWARE = {
    "device": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700,
    "peak_flops_bf16": 989e12,       # FLOP/s, tensor cores, dense
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
    "link_bytes_per_s": 450e9,       # NVLink, one direction
}
PEAK_FLOPS = HARDWARE["peak_flops_bf16"]
HBM_BW = HARDWARE["hbm_bytes_per_s"]
LINK_BW = HARDWARE["link_bytes_per_s"]

#: how the trace counts flops (stated in every result)
FLOP_CONVENTION = (
    "matrix products as torch.utils.flop_counter counts them (elementwise "
    "work excluded); B11 (flash_attention_fwd/_dq/_dkv) on its causal "
    "(query, key) pairs only: 4·hd flops a pair forward, 6·hd dq, 8·hd "
    "dk/dv")


def model_flops(arch: str, meta: Dict[str, Any]) -> float:
    """6·N·D a training step, 2·N·D a prefill, 2·N·B a decode step (N the
    active parameters of a moe), as the reference counts them."""
    cfg = get_config(arch)
    n_eff = cfg.active_param_count() if cfg.family == "moe" \
        else cfg.param_count()
    if meta["kind"] == "train":
        return 6.0 * n_eff * meta["global_batch"] * meta["seq"]
    if meta["kind"] == "prefill":
        return 2.0 * n_eff * meta["global_batch"] * meta["seq"]
    return 2.0 * n_eff * meta["global_batch"]


def _memory(spec, summary) -> Dict[str, float]:
    """The rank's resident arguments, the trace's peak beyond them, and
    the reference's analytic argument bytes."""
    total = spec_bytes(spec.args)
    return {
        "argument_size_in_bytes": spec_bytes(spec.local_args),
        "temp_size_in_bytes": summary.temp_bytes,
        "peak_size_in_bytes": summary.peak_bytes,
        "analytic_total_arg_bytes": total,
        "analytic_arg_bytes_per_device_lower_bound": total / spec.mesh.size,
    }


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            reduced: bool = False, packed_uplink=None, fsdp: int = 1,
            fl_mode=None, sketch_ratio: int = 256) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod, fsdp=fsdp)
    t0 = time.time()
    spec = build_spec(arch, shape_name, mesh, multi_pod=multi_pod,
                      reduced=reduced, packed_uplink=packed_uplink,
                      fl_mode=fl_mode, sketch_ratio=sketch_ratio)
    t_spec = time.time() - t0
    summary = trace_analysis.analyze(spec.fn, spec.local_args, spec.mesh)
    t_trace = time.time() - t0 - t_spec

    chips = mesh.size
    flops = summary.flops
    compute_s = flops / PEAK_FLOPS
    memory_s = summary.mem_bytes / HBM_BW
    coll_s = summary.coll_bytes_total / LINK_BW
    mf = model_flops(arch, spec.meta)
    flops_global = flops * chips
    meta = dict(spec.meta)
    meta["n_leaves"] = len(leaves(spec.args))
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "meta": meta,
        "hardware": dict(HARDWARE),
        "timings": {"spec_s": round(t_spec, 2),
                    "trace_s": round(t_trace, 2)},
        "trace": {"flops": flops, "mem_bytes": summary.mem_bytes,
                  "n_ops": summary.n_ops, "kernels": summary.kernels,
                  "flop_convention": FLOP_CONVENTION},
        "memory": _memory(spec, summary),
        "collectives": {
            "bytes_per_device": summary.coll_bytes_total,
            "by_kind_bytes": summary.coll_bytes,
            "by_kind_count": summary.coll_count,
            # the reshard tripwire (one train_step = one round): the
            # packed round's calls against the leafwise round's
            "collective_calls": trace_analysis.collective_calls(summary),
            "mesh_stats": summary.mesh_stats},
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": coll_s,
            "dominant": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", coll_s)], key=lambda kv: kv[1])[0],
            "model_flops": mf,
            "trace_flops_global": flops_global,
            "useful_flop_fraction": (mf / flops_global
                                     if flops_global else None),
        },
    }


def tag_of(arch: str, shape_name: str, *, multi_pod: bool, opt=None,
           packed: str = "auto", fsdp: int = 1, mode=None) -> str:
    """The result's file tag, as the reference names it."""
    tag = f"{arch}_{shape_name}_{'2x16x16' if multi_pod else '16x16'}"
    if opt:
        tag += "_opt-" + opt.replace(",", "+")
    if packed != "auto":
        tag += f"_packed-{packed}"
    if fsdp > 1:
        tag += f"_fsdp-{fsdp}"
    if mode is not None:
        tag += f"_mode-{mode}"
    return tag


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny configs (plumbing test)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--opt", default=None,
                    help="comma-separated REPRO_OPT flags; results are "
                         "tagged _opt-<flags>")
    ap.add_argument("--packed", default="auto", choices=["auto", "on", "off"],
                    help="replicated-FL uplink layout: on/auto = packed "
                         "(shard-local under model-parallel), off = the "
                         "per-leaf leafwise round; tagged _packed-<choice> "
                         "when not auto")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="split the 16-wide data plane into (data, fsdp): "
                         "fsdp=4 -> 4x4x16 (data, fsdp, model); tagged "
                         "_fsdp-N")
    ap.add_argument("--mode", default=None,
                    choices=["replicated", "sketched"],
                    help="force the FL mode (default: sketched for "
                         "BIG_ARCHS at full size, replicated otherwise); "
                         "tagged _mode-<mode> when forced")
    ap.add_argument("--sketch-ratio", type=int, default=256,
                    help="sketched mode: d_s = ceil(packed_size / ratio)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    packed_uplink = {"auto": None, "on": True, "off": False}[args.packed]
    if args.opt is not None:
        os.environ["REPRO_OPT"] = args.opt
    if args.all:
        combos = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if args.arch is None or args.shape is None:
            raise SystemExit("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    for arch, shape_name in combos:
        tag = tag_of(arch, shape_name, multi_pod=args.multi_pod,
                     opt=args.opt, packed=args.packed, fsdp=args.fsdp,
                     mode=args.mode)
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag} (exists)")
            continue
        print(f"[run ] {tag}", flush=True)
        try:
            res = run_one(arch, shape_name, multi_pod=args.multi_pod,
                          reduced=args.reduced, packed_uplink=packed_uplink,
                          fsdp=args.fsdp, fl_mode=args.mode,
                          sketch_ratio=args.sketch_ratio)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            r = res["roofline"]
            print(f"[ ok ] {tag}: trace={res['timings']['trace_s']}s "
                  f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s dom={r['dominant']}",
                  flush=True)
        except Exception as e:
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
