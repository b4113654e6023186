#!/usr/bin/env python3
"""Time the port's ``llm`` round and trace one round on the host side.

    python3 src/repro_torch/benchmarks/llm_walltime.py [--src DIR]
        [--rounds N] [--trace-dir DIR]

The round is ``chip_smoke.py``'s phase ``llm``: granite-8b at full width
with 2 of its 36 layers, W = 2 workers, 1 × 4,096 tokens each, 2 local sgd
steps at 5e-4, through ``make_fl_train``'s ``train_step``, the old state
handed over so the trainer can free it mid-round.  ``--src`` names the
``src`` directory of the checkout to time (default: this one's), so an
older checkout unpacked with ``git archive`` can be timed the same way in
the same call.  The trace of the last round comes from this checkout's
``repro_torch/obs/profiling.trace_session``, loaded by its path, whatever
checkout is timed.

Prints one JSON line: each round's wall seconds (host clock around the
round, synchronised), the allocator's counters each round adds
(``torch.cuda.memory_stats``: device allocations and frees, segments,
retries), the peak, and from the traced round the device time of its
kernels, the host time of its CUDA API calls by name and the share of the
round's wall time the card was busy.  Needs one card; exits 1 without.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

#: the checkout's root (this file is src/repro_torch/benchmarks/…)
HERE = Path(__file__).resolve().parents[3]
#: allocator counters a round may move (``torch.cuda.memory_stats``)
ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
               "num_sync_all_streams", "segment.all.allocated",
               "segment.all.freed")


def _profiling():
    """This checkout's ``obs/profiling.py``, loaded by path (it imports
    only torch)."""
    path = HERE / "src" / "repro_torch" / "obs" / "profiling.py"
    spec = importlib.util.spec_from_file_location("llm_walltime_profiling",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(HERE / "src"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--trace-dir", default=None,
                    help="where the traced round's Chrome trace goes "
                         "(default: a temporary directory)")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("llm_walltime: no CUDA device", file=sys.stderr)
        return 1
    profiling = _profiling()
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_config
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=2)
    W, S = 2, 4096
    init_fn, step = make_fl_train(
        build_model(cfg),
        FLConfig(n_workers=W, local_steps=2, local_lr=5e-4,
                 local_optimizer="sgd"),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10))
    batch = {"tokens": token_dataset(1, 1, S, cfg.vocab_size, n_workers=W)}
    held = [init_fn(0)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def one(r: int):
        before = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        state, m = step(held.pop(), batch, key=rng.fold_in(0, r + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        held.append(state)
        after = torch.cuda.memory_stats()
        return wall, float(m["loss"]), {k: after.get(k, 0) - before.get(k, 0)
                                        for k in ALLOC_STATS}

    walls, losses, alloc = [], [], []
    for r in range(args.rounds):
        w, loss, a = one(r)
        walls.append(w)
        losses.append(loss)
        alloc.append(a)
    peak = torch.cuda.max_memory_allocated()

    import tempfile
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="llm_walltime_")
    with profiling.trace_session(trace_dir) as sess:
        traced_wall, _, traced_alloc = one(args.rounds)
    from torch.autograd import DeviceType
    events = sess.profiler.key_averages() if sess.profiler else []
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    api = {e.key: {"calls": e.count, "host_ms": e.self_cpu_time_total / 1e3}
           for e in events if e.device_type == DeviceType.CPU
           and (e.key.startswith("cuda") or e.key.startswith("cu"))}
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(json.dumps({
        "src": args.src, "alloc_conf": os.environ["PYTORCH_CUDA_ALLOC_CONF"],
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "round_s": walls, "loss": losses, "alloc_per_round": alloc,
        "peak_gb": peak / 1e9, "traced_round_s": traced_wall,
        "traced_alloc": traced_alloc, "traced_device_ms": device_ms,
        "traced_busy_share": device_ms / (traced_wall * 1e3),
        "cuda_api": dict(sorted(api.items(),
                                key=lambda kv: -kv[1]["host_ms"])[:12]),
        "trace": sess.path, "trace_error": sess.error}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
