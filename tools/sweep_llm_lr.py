#!/usr/bin/env python3
"""Sweep the local sgd rate of the federated LLM trainer at full width on
the card, as ``chip_smoke.py``'s phases ``llm`` and ``llm_ssm`` run it:
granite-8b with 2 of its 36 layers or falcon-mamba-7b with 2 of its 64
layers, one 4,096-token sequence a worker;
W = 2 workers (the same tokens every round), 2 local steps.

    python3 tools/sweep_llm_lr.py             # the rate sweep, bf16
    python3 tools/sweep_llm_lr.py --witness   # what an overshoot is due to
    python3 tools/sweep_llm_lr.py --witness --dtype float32
    python3 tools/sweep_llm_lr.py --arch falcon-mamba-7b [--witness]

The sweep runs each (rate, noisy uplink) of ``RUNS``; the noise-free run
tells the rate's overshoot from the analog noise.  ``--witness`` runs the
rates of ``WITNESS_LRS`` three ways each: the model's kernel (B11 flash
attention for granite, B12 linear scan for falcon-mamba) on the card, the
same autograd.Function on the kernel's plain PyTorch versions
(``kernels/ref.py``), and the whole model in f32 on the kernels.  Equal
trajectories from the first two rule out the kernel; an overshoot in f32
rules out bf16 rounding of the sgd step.

One JSON line a run: the per-round loss (mean over workers at the last
local step), θ drift, α⁻¹, peak memory and the kernel launches of the run
(a run that does not fit says so).  Needs one NVIDIA GPU with ~60 GB free
(more for f32) and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: (rate, noisy uplink, kernel path, parameter dtype)
RUNS = tuple((lr, True, "kernel", "bfloat16")
             for lr in (1e-3, 5e-4, 2.5e-4, 1e-4)) + (
    (1e-3, False, "kernel", "bfloat16"),)
#: the rates the witness runs, by architecture
WITNESS_LRS = {"granite-8b": (1e-2, 1e-3), "falcon-mamba-7b": (1e-3, 5e-4)}
#: (layers kept, tokens a worker) by architecture
SHAPES = {"granite-8b": (2, 4096), "falcon-mamba-7b": (2, 4096)}
ROUNDS = 6
SEED = 0


def witness_runs(arch: str):
    return tuple((lr, True, path, dtype)
                 for path, dtype in (("kernel", "bfloat16"),
                                     ("plain", "bfloat16"),
                                     ("kernel", "float32"))
                 for lr in WITNESS_LRS[arch])


def _plain_attention():
    """Patch B11's three entry points to their plain versions, for the
    autograd.Function that looks them up at each call."""
    from unittest import mock

    from repro_torch.kernels import flash_attention as fa, ref

    def fwd(q, k, v, causal=True, scale=None):
        return ref.flash_attention_fwd(q, k, v, causal, scale)

    def dq(q, k, v, do, lse, delta, causal=True, scale=None):
        return ref.flash_attention_bwd(q, k, v, do, causal, scale, lse=lse,
                                       delta=delta)[0]

    def dkv(q, k, v, do, lse, delta, causal=True, scale=None):
        return ref.flash_attention_bwd(q, k, v, do, causal, scale, lse=lse,
                                       delta=delta)[1:]

    return mock.patch.multiple(fa, flash_attention_fwd=fwd,
                               flash_attention_dq=dq,
                               flash_attention_dkv=dkv)


def _plain_scan():
    """Patch B12's two entry points to their plain versions, for the
    ``LinearScan`` autograd.Function that looks them up at each call."""
    from unittest import mock

    from repro_torch.kernels import linear_scan as ls, ref

    return mock.patch.multiple(ls, linear_scan_fwd=ref.linear_scan,
                               linear_scan_bwd=ref.linear_scan_bwd)


def run(arch: str, lr: float, noisy: bool, path: str, dtype: str) -> dict:
    if path == "plain":
        plain = _plain_attention if arch == "granite-8b" else _plain_scan
        with plain():
            return _run(arch, lr, noisy, path, dtype)
    return _run(arch, lr, noisy, path, dtype)


def _run(arch: str, lr: float, noisy: bool, path: str, dtype: str) -> dict:
    import torch

    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    layers, seq = SHAPES[arch]
    cfg = dataclasses.replace(get_model(arch).cfg, n_layers=layers,
                              param_dtype=dtype)
    W = 2
    tokens = token_dataset(SEED + 1, 1, seq, cfg.vocab_size, n_workers=W)
    init_fn, step = make_fl_train(
        build_model(cfg), FLConfig(n_workers=W, local_steps=2, local_lr=lr),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10,
                      noisy=noisy))
    state = init_fn(SEED)
    out = {"arch": arch, "lr": lr, "noisy": noisy, "path": path,
           "dtype": dtype, "loss": [], "theta_drift": [], "inv_alpha": []}
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    for r in range(ROUNDS):
        state, m = step(state, {"tokens": tokens},
                        key=rng.fold_in(SEED, r + 1))
        for k in ("loss", "theta_drift", "inv_alpha"):
            out[k].append(float(m[k]))
    out["seconds"] = time.perf_counter() - t0
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = {k: n for k, n in build.launches.items() if n}
    del state, init_fn, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", choices=tuple(SHAPES),
                        default="granite-8b")
    parser.add_argument("--witness", action="store_true",
                        help="run the witness runs instead of the rate "
                        "sweep")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        help="only the runs of this parameter dtype")
    args = parser.parse_args()
    # the f32 model peaks near 65 GB: let freed blocks be remapped rather
    # than held as reserved fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("sweep_llm_lr: no CUDA device", file=sys.stderr)
        return 1
    for spec in witness_runs(args.arch) if args.witness else RUNS:
        if args.dtype and spec[3] != args.dtype:
            continue
        try:
            out = run(args.arch, *spec)
        except torch.cuda.OutOfMemoryError as e:
            # a model that does not fit is a result too: say so, go on
            out = dict(zip(("lr", "noisy", "path", "dtype"), spec),
                       arch=args.arch,
                       error=f"out of memory: {str(e).splitlines()[0]}")
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
