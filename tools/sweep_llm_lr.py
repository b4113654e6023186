#!/usr/bin/env python3
"""Sweep the local sgd rate of the federated LLM trainer at full width on
the card: granite-8b with 2 of its 36 layers, W = 2 workers, one 4,096-token
sequence each (the same tokens every round), 2 local steps, as
``chip_smoke.py``'s phase ``llm`` runs it.

    python3 tools/sweep_llm_lr.py             # the rate sweep, bf16
    python3 tools/sweep_llm_lr.py --witness   # what the overshoot is due to
    python3 tools/sweep_llm_lr.py --witness --dtype float32

The sweep runs each (rate, noisy uplink) of ``RUNS``; the noise-free run
tells the rate's overshoot from the analog noise.  ``--witness`` runs the
rates that overshoot, 1e-2 and 1e-3, three ways each (``WITNESS_RUNS``):
attention through the B11 kernels, attention through their plain PyTorch
versions (``kernels/ref.py``, exact softmax in f32, on the same
autograd.Function), and the whole model in f32 on the kernels.  Equal
trajectories from the first two rule out B11; an overshoot in f32 rules out
bf16 rounding of the sgd step.

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

#: (rate, noisy uplink, attention, parameter dtype)
RUNS = tuple((lr, True, "kernel", "bfloat16")
             for lr in (1e-3, 5e-4, 2.5e-4, 1e-4)) + (
    (1e-3, False, "kernel", "bfloat16"),)
WITNESS_RUNS = tuple((lr, True, attention, dtype)
                     for attention, dtype in (("kernel", "bfloat16"),
                                              ("plain", "bfloat16"),
                                              ("kernel", "float32"))
                     for lr in (1e-2, 1e-3))
ROUNDS = 6
SEED = 0


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


def run(lr: float, noisy: bool, attention: str, dtype: str) -> dict:
    if attention == "plain":
        with _plain_attention():
            return _run(lr, noisy, attention, dtype)
    return _run(lr, noisy, attention, dtype)


def _run(lr: float, noisy: bool, attention: str, dtype: str) -> dict:
    import torch

    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    cfg = dataclasses.replace(get_model("granite-8b").cfg, n_layers=2,
                              param_dtype=dtype)
    W = 2
    tokens = token_dataset(SEED + 1, 1, 4096, cfg.vocab_size, n_workers=W)
    init_fn, step = make_fl_train(
        build_model(cfg), FLConfig(n_workers=W, local_steps=2, local_lr=lr),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10,
                      noisy=noisy))
    state = init_fn(SEED)
    out = {"lr": lr, "noisy": noisy, "attention": attention, "dtype": dtype,
           "loss": [], "theta_drift": [], "inv_alpha": []}
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
    parser.add_argument("--witness", action="store_true",
                        help="run WITNESS_RUNS instead of the rate sweep")
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
    for spec in WITNESS_RUNS if args.witness else RUNS:
        if args.dtype and spec[3] != args.dtype:
            continue
        try:
            out = run(*spec)
        except torch.cuda.OutOfMemoryError as e:
            # a model that does not fit is a result too: say so, go on
            out = dict(zip(("lr", "noisy", "attention", "dtype"), spec),
                       error=f"out of memory: {str(e).splitlines()[0]}")
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
