"""Serving throughput microbenchmark: batched greedy decode on the reduced
variants.  Torch twin of ``benchmarks/serve_microbench.py``.

Per arch (the reference's four by default, any of ``list_archs()`` by
``archs``): tokens/s of ``serve.generate`` after a one-step warm-up (wall
clock, the card synchronised at the end of the timed call) and whether the
ids have the expected shape.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        --only serve_microbench [--device cpu]
"""
from __future__ import annotations

import time

import torch

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serve import generate

ARCHS = ("granite-8b", "falcon-mamba-7b", "recurrentgemma-2b",
         "qwen3-moe-30b-a3b")


def serve_microbench(batch: int = 4, new_tokens: int = 12,
                     device="cuda", archs=ARCHS) -> dict:
    dev = resolve_device(device)
    key = 0
    out = {}
    for arch in archs:
        m = get_model(arch, reduced=True)
        params = m.init(key, device=dev)
        prompts = torch.randint(0, m.cfg.vocab_size, (batch, 4),
                                generator=rng.generator(key, dev),
                                device=dev)
        generate(m, params, prompts, n_steps=1, max_seq=4 + new_tokens)
        t0 = time.time()
        toks = generate(m, params, prompts, n_steps=new_tokens,
                        max_seq=4 + new_tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        out[arch] = {"tok_per_s": round(batch * new_tokens / dt, 1),
                     "shape_ok": list(toks.shape) == [batch, new_tokens]}
    return out
