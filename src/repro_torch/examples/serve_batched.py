"""Batched serving example: greedy decode with a KV/state cache.  Torch
twin of ``examples/serve_batched.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch falcon-mamba-7b] [--device cpu]

Runs the reduced variant of any assigned arch: ingests a batch of prompts
and decodes new tokens with the same ``serve_step`` that
``repro_torch.serve.generate`` runs (the vlm and the audio enc-dec decode
text alone, as in the reference: the enc-dec's cross cache stays zero).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.models import get_model, list_archs
from repro_torch.serve import generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="falcon-mamba-7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    key = 0
    model = get_model(args.arch, reduced=True)
    params = model.init(key, device=dev)
    print(f"arch={args.arch} (reduced: {model.cfg.n_layers}L "
          f"d={model.cfg.d_model})")

    prompts = torch.randint(0, model.cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=rng.generator(key, dev), device=dev)
    t0 = time.time()
    out = generate(model, params, prompts, n_steps=args.new_tokens,
                   max_seq=args.prompt_len + args.new_tokens)
    out = out.cpu()
    dt = time.time() - t0
    total_new = args.batch * args.new_tokens
    print(f"decoded {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    for b in range(args.batch):
        print(f"  request {b}: {out[b].tolist()}")
    return {"ids": out, "tok_per_s": total_new / dt}


if __name__ == "__main__":
    main()
