"""End-to-end driver: federated training of a transformer over the
simulated wireless channel (A-FADMM replicated mode).  Torch twin of
``examples/train_llm_federated.py``, with its flags.

    PYTHONPATH=src python -m repro_torch.examples.train_llm_federated \
        [--d-model 256 --layers 8 --steps 300] [--device cpu]

The defaults are a ~10M-parameter granite-family decoder and 300 rounds;
raise --d-model/--layers toward the 100M+ regime on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import rng
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.synthetic import token_dataset
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model, get_config
from repro_torch.train.llm_trainer import FLConfig, make_fl_train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--snr-db", type=float, default=40.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_config("granite-8b"), n_layers=args.layers,
        d_model=args.d_model, n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 128), head_dim=64,
        d_ff=4 * args.d_model, vocab_size=args.vocab,
        name=f"granite-{args.d_model}d{args.layers}L")
    model = build_model(cfg)
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M  "
          f"workers={args.workers}")

    key = 0
    W = args.workers
    flcfg = FLConfig(mode="replicated", n_workers=W, local_steps=2,
                     local_lr=2e-2)
    init_fn, train_step = make_fl_train(
        model, flcfg, AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=args.snr_db), device=dev)

    data = token_dataset(key, 128, args.seq, cfg.vocab_size, n_workers=W,
                         device=dev)
    st = init_fn(key)
    losses = []
    t0 = time.time()
    for r in range(args.steps):
        idx = torch.randint(0, data.shape[1], (W, args.batch),
                            generator=rng.generator(rng.fold_in(key, r), dev),
                            device=dev)
        batch = {"tokens": torch.gather(
            data, 1, idx[:, :, None].expand(W, args.batch, args.seq))}
        st, m = train_step(st, batch, key=rng.fold_in(key, 10_000 + r))
        if r % 25 == 0 or r == args.steps - 1:
            losses.append(float(m["loss"]))
            print(f"step {r:4d}  loss={losses[-1]:.4f}  "
                  f"worker-drift={float(m['theta_drift']):.4f}  "
                  f"({(time.time() - t0) / (r + 1):.2f}s/step)", flush=True)
    print(f"total {time.time() - t0:.0f}s")
    return {"loss": losses, "seconds": time.time() - t0}


if __name__ == "__main__":
    main()
