"""Serving layer: prefill and batched greedy decode over the model API.
Counterpart of ``repro/serve/serving.py``.

``make_serve_step`` makes ONE new token for every sequence of the batch
against a KV/state cache, which it updates in place (JAX donates the
cache to the compiled step).  Prefill is the model's full forward, so it
runs B11 (dense) or B12 (the SSM and the hybrid's recurrent layers) on the
card; decode is plain torch, as the reference computes it outside any
kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.registry import Model

Tensor = torch.Tensor


def make_prefill(model: Model):
    """prefill(params, batch) -> the last position's logits (B, V) of the
    full forward, without autograd."""

    def prefill(params, batch):
        with torch.no_grad():
            logits, _aux = model.forward(params, batch, remat=True)
            return logits[:, -1]

    return prefill


def make_serve_step(model: Model):
    """serve_step(params, cache, token, pos) -> (next token (B,) int32,
    cache): one greedy step, the cache updated in place."""

    def serve_step(params, cache, token: Tensor, pos: int):
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache, token, pos)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def generate(model: Model, params, prompt_tokens: Tensor, n_steps: int,
             max_seq: Optional[int] = None) -> Tensor:
    """Greedy generation: teacher-forced prompt ingest, then ``n_steps``
    decode steps.  prompt_tokens: (B, S0) on the params' device.  Returns
    the (B, n_steps) int32 generated ids.

    The prompt runs through ``decode_step`` a token at a time, so one cache
    layout serves both phases (the batched prefill is
    :func:`make_prefill`)."""
    B, S0 = prompt_tokens.shape
    max_seq = max_seq or (S0 + n_steps)
    dev = prompt_tokens.device
    cache = model.init_cache(B, max_seq, device=dev)
    step = make_serve_step(model)

    tok = prompt_tokens[:, 0]
    for i in range(1, S0):          # ingest the prompt
        _, cache = step(params, cache, tok, i - 1)
        tok = prompt_tokens[:, i]

    out = []
    pos = S0 - 1
    for i in range(n_steps):
        tok, cache = step(params, cache, tok, pos + i)
        out.append(tok)
    return torch.stack(out, dim=1)
