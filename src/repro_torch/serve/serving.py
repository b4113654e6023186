"""Serving layer: prefill and batched greedy decode over the model API.
Counterpart of ``repro/serve/serving.py``.

``make_serve_step`` makes ONE new token for every sequence of the batch
against a KV/state cache, which it updates in place (JAX donates the
cache to the compiled step).  Prefill is the model's full forward (with
the batch's stub patches or frames for the vlm and the audio enc-dec), so
it runs B11 (dense, vlm, qwen3-moe, the enc-dec's decoder) or B12 (the SSM
and the hybrid's recurrent layers) on the card; MLA is plain einsums.
Decode is plain torch, as the reference computes it outside any kernel;
``generate`` starts the enc-dec from a zero cross cache, as the reference
does (``models/encdec.prefill_cross`` fills it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import gather as _gather
from repro_torch.models.registry import Model
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def _mesh_layout(model: Model, mesh, fsdp: bool):
    """``(layout, shard)``: under ``mesh`` a rank holds its block of every
    parameter (``launch.shardings.tree_pspecs`` with no worker dim: the big
    dims over ``model``, and over the fsdp axes where ``fsdp``);
    ``shard(params)`` cuts that block from the full params and puts the
    gather plan into ``layout["plan"]``.  Without a mesh there is no plan
    and ``shard`` is the identity."""
    layout: dict = {"plan": None}

    def shard(params):
        if mesh is None:
            return params
        from repro_torch.launch.shardings import (fsdp_axes, shard_leaf,
                                                  tree_pspecs)
        from repro_torch.models.gather import make_plan
        from repro_torch.tree import tree_leaves

        multi_pod = "pod" in mesh.axis_names
        specs = tree_pspecs(params, model.cfg, mesh, worker_dim=False,
                            fsdp=fsdp, multi_pod=multi_pod)
        faxes = fsdp_axes(mesh, worker_dim=False, multi_pod=multi_pod)
        fset = set(faxes or ())
        mdims, fdims = [], []
        for spec in tree_leaves(specs):
            axes = [(d, e if isinstance(e, tuple) else (e,))
                    for d, e in enumerate(spec) if e is not None]
            mdims.append(next((d for d, a in axes if "model" in a), None))
            fdims.append(next((d for d, a in axes if fset & set(a)), None))
        layout["plan"] = make_plan(params, mdims, fdims, mesh, lead=0,
                                   fsdp_axis=faxes or "fsdp")
        layout["specs"] = specs
        # a copy: the block alone, not a view that keeps the full leaf
        return tree_map(lambda x, sp: shard_leaf(x, sp, mesh).clone(
            memory_format=torch.contiguous_format), params, specs)

    return layout, shard


def make_prefill(model: Model, mesh=None, *, fsdp: bool = False):
    """prefill(params, batch) -> the last position's logits (B, V) of the
    full forward, without autograd.  Under ``mesh`` (a ``launch.mesh``
    mesh, as the trainer takes) a rank holds its block of the parameters
    (``prefill.shard(full)`` cuts it and builds the gather plan; call it
    first) and its rows of the batch; each layer is gathered whole
    (``models/gather``; serving's plan partitions no product, where the
    trainer's computes each rank's heads, ff columns and vocab rows)."""
    layout, shard = _mesh_layout(model, mesh, fsdp)

    def prefill(params, batch):
        with torch.no_grad(), _gather.gathering(layout["plan"]):
            logits, _aux = model.forward(_gather.gather_params(params),
                                         batch, remat=True)
            return logits[:, -1]

    prefill.shard = shard
    prefill.layout = layout
    return prefill


def make_serve_step(model: Model, mesh=None, *, fsdp: bool = False):
    """serve_step(params, cache, token, pos) -> (next token (B,) int32,
    cache): one greedy step, the cache updated in place.  Under ``mesh``
    the params are the rank's block (``serve_step.shard(full)`` first) and
    the cache, the tokens and the logits the rank's rows of the batch;
    each family's ``decode_step`` gathers a layer at a time
    (``transformer.decode_layer``)."""
    layout, shard = _mesh_layout(model, mesh, fsdp)

    def serve_step(params, cache, token: Tensor, pos: int):
        with torch.no_grad(), _gather.gathering(layout["plan"]):
            logits, cache = model.decode_step(
                _gather.gather_params(params), cache, token, pos)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

    serve_step.shard = shard
    serve_step.layout = layout
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
