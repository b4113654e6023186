"""Dense decoder-only transformer (qwen1.5 / codeqwen / starcoder2 / granite
/ the pixtral backbone), with the layers stacked on a leading ``n_layers``
dim.  Counterpart of ``repro/models/transformer.py`` (no prefill cache):
the full-sequence forward and the one-token decode against a KV cache
(:func:`init_cache`, :func:`decode_step`; a rotating buffer of ``window``
slots under a sliding window), which updates the cache in place.  The vlm
arch's stub vision frontend is a ``projector`` leaf: :func:`lm_forward`'s
``frontend_embeds`` (the stub patches) are projected and put in front of
the token embeddings.

A Python loop over the stacked layers replaces ``lax.scan``; ``remat=True``
(JAX's default) checkpoints each layer with
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so the
backward pass runs each layer's forward again — B11's forward included;
under ``REPRO_OPT=save_dots`` the forward keeps the matrix products'
outputs and the backward recomputes the rest (``run_stacked``).
Leaves may carry a leading worker dim W in front of ``n_layers``
(``models/layers.py``); layer ``i`` is then ``leaf[:, i]``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import optflags, rng
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Params = Dict


def init_block(key: int, cfg: ModelConfig, device="cuda") -> Params:
    k1, k2 = rng.split(key)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
        "attn": L.attention_init(k1, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
        "mlp": L.mlp_init(k2, cfg, device=device),
    }


def block_fwd(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor,
              window: Optional[int]) -> Tuple[Tensor, Dict[str, Tensor]]:
    a, kv = L.attention_fwd(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                            cfg, positions, window)
    x = x + a
    x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x, kv


def block_decode(p: Params, x: Tensor, cfg: ModelConfig, ck: Tensor,
                 cv: Tensor, write_pos: int, abs_pos: int):
    a, ck, cv = L.attention_decode(p["attn"],
                                   L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                   cfg, ck, cv, write_pos, abs_pos)
    x = x + a
    x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x, ck, cv


def init_stacked(init_one: Callable[[int], Params], keys) -> Params:
    """The trees ``init_one(k)`` for each of ``keys``, stacked leafwise on a
    leading dim (``jax.vmap(init_one)(keys)``'s layout, ``tree_stack``'s
    tensors): the stacked leaves are allocated once and filled an entry at
    a time, so the init holds the stack and one entry, never two copies
    (one entry is its own stack, a view)."""
    out = dst = None
    for i, k in enumerate(keys):
        entry = init_one(k)
        if out is None:
            if len(keys) == 1:
                return tree_map(lambda l: l[None], entry)
            out = tree_map(
                lambda l: l.new_empty((len(keys),) + tuple(l.shape)), entry)
            dst = tree_leaves(out)
        for d_, s_ in zip(dst, tree_leaves(entry)):
            d_[i].copy_(s_)
        del entry
    return out


def init_params(key: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random init from an integer key: per-layer leaves stacked on a
    leading ``n_layers`` dim, as ``jax.vmap(init_block)`` makes them, and
    the vision frontend's ``projector`` (frontend_dim → d_model) when
    ``modality == "vision"``."""
    device = resolve_device(device)
    ke, kl, kp = rng.split(key, 3)
    params = {
        "embed": L.embedding_init(ke, cfg.vocab_size, cfg.d_model, cfg.dtype,
                                  device),
        "layers": init_stacked(lambda k: init_block(k, cfg, device),
                               [rng.fold_in(kl, i)
                                for i in range(cfg.n_layers)]),
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
    }
    if cfg.modality == "vision":
        params["projector"] = L.dense_init(kp, cfg.frontend_dim, cfg.d_model,
                                           cfg.dtype, device=device)
    return params


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: Tensor,
                  frontend_embeds: Optional[Tensor] = None) -> Tensor:
    """Token embeddings (..., S, d); with ``frontend_embeds`` (..., P,
    frontend_dim), the projected patches (cast to the param dtype) in front
    of them: (..., P + S, d)."""
    x = L.embed(params["embed"], tokens, cfg.vocab_size)
    if frontend_embeds is not None:
        patches = L.dense(params["projector"],
                          frontend_embeds.to(cfg.dtype))
        x = torch.cat([patches, x], dim=-2)
    return x


#: the keys whose leaves the families stack on a leading entry dim (the
#: layers; the hybrid's super-blocks; the moe family's dense and MoE
#: layers; the encoder's and the decoder's layers): :func:`run_stacked`
#: reads them
STACKED_KEYS = ("layers", "super", "dense_layers", "moe_layers",
                "enc_layers", "dec_layers")


def unstack(params: Params) -> Params:
    """``params`` with each stacked entry of :data:`STACKED_KEYS` as a list
    of one tree an entry (views of the stacked leaves), which
    :func:`layer_params` reads as it reads the stacked leaves.  Made
    autograd leaves, the views give each entry a gradient of its own,
    where a stacked leaf's backward pass would add a zero-filled gradient
    of its whole size once an entry."""
    out = dict(params)
    for key in STACKED_KEYS:
        if isinstance(params.get(key), dict):
            n = tree_leaves(params[key])[0].shape[0]
            out[key] = [tree_map(lambda leaf, i=i: leaf[i], params[key])
                        for i in range(n)]
    return out


def layer_params(params: Params, i: int, key: str = "layers") -> Params:
    """Entry ``i`` of the stacked ``params[key]`` (views), behind the
    leading worker dim if the leaves carry one; entry ``i`` of the list
    where ``params[key]`` is :func:`unstack`'s."""
    if isinstance(params[key], list):
        return params[key][i]
    lead = params["embed"]["table"].dim() - 2
    index = (slice(None),) * lead + (i,)
    return tree_map(lambda leaf: leaf[index], params[key])


def decode_layer(params: Params, i: int, key: str = "layers") -> Params:
    """Entry ``i`` of ``params[key]`` for a decode step: :func:`layer_params`,
    with the entry's sharded dims gathered under a mesh's gather plan
    (``models/gather``: the serving layer's, the params held as a rank's
    shards; where the plan partitions the products, the leaves of the
    partitioned ones keep their ``model`` block, ``partition.model_dims``);
    without a plan, :func:`layer_params` itself."""
    from repro_torch.models import gather as _gather

    return _gather.gather_entry(_gather.current(),
                                layer_params(params, i, key), key)


#: the matrix products ``dense``, the einsums and ``matmul`` lower to
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_saveable(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """JAX's ``dots_saveable``: keep the outputs of the matrix products,
    recompute everything else.  The CUDA kernels (B11, B12) are ctypes
    launches the dispatcher never sees, so they run again, as a
    ``pallas_call`` (no ``dot_general``) does under JAX's policy."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if func in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def run_stacked(params: Params, x: Tensor, block: Callable, n: int,
                remat: bool, key: str = "layers", with_aux: bool = False):
    """x through ``block(x, entry)`` for each of the ``n`` stacked entries
    of ``params[key]`` in order (JAX's ``lax.scan``); with ``remat`` each
    entry is one ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of
    the scan body), so the backward pass runs its forward again, all of it
    (JAX's ``nothing_saveable``) or, under ``optflags`` ``save_dots``, all
    but the matrix products, whose outputs the forward keeps
    (:func:`_dots_saveable`).  With ``with_aux`` the block returns
    ``(x, aux)`` (the scan's per-layer output) and so does this: ``(x, [aux
    of each entry])``.  Under a gather plan (``models/gather``: θ held as
    shards of a mesh) each entry's shards are gathered inside its block, so
    the recompute gathers again and one full entry is alive at a time;
    where the plan partitions the products (``models/partition``), only
    the fsdp dims of their leaves are gathered, and the block runs under
    the plan again when the backward recomputes it."""
    from repro_torch.models import gather as _gather

    plan = _gather.current()
    if plan is not None:
        inner = block

        def block(x_, p_):
            with _gather.gathering(plan):
                return inner(x_, _gather.gather_entry(plan, p_, key))
    policy = {}
    if remat and optflags.enabled("save_dots"):
        policy["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    auxs = []
    for i in range(n):
        entry = layer_params(params, i, key)
        if remat:
            out = checkpoint(block, x, entry, use_reentrant=False,
                             preserve_rng_state=False, **policy)
        else:
            out = block(x, entry)
        if with_aux:
            x, a = out
            auxs.append(a)
        else:
            x = out
    return (x, auxs) if with_aux else x


def lm_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
               frontend_embeds: Optional[Tensor] = None,
               remat: bool = True) -> Tensor:
    """Full-sequence forward over tokens (..., B, S), after the projected
    ``frontend_embeds`` (..., B, P, frontend_dim) where given (positions
    over the whole P + S sequence). Returns logits."""
    x = _embed_inputs(params, cfg, tokens, frontend_embeds)
    S = x.shape[-2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    def block(x_: Tensor, p_: Params) -> Tensor:
        return block_fwd(p_, x_, cfg, positions, cfg.sliding_window)[0]

    x = run_stacked(params, x, block, cfg.n_layers, remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> Dict[str, Tensor]:
    """Zero K and V caches (n_layers, B, T, KV, hd): T = max_seq, or
    min(max_seq, window) under a sliding window."""
    dtype = dtype or cfg.dtype
    kvs = (max_seq if cfg.sliding_window is None
           else min(max_seq, cfg.sliding_window))
    shape = (cfg.n_layers, batch, kvs, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Tensor],
                token: Tensor, pos: int) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One greedy decode step. token: (B,) ids; pos: the absolute position.
    Returns the (B, V) logits and the cache, written in place at slot
    ``pos`` (``pos % window`` in a sliding window's rotating buffer).

    Under serving's partition (``models/partition``) the cache is the
    rank's block, the slot is the global one (``layers.attention_decode``
    hands it to the rank whose slice of the sequence holds it), and the
    logits are the rank's vocab columns (B, V/n)."""
    from repro_torch.models import partition

    part = partition.current()
    x = L.embed(params["embed"], token[:, None], cfg.vocab_size)
    T = cache["k"].shape[2]
    if part is not None and part.cache == "seq":
        T *= part.seq_n
    write_pos = pos % T if cfg.sliding_window is not None else pos
    for i in range(cfg.n_layers):
        x, _, _ = block_decode(decode_layer(params, i), x, cfg,
                               cache["k"][i], cache["v"][i], write_pos, pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
