"""Hybrid family: recurrentgemma-2b (Griffin), RG-LRU recurrent blocks
interleaved 2:1 with local (sliding-window) MQA attention blocks.
Counterpart of ``repro/models/hybrid.py``, the full-sequence half.

The block pattern ("rec", "rec", "attn") repeats: 26 layers are 8
super-blocks of 3, stacked on a leading dim, plus a tail of 2 layers (rec,
rec) kept as a list.  Each layer is a temporal block (RG-LRU or attention)
followed by a geglu MLP block.

Recurrent block, Griffin §2:
    y = W_out( gelu(W_1 x)  ⊙  RG-LRU(conv1d(W_2 x)) )
RG-LRU:
    r = σ(W_a x + b_a);  i = σ(W_x x + b_x);  log a = −c·softplus(Λ)·r (c=8)
    h_t = a ⊙ h_{t−1} + sqrt(1 − a²) ⊙ (i ⊙ x_t)
The recurrence runs B12 (``kernels/linear_scan.py``) with the leading
worker and batch dims folded into its batch.  Attention is windowed
(``attn_window``), so it takes ``layers.attention_fwd``'s masked fallback,
not B11.  ``remat=True`` checkpoints each super-block as one unit, as JAX's
``jax.checkpoint(body)`` does; the tail layers are not checkpointed.

Decode runs in plain torch (:func:`init_cache`, :func:`decode_step`): a
rec layer keeps its f32 RG-LRU state (B, lru_width) and conv window, an
attention layer a rotating KV buffer of ``attn_window`` slots written at
``pos % attn_window``; the caches of the super-blocks are stacked and the
tail's a list, in the parameters' order, and are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.kernels.linear_scan import gated_linear_scan
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import _conv1d_causal
from repro_torch.models.transformer import (init_stacked, layer_params,
                                            run_stacked)
from repro_torch.tree import tree_map

Tensor = torch.Tensor
Params = Dict

LRU_C = 8.0


def _attn_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, sliding_window=cfg.attn_window)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block
# ---------------------------------------------------------------------------

def rec_block_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    d, dw = cfg.d_model, cfg.lru_width
    dt = cfg.dtype
    dev = resolve_device(device)
    k = rng.split(key, 7)
    # Λ so that a^c·softplus starts in the [0.9, 0.999] regime (Griffin
    # appendix)
    u = torch.empty(dw, device=dev).uniform_(0.1, 0.9,
                                             generator=rng.generator(k[0], dev))
    g = rng.generator(k[3], dev)
    return {
        "norm": L.rmsnorm_init(d, dt, dev),
        "w_gelu": L.dense_init(k[1], d, dw, dt, device=dev),
        "w_rec": L.dense_init(k[2], d, dw, dt, device=dev),
        "conv_w": (torch.randn((cfg.conv1d_width, dw), generator=g,
                               device=dev) * 0.1).to(dt),
        "conv_b": torch.zeros((dw,), dtype=dt, device=dev),
        "gate_a": L.dense_init(k[4], dw, dw, dt, bias=True, device=dev),
        "gate_x": L.dense_init(k[5], dw, dw, dt, bias=True, device=dev),
        "lam": torch.log(torch.expm1(u)),
        "w_out": L.dense_init(k[6], dw, d, dt, device=dev),
    }


def _rglru_coeffs(p: Params, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (..., dw) -> (a, gated input b) in f32."""
    r = torch.sigmoid(L.dense(p["gate_a"], x).float())
    i = torch.sigmoid(L.dense(p["gate_x"], x).float())
    log_a = -LRU_C * r * L._bcast(F.softplus(p["lam"]), r, 1)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x.float())
    return a, b


def rec_block_fwd(p: Params, u: Tensor, cfg: ModelConfig) -> Tensor:
    x = L.rmsnorm(p["norm"], u, cfg.norm_eps)
    g = L._gelu(L.dense(p["w_gelu"], x))
    y = L.dense(p["w_rec"], x)
    y = _conv1d_causal(p["conv_w"], p["conv_b"], y)
    a, b = _rglru_coeffs(p, y)
    S, dw = a.shape[-2:]
    h = gated_linear_scan(a.reshape(-1, S, dw),
                          b.reshape(-1, S, dw)).reshape(a.shape)
    y = h.to(u.dtype) * g
    return u + L.dense(p["w_out"], y)


def rec_block_decode(p: Params, u: Tensor, cfg: ModelConfig,
                     lru_state: Tensor, conv_state: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """u: (B, 1, d); lru_state: (B, dw) f32; conv_state: (B, K − 1, dw).
    Returns (out, new state, new conv window)."""
    x = L.rmsnorm(p["norm"], u, cfg.norm_eps)
    g = L._gelu(L.dense(p["w_gelu"], x))
    y = L.dense(p["w_rec"], x)                           # (B, 1, dw)
    window = torch.cat([conv_state, y], dim=1)
    y = (torch.einsum("bwd,wd->bd", window, p["conv_w"])
         + p["conv_b"])[:, None]
    a, b = _rglru_coeffs(p, y)
    h = a[:, 0] * lru_state + b[:, 0]
    y = h[:, None].to(u.dtype) * g
    return u + L.dense(p["w_out"], y), h, window[:, 1:]


# ---------------------------------------------------------------------------
# attention + mlp sub-blocks
# ---------------------------------------------------------------------------

def attn_block_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    return {"ln": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
            "attn": L.attention_init(key, _attn_cfg(cfg), device)}


def attn_block_fwd(p: Params, x: Tensor, cfg: ModelConfig,
                   positions: Tensor) -> Tensor:
    a, _ = L.attention_fwd(p["attn"], L.rmsnorm(p["ln"], x, cfg.norm_eps),
                           _attn_cfg(cfg), positions, cfg.attn_window)
    return x + a


def mlp_block_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    return {"ln": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
            "mlp": L.mlp_init(key, cfg, device=device)}


def mlp_block_fwd(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)


# ---------------------------------------------------------------------------
# full model: stacked super-blocks + tail
# ---------------------------------------------------------------------------

def _layer_init(key: int, cfg: ModelConfig, kind: str,
                device="cuda") -> Params:
    k1, k2 = rng.split(key)
    tm = (rec_block_init(k1, cfg, device) if kind == "rec"
          else attn_block_init(k1, cfg, device))
    return {"temporal": tm, "mlp_blk": mlp_block_init(k2, cfg, device)}


def _layer_fwd(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor,
               kind: str) -> Tensor:
    if kind == "rec":
        x = rec_block_fwd(p["temporal"], x, cfg)
    else:
        x = attn_block_fwd(p["temporal"], x, cfg, positions)
    return mlp_block_fwd(p["mlp_blk"], x, cfg)


def _split_pattern(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    tail = tuple(pat[: cfg.n_layers - n_super * len(pat)])
    return n_super, tail


def init_params(key: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random init from an integer key: ``super`` holds the super-blocks'
    leaves stacked on a leading dim, ``tail`` a list of the remaining
    layers (empty when the pattern divides ``n_layers``)."""
    dev = resolve_device(device)
    pat = cfg.block_pattern
    n_super, tail = _split_pattern(cfg)
    ke, ks, kt = rng.split(key, 3)

    def init_super(k: int) -> Params:
        kk = rng.split(k, len(pat))
        return {f"b{i}": _layer_init(kk[i], cfg, kind, dev)
                for i, kind in enumerate(pat)}

    tail_p: List[Params] = [_layer_init(rng.fold_in(kt, i), cfg, kind, dev)
                            for i, kind in enumerate(tail)]
    return {
        "embed": L.embedding_init(ke, cfg.vocab_size, cfg.d_model, cfg.dtype,
                                  dev),
        "super": init_stacked(init_super, [rng.fold_in(ks, i)
                                           for i in range(n_super)]),
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
        "tail": tail_p,
    }


def lm_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
               remat: bool = True) -> Tensor:
    """Full-sequence forward over tokens (..., B, S). Returns logits."""
    pat = cfg.block_pattern
    n_super, tail = _split_pattern(cfg)
    table = params["embed"]["table"]
    # gemma-style embedding scale, cast to the param dtype first (bf16:
    # 50.5, not 50.596)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                         device=table.device)
    x = L.embed(params["embed"], tokens) * scale
    S = x.shape[-2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    def body(x_: Tensor, super_p: Params) -> Tensor:
        for i, kind in enumerate(pat):
            x_ = _layer_fwd(super_p[f"b{i}"], x_, cfg, positions, kind)
        return x_

    x = run_stacked(params, x, body, n_super, remat, key="super")
    for p_l, kind in zip(params["tail"], tail):
        x = _layer_fwd(p_l, x, cfg, positions, kind)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, batch: int, kind: str, dtype,
                 device) -> Dict[str, Tensor]:
    if kind == "rec":
        return {"lru": torch.zeros((batch, cfg.lru_width),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, cfg.conv1d_width - 1,
                                     cfg.lru_width), dtype=dtype,
                                    device=device)}
    acfg = _attn_cfg(cfg)
    shape = (batch, cfg.attn_window, acfg.n_kv_heads, acfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> Dict:
    """The zero cache: ``super`` the super-blocks' layer caches stacked on a
    leading dim, ``tail`` a list of the tail layers'; recurrent state and a
    rotating window, so the size does not depend on the sequence."""
    del max_seq
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    pat = cfg.block_pattern
    n_super, tail = _split_pattern(cfg)
    one = {f"b{i}": _layer_cache(cfg, batch, kind, dtype, dev)
           for i, kind in enumerate(pat)}
    return {"super": tree_map(
                lambda x: x[None].repeat((n_super,) + (1,) * x.dim()), one),
            "tail": [_layer_cache(cfg, batch, kind, dtype, dev)
                     for kind in tail]}


def _layer_decode(p: Params, x: Tensor, cfg: ModelConfig, cache: Dict,
                  kind: str, write_pos: int, abs_pos: int) -> Tensor:
    """One layer's decode; its cache entries are updated in place."""
    if kind == "rec":
        y, lru, conv = rec_block_decode(p["temporal"], x, cfg, cache["lru"],
                                        cache["conv"])
        cache["lru"].copy_(lru)
        cache["conv"].copy_(conv)
    else:
        h = L.rmsnorm(p["temporal"]["ln"], x, cfg.norm_eps)
        a, _, _ = L.attention_decode(p["temporal"]["attn"], h, _attn_cfg(cfg),
                                     cache["k"], cache["v"], write_pos,
                                     abs_pos)
        y = x + a
    return mlp_block_fwd(p["mlp_blk"], y, cfg)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict, token: Tensor,
                pos: int) -> Tuple[Tensor, Dict]:
    """One decode step: the (B, V) logits, and the cache updated in place
    (attention slots at ``pos % attn_window``)."""
    pat = cfg.block_pattern
    n_super, tail = _split_pattern(cfg)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                         device=token.device)
    x = L.embed(params["embed"], token[:, None]) * scale
    write_pos = pos % cfg.attn_window
    for s in range(n_super):
        super_p = layer_params(params, s, key="super")
        super_c = tree_map(lambda leaf: leaf[s], cache["super"])
        for i, kind in enumerate(pat):
            x = _layer_decode(super_p[f"b{i}"], x, cfg, super_c[f"b{i}"],
                              kind, write_pos, pos)
    for p_l, c_l, kind in zip(params["tail"], cache["tail"], tail):
        x = _layer_decode(p_l, x, cfg, c_l, kind, write_pos, pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
