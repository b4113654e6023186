"""Audio enc-dec family: the seamless-m4t-medium backbone.  Counterpart of
``repro/models/encdec.py``, with its parameter keys and layouts.

The modality frontend (mel-spectrogram + conv feature extractor) is a stub:
precomputed frame embeddings (..., B, T_frames, d_model) go straight into
the encoder.  12 bidirectional encoder layers and 12 causal decoder layers
with cross-attention, layernorm, gelu MLPs, each stack on a leading layer
dim (``enc_layers``, ``dec_layers``).

* The encoder's attention is bidirectional: RoPE and an all-true mask, a
  plain einsum (no B11), as in the reference.
* The decoder's self-attention is ``layers.attention_fwd``, so full causal
  attention (S ≥ 16, no window) runs B11; its cross-attention has no RoPE,
  and each checkpointed decoder layer recomputes its cross K/V from the
  encoder memory, as the reference's remat body does.
* Decode (:func:`init_cache`, :func:`decode_step`) writes the self K/V in
  place and reads the cross K/V cache, which :func:`init_cache` leaves at
  zero and :func:`prefill_cross` computes from an encoder memory.

Leaves may carry a leading worker dim W (``models/layers.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (init_stacked, layer_params,
                                            run_stacked)

Tensor = torch.Tensor
Params = Dict


def _enc_layer_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    k1, k2 = rng.split(key)
    return {"ln1": L.layernorm_init(cfg.d_model, cfg.dtype, device),
            "attn": L.attention_init(k1, cfg, device),
            "ln2": L.layernorm_init(cfg.d_model, cfg.dtype, device),
            "mlp": L.mlp_init(k2, cfg, device=device)}


def _dec_layer_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    k1, k2, k3 = rng.split(key, 3)
    return {"ln1": L.layernorm_init(cfg.d_model, cfg.dtype, device),
            "self_attn": L.attention_init(k1, cfg, device),
            "ln_x": L.layernorm_init(cfg.d_model, cfg.dtype, device),
            "cross_attn": L.attention_init(k2, cfg, device),
            "ln2": L.layernorm_init(cfg.d_model, cfg.dtype, device),
            "mlp": L.mlp_init(k3, cfg, device=device)}


def init_params(key: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random init from an integer key: the encoder's and the decoder's
    layers each stacked on a leading dim."""
    dev = resolve_device(device)
    ke, kenc, kdec = rng.split(key, 3)
    return {
        "embed": L.embedding_init(ke, cfg.vocab_size, cfg.d_model, cfg.dtype,
                                  dev),
        "enc_layers": init_stacked(
            lambda k: _enc_layer_init(k, cfg, dev),
            [rng.fold_in(kenc, i) for i in range(cfg.n_enc_layers)]),
        "enc_norm": L.layernorm_init(cfg.d_model, cfg.dtype, dev),
        "dec_layers": init_stacked(
            lambda k: _dec_layer_init(k, cfg, dev),
            [rng.fold_in(kdec, i) for i in range(cfg.n_layers)]),
        "dec_norm": L.layernorm_init(cfg.d_model, cfg.dtype, dev),
    }


# ---------------------------------------------------------------------------
# encoder (bidirectional over the stub frame embeddings)
# ---------------------------------------------------------------------------

def _attend(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig,
            dtype) -> Tensor:
    """Unmasked GQA attention: q (..., S, H, hd) against k, v (..., T, KV,
    hd), scores and softmax in f32.  Returns (..., S, H·hd)."""
    hd = cfg.hd
    S, T = q.shape[-3], k.shape[-3]
    lead = q.shape[:-3]
    n = math.prod(lead)
    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(n, S, cfg.n_kv_heads, g, hd)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    w = L._attn_weights(qg, k.reshape(n, T, cfg.n_kv_heads, hd), mask)
    o = torch.einsum("bkgst,btkh->bskgh", w.to(dtype),
                     v.reshape(n, T, cfg.n_kv_heads, hd))
    return o.reshape(lead + (S, cfg.n_heads * hd))


def _bidir_attention(p: Params, x: Tensor, cfg: ModelConfig,
                     positions: Tensor) -> Tensor:
    hd = cfg.hd
    q = L.rope(L._split_heads(L.dense(p["wq"], x), cfg.n_heads, hd),
               positions, cfg.rope_theta)
    k = L.rope(L._split_heads(L.dense(p["wk"], x), cfg.n_kv_heads, hd),
               positions, cfg.rope_theta)
    v = L._split_heads(L.dense(p["wv"], x), cfg.n_kv_heads, hd)
    return L.dense(p["wo"], _attend(q, k, v, cfg, x.dtype))


def encode(params: Params, cfg: ModelConfig, frames: Tensor,
           remat: bool = True) -> Tensor:
    """frames: (..., B, T_frames, d_model) stub embeddings -> the encoder
    memory (..., B, T_frames, d_model) in the param dtype."""
    x = frames.to(cfg.dtype)
    S = x.shape[-2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    def body(x_: Tensor, p: Params) -> Tensor:
        x_ = x_ + _bidir_attention(
            p["attn"], L.layernorm(p["ln1"], x_, cfg.norm_eps), cfg,
            positions)
        return x_ + L.mlp(p["mlp"], L.layernorm(p["ln2"], x_, cfg.norm_eps),
                          cfg)

    x = run_stacked(params, x, body, cfg.n_enc_layers, remat,
                    key="enc_layers")
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _cross_attention(p: Params, x: Tensor, cfg: ModelConfig, mem_k: Tensor,
                     mem_v: Tensor) -> Tensor:
    """x: (..., S, d); mem_[kv]: (..., T, KV, hd) from the encoder memory
    (no RoPE)."""
    q = L._split_heads(L.dense(p["wq"], x), cfg.n_heads, cfg.hd)
    return L.dense(p["wo"], _attend(q, mem_k, mem_v, cfg, x.dtype))


def _cross_kv(p: Params, cfg: ModelConfig, memory: Tensor
              ) -> Tuple[Tensor, Tensor]:
    k = L._split_heads(L.dense(p["wk"], memory), cfg.n_kv_heads, cfg.hd)
    v = L._split_heads(L.dense(p["wv"], memory), cfg.n_kv_heads, cfg.hd)
    return k, v


def decode_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
                   memory: Tensor, remat: bool = True) -> Tensor:
    """Teacher-forced decoder pass (training). tokens: (..., B, S); memory:
    the encoder's (..., B, T, d). Returns logits."""
    x = L.embed(params["embed"], tokens)
    S = x.shape[-2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    def body(x_: Tensor, p: Params) -> Tensor:
        h = L.layernorm(p["ln1"], x_, cfg.norm_eps)
        a, _ = L.attention_fwd(p["self_attn"], h, cfg, positions,
                               cfg.sliding_window)
        x_ = x_ + a
        mk, mv = _cross_kv(p["cross_attn"], cfg, memory)
        x_ = x_ + _cross_attention(
            p["cross_attn"], L.layernorm(p["ln_x"], x_, cfg.norm_eps), cfg,
            mk, mv)
        return x_ + L.mlp(p["mlp"], L.layernorm(p["ln2"], x_, cfg.norm_eps),
                          cfg)

    x = run_stacked(params, x, body, cfg.n_layers, remat, key="dec_layers")
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)


def lm_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
               frames: Tensor, remat: bool = True) -> Tensor:
    memory = encode(params, cfg, frames, remat=remat)
    return decode_forward(params, cfg, tokens, memory, remat=remat)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               n_frames: Optional[int] = None, dtype=None,
               device="cuda") -> Dict[str, Tensor]:
    """Zero caches (n_layers, B, ·, KV, hd): the self K/V over T = max_seq
    (min(max_seq, window) under a sliding window) and the cross K/V over
    ``n_frames`` (the config's ``frontend_tokens`` by default), which stay
    zero until :func:`prefill_cross` fills them."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    T = (max_seq if cfg.sliding_window is None
         else min(max_seq, cfg.sliding_window))
    n_frames = n_frames or cfg.frontend_tokens

    def zeros(t: int) -> Tensor:
        return torch.zeros((cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.hd),
                           dtype=dtype, device=dev)

    return {"self_k": zeros(T), "self_v": zeros(T),
            "cross_k": zeros(n_frames), "cross_v": zeros(n_frames)}


def prefill_cross(params: Params, cfg: ModelConfig, memory: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """Every decoder layer's cross K and V of ``memory`` (B, T, d), stacked
    on a leading layer dim: (n_layers, B, T, KV, hd) each."""
    ks, vs = zip(*(_cross_kv(layer_params(params, i, "dec_layers")
                             ["cross_attn"], cfg, memory)
                   for i in range(cfg.n_layers)))
    return torch.stack(ks), torch.stack(vs)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict, token: Tensor,
                pos: int) -> Tuple[Tensor, Dict]:
    """One greedy decode step: the (B, V) logits, and the cache with the
    self K/V written in place at slot ``pos`` (``pos % window`` under a
    sliding window); the cross K/V are read as they are."""
    x = L.embed(params["embed"], token[:, None])
    T = cache["self_k"].shape[2]
    write_pos = pos % T if cfg.sliding_window is not None else pos
    for i in range(cfg.n_layers):
        p = layer_params(params, i, "dec_layers")
        h = L.layernorm(p["ln1"], x, cfg.norm_eps)
        a, _, _ = L.attention_decode(p["self_attn"], h, cfg,
                                     cache["self_k"][i], cache["self_v"][i],
                                     write_pos, pos)
        x = x + a
        x = x + _cross_attention(p["cross_attn"],
                                 L.layernorm(p["ln_x"], x, cfg.norm_eps),
                                 cfg, cache["cross_k"][i],
                                 cache["cross_v"][i])
        x = x + L.mlp(p["mlp"], L.layernorm(p["ln2"], x, cfg.norm_eps), cfg)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
