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

On a mesh whose ``model`` axis splits the heads (``models/partition``)
every attention runs the rank's H/m query heads and the KV heads they
read (its ``wk``/``wv`` columns, or the KV heads of ``wk``/``wv`` read
whole through ``copy_to`` where the KV heads do not split), ``wo``'s rows
summed; the MLPs their ff columns, and the embedding and the logits their
vocab rows where ``vocab`` binds.  Every decoder layer projects the one
encoder memory through its own K/V columns, so the decoder reads the
memory through ``copy_to`` once: its backward sums the ranks' partial
gradients, which the encoder then takes whole on every rank.  Decode
holds the rank's block of both caches (``Partition.cache`` for the self
cache, ``Partition.cross_cache`` for the cross cache): on the KV heads,
or, where they do not split, the self cache on its slots and the cross
cache on its frames (the ranks' partial softmaxes joined,
``Partition.combine_attention``) or whole.

Leaves may carry a leading worker dim W (``models/layers.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_layer, init_stacked,
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

def _heads_part():
    """The active partition where it splits the heads, else None (the
    attention runs whole)."""
    part = partition.current()
    return part if part is not None and part.heads else None


def _attend(q: Tensor, k: Tensor, v: Tensor, dtype) -> Tensor:
    """Unmasked GQA attention: q (..., S, H, hd) against k, v (..., T, KV,
    hd) (H and KV the rank's where the heads split), scores and softmax in
    f32.  Returns (..., S, H·hd)."""
    S, H, hd = q.shape[-3:]
    T, KV = k.shape[-3], k.shape[-2]
    lead = q.shape[:-3]
    n = math.prod(lead)
    qg = q.reshape(n, S, KV, H // KV, hd)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    w = L._attn_weights(qg, k.reshape(n, T, KV, hd), mask)
    o = torch.einsum("bkgst,btkh->bskgh", w.to(dtype), v.reshape(n, T, KV,
                                                                 hd))
    return o.reshape(lead + (S, H * hd))


def _out(p: Params, o: Tensor, cfg: ModelConfig, part) -> Tensor:
    """``wo`` on the attention's output: its rows summed over the ranks
    where the heads split."""
    if part is not None:
        return part.dense_rows(p["wo"], o, cfg.n_heads * cfg.hd, "wo")
    return L.dense(p["wo"], o)


def _bidir_attention(p: Params, x: Tensor, cfg: ModelConfig,
                     positions: Tensor) -> Tensor:
    hd = cfg.hd
    part = _heads_part()
    if part is not None:
        q, k, v, _, _ = L._qkv_partitioned(p, x, cfg, part)
    else:
        q = L._split_heads(L.dense(p["wq"], x), cfg.n_heads, hd)
        k = L._split_heads(L.dense(p["wk"], x), cfg.n_kv_heads, hd)
        v = L._split_heads(L.dense(p["wv"], x), cfg.n_kv_heads, hd)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return _out(p, _attend(q, k, v, x.dtype), cfg, part)


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
    (no RoPE): the rank's KV heads where the heads split, as
    :func:`_cross_kv` gives them."""
    hd = cfg.hd
    part = _heads_part()
    if part is not None:
        x = part.copy_to(x)
        q = L._split_heads(part.dense_cols(p["wq"], x, cfg.n_heads * hd,
                                           "wq"), cfg.n_heads // part.n, hd)
    else:
        q = L._split_heads(L.dense(p["wq"], x), cfg.n_heads, hd)
    return _out(p, _attend(q, mem_k, mem_v, x.dtype), cfg, part)


def _cross_kv(p: Params, cfg: ModelConfig, memory: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """The cross K and V of ``memory`` (..., T, d): every KV head, or,
    where the heads split, those the rank's query heads read (the memory
    read through ``copy_to`` by the caller)."""
    part = _heads_part()
    if part is not None:
        k, v, _ = L._kv_partitioned(p, memory, cfg, part)
        return k, v
    k = L._split_heads(L.dense(p["wk"], memory), cfg.n_kv_heads, cfg.hd)
    v = L._split_heads(L.dense(p["wv"], memory), cfg.n_kv_heads, cfg.hd)
    return k, v


def decode_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
                   memory: Tensor, remat: bool = True) -> Tensor:
    """Teacher-forced decoder pass (training). tokens: (..., B, S); memory:
    the encoder's (..., B, T, d). Returns logits (the rank's vocab
    columns where the plan splits the vocab)."""
    x = L.embed(params["embed"], tokens, cfg.vocab_size)
    part = _heads_part()
    if part is not None:
        memory = part.copy_to(memory)
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


def _cross_cache_kv(p: Params, cfg: ModelConfig, memory: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """A decoder layer's cross K and V as the cache holds them: the
    rank's KV heads where the cache lies on them, else every KV head (the
    projections of the rank's ``wk``/``wv`` columns gathered under
    serving's ``kv_cols``)."""
    part = partition.current()
    if part is not None and part.cross_cache == "heads":
        return _cross_kv(p, cfg, memory)
    k, v = L.dense(p["wk"], memory), L.dense(p["wv"], memory)
    if part is not None and part.kv_cols:
        k, v = part.gather_cols(k, v, op="gather_kv")
    return (L._split_heads(k, cfg.n_kv_heads, cfg.hd),
            L._split_heads(v, cfg.n_kv_heads, cfg.hd))


def prefill_cross(params: Params, cfg: ModelConfig, memory: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """Every decoder layer's cross K and V of ``memory`` (B, T, d), stacked
    on a leading layer dim: (n_layers, B, T, KV, hd) each.  Under serving's
    plan, the rank's block of them as the cache lies: its KV heads, or its
    slice of the frames (every KV head), or all of them.  The frames are
    cut after the projections: under ``kv_cols`` the ranks' column blocks
    of every frame are gathered first."""
    part = partition.current()
    ks, vs = zip(*(_cross_cache_kv(decode_layer(params, i, "dec_layers")
                                   ["cross_attn"], cfg, memory)
                   for i in range(cfg.n_layers)))
    ks, vs = torch.stack(ks), torch.stack(vs)
    if part is not None and part.cross_cache == "seq":
        cp = part.cross
        t = ks.shape[-3] // cp.seq_n
        ks = ks.narrow(-3, cp.seq_index * t, t).contiguous()
        vs = vs.narrow(-3, cp.seq_index * t, t).contiguous()
    return ks, vs


def _cross_decode_seq(p: Params, x: Tensor, cfg: ModelConfig, ck: Tensor,
                      cv: Tensor, part) -> Tensor:
    """One token's cross-attention against the cross cache split on its
    frames (``part.cross``): every query head (the rank's gathered where
    the heads split) scored on the rank's frames, every KV head, the
    partial softmaxes joined over the frames' axes, and the rank's heads
    of the result kept for ``wo``'s rows."""
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    B = x.shape[0]
    if part.heads:
        q = part.dense_cols(p["wq"], part.copy_to(x), H * hd, "wq")
        q = part.gather_heads(q.reshape(B, 1, -1))
    else:
        q = L.dense(p["wq"], x)
    qg = q.reshape(B, 1, KV, H // KV, hd)
    valid = torch.ones(ck.shape[1], dtype=torch.bool, device=x.device)
    o = part.cross.combine_attention(*L._decode_partial(qg, ck, cv, valid))
    o = o.reshape(B, 1, H, hd).to(x.dtype)
    if part.heads:
        Hl = H // part.n
        o = o[:, :, part.index * Hl:(part.index + 1) * Hl]
        return _out(p, o.reshape(B, 1, Hl * hd), cfg, part)
    return _out(p, o.reshape(B, 1, H * hd), cfg, None)


def _cross_decode(p: Params, x: Tensor, cfg: ModelConfig, ck: Tensor,
                  cv: Tensor) -> Tensor:
    """One token's cross-attention against a layer's cross cache block
    (B, T, ·, hd): on the rank's KV heads (``"heads"``), its frames
    (``"seq"``), or the whole cache (``"batch"``, the rank's query heads
    reading the KV heads they read)."""
    from repro_torch.models.partition import rank_kv_heads

    part = partition.current()
    layout = "batch" if part is None else part.cross_cache
    if layout == "seq":
        return _cross_decode_seq(p, x, cfg, ck, cv, part)
    if layout == "batch" and part is not None and part.heads:
        k0, k1, rel = rank_kv_heads(cfg, part)
        ck, cv = ck[:, :, k0:k1], cv[:, :, k0:k1]
        if rel is not None:
            idx = torch.tensor(rel, device=x.device)
            ck, cv = ck.index_select(2, idx), cv.index_select(2, idx)
    return _cross_attention(p, x, cfg, ck, cv)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict, token: Tensor,
                pos: int) -> Tuple[Tensor, Dict]:
    """One greedy decode step: the (B, V) logits, and the cache with the
    self K/V written in place at slot ``pos`` (``pos % window`` under a
    sliding window); the cross K/V are read as they are.  Under serving's
    partition the cache is the rank's block, the slot the global one
    (``layers.attention_decode`` hands it to the rank whose slice holds
    it), and the logits the rank's vocab columns (B, V/n)."""
    part = partition.current()
    x = L.embed(params["embed"], token[:, None], cfg.vocab_size)
    T = cache["self_k"].shape[2]
    if part is not None and part.cache == "seq":
        T *= part.seq_n
    write_pos = pos % T if cfg.sliding_window is not None else pos
    for i in range(cfg.n_layers):
        p = decode_layer(params, i, "dec_layers")
        h = L.layernorm(p["ln1"], x, cfg.norm_eps)
        a, _, _ = L.attention_decode(p["self_attn"], h, cfg,
                                     cache["self_k"][i], cache["self_v"][i],
                                     write_pos, pos)
        x = x + a
        x = x + _cross_decode(p["cross_attn"],
                              L.layernorm(p["ln_x"], x, cfg.norm_eps), cfg,
                              cache["cross_k"][i], cache["cross_v"][i])
        x = x + L.mlp(p["mlp"], L.layernorm(p["ln2"], x, cfg.norm_eps), cfg)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
