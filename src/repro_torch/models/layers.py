"""Shared transformer building blocks: norms, RoPE, GQA attention, MLPs.
Counterpart of ``repro/models/layers.py``, with its names, parameter keys
and layouts.

Conventions:
* params are nested dicts of tensors; init functions mirror forward
  functions 1:1;
* activations flow in the config dtype (bf16), softmax/norm statistics in
  f32;
* every leaf may carry leading dims in front of its own shape (the LLM
  trainer's worker axis W), and the activations then carry the same leading
  dims: a dense weight (W, i, o) applies to x (W, ..., i) as
  ``einsum("w...i,wio->w...o")``, and attention folds W into its batch.
  The JAX package gets the same by ``vmap`` over workers;
* full causal attention (S ≥ 16, no window) runs B11, the flash-attention
  kernels (``kernels/flash_attention.py``); a sliding window, or S < 16,
  takes the masked-einsum fallback in plain torch, or under ``optflags``
  ``chunked_attn`` (and S > ``ATTN_CHUNK``) its query-chunked variant,
  whose score tensor is (chunk, S), not (S, S).  The single-token decode
  (:func:`attention_decode`) is plain torch against a KV cache it writes
  in place, as the reference computes it outside any kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import optflags, rng
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]

NEG_INF = -1e30


def _bcast(t: Tensor, x: Tensor, n_elem: int) -> Tensor:
    """View of a parameter ``t`` (lead + its n_elem-dim shape) that
    broadcasts against ``x`` (lead + batch dims + the same trailing dims)."""
    lead = t.dim() - n_elem
    if lead == 0:
        return t
    extra = x.dim() - t.dim()
    return t.reshape(t.shape[:lead] + (1,) * extra + t.shape[lead:])


def _lead(w: Tensor, n_elem: int) -> int:
    lead = w.dim() - n_elem
    if lead not in (0, 1):
        raise ValueError(f"parameter of shape {tuple(w.shape)}: at most one "
                         f"leading (worker) dim is supported")
    return lead


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device="cuda") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype,
                                device=resolve_device(device))}


def rmsnorm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * _bcast(p["scale"], x, 1).float()).to(x.dtype)


def layernorm_init(d: int, dtype, device="cuda") -> Params:
    dev = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=dev),
            "bias": torch.zeros((d,), dtype=dtype, device=dev)}


def layernorm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * _bcast(p["scale"], x, 1).float()
            + _bcast(p["bias"], x, 1).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding, split-halves convention. x: (..., S, H, hd);
    positions: (..., S), broadcasting against x's leading dims."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def dense_init(key: int, d_in: int, d_out: int, dtype, bias: bool = False,
               scale: Optional[float] = None, device="cuda") -> Params:
    s = scale if scale is not None else d_in ** -0.5
    g = rng.generator(key, resolve_device(device))
    w = torch.randn((d_in, d_out), generator=g, device=g.device) * s
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=g.device)
    return p


def dense(p: Params, x: Tensor) -> Tensor:
    w = p["w"]
    if _lead(w, 2):
        y = torch.einsum("w...i,wio->w...o", x, w)
    else:
        y = torch.einsum("...i,io->...o", x, w)
    if "b" in p:
        y = y + _bcast(p["b"], y, 1)
    return y


def embedding_init(key: int, vocab: int, d: int, dtype,
                   device="cuda") -> Params:
    g = rng.generator(key, resolve_device(device))
    t = torch.randn((vocab, d), generator=g, device=g.device) * d ** -0.5
    return {"table": t.to(dtype)}


def _lookup(table: Tensor, ids: Tensor) -> Tensor:
    if _lead(table, 2):
        w = torch.arange(table.shape[0], device=ids.device)
        return table[w.reshape((-1,) + (1,) * (ids.dim() - 1)), ids]
    return table[ids]


def embed(p: Params, ids: Tensor, vocab: Optional[int] = None) -> Tensor:
    """The rows of ``ids``.  Under a partition of the vocab
    (``models/partition``; ``vocab`` the whole count), each rank looks up
    the ids of its rows, writes zeros for the others, and the ranks' rows
    are summed: one nonzero addend a row, so the sum is exact."""
    from repro_torch.models import partition

    table = p["table"]
    part = partition.current()
    if part is None or not part.vocab:
        return _lookup(table, ids)
    v0, vl = part.vocab_rows(table, vocab)
    local = ids.long() - v0
    mine = (local >= 0) & (local < vl)
    rows = _lookup(table, torch.where(mine, local, 0))
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return part.reduce_from(rows)


def unembed(p: Params, x: Tensor) -> Tensor:
    """The logits; under a partition of the vocab, this rank's vocab
    columns of them (``x`` read through ``copy_to``)."""
    from repro_torch.models import partition

    table = p["table"]
    part = partition.current()
    if part is not None and part.vocab:
        x = part.copy_to(x)
    if _lead(table, 2):
        return torch.einsum("w...d,wvd->w...v", x, table)
    return torch.einsum("...d,vd->...v", x, table)


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window, KV cache decode)
# ---------------------------------------------------------------------------

def attention_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    hd = cfg.hd
    kq, kk, kv, ko = rng.split(key, 4)
    return {
        "wq": dense_init(kq, cfg.d_model, cfg.n_heads * hd, cfg.dtype,
                         bias=cfg.qkv_bias, device=device),
        "wk": dense_init(kk, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype,
                         bias=cfg.qkv_bias, device=device),
        "wv": dense_init(kv, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype,
                         bias=cfg.qkv_bias, device=device),
        "wo": dense_init(ko, cfg.n_heads * hd, cfg.d_model, cfg.dtype,
                         device=device),
    }


def _split_heads(x: Tensor, n: int, hd: int) -> Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _attn_weights(q: Tensor, k: Tensor, mask: Tensor) -> Tensor:
    """q: (B,S,KV,G,hd)  k: (B,T,KV,hd)  mask: (S,T) or (B,S,T) ->
    (B,KV,G,S,T), scores and softmax in f32."""
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())
    scores = scores * (q.shape[-1] ** -0.5)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    return torch.softmax(scores, dim=-1)


def causal_mask(s: int, window: Optional[int], device=None) -> Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m


def _attention_chunked(qg: Tensor, k: Tensor, v: Tensor,
                       window: Optional[int], chunk: int) -> Tensor:
    """Query-chunked causal attention: the peak score tensor is (chunk, S),
    not (S, S).  Exact softmax (a full row per query chunk), over query
    blocks in order.  qg: (B,S,KV,G,hd)  k, v: (B,S,KV,hd) -> (B,S,KV,G,hd);
    S is padded to a multiple of the chunk and the padded rows sliced
    off."""
    S = qg.shape[1]
    C = min(chunk, S)
    n = -(-S // C)
    if n * C != S:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, n * C - S))
    t = torch.arange(S, device=qg.device)
    outs = []
    for ci in range(n):
        i = ci * C + torch.arange(C, device=qg.device)[:, None]  # query rows
        m = t[None, :] <= i
        if window is not None:
            m = m & (t[None, :] > i - window)
        w = _attn_weights(qg[:, ci * C:(ci + 1) * C], k, m)
        outs.append(torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v))
    return torch.cat(outs, 1)[:, :S]


def _kv_partitioned(p: Params, x: Tensor, cfg: ModelConfig, part
                    ) -> Tuple[Tensor, Tensor, int]:
    """The k and v (…, S, n_kv, hd) this rank's query heads ``[r·H/m,
    (r+1)·H/m)`` read under a partition of the heads, from ``x`` already
    read through ``copy_to``, and n_kv.  Where the KV heads split too, they
    are the rank's ``wk``/``wv`` columns; else ``wk``/``wv`` are whole on
    the rank and it projects the contiguous KV heads its query heads read
    (under serving's :attr:`~repro_torch.models.partition.Partition.kv_cols`
    it projects its ``wk``/``wv`` columns, gathers the projections and
    takes those heads), repeated to one a query head where the group does
    not fit them evenly."""
    from repro_torch.models.partition import rank_kv_heads

    hd, KV = cfg.hd, cfg.n_kv_heads
    if part.kv:
        KVl = KV // part.n
        k = _split_heads(part.dense_cols(p["wk"], x, KV * hd, "wk"), KVl, hd)
        v = _split_heads(part.dense_cols(p["wv"], x, KV * hd, "wv"), KVl, hd)
        return k, v, KVl
    k0, k1, rel = rank_kv_heads(cfg, part)
    KVl = k1 - k0
    if part.kv_cols:
        # serving: the rank's wk/wv columns, the projections gathered
        k, v = part.gather_cols(dense(p["wk"], x), dense(p["wv"], x),
                                op="gather_kv")
        k = k.narrow(-1, k0 * hd, KVl * hd)
        v = v.narrow(-1, k0 * hd, KVl * hd)
    else:
        k = part.dense_slice(p["wk"], x, k0 * hd, k1 * hd)
        v = part.dense_slice(p["wv"], x, k0 * hd, k1 * hd)
    k, v = _split_heads(k, KVl, hd), _split_heads(v, KVl, hd)
    if rel is None:
        return k, v, KVl
    idx = torch.tensor(rel, device=x.device)
    return k.index_select(-2, idx), v.index_select(-2, idx), len(rel)


def _qkv_partitioned(p: Params, x: Tensor, cfg: ModelConfig, part
                     ) -> Tuple[Tensor, Tensor, Tensor, int, int]:
    """This rank's q, k, v under a partition of the heads: its ``H/m``
    query heads on its ``wq`` columns and the KV heads they read
    (:func:`_kv_partitioned`), with the local (query heads, KV heads)."""
    hd, H = cfg.hd, cfg.n_heads
    Hl = H // part.n
    x = part.copy_to(x)
    q = _split_heads(part.dense_cols(p["wq"], x, H * hd, "wq"), Hl, hd)
    k, v, n_kv = _kv_partitioned(p, x, cfg, part)
    return q, k, v, Hl, n_kv


def attention_fwd(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor,
                  window: Optional[int]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence causal attention over x (..., S, d). Returns (out, kv)
    — kv for prefill.  The reference's dispatch: B11 wherever there is no
    window and S ≥ 16, else the chunked path under ``chunked_attn`` when
    S > ``ATTN_CHUNK``, else the masked einsum.  Under a partition of the
    heads (``models/partition``) each branch runs on this rank's heads and
    ``wo``'s row-split partial outputs are summed over the ranks."""
    from repro_torch.models import partition

    hd = cfg.hd
    S = x.shape[-2]
    lead = x.shape[:-2]
    n = math.prod(lead)
    part = partition.current()
    if part is not None and not part.heads:
        part = None             # the heads do not split: attention whole
    if part is not None:
        q, k, v, n_heads, n_kv = _qkv_partitioned(p, x, cfg, part)
    else:
        n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
        q = _split_heads(dense(p["wq"], x), n_heads, hd)
        k = _split_heads(dense(p["wk"], x), n_kv, hd)
        v = _split_heads(dense(p["wv"], x), n_kv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    g = n_heads // n_kv
    qg = q.reshape(n, S, n_kv, g, hd)
    kn = k.reshape(n, S, n_kv, hd)
    vn = v.reshape(n, S, n_kv, hd)
    if window is None and S >= 16:
        # B11 (kernels/flash_attention), differentiable through its
        # autograd.Function.  GQA stays here: KV repeated over the group
        # (head = kv·g + i) by an expand, whose backward sums the k/v
        # cotangents back over the group in a fixed order (on the card,
        # repeat_interleave's backward adds them with float atomics, whose
        # order is not)
        qf = qg.permute(0, 2, 3, 1, 4).reshape(n, n_heads, S, hd)

        def group(t: Tensor) -> Tensor:
            t = t.permute(0, 2, 1, 3)[:, :, None]
            return t.expand(n, n_kv, g, S, hd).reshape(
                n, n_heads, S, hd).contiguous()

        of = flash_attention(qf.contiguous(), group(kn), group(vn),
                             causal=True)
        o = of.reshape(n, n_kv, g, S, hd).permute(0, 3, 1, 2, 4)
    elif optflags.enabled("chunked_attn") and S > optflags.ATTN_CHUNK:
        o = _attention_chunked(qg, kn, vn, window, optflags.ATTN_CHUNK)
    else:
        w = _attn_weights(qg, kn, causal_mask(S, window, x.device))
        o = torch.einsum("bkgst,btkh->bskgh", w.to(x.dtype), vn)
    o = o.reshape(lead + (S, n_heads * hd))
    if part is not None:
        return (part.dense_rows(p["wo"], o, cfg.n_heads * hd, "wo"),
                {"k": k, "v": v})
    return dense(p["wo"], o), {"k": k, "v": v}


def _decode_partial(qg: Tensor, k: Tensor, v: Tensor, valid: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """One rank's part of the softmax over its slots: qg (B,1,KV,g,hd), k,
    v (B,T,KV,hd), valid (T,) -> the max score m and the sum l of
    ``exp(s − m)`` (B,1,KV,g,1), and ``Σ exp(s − m)·v`` (B,1,KV,g,hd), all
    f32; a row whose slots are all masked has m = −inf and l, o = 0."""
    s = torch.einsum("bskgh,btkh->bskgt", qg.float(), k.float())
    s = s * (qg.shape[-1] ** -0.5)
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    live = torch.isfinite(m)
    e = torch.where(valid, torch.exp(s - torch.where(live, m, 0.0)), 0.0)
    o = torch.einsum("bskgt,btkh->bskgh", e, v.float())
    return m, e.sum(dim=-1, keepdim=True), o


def attention_decode(p: Params, x: Tensor, cfg: ModelConfig, cache_k: Tensor,
                     cache_v: Tensor, write_pos: int,
                     abs_pos: int) -> Tuple[Tensor, Tensor, Tensor]:
    """One-token decode. x: (B, 1, d); cache_[kv]: (B, T, KV, hd).

    The token's k and v are written into the caches at slot ``write_pos``,
    in place (``abs_pos`` for a full cache, ``abs_pos % window`` for a
    rotating sliding-window buffer); ``abs_pos`` is the absolute position
    (RoPE, and the validity mask: slot t is attended iff t ≤ abs_pos, so a
    warm rotating buffer attends every slot, which is exactly the window).
    The scores and the softmax run in f32, GQA grouped as
    :func:`_attn_weights` groups it.  Returns (out, cache_k, cache_v).

    Under serving's partition (``models/partition``) the caches are this
    rank's block (``part.cache``) and the products its part: its query
    heads on its ``wq`` columns where the heads split (``wo``'s rows summed
    over the ranks after), else every head; then by the cache's layout

    * ``"heads"``: its KV heads on its ``wk``/``wv`` columns, written into
      its (B, T, KV/n, hd) block and attended as one device attends them;
    * ``"seq"``: every KV head (``wk``/``wv`` whole, or, under
      ``part.kv_cols``, the rank's columns projected and the projections
      gathered over ``model``), the slot written by
      the rank whose slice holds it (``write_pos // T_local``), the query
      heads gathered over ``model``, every head scored on the rank's slots
      (slot t valid where ``r·T_local + t ≤ abs_pos``), the partial
      softmaxes joined over the sequence's axes, and the rank's heads of
      the result kept for ``wo``'s rows;
    * ``"batch"`` (one device's layout too): every KV head written into
      the whole cache, the rank's query heads attending the KV heads they
      read.
    """
    from repro_torch.models import partition
    from repro_torch.models.partition import rank_kv_heads

    part = partition.current()
    if part is not None and not (part.heads or part.cache == "seq"):
        part = None             # nothing splits: one device's decode
    heads = part is not None and part.heads
    layout = "batch" if part is None else part.cache
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    B = x.shape[0]
    T = cache_k.shape[1]
    posv = torch.full((B, 1), abs_pos, dtype=torch.int32, device=x.device)
    if part is not None:
        x = part.copy_to(x)
    if heads:
        n_heads = H // part.n
        q = part.dense_cols(p["wq"], x, H * hd, "wq")
    else:
        n_heads = H
        q = dense(p["wq"], x)
    q = rope(_split_heads(q, n_heads, hd), posv, cfg.rope_theta)
    if layout == "heads":
        n_kv = KV // part.n
        k = part.dense_cols(p["wk"], x, KV * hd, "wk")
        v = part.dense_cols(p["wv"], x, KV * hd, "wv")
    else:
        n_kv = KV
        k, v = dense(p["wk"], x), dense(p["wv"], x)
        if part is not None and part.kv_cols:
            k, v = part.gather_cols(k, v, op="gather_kv")
    k = rope(_split_heads(k, n_kv, hd), posv, cfg.rope_theta)
    v = _split_heads(v, n_kv, hd)
    slot = write_pos
    if layout == "seq":
        owner, slot = divmod(write_pos, T)
        slot = slot if owner == part.seq_index else None
    if slot is not None:
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    if layout == "seq":
        if heads:
            q = _split_heads(part.gather_heads(q.reshape(B, 1, -1)), H, hd)
        t = part.seq_index * T + torch.arange(T, device=x.device)
        qg = q.reshape(B, 1, KV, H // KV, hd)
        o = part.combine_attention(*_decode_partial(qg, cache_k, cache_v,
                                                    t <= abs_pos))
        o = o.reshape(B, 1, H, hd).to(x.dtype)
        if heads:
            o = o[:, :, part.index * n_heads:(part.index + 1) * n_heads]
    else:
        kk, vv = cache_k, cache_v
        if layout == "batch" and heads:
            k0, k1, rel = rank_kv_heads(cfg, part)
            kk, vv = kk[:, :, k0:k1], vv[:, :, k0:k1]
            n_kv = k1 - k0
            if rel is not None:
                idx = torch.tensor(rel, device=x.device)
                kk, vv = kk.index_select(2, idx), vv.index_select(2, idx)
                n_kv = n_heads
        m = torch.arange(T, device=x.device) <= abs_pos
        qg = q.reshape(B, 1, n_kv, n_heads // n_kv, hd)
        w = _attn_weights(qg, kk, m[None, :])
        o = torch.einsum("bkgst,btkh->bskgh", w.to(x.dtype), vv)
    o = o.reshape(B, 1, n_heads * hd)
    if heads:
        return part.dense_rows(p["wo"], o, H * hd, "wo"), cache_k, cache_v
    return dense(p["wo"], o), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_init(key: int, cfg: ModelConfig, d_ff: Optional[int] = None,
             device="cuda") -> Params:
    """mlp_act: "silu" (swiglu) | "geglu" | "gelu_mlp" (plain 2-matrix)."""
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp_act in ("silu", "geglu"):  # gated: gate/up/down
        kg, ku, kd = rng.split(key, 3)
        return {
            "gate": dense_init(kg, cfg.d_model, d_ff, cfg.dtype,
                               device=device),
            "up": dense_init(ku, cfg.d_model, d_ff, cfg.dtype, device=device),
            "down": dense_init(kd, d_ff, cfg.d_model, cfg.dtype,
                               device=device),
        }
    ki, ko = rng.split(key)
    return {
        "fc_in": dense_init(ki, cfg.d_model, d_ff, cfg.dtype, bias=True,
                            device=device),
        "fc_out": dense_init(ko, d_ff, cfg.d_model, cfg.dtype, bias=True,
                             device=device),
    }


def mlp(p: Params, x: Tensor, cfg: ModelConfig, d_ff: Optional[int] = None,
        split: str = "ff") -> Tensor:
    """The MLP of hidden width ``d_ff`` (``cfg.d_ff``; the MoE's shared
    expert passes its own); under a partition whose field ``split`` is set
    (``models/partition``: ``ff``, or ``shared_ff`` for the shared
    expert), this rank's hidden columns, ``down``/``fc_out``'s partial
    outputs summed over the ranks and ``fc_out``'s bias added once after
    the sum."""
    from repro_torch.models import partition

    part = partition.current()
    if part is not None and getattr(part, split):
        ff = d_ff or cfg.d_ff
        x = part.copy_to(x)
        if "gate" in p:
            act = F.silu if cfg.mlp_act == "silu" else _gelu
            h = (act(part.dense_cols(p["gate"], x, ff, "gate"))
                 * part.dense_cols(p["up"], x, ff, "up"))
            return part.dense_rows(p["down"], h, ff, "down")
        h = _gelu(part.dense_cols(p["fc_in"], x, ff, "fc_in"))
        return part.dense_rows(p["fc_out"], h, ff, "fc_out")
    if "gate" in p:
        act = F.silu if cfg.mlp_act == "silu" else _gelu
        h = act(dense(p["gate"], x)) * dense(p["up"], x)
        return dense(p["down"], h)
    h = _gelu(dense(p["fc_in"], x))
    return dense(p["fc_out"], h)
