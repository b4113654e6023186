"""Mixture-of-Experts family: qwen3-moe (GQA + 128 experts, top 8) and
deepseek-v3 (MLA + 1 shared + 256 routed experts, top 8, and MTP).
Counterpart of ``repro/models/moe.py``, with its parameter keys, shapes and
dispatch.

* **Dispatch** is sort-based: the (token, k) pairs are sorted by expert
  (a stable sort, as ``jnp.argsort``'s), ranked within their expert, and
  scattered into an (E, C, d) capacity buffer; the pairs ranked past the
  capacity C land in an overflow slot that is sliced off (dropped).  The
  experts' products are batched matrix products over E.  The combine
  gathers each kept pair's expert output, weighs it by its gate, puts the
  pairs back in (token, k) order and sums each token's K contributions in
  ascending expert id, the order in which the reference's segment sum
  meets them.  Every gather and scatter moves rows by indices that are
  distinct where it matters (:class:`_Take`, :class:`_Put`), so neither
  direction accumulates with float atomics, and a round's bits do not
  change from one run to the next.
* Leaves may carry a leading worker dim W (``models/layers.py``): the
  router, the sort and the capacity are then per worker (the reference
  vmaps the loss over workers), so a worker's N is its own B·S.
* ``optflags`` ``grouped_moe`` runs the dispatch in G token groups (G the
  largest divisor of N up to 16), each with its own capacity.
* **MLA** (deepseek-v3) is plain einsums, as in the reference: the scores
  are f32 products of the param-dtype operands, in the compressed c_kv
  space (q_nope projected through W_UK); decode keeps the compressed
  (c_kv, k_rope) cache, written in place.  qwen3-moe's attention is
  ``layers.attention_fwd``, so full causal attention runs B11.
* **MTP**: one extra block and the shared unembedding predict token t+2
  from the last hidden state and the next token's embedding.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import optflags, rng
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (init_stacked, layer_params,
                                            run_stacked)
from repro_torch.tree import tree_leaves

Tensor = torch.Tensor
Params = Dict

CAPACITY_FACTOR = 1.25

#: set by :func:`record_routing`: each dispatch appends what it picked
_ROUTING: Optional[List[Dict[str, Tensor]]] = None


@contextlib.contextmanager
def record_routing():
    """Collect every dispatch run inside the block: a list of dicts with
    ``idx`` (..., N, K), the experts picked, and ``kept`` (..., N·K), which
    pairs the capacity kept (in the dispatch's sorted order), detached.  A
    checkpointed layer dispatches again in the backward pass, and is then
    recorded again."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


def _wview(w: Tensor, n_elem: int, lead: int) -> Tensor:
    """``w`` (its own lead + n_elem dims) viewed to broadcast against
    operands with ``lead`` leading dims: singletons after its own."""
    own = w.dim() - n_elem
    return w.reshape(w.shape[:own] + (1,) * (lead - own) + w.shape[own:])


# ---------------------------------------------------------------------------
# router + sort-based dispatch
# ---------------------------------------------------------------------------

def router_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    g = rng.generator(key, resolve_device(device))
    return {"w": torch.randn((cfg.d_model, cfg.n_experts), generator=g,
                             device=g.device) * cfg.d_model ** -0.5}


def moe_mlp_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    """Routed experts as stacked (E, ...) swiglu weights + router (+ the
    shared expert, an MLP of ``moe_d_ff · n_shared_experts``)."""
    dev = resolve_device(device)
    kr, kg, ku, kd, ks = rng.split(key, 5)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff

    def normal(k: int, shape, scale: float) -> Tensor:
        # an expert at a time, so the f32 draws never exceed one expert's
        g = rng.generator(k, dev)
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for e in range(shape[0]):
            out[e] = torch.randn(shape[1:], generator=g, device=dev) * scale
        return out

    p = {"router": router_init(kr, cfg, dev),
         "gate": normal(kg, (E, d, f), d ** -0.5),
         "up": normal(ku, (E, d, f), d ** -0.5),
         "down": normal(kd, (E, f, d), f ** -0.5)}
    if cfg.n_shared_experts:
        shared_cfg = dataclasses.replace(
            cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
        p["shared"] = L.mlp_init(ks, shared_cfg, device=dev)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.n_experts_active * CAPACITY_FACTOR / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for lane alignment


class _Take(torch.autograd.Function):
    """``x[g, index[g, r]]``: rows of x (G, M, ...) picked by index (G, R).
    Its backward puts each cotangent row back where it came from, without
    accumulating: right wherever the indices whose cotangent is not zero
    are distinct (a permutation; the kept pairs' capacity slots), which is
    what the dispatch asks of it, and free of float atomics."""

    @staticmethod
    def forward(ctx, x: Tensor, index: Tensor) -> Tensor:
        ctx.save_for_backward(index)
        ctx.rows = x.shape[1]
        g = torch.arange(x.shape[0], device=x.device)[:, None]
        return x[g, index]

    @staticmethod
    def backward(ctx, grad: Tensor):
        (index,) = ctx.saved_tensors
        return _Put.apply(grad, index, ctx.rows), None


class _Put(torch.autograd.Function):
    """Zeros (G, rows, ...) with ``out[g, index[g, r]] = x[g, r]``, without
    accumulating (where two rows land on one slot, one of them is kept:
    only overflow slots, which the dispatch discards); its backward is
    :class:`_Take`'s forward."""

    @staticmethod
    def forward(ctx, x: Tensor, index: Tensor, rows: int) -> Tensor:
        ctx.save_for_backward(index)
        out = x.new_zeros((x.shape[0], rows) + tuple(x.shape[2:]))
        g = torch.arange(x.shape[0], device=x.device)[:, None]
        out[g, index] = x
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        (index,) = ctx.saved_tensors
        return _Take.apply(grad, index), None, None


def _dispatch_compute(p: Params, xf: Tensor, gate_vals: Tensor, idx: Tensor,
                      cfg: ModelConfig, C: int) -> Tensor:
    """Sort-based dispatch, the experts' products and the combine, for each
    token group of the leading dims.  xf: (*lead, N, d); gate_vals, idx:
    (*lead, N, K); the experts' leaves (own lead, E, d, f) broadcast
    against ``lead``.  Returns (*lead, N, d).  The sort, ranking and
    scatter run in the profiler range ``moe_dispatch``, the gather and the
    sum in ``moe_combine``."""
    lead = xf.shape[:-2]
    N, d = xf.shape[-2:]
    E, K = cfg.n_experts, cfg.n_experts_active
    G = xf[..., 0, 0].numel()
    dev = xf.device
    flat_e = idx.reshape(G, N * K)
    flat_g = gate_vals.reshape(G, N * K).to(xf.dtype)

    with torch.profiler.record_function("moe_dispatch"):
        order = torch.argsort(flat_e, dim=-1, stable=True)       # (G, NK)
        se = torch.gather(flat_e, 1, order)
        sg = _Take.apply(flat_g, order)
        # the group's pairs sorted by expert: expert e's run starts where the
        # first pair of id ≥ e sits
        starts = torch.searchsorted(
            se, torch.arange(E, device=dev).expand(G, E).contiguous())
        rank = torch.arange(N * K, device=dev) - torch.gather(starts, 1, se)
        keep = rank < C
        slot = torch.where(keep, rank, C)                  # C: overflow
        if _ROUTING is not None:
            _ROUTING.append({"idx": idx.detach(), "kept": keep.detach()})

        # the (NK, d) rows: xf expanded over K ((token, k) order), permuted by
        # ``order``; into the (E, C + 1, d) buffer, the overflow slots sliced
        # off
        rows = xf.reshape(G, N, 1, d).expand(G, N, K, d).reshape(G, N * K, d)
        rows = _Take.apply(rows, order)
        dest = se * (C + 1) + slot
        buf = _Put.apply(rows, dest, E * (C + 1))
        buf = buf.reshape(G, E, C + 1, d)[:, :, :C].reshape(lead + (E, C, d))

    nl = len(lead)
    gate = _wview(p["gate"], 3, nl)
    up = _wview(p["up"], 3, nl)
    down = _wview(p["down"], 3, nl)
    h = F.silu(torch.matmul(buf, gate)) * torch.matmul(buf, up)
    eo = torch.matmul(h, down).reshape(G, E, C, d)

    with torch.profiler.record_function("moe_combine"):
        # each pair's expert output (zero from the overflow slot), weighed by
        # its gate; back in (token, k) order, then each token's K
        # contributions summed in ascending expert id
        eo_pad = torch.cat([eo, eo.new_zeros((G, E, 1, d))], dim=2)
        out_rows = _Take.apply(eo_pad.reshape(G, E * (C + 1), d), dest)
        out_rows = out_rows * (sg * keep.to(xf.dtype))[..., None]
        per_pair = _Take.apply(out_rows, torch.argsort(order, dim=-1))
        by_expert = torch.argsort(idx.reshape(G * N, K), dim=-1)
        per_pair = _Take.apply(per_pair.reshape(G * N, K, d), by_expert)
        out = per_pair[:, 0]
        for k in range(1, K):
            out = out + per_pair[:, k]
    return out.reshape(lead + (N, d))


def _dispatch_groups(N: int, max_groups: int = 16) -> int:
    for g in range(max_groups, 0, -1):
        if N % g == 0:
            return g
    return 1


def moe_apply(p: Params, x: Tensor, cfg: ModelConfig
              ) -> Tuple[Tensor, Tensor]:
    """x: (*lead, B, S, d) -> (out, aux_loss (*lead)); the routing, the
    capacity and the load-balance loss per leading (worker) entry."""
    lead = x.shape[:-3]
    B, S, d = x.shape[-3:]
    N = B * S
    E, K = cfg.n_experts, cfg.n_experts_active

    xf = x.reshape(lead + (N, d))
    w = p["router"]["w"]
    logits = torch.matmul(xf.float(), _wview(w, 2, len(lead)).float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, K, dim=-1)              # (.., N, K)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # Switch-style load-balance loss
    me = torch.mean(probs, dim=-2)                             # (.., E)
    ce = torch.mean(F.one_hot(idx[..., 0], E).float(), dim=-2)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce, -1)

    if optflags.enabled("grouped_moe") and N > 1:
        G = _dispatch_groups(N)
        Ng = N // G
        C = _capacity(Ng, cfg)
        groups = lead + (G, Ng)
        out = _dispatch_compute(
            p, xf.reshape(groups + (d,)), gate_vals.reshape(groups + (K,)),
            idx.reshape(groups + (K,)), cfg, C).reshape(lead + (N, d))
    else:
        out = _dispatch_compute(p, xf, gate_vals, idx, cfg,
                                _capacity(N, cfg))

    if "shared" in p:
        out = out + L.mlp(p["shared"], xf, cfg)
    return out.reshape(x.shape), aux


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v3)
# ---------------------------------------------------------------------------

def mla_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    dt = cfg.dtype
    dev = resolve_device(device)
    d = cfg.d_model
    H = cfg.n_heads
    kq1, kq2, kkv1, kkv2, ko = rng.split(key, 5)
    q_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    c = cfg.kv_lora_rank

    def normal(k: int, shape) -> Tensor:
        g = rng.generator(k, dev)
        return (torch.randn(shape, generator=g, device=dev)
                * c ** -0.5).to(dt)

    p = {
        "wkv_a": L.dense_init(kkv1, d, c + cfg.qk_rope_head_dim, dt,
                              device=dev),
        "kv_norm": L.rmsnorm_init(c, dt, dev),
        # W_UK: per-head decompression for keys (nope part) and W_UV for
        # values
        "wk_b": normal(kkv2, (H, c, cfg.qk_nope_head_dim)),
        "wv_b": normal(rng.fold_in(kkv2, 1), (H, c, cfg.v_head_dim)),
        "wo": L.dense_init(ko, H * cfg.v_head_dim, d, dt, device=dev),
    }
    if cfg.q_lora_rank:
        p["wq_a"] = L.dense_init(kq1, d, cfg.q_lora_rank, dt, device=dev)
        p["q_norm"] = L.rmsnorm_init(cfg.q_lora_rank, dt, dev)
        p["wq_b"] = L.dense_init(kq2, cfg.q_lora_rank, H * q_head, dt,
                                 device=dev)
    else:
        p["wq"] = L.dense_init(kq1, d, H * q_head, dt, device=dev)
    return p


def _mla_q(p: Params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Returns (q_nope (..., S, H, dn), q_rope (..., S, H, dr))."""
    H = cfg.n_heads
    if "wq_a" in p:
        qc = L.rmsnorm(p["q_norm"], L.dense(p["wq_a"], x), cfg.norm_eps)
        q = L.dense(p["wq_b"], qc)
    else:
        q = L.dense(p["wq"], x)
    q = q.reshape(x.shape[:-1] + (H, cfg.qk_nope_head_dim
                                  + cfg.qk_rope_head_dim))
    return q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]


def _per_head(spec: str, x: Tensor, w: Tensor) -> Tensor:
    """``spec`` ("hn,hcn->hc") over x (..., H, ·) and the per-head w (H,
    ·, ·), or over x (W, ..., H, ·) and w (W, H, ·, ·)."""
    a, rest = spec.split(",")
    b, out = rest.split("->")
    if w.dim() == 4:
        return torch.einsum(f"w...{a},w{b}->w...{out}", x, w)
    return torch.einsum(f"...{a},{b}->...{out}", x, w)


def _kv_a(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor
          ) -> Tuple[Tensor, Tensor]:
    """The compressed c_kv (..., S, c) and the RoPE'd shared-head k_rope
    (..., S, dr) of x."""
    kv_a = L.dense(p["wkv_a"], x)
    c_kv = L.rmsnorm(p["kv_norm"], kv_a[..., :cfg.kv_lora_rank],
                     cfg.norm_eps)
    k_rope = L.rope(kv_a[..., cfg.kv_lora_rank:][..., None, :], positions,
                    cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _mla_attend(q_c: Tensor, q_rope: Tensor, c_kv: Tensor, k_rope: Tensor,
                mask: Tensor, cfg: ModelConfig, dtype) -> Tensor:
    """Absorbed attention: q_c (n, S, H, c), q_rope (n, S, H, dr) against
    c_kv (n, T, c) and k_rope (n, T, dr); scores f32 products of the
    operands, masked by ``mask`` (S, T) or (1, 1, 1, T).  Returns the
    compressed output o_c (n, S, H, c) in ``dtype``."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshc,btc->bhst", q_c.float(), c_kv.float())
              + torch.einsum("bshr,btr->bhst", q_rope.float(),
                             k_rope.float())) * scale
    scores = torch.where(mask, scores,
                         torch.full((), L.NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhst,btc->bshc", w, c_kv)


def mla_fwd(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor,
            window: Optional[int]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence MLA over x (..., S, d) (train/prefill). Returns (out,
    the compressed cache {c_kv, k_rope})."""
    S = x.shape[-2]
    lead = x.shape[:-2]
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = L.rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _kv_a(p, x, cfg, positions)

    # absorption: project q_nope into the compressed space once
    q_c = _per_head("hn,hcn->hc", q_nope, p["wk_b"])        # (.., S, H, c)
    n = q_c[..., 0, 0, 0].numel()
    o_c = _mla_attend(
        q_c.reshape(n, S, H, -1), q_rope.reshape(n, S, H, -1),
        c_kv.reshape(n, S, -1), k_rope.reshape(n, S, -1),
        L.causal_mask(S, window, x.device)[None, None], cfg, x.dtype)
    o = _per_head("hc,hcv->hv", o_c.reshape(lead + (S, H, -1)),
                  p["wv_b"])
    o = o.reshape(lead + (S, H * cfg.v_head_dim))
    return L.dense(p["wo"], o), {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(p: Params, x: Tensor, cfg: ModelConfig, c_kv: Tensor,
               k_rope: Tensor, write_pos: int, abs_pos: int):
    """One-token MLA decode against the compressed cache, c_kv (B, T, c)
    and k_rope (B, T, dr): the token's entries written in place at slot
    ``write_pos``, slot t attended iff t ≤ ``abs_pos``.  Returns (out,
    c_kv, k_rope)."""
    B = x.shape[0]
    H = cfg.n_heads
    T = c_kv.shape[1]
    q_nope, q_rope = _mla_q(p, x, cfg)
    posv = torch.full((B, 1), abs_pos, dtype=torch.int32, device=x.device)
    q_rope = L.rope(q_rope, posv, cfg.rope_theta)
    c_new, kr_new = _kv_a(p, x, cfg, posv)
    c_kv[:, write_pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, write_pos] = kr_new[:, 0].to(k_rope.dtype)

    q_c = _per_head("hn,hcn->hc", q_nope, p["wk_b"])
    mask = (torch.arange(T, device=x.device) <= abs_pos)[None, None, None]
    o_c = _mla_attend(q_c, q_rope, c_kv, k_rope, mask, cfg, x.dtype)
    o = _per_head("hc,hcv->hv", o_c, p["wv_b"]).reshape(B, 1, -1)
    return L.dense(p["wo"], o), c_kv, k_rope


# ---------------------------------------------------------------------------
# blocks and model
# ---------------------------------------------------------------------------

def init_block(key: int, cfg: ModelConfig, moe: bool,
               device="cuda") -> Params:
    k1, k2 = rng.split(key)
    attn = (mla_init(k1, cfg, device) if cfg.use_mla
            else L.attention_init(k1, cfg, device))
    ff = (moe_mlp_init(k2, cfg, device) if moe
          else L.mlp_init(k2, cfg, device=device))
    return {"ln1": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
            "attn": attn,
            "ln2": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
            "mlp": ff}


def _zero_aux(x: Tensor) -> Tensor:
    return torch.zeros(x.shape[:-3], dtype=torch.float32, device=x.device)


def block_fwd(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor,
              moe: bool) -> Tuple[Tensor, Tensor]:
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        a, _ = mla_fwd(p["attn"], h, cfg, positions, cfg.sliding_window)
    else:
        a, _ = L.attention_fwd(p["attn"], h, cfg, positions,
                               cfg.sliding_window)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if moe:
        y, aux = moe_apply(p["mlp"], h, cfg)
    else:
        y, aux = L.mlp(p["mlp"], h, cfg), _zero_aux(x)
    return x + y, aux


def init_params(key: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random init from an integer key: ``dense_layers`` (the first
    ``first_dense_layers``) and ``moe_layers`` stacked on a leading dim,
    then, with ``mtp``, ``mtp_block``, ``mtp_proj`` and ``mtp_norm``."""
    dev = resolve_device(device)
    ke, kd, km, kt = rng.split(key, 4)
    nd = cfg.first_dense_layers
    params: Params = {
        "embed": L.embedding_init(ke, cfg.vocab_size, cfg.d_model, cfg.dtype,
                                  dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
    }
    if nd:
        params["dense_layers"] = init_stacked(
            lambda k: init_block(k, cfg, False, dev),
            [rng.fold_in(kd, i) for i in range(nd)])
    params["moe_layers"] = init_stacked(
        lambda k: init_block(k, cfg, True, dev),
        [rng.fold_in(km, i) for i in range(cfg.n_layers - nd)])
    if cfg.mtp:
        params["mtp_block"] = init_block(kt, cfg, True, dev)
        params["mtp_proj"] = L.dense_init(rng.fold_in(kt, 1), 2 * cfg.d_model,
                                          cfg.d_model, cfg.dtype, device=dev)
        params["mtp_norm"] = L.rmsnorm_init(cfg.d_model, cfg.dtype, dev)
    return params


def lm_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
               remat: bool = True, return_mtp: bool = False):
    """Full-sequence forward over tokens (..., B, S).  Returns the logits,
    the aux loss summed over the MoE layers (one a leading entry), and the
    MTP logits (None unless ``return_mtp`` and the config has MTP)."""
    x = L.embed(params["embed"], tokens)
    S = x.shape[-2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    def dense_body(x_: Tensor, p_: Params) -> Tensor:
        return block_fwd(p_, x_, cfg, positions, moe=False)[0]

    def moe_body(x_: Tensor, p_: Params) -> Tuple[Tensor, Tensor]:
        return block_fwd(p_, x_, cfg, positions, moe=True)

    nd = cfg.first_dense_layers
    if "dense_layers" in params:
        x = run_stacked(params, x, dense_body, nd, remat, key="dense_layers")
    x, auxs = run_stacked(params, x, moe_body, cfg.n_layers - nd, remat,
                          key="moe_layers", with_aux=True)
    aux_total = torch.stack(auxs).sum(0)

    xn = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], xn)

    if cfg.mtp and return_mtp:
        # depth-1 MTP: the hidden state with the next token's embedding
        emb_next = torch.roll(L.embed(params["embed"], tokens), -1, dims=-2)
        h = L.dense(params["mtp_proj"],
                    torch.cat([L.rmsnorm(params["mtp_norm"], x,
                                         cfg.norm_eps), emb_next], -1))
        h, aux_m = block_fwd(params["mtp_block"], h, cfg, positions,
                             moe=True)
        mtp_logits = L.unembed(params["embed"],
                               L.rmsnorm(params["final_norm"], h,
                                         cfg.norm_eps))
        return logits, aux_total + aux_m, mtp_logits
    return logits, aux_total, None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> Dict:
    """Zero caches of the ``dense`` and ``moe`` layers, stacked on a
    leading layer dim: MLA's compressed c_kv (.., B, T, kv_lora_rank) and
    k_rope (.., B, T, qk_rope_head_dim), or GQA's K and V (.., B, T, KV,
    hd); T = max_seq, or min(max_seq, window) under a sliding window."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    T = (max_seq if cfg.sliding_window is None
         else min(max_seq, cfg.sliding_window))
    nd, nm = cfg.first_dense_layers, cfg.n_layers - cfg.first_dense_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def layers(n: int) -> Dict[str, Tensor]:
        if cfg.use_mla:
            return {"c_kv": zeros(n, batch, T, cfg.kv_lora_rank),
                    "k_rope": zeros(n, batch, T, cfg.qk_rope_head_dim)}
        return {"k": zeros(n, batch, T, cfg.n_kv_heads, cfg.hd),
                "v": zeros(n, batch, T, cfg.n_kv_heads, cfg.hd)}

    cache: Dict = {}
    if nd:
        cache["dense"] = layers(nd)
    cache["moe"] = layers(nm)
    return cache


def _block_decode(p: Params, x: Tensor, cfg: ModelConfig, cache: Dict,
                  i: int, write_pos: int, abs_pos: int, moe: bool) -> Tensor:
    """Layer ``i`` of a stack's decode; its cache entries are written in
    place."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        a, _, _ = mla_decode(p["attn"], h, cfg, cache["c_kv"][i],
                             cache["k_rope"][i], write_pos, abs_pos)
    else:
        a, _, _ = L.attention_decode(p["attn"], h, cfg, cache["k"][i],
                                     cache["v"][i], write_pos, abs_pos)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    y = moe_apply(p["mlp"], h, cfg)[0] if moe else L.mlp(p["mlp"], h, cfg)
    return x + y


def decode_step(params: Params, cfg: ModelConfig, cache: Dict, token: Tensor,
                pos: int) -> Tuple[Tensor, Dict]:
    """One greedy decode step. token: (B,) ids; pos: the absolute position.
    Returns the (B, V) logits and the cache, written in place at slot
    ``pos`` (``pos % window`` under a sliding window).  Every expert runs
    on its capacity buffer, as in the reference."""
    x = L.embed(params["embed"], token[:, None])
    T = tree_leaves(cache)[0].shape[2]
    write_pos = pos % T if cfg.sliding_window is not None else pos
    nd = cfg.first_dense_layers
    if "dense" in cache:
        for i in range(nd):
            x = _block_decode(layer_params(params, i, "dense_layers"), x, cfg,
                              cache["dense"], i, write_pos, pos, moe=False)
    for i in range(cfg.n_layers - nd):
        x = _block_decode(layer_params(params, i, "moe_layers"), x, cfg,
                          cache["moe"], i, write_pos, pos, moe=True)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
