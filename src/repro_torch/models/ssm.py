"""SSM family: mamba1 (falcon-mamba-7b), attention-free selective state
space.  Counterpart of ``repro/models/ssm.py``, the full-sequence half.

Per layer:  x,z = in_proj(u);  x = silu(causal_conv1d(x));
            dt,B,C = x_proj(x);  dt = softplus(dt_proj(dt)+bias);
            h_t = exp(dt·A)⊙h_{t-1} + (dt·B_t)·x_t ;  y_t = C_t·h_t + D⊙x_t;
            out = out_proj(y ⊙ silu(z)),
with the RMS normalisation of (B, C, dt) that Falcon-Mamba adds.

The recurrence runs B12 (``kernels/linear_scan.py``) over the (·, S,
d_inner·n) planes a and b in f32, as JAX's ``_scan_full`` materialises
them; the leading worker and batch dims fold into the scan's batch.  Under
``REPRO_OPT=chunked_scan`` (``optflags``) a sequence longer than
``SCAN_CHUNK`` runs JAX's ``_scan_chunked_fused`` instead: a and b are
built one chunk at a time, B12 runs on each chunk with the carry folded
into its first step, and h is contracted with C inside the chunk, so the
planes exist at the chunk's length only.  A Python loop over the stacked
layers replaces ``lax.scan``, and ``remat=True`` checkpoints each layer
(``transformer.run_stacked``), so the backward pass runs each layer's
forward, B12 included, once more.  ``A_log`` and ``D`` stay f32 leaves in a
bf16 tree.  Decode is the O(1)-per-token state update in plain torch
(:func:`init_cache`, :func:`decode_step`): an f32 state (B, d_inner, n)
and the conv window (B, K − 1, d_inner) a layer, updated in place.

On a mesh whose ``model`` axis divides ``d_inner`` (``models/partition``:
``Partition.inner``) every rank runs its d_inner/m channels: its
``in_proj`` block exchanged to its x and z (one all-to-all), the conv,
``dt_proj``, ``A_log``, ``D`` and B12 on its channels, ``x_proj`` whole on
the gathered channels, ``out_proj``'s rows summed; decode holds the
rank's channels of the state and the window.  One device (no partition)
runs the same code with nothing split.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import optflags, rng
from repro_torch.device import resolve_device
from repro_torch.kernels.linear_scan import (gated_linear_scan,
                                             linear_scan_carry)
from repro_torch.models import layers as L
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_layer, init_stacked,
                                            run_stacked)

Tensor = torch.Tensor
Params = Dict


def block_init(key: int, cfg: ModelConfig, device="cuda") -> Params:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dt = cfg.dtype
    dev = resolve_device(device)
    k = rng.split(key, 6)
    g = rng.generator(k[1], dev)
    # S4D-real initialisation for A
    a_init = torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev)[None].repeat(di, 1)
    return {
        "norm": L.rmsnorm_init(d, dt, dev),
        "in_proj": L.dense_init(k[0], d, 2 * di, dt, device=dev),
        "conv_w": (torch.randn((cfg.conv1d_width, di), generator=g,
                               device=dev) * 0.1).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": L.dense_init(k[2], di, r + 2 * n, dt, device=dev),
        "dt_proj": L.dense_init(k[3], r, di, dt, bias=True, device=dev),
        "A_log": torch.log(a_init),                    # f32: dynamics in f32
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": L.dense_init(k[4], di, d, dt, device=dev),
        "b_norm": L.rmsnorm_init(n, dt, dev),
        "c_norm": L.rmsnorm_init(n, dt, dev),
        "dt_norm": L.rmsnorm_init(r, dt, dev),
    }


def _conv1d_causal(w: Tensor, b: Tensor, x: Tensor) -> Tensor:
    """Depthwise causal conv. x: (..., B, S, di); w: (..., W, di), the
    leading (worker) dims of w matching x's."""
    K, S = w.shape[-2], x.shape[-2]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[..., i:i + S, :] * L._bcast(w[..., i, :], x, 1)
              for i in range(K))
    return out + L._bcast(b, x, 1)


def _x_proj(p: Params, x: Tensor, cfg: ModelConfig, part) -> Tensor:
    """``x_proj`` (…, r + 2n) whole from x on the rank's channels: the
    channels gathered (``gather_inner``), then the whole product, one
    device's contraction over d_inner, where the rank holds the weight
    whole (the trainer and the prefill gather it; a width the axis does
    not divide is replicated), or its columns of it where it holds its
    column block (decode's plan), the columns gathered (``gather_proj``).
    A row split of the contraction (each rank's channels, the partials
    summed) moves fewer bytes at S tokens, but the sums' other rounding
    moves reduced falcon-mamba's f32 gradients by up to 1.6e-5 of their
    largest, where one device's contraction keeps them within 1e-5 of
    JAX's."""
    xs = part.gather_inner(x)
    if p["x_proj"]["w"].shape[-1] == cfg.dt_rank + 2 * cfg.ssm_state:
        return L.dense(p["x_proj"], xs)
    return part.gather_cols(L.dense(p["x_proj"], xs))[0]


def _dt_proj(p: Params, dt_r: Tensor, cfg: ModelConfig, part) -> Tensor:
    """``dt_proj``'s output on the rank's channels (…, di/n), bias added.
    Where the rank holds the weight whole (gathered, or replicated) its
    columns; where it holds its row block (decode's plan), the product on
    those rows in f32, reduce-scattered over the axis to the rank's
    channels (``scatter_inner``) and rounded once."""
    from repro_torch.models.layers import _bcast

    w = p["dt_proj"]["w"]
    c = cfg.d_inner // part.n
    if w.shape[-2] == cfg.dt_rank:
        return part.dense_slice(p["dt_proj"], dt_r, part.index * c,
                                (part.index + 1) * c)
    rl = w.shape[-2]
    acc = torch.promote_types(dt_r.dtype, torch.float32)
    y = L.dense({"w": w.to(acc)},
                dt_r.narrow(-1, part.index * rl, rl).to(acc))
    y = part.mesh.reduce_scatter(y, part.axis, y.dim() - 1,
                                 op="scatter_inner").to(dt_r.dtype)
    return y + _bcast(part.channels(p["dt_proj"]["b"]), y, 1)


def _ssm_inputs(p: Params, x: Tensor, cfg: ModelConfig, part=None):
    """Shared pre-scan computation. x: (..., B, S, di) post-conv (the
    rank's di/m channels under ``part``).  Returns (dt, B, C, A): dt (...,
    B, S, di), B and C (..., B, S, n) in f32, and A = −exp(A_log) (...,
    di, n); under ``part`` dt and A on the rank's channels, B and C
    whole."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = (L.dense(p["x_proj"], x) if part is None
            else _x_proj(p, x, cfg, part))
    dt_r, Bc, Cc = torch.split(proj, [r, n, n], dim=-1)
    dt_r = L.rmsnorm(p["dt_norm"], dt_r, cfg.norm_eps)
    Bc = L.rmsnorm(p["b_norm"], Bc, cfg.norm_eps)
    Cc = L.rmsnorm(p["c_norm"], Cc, cfg.norm_eps)
    if part is not None:
        # whole on every rank, each uses them on its channels alone: their
        # gradients sum over the axis (one ``copy_to``), so the norms and
        # ``x_proj`` before them see the whole gradient on every rank
        dt_r, Bc, Cc = torch.split(part.copy_to(torch.cat([dt_r, Bc, Cc],
                                                          -1)),
                                   [r, n, n], dim=-1)
    Bc, Cc = Bc.float(), Cc.float()
    if part is None:
        dt = F.softplus(L.dense(p["dt_proj"], dt_r).float())
        A = -torch.exp(p["A_log"])
    else:
        dt = F.softplus(_dt_proj(p, dt_r, cfg, part).float())
        A = -torch.exp(part.channels(p["A_log"], -2))
    return dt, Bc, Cc, A


def _in_proj(p: Params, h: Tensor, cfg: ModelConfig, part
             ) -> Tuple[Tensor, Tensor]:
    """x and z (…, di) of ``in_proj`` on h; under ``part`` the rank's
    channels of each (…, di/m): its column block's product, exchanged
    (``Partition.inner_xz``)."""
    if part is None:
        return torch.chunk(L.dense(p["in_proj"], h), 2, dim=-1)
    xz = part.dense_cols(p["in_proj"], part.copy_to(h), 2 * cfg.d_inner,
                         "in_proj")
    return part.inner_xz(xz)


def _conv_params(p: Params, part) -> Tuple[Tensor, Tensor, Tensor]:
    """``conv_w``, ``conv_b`` and ``D`` on the rank's channels (whole
    without ``part``)."""
    if part is None:
        return p["conv_w"], p["conv_b"], p["D"]
    return (part.channels(p["conv_w"]), part.channels(p["conv_b"]),
            part.channels(p["D"]))


def _scan_full(dt: Tensor, Bc: Tensor, Cc: Tensor, A: Tensor,
               xf: Tensor) -> Tensor:
    """Materialise the (..., B, S, di, n) planes a and b in f32, run B12
    over them with every leading dim folded into its batch, contract with
    C."""
    a = torch.exp(dt[..., None] * L._bcast(A, dt[..., None], 2))
    b = (dt * xf)[..., None] * Bc[..., None, :]
    S, di, n = a.shape[-3:]
    hs = gated_linear_scan(a.reshape(-1, S, di, n), b.reshape(-1, S, di, n))
    return torch.einsum("...sdn,...sn->...sd", hs.reshape(a.shape), Cc)


def _scan_chunked_fused(dt: Tensor, Bc: Tensor, Cc: Tensor, A: Tensor,
                        xf: Tensor, chunk: int) -> Tensor:
    """``_scan_full`` one chunk of ``chunk`` steps at a time along the
    sequence (axis −2 of the (..., B, S, ·) inputs; the leading dims fold
    into the scan's batch): each chunk builds its own a = exp(dt·A) and
    b = (dt·x)⊗B, runs B12 from the last chunk's state
    (``linear_scan_carry``, which folds it into step 0: b₀ += a₀·h_prev,
    rounded product first as B12's own step), contracts h with C and
    keeps only h's last step for the next chunk.  The tail is padded with
    dt = 0 (a = 1, b = 0) and the output sliced back to S."""
    lead = xf.shape[:-2]
    S, di = xf.shape[-2:]
    n = A.shape[-1]
    C = min(chunk, S)
    pad = -(-S // C) * C - S
    A_b = L._bcast(A, dt[..., None], 2).expand(*lead, 1, di, n)
    A_b = A_b.reshape(-1, 1, di, n)
    if pad:
        dt, Bc, Cc, xf = (F.pad(v, (0, 0, 0, pad)) for v in (dt, Bc, Cc, xf))
    dt, Bc, Cc, xf = (v.reshape(-1, S + pad, v.shape[-1])
                      for v in (dt, Bc, Cc, xf))
    ys, h = [], dt.new_zeros(dt.shape[0], di, n)
    # one split a tensor: its backward is one concatenation, where a slice
    # a chunk would add a zero-filled full-length gradient per chunk
    for dtc, bc, cc, xc in zip(*(v.split(C, dim=1)
                                 for v in (dt, Bc, Cc, xf))):
        a = torch.exp(dtc[..., None] * A_b)               # (N, C, di, n)
        b = (dtc * xc)[..., None] * bc[:, :, None, :]
        hs, h = linear_scan_carry(a, b, h)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cc))
    return torch.cat(ys, dim=1)[:, :S].reshape(*lead, S, di)


def _out_proj(p: Params, y: Tensor, cfg: ModelConfig, part) -> Tensor:
    if part is None:
        return L.dense(p["out_proj"], y)
    return part.dense_rows(p["out_proj"], y, cfg.d_inner, "out_proj")


def block_fwd(p: Params, u: Tensor, cfg: ModelConfig) -> Tensor:
    """Full-sequence forward. u: (..., B, S, d).  Under a partition of the
    inner channels (``models/partition``) every product, the conv, B12
    and the gate run on the rank's di/m channels, and ``out_proj``'s
    row-split partials are summed."""
    part = partition.current("inner")
    h = L.rmsnorm(p["norm"], u, cfg.norm_eps)
    x, z = _in_proj(p, h, cfg, part)
    conv_w, conv_b, D = _conv_params(p, part)
    x = F.silu(_conv1d_causal(conv_w, conv_b, x))
    dt, Bc, Cc, A = _ssm_inputs(p, x, cfg, part)
    xf = x.float()
    if optflags.enabled("chunked_scan") and x.shape[-2] > optflags.SCAN_CHUNK:
        y = _scan_chunked_fused(dt, Bc, Cc, A, xf, optflags.SCAN_CHUNK)
    else:
        y = _scan_full(dt, Bc, Cc, A, xf)
    y = y + L._bcast(D, xf, 1) * xf
    y = y.to(u.dtype) * F.silu(z)
    return u + _out_proj(p, y, cfg, part)


def init_params(key: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random init from an integer key: per-layer leaves stacked on a
    leading ``n_layers`` dim, as ``jax.vmap(block_init)`` makes them."""
    dev = resolve_device(device)
    ke, kl = rng.split(key)
    lkeys = [rng.fold_in(kl, i) for i in range(cfg.n_layers)]
    return {
        "embed": L.embedding_init(ke, cfg.vocab_size, cfg.d_model, cfg.dtype,
                                  dev),
        "layers": init_stacked(lambda k: block_init(k, cfg, dev), lkeys),
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
    }


def lm_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
               remat: bool = True) -> Tensor:
    """Full-sequence forward over tokens (..., B, S). Returns logits (the
    rank's vocab columns under a partition of the vocab)."""
    x = L.embed(params["embed"], tokens, cfg.vocab_size)

    def block(x_: Tensor, p_: Params) -> Tensor:
        return block_fwd(p_, x_, cfg)

    x = run_stacked(params, x, block, cfg.n_layers, remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)


# ---------------------------------------------------------------------------
# decode: the O(1) state update a token
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> Dict[str, Tensor]:
    """The zero state of every layer: ``ssm`` (n_layers, B, d_inner, n) f32
    and ``conv`` (n_layers, B, K − 1, d_inner) in the param dtype; the size
    does not depend on the sequence.  (Serving on a mesh makes the rank's
    block, ``serve_step.init_cache``.)"""
    del max_seq, dtype
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv1d_width - 1,
                             cfg.d_inner), dtype=cfg.dtype, device=dev),
    }


def block_decode(p: Params, u: Tensor, cfg: ModelConfig, ssm_state: Tensor,
                 conv_state: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """u: (B, 1, d); ssm_state: (B, d_inner, n); conv_state: (B, K − 1,
    d_inner).  Returns (out, new state, new conv window).  Under serving's
    partition of the inner channels (``models/partition``: the cache's
    ``"inner"`` layout) the states are the rank's channels (B, d_inner/m,
    ·), and so is every product but ``x_proj``'s, whose columns the rank
    projects from the gathered token (``_x_proj``)."""
    part = partition.current("inner")
    h = L.rmsnorm(p["norm"], u, cfg.norm_eps)
    x, z = _in_proj(p, h, cfg, part)                    # (B, 1, di)
    conv_w, conv_b, D = _conv_params(p, part)
    window = torch.cat([conv_state, x], dim=1)          # (B, K, di)
    x = torch.einsum("bwd,wd->bd", window, conv_w) + conv_b
    x = F.silu(x)[:, None]                              # (B, 1, di)
    dt, Bc, Cc, A = _ssm_inputs(p, x, cfg, part)
    dt, Bc, Cc = dt[:, 0], Bc[:, 0], Cc[:, 0]           # (B, di) / (B, n)
    xf = x[:, 0].float()
    a = torch.exp(dt[..., None] * A[None])              # (B, di, n)
    hnew = a * ssm_state + (dt * xf)[..., None] * Bc[:, None, :]
    y = torch.einsum("bdn,bn->bd", hnew, Cc) + D[None] * xf
    y = (y.to(u.dtype) * F.silu(z[:, 0]))[:, None]
    return u + _out_proj(p, y, cfg, part), hnew, window[:, 1:]


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Tensor],
                token: Tensor, pos: int) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step (an SSM has no positional state beyond h): the
    (B, V) logits (the rank's vocab columns under a partition of the
    vocab), and the cache updated in place."""
    del pos
    x = L.embed(params["embed"], token[:, None], cfg.vocab_size)
    for i in range(cfg.n_layers):
        x, s, c = block_decode(decode_layer(params, i), x, cfg,
                               cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i].copy_(s)
        cache["conv"][i].copy_(c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
