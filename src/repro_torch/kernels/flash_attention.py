"""Wrappers of the flash-attention CUDA kernels in ``csrc/flash_attention.cu``
(B11): the forward with its log-sum-exp residual, dq, and dk/dv, joined into
a differentiable :func:`flash_attention` by a ``torch.autograd.Function``.

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version from ``kernels/ref.py``.  q is
(B, H, S, hd), k and v (B, H, T, hd), contiguous, bf16 or f32 alike, with
hd ∈ {16, 32, 64, 128}; lse and δ are f32 (B, H, S); every operand
16-byte aligned.  bf16 operands run the kernels on the tensor cores, f32
operands the SIMT kernels (the C entry points choose by dtype).
Counterpart of ``repro/kernels/flash_attention.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor

#: head widths the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the SIMT (f32) kernels' gridDim.y carries B·H
MAX_BH = 65535


def attention_flops(q: Tensor, k: Tensor, causal: bool, per_pair: int
                    ) -> float:
    """The products one B11 kernel computes: ``per_pair`` · hd flops for
    each (query, key) pair it visits, the pairs with key ≤ query where
    ``causal`` (4 the forward: q·kᵀ and p·v; 6 dq; 8 dk/dv).  PERF.md §6's
    bound convention; the dry run counts a B11 call so."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    if causal:
        n = min(S, T)
        pairs = n * (n + 1) // 2 + max(S - T, 0) * T
    else:
        pairs = S * T
    return float(per_pair * hd * B * H * pairs)


def _scale(q: Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _check(name: str, q: Tensor, k: Tensor, v: Tensor,
           do: Optional[Tensor] = None, **rows: Tensor):
    """(device, BH, S, T, hd) of kernel operands, or raise on what the
    kernels do not take.  ``rows`` are the f32 (B, H, S) planes."""
    build.check_cuda(name, tuple(DTYPES), q=q)
    primal = dict(q=q, k=k, v=v) if do is None else dict(q=q, k=k, v=v, do=do)
    dev = build.check_cuda(name, (q.dtype,), **primal)
    if rows and build.check_cuda_f32(name, **rows) != dev:
        raise ValueError(f"{name}: {tuple(rows)} are not on q's device {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: want (B, H, S, hd) tensors, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    B, H, S, hd = q.shape
    T = k.shape[2]
    if k.shape != (B, H, T, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: k and v must be ({B}, {H}, T, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"{name}: do has shape {tuple(do.shape)}, q "
                         f"{tuple(q.shape)}")
    for arg, t in rows.items():
        if t.shape != q.shape[:3]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"want {tuple(q.shape[:3])}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
    if B * H > MAX_BH:
        raise ValueError(f"{name}: B·H = {B * H} exceeds {MAX_BH}")
    if S == 0 or T == 0:
        raise ValueError(f"{name}: empty sequence (S={S}, T={T})")
    for arg, t in {**primal, **rows}.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    return dev, B * H, S, T, hd


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[Tensor, Tensor]:
    """B11 forward: ``(o, lse)``, o in q's dtype, lse f32 (B, H, S)."""
    if build.resolve_backend(q.device) == "torch":
        return build.plain("flash_attention_fwd", ref.flash_attention_fwd,
                           q, k, v, causal, scale,
                           flops=attention_flops(q, k, causal, 4))
    dev, BH, S, T, hd = _check("flash_attention_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    build.launch("flash_attention", "flash_attention_fwd", dev,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), BH, S, T, hd, DTYPES[q.dtype],
                 _scale(q, scale), int(bool(causal)))
    return o, lse


def attention_delta(o: Tensor, do: Tensor) -> Tensor:
    """δ = Σ_d do∘o per query row, in f32 (the TPU wrapper's, outside the
    kernels)."""
    return torch.sum(do.float() * o.float(), dim=-1)


def flash_attention_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                       lse: Tensor, delta: Tensor, causal: bool = True,
                       scale: Optional[float] = None) -> Tensor:
    """B11 dq: Σ_k p∘(do·vᵀ − δ)·k·scale with p = exp(q·kᵀ·scale − lse)."""
    name = "flash_attention_dq"
    if build.resolve_backend(q.device) == "torch":
        return build.plain(name, lambda *a, **kw: ref.flash_attention_bwd(
            *a, **kw)[0], q, k, v, do, causal, scale, lse=lse, delta=delta,
            flops=attention_flops(q, k, causal, 6))
    dev, BH, S, T, hd = _check(name, q, k, v, do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    build.launch("flash_attention", name, dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), BH, S, T, hd,
                 DTYPES[q.dtype], _scale(q, scale), int(bool(causal)))
    return dq


def flash_attention_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                        lse: Tensor, delta: Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[Tensor, Tensor]:
    """B11 dk/dv: dv = pᵀ·do, dk = dsᵀ·q·scale with ds = p∘(do·vᵀ − δ)."""
    name = "flash_attention_dkv"
    if build.resolve_backend(q.device) == "torch":
        return build.plain(name, lambda *a, **kw: ref.flash_attention_bwd(
            *a, **kw)[1:], q, k, v, do, causal, scale, lse=lse, delta=delta,
            flops=attention_flops(q, k, causal, 8))
    dev, BH, S, T, hd = _check(name, q, k, v, do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    build.launch("flash_attention", name, dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, S, T,
                 hd, DTYPES[q.dtype], _scale(q, scale), int(bool(causal)))
    return dk, dv


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        lse: Tensor, do: Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) from the forward's residuals: δ in plain torch, then the
    dq and dk/dv kernels (their plain versions for CPU tensors)."""
    delta = attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Saves ``(q, k, v, o, lse)``; the backward returns ``(dq, dk, dv)`` in
    the primal dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    scale: Optional[float] = None) -> Tensor:
    """q (B,H,S,hd); k/v (B,H,T,hd) -> (B,H,S,hd), differentiable: the
    backward runs the dq and dk/dv kernels from the forward's one f32
    (B, H, S) log-sum-exp residual."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale))
