"""Wrappers of the gated linear scan's CUDA kernels in ``csrc/linear_scan.cu``
(B12): h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D), h_0 = b_0, its reversed
backward, and :func:`gated_linear_scan`, the models' entry point, which is
differentiable through :class:`LinearScan`.

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version from ``kernels/ref.py``.  The
kernels take contiguous float32 (B, S, D) tensors.  Counterpart of
``repro/kernels/linear_scan.py`` and of the scan shim in
``repro/kernels/__init__.py``; the JAX package's ``REPRO_USE_PALLAS``
switch and its ``chunked_scan`` optflag are not ported (ROADMAP queue A
item 2): on the card the scan always runs B12, and ``REPRO_OPT`` naming
``chunked_scan`` is refused.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor


def _check(name: str, **tensors: Tensor):
    """(device, rows, S, D) of same-shape (B, S, D) kernel operands."""
    dev = build.check_cuda_f32(name, **tensors)
    shapes = {arg: tuple(t.shape) for arg, t in tensors.items()}
    first = next(iter(shapes.values()))
    if len(first) != 3:
        raise ValueError(f"{name}: want (B, S, D) tensors, got {shapes}")
    if any(s != first for s in shapes.values()):
        raise ValueError(f"{name}: operands differ in shape: {shapes}")
    return (dev, *first)


def linear_scan_fwd(a: Tensor, b: Tensor) -> Tensor:
    """B12 forward: h (B, S, D) float32."""
    if build.resolve_backend(a.device) == "torch":
        return ref.linear_scan(a, b)
    dev, rows, S, D = _check("linear_scan_fwd", a=a, b=b)
    h = torch.empty_like(b)
    build.launch("linear_scan", "linear_scan_fwd", dev, a.data_ptr(),
                 b.data_ptr(), h.data_ptr(), rows, S, D)
    return h


def linear_scan_bwd(a: Tensor, h: Tensor, dh: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """B12 backward: ``(da, db)`` float32 from the gates, the forward's
    output and its cotangent (the reversed recurrence and the epilogue
    da = g ⊙ h_{t−1} in one launch)."""
    if build.resolve_backend(a.device) == "torch":
        return ref.linear_scan_bwd(a, h, dh)
    dev, rows, S, D = _check("linear_scan_bwd", a=a, h=h, dh=dh)
    da = torch.empty_like(dh)
    g = torch.empty_like(dh)
    build.launch("linear_scan", "linear_scan_bwd", dev, a.data_ptr(),
                 h.data_ptr(), dh.data_ptr(), da.data_ptr(), g.data_ptr(),
                 rows, S, D)
    return da, g


class LinearScan(torch.autograd.Function):
    """h = scan(a, b), differentiable.  Saves ``a`` and ``h`` only (the JAX
    rule keeps ``b`` for its dtype alone; this one keeps the dtypes); the
    backward is one launch of the backward kernel, cotangents cast to the
    primal dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        af, bf = a.float().contiguous(), b.float().contiguous()
        h = linear_scan_fwd(af, bf)
        ctx.save_for_backward(af, h)
        ctx.dtypes = (a.dtype, b.dtype)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, db = linear_scan_bwd(a, h, dh.float().contiguous())
        return da.to(ctx.dtypes[0]), db.to(ctx.dtypes[1])


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D), h_0 = b_0; float32 out,
    differentiable."""
    return LinearScan.apply(a, b)


def gated_linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """The recurrence over axis 1 of (B, S, ...): the trailing dims fold
    into one channel axis, as the JAX shim folds them."""
    if "chunked_scan" in os.environ.get("REPRO_OPT", "").split(","):
        raise NotImplementedError(
            "REPRO_OPT chunked_scan is not ported yet (ROADMAP queue A item "
            "2: optflags.py); the scan runs B12 on the card")
    if a.shape != b.shape or a.dim() < 2:
        raise ValueError(f"gated_linear_scan: want a and b of one (B, S, "
                         f"...) shape, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    B, S = a.shape[:2]
    h = linear_scan(a.reshape(B, S, -1), b.reshape(B, S, -1))
    return h.reshape(a.shape)
