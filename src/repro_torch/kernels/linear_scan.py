"""Wrappers of the gated linear scan's CUDA kernels in ``csrc/linear_scan.cu``
(B12): h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D), h_0 = b_0, its reversed
backward, :func:`gated_linear_scan`, the models' entry point, which is
differentiable through :class:`LinearScan`, and :func:`linear_scan_carry`,
the scan from a carried state that the SSM's chunked scan runs chunk by
chunk.

Same contract as ``kernels/ota.py``: CUDA tensors launch the kernel or
raise, CPU tensors take the plain version from ``kernels/ref.py``.  The
kernels take contiguous float32 (B, S, D) tensors.  Each direction has two
plans, which give the same bits (the plain version's): ``"thread"``, one
thread walking each sequence, for many sequences, and ``"staged"``, a warp
walking cb sequences out of a TMA-fed shared-memory ring, for few.  The
planner :func:`scan_tiling` picks one by shape; a wrapper's ``plan``
argument, or :func:`forced_plan` around the autograd path, forces one.
Either plan is one launch, counted under the wrapper's name.  Counterpart
of ``repro/kernels/linear_scan.py`` and of the scan shim in
``repro/kernels/__init__.py``.  The shim has no ``REPRO_USE_PALLAS``
switch: the scan always runs B12, which is the branch JAX's shim takes
first, so under ``REPRO_OPT=chunked_scan`` it still runs B12 over the
whole sequence (the SSM chunks its own scan, ``models/ssm.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import build, ota_round, ref

Tensor = torch.Tensor

PLANS = ("thread", "staged")
#: rows·D below this many sequences an SM take the staged plan: on an H100
#: (132 SMs) it beats the thread plan at every count below 131,072, at
#: S = 128, 1,000 and 4,096, both directions; from there the two are within
#: 3 % either way (tools/sweep_scan.py)
STAGED_BELOW_PER_SM = 992
#: channels a staged block walks: the widest is the fastest from a few
#: thousand sequences up and no slower below (tools/sweep_scan.py)
STAGED_CHANNELS = 32
#: (steps a stage, stages in the ring).  A stage costs the walker a fixed
#: fraction of a µs, so below LONG_STAGES_BELOW_PER_SM sequences an SM,
#: where the walk sets the time, stages are long; above, where the blocks
#: stream the most bytes, they are short and the ring small enough that
#: two blocks share an SM (tools/sweep_scan.py)
LONG_STAGES_BELOW_PER_SM = 31
LONG_STAGES = (128, 3)
SHORT_STAGES = (32, 3)


class ScanTiling(NamedTuple):
    """B12's plan.  ``"thread"``: one thread a sequence (the other fields
    0).  ``"staged"``: a block walks ``channels`` sequences of one row out
    of a ring of ``stages`` shared-memory stages of ``steps`` steps each."""
    plan: str
    channels: int = 0
    steps: int = 0
    stages: int = 0


def scan_tiling(rows: int, S: int, D: int, n_sm: int = ota_round.SMS,
                aligned: bool = True) -> ScanTiling:
    """The plan for (rows, S, D) planes on a card of ``n_sm`` SMs: staged
    where rows·D sequences are too few to fill the card (fewer than
    :data:`STAGED_BELOW_PER_SM` an SM) and TMA can take the planes
    (D % 4 == 0, 16-byte ``aligned`` bases), else one thread a sequence.
    The staged plan's parameters follow from the same count; S does not
    move the choice (the sweep's crossover is the same at every S)."""
    if rows * D < STAGED_BELOW_PER_SM * n_sm and staged_refusal(
            D, aligned) is None:
        return staged_tiling(rows, D, n_sm)
    return ScanTiling("thread")


def staged_tiling(rows: int, D: int, n_sm: int = ota_round.SMS
                  ) -> ScanTiling:
    """The staged plan's parameters for rows·D sequences on ``n_sm`` SMs:
    long stages for few sequences, short ones for more."""
    long = rows * D < LONG_STAGES_BELOW_PER_SM * n_sm
    return ScanTiling("staged", STAGED_CHANNELS,
                      *(LONG_STAGES if long else SHORT_STAGES))


def staged_refusal(D: int, aligned: bool) -> Optional[str]:
    """Why the staged plan cannot take these planes, or None."""
    if D % 4:
        return f"D = {D} is not a multiple of 4 (TMA's 16-byte row stride)"
    if not aligned:
        return "a plane does not start on a 16-byte boundary (TMA's base)"
    return None


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


PlanArg = Union[None, str, ScanTiling]


def resolve_plan(name: str, plan: PlanArg, rows: int, S: int, D: int,
                 n_sm: int = ota_round.SMS, aligned: bool = True
                 ) -> ScanTiling:
    """``plan`` resolved for (rows, S, D) planes: None is the planner's
    choice, a plan's name its parameters for this shape, a
    :class:`ScanTiling` itself; a staged plan the planes cannot take
    raises, naming the reason."""
    if plan is None:
        return scan_tiling(rows, S, D, n_sm, aligned)
    name_of = plan if isinstance(plan, str) else plan.plan
    if name_of not in PLANS:
        raise ValueError(f"{name}: plan {plan!r} is none of {PLANS}")
    if name_of == "thread":
        return ScanTiling("thread")
    why = staged_refusal(D, aligned)
    if why is not None:
        raise ValueError(f"{name}: the staged plan cannot take ({rows}, "
                         f"{S}, {D}) planes: {why}")
    return staged_tiling(rows, D, n_sm) if isinstance(plan, str) else plan


def _plan(name: str, plan: PlanArg, *planes: Tensor) -> ScanTiling:
    """:func:`resolve_plan` for these (B, S, D) planes on their card."""
    if planes[0].dim() != 3:
        raise ValueError(f"{name}: want (B, S, D) tensors, got "
                         f"{tuple(planes[0].shape)}")
    dev = planes[0].device
    n_sm = ota_round.sm_count(dev) if dev.type == "cuda" else ota_round.SMS
    return resolve_plan(name, plan, *planes[0].shape, n_sm,
                        ota_round.aligned16(*planes))


def linear_scan_fwd(a: Tensor, b: Tensor, plan: PlanArg = None) -> Tensor:
    """B12 forward: h (B, S, D) float32, on ``plan`` (see
    :func:`resolve_plan`; on CPU tensors a forced plan is checked, then the
    plain version runs)."""
    if build.resolve_backend(a.device) == "torch":
        if plan is not None:
            _plan("linear_scan_fwd", plan, a, b)
        return build.plain("linear_scan_fwd", ref.linear_scan, a, b,
                           like=lambda: torch.empty_like(
                               b, dtype=torch.float32))
    dev, rows, S, D = _check("linear_scan_fwd", a=a, b=b)
    t = _plan("linear_scan_fwd", plan, a, b)
    h = torch.empty_like(b)
    args = (a.data_ptr(), b.data_ptr(), h.data_ptr(), rows, S, D)
    if t.plan == "thread":
        build.launch("linear_scan", "linear_scan_fwd", dev, *args)
    else:
        build.launch("linear_scan", "linear_scan_fwd_staged", dev, *args,
                     t.channels, t.steps, t.stages, count="linear_scan_fwd")
    return h


def linear_scan_bwd(a: Tensor, h: Tensor, dh: Tensor, plan: PlanArg = None
                    ) -> Tuple[Tensor, Tensor]:
    """B12 backward: ``(da, db)`` float32 from the gates, the forward's
    output and its cotangent (the reversed recurrence and the epilogue
    da = g ⊙ h_{t−1} in one launch), on ``plan``."""
    if build.resolve_backend(a.device) == "torch":
        if plan is not None:
            _plan("linear_scan_bwd", plan, a, h, dh)
        return build.plain("linear_scan_bwd", ref.linear_scan_bwd, a, h,
                           dh, like=lambda: tuple(torch.empty_like(
                               dh, dtype=torch.float32) for _ in range(2)))
    dev, rows, S, D = _check("linear_scan_bwd", a=a, h=h, dh=dh)
    t = _plan("linear_scan_bwd", plan, a, h, dh)
    da = torch.empty_like(dh)
    g = torch.empty_like(dh)
    args = (a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
            g.data_ptr(), rows, S, D)
    if t.plan == "thread":
        build.launch("linear_scan", "linear_scan_bwd", dev, *args)
    else:
        build.launch("linear_scan", "linear_scan_bwd_staged", dev, *args,
                     t.channels, t.steps, t.stages, count="linear_scan_bwd")
    return da, g


#: the plan :func:`forced_plan` sets for the autograd path in this context
_forced: contextvars.ContextVar = contextvars.ContextVar(
    "linear_scan_forced_plan", default=None)


@contextlib.contextmanager
def forced_plan(plan: str):
    """Every :class:`LinearScan` forward entered inside the block runs on
    ``plan`` ("thread" or "staged"), and so does its backward, wherever it
    runs."""
    if plan not in PLANS:
        raise ValueError(f"forced_plan: {plan!r} is none of {PLANS}")
    token = _forced.set(plan)
    try:
        yield
    finally:
        _forced.reset(token)


class LinearScan(torch.autograd.Function):
    """h = scan(a, b), differentiable.  Saves ``a`` and ``h`` only (the JAX
    rule keeps ``b`` for its dtype alone; this one keeps the dtypes); the
    backward is one launch of the backward kernel, cotangents cast to the
    primal dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        af, bf = a.float().contiguous(), b.float().contiguous()
        ctx.plan = _forced.get()
        h = linear_scan_fwd(af, bf, ctx.plan)
        ctx.save_for_backward(af, h)
        ctx.dtypes = (a.dtype, b.dtype)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, db = linear_scan_bwd(a, h, dh.float().contiguous(), ctx.plan)
        return da.to(ctx.dtypes[0]), db.to(ctx.dtypes[1])


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D), h_0 = b_0; float32 out,
    differentiable."""
    return LinearScan.apply(a, b)


class LinearScanCarry(torch.autograd.Function):
    """(h, h_last, b) = the scan of (B, S, ...) planes from a carried state
    h0 (B, ...): h_0 = a_0·h0 + b_0, then as :class:`LinearScan`; the
    trailing dims fold into one channel axis.  ``b`` (float32, contiguous,
    not a view) is taken over: its first step becomes b_0 + a_0·h0, rounded
    product first as B12 rounds each step, so a sequence scanned chunk by
    chunk, each chunk carrying the last one's ``h_last``, gets the whole
    scan's bits.  ``b`` is returned (marked dirty) for the caller to drop.
    The backward is one B12 backward launch: the next chunk's gradient of
    ``h_last`` enters the last step of dh (on a copy), h0's gradient is
    g_0·a_0, and da_0 gains g_0·h0 (B12's own step 0 reads h_{−1} = 0)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        if b.dtype != torch.float32 or not b.is_contiguous() \
                or b._base is not None:
            raise ValueError("linear_scan_carry: b must be a contiguous "
                             "float32 tensor, not a view; its first step "
                             "is overwritten")
        ctx.set_materialize_grads(False)
        B, S = b.shape[:2]
        af = a.float().contiguous().view(B, S, -1)
        bf = b.view(B, S, -1)
        h0f = h0.float().reshape(B, -1)
        bf[:, 0] += af[:, 0] * h0f
        ctx.mark_dirty(b)
        ctx.plan = _forced.get()
        h = linear_scan_fwd(af, bf, ctx.plan)
        ctx.save_for_backward(af, h, h0f)
        ctx.meta = (b.shape, a.dtype, h0.shape, h0.dtype)
        return h.view(b.shape), h[:, -1].reshape(h0.shape).clone(), b

    @staticmethod
    def backward(ctx, dh, dh_last, _):
        a, h, h0 = ctx.saved_tensors
        shape, a_dtype, h0_shape, h0_dtype = ctx.meta
        dh = torch.zeros_like(h) if dh is None \
            else dh.float().reshape(h.shape).contiguous()
        if dh_last is not None:
            dh = dh.clone()
            dh[:, -1] += dh_last.float().reshape(h0.shape)
        da, g = linear_scan_bwd(a, h, dh, ctx.plan)
        da[:, 0] += g[:, 0] * h0
        dh0 = (g[:, 0] * a[:, 0]).reshape(h0_shape).to(h0_dtype)
        return da.view(shape).to(a_dtype), g.view(shape), dh0


def linear_scan_carry(a: Tensor, b: Tensor,
                      h0: Tensor) -> Tuple[Tensor, Tensor]:
    """(h, h_last): the recurrence over axis 1 of (B, S, ...) from the
    state h0 (B, ...), h_0 = a_0·h0 + b_0; ``b`` is overwritten
    (:class:`LinearScanCarry`).  Float32 out, differentiable; one B12
    launch a direction."""
    h, h_last, _ = LinearScanCarry.apply(a, b, h0)
    return h, h_last


def gated_linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """The recurrence over axis 1 of (B, S, ...): the trailing dims fold
    into one channel axis, as the JAX shim folds them."""
    if a.shape != b.shape or a.dim() < 2:
        raise ValueError(f"gated_linear_scan: want a and b of one (B, S, "
                         f"...) shape, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    B, S = a.shape[:2]
    h = linear_scan(a.reshape(B, S, -1), b.reshape(B, S, -1))
    return h.reshape(a.shape)
