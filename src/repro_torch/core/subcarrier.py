"""Subcarrier mapping and channel-use accounting.

The paper transmits model element i on subcarrier ``i mod S`` in slot
``i // S`` (Appendix H: ceil(d/S) slots per upload).  Counterpart of the
accounting half of ``repro/core/subcarrier.py``: the analog upload's slot
count and the digital baseline's straggler-bound count.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SubcarrierPlan:
    """Static element->subcarrier schedule for one model."""

    d: int  # true number of model elements
    n_subcarriers: int
    n_slots: int  # ceil(d / S): analog channel uses per upload
    d_padded: int  # n_slots * S

    @classmethod
    def build(cls, d: int, n_subcarriers: int) -> "SubcarrierPlan":
        n_slots = -(-d // n_subcarriers)
        return cls(d=d, n_subcarriers=n_subcarriers, n_slots=n_slots,
                   d_padded=n_slots * n_subcarriers)


def analog_channel_uses(plan: SubcarrierPlan) -> int:
    """One analog upload = n_slots channel uses, *independent of N workers*."""
    return plan.n_slots


def digital_channel_uses(rates_bits_per_slot: torch.Tensor, bits: float,
                         subcarriers_per_worker: int) -> torch.Tensor:
    """Slots needed for the slowest worker to push ``bits`` bits (Appendix
    H), times the S_w · N subcarriers those slots occupy.

    ``rates_bits_per_slot``: (N, S_w) per-worker per-allocated-subcarrier
    Shannon rates for the current block.  Every worker gets an orthogonal
    S_w = S/N slice, and the straggler sets the slot count:
    T̂ = max_n ⌈bits / rate_n⌉.  A 0-dim tensor on the rates' device."""
    per_worker_rate = rates_bits_per_slot.sum(-1)        # bits/slot/worker
    slots = torch.ceil(bits / torch.clamp(per_worker_rate, min=1e-9))
    return slots.max() * subcarriers_per_worker * rates_bits_per_slot.shape[0]
