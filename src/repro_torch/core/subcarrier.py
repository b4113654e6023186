"""Subcarrier mapping and channel-use accounting.

The paper transmits model element i on subcarrier ``i mod S`` in slot
``i // S`` (Appendix H: ceil(d/S) slots per upload).  Counterpart of the
accounting half of ``repro/core/subcarrier.py``.
"""
from __future__ import annotations

import dataclasses


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
