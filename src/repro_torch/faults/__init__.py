"""Fault tolerance for OTA rounds: injection → detection → recovery.

* :mod:`repro_torch.faults.plan` — :class:`FaultPlan`/:class:`FaultState`:
  keyed injection of worker crashes, straggler staleness, corrupted uplink
  planes and receiver burst interference.
* :mod:`repro_torch.faults.guards` — :class:`GuardConfig` and the round
  health guard (Θ finiteness + receive-SNR floor) with the skip /
  retransmit / evict cascade, branch-free on the device.

Counterpart of ``repro/faults``.
"""
from repro_torch.faults.guards import (GuardConfig, GuardedRound,  # noqa: F401
                                       guarded_ota_round, guarded_receive)
from repro_torch.faults.plan import (FAULT_SALT, FaultPlan,  # noqa: F401
                                     FaultState, RoundFaults, apply_uplink,
                                     commit, draw, init)

__all__ = [
    "FAULT_SALT", "FaultPlan", "FaultState", "RoundFaults",
    "GuardConfig", "GuardedRound",
    "apply_uplink", "commit", "draw", "init",
    "guarded_ota_round", "guarded_receive",
]
