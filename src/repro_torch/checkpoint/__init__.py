"""Checkpoints of the port's states in the JAX package's ``.npz`` format
(counterpart of ``repro/checkpoint``)."""
from repro_torch.checkpoint.np_checkpoint import (latest_round,  # noqa: F401
                                                  restore, round_path, save)
