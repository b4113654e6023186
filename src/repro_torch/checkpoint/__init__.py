"""Checkpoints of the port's states in the JAX package's ``.npz`` format
(counterpart of ``repro/checkpoint``); a mesh-sharded state's through
``save_sharded``/``restore_sharded``."""
from repro_torch.checkpoint.np_checkpoint import (latest_round,  # noqa: F401
                                                  restore, round_path, save)
from repro_torch.checkpoint.sharded import (gather_fl_state,  # noqa: F401
                                            restore_sharded, save_sharded)
