"""Beyond-paper optimization flags, read from ``REPRO_OPT`` (comma-separated).

Counterpart of ``repro/optflags.py``.  Everything here is read when it is
called (or, for the chunk sizes, when the attribute is read), never at
import, so a caller or a test that sets the environment after importing
the port still takes effect:

* ``enabled("chunked_scan")`` — the SSM runs its recurrence in chunks of
  :data:`SCAN_CHUNK` steps along the sequence (``models/ssm.py``), so its
  (·, S, d_inner·n) f32 planes never exist at full length.
* ``enabled("chunked_attn")`` — windowed (or short) attention runs in
  query chunks of :data:`ATTN_CHUNK` rows (``models/layers.py``), so its
  score tensor is (chunk, S), not (S, S); full causal attention runs B11
  whatever the flag says, as in the reference.
* ``enabled("save_dots")`` — each checkpointed layer keeps its matrix
  products' outputs and the backward recomputes the rest
  (``models/transformer.run_stacked``, JAX's ``dots_saveable``).
* ``enabled("grouped_moe")`` — the MoE dispatch runs in G token groups
  (G the largest divisor of a worker's N ≤ 16), each with its own sort and
  capacity (``models/moe.moe_apply``); it changes which (token, k) pairs
  the capacity drops, so it changes results, as in the reference.
* ``enabled("rs_grads")`` — the sketched mode on a mesh sums a worker's
  gradient over the data ranks that split its batch as a reduce-scatter
  into each rank's shard where the codec's fsdp dim rides those ranks
  (``models/gather``'s backward), not as an all-reduce of the full
  gradient and a narrow; the sum is the same.  Elsewhere no rank sums a
  gradient the grid shards, so the flag changes nothing
  (``train/llm_trainer.make_sketched``).

``SCAN_CHUNK`` (``REPRO_SCAN_CHUNK``, 512) and ``ATTN_CHUNK``
(``REPRO_ATTN_CHUNK``, 512) are the chunk lengths.

The OTA tiling knobs are functions, read when a round runs, so a launcher
or an autotune sweep (``transport.autotune_ota_round``,
``phy.population.autotune_population_step``) that sets the environment
after import still takes effect:

* :func:`ota_worker_chunk` (``REPRO_OTA_WORKER_CHUNK``) — the streamed
  round's worker cohort, 0 for the monolithic pass;
* :func:`ota_block_cols` (``REPRO_OTA_BLOCK_COLS``) — the column tile of the
  one-pass round kernels B6/B7, which picks their plan
  (``kernels/ota_round.block_cols_choices``); unset, the kernels' own plan;
* :func:`ota_block_rows` (``REPRO_OTA_BLOCK_ROWS``) — the population
  kernel B10's block size (threads), 256 by default.
"""
from __future__ import annotations

import os
from typing import Optional

#: module attribute -> (environment variable, default)
_CHUNKS = {"SCAN_CHUNK": ("REPRO_SCAN_CHUNK", "512"),
           "ATTN_CHUNK": ("REPRO_ATTN_CHUNK", "512")}


def enabled(name: str) -> bool:
    return name in os.environ.get("REPRO_OPT", "").split(",")


def __getattr__(name: str) -> int:
    if name in _CHUNKS:
        var, default = _CHUNKS[name]
        value = int(os.environ.get(var, default))
        if value < 1:
            raise ValueError(f"{var}={value}: a chunk holds at least one "
                             f"step")
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def ota_worker_chunk() -> int:
    """Worker cohort of the streamed OTA round
    (``transport.ota_round_fused``): 0 (the default) the monolithic pass
    over all W workers; C > 0 streams ceil(W/C) cohorts, so the signal
    planes of C workers live at a time."""
    return int(os.environ.get("REPRO_OTA_WORKER_CHUNK", "0"))


def ota_block_cols() -> Optional[int]:
    """Column tile of the one-pass round kernels (B6/B7), or None (unset:
    ``kernels/ota_round.tiling`` picks the plan)."""
    value = os.environ.get("REPRO_OTA_BLOCK_COLS")
    return None if value in (None, "") else int(value)


def ota_block_rows() -> int:
    """Threads a block of the population kernel (B10), 256 by default."""
    return int(os.environ.get("REPRO_OTA_BLOCK_ROWS", "256"))
