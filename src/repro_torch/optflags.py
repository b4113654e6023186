"""Beyond-paper optimization flags, read from ``REPRO_OPT`` (comma-separated).

Counterpart of ``repro/optflags.py``.  Everything here is read when it is
called (or, for the chunk sizes, when the attribute is read), never at
import, so a caller or a test that sets the environment after importing
the port still takes effect:

* ``enabled("chunked_scan")`` — the SSM runs its recurrence in chunks of
  :data:`SCAN_CHUNK` steps along the sequence (``models/ssm.py``), so its
  (·, S, d_inner·n) f32 planes never exist at full length.
* ``enabled("chunked_attn")`` and ``enabled("save_dots")`` — not ported
  yet (ROADMAP queue A item 2): the models refuse them.

``SCAN_CHUNK`` (``REPRO_SCAN_CHUNK``, 512) and ``ATTN_CHUNK``
(``REPRO_ATTN_CHUNK``, 512) are the chunk lengths.  The JAX package's OTA
tiling knobs have no counterpart: the port's kernels pick their own tiling.
"""
from __future__ import annotations

import os

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
