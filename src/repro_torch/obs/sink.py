"""Structured run logs: per-round JSONL events + a run manifest.
Counterpart of ``repro/obs/sink.py``.

A :class:`MetricsSink` owns one run directory::

    run_dir/
      manifest.json    resolved config, device, torch version, git SHA, host
      metrics.jsonl    one JSON object per line (see repro_torch.obs)

The JSONL file is opened in append mode and every event is flushed on
write, so a killed run leaves a valid (truncated) log and a resumed run
appends to the same file after a ``{"event": "resume"}`` marker.  Values
are host types only: scalars become floats (non-finite -> ``null``),
``(W,)`` vector metrics become lists.  Keys starting with ``_`` never reach
the log.  Tensor metrics are copied to the host once per call: one
``.cpu()`` a metric for a block's stacked rows (:meth:`MetricsSink
.log_rounds`), never one a round.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["MetricsSink", "jsonable_metrics", "read_events",
           "run_manifest"]


def _host(v) -> np.ndarray:
    """A metric value as a numpy array: a tensor is copied to the host
    (bf16 read as f32), a number or list wrapped."""
    if hasattr(v, "detach"):
        t = v.detach()
        if t.dtype.is_floating_point and t.element_size() < 4:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(v)


def _jsonable_scalar(x: float) -> Optional[float]:
    x = float(x)
    return x if math.isfinite(x) else None


def jsonable_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """One round's metrics -> a JSON-serialisable dict.

    Scalars -> float (non-finite -> None); higher-rank values -> (nested)
    lists of the same; ``_``-private keys dropped.
    """
    out = {}
    for k, v in metrics.items():
        if k.startswith("_"):
            continue
        a = _host(v)
        if a.ndim == 0:
            out[k] = _jsonable_scalar(a)
        else:
            out[k] = [_jsonable_scalar(x) for x in a.reshape(-1)]
    return out


def _card() -> Dict[str, Any]:
    """The card's name, count and power limit as ``nvidia-smi`` reports
    them, where torch sees one."""
    import torch

    out: Dict[str, Any] = {"torch_version": torch.__version__,
                           "cuda_available": torch.cuda.is_available()}
    if not out["cuda_available"]:
        return out
    out["device_name"] = torch.cuda.get_device_name(0)
    out["device_count"] = torch.cuda.device_count()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if smi.returncode == 0:
            out["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def run_manifest(**fields) -> Dict[str, Any]:
    """Base manifest: git SHA + host + torch and card info (the card's name
    and its power limit from ``nvidia-smi``), overlaid with any caller
    ``fields`` (resolved configs, CLI args, ...)."""
    import platform
    man: Dict[str, Any] = {
        "host": platform.node(),
        "platform": platform.platform(),
        "python": platform.python_version(),
    }
    man.update(_card())
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        if sha.returncode == 0:
            man["git_sha"] = sha.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    man.update(fields)
    return man


class MetricsSink:
    """Append-mode JSONL writer for one run directory.

    ``resume=False`` starts a fresh log (truncates ``metrics.jsonl`` and
    rewrites the manifest); ``resume=True`` keeps both and appends a
    ``{"event": "resume", "round": r}`` marker via :meth:`log_resume`.
    """

    def __init__(self, run_dir: str, resume: bool = False):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self.manifest_path = os.path.join(run_dir, "manifest.json")
        if not resume:
            for p in (self.path, self.manifest_path):
                if os.path.exists(p):
                    os.remove(p)
        self._f = open(self.path, "a")

    # -- events ----------------------------------------------------------
    def log_event(self, event: str, **fields) -> None:
        rec = {"event": event, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_round(self, r: int, metrics: Dict[str, Any]) -> None:
        self.log_event("round", round=int(r),
                       metrics=jsonable_metrics(metrics))

    def log_rounds(self, start: int, stacked: Dict[str, Any]) -> None:
        """Emit one ``round`` event per round of a ``(T, ...)``-stacked
        metrics dict (a block of rounds) — NOT just the last row.  Each
        metric is copied to the host once."""
        clean = {k: _host(v) for k, v in stacked.items()
                 if not k.startswith("_")}
        if not clean:
            return
        T = next(iter(clean.values())).shape[0]
        for i in range(T):
            self.log_round(start + i, {k: v[i] for k, v in clean.items()})

    def log_block(self, r: int, seconds: float, rounds: int) -> None:
        self.log_event("block", round=int(r), seconds=float(seconds),
                       rounds=int(rounds))

    def log_resume(self, r: int) -> None:
        self.log_event("resume", round=int(r))

    def log_done(self, rounds: int, seconds: float) -> None:
        self.log_event("done", rounds=int(rounds), seconds=float(seconds))

    # -- manifest --------------------------------------------------------
    def write_manifest(self, manifest: Dict[str, Any]) -> None:
        """Write ``manifest.json`` (no-op on resume if one already exists,
        so the original run's record is preserved)."""
        if os.path.exists(self.manifest_path):
            return
        with open(self.manifest_path, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True, default=str)
            f.write("\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(run_dir: str) -> list:
    """Parse ``metrics.jsonl`` from ``run_dir`` (list of dicts)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
