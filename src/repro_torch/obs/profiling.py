"""Profiling hooks: trace ranges, a trace session, wall-clock spans.
Counterpart of ``repro/obs/profiling.py``.

* :func:`annotate` — a ``torch.profiler.record_function`` range, which
  shows in a trace as a span on the host and around the kernels it
  launched.
* :func:`trace_session` — ``torch.profiler.profile`` over the CPU and, where
  there is a card, CUDA activity, writing a Chrome trace into a directory.
  As in the JAX package, a profiler that fails to start or stop does not
  kill the run; the session's :attr:`TraceSession.path` is None then, so a
  caller that needs the trace (``chip_smoke.py``) can fail on its own.
* :class:`SpanTimer` — wall-clock spans accumulated into a
  JSON-serialisable dict, as in the JAX package.
* :func:`compile_report` — the static report of one dispatch from the dry
  run's trace of it (``launch/trace_analysis.py``, in place of the
  reference's HLO analysis): flops, HBM bytes, per-collective bytes and
  calls, written as ``compile_report.json`` next to the run's JSONL.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

__all__ = ["annotate", "trace_session", "TraceSession", "SpanTimer",
           "compile_report"]

#: the Chrome trace :func:`trace_session` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def annotate(name: str):
    """A named ``torch.profiler.record_function`` range (free when no
    profiler is running)."""
    import torch

    with torch.profiler.record_function(name):
        yield


class TraceSession:
    """What :func:`trace_session` yields: ``path`` is the Chrome trace once
    the session has closed and written it, else None; ``profiler`` the
    running ``torch.profiler.profile`` (None if it failed to start), whose
    ``key_averages()`` a caller may read after the session."""

    def __init__(self):
        self.path: Optional[str] = None
        self.profiler = None
        self.error: Optional[str] = None


@contextlib.contextmanager
def trace_session(trace_dir: Optional[str]):
    """Profile the enclosed code with ``torch.profiler`` and write
    ``trace_dir/trace.json`` (a Chrome trace) when it ends.

    ``None`` disables tracing.  Profiler failures (no CUPTI, a profiler
    already running) are recorded in the session's ``error`` and swallowed,
    so ``--profile`` can never turn a working run into a crash.
    """
    sess = TraceSession()
    if not trace_dir:
        yield sess
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
        sess.profiler = prof
    except Exception as e:  # a profiler fault must not kill the run
        sess.error = f"start: {e}"
    try:
        yield sess
    finally:
        if sess.profiler is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                sess.profiler.__exit__(None, None, None)
                path = os.path.join(trace_dir, TRACE_FILE)
                sess.profiler.export_chrome_trace(path)
                sess.path = path
            except Exception as e:  # as above: report, do not raise
                sess.error = f"stop: {e}"


class SpanTimer:
    """Named wall-clock spans, accumulated + counted.

    >>> t = SpanTimer()
    >>> with t.span("execute"): run_block()
    >>> t.summary()["execute"]["seconds"]
    """

    def __init__(self):
        self.spans: Dict[str, Dict[str, float]] = {}
        #: per-span list of individual durations (s/round series etc.)
        self.series: Dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            s = self.spans.setdefault(name, {"seconds": 0.0, "count": 0.0})
            s["seconds"] += dt
            s["count"] += 1.0
            self.series.setdefault(name, []).append(dt)

    def add(self, name: str, seconds: float) -> None:
        s = self.spans.setdefault(name, {"seconds": 0.0, "count": 0.0})
        s["seconds"] += float(seconds)
        s["count"] += 1.0
        self.series.setdefault(name, []).append(float(seconds))

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.spans.items()}


def compile_report(summary, path: Optional[str] = None,
                   **extra) -> Dict[str, Any]:
    """The compile report of one traced dispatch
    (``launch.trace_analysis.TraceSummary``), the reference's keys with
    ``collective_calls`` in place of ``collective_permutes``::

        {"flops": ..., "mem_bytes": ..., "coll_bytes": {...},
         "coll_count": {...}, "coll_bytes_total": ...,
         "collective_calls": ..., **extra}

    ``extra`` fields (``trace_seconds``, ``rounds_per_dispatch``) are
    merged verbatim; with ``path`` the report is written there as JSON."""
    from repro_torch.launch.trace_analysis import collective_calls

    rep: Dict[str, Any] = {
        "flops": summary.flops,
        "mem_bytes": summary.mem_bytes,
        "coll_bytes": dict(summary.coll_bytes),
        "coll_count": dict(summary.coll_count),
        "coll_bytes_total": summary.coll_bytes_total,
        "collective_calls": collective_calls(summary),
    }
    rep.update(extra)
    if path is not None:
        with open(path, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True)
            f.write("\n")
    return rep
