"""The dry run's cost analysis of one rank's program: the port's
counterpart of ``repro/launch/hlo_analysis.py``.

The reference compiles one partition of the SPMD program and reads the
three roofline inputs from its optimized HLO.  Torch has no HLO, so
:func:`analyze` runs the port's own SPMD code for one rank instead, on
``meta`` tensors (shapes and dtypes, no data) at that rank's resident
shapes, under a ``launch.mesh.FakeMesh``, and counts every aten op it
dispatches:

* **flops** — as ``torch.utils.flop_counter`` counts them: the matrix
  products (mm, bmm, addmm, convolutions, SDPA), elementwise work
  excluded, as ``hlo_analysis`` counts only dots;
* **HBM bytes** — operands + results of every op that is not a view (in
  eager PyTorch every op reads and writes HBM, so this is the port's
  traffic, not an estimate of fusion);
* **collectives** — as the mesh counts them: kinds ``all-reduce`` (psum,
  pmin, pmax, por, the partitioned products' ``copy_to`` and
  ``reduce_from``, and partitioned serving's ``softmax_max``/
  ``softmax_sum`` of a cache split over the sequence and ``vocab_max``/
  ``vocab_min`` of the greedy token), ``all-gather`` (of parameters, and
  serving's ``gather_heads`` of the query heads, ``gather_kv`` of the K
  and V projections and ``gather_vocab`` of the last logits) and
  ``reduce-scatter``, per-rank result bytes × the
  reference's multiplier (all-reduce 2×; ``launch.mesh.COLL_KIND``).  The
  port has no collective-permute; a reshard shows up as extra gathers,
  which :func:`collective_calls` counts.

A while loop in HLO is a Python loop here, which the trace counts as it
runs, so a block of k rounds counts k rounds: loop-corrected by
construction.

The kernels count as the card runs them.  On ``meta`` a kernel wrapper
runs its plain version inside ``kernels.build.plain``; there the trace
drops the plain version's own ops and counts the kernel's bytes instead
(each tensor input read once, each output written once: PERF.md §6's bound
convention) and its flops as the wrapper states them (B11's products on
its causal pairs only, ``kernels/flash_attention.py``).

The trace also follows live bytes: every storage an op makes is held by a
weak reference until torch frees it, so :attr:`TraceSummary.peak_bytes` is
the most the rank holds at once, its arguments included.  All numbers are
per rank; multiply by the rank count for global figures.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

Tensor = torch.Tensor

#: ops that move no data (allocation, metadata); views are told apart by
#: their schema (``OpOverload.is_view``)
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "alias", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "is_contiguous", "set_", "resize_", "_has_compatible_shallow_copy_type",
})


@dataclasses.dataclass
class TraceSummary:
    """One rank's counts; the field names are ``hlo_analysis.HloSummary``'s
    where the quantity is the same."""

    flops: float
    mem_bytes: float
    coll_bytes: Dict[str, float]
    coll_count: Dict[str, float]
    #: live bytes at their peak (arguments included) and the arguments'
    peak_bytes: float = 0.0
    arg_bytes: float = 0.0
    #: per kernel wrapper: calls, flops and bytes the trace counted for it
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: the mesh's own counts, as ``Mesh.stats`` holds them (calls and input
    #: bytes by op), for an exact comparison with a live rank
    mesh_stats: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: flops of the products outside the kernels, by (op, operand shapes,
    #: result shapes)
    products: Dict[tuple, float] = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    seconds: float = 0.0

    @property
    def coll_bytes_total(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def temp_bytes(self) -> float:
        """The peak's bytes beyond the arguments."""
        return max(self.peak_bytes - self.arg_bytes, 0.0)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, Tensor)]


def _nbytes(t: Tensor) -> float:
    return float(t.numel() * t.element_size())


class _Live:
    """Bytes of the storages alive, by weak reference to each storage."""

    def __init__(self):
        self.bytes = 0.0
        self.peak = 0.0
        self._seen: Dict[int, weakref.finalize] = {}

    def add(self, t: Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen and self._seen[key].alive:
            return
        n = float(st.nbytes())
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        self._seen[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: float) -> None:
        self.bytes -= n
        self._seen.pop(key, None)

    def close(self) -> None:
        for f in list(self._seen.values()):
            f.detach()
        self._seen.clear()


class Tracer(TorchDispatchMode):
    """Counts what the enclosed code dispatches (see the module's doc).
    Enter it with ``with Tracer(mesh) as tr:`` around one rank's program;
    :meth:`summary` reads the counts."""

    def __init__(self, mesh=None, args: Sequence = ()):
        super().__init__()
        self.mesh = mesh
        self.flops = 0.0
        self.mem_bytes = 0.0
        self.n_ops = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.products: Dict[tuple, float] = collections.Counter()
        self._depth = 0
        self._live = _Live()
        for t in _tensors(args):
            self._live.add(t)
        self.arg_bytes = self._live.bytes
        self._t0 = 0.0
        self._seconds = 0.0
        self._hook_prev = None

    def __enter__(self):
        if self.mesh is not None:
            self.mesh.reset_stats()
        self._hook_prev = build.set_plain_hook(self._kernel)
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._seconds += time.perf_counter() - self._t0
        build.set_plain_hook(self._hook_prev)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out           # a kernel's plain version: not the card's
        self.n_ops += 1
        pkt = func._overloadpacket
        if pkt in flop_registry:
            f = float(flop_registry[pkt](*args, **kwargs, out_val=out))
            self.flops += f
            key = (pkt.__name__,
                   tuple(tuple(t.shape) for t in _tensors((args, kwargs))),
                   tuple(tuple(t.shape) for t in _tensors(out)))
            self.products[key] += f
        if not func.is_view and pkt.__name__ not in _NO_TRAFFIC:
            outs = _tensors(out)
            self.mem_bytes += sum(map(_nbytes, _tensors((args, kwargs))))
            self.mem_bytes += sum(map(_nbytes, outs))
            for t in outs:
                self._live.add(t)
        return out

    def _kernel(self, name: str, fn: Callable, args, kwargs, flops: float,
                like: Optional[Callable] = None):
        """``kernels.build.plain``'s hook: run the plain version unseen (on
        ``meta`` inputs, ``like()`` where the wrapper gives it), count the
        kernel's reads, writes and flops."""
        ins = _tensors((args, kwargs))
        self._depth += 1
        try:
            if like is not None and all(t.is_meta for t in ins):
                out = like()
            else:
                out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        if self._depth == 0:
            nbytes = (sum(map(_nbytes, ins))
                      + sum(map(_nbytes, _tensors(out))))
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                               "bytes": 0.0})
            k["calls"] += 1
            k["flops"] += float(flops)
            k["bytes"] += nbytes
            self.flops += float(flops)
            self.mem_bytes += nbytes
            for t in _tensors(out):
                self._live.add(t)
        return out

    def summary(self) -> TraceSummary:
        mesh = self.mesh
        coll = getattr(mesh, "coll", {}) if mesh is not None else {}
        stats = {} if mesh is None else mesh_collectives(mesh.stats)
        return TraceSummary(
            flops=self.flops, mem_bytes=self.mem_bytes,
            coll_bytes={k: v["bytes"] for k, v in coll.items()},
            coll_count={k: float(v["count"]) for k, v in coll.items()},
            peak_bytes=self._live.peak, arg_bytes=self.arg_bytes,
            kernels={k: dict(v) for k, v in self.kernels.items()},
            mesh_stats=stats, products=dict(self.products), n_ops=self.n_ops,
            seconds=self._seconds)

    def close(self) -> None:
        self._live.close()


def analyze(fn: Callable, args: Sequence, mesh=None,
            kwargs: Optional[dict] = None) -> TraceSummary:
    """Run ``fn(*args, **kwargs)`` once as one rank of ``mesh`` (a
    ``FakeMesh``, or None for one device) and count it.  ``args`` are
    ``meta`` tensors (trees of them) at the rank's resident shapes."""
    with tracing(mesh, (args, kwargs)) as tr:
        fn(*args, **(kwargs or {}))
    return tr.summary()


@contextlib.contextmanager
def tracing(mesh=None, args: Sequence = ()):
    """``with tracing(mesh, args) as tr:`` counts the enclosed code;
    ``tr.summary()`` afterwards."""
    tr = Tracer(mesh, args)
    try:
        with tr:
            yield tr
    finally:
        tr.close()


def collective_calls(summary: TraceSummary) -> float:
    """Collective calls of one traced dispatch, all kinds: the port's
    reshard tripwire, in place of the reference's
    ``hlo_analysis.collective_permutes`` (the port has no
    collective-permute; a reshard would add gathers)."""
    return float(sum(summary.coll_count.values()))


def mesh_collectives(stats: Dict[str, Dict[str, float]]
                     ) -> Dict[str, Dict[str, float]]:
    """A mesh's ``stats`` (live or traced) as ``{op: {"calls", "bytes"}}``,
    the seconds dropped: the form in which a live rank's collectives and
    the trace's are compared exactly."""
    return {op: {"calls": s["calls"], "bytes": s["bytes"]}
            for op, s in sorted(stats.items())}
