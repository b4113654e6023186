"""Process meshes over ``torch.distributed``: the port's counterpart of
``repro/launch/mesh.py`` and of the collectives the JAX package uses inside
``shard_map``.

A :class:`Mesh` lays the world's ranks out on named axes, ``("data",
"model")`` or ``("data", "fsdp", "model")`` (``"pod"`` in front for a
multi-pod layout), over a ``torch.distributed.device_mesh.DeviceMesh``.
Each rank knows its coordinate on every axis (:meth:`Mesh.axis_index`) and
holds one process group per axis and per tuple of axes
(:meth:`Mesh.group`).  The collectives are the ones the JAX package's
shard-local round, the gathered forward and the partitioned products
need, and no more: :meth:`Mesh.psum` (all-reduce SUM), :meth:`Mesh.pmin`
(MIN), :meth:`Mesh.pmax` (the MIN of the negation), :meth:`Mesh.por` (an
OR as a SUM > 0, as ``tree_ota`` takes it), :meth:`Mesh.all_gather` along
a tensor dim, :meth:`Mesh.reduce_scatter` (the sketched mode's
``rs_grads``) and :meth:`Mesh.all_to_all` (the SSM's ``in_proj`` output
to each rank's channels), each over one axis or a tuple of axes.  A
collective over axes of total size 1 is the identity and touches no
process group.
Partitioned serving's collectives over activations (the query heads'
gather, the split softmax's max and sum, the greedy token's max and min,
the last logits' gather) run through the same methods under names of
their own (:data:`COLL_KIND`), so :attr:`Mesh.stats`'s ``all_gather``
counts the gathers of parameters alone.

The partitioned products (``models/partition.py``) differentiate through
three of them (:func:`copy_to`, :func:`reduce_from`,
:func:`all_to_all`): the identity forward whose backward sums the
gradient over an axis (at the input of a column-split product), the sum
forward whose backward is the identity (at the output of a row-split
product), and the exchange whose backward is the inverse exchange.
Every rank of the axis issues them in the same order, the checkpointed
recompute included, since each runs the same program on its own
columns.

Backend rule (:func:`backend_for`): NCCL where every rank has a card of its
own; gloo where ranks share a card or run on the CPU.  Gloo takes each of
these collectives on CUDA tensors and copies them through the host itself
(with torch 2.11 on an H100 host: all-reduce SUM and MIN,
all-gather, and the all-to-all with uneven and zero counts, so this
module stages none); compute never leaves the card.
Gloo copies on streams of its own, so on CUDA tensors the mesh waits for
the card before each such collective and again before anything reads
what it wrote, which leaves no window for a copy race: one (1, 2) round
on an H100 gave rank 1 a loss 2·10⁻⁵ away from its peer's, which
repeated runs never showed again (``tools/check_mesh_bits.py`` repeats
the round's pieces).

With ``Mesh.timing`` on, every collective synchronises the card before and
after itself and adds its wall time to :attr:`Mesh.stats`, so a caller
reads the collectives' milliseconds a round; every collective adds its
call and its input's bytes there, timed or not, and its calls by the axes
it ran over (``"axes"``: ``{"model": n, "data+model": n}``).

:class:`FakeMesh` (:func:`make_production_mesh`) is the dry run's mesh:
the reference's 16 × 16 or 2 × 16 × 16 production layout seen from rank
0, with no process group.  Its collectives communicate nothing: they run
the local copies a rank would, return the result's shape and count
themselves in :attr:`Mesh.stats` as the live mesh does, and in
:attr:`FakeMesh.coll` by the reference's collective kinds.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Axes = Union[str, Sequence[str]]


def backend_for(device, local_world_size: int,
                n_cards: Optional[int] = None) -> str:
    """``"nccl"`` where each of the host's ``local_world_size`` ranks has a
    card of its own, else ``"gloo"`` (ranks sharing a card, or the CPU).
    NCCL refuses two ranks on one device, so this is a rule, not a
    fallback."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    return "nccl" if n_cards >= local_world_size else "gloo"


def init_distributed(device, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout=None) -> str:
    """Join the default process group (if not joined yet) with the backend
    :func:`backend_for` picks, and return it.  ``rank``/``world_size``
    default to ``torch.distributed.run``'s ``RANK``/``WORLD_SIZE``, and
    ``init_method`` to its ``env://`` rendezvous; a caller spawning its own
    ranks passes a ``file://`` or ``tcp://localhost:<port>`` method, and
    ``timeout`` (a ``datetime.timedelta``) bounds a collective's wait."""
    if dist.is_initialized():
        return dist.get_backend()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend_for(device, local)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kw)
    return backend


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes without ranks or groups (the JAX package's
    ``AbstractMesh``): what the sharding rules read."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> MeshShape:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                         f"{tuple(axes)}")
    return MeshShape(tuple(axes), tuple(int(n) for n in shape))


def _axes(names: Axes) -> Tuple[str, ...]:
    return (names,) if isinstance(names, str) else tuple(names)


class Mesh:
    """The world's ranks on named axes, with this rank's coordinates and
    process groups and the collectives over them.  Build it with
    :func:`make_mesh` once the default process group is up."""

    def __init__(self, device_mesh, device, backend: str):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.backend = backend
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        ranks = device_mesh.mesh.cpu()
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              ranks.shape))
        self._coord = dict(zip(self.axis_names,
                               device_mesh.get_coordinate()))
        self._groups: Dict[Tuple[str, ...], object] = {}
        for a in self.axis_names:
            self._groups[(a,)] = device_mesh.get_group(a)
        # one group family a tuple of two or more axes, created by every
        # rank in the same order (torch orders a group's ranks ascending,
        # so a tuple in mesh order is row-major, fsdp-major for the grid)
        for k in range(2, len(self.axis_names) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                rest = [a for a in self.axis_names if a not in sub]
                perm = ([self.axis_names.index(a) for a in rest]
                        + [self.axis_names.index(a) for a in sub])
                flat = ranks.permute(perm).reshape(
                    -1, math.prod(self.shape[a] for a in sub))
                for row in flat.tolist():
                    g = dist.new_group(sorted(row))
                    if dist.get_rank() in row:
                        self._groups[sub] = g
        self.timing = False
        self.stats: Dict[str, Dict[str, float]] = {}

    # -- layout -------------------------------------------------------------

    def axis_size(self, names: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(names))

    def axis_index(self, names: Axes) -> int:
        """This rank's flat coordinate over ``names`` (row-major in the
        order given)."""
        idx = 0
        for a in _axes(names):
            idx = idx * self.shape[a] + self._coord[a]
        return idx

    def group(self, names: Axes):
        """The process group of this rank over ``names`` (taken in mesh
        order)."""
        key = tuple(a for a in self.axis_names if a in _axes(names))
        return self._groups[key]

    # -- collectives --------------------------------------------------------

    def reset_stats(self) -> None:
        self.stats = {}

    def _run(self, op: str, x: Tensor, fn, inplace: bool = False,
             names: Axes = ()) -> Tensor:
        """``fn(t)`` on ``t``, a contiguous copy of ``x`` (``x`` itself when
        ``inplace`` and contiguous: a collective that only reads it, or a
        plane the caller gives up), counted (and timed when asked) under
        ``op`` in :attr:`stats`, its call also under the axes ``names``."""
        self._wait(x)
        t0 = time.perf_counter()
        out = fn(x if inplace and x.is_contiguous()
                 else x.contiguous().clone())
        self._wait(x)
        s = self.stats.setdefault(op, {"calls": 0, "seconds": 0.0,
                                       "bytes": 0, "axes": {}})
        s["calls"] += 1
        s["seconds"] += time.perf_counter() - t0
        s["bytes"] += x.numel() * x.element_size()
        key = "+".join(_axes(names))
        s["axes"][key] = s["axes"].get(key, 0) + 1
        return out

    def _wait(self, x: Tensor) -> None:
        """Wait for the card: around every collective of gloo (which moves
        CUDA tensors on streams of its own) and, with :attr:`timing`, of
        any backend."""
        if x.is_cuda and (self.timing or self.backend == "gloo"):
            torch.cuda.synchronize(x.device)

    def _reduce(self, op: str, x: Tensor, names: Axes, rop,
                inplace: bool = False) -> Tensor:
        if self.axis_size(names) == 1:
            return x
        group = self.group(names)

        def fn(t):
            dist.all_reduce(t, op=rop, group=group)
            return t
        return self._run(op, x, fn, inplace, names)

    def psum(self, x: Tensor, names: Axes, inplace: bool = False,
             op: str = "psum") -> Tensor:
        """Σ of ``x`` over the ranks of ``names``; ``inplace`` sums into
        ``x`` itself (a plane the caller no longer needs as it was), where
        a copy would hold one more plane.  ``op`` names the call in
        :attr:`stats` (here and below: one of :data:`COLL_KIND`)."""
        return self._reduce(op, x, names, dist.ReduceOp.SUM, inplace)

    def pmin(self, x: Tensor, names: Axes, op: str = "pmin") -> Tensor:
        """Elementwise min of ``x`` over the ranks of ``names``."""
        return self._reduce(op, x, names, dist.ReduceOp.MIN)

    def pmax(self, x: Tensor, names: Axes, op: str = "pmax") -> Tensor:
        """Elementwise max of ``x`` over the ranks of ``names``: the MIN
        of ``-x``, negated (exact)."""
        if self.axis_size(names) == 1:
            return x
        return -self._reduce(op, -x, names, dist.ReduceOp.MIN,
                             inplace=True)

    def por(self, x: Tensor, names: Axes) -> Tensor:
        """Elementwise OR of bool ``x`` over ``names``: a SUM of its f32
        image, then > 0 (the JAX package's ``psum(bad) > 0``)."""
        if self.axis_size(names) == 1:
            return x
        return self._reduce("por", x.to(torch.float32), names,
                            dist.ReduceOp.SUM) > 0.0

    def reduce_scatter(self, x: Tensor, names: Axes, dim: int,
                       op: str = "reduce_scatter") -> Tensor:
        """Σ of ``x`` over the ranks of ``names``, of which this rank keeps
        its slice along ``dim`` (``x``'s ``dim`` cut in the order of
        :meth:`axis_index`)."""
        n = self.axis_size(names)
        if n == 1:
            return x
        group = self.group(names)

        def fn(t):
            parts = [p.contiguous() for p in t.chunk(n, dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=group)
            return out
        # the scatter reads x only: no copy of it
        return self._run(op, x, fn, inplace=True, names=names)

    def all_to_all(self, x: Tensor, names: Axes, send: Sequence[int],
                   recv: Sequence[int]) -> Tensor:
        """``x``'s dim 0 cut into blocks of ``send[j]`` rows, block j to the
        rank of ``names`` at coordinate j (:meth:`axis_index`); returns the
        blocks received, ``recv[j]`` rows from coordinate j, concatenated
        on dim 0 in coordinate order.  A count may be 0."""
        if self.axis_size(names) == 1:
            return x
        group = self.group(names)

        def fn(t):
            out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
            dist.all_to_all_single(out, t, list(recv), list(send),
                                   group=group)
            self._wait(t)        # before anything reads what it wrote
            return out
        # the exchange reads x only: no copy of it
        return self._run("all_to_all", x, fn, inplace=True, names=names)

    def all_gather(self, x: Tensor, names: Axes, dim: int,
                   op: str = "all_gather") -> Tensor:
        """The ranks' ``x`` over ``names`` concatenated along ``dim``, in
        the order of :meth:`axis_index`."""
        n = self.axis_size(names)
        if n == 1:
            return x
        group = self.group(names)

        def fn(t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            self._wait(t)        # before the concatenation reads the parts
            return torch.cat(parts, dim=dim)
        # the gather reads x only: no copy of it
        return self._run(op, x, fn, inplace=True, names=names)


class _CopyTo(torch.autograd.Function):
    """The identity; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: "Mesh", names: Axes) -> Tensor:
        ctx.mesh, ctx.names = mesh, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        return (ctx.mesh._reduce("copy_to", g, ctx.names,
                                 dist.ReduceOp.SUM), None, None)


class _ReduceFrom(torch.autograd.Function):
    """The sum over the axis; the backward is the identity."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: "Mesh", names: Axes) -> Tensor:
        return mesh._reduce("reduce_from", x, names, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None, None


class _AllToAll(torch.autograd.Function):
    """:meth:`Mesh.all_to_all`; the backward sends the gradient back, the
    inverse exchange (``send`` and ``recv`` swapped)."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: "Mesh", names: Axes, send, recv
                ) -> Tensor:
        ctx.mesh, ctx.names, ctx.send, ctx.recv = mesh, names, send, recv
        return mesh.all_to_all(x, names, send, recv)

    @staticmethod
    def backward(ctx, g: Tensor):
        return (ctx.mesh.all_to_all(g, ctx.names, ctx.recv, ctx.send),
                None, None, None, None)


def all_to_all(x: Tensor, mesh: "Mesh", names: Axes, send: Sequence[int],
               recv: Sequence[int]) -> Tensor:
    """:meth:`Mesh.all_to_all` with its gradient (counted as
    ``"all_to_all"`` both ways)."""
    if mesh.axis_size(names) == 1:
        return x
    return _AllToAll.apply(x, mesh, names, tuple(send), tuple(recv))


def copy_to(x: Tensor, mesh: "Mesh", names: Axes) -> Tensor:
    """``x`` at the input of a product each rank of ``names`` computes on
    its own columns: the identity, whose backward sums the ranks' partial
    input gradients (an all-reduce, counted as ``"copy_to"``).  Also how a
    leaf every rank holds whole, read by each rank for its own part (a
    replicated bias sliced to the rank's columns, the K/V projection of
    heads the axis does not split), gets the gradient of the whole
    product."""
    if mesh.axis_size(names) == 1:
        return x
    return _CopyTo.apply(x, mesh, names)


def reduce_from(x: Tensor, mesh: "Mesh", names: Axes) -> Tensor:
    """The sum over the ranks of ``names`` of their partial results of a
    row-split product (an all-reduce in ``x``'s dtype, counted as
    ``"reduce_from"``); the backward hands each rank the whole gradient,
    which every rank holds alike."""
    if mesh.axis_size(names) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, names)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axes`` for the tensors of
    ``device``: rank ``r`` of the default process group sits at the
    row-major coordinate ``r`` of ``shape``.  The mesh must cover the
    world.  An ``fsdp`` axis must divide the data plane: the launcher's
    check (``--fsdp N`` "must divide" the rank count) stands before it."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"ranks but the world has {world}")
    backend = dist.get_backend()
    dev = torch.device(device)
    # the device mesh's type names the groups' backend: gloo's groups are
    # host groups even when their tensors live on a shared card
    kind = "cuda" if backend == "nccl" else "cpu"
    dm = init_device_mesh(kind, shape, mesh_dim_names=axes)
    return Mesh(dm, dev, backend)


def fsdp_mesh_shape(n_ranks: int, fsdp: int) -> Tuple[int, int, int]:
    """The launcher's ``(n // fsdp, fsdp, 1)`` (data, fsdp, model) shape;
    a ValueError that says "must divide" when ``fsdp`` does not."""
    if fsdp < 1 or n_ranks % fsdp:
        raise ValueError(f"--fsdp {fsdp} must divide the rank count "
                         f"({n_ranks})")
    return (n_ranks // fsdp, fsdp, 1)


#: the reference's collective kind of each of the mesh's collectives
COLL_KIND = {"psum": "all-reduce", "pmin": "all-reduce", "por": "all-reduce",
             "pmax": "all-reduce", "copy_to": "all-reduce",
             "reduce_from": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
             # serving's collectives over activations (``models/partition``)
             "gather_heads": "all-gather", "gather_vocab": "all-gather",
             "gather_kv": "all-gather", "gather_proj": "all-gather",
             "softmax_max": "all-reduce", "softmax_sum": "all-reduce",
             "vocab_max": "all-reduce", "vocab_min": "all-reduce",
             # the SSM's decode: the token's channels, dt's partial sums
             "gather_inner": "all-gather", "scatter_inner": "reduce-scatter"}
#: bytes moved per result byte, by kind (the reference's ``_COLL_MULT``:
#: an all-reduce is a reduce-scatter and an all-gather)
COLL_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0}


class FakeMesh(Mesh):
    """A mesh of fake ranks seen from the rank at coordinate 0 on every
    axis: the layout of :class:`Mesh` without a process group, so that one
    process traces one rank's program at a production mesh's shape (the
    dry run, ``launch/trace_analysis.py``) and a live run's default group
    is left alone.  A collective runs the rank's local copies (the
    contiguous clone of a reduced input, the gather's concatenation, the
    scatter's parts), moves nothing, and returns a tensor of the result's
    shape; it counts itself in :attr:`stats` exactly as :class:`Mesh` does
    (calls and input bytes by op) and in :attr:`coll` by the reference's
    kind (``"count"``, and ``"bytes"``: result bytes × :data:`COLL_MULT`).
    Its tensors are the caller's: ``meta`` in the dry run."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device="meta"):
        shape = tuple(int(n) for n in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axes}")
        self.device_mesh = None
        self.device = torch.device(device)
        self.backend = "fake"
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self._coord = {a: 0 for a in axes}
        self._groups = {}
        self.timing = False
        self.stats = {}
        self.coll: Dict[str, Dict[str, float]] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, names: Axes):
        return None

    def reset_stats(self) -> None:
        self.stats = {}
        self.coll = {}

    def _run(self, op: str, x: Tensor, fn, inplace: bool = False,
             names: Axes = ()) -> Tensor:
        out = super()._run(op, x, fn, inplace, names)
        kind = COLL_KIND[op]
        c = self.coll.setdefault(kind, {"count": 0, "bytes": 0.0})
        c["count"] += 1
        c["bytes"] += out.numel() * out.element_size() * COLL_MULT[kind]
        return out

    def _reduce(self, op: str, x: Tensor, names: Axes, rop,
                inplace: bool = False) -> Tensor:
        if self.axis_size(names) == 1:
            return x
        return self._run(op, x, lambda t: t, inplace, names)

    def reduce_scatter(self, x: Tensor, names: Axes, dim: int,
                       op: str = "reduce_scatter") -> Tensor:
        n = self.axis_size(names)
        if n == 1:
            return x

        def fn(t):
            parts = [p.contiguous() for p in t.chunk(n, dim)]
            return torch.empty_like(parts[0])
        return self._run(op, x, fn, inplace=True, names=names)

    def all_to_all(self, x: Tensor, names: Axes, send: Sequence[int],
                   recv: Sequence[int]) -> Tensor:
        if self.axis_size(names) == 1:
            return x
        return self._run("all_to_all", x, lambda t: t.new_empty(
            (sum(recv),) + tuple(t.shape[1:])), inplace=True, names=names)

    def all_gather(self, x: Tensor, names: Axes, dim: int,
                   op: str = "all_gather") -> Tensor:
        n = self.axis_size(names)
        if n == 1:
            return x
        return self._run(op, x, lambda t: torch.cat([t] * n, dim=dim),
                         inplace=True, names=names)


def make_production_mesh(*, multi_pod: bool = False, fsdp: int = 1,
                         device="meta") -> FakeMesh:
    """The reference's production mesh (``repro/launch/mesh.py``) as a
    :class:`FakeMesh`: 16 × 16 ("data", "model") on one pod, 2 × 16 × 16
    ("pod", "data", "model") on two; ``fsdp > 1`` splits the 16-wide data
    plane into ("data", "fsdp")."""
    if fsdp <= 1:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return FakeMesh(shape, axes, device)
    if 16 % fsdp:
        raise ValueError(f"fsdp={fsdp} must divide the 16-wide data plane")
    shape = (2, 16 // fsdp, fsdp, 16) if multi_pod \
        else (16 // fsdp, fsdp, 16)
    axes = ("pod", "data", "fsdp", "model") if multi_pod \
        else ("data", "fsdp", "model")
    return FakeMesh(shape, axes, device)


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    """Mesh axes that jointly carry the batch / FL-worker dimension."""
    return ("pod", "data") if multi_pod else ("data",)


def axis_size(mesh, names: Axes) -> int:
    """Product of the sizes of ``names`` on ``mesh`` (a :class:`Mesh` or a
    :class:`MeshShape`)."""
    return math.prod(mesh.shape[a] for a in _axes(names))
