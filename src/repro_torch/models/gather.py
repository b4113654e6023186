"""The gathered forward: a model whose parameters each rank holds as its
(fsdp, model) shard runs on the full parameters of each product it does
not partition, one stacked layer at a time.

Under a model-parallel mesh the JAX package's θ leaves carry their model
and fsdp shardings and XLA partitions the forward; the semantics are each
worker's loss on its full parameters.  The port keeps θ shard-local and
gathers on the way in: :func:`gather_params` all-gathers the unstacked
leaves (embedding, head, norms) whole, and the stacked leaves of
``transformer.STACKED_KEYS`` only along their entry dim where the grid
shards that dim; ``transformer.run_stacked`` then gathers the rest of each
entry inside its checkpointed block (:func:`gather_entry`), so the
backward's recompute gathers again and only one full layer is alive.

Where the plan carries a :class:`~repro_torch.models.partition.Partition`
(the trainer's and the serving layer's plans, for every family), the
leaves of the partitioned products are gathered over their fsdp dims
only: each rank computes its own heads, ff columns, experts, inner or
RG-LRU channels and vocab rows on its ``model`` block
(``models/partition.py``), as XLA partitions the reference's products.  The fsdp axes keep their gather, as XLA's FSDP
does.

The gather's backward (:class:`_Gather`) narrows the full gradient to the
rank's own slice where every rank of the gathered axis computed it alike
(the same products on the same batch).  Where the ranks of the axis hold
different rows of the batch (the sketched mode's FSDP over the data axes,
:attr:`GatherPlan.reduce`) the full gradient is summed over the axis
first: an all-reduce and then the narrow, or, with
:attr:`GatherPlan.scatter` (``REPRO_OPT=rs_grads``), one reduce-scatter
that leaves each rank its slice of the sum.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Tensor = torch.Tensor
PyTree = Any
#: a mesh axis, or a tuple of axes taken as one
Axis = Union[str, Sequence[str]]
#: a leaf's sharded element dims: ((dim, mesh axis), ...)
Dims = Tuple[Tuple[int, Axis], ...]


class GatherPlan(NamedTuple):
    """How to rebuild full parameters from a rank's shards."""

    mesh: Any
    dims: PyTree        # params' structure; each leaf a :data:`Dims`
    lead: int           # leading worker dims of the leaves
    #: mesh axes whose ranks hold different batch rows: a gather over them
    #: sums the gradient over them in its backward
    reduce: Tuple[str, ...] = ()
    #: that sum as a reduce-scatter (``REPRO_OPT=rs_grads``), else an
    #: all-reduce and a narrow
    scatter: bool = False
    #: the products that split over ``model`` (``models/partition``), whose
    #: leaves keep their model block; None: every product whole
    part: Any = None


_ACTIVE: dict = {"plan": None}


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def make_plan(params: PyTree, model_dims, fsdp_dims, mesh, lead: int = 1,
              model_axis: str = "model", fsdp_axis: Axis = "fsdp",
              reduce: Tuple[str, ...] = (), part=None) -> GatherPlan:
    """The plan of a params tree (its flatten order) from its per-leaf
    model and fsdp element dims (``launch.shardings.shard_dims_2d``).
    ``fsdp_axis`` is an axis or a tuple of them (the data axes, where the
    fsdp dim rides them); an axis of size 1 gathers nothing and is left
    out.  With ``part`` (``partition.partition_for``), the leaves of the
    partitioned products are not gathered over ``model_axis``."""
    from repro_torch.models import partition as _partition

    treedef = tree_flatten(params)[1]
    model_dims = _partition.model_dims(params, model_dims, part)

    def size(axis: Axis) -> int:
        return math.prod(mesh.shape.get(a, 1) for a in _names(axis))

    n_model, n_fsdp = size(model_axis), size(fsdp_axis)
    leaves = []
    for md, fd in zip(model_dims, fsdp_dims):
        pairs = []
        if md is not None and n_model > 1:
            pairs.append((md, model_axis))
        if fd is not None and n_fsdp > 1:
            pairs.append((fd, fsdp_axis))
        leaves.append(tuple(pairs))
    return GatherPlan(mesh, tree_unflatten(treedef, leaves), lead,
                      tuple(reduce), part=part)


@contextlib.contextmanager
def gathering(plan: Optional[GatherPlan]):
    """Make ``plan`` the one :func:`gather_params` and ``run_stacked``
    read in the enclosed code (None: no gathering)."""
    prev = _ACTIVE["plan"]
    _ACTIVE["plan"] = plan
    try:
        yield
    finally:
        _ACTIVE["plan"] = prev


def current() -> Optional[GatherPlan]:
    return _ACTIVE["plan"]


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis`` (counted as ``op`` in
    ``Mesh.stats``); the backward narrows the full gradient to this rank's
    slice, after summing it over the axis where ``reduce`` (all-reduce
    then narrow, or a reduce-scatter where ``scatter``)."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh, axis: Axis, dim: int, reduce: bool,
                scatter: bool, op: str = "all_gather") -> Tensor:
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.reduce, ctx.scatter = reduce, scatter
        ctx.width = x.shape[dim]
        return mesh.all_gather(x.detach(), axis, dim, op=op)

    @staticmethod
    def backward(ctx, g: Tensor):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if ctx.reduce and ctx.scatter:
            out = mesh.reduce_scatter(g, axis, dim)
        else:
            if ctx.reduce:
                g = mesh.psum(g, axis)
            i = mesh.axis_index(axis)
            out = g.narrow(dim, i * ctx.width, ctx.width)
        return out, None, None, None, None, None, None


def _gather_leaf(x: Tensor, pairs: Dims, plan: GatherPlan,
                 offset: int) -> Tensor:
    for d, axis in pairs:
        reduce = set(_names(axis)) <= set(plan.reduce)
        x = _Gather.apply(x, plan.mesh, axis, offset + d, reduce,
                          plan.scatter)
    return x


def gather_params(params: PyTree, plan: Optional[GatherPlan] = None
                  ) -> PyTree:
    """``params`` (this rank's shards) with every unstacked leaf gathered
    whole and every stacked leaf gathered along its entry dim where it is
    sharded there; the identity without a plan."""
    from repro_torch.models.transformer import STACKED_KEYS

    plan = plan or current()
    if plan is None:
        return params
    out = {}
    for key, sub in params.items():
        dims = plan.dims[key]
        if key in STACKED_KEYS and isinstance(sub, dict):
            out[key] = tree_map(lambda x, p: _gather_leaf(
                x, tuple(q for q in p if q[0] == 0), plan, plan.lead),
                sub, dims)
        else:
            out[key] = tree_map(lambda x, p: _gather_leaf(
                x, p, plan, plan.lead), sub, dims)
    return out


def gather_entry(plan: Optional[GatherPlan], entry: PyTree,
                 key: str) -> PyTree:
    """One stacked entry of ``params[key]`` (leaves ``leaf[:, i]``, the
    entry dim gone) with its other sharded dims gathered."""
    if plan is None:
        return entry
    return tree_map(lambda x, p: _gather_leaf(
        x, tuple((d - 1, a) for d, a in p if d > 0), plan, plan.lead),
        entry, plan.dims[key])
