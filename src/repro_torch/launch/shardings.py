"""Sharding policy: which dims of a parameter (or of a like-shaped dual or
channel) leaf a (data, fsdp, model) mesh splits, per arch and mesh.  The
port's counterpart of ``repro/launch/shardings.py``, rule for rule.

A spec is a tuple with one entry a dim: a mesh axis name, a tuple of axis
names, or None (replicated on that dim).  The rules:

* params: the big matmul dims shard over ``model`` (:data:`_LAST_DIM_MODEL`
  on the last dim, :data:`_PREV_DIM_MODEL` on the one before it, the moe
  expert tensors on the expert dim, the embedding ``table`` on the vocab
  dim, MLA's ``wk_b``/``wv_b`` on the head dim) and a second dim over the
  fsdp axes (:func:`fsdp_axes`);
* a dim shards only where its size divides the axis (``ok``);
* replicated-FL state: the leading worker dim over the data axes.

:func:`shard_dims_2d` is the contract with ``core.packing.ShardPackSpec``:
each rank packs exactly the slice these specs make resident on it.  A mesh
is anything with ``shape`` (axis -> size) and ``axis_names``: a
``launch.mesh.Mesh`` or, for layout checks without ranks, a
``launch.mesh.MeshShape``.  :func:`cache_pspecs` are the decode caches'
specs: every family's decode holds its block of them
(``serve/serving.py``, ``models/partition.partition_for``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_flatten, tree_paths, tree_unflatten

PyTree = Any
Spec = Tuple[Any, ...]

#: param names whose LAST dim shards over model
_LAST_DIM_MODEL = (
    "wq", "wk", "wv", "gate", "up", "fc_in", "wq_a", "wq_b", "wkv_a",
    "in_proj", "x_proj", "w_gelu", "w_rec", "gate_a", "gate_x", "router",
    "projector", "mtp_proj",
)
#: param names whose SECOND-TO-LAST dim shards over model
_PREV_DIM_MODEL = ("wo", "down", "fc_out", "out_proj", "dt_proj", "w_out")
#: moe expert tensors: (E, d, f) — expert dim (-3) over model
_EXPERT = ("gate", "up", "down")


def _shape(leaf) -> Tuple[int, ...]:
    t = getattr(leaf, "re", leaf)
    return tuple(t.shape)


def fsdp_axes(mesh, *, worker_dim: bool,
              multi_pod: bool) -> Optional[Tuple[str, ...]]:
    """Mesh axes that carry the FSDP parameter dim: a dedicated ``fsdp``
    axis; without one, the data axes for state WITHOUT a leading worker
    dim (a (W, ...) leaf spends them on its worker dim)."""
    if "fsdp" in mesh.axis_names:
        return ("fsdp",)
    if not worker_dim:
        return data_axes(multi_pod)
    return None


def param_pspec(names: Tuple[str, ...], leaf_shape: Tuple[int, ...],
                cfg: ModelConfig, mesh, *, worker_dim: bool, fsdp: bool,
                multi_pod: bool) -> Spec:
    """Spec of one parameter (or like-shaped dual/channel) leaf reached by
    the path ``names``."""
    name = next((n for n in reversed(names) if n not in ("re", "im", "w", "b",
                                                         "mu", "nu")), "")
    ndim = len(leaf_shape)
    spec: list = [None] * ndim
    daxes = data_axes(multi_pod)
    model_n = mesh.shape["model"]
    faxes = fsdp_axes(mesh, worker_dim=worker_dim, multi_pod=multi_pod) \
        if fsdp else None
    f_entry = (faxes if len(faxes) > 1 else faxes[0]) if faxes else None
    f_n = axis_size(mesh, faxes) if faxes else 0

    lead = 0
    if worker_dim:
        spec[0] = daxes if len(daxes) > 1 else daxes[0]
        lead = 1

    def ok(dim_idx: int, axis_n: int) -> bool:
        return (dim_idx >= lead and leaf_shape[dim_idx] % axis_n == 0
                and leaf_shape[dim_idx] >= axis_n)

    def f_ok(dim_idx: int) -> bool:
        return f_entry is not None and ok(dim_idx, f_n)

    # moe expert tensors: trailing (E, d, f)
    if name in _EXPERT and ndim - lead >= 3 and "layers" in "".join(names):
        e_dim = ndim - 3
        if (cfg.n_experts and leaf_shape[e_dim] == cfg.n_experts
                and ok(e_dim, model_n)):
            spec[e_dim] = "model"
            if f_ok(ndim - 2):
                spec[ndim - 2] = f_entry
            return tuple(spec)

    if name == "table":  # embedding (V, D)
        if ok(ndim - 2, model_n):
            spec[ndim - 2] = "model"
        if f_ok(ndim - 1):
            spec[ndim - 1] = f_entry
        return tuple(spec)

    if name in ("wk_b", "wv_b"):  # MLA decompression (H, c, hd)
        if ok(ndim - 3, model_n):
            spec[ndim - 3] = "model"
        return tuple(spec)

    if name in _LAST_DIM_MODEL and ndim - lead >= 2:
        if ok(ndim - 1, model_n):
            spec[ndim - 1] = "model"
        if f_ok(ndim - 2):
            spec[ndim - 2] = f_entry
        return tuple(spec)

    if name in _PREV_DIM_MODEL and ndim - lead >= 2:
        if ok(ndim - 2, model_n):
            spec[ndim - 2] = "model"
        if f_ok(ndim - 1):
            spec[ndim - 1] = f_entry
        return tuple(spec)

    # conv weights, norms, biases, scalars: replicated (bar the worker dim)
    return tuple(spec)


def tree_pspecs(tree: PyTree, cfg: ModelConfig, mesh, *, worker_dim: bool,
                fsdp: bool, multi_pod: bool) -> PyTree:
    """:func:`param_pspec` over a tree (a Complex leaf takes its planes'
    spec) -> the tree of specs."""
    treedef = tree_flatten(tree)[1]
    return tree_unflatten(treedef, [
        param_pspec(p, _shape(v), cfg, mesh, worker_dim=worker_dim,
                    fsdp=fsdp, multi_pod=multi_pod)
        for p, v in tree_paths(tree)])


def _entry_axes(entry) -> Tuple[str, ...]:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def model_shard_dims(tree: PyTree, cfg: ModelConfig, mesh, *,
                     multi_pod: bool, worker_dim: bool = True
                     ) -> Tuple[Optional[int], ...]:
    """Per-leaf ELEMENT-dim index sharded over ``model`` (None: replicated
    on it), in flatten order; element dims skip the worker dim."""
    lead = 1 if worker_dim else 0
    dims = []
    for p, v in tree_paths(tree):
        spec = param_pspec(p, _shape(v), cfg, mesh, worker_dim=worker_dim,
                           fsdp=False, multi_pod=multi_pod)
        dim = None
        for k, entry in enumerate(spec):
            if "model" in _entry_axes(entry):
                dim = k - lead
        dims.append(dim)
    return tuple(dims)


def shard_dims_2d(tree: PyTree, cfg: ModelConfig, mesh, *, multi_pod: bool,
                  worker_dim: bool = True
                  ) -> Tuple[Tuple[Optional[int], ...],
                             Tuple[Optional[int], ...]]:
    """Per-leaf ``(model_dims, fsdp_dims)`` ELEMENT-dim indices: the 2-D
    layout contract between :func:`param_pspec` and ``ShardPackSpec``."""
    lead = 1 if worker_dim else 0
    faxes = fsdp_axes(mesh, worker_dim=worker_dim, multi_pod=multi_pod)
    fset = frozenset(faxes or ())
    mdims, fdims = [], []
    for p, v in tree_paths(tree):
        spec = param_pspec(p, _shape(v), cfg, mesh, worker_dim=worker_dim,
                           fsdp=True, multi_pod=multi_pod)
        md = fd = None
        for k, entry in enumerate(spec):
            if k < lead:
                continue
            axes = _entry_axes(entry)
            if "model" in axes:
                md = k - lead
            elif fset and fset & {a for a in axes if a}:
                fd = k - lead
        mdims.append(md)
        fdims.append(fd)
    return tuple(mdims), tuple(fdims)


def cache_pspec(names: Tuple[str, ...], leaf_shape: Tuple[int, ...],
                cfg: ModelConfig, mesh, batch: int, *,
                multi_pod: bool) -> Spec:
    """Spec of one decode-cache leaf reached by the path ``names``: the
    batch dim over the data axes where the batch divides them; K/V heads
    over ``model`` where they divide it, else the sequence (over every axis
    when the batch cannot shard); MLA's latent cache on the sequence; the
    SSM and recurrent states on their channel dim."""
    name = names[-1]
    ndim = len(leaf_shape)
    daxes = data_axes(multi_pod)
    d_n = axis_size(mesh, daxes)
    model_n = mesh.shape["model"]
    batch_ok = batch % d_n == 0 and batch >= d_n
    b_spec = (daxes if len(daxes) > 1 else daxes[0]) if batch_ok else None
    #: when batch can't shard, spread the sequence over every axis
    seq_axes = "model" if batch_ok else (daxes + ("model",) if len(daxes) > 1
                                         else (daxes[0], "model"))

    def seq_spec(T: int):
        n = model_n if batch_ok else model_n * d_n
        return seq_axes if (T % n == 0 and T >= n) else (
            "model" if T % model_n == 0 and T >= model_n else None)

    # locate the batch dim: caches are (L?, B, ...) or (B, ...)
    b_dim = 1 if ndim >= 2 and leaf_shape[0] != batch else 0
    if leaf_shape[b_dim] != batch:
        b_dim = next((i for i, n in enumerate(leaf_shape) if n == batch),
                     None)

    spec: list = [None] * ndim
    if b_dim is not None:
        spec[b_dim] = b_spec

    if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
        # (..., B, T, KV, hd): heads over `model` where they divide it,
        # else the sequence dim
        if leaf_shape[ndim - 2] % model_n == 0 and \
                leaf_shape[ndim - 2] >= model_n:
            spec[ndim - 2] = "model"
        else:
            spec[ndim - 3] = seq_spec(leaf_shape[ndim - 3])
    elif name in ("c_kv", "k_rope"):
        # (..., B, T, c)
        spec[ndim - 2] = seq_spec(leaf_shape[ndim - 2])
    elif name == "ssm":
        # (L, B, di, n)
        if leaf_shape[ndim - 2] % model_n == 0:
            spec[ndim - 2] = "model"
    elif name in ("conv", "lru"):
        # (..., B, W-1, di/dw) and (..., B, dw)
        if leaf_shape[ndim - 1] % model_n == 0:
            spec[ndim - 1] = "model"
    return tuple(spec)


def cache_pspecs(cache: PyTree, cfg: ModelConfig, mesh, batch: int, *,
                 multi_pod: bool) -> PyTree:
    """:func:`cache_pspec` over a cache tree -> the tree of specs."""
    treedef = tree_flatten(cache)[1]
    return tree_unflatten(treedef, [
        cache_pspec(p, tuple(v.shape), cfg, mesh, batch,
                    multi_pod=multi_pod)
        for p, v in tree_paths(cache)])


def shard_leaf(x, spec: Spec, mesh):
    """The block of ``x`` a rank at ``mesh``'s coordinates holds under
    ``spec`` (views, narrowed on every sharded dim)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = axis_size(mesh, entry)
        if n > 1:
            w = x.shape[d] // n
            x = x.narrow(d, mesh.axis_index(entry) * w, w)
    return x


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh
                ) -> Tuple[int, ...]:
    """The shape of a rank's block of a ``shape`` leaf under ``spec``."""
    return tuple(n // (axis_size(mesh, e) if e is not None else 1)
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def batch_pspec(shape: Tuple[int, ...], mesh, batch_dim: int,
                multi_pod: bool) -> Spec:
    """The batch dim over the data axes where it divides them."""
    daxes = data_axes(multi_pod)
    d_n = axis_size(mesh, daxes)
    spec: list = [None] * len(shape)
    if shape[batch_dim] % d_n == 0 and shape[batch_dim] >= d_n:
        spec[batch_dim] = daxes if len(daxes) > 1 else daxes[0]
    return tuple(spec)


def rules_for(cfg: ModelConfig, mesh, *, multi_pod: bool,
              decode: bool = False, fl_replicated: bool = False) -> dict:
    """Logical-axis bindings specialised to the arch's divisibilities: a
    head-type axis binds to ``model`` only where its count divides it."""
    from repro_torch import optflags
    from repro_torch.models.sharding import DEFAULT_RULES

    del decode
    rules = dict(DEFAULT_RULES)
    model_n = mesh.shape["model"]
    daxes = data_axes(multi_pod)
    batch_axes = daxes if len(daxes) > 1 else daxes[0]
    rules["batch"] = batch_axes
    rules["worker"] = batch_axes
    if fl_replicated:
        # the worker dim consumes the data axes; the inner per-worker batch
        # stays unsharded
        rules["batch"] = None
        rules["moe_group"] = None

    def fits(n: int) -> bool:
        return n >= model_n and n % model_n == 0

    if not fits(cfg.n_heads):
        rules["heads"] = None
    if not fits(cfg.n_kv_heads):
        rules["kv_heads"] = None
    else:
        # cache: head-sharding wins; seq must not also claim `model`
        rules["kv_seq"] = None
    if cfg.d_ff and not fits(cfg.d_ff):
        rules["ff"] = None
    if cfg.n_experts and not fits(cfg.n_experts):
        rules["expert"] = None
    if cfg.lru_width and not fits(cfg.lru_width):
        rules["lru"] = None
    if cfg.d_inner and not fits(cfg.d_inner):
        rules["inner"] = None
    if not fits(cfg.vocab_size):
        rules["vocab"] = None
    if optflags.enabled("seq_par"):
        rules["res_seq"] = "model"
    return rules
