"""Serving layer: prefill and batched greedy decode over the model API.
Counterpart of ``repro/serve/serving.py``.

``make_serve_step`` makes ONE new token for every sequence of the batch
against a KV/state cache, which it updates in place (JAX donates the
cache to the compiled step).  Prefill is the model's full forward (with
the batch's stub patches or frames for the vlm and the audio enc-dec), so
it runs B11 (dense, vlm, qwen3-moe, the enc-dec's decoder) or B12 (the SSM
and the hybrid's recurrent layers) on the card; MLA is plain einsums.
Decode is plain torch, as the reference computes it outside any kernel;
``generate`` starts the enc-dec from a zero cross cache, as the reference
does (``models/encdec.prefill_cross`` fills it).

On a mesh every family serves partitioned over ``model``
(``models/partition``): the prefill runs each rank's heads, ff columns,
experts, inner or RG-LRU channels and vocab rows, and decode holds the
rank's block of the cache (its KV heads, or its slice of the sequence;
MLA's latent cache on the sequence; the SSM's and the hybrid's states and
conv windows on their channels, the hybrid's attention window on its
slots; the enc-dec's self and cross caches on their KV heads, or each on
its own sequence, its frames, or whole) as the reference's cache specs
lay it out; no rank gathers a partitioned leaf (where the KV heads do not
split, a rank projects its ``wk``/``wv`` columns and gathers the
projections; decode does the same with the router, ``wq_a``, ``wkv_a``
and the SSM's ``x_proj``, which the prefill gathers whole, and
reduce-scatters the SSM's ``dt_proj`` product from its rows).
Neither reads the MTP head, and neither gathers it.  ``generate`` stays
one device's, as the reference's is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import gather as _gather
from repro_torch.models.registry import Model
from repro_torch.tree import tree_map

Tensor = torch.Tensor


#: the enc-dec's encoder, which decode does not read (it decodes against
#: its cross cache, ``models/encdec.prefill_cross``)
DECODE_UNREAD = ("enc_layers", "enc_norm")


def _served(params, decode: bool = False):
    """``params`` without the MTP head's leaves (``partition.MTP_KEYS``),
    which neither the prefill nor decode reads, and, for ``decode``,
    without :data:`DECODE_UNREAD`: none of them is gathered."""
    from repro_torch.models.partition import MTP_KEYS

    drop = MTP_KEYS + (DECODE_UNREAD if decode else ())
    return {k: v for k, v in params.items() if k not in drop}


def _attention_leaf(glob) -> tuple:
    """(name, global shape) of the whole cache's leaf that decides its
    layout: the K leaf (L, B, T, KV, hd), the enc-dec's ``self_k`` of that
    shape, MLA's latent ``c_kv`` (L, B, T, c), or the SSM's state ``ssm``
    (L, B, di, n); the moe family's ``dense`` and ``moe`` stacks share one
    layout, read from the ``moe`` stack's; the hybrid's is its
    super-blocks' attention ``k`` (their RG-LRU state beside it,
    ``partition.partition_for``)."""
    from repro_torch.tree import tree_paths

    leaves: dict = {}
    for path, x in tree_paths(glob.get("moe", glob)):
        leaves.setdefault(path[-1], x)
    name = next(k for k in ("k", "self_k", "c_kv", "ssm") if k in leaves)
    return name, tuple(leaves[name].shape)


def _mesh_layout(model: Model, mesh, fsdp: bool, decode: bool = False):
    """``(layout, shard)``: under ``mesh`` a rank holds its block of every
    parameter (``launch.shardings.tree_pspecs`` with no worker dim: the big
    dims over ``model``, and over the fsdp axes where ``fsdp``);
    ``shard(params)`` cuts that block from the full params and puts the
    gather plan into ``layout["plan"]``, with the products the family
    partitions (``models/partition``, serving's plan: ``layout["part"]``;
    with ``decode``, decode's, which keeps the small projections' columns
    too) kept as each rank's part.  Without a mesh there is no plan and
    ``shard`` is the identity."""
    layout: dict = {"plan": None, "part": None}

    def shard(params):
        if mesh is None:
            return params
        from repro_torch.launch.shardings import (fsdp_axes, shard_leaf,
                                                  tree_pspecs)
        from repro_torch.models.gather import make_plan
        from repro_torch.models.partition import partition_for
        from repro_torch.tree import tree_leaves

        multi_pod = "pod" in mesh.axis_names
        specs = tree_pspecs(params, model.cfg, mesh, worker_dim=False,
                            fsdp=fsdp, multi_pod=multi_pod)
        faxes = fsdp_axes(mesh, worker_dim=False, multi_pod=multi_pod)
        fset = set(faxes or ())
        mdims, fdims = [], []
        for spec in tree_leaves(specs):
            axes = [(d, e if isinstance(e, tuple) else (e,))
                    for d, e in enumerate(spec) if e is not None]
            mdims.append(next((d for d, a in axes if "model" in a), None))
            fdims.append(next((d for d, a in axes if fset & set(a)), None))
        layout["part"] = partition_for(model.cfg, mesh, multi_pod=multi_pod,
                                       serve=True, decode=decode)
        layout["plan"] = make_plan(params, mdims, fdims, mesh, lead=0,
                                   fsdp_axis=faxes or "fsdp",
                                   part=layout["part"])
        layout["specs"] = specs
        # a copy: the block alone, not a view that keeps the full leaf
        return tree_map(lambda x, sp: shard_leaf(x, sp, mesh).clone(
            memory_format=torch.contiguous_format), params, specs)

    return layout, shard


def _batch_specs(cache, specs):
    """(``specs`` with the batch's entry on each leaf's batch dim, the
    paths of the leaves so moved).  ``specs`` are
    ``shardings.cache_pspecs``' of ``cache``.  Every family's cache leads
    with its layer (or stacked entry) dim, then the batch (the hybrid's
    unstacked ``tail`` layers lead with the batch); the reference's rule
    takes a leading dim of the batch's size for the batch's, so where the
    layer count equals the batch it splits the layers over the data axes.
    Here the same entries stand with the data axes on dim 1 instead of
    dim 0."""
    from repro_torch.tree import (tree_flatten, tree_leaves, tree_paths,
                                  tree_unflatten)

    out, moved = [], []
    for (path, x), sp in zip(tree_paths(cache), tree_leaves(specs)):
        if (path[:1] != ("tail",) and x.shape[0] == x.shape[1]
                and sp[0] is not None and sp[1] is None):
            sp = (None, sp[0]) + tuple(sp[2:])
            moved.append("/".join(map(str, path)))
        out.append(sp)
    return tree_unflatten(tree_flatten(cache)[1], out), moved


def make_prefill(model: Model, mesh=None, *, fsdp: bool = False):
    """prefill(params, batch) -> the last position's logits (B, V) of the
    full forward, without autograd.  Under ``mesh`` (a ``launch.mesh``
    mesh, as the trainer takes) a rank holds its block of the parameters
    (``prefill.shard(full)`` cuts it and builds the gather plan; call it
    first) and its rows of the batch.  Each family runs the trainer's
    partitioned forward (``models/partition``: each rank's heads, B11 on
    them, its ff columns, experts, inner or RG-LRU channels, B12 on them,
    and vocab rows) and gathers the last position's vocab-parallel logits
    whole; the router, ``wq_a``, ``wkv_a``, ``x_proj`` and ``dt_proj``
    are gathered whole, since at S tokens their outputs outweigh the
    weights.  No MTP leaf is gathered."""
    layout, shard = _mesh_layout(model, mesh, fsdp)

    def prefill(params, batch):
        with torch.no_grad(), _gather.gathering(layout["plan"]):
            logits, _aux = model.forward(
                _gather.gather_params(_served(params)), batch, remat=True)
            last = logits[:, -1]
            part = layout["part"]
            if part is not None and part.vocab:
                last = part.gather_vocab(last)
            return last

    prefill.shard = shard
    prefill.layout = layout
    return prefill


def make_serve_step(model: Model, mesh=None, *, fsdp: bool = False):
    """serve_step(params, cache, token, pos) -> (next token (B,) int32,
    cache): one greedy step, the cache updated in place.  Under ``mesh``
    the params are the rank's block (``serve_step.shard(full)`` first), the
    tokens the rank's rows of the batch, and the cache the rank's block of
    the whole one as ``launch.shardings.cache_pspecs`` lays it out: the
    batch over the data axes, then, for the dense, vlm and moe families,
    the KV heads over ``model`` or else the sequence (MLA's latent cache:
    the sequence, else the batch alone; ``models/partition``), with the
    router's, ``wq_a``'s and ``wkv_a``'s columns on the rank and their
    one-token outputs gathered; for the ssm family the state and the conv
    window on the rank's channels (``"inner"``), with ``x_proj``'s columns
    and ``dt_proj``'s rows on the rank; for the hybrid its RG-LRU state and
    conv window on the rank's channels and its attention window as the
    dense family's (``"seq"`` for its one KV head); for the audio family
    its self and cross caches on the rank's KV heads, or, where they do
    not split, the self cache on its slots and the cross cache on its
    frames or whole (``Partition.cross_cache``), the encoder's leaves
    neither read nor gathered.  Fill the enc-dec's cross cache with
    ``serve_step.prefill_cross(params, frames)`` (the rank's block; a zero
    cross cache otherwise, as ``generate`` starts from).  Make the cache with
    ``serve_step.init_cache(batch, max_seq, device=...)`` (the rank's
    block, never the whole cache; ``batch`` the whole batch) or cut it
    from a whole one with ``serve_step.shard_cache(full)``: either records
    the layout the step decodes on (``serve_step.layout["cache"]``).  The
    greedy token of the partitioned families is the first maximum of the
    vocab-parallel logits over the ranks (``Partition.argmax_vocab``)."""
    layout, shard = _mesh_layout(model, mesh, fsdp, decode=True)
    layout["cache"] = None

    def cache_specs(glob):
        """The rank's specs of the whole cache ``glob`` (its shapes); puts
        the cache's layout into ``layout``, with the plan's partition that
        decodes on it (``cache_part``)."""
        from repro_torch.launch.mesh import data_axes
        from repro_torch.launch.shardings import (_entry_axes, cache_pspecs,
                                                  shard_shape)
        from repro_torch.models.partition import (SERVE_FAMILIES,
                                                  partition_for)
        from repro_torch.tree import tree_leaves

        multi_pod = "pod" in mesh.axis_names
        batch = tree_leaves(glob)[0].shape[1]
        specs, moved = _batch_specs(glob, cache_pspecs(
            glob, model.cfg, mesh, batch, multi_pod=multi_pod))
        part = None
        if model.cfg.family in SERVE_FAMILIES:
            name, shape = _attention_leaf(glob)
            cross = glob.get("cross_k")
            part = partition_for(
                model.cfg, mesh, multi_pod=multi_pod, cache=shape,
                cache_leaf=name,
                cross=None if cross is None else tuple(cross.shape))
        if part is None:
            daxes = set(data_axes(multi_pod))
            specs = tree_map(lambda _x, sp: tuple(
                e if e is not None and set(_entry_axes(e)) <= daxes
                else None for e in sp), glob, specs)
        layout["cache_part"] = part
        layout["cache"] = "batch" if part is None else part.cache
        layout["cache_specs"] = specs
        layout["cache_batch_moved"] = moved
        layout["cache_shapes"] = [shard_shape(tuple(x.shape), sp, mesh)
                                  for x, sp in zip(tree_leaves(glob),
                                                   tree_leaves(specs))]
        return specs

    def init_cache(batch: int, max_seq: int, dtype=None, device="cuda",
                   **kw):
        """The rank's block of the zero cache of ``batch`` rows and
        ``max_seq`` positions (the whole cache without a mesh)."""
        from repro_torch.device import resolve_device
        from repro_torch.launch.shardings import shard_shape

        if mesh is None:
            return model.init_cache(batch, max_seq, dtype=dtype,
                                    device=device, **kw)
        glob = model.init_cache(batch, max_seq, dtype=dtype, device="meta",
                                **kw)
        dev = resolve_device(device)
        return tree_map(lambda x, sp: torch.zeros(
            shard_shape(tuple(x.shape), sp, mesh), dtype=x.dtype,
            device=dev), glob, cache_specs(glob))

    def shard_cache(full):
        """The rank's block of the whole cache ``full`` (a copy)."""
        from repro_torch.launch.shardings import shard_leaf

        if mesh is None:
            return full
        return tree_map(lambda x, sp: shard_leaf(x, sp, mesh).clone(
            memory_format=torch.contiguous_format), full, cache_specs(full))

    def serve_step(params, cache, token: Tensor, pos: int):
        plan, part = layout["plan"], layout["part"]
        if part is not None:
            from repro_torch.tree import tree_leaves

            shapes = [tuple(x.shape) for x in tree_leaves(cache)]
            if layout["cache"] is None or shapes != layout["cache_shapes"]:
                raise ValueError(
                    f"{model.cfg.name}: the cache {shapes} is not the block "
                    f"of the layout the plan decodes on "
                    f"({layout['cache']}: {layout.get('cache_shapes')}); "
                    f"make it with serve_step.init_cache or .shard_cache")
            part = layout["cache_part"]
            plan = plan._replace(part=part)
        with torch.no_grad(), _gather.gathering(plan):
            logits, cache = model.decode_step(
                _gather.gather_params(_served(params, decode=True)), cache,
                token, pos)
            if part is not None and part.vocab:
                tok = part.argmax_vocab(logits)
            else:
                tok = torch.argmax(logits, dim=-1)
            return tok.to(torch.int32), cache

    def prefill_cross(params, frames: Tensor):
        """The enc-dec's cross K and V of ``frames`` (B, T, d; the rank's
        rows): the encoder's forward under the plan, then each decoder
        layer's projections of its memory (``encdec.prefill_cross``), the
        rank's block of the cross cache as :func:`init_cache` laid it out
        (call it, or :func:`shard_cache`, first)."""
        from repro_torch.models import encdec

        plan = layout["plan"]
        if plan is not None:
            if layout["cache"] is None:
                raise ValueError(f"{model.cfg.name}: the cache's layout is "
                                 f"not known yet; make the cache with "
                                 f"serve_step.init_cache or .shard_cache")
            plan = plan._replace(part=layout["cache_part"])
        with torch.no_grad(), _gather.gathering(plan):
            p = _gather.gather_params(_served(params))
            memory = encdec.encode(p, model.cfg, frames, remat=False)
            return encdec.prefill_cross(p, model.cfg, memory)

    serve_step.shard = shard
    serve_step.init_cache = init_cache
    serve_step.prefill_cross = prefill_cross
    serve_step.shard_cache = shard_cache
    serve_step.layout = layout
    return serve_step


def generate(model: Model, params, prompt_tokens: Tensor, n_steps: int,
             max_seq: Optional[int] = None) -> Tensor:
    """Greedy generation: teacher-forced prompt ingest, then ``n_steps``
    decode steps.  prompt_tokens: (B, S0) on the params' device.  Returns
    the (B, n_steps) int32 generated ids.

    The prompt runs through ``decode_step`` a token at a time, so one cache
    layout serves both phases (the batched prefill is
    :func:`make_prefill`)."""
    B, S0 = prompt_tokens.shape
    max_seq = max_seq or (S0 + n_steps)
    dev = prompt_tokens.device
    cache = model.init_cache(B, max_seq, device=dev)
    step = make_serve_step(model)

    tok = prompt_tokens[:, 0]
    for i in range(1, S0):          # ingest the prompt
        _, cache = step(params, cache, tok, i - 1)
        tok = prompt_tokens[:, i]

    out = []
    pos = S0 - 1
    for i in range(n_steps):
        tok, cache = step(params, cache, tok, pos + i)
        out.append(tok)
    return torch.stack(out, dim=1)
