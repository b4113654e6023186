"""Input specs of every (architecture × input shape × mesh) combination:
the dry run's contract.  Counterpart of ``repro/launch/specs.py``.

Shapes (the reference's assignment sheet):
    train_4k      seq=4,096    global_batch=256   -> train_step
    prefill_32k   seq=32,768   global_batch=32    -> prefill forward
    decode_32k    seq=32,768   global_batch=128   -> serve_step (1 token)
    long_500k     seq=524,288  global_batch=1     -> serve_step (1 token)

long_500k takes the sub-quadratic path: native for ssm/hybrid, the
sliding-window variant (window 4,096) for attention archs.

A :class:`DryRunSpec` holds what the reference's holds: ``args`` are
``meta`` tensors at the reference's GLOBAL shapes and dtypes (the round
key a (2,) uint32 stand-in, as JAX's), ``in_shardings`` the reference's
specs (``launch/shardings.py``: a tuple of mesh axes a dim), the donation
and ``meta``.  It adds what one rank of the port runs: ``local_args``, the
rank's resident arguments, built by the port's own init under the
``FakeMesh`` (``meta`` tensors; the round key and the decode position as
the ints the port takes), ``local_shardings``, the specs that cut
``local_args`` from ``args``, and the ``mesh``; ``fn(*local_args)`` is one
rank's call.

``local_shardings`` equal ``in_shardings`` except where the port holds
more or less than the reference's boundary layout says:

* the replicated mode on a mesh with an ``fsdp`` axis: the port keeps θ,
  Θ, the optimizer state and the (W, d_pad) planes on the (fsdp, model)
  shard grid from the start (the reference's own trainer re-lays them so
  inside its ``shard_map``); a scenario's planes hold every worker's row,
  and the fault state's (W,) liveness is every rank's;
* decode: every family holds the reference's cache block
  (``serving.make_serve_step``'s ``init_cache``: the KV heads over
  ``model`` where they divide it, ``meta["cache_layout"] == "heads"``,
  else the sequence, ``"seq"``; MLA's latent cache on the sequence; the
  SSM's state and conv window on their channels, ``"inner"``; the
  hybrid's RG-LRU state and conv window on their channels beside its
  attention window's layout, ``"seq"``; the enc-dec's self and cross
  caches on their KV heads, or each on its own sequence or whole, its
  layout the self cache's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.cplx import Complex
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import FakeMesh, Mesh, axis_size, data_axes
from repro_torch.models.registry import build_model, get_config
from repro_torch.serve.serving import make_prefill, make_serve_step
from repro_torch.train.llm_trainer import FLConfig, make_fl_train

PyTree = Any
Spec = Tuple[Any, ...]

SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

#: archs whose per-worker copies exceed a device -> sketched FL + 2D params
BIG_ARCHS = ("qwen1.5-110b", "deepseek-v3-671b")

SLIDING_WINDOW_LONG = 4096

META = torch.device("meta")


@dataclasses.dataclass
class DryRunSpec:
    """Everything ``launch/dryrun.py`` needs to trace one combination."""

    fn: Callable
    args: Tuple                      # meta tensors, global shapes
    in_shardings: Tuple
    donate_argnums: Tuple[int, ...]
    meta: Dict[str, Any]
    local_args: Tuple = ()           # one rank's resident arguments
    local_shardings: Tuple = ()
    mesh: Any = None


# ---------------------------------------------------------------------------
# trees of states, specs and shapes
# ---------------------------------------------------------------------------

def _is_nt(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def smap(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over a state tree: NamedTuples
    (states, ``Complex``) field by field, dicts by sorted key, lists item
    by item; a leaf is a tensor, an int or a spec tuple; None stays None."""
    if tree is None:
        return None
    if _is_nt(tree):
        return type(tree)(*(smap(fn, getattr(tree, f),
                                 *(getattr(r, f) for r in rest),
                                 path=path + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: smap(fn, tree[k], *(r[k] for r in rest),
                        path=path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [smap(fn, v, *(r[i] for r in rest), path=path + (f"#{i}",))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def flatten(tree) -> list:
    """``(path, leaf)`` of every leaf, in ``jax.tree_util``'s order for the
    reference's containers (a NamedTuple's fields in order, dict keys
    sorted; None holds no leaf; a spec tuple is one leaf)."""
    out: list = []
    smap(lambda p, x: out.append((p, x)), tree)
    return out


def _meta_like(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _leaf_global(leaf, spec: Spec, mesh) -> torch.Tensor:
    """The global stand-in of a rank's leaf under ``spec``: every sharded
    dim times its axes' size; a host int (a round counter) is a () int32."""
    if not isinstance(leaf, torch.Tensor):
        return _meta_like((), torch.int32)
    shape = [n * (axis_size(mesh, e) if e is not None else 1)
             for n, e in zip(leaf.shape, spec)]
    return _meta_like(shape, leaf.dtype)


def _replicated(tree) -> PyTree:
    return smap(lambda _p, x: (None,) * (x.dim() if isinstance(
        x, torch.Tensor) else 0), tree)


def _pspecs(tree, cfg, mesh, *, worker_dim: bool, fsdp: bool,
            multi_pod: bool) -> PyTree:
    """``shardings.tree_pspecs`` with a ``Complex`` leaf's spec on both its
    planes (the reference's tree of specs)."""
    def one(path, x):
        names = tuple(n for n in path if n not in ("re", "im"))
        return SH.param_pspec(names, tuple(x.shape), cfg, mesh,
                              worker_dim=worker_dim, fsdp=fsdp,
                              multi_pod=multi_pod)
    return smap(one, tree)


def _stacked(params: PyTree, W: int) -> PyTree:
    """``W`` workers' params as (W, ...) ``meta`` stand-ins."""
    return smap(lambda _p, x: _meta_like((W,) + tuple(x.shape), x.dtype),
                params)


def _as_mesh(mesh):
    """A ``FakeMesh`` of ``mesh``'s axes: a live :class:`Mesh` or a
    ``FakeMesh`` is taken as it is, a layout (``MeshShape``) becomes the
    fake-rank mesh at coordinate 0."""
    if isinstance(mesh, Mesh):
        return mesh
    return FakeMesh(tuple(mesh.shape[a] for a in mesh.axis_names),
                    mesh.axis_names)


def _arch_cfg(arch: str, shape_name: str):
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.subquadratic:
        cfg = cfg.with_sliding_window(SLIDING_WINDOW_LONG)
    return cfg


def _modality_extras(cfg, W_or_B: int, batch_inner: Optional[int],
                     seq: int) -> dict:
    """Extra batch fields for vlm/audio (stub frontends), as shapes."""
    extras = {}
    lead = (W_or_B,) if batch_inner is None else (W_or_B, batch_inner)
    if cfg.family == "vlm":
        extras["patches"] = (lead + (cfg.frontend_tokens, cfg.frontend_dim),
                             torch.float32)
    if cfg.family == "audio":
        extras["frames"] = (lead + (max(seq // 4, 16), cfg.d_model),
                            torch.float32)
    return extras


def _text_seq(cfg, seq: int) -> int:
    # vlm: the patch embeddings take part of the sequence budget
    return seq - cfg.frontend_tokens if cfg.family == "vlm" else seq


def _batch(shapes: dict, specs: dict, mesh) -> Tuple[dict, dict]:
    """(global batch, the rank's rows) of ``{name: (shape, dtype)}``:
    tokens int32, the frontends' stubs f32."""
    glob = {k: _meta_like(s, d) for k, (s, d) in shapes.items()}
    local = {k: _meta_like(SH.shard_shape(s, specs[k], mesh), d)
             for k, (s, d) in shapes.items()}
    return glob, local


def _wentry(daxes: Tuple[str, ...]):
    return daxes if len(daxes) > 1 else daxes[0]


def _grid_entry(mesh):
    """The (fsdp, model) shard grid's axes of size > 1, fsdp-major, as one
    spec entry (None: no grid)."""
    grid = tuple(a for a in ("fsdp", "model")
                 if a in mesh.axis_names and mesh.shape[a] > 1)
    return None if not grid else grid[0] if len(grid) == 1 else grid


# ---------------------------------------------------------------------------
# the three kinds
# ---------------------------------------------------------------------------

def build_train_spec(arch: str, mesh, *, multi_pod: bool,
                     reduced: bool = False,
                     transport_backend: Optional[str] = None,
                     train_driver: str = "scan",
                     scenario: Optional[str] = None,
                     packed_uplink: Optional[bool] = None,
                     faults: Optional[Any] = None,
                     guard: Optional[Any] = None,
                     fl_mode: Optional[str] = None,
                     sketch_ratio: int = 256) -> DryRunSpec:
    """The reference's ``build_train_spec``, keyword for keyword: one
    round of the trainer (``train_step``) as one rank of ``mesh``.
    ``fl_mode`` None picks the sketched mode for :data:`BIG_ARCHS` at full
    size, the replicated mode otherwise."""
    if train_driver not in ("scan", "loop"):
        raise ValueError(f"unknown train driver {train_driver!r}")
    if fl_mode not in (None, "replicated", "sketched"):
        raise ValueError(f"unknown fl_mode {fl_mode!r}")
    mesh = _as_mesh(mesh)
    shp = SHAPES["train_4k"]
    cfg = _arch_cfg(arch, "train_4k")
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    daxes = data_axes(multi_pod)
    d_n = axis_size(mesh, daxes)
    seq = 64 if reduced else shp["seq"]
    gbatch = 2 * d_n if reduced else shp["batch"]
    model_parallel = mesh.shape.get("model", 1) > 1
    fsdp_n = mesh.shape.get("fsdp", 1)
    sketched = fl_mode == "sketched" if fl_mode is not None \
        else arch in BIG_ARCHS and not reduced
    W = 8 if sketched else d_n
    flcfg = FLConfig(mode="sketched" if sketched else "replicated",
                     n_workers=W, local_steps=1, local_lr=1e-3,
                     sketch_ratio=sketch_ratio,
                     transport_backend=transport_backend,
                     packed_uplink=None if sketched else packed_uplink,
                     scenario=scenario, faults=faults, guard=guard)
    bw = gbatch // W
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0)
    init_fn, train_step = make_fl_train(model, flcfg, acfg, ccfg, mesh=mesh,
                                        device=META)
    state = init_fn(0)                  # the rank's resident state
    tseq = _text_seq(cfg, seq)
    shapes = {"tokens": ((W, bw, tseq), torch.int32),
              **_modality_extras(cfg, W, bw, seq)}
    wspec = _wentry(daxes)
    kw = dict(cfg=cfg, mesh=mesh, multi_pod=multi_pod)

    # specs from the global shapes: a worker's full params from the
    # model's init on meta
    full = model.init(0, device=META)
    if sketched:
        # Θ on the codec's (fsdp, model) grid; the sketch-space state
        # ((W, d_s) planes, scenario, faults) whole on every rank
        theta_spec = _pspecs(full, worker_dim=False, fsdp=True, **kw)
        state_spec = type(state)(
            Theta=theta_spec, lam=_replicated(state.lam),
            chan=_replicated(state.chan), step=(), flt=_replicated(state.flt))
        local_state_spec = state_spec
        # a worker's batch rows over the data axes where they divide
        batch_spec = {k: (None, wspec if s[1] % d_n == 0 and s[1] >= d_n
                          else None) + (None,) * (len(s) - 2)
                      for k, (s, _) in shapes.items()}
    else:
        packed = isinstance(state.lam, Complex)
        grid = _grid_entry(mesh)
        shard_local = packed and (model_parallel or fsdp_n > 1)
        d_local = state.lam.re.shape[-1] if packed else None
        theta_g = _stacked(full, W)
        plane_ref = (wspec, "model") if model_parallel and packed \
            else (wspec,)
        plane_loc = (wspec, grid if shard_local else None)

        def is_plane(x) -> bool:
            return (isinstance(x, torch.Tensor) and x.dim() == 2
                    and x.shape[-1] == d_local)

        def worker(ref: bool, cplx: bool = False):
            t = _pspecs(theta_g, worker_dim=True, fsdp=not ref, **kw)
            return smap(lambda _p, s: Complex(s, s), t) if cplx else t

        def scenario_spec(ref: bool):
            # every leaf worker-major; the port's rank holds every row, and
            # its shard's columns of the per-element planes
            def one(_p, x):
                if is_plane(x):
                    return plane_ref if ref else (
                        None, grid if shard_local else None)
                if not isinstance(x, torch.Tensor) or x.dim() == 0:
                    return ()
                return ((wspec,) if ref else (None,)) + (None,) * (
                    x.dim() - 1)
            return smap(one, state.chan)

        def flt_spec(ref: bool):
            if state.flt is None:
                return None
            f = state.flt
            return type(f)(
                alive=(wspec,) if ref else (None,),
                stale=None if f.stale is None else
                (plane_ref if ref else plane_loc),
                round=(), n_evicted=())

        def build(ref: bool):
            th = worker(ref)
            p = plane_ref if ref else plane_loc
            lam = Complex(p, p) if packed else worker(ref, cplx=True)
            if scenario is not None:
                chan = scenario_spec(ref)
            elif packed:
                chan = type(state.chan)(h=Complex(p, p), age=())
            else:
                chan = type(state.chan)(h=worker(ref, cplx=True), age=())
            if ref:
                Theta = _pspecs(full, worker_dim=False, fsdp=False, **kw)
            else:
                Theta = smap(lambda _p, s: s[1:], th)
            opt = type(state.opt)(mu=th, nu=th, count=())
            return type(state)(theta=th, lam=lam, Theta=Theta, chan=chan,
                               opt=opt, step=(), flt=flt_spec(ref))
        state_spec = build(ref=True)
        local_state_spec = build(ref=False)
        batch_spec = {k: (wspec,) + (None,) * (len(s) - 1)
                      for k, (s, _) in shapes.items()}

    state_g = smap(lambda _p, x, s: _leaf_global(x, s, mesh), state,
                   local_state_spec)
    batch_g, batch_l = _batch(shapes, batch_spec, mesh)
    key_g = _meta_like((2,), torch.uint32)

    def fn(st, batch, key):
        return train_step(st, batch, key=key)

    return DryRunSpec(
        fn=fn, args=(state_g, batch_g, key_g),
        in_shardings=(state_spec, batch_spec, ()), donate_argnums=(0,),
        meta=dict(kind="train", arch=arch, seq=seq, global_batch=gbatch,
                  fl_mode=flcfg.mode, n_workers=W,
                  sketch_ratio=sketch_ratio if sketched else None,
                  fsdp=mesh.shape.get("fsdp", 1),
                  sliding_window=cfg.sliding_window,
                  transport_backend=transport_backend,
                  train_driver=train_driver, scenario=scenario,
                  packed_uplink=packed_uplink,
                  faulted=faults is not None, guarded=guard is not None,
                  shard_local=bool(
                      (model_parallel or fsdp_n > 1)
                      and (sketched or packed_uplink is not False))),
        local_args=(state, batch_l, 1),
        local_shardings=(local_state_spec, batch_spec, ()), mesh=mesh)


def _serve_params(model, mesh, fsdp: bool, prep) -> Tuple[PyTree, PyTree,
                                                           PyTree]:
    """(global params, their specs, the rank's block) from the model's
    init on ``meta``; ``prep.shard`` builds the serving layer's plan."""
    full = model.init(0, device=META)
    local = prep.shard(full)
    spec = prep.layout.get("specs")
    if spec is None:
        spec = smap(lambda _p, x: (None,) * x.dim(), full)
    return full, spec, local


def build_prefill_spec(arch: str, mesh, *, multi_pod: bool,
                       reduced: bool = False) -> DryRunSpec:
    """The batch's forward to the last logits (``serving.make_prefill``)
    as one rank: its rows of the batch over the data axes, its part of
    each product (``models/partition``: its heads, ff columns, experts,
    channels and vocab rows)."""
    mesh = _as_mesh(mesh)
    shp = SHAPES["prefill_32k"]
    cfg = _arch_cfg(arch, "prefill_32k")
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    d_n = axis_size(mesh, data_axes(multi_pod))
    seq = 64 if reduced else shp["seq"]
    B = d_n if reduced else shp["batch"]
    fsdp = arch in BIG_ARCHS and not reduced
    prefill = make_prefill(model, mesh, fsdp=fsdp)
    params_g, pspec, params_l = _serve_params(model, mesh, fsdp, prefill)
    tseq = _text_seq(cfg, seq)
    shapes = {"tokens": ((B, tseq), torch.int32),
              **_modality_extras(cfg, B, None, seq)}
    bspec = {k: SH.batch_pspec(s, mesh, 0, multi_pod)
             for k, (s, _) in shapes.items()}
    batch_g, batch_l = _batch(shapes, bspec, mesh)
    return DryRunSpec(
        fn=prefill, args=(params_g, batch_g),
        in_shardings=(pspec, bspec), donate_argnums=(),
        meta=dict(kind="prefill", arch=arch, seq=seq, global_batch=B,
                  fsdp=fsdp, sliding_window=cfg.sliding_window),
        local_args=(params_l, batch_l), local_shardings=(pspec, bspec),
        mesh=mesh)


def build_decode_spec(arch: str, shape_name: str, mesh, *,
                      multi_pod: bool, reduced: bool = False) -> DryRunSpec:
    """One greedy decode step (``serving.make_serve_step``) as one rank:
    in ``in_shardings`` the reference's cache specs
    (``shardings.cache_pspecs``); the rank's cache is its block under the
    step's layout (``init_cache``; ``meta["cache_layout"]``)."""
    mesh = _as_mesh(mesh)
    shp = SHAPES[shape_name]
    cfg = _arch_cfg(arch, shape_name)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    d_n = axis_size(mesh, data_axes(multi_pod))
    seq = 128 if reduced else shp["seq"]
    B = ((d_n if shp["batch"] >= d_n else shp["batch"]) if reduced
         else shp["batch"])
    fsdp = arch in BIG_ARCHS and not reduced
    step = make_serve_step(model, mesh, fsdp=fsdp)
    params_g, pspec, params_l = _serve_params(model, mesh, fsdp, step)
    cache_kw = {}
    if cfg.family == "audio":
        cache_kw["n_frames"] = max(seq // 4, 16)
    cache_g = model.init_cache(B, seq, device=META, **cache_kw)
    cspec = SH.cache_pspecs(cache_g, cfg, mesh, B, multi_pod=multi_pod)
    tspec = SH.batch_pspec((B,), mesh, 0, multi_pod)
    b_loc = SH.shard_shape((B,), tspec, mesh)[0]
    # the rank's block of the cache, as the step lays it out
    cache_l = step.init_cache(B, seq, device=META, **cache_kw)
    cspec_l = step.layout["cache_specs"]
    return DryRunSpec(
        fn=step,
        args=(params_g, cache_g, _meta_like((B,), torch.int32),
              _meta_like((), torch.int32)),
        in_shardings=(pspec, cspec, tspec, ()), donate_argnums=(1,),
        meta=dict(kind="decode", arch=arch, seq=seq, global_batch=B,
                  fsdp=fsdp, sliding_window=cfg.sliding_window,
                  cache_layout=step.layout["cache"],
                  # leaves whose batch entry the rank holds on dim 1 where
                  # ``cspec`` (the reference's) puts it on dim 0: their
                  # layer count equals the batch (``cspec_l`` the rank's)
                  cache_batch_moved=step.layout["cache_batch_moved"]),
        local_args=(params_l, cache_l, _meta_like((b_loc,), torch.int32),
                    seq - 1),
        local_shardings=(pspec, cspec_l, tspec, ()), mesh=mesh)


def input_specs(arch: str, shape_name: str = "train_4k", mesh=None, *,
                multi_pod: bool = False) -> Tuple:
    """The ``meta`` stand-ins of every input of one combination (global
    shapes, no device allocation)."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    return build_spec(arch, shape_name, mesh, multi_pod=multi_pod).args


def build_spec(arch: str, shape_name: str, mesh, *, multi_pod: bool,
               reduced: bool = False,
               transport_backend: Optional[str] = None,
               train_driver: str = "scan",
               scenario: Optional[str] = None,
               packed_uplink: Optional[bool] = None,
               faults: Optional[Any] = None,
               guard: Optional[Any] = None,
               fl_mode: Optional[str] = None,
               sketch_ratio: int = 256) -> DryRunSpec:
    kind = SHAPES[shape_name]["kind"]
    if kind == "train":
        return build_train_spec(arch, mesh, multi_pod=multi_pod,
                                reduced=reduced,
                                transport_backend=transport_backend,
                                train_driver=train_driver,
                                scenario=scenario,
                                packed_uplink=packed_uplink,
                                faults=faults, guard=guard,
                                fl_mode=fl_mode, sketch_ratio=sketch_ratio)
    if kind == "prefill":
        return build_prefill_spec(arch, mesh, multi_pod=multi_pod,
                                  reduced=reduced)
    return build_decode_spec(arch, shape_name, mesh, multi_pod=multi_pod,
                             reduced=reduced)


def leaves(args: Tuple) -> list:
    """``(path, leaf)`` of every leaf of a spec's argument tuple (or of
    its tuple of spec trees), argument by argument."""
    return [((str(i),) + p, x) for i, a in enumerate(args)
            for p, x in flatten(a)]


def spec_bytes(args: Tuple) -> float:
    """Bytes of the tensors of an argument tuple of ``meta`` stand-ins."""
    return float(sum(math.prod(x.shape) * x.element_size()
                     for _p, x in leaves(args)
                     if isinstance(x, torch.Tensor)))


def cut_shapes(args: Tuple, shardings: Tuple, mesh) -> list:
    """The shape each tensor leaf of ``args`` has on one rank under
    ``shardings``: what the specs cut from the global stand-ins."""
    return [SH.shard_shape(tuple(x.shape), s, mesh)
            for (_p, x), (_q, s) in zip(leaves(args), leaves(shardings))]
