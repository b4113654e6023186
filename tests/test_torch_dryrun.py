"""The port's dry run (``repro_torch.launch.specs``, ``trace_analysis``,
``dryrun``, ``shardings.cache_pspecs``, ``obs.profiling.compile_report``
and the ``benchmarks.roofline``/``report`` twins) against the JAX
package's, on the CPU.

* Specs: every arch × shape (reduced) on the reference's ``AbstractMesh``
  (16, 16), (4, 4, 16) and (2, 16, 16) and the port's fake-rank mesh of the
  same shape, plus granite-8b sketched, leafwise and under markov-doppler:
  ``args`` leaf shapes and dtypes, ``in_shardings``, donation and ``meta``
  equal the reference's; ``local_args`` are what ``local_shardings`` cut.
* Cache specs for decode_32k and long_500k, leaf by leaf.
* Flops: the port's trace against the reference's loop-corrected HLO flops
  on a (1, 1) ``Auto`` mesh for six reduced cases, rtol 1e-2; and the
  port's partitioned rank on (1, 2) against the per-device module XLA
  partitions over a (1, 2) ``Auto`` mesh (one JAX subprocess with two
  host devices), reduced granite-8b train_4k, rtol 1e-2; so too the moe,
  ssm, hybrid and enc-dec families' training and serving modules, and
  full-size decode traces on 16 × 16 (what a step gathers, the cache's
  blocks).  The named
  exception is attention: the reference counts its masked S × S score
  products (full squares, of which the compiled CPU module keeps some
  inside fusions that ``hlo_analysis`` counts once), the port counts B11 as
  the kernel computes it (causal pairs only).  So the products whose
  operands or result carry two sequence-length dims are set aside on both
  sides, and B11's flops are held to the causal-pair count instead.
* Collectives: one spawn of two gloo ranks runs a round of reduced granite
  on (1, 2), on (2, 1) and sketched on (1, 2); the trace of the same round
  on the fake mesh counts the same calls and bytes by op, exactly.  The
  same spawn serves reduced granite-8b and falcon-mamba-7b on (1, 2) and
  (2, 1) through ``.shard(full)``: each rank's prefill logits, greedy
  tokens and cache are its rows of one device's (the path
  ``test_torch_serve`` holds to JAX), and the traced prefill and decode
  step count the live ranks' collectives.
* Port against port: the packed round's collective calls within 1.1× the
  leafwise round's on 16 × 16 (the reference's CI rule); k rounds count k
  times one round's flops and collectives; the CLI writes the reference's
  keys for its own ``test_dryrun_reduced`` cases (and a ``.err`` for a
  combination that fails); the report and roofline twins read them.
"""
import collections
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.launch.specs import build_spec as jbuild_spec  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch.benchmarks import report, roofline  # noqa: E402
from repro_torch.kernels.flash_attention import attention_flops  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import FakeMesh  # noqa: E402
from repro_torch.launch.trace_analysis import (analyze,  # noqa: E402
                                               collective_calls, tracing)
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.models.partition import SERVE_FAMILIES  # noqa: E402
from repro_torch.models.registry import list_archs  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "4x4x16": ((4, 4, 16), ("data", "fsdp", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
REDUCED_CACHE_SHAPES = ("decode_32k", "long_500k")


def _amesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes,
                        axis_types=(AxisType.Explicit,) * len(axes))


def _fake(name):
    return FakeMesh(*MESHES[name])


def _norm(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _jax_leaves(spec):
    args = jax.tree_util.tree_leaves(spec.args)
    shs = jax.tree_util.tree_leaves(spec.in_shardings,
                                    is_leaf=lambda x: isinstance(x, P))
    return args, shs


def _check_spec(ours, ref, mesh):
    """``ours`` (the port's DryRunSpec) against ``ref`` (the JAX
    package's): leaves, shapes, dtypes, specs, donation, meta; and the
    rank's resident args are what the local specs cut."""
    ra, rs = _jax_leaves(ref)
    pa = specs.leaves(ours.args)
    ps = specs.leaves(ours.in_shardings)
    assert len(pa) == len(ra) == len(ps) == len(rs)
    for (path, x), j, (_, s), js in zip(pa, ra, ps, rs):
        where = ".".join(path)
        assert tuple(x.shape) == tuple(j.shape), where
        assert str(x.dtype).replace("torch.", "") == str(j.dtype), where
        assert _norm(s, x.dim()) == _norm(js, x.dim()), (where, s, js)
    assert tuple(ours.donate_argnums) == tuple(ref.donate_argnums)
    assert {k: v for k, v in ours.meta.items() if k in ref.meta} == ref.meta
    assert set(ours.meta) - set(ref.meta) <= {"cache_layout",
                                              "cache_batch_moved"}
    local = specs.leaves(ours.local_args)
    cut = specs.cut_shapes(ours.args, ours.local_shardings, mesh)
    assert len(local) == len(cut)
    for (path, x), want in zip(local, cut):
        if isinstance(x, torch.Tensor):
            assert tuple(x.shape) == want, ".".join(path)
            assert x.is_meta, ".".join(path)


def _cache_layout(ours):
    """The decode cache's layout the reference's cache specs give a
    family (the KV heads over ``model``, else the sequence, else the batch
    alone; the enc-dec's by its self cache ``self_k``, as a K leaf's;
    MLA's latent ``c_kv`` on the sequence, else the batch; the SSM's state
    on its channels, else the batch; the hybrid's attention window as a K
    leaf's, the batch where its RG-LRU state does not split), and
    ``"batch"`` for a family that serves gathered."""
    if get_config(ours.meta["arch"]).family not in SERVE_FAMILIES:
        return "batch"
    leaves = dict(specs.leaves(ours.in_shardings))
    if ("1", "ssm") in leaves:
        return "inner" if _norm(leaves[("1", "ssm")], 4)[2] else "batch"
    lru = ("1", "super", "b0", "lru")
    if lru in leaves and not _norm(leaves[lru], 3)[2]:
        return "batch"
    path = next(p for p in (("1", "k"), ("1", "self_k"), ("1", "moe", "k"),
                            ("1", "moe", "c_kv"), ("1", "super", "b2", "k"))
                if p in leaves)
    spec = _norm(leaves[path], 4 if path[-1] == "c_kv" else 5)
    if path[-1] != "c_kv" and spec[3]:
        return "heads"
    return "seq" if spec[2] else "batch"


def _same_layout(ours, mesh_name):
    """Where the rank's layout is the reference's boundary layout: every
    argument but the decode cache of the families still gathering (split
    over the batch only) and, on an fsdp mesh, the replicated mode's state
    (on the (fsdp, model) grid)."""
    kind = ours.meta["kind"]
    skip = set()
    if kind == "decode" and get_config(
            ours.meta["arch"]).family not in SERVE_FAMILIES:
        skip.add(1)
    if kind == "train" and ours.meta["fl_mode"] == "replicated" \
            and mesh_name == "4x4x16":
        skip.add(0)
    moved = set(ours.meta.get("cache_batch_moved", ()))
    loc = specs.leaves(ours.local_shardings)
    ref = specs.leaves(ours.in_shardings)
    for ((path, a), (_, b)), (_, x) in zip(zip(loc, ref),
                                           specs.leaves(ours.args)):
        if int(path[0]) in skip or not isinstance(x, torch.Tensor):
            continue
        b = _norm(b, x.dim())
        if path[0] == "1" and "/".join(path[1:]) in moved:
            # layer count = batch: the data axes on dim 1, not dim 0
            b = (b[1], b[0]) + b[2:]
        assert _norm(a, x.dim()) == b, ".".join(path)
    if kind == "decode":
        assert ours.meta["cache_layout"] == _cache_layout(ours)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_match_the_reference(mesh_name, arch):
    multi_pod = mesh_name == "2x16x16"
    for shape in specs.SHAPES:
        ref = jbuild_spec(arch, shape, _amesh(mesh_name),
                          multi_pod=multi_pod, reduced=True)
        mesh = _fake(mesh_name)
        ours = specs.build_spec(arch, shape, mesh, multi_pod=multi_pod,
                                reduced=True)
        _check_spec(ours, ref, mesh)
        _same_layout(ours, mesh_name)


@pytest.mark.parametrize("kw", [dict(fl_mode="sketched"),
                                dict(packed_uplink=False),
                                dict(scenario="markov-doppler")],
                         ids=["sketched", "leafwise", "markov-doppler"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_train_spec_variants_match_the_reference(mesh_name, kw):
    multi_pod = mesh_name == "2x16x16"
    ref = jbuild_spec("granite-8b", "train_4k", _amesh(mesh_name),
                      multi_pod=multi_pod, reduced=True, **kw)
    mesh = _fake(mesh_name)
    ours = specs.build_spec("granite-8b", "train_4k", mesh,
                            multi_pod=multi_pod, reduced=True, **kw)
    _check_spec(ours, ref, mesh)


@pytest.mark.parametrize("shape", REDUCED_CACHE_SHAPES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_pspecs_match_the_reference(mesh_name, shape):
    multi_pod = mesh_name == "2x16x16"
    amesh, mesh = _amesh(mesh_name), _fake(mesh_name)
    for arch in list_archs():
        cfg_j = jget_config(arch)
        cfg_p = get_config(arch)
        if shape == "long_500k" and not cfg_j.subquadratic:
            cfg_j = cfg_j.with_sliding_window(specs.SLIDING_WINDOW_LONG)
            cfg_p = cfg_p.with_sliding_window(specs.SLIDING_WINDOW_LONG)
        cfg_j, cfg_p = cfg_j.reduced(), cfg_p.reduced()
        d_n = 32 if multi_pod else (4 if mesh_name == "4x4x16" else 16)
        B = d_n if specs.SHAPES[shape]["batch"] >= d_n \
            else specs.SHAPES[shape]["batch"]
        kw = {"n_frames": 32} if cfg_p.family == "audio" else {}
        cj = jax.eval_shape(lambda: jbuild_model(cfg_j).init_cache(
            B, 128, **kw))
        cp = build_model(cfg_p).init_cache(B, 128, device="meta", **kw)
        sj = jax.tree_util.tree_leaves(
            JSH.cache_pspecs(cj, cfg_j, amesh, B, multi_pod=multi_pod),
            is_leaf=lambda x: isinstance(x, P))
        lp = specs.leaves((cp,))
        sp = specs.leaves((SH.cache_pspecs(cp, cfg_p, mesh, B,
                                           multi_pod=multi_pod),))
        lj = jax.tree_util.tree_leaves(cj)
        assert len(lj) == len(lp) == len(sp) == len(sj), arch
        for (path, x), j, (_, s), js in zip(lp, lj, sp, sj):
            assert tuple(x.shape) == tuple(j.shape), (arch, path)
            assert _norm(s, x.dim()) == _norm(js, x.dim()), (arch, path)


# ---------------------------------------------------------------------------
# flops against the reference's HLO
# ---------------------------------------------------------------------------

def _hlo_of(arch, shape):
    """The reference's compiled module of the reduced spec on a (1, 1)
    mesh with ``Auto`` axes, as its ``run_one`` lowers it."""
    from repro.launch.shardings import named, rules_for
    from repro.models.sharding import axis_rules

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    spec = jbuild_spec(arch, shape, mesh, multi_pod=False, reduced=True)
    fl_repl = (spec.meta.get("kind") == "train"
               and spec.meta.get("fl_mode") == "replicated")
    rules = rules_for(jget_config(arch).reduced(), mesh, multi_pod=False,
                      fl_replicated=fl_repl)
    with mesh:
        with axis_rules(mesh, rules):
            return jax.jit(spec.fn, in_shardings=named(
                mesh, spec.in_shardings), donate_argnums=spec.donate_argnums
            ).lower(*spec.args).compile().as_text()


def _hlo_dots(hlo):
    """Flops of every dot of the module by (lhs, rhs, result) dims, times
    the loop trips ``hlo_analysis`` multiplies through."""
    comps, entry = hlo_analysis._parse_computations(hlo)
    costs = {n: hlo_analysis._analyze_comp(c) for n, c in comps.items()}
    mult = collections.Counter()

    def walk(name, m):
        mult[name] += m
        for child, k, _ in costs[name].refs:
            if child in costs:
                walk(child, m * k)
    walk(entry, 1.0)
    out = collections.Counter()
    for name, lines in comps.items():
        if not mult[name]:
            continue
        defs = {}
        for line in lines:
            m = hlo_analysis._OP_RE.match(line)
            if m:
                defs[m.group(1)] = m.group(2)
        for line in lines:
            m = hlo_analysis._OP_RE.match(line)
            if not m or m.group(3) != "dot":
                continue
            ops = hlo_analysis._NAME_RE.findall(m.group(4).split(")")[0])
            lhs = hlo_analysis.shape_dims(defs.get(ops[0], ""))
            rhs = hlo_analysis.shape_dims(defs.get(ops[1], ""))
            res = hlo_analysis.shape_dims(m.group(2))
            k = 1
            cm = hlo_analysis._CONTRACT_RE.search(line)
            for i in (int(x) for x in cm.group(1).split(",") if x):
                k *= lhs[i]
            out[(lhs, rhs, res)] += 2.0 * float(np.prod(res)) * k \
                * mult[name]
    return out


def _attention(shapes, S):
    return any(list(s).count(S) >= 2 for s in shapes)


@pytest.mark.parametrize("arch,shape", [
    ("granite-8b", "train_4k"), ("granite-8b", "prefill_32k"),
    ("granite-8b", "decode_32k"), ("falcon-mamba-7b", "long_500k"),
    ("recurrentgemma-2b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k")])
def test_trace_flops_match_the_reference_hlo(arch, shape):
    hlo = _hlo_of(arch, shape)
    ref_total = hlo_analysis.analyze(hlo).flops
    dots = _hlo_dots(hlo)
    assert sum(dots.values()) == pytest.approx(ref_total, rel=1e-9)
    mesh = FakeMesh((1, 1), ("data", "model"))
    spec = specs.build_spec(arch, shape, mesh, multi_pod=False, reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    S = spec.meta["seq"]
    ref_attn = sum(v for k, v in dots.items() if _attention(k, S))
    ours_attn = sum(v for (_, ins, outs), v in s.products.items()
                    if _attention(ins + outs, S))
    b11 = {k: v for k, v in s.kernels.items()
           if k.startswith("flash_attention")}
    kernel_flops = sum(k["flops"] for k in s.kernels.values())
    # outside attention the products are the reference's
    assert s.flops - ours_attn - kernel_flops == pytest.approx(
        ref_total - ref_attn, rel=1e-2)
    if not ref_attn:
        assert s.flops == pytest.approx(ref_total, rel=1e-2)
    # B11 as the kernel computes it: per call, the causal pairs × 4/6/8·hd
    if b11:
        cfg = spec.meta
        assert cfg["kind"] in ("train", "prefill")
        n_rows = {"train": 2, "prefill": 1}[cfg["kind"]]   # B·(workers)
        m = get_config(arch)
        hd = m.reduced().hd
        H = m.reduced().n_heads
        q = torch.empty((n_rows, H, S, hd), device="meta")
        per = {"flash_attention_fwd": 4, "flash_attention_dq": 6,
               "flash_attention_dkv": 8}
        for name, k in b11.items():
            assert k["flops"] == k["calls"] * attention_flops(
                q, q, True, per[name]), name


#: the reference's reduced ``argv[2]`` train_4k compiled on a (1, 2)
#: ``Auto`` mesh of two forced host devices: XLA's partition of each product
#: over ``model`` (its per-device module's text into ``argv[1]``)
_HLO_12 = r"""
import sys
import jax
from jax.sharding import AxisType
from repro.launch.shardings import named, rules_for
from repro.launch.specs import build_spec
from repro.models.registry import get_config
from repro.models.sharding import axis_rules

assert jax.device_count() == 2, jax.devices()
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
spec = build_spec(sys.argv[2], "train_4k", mesh, multi_pod=False,
                  reduced=True)
rules = rules_for(get_config(sys.argv[2]).reduced(), mesh, multi_pod=False,
                  fl_replicated=True)
with mesh:
    with axis_rules(mesh, rules):
        hlo = jax.jit(spec.fn, in_shardings=named(mesh, spec.in_shardings),
                      donate_argnums=spec.donate_argnums
                      ).lower(*spec.args).compile().as_text()
open(sys.argv[1], "w").write(hlo)
print("HLO_OK")
"""


def _hlo_12(tmp_path, arch):
    """The text of :data:`_HLO_12`'s module for ``arch``."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / f"{arch}_12.hlo"
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2"
                          ).strip())
    proc = subprocess.run([sys.executable, "-c", _HLO_12, str(out), arch],
                          env=env, capture_output=True, text=True,
                          timeout=400, cwd=repo)
    assert "HLO_OK" in proc.stdout, proc.stdout + proc.stderr
    return out.read_text()


def test_partitioned_trace_flops_match_the_references_partition(tmp_path):
    """The port's rank on a (1, 2) fake mesh computes its heads, ff columns
    and vocab rows (``models/partition``): its traced flops outside
    attention equal, within rtol 1e-2, the per-device flops of the
    reference's module that XLA partitions over the same mesh, and B11 runs
    on half the heads."""
    hlo = _hlo_12(tmp_path, "granite-8b")
    ref_total = hlo_analysis.analyze(hlo).flops
    dots = _hlo_dots(hlo)
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec("granite-8b", "train_4k", mesh, multi_pod=False,
                            reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    S = spec.meta["seq"]
    ref_attn = sum(v for k, v in dots.items() if _attention(k, S))
    ours_attn = sum(v for (_, ins, outs), v in s.products.items()
                    if _attention(ins + outs, S))
    kernel_flops = sum(k["flops"] for k in s.kernels.values())
    assert s.flops - ours_attn - kernel_flops == pytest.approx(
        ref_total - ref_attn, rel=1e-2)
    # against the whole products on (1, 1): each rank's half of them
    one = FakeMesh((1, 1), ("data", "model"))
    whole = specs.build_spec("granite-8b", "train_4k", one, multi_pod=False,
                             reduced=True)
    assert s.flops < 0.6 * analyze(whole.fn, whole.local_args, one).flops
    cfg = get_config("granite-8b").reduced()
    q = torch.empty((2, cfg.n_heads // 2, S, cfg.hd), device="meta")
    fwd = s.kernels["flash_attention_fwd"]
    assert fwd["flops"] == fwd["calls"] * attention_flops(q, q, True, 4)
    # the products partition: no all-gather over model, the sums instead
    assert "all_gather" not in s.mesh_stats
    assert s.mesh_stats["reduce_from"]["calls"] > 0
    assert s.mesh_stats["copy_to"]["calls"] > 0


def _expert_product(shapes, E_local, C):
    """A routed expert's batched product: an (E_local, ·, ·) operand with
    the capacity C on one of its last two dims."""
    return any(len(sh) == 3 and sh[0] == E_local and C in sh[1:]
               for sh in shapes)


def test_partitioned_moe_trace_flops_match_the_references_partition(
        tmp_path):
    """Reduced qwen3-moe train_4k on a (1, 2) fake mesh: the rank runs its
    E/2 routed experts, its heads and vocab rows (``models/partition``).
    The experts' three batched products (with their backward and the
    checkpoint's recompute) and every product outside attention count,
    within rtol 1e-2, the flops of the per-device module XLA partitions
    from the reference's over the same mesh."""
    from repro_torch.models import moe

    hlo = _hlo_12(tmp_path, "qwen3-moe-30b-a3b")
    ref_total = hlo_analysis.analyze(hlo).flops
    dots = _hlo_dots(hlo)
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec("qwen3-moe-30b-a3b", "train_4k", mesh,
                            multi_pod=False, reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    S = spec.meta["seq"]
    C = moe._capacity(S * spec.meta["global_batch"]
                      // spec.meta["n_workers"], cfg)
    ref_ex = sum(v for k, v in dots.items()
                 if _expert_product(k, cfg.n_experts // 2, C))
    ours_ex = sum(v for (_, ins, outs), v in s.products.items()
                  if _expert_product(ins + outs, cfg.n_experts // 2, C))
    assert ref_ex > 0
    assert ours_ex == pytest.approx(ref_ex, rel=1e-2)
    ref_attn = sum(v for k, v in dots.items() if _attention(k, S))
    ours_attn = sum(v for (_, ins, outs), v in s.products.items()
                    if _attention(ins + outs, S))
    kernel_flops = sum(k["flops"] for k in s.kernels.values())
    assert s.flops - ours_attn - kernel_flops == pytest.approx(
        ref_total - ref_attn, rel=1e-2)
    # no expert leaf is gathered: the router's columns alone, a layer each
    assert s.mesh_stats["all_gather"]["calls"] == 2 * cfg.n_layers
    assert s.mesh_stats["reduce_from"]["calls"] > 0


def test_seq_decode_gathers_the_kv_projections_not_wk_wv():
    """granite-8b decode_32k at full size on 16 × 16 (32 heads split, 8 KV
    heads not, so the cache lies on the sequence): a step gathers no
    parameter over ``model``.  Each layer gathers its K and V projections
    of the rank's ``wk``/``wv`` columns, (B, 1, KV·hd) each, where a gather
    of ``wk``/``wv`` (d, KV·hd) would move over 500× the bytes."""
    mesh = _fake("16x16")
    spec = specs.build_spec("granite-8b", "decode_32k", mesh,
                            multi_pod=False)
    assert spec.meta["cache_layout"] == "seq"
    s = analyze(spec.fn, spec.local_args, mesh)
    assert "all_gather" not in s.mesh_stats
    cfg = get_config("granite-8b")
    L, kvd, n = cfg.n_layers, cfg.n_kv_heads * cfg.hd, mesh.shape["model"]
    B = spec.local_args[1]["k"].shape[1]
    kv = s.mesh_stats["gather_kv"]
    assert kv["calls"] == L
    # the mesh counts a gather's input: the rank's (2, B, 1, KV·hd/n) bf16
    assert kv["bytes"] == L * 2 * B * kvd // n * 2
    assert 500 * n * kv["bytes"] < L * 2 * cfg.d_model * kvd * 2


#: the reference's reduced serving specs (``arch:shape`` each, from
#: ``argv[2:]``) compiled on a (1, 2) ``Auto`` mesh of two forced host
#: devices, with its cache specs (each per-device module's text into
#: ``argv[1]/<arch>_<shape>.hlo``)
_HLO_SERVE_12 = r"""
import sys
import jax
from jax.sharding import AxisType
from repro.launch.shardings import named, rules_for
from repro.launch.specs import build_spec
from repro.models.registry import get_config
from repro.models.sharding import axis_rules

assert jax.device_count() == 2, jax.devices()
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for arg in sys.argv[2:]:
    arch, shape = arg.split(":")
    spec = build_spec(arch, shape, mesh, multi_pod=False, reduced=True)
    rules = rules_for(get_config(arch).reduced(), mesh, multi_pod=False)
    with mesh:
        with axis_rules(mesh, rules):
            hlo = jax.jit(spec.fn, in_shardings=named(
                mesh, spec.in_shardings), donate_argnums=spec.donate_argnums
            ).lower(*spec.args).compile().as_text()
    open(f"{sys.argv[1]}/{arch}_{shape}.hlo", "w").write(hlo)
print("HLO_OK")
"""
MOE_SERVE = [(a, s) for a in ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
             for s in ("decode_32k", "prefill_32k")]


@pytest.fixture(scope="module")
def moe_serve_hlo(tmp_path_factory):
    """The text of each :data:`MOE_SERVE` module XLA partitions over (1,
    2), from one JAX subprocess."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("hlo_serve")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2"
                          ).strip())
    proc = subprocess.run(
        [sys.executable, "-c", _HLO_SERVE_12, str(out)]
        + [f"{a}:{s}" for a, s in MOE_SERVE], env=env, capture_output=True,
        text=True, timeout=400, cwd=repo)
    assert "HLO_OK" in proc.stdout, proc.stdout + proc.stderr
    return {(a, s): (out / f"{a}_{s}.hlo").read_text() for a, s in MOE_SERVE}


def _small_proj_flops(cfg, n_tokens: int) -> float:
    """The flops of the router's, ``wq_a``'s and ``wkv_a``'s whole
    products on ``n_tokens`` tokens, over every layer that has them."""
    d, nm = cfg.d_model, cfg.n_layers - cfg.first_dense_layers
    f = 2.0 * n_tokens * d * cfg.n_experts * nm
    if cfg.use_mla:
        f += 2.0 * n_tokens * d * (cfg.q_lora_rank + cfg.kv_lora_rank
                                   + cfg.qk_rope_head_dim) * cfg.n_layers
    return f


@pytest.mark.parametrize("arch,shape", MOE_SERVE)
def test_partitioned_moe_serving_flops_match_the_references_partition(
        moe_serve_hlo, arch, shape):
    """Reduced qwen3-moe and deepseek-v3 serving on a (1, 2) fake mesh:
    the rank's experts, heads, shared expert's and dense MLP's columns and
    vocab rows (``models/partition``; MLA's decode on its slice of the
    latent cache's sequence, every head).  Decode counts, within rtol
    1e-2, the flops of the per-device module XLA partitions from the
    reference's ``serve_step`` over the same mesh (measured: equal), half
    of one device's.  The prefill reads the router, ``wq_a`` and ``wkv_a``
    whole (gathered), where XLA splits their columns: with the half of
    those products the rank computes beyond XLA's set aside, it counts
    XLA's flops within rtol 1e-2 (measured: equal; the gap before, of
    those products alone, +0.54 % outside attention for qwen3-moe, +8.3 %
    in all for deepseek-v3).  qwen3-moe's attention runs B11 and is set
    aside on both sides as in the training test; MLA's einsums count alike
    on both."""
    hlo = moe_serve_hlo[(arch, shape)]
    ref_total = hlo_analysis.analyze(hlo).flops
    dots = _hlo_dots(hlo)
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec(arch, shape, mesh, multi_pod=False,
                            reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    cfg = get_config(arch).reduced()
    ours, ref = s.flops, ref_total
    if shape == "prefill_32k":
        S = spec.meta["seq"]
        ours -= 0.5 * _small_proj_flops(cfg, spec.meta["global_batch"] * S)
        if not cfg.use_mla:
            ref -= sum(v for k, v in dots.items() if _attention(k, S))
            ours -= sum(v for (_, ins, outs), v in s.products.items()
                        if _attention(ins + outs, S))
            ours -= sum(k["flops"] for k in s.kernels.values())
            q = torch.empty((spec.meta["global_batch"], cfg.n_heads // 2, S,
                             cfg.hd), device="meta")
            fwd = s.kernels["flash_attention_fwd"]
            assert fwd["flops"] == fwd["calls"] * attention_flops(
                q, q, True, 4)
    else:
        assert spec.meta["cache_layout"] == (
            "seq" if cfg.use_mla else "heads")
        one = FakeMesh((1, 1), ("data", "model"))
        whole = specs.build_spec(arch, shape, one, multi_pod=False,
                                 reduced=True)
        assert s.flops == pytest.approx(
            0.5 * analyze(whole.fn, whole.local_args, one).flops, rel=1e-2)
        assert "all_gather" not in s.mesh_stats
    assert ours == pytest.approx(ref, rel=1e-2)


def test_mla_decode_keeps_the_latent_cache_split_and_gathers_no_weight():
    """deepseek-v3 decode_32k at full size on 16 × 16 (its 128 KV heads
    bind ``kv_heads``, but the latent cache lies on the sequence): a step
    all-gathers no parameter over ``model``; the only parameter gathers
    are the reference's FSDP over ``data`` (the rank's fsdp block of each
    layer).  The latent cache is never gathered: each layer gathers its
    query heads (``gather_heads``) and its one-token small projections
    (``gather_proj``: ``wq_a`` and ``wkv_a`` in one, the router in
    another on a MoE layer), and joins its partial softmaxes, which
    together move less than one layer's block of ``c_kv``."""
    mesh = _fake("16x16")
    spec = specs.build_spec("deepseek-v3-671b", "decode_32k", mesh,
                            multi_pod=False)
    assert spec.meta["cache_layout"] == "seq"
    analyze(spec.fn, spec.local_args, mesh)
    st = mesh.stats
    cfg = get_config("deepseek-v3-671b")
    L, nm = cfg.n_layers, cfg.n_layers - cfg.first_dense_layers
    assert st["all_gather"]["axes"] == {"data": st["all_gather"]["calls"]}
    assert st["gather_proj"]["axes"] == {"model": L + nm}
    for op in ("gather_heads", "softmax_max", "softmax_sum"):
        assert st[op]["axes"] == {"model": L}, op
    assert "gather_kv" not in st
    c_kv = spec.local_args[1]["moe"]["c_kv"]
    assert tuple(c_kv.shape[2:]) == (
        spec.meta["seq"] // mesh.shape["model"], cfg.kv_lora_rank)
    block = c_kv[0].numel() * c_kv.element_size()
    moved = sum(st[op]["bytes"] for op in ("gather_heads", "gather_proj"))
    assert moved < block


def _x_proj_flops(s, cfg) -> float:
    """The traced flops of the SSM's ``x_proj`` products (forward,
    recompute and backward): those with an operand or result ``r + 2n``
    wide."""
    w = cfg.dt_rank + 2 * cfg.ssm_state
    return sum(v for (_, ins, outs), v in s.products.items()
               if any(w in sh[-2:] for sh in ins + outs))


def test_partitioned_ssm_trace_flops_match_the_references_partition(
        tmp_path):
    """Reduced falcon-mamba train_4k on a (1, 2) fake mesh: the rank runs
    its d_inner/2 channels (``in_proj``'s columns, ``dt_proj``'s columns,
    ``out_proj``'s rows, B12 on its channels) and its vocab rows.  Each
    rank computes ``x_proj``'s whole product on the gathered channels (one
    device's contraction), where XLA splits its columns: with the half of
    those products the rank computes beyond XLA's set aside, its traced
    flops count, within rtol 1e-2, those of the per-device module XLA
    partitions from the reference's over the same mesh (measured: +0.42 %,
    XLA's remat keeps a few products the port recomputes), and exactly
    half of its own flops on (1, 1) otherwise.  Only ``x_proj``,
    ``dt_proj`` and ``dt_proj``'s bias are gathered: twice a layer (the
    forward and the recompute) and the bias once."""
    hlo = _hlo_12(tmp_path, "falcon-mamba-7b")
    ref_total = hlo_analysis.analyze(hlo).flops
    cfg = get_config("falcon-mamba-7b").reduced()
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec("falcon-mamba-7b", "train_4k", mesh,
                            multi_pod=False, reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    kernel_flops = sum(k["flops"] for k in s.kernels.values())
    assert s.kernels["linear_scan_fwd"]["calls"] == 2 * cfg.n_layers
    extra = 0.5 * _x_proj_flops(s, cfg)
    assert extra > 0
    assert s.flops - kernel_flops - extra == pytest.approx(ref_total,
                                                           rel=1e-2)
    one = FakeMesh((1, 1), ("data", "model"))
    whole = specs.build_spec("falcon-mamba-7b", "train_4k", one,
                             multi_pod=False, reduced=True)
    sw = analyze(whole.fn, whole.local_args, one)
    assert s.flops - extra == pytest.approx(0.5 * sw.flops, rel=1e-6)
    L = cfg.n_layers
    assert s.mesh_stats["all_gather"]["calls"] == 2 * (2 * L) + 1
    assert s.mesh_stats["all_to_all"]["calls"] == 3 * L
    assert s.mesh_stats["gather_inner"]["calls"] == 2 * L


SSM_SERVE = [("falcon-mamba-7b", s) for s in ("decode_32k", "prefill_32k")]


@pytest.fixture(scope="module")
def ssm_serve_hlo(tmp_path_factory):
    """The text of each :data:`SSM_SERVE` module XLA partitions over (1,
    2), from one JAX subprocess."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("hlo_ssm")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2"
                          ).strip())
    proc = subprocess.run(
        [sys.executable, "-c", _HLO_SERVE_12, str(out)]
        + [f"{a}:{s}" for a, s in SSM_SERVE], env=env, capture_output=True,
        text=True, timeout=400, cwd=repo)
    assert "HLO_OK" in proc.stdout, proc.stdout + proc.stderr
    return {(a, s): (out / f"{a}_{s}.hlo").read_text() for a, s in SSM_SERVE}


@pytest.mark.parametrize("arch,shape", SSM_SERVE)
def test_partitioned_ssm_serving_flops_match_the_references_partition(
        ssm_serve_hlo, arch, shape):
    """Reduced falcon-mamba serving on a (1, 2) fake mesh, the rank's
    channels and vocab rows.  Decode (the cache on its channels; the
    token's channels gathered and ``x_proj``'s columns projected,
    ``dt_proj``'s rows reduce-scattered) counts, within rtol 1e-2, the
    flops of the per-device module XLA partitions from the reference's
    ``serve_step`` over the same mesh, half of one device's.  The prefill
    computes ``x_proj``'s whole product on the gathered channels, where
    XLA splits its columns: with the half the rank computes beyond XLA's
    set aside, it counts XLA's flops within rtol 1e-2."""
    hlo = ssm_serve_hlo[(arch, shape)]
    ref = hlo_analysis.analyze(hlo).flops
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec(arch, shape, mesh, multi_pod=False, reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    cfg = get_config(arch).reduced()
    ours = s.flops - sum(k["flops"] for k in s.kernels.values())
    one = FakeMesh((1, 1), ("data", "model"))
    whole = specs.build_spec(arch, shape, one, multi_pod=False, reduced=True)
    sw = analyze(whole.fn, whole.local_args, one)
    if shape == "prefill_32k":
        extra = 0.5 * _x_proj_flops(s, cfg)
        assert extra > 0
        ours -= extra
        assert s.kernels["linear_scan_fwd"]["calls"] == cfg.n_layers
    else:
        assert spec.meta["cache_layout"] == "inner"
        assert "linear_scan_fwd" not in s.kernels
    assert ours == pytest.approx(0.5 * sw.flops, rel=1e-2)
    assert ours == pytest.approx(ref, rel=1e-2)


def test_ssm_decode_gathers_no_weight_but_the_dt_bias():
    """falcon-mamba-7b decode_32k at full size on 16 × 16 (d_inner 8,192
    over ``model``): the rank's cache is its 512 channels of the state
    and the conv window, and a step all-gathers no parameter over
    ``model`` but ``dt_proj``'s bias, which the layout splits on its layer
    dim (the rank's 4 of 64 rows, once a step).  Each layer exchanges its
    ``in_proj`` block (all-to-all), gathers the token's channels and its
    ``x_proj`` columns, and reduce-scatters ``dt_proj``'s partials, which
    together move less than one layer's ``x_proj`` and ``dt_proj``
    weights would."""
    mesh = _fake("16x16")
    spec = specs.build_spec("falcon-mamba-7b", "decode_32k", mesh,
                            multi_pod=False)
    assert spec.meta["cache_layout"] == "inner"
    cfg = get_config("falcon-mamba-7b")
    L, di, n = cfg.n_layers, cfg.d_inner, mesh.shape["model"]
    cache = spec.local_args[1]
    B = cache["ssm"].shape[1]
    assert tuple(cache["ssm"].shape) == (L, B, di // n, cfg.ssm_state)
    assert tuple(cache["conv"].shape) == (L, B, cfg.conv1d_width - 1,
                                          di // n)
    analyze(spec.fn, spec.local_args, mesh)
    st = mesh.stats
    # dt_proj's bias: the rank's L/n rows (bf16), whole once
    assert st["all_gather"]["axes"] == {"model": 1}
    assert st["all_gather"]["bytes"] == L // n * di * 2
    for op in ("all_to_all", "gather_inner", "gather_proj",
               "scatter_inner"):
        assert st[op]["axes"] == {"model": L}, op
    moved = sum(st[op]["bytes"] for op in ("all_to_all", "gather_inner",
                                           "gather_proj", "scatter_inner"))
    weights = L * (di * (cfg.dt_rank + 2 * cfg.ssm_state)
                   + cfg.dt_rank * di) * 2
    assert moved < weights


def test_partitioned_hybrid_trace_flops_match_the_references_partition(
        tmp_path):
    """Reduced recurrentgemma-2b train_4k on a (1, 2) fake mesh: the rank
    runs its lru_width/2 RG-LRU channels (``w_gelu``'s, ``w_rec``'s and the
    gates' columns on the gathered channels, ``w_out``'s rows, B12 on its
    channels), its half of the heads, its ff columns and its vocab rows.
    Each rank projects the one KV head whole (``wk``/``wv`` read through
    ``copy_to``, as the dense family's trainer does where the KV heads do
    not split), where XLA splits those columns and gathers the result:
    with the half of those products the rank computes beyond XLA's set
    aside (measured: exactly that half, 2²² flops), its traced flops
    outside attention count, within rtol 1e-2, those of the per-device
    module XLA partitions from the reference's over the same mesh, and
    half of its own on (1, 1); B12 runs on the rank's channels.  No
    RG-LRU, MLP or vocab leaf is gathered: the one KV head's ``wk``/``wv``
    alone, twice (the forward and the recompute)."""
    hlo = _hlo_12(tmp_path, "recurrentgemma-2b")
    ref_total = hlo_analysis.analyze(hlo).flops
    dots = _hlo_dots(hlo)
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec("recurrentgemma-2b", "train_4k", mesh,
                            multi_pod=False, reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    S = spec.meta["seq"]
    ref_attn = sum(v for k, v in dots.items() if _attention(k, S))
    ours_attn = sum(v for (_, ins, outs), v in s.products.items()
                    if _attention(ins + outs, S))
    kernel_flops = sum(k["flops"] for k in s.kernels.values())
    cfg = get_config("recurrentgemma-2b").reduced()
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.hd
    # the K and V projections: an operand of the weight's (1, d, KV·hd)
    # shape or its transpose
    extra = 0.5 * sum(v for (_, ins, _), v in s.products.items()
                      if {(1, d, kv), (1, kv, d)} & set(map(tuple, ins)))
    assert extra > 0
    assert s.flops - ours_attn - kernel_flops - extra == pytest.approx(
        ref_total - ref_attn, rel=1e-2)
    one = FakeMesh((1, 1), ("data", "model"))
    whole = specs.build_spec("recurrentgemma-2b", "train_4k", one,
                             multi_pod=False, reduced=True)
    sw = analyze(whole.fn, whole.local_args, one)
    assert s.flops - extra == pytest.approx(0.5 * sw.flops, rel=1e-2)
    n_rec = cfg.block_pattern.count("rec")
    fwd = s.kernels["linear_scan_fwd"]
    assert fwd["calls"] == 2 * n_rec
    assert fwd["bytes"] == pytest.approx(0.5 * sw.kernels[
        "linear_scan_fwd"]["bytes"], rel=1e-6)
    assert s.mesh_stats["all_gather"]["calls"] == 2 * 2
    assert s.mesh_stats["gather_inner"]["calls"] == 2 * n_rec


def test_hybrid_decode_gathers_no_lru_ff_or_vocab_leaf():
    """recurrentgemma-2b decode_32k at full size on 16 × 16 (lru_width
    2,560, d_ff 7,680 and the vocabulary over ``model``; its 10 heads do
    not split 16): the rank's cache is its 160 channels of each recurrent
    layer's state and conv window and its 128 of the 2,048-slot window of
    each attention layer's one KV head.  A step all-gathers over ``model``
    no RG-LRU, MLP or vocab leaf: only the attention's ``wq``, ``wk``,
    ``wv`` and ``wo``, whose heads stay whole (the rank's blocks, 4 a
    layer).  Each recurrent layer gathers the conv's channels (B, 1, dw)
    once."""
    from repro_torch.models.partition import gathered_model_leaf

    mesh = _fake("16x16")
    spec = specs.build_spec("recurrentgemma-2b", "decode_32k", mesh,
                            multi_pod=False)
    assert spec.meta["cache_layout"] == "seq"
    cfg = get_config("recurrentgemma-2b")
    n, dw, d = mesh.shape["model"], cfg.lru_width, cfg.d_model
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    n_tail = cfg.n_layers - n_super * len(pat)
    n_rec = n_super * pat.count("rec") + n_tail
    n_attn = n_super * pat.count("attn")
    cache = spec.local_args[1]
    B = cache["super"]["b0"]["lru"].shape[1]
    assert tuple(cache["super"]["b0"]["lru"].shape) == (n_super, B, dw // n)
    assert tuple(cache["super"]["b1"]["conv"].shape) == (
        n_super, B, cfg.conv1d_width - 1, dw // n)
    assert tuple(cache["tail"][0]["lru"].shape) == (B, dw // n)
    assert tuple(cache["super"]["b2"]["k"].shape) == (
        n_super, B, cfg.attn_window // n, cfg.n_kv_heads, cfg.hd)
    part = spec.fn.layout["part"]
    assert part.lru and part.ff and part.vocab and not part.heads
    params = spec.local_args[0]
    md, _ = SH.shard_dims_2d(params, cfg, mesh, multi_pod=False,
                             worker_dim=False)
    gathered = sorted({"/".join(p[3:]) for (p, _), m in zip(
        tree_paths(params), md) if gathered_model_leaf(p, m, part)})
    assert gathered == [f"attn/{w}/w" for w in ("wk", "wo", "wq", "wv")]
    analyze(spec.fn, spec.local_args, mesh)
    st = mesh.stats
    assert st["all_gather"]["axes"] == {"model": 4 * n_attn}
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    assert st["all_gather"]["bytes"] == n_attn * (2 * d * hq + 2 * d * hkv
                                                  ) // n * 2
    assert st["gather_inner"]["axes"] == {"model": n_rec}
    assert st["gather_inner"]["bytes"] == n_rec * B * dw // n * 2


def test_partitioned_encdec_trace_flops_match_the_references_partition(
        tmp_path):
    """Reduced seamless-m4t-medium train_4k on a (1, 2) fake mesh: the rank
    runs its half of the heads of the encoder's bidirectional attention and
    of the decoder's self- and cross-attention, its ff columns and its
    vocab rows (``models/partition``).  Its traced flops outside the
    decoder's causal attention count, within rtol 1e-2, those of the
    per-device module XLA partitions from the reference's over the same
    mesh, and half of its own on (1, 1); B11 runs on half the heads.  No
    product's leaf is gathered: ``fc_out``'s bias alone (split on its layer
    dim), once a stack a forward."""
    arch = "seamless-m4t-medium"
    hlo = _hlo_12(tmp_path, arch)
    ref_total = hlo_analysis.analyze(hlo).flops
    dots = _hlo_dots(hlo)
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec(arch, "train_4k", mesh, multi_pod=False,
                            reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    S = spec.meta["seq"]
    ref_attn = sum(v for k, v in dots.items() if _attention(k, S))
    ours_attn = sum(v for (_, ins, outs), v in s.products.items()
                    if _attention(ins + outs, S))
    kernel_flops = sum(k["flops"] for k in s.kernels.values())
    assert s.flops - ours_attn - kernel_flops == pytest.approx(
        ref_total - ref_attn, rel=1e-2)
    one = FakeMesh((1, 1), ("data", "model"))
    whole = specs.build_spec(arch, "train_4k", one, multi_pod=False,
                             reduced=True)
    sw = analyze(whole.fn, whole.local_args, one)
    assert s.flops == pytest.approx(0.5 * sw.flops, rel=1e-2)
    cfg = get_config(arch).reduced()
    q = torch.empty((2, cfg.n_heads // 2, S, cfg.hd), device="meta")
    fwd = s.kernels["flash_attention_fwd"]
    assert fwd["flops"] == fwd["calls"] * attention_flops(q, q, True, 4)
    assert s.mesh_stats["all_gather"]["calls"] == 2


ENCDEC_SERVE = [("seamless-m4t-medium", s)
                for s in ("decode_32k", "prefill_32k")]


@pytest.fixture(scope="module")
def encdec_serve_hlo(tmp_path_factory):
    """The text of each :data:`ENCDEC_SERVE` module XLA partitions over
    (1, 2), from one JAX subprocess."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("hlo_encdec")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2"
                          ).strip())
    proc = subprocess.run(
        [sys.executable, "-c", _HLO_SERVE_12, str(out)]
        + [f"{a}:{s}" for a, s in ENCDEC_SERVE], env=env,
        capture_output=True, text=True, timeout=400, cwd=repo)
    assert "HLO_OK" in proc.stdout, proc.stdout + proc.stderr
    return {(a, s): (out / f"{a}_{s}.hlo").read_text()
            for a, s in ENCDEC_SERVE}


@pytest.mark.parametrize("arch,shape", ENCDEC_SERVE)
def test_partitioned_encdec_serving_flops_match_the_references_partition(
        encdec_serve_hlo, arch, shape):
    """Reduced seamless serving on a (1, 2) fake mesh: the rank's heads,
    ff columns and vocab rows; decode on its KV heads of both caches
    (``"heads"``).  Decode counts, within rtol 1e-2, the flops of the
    per-device module XLA partitions from the reference's ``serve_step``
    over the same mesh, half of one device's.  The prefill does too outside
    the decoder's causal attention (B11 on half the heads, set aside on
    both sides as in the training test)."""
    hlo = encdec_serve_hlo[(arch, shape)]
    ref = hlo_analysis.analyze(hlo).flops
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec(arch, shape, mesh, multi_pod=False, reduced=True)
    s = analyze(spec.fn, spec.local_args, mesh)
    cfg = get_config(arch).reduced()
    ours = s.flops
    if shape == "prefill_32k":
        S = spec.meta["seq"]
        dots = _hlo_dots(hlo)
        ref -= sum(v for k, v in dots.items() if _attention(k, S))
        ours -= sum(v for (_, ins, outs), v in s.products.items()
                    if _attention(ins + outs, S))
        ours -= sum(k["flops"] for k in s.kernels.values())
        q = torch.empty((spec.meta["global_batch"], cfg.n_heads // 2, S,
                         cfg.hd), device="meta")
        fwd = s.kernels["flash_attention_fwd"]
        assert fwd["flops"] == fwd["calls"] * attention_flops(q, q, True, 4)
    else:
        assert spec.meta["cache_layout"] == "heads"
        one = FakeMesh((1, 1), ("data", "model"))
        whole = specs.build_spec(arch, shape, one, multi_pod=False,
                                 reduced=True)
        assert s.flops == pytest.approx(
            0.5 * analyze(whole.fn, whole.local_args, one).flops, rel=1e-2)
    assert ours == pytest.approx(ref, rel=1e-2)


def test_encdec_decode_keeps_both_caches_on_their_heads():
    """seamless-m4t-medium decode_32k at full size on 16 × 16 (its 16
    heads and 16 KV heads, d_ff 4,096 over ``model``; its 256,206-row
    vocabulary does not divide 16, so the table and the logits stay whole,
    as XLA's module keeps them): the rank's caches are its one KV head of
    the self cache's 32,768 slots and of the cross cache's 8,192 frames, a
    step all-gathers no parameter (``fc_out``'s bias, 12 layers, does not
    split 16) and reads no encoder leaf, and it sums each decoder layer's
    self- and cross-attention and MLP rows, nothing else."""
    mesh = _fake("16x16")
    spec = specs.build_spec("seamless-m4t-medium", "decode_32k", mesh,
                            multi_pod=False)
    assert spec.meta["cache_layout"] == "heads"
    cfg = get_config("seamless-m4t-medium")
    L, n = cfg.n_layers, mesh.shape["model"]
    part = spec.fn.layout["cache_part"]
    assert part.heads and part.kv and part.ff and not part.vocab
    assert part.cross_cache == "heads"
    cache = spec.local_args[1]
    B = cache["self_k"].shape[1]
    assert tuple(cache["self_k"].shape) == (L, B, 32768, 1, cfg.hd)
    assert tuple(cache["cross_k"].shape) == (L, B, 8192, 1, cfg.hd)
    s = analyze(spec.fn, spec.local_args, mesh)
    assert s.mesh_stats == {"reduce_from": s.mesh_stats["reduce_from"]}
    assert s.mesh_stats["reduce_from"]["calls"] == 3 * L


# ---------------------------------------------------------------------------
# collectives against a live round on two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """The module's one spawn of two gloo ranks (``torch_mesh.dryrun_rank``):
    each rank's live rounds and serving runs."""
    return tm.spawn(tm.dryrun_rank, 2, tmp_path_factory.mktemp("live"))


def test_trace_collectives_equal_a_live_round(live):
    for name, shape, mode, arch in tm.DRYRUN_ROUNDS:
        mesh = FakeMesh(shape, ("data", "model"))
        init_fn, step = tm.dryrun_trainer(mesh, mode, "meta", arch)
        state = init_fn(0)
        batch = tm.dryrun_batch(mesh, mode, "meta")
        s = analyze(lambda st, b: step(st, b, key=tm.DRYRUN_KEY),
                    (state, batch), mesh)
        assert s.mesh_stats, name
        for rank in (0, 1):
            assert s.mesh_stats == live[rank][name]["stats"], (name, rank)
            assert np.isfinite(live[rank][name]["loss"])
        # the reference's kinds count the same calls
        assert sum(s.coll_count.values()) == sum(
            v["calls"] for v in s.mesh_stats.values())


# ---------------------------------------------------------------------------
# serving on a mesh against one device, and its trace against the live ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_alone():
    """Each served arch on one device: the path ``test_torch_serve`` holds
    to JAX."""
    return {arch: tm.serve_run(arch) for arch in
            dict.fromkeys(a for a, _ in tm.DRYRUN_SERVE)}


def _rank_rows(shape, rank: int) -> slice:
    b = tm.SERVE_BATCH // shape[0]
    j = rank // shape[1]                     # the rank's data coordinate
    return slice(j * b, (j + 1) * b)


@pytest.mark.parametrize("arch,shape", tm.DRYRUN_SERVE)
def test_serving_on_a_mesh_equals_one_device(live, served_alone, arch,
                                             shape):
    """Each rank's prefill logits and greedy tokens are its rows of one
    device's, and its final cache is its block of one device's under the
    layout the step records (the reference's cache specs for granite-8b,
    whose products partition over ``model``, on its KV heads; for
    falcon-mamba-7b, whose inner channels partition, on its channels;
    for recurrentgemma-2b, whose RG-LRU channels partition, its state on
    its channels and its attention window on its slots): f32, 1e-5."""
    want = served_alone[arch]
    for rank in (0, 1):
        got = live[rank][(arch, shape)]
        rows = _rank_rows(shape, rank)
        np.testing.assert_allclose(got["logits"], want["logits"][rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["tokens"], want["tokens"][rows])
        assert got["layout"]["cache"] == (
            {"granite-8b": "heads", "falcon-mamba-7b": "inner",
             "recurrentgemma-2b": "seq"}[arch] if shape[1] > 1
            else "batch")
        for (path, c), (_, sp), (_, mine) in zip(
                tree_paths(want["cache"]),
                tree_paths(got["layout"]["cache_specs"]),
                tree_paths(got["cache"])):
            block = tm.cache_block(c, sp, got["coord"], got["mesh"])
            np.testing.assert_allclose(mine, block, rtol=1e-5, atol=1e-5,
                                       err_msg="/".join(map(str, path)))


@pytest.mark.parametrize("arch,shape", tm.DRYRUN_SERVE)
def test_trace_serving_collectives_equal_the_live_ranks(live, arch, shape):
    """The prefill and one greedy step traced on the fake mesh count the
    calls and bytes by op that each live rank's ``Mesh.stats`` recorded."""
    from repro_torch.serve import make_prefill, make_serve_step

    mesh = FakeMesh(shape, ("data", "model"))
    model = tm._f32_model(arch)
    full = model.init(0, device="meta")
    b = tm.SERVE_BATCH // shape[0]
    toks = torch.empty((b, tm.SERVE_PROMPT), dtype=torch.int32,
                       device="meta")
    prefill = make_prefill(model, mesh)
    s_pre = analyze(prefill, (prefill.shard(full), {"tokens": toks}), mesh)
    step = make_serve_step(model, mesh)
    cache = step.init_cache(tm.SERVE_BATCH, tm.SERVE_PROMPT + tm.SERVE_STEPS,
                            device="meta")
    s_dec = analyze(step, (step.shard(full), cache, toks[:, 0],
                           tm.SERVE_PROMPT + tm.SERVE_STEPS - 2), mesh)
    # a pure-data mesh holds the params whole: nothing to gather
    assert bool(s_pre.mesh_stats) == bool(s_dec.mesh_stats) == (shape[1] > 1)
    for rank in (0, 1):
        stats = live[rank][(arch, shape)]["stats"]
        assert s_pre.mesh_stats == stats["prefill"], rank
        assert s_dec.mesh_stats == stats["decode"], rank


@pytest.mark.parametrize("arch,shape,prompt,steps", tm.DRYRUN_SERVE_MOE)
def test_trace_moe_serving_collectives_equal_the_live_ranks(
        live, arch, shape, prompt, steps):
    """Reduced deepseek-v3 served on (1, 2) (MLA's latent cache split on
    the sequence): the prefill and one greedy step traced on the fake mesh
    count the calls and bytes by op that each live rank's ``Mesh.stats``
    recorded, and the step gathers no parameter."""
    from repro_torch.serve import make_prefill, make_serve_step

    mesh = FakeMesh(shape, ("data", "model"))
    model = tm._f32_model(arch)
    full = model.init(0, device="meta")
    b = tm.SERVE_BATCH // shape[0]
    toks = torch.empty((b, prompt), dtype=torch.int32, device="meta")
    prefill = make_prefill(model, mesh)
    s_pre = analyze(prefill, (prefill.shard(full), {"tokens": toks}), mesh)
    step = make_serve_step(model, mesh)
    cache = step.init_cache(tm.SERVE_BATCH, prompt + steps, device="meta")
    assert step.layout["cache"] == "seq"
    s_dec = analyze(step, (step.shard(full), cache, toks[:, 0],
                           prompt + steps - 2), mesh)
    assert "all_gather" not in s_dec.mesh_stats
    for rank in (0, 1):
        got = live[rank][(arch, shape, prompt, steps)]
        assert got["layout"]["cache"] == "seq"
        assert s_pre.mesh_stats == got["stats"]["prefill"], rank
        assert s_dec.mesh_stats == got["stats"]["decode"], rank


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------

def test_packed_round_collectives_within_leafwise_on_16x16():
    calls = {}
    for packed in (None, False):
        mesh = _fake("16x16")
        spec = specs.build_spec("granite-8b", "train_4k", mesh,
                                multi_pod=False, reduced=True,
                                packed_uplink=packed)
        calls[packed] = collective_calls(analyze(spec.fn, spec.local_args,
                                                 mesh))
    assert 0 < calls[None] <= 1.1 * calls[False]


def test_k_rounds_count_k_times_one_round():
    mesh = FakeMesh((1, 2), ("data", "model"))
    init_fn, step = tm.dryrun_trainer(mesh, "replicated", "meta")
    batch = tm.dryrun_batch(mesh, "replicated", "meta")

    def rounds(k):
        st = init_fn(0)
        with tracing(mesh, (st, batch)) as tr:
            for r in range(k):
                st, _ = step(st, batch, key=tm.DRYRUN_KEY + r)
        return tr.summary()
    one, three = rounds(1), rounds(3)
    assert one.flops > 0 and three.flops == 3 * one.flops
    assert three.coll_count == {k: 3 * v for k, v in one.coll_count.items()}
    assert three.coll_bytes == {k: 3 * v for k, v in one.coll_bytes.items()}
    assert three.mesh_stats == {
        op: {"calls": 3 * v["calls"], "bytes": 3 * v["bytes"]}
        for op, v in one.mesh_stats.items()}


#: the keys of a result, as the reference's ``run_one`` writes them
RESULT_KEYS = {"arch", "shape", "mesh", "chips", "meta", "timings", "memory",
               "collectives", "roofline"}


def test_cli_writes_results_and_the_twins_read_them(tmp_path, capsys):
    out = str(tmp_path / "dry")
    for arch, shape in (("recurrentgemma-2b", "train_4k"),
                        ("falcon-mamba-7b", "long_500k")):
        assert dryrun.main(["--arch", arch, "--shape", shape, "--reduced",
                            "--out", out]) == 0
        path = os.path.join(out, f"{arch}_{shape}_16x16.json")
        r = json.load(open(path))
        assert RESULT_KEYS <= set(r)
        assert r["chips"] == 256 and r["mesh"] == "16x16"
        rf = r["roofline"]
        for key in ("compute_s", "memory_s", "collective_s", "dominant",
                    "model_flops", "useful_flop_fraction"):
            assert key in rf
        assert rf["compute_s"] >= 0 and rf["memory_s"] > 0
        assert r["collectives"]["bytes_per_device"] >= 0
        assert r["collectives"]["collective_calls"] >= 0
        assert r["trace"]["flops"] > 0 and r["timings"]["trace_s"] >= 0
        assert r["memory"]["argument_size_in_bytes"] > 0
        assert r["hardware"]["device"] == "NVIDIA H100 80GB HBM3"
    assert "[ ok ]" in capsys.readouterr().out
    # a combination that fails leaves its traceback, as the reference's
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--reduced", "--out", out]) == 0
    err = os.path.join(out, "no-such-arch_train_4k_16x16.json.err")
    assert "KeyError" in open(err).read()

    rows = roofline.table(out)
    assert sorted(r["arch"] for r in rows) == ["falcon-mamba-7b",
                                               "recurrentgemma-2b"]
    summ = roofline.roofline_summary(out)
    assert summ["n_results"] == 2 and sum(
        summ["dominant_counts"].values()) == 2
    assert summ["worst_useful_flop_fraction"]["arch"] == "recurrentgemma-2b"
    assert "recurrentgemma-2b | train_4k" in roofline.markdown_table(out)
    sec = report.dryrun_section(out)
    assert "NVIDIA H100 80GB HBM3, 700 W" in sec
    assert "2/40 combinations traced" in sec
    assert "no-such-arch_train_4k_16x16 | failed:" in sec
    roof = report.roofline_section(out)
    assert "falcon-mamba-7b | long_500k" in roof
    assert "NVIDIA H100 80GB HBM3, 700 W" in roof
    assert len(report.load("16x16", out)) == 2
    assert report.load("2x16x16", out) == []


def test_fused_round_with_a_channel_step_traces_on_meta():
    """A fused round whose AR(1) step arrives as tensors traces on ``meta``
    (the kernel's path: no value to read) and counts the kernel once."""
    from repro_torch.core import transport
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.cplx import Complex

    W, d = 4, 64

    def z(*shape):
        return torch.empty(shape, device="meta")
    theta, noise = z(W, d), z(d)
    lam, h, w = (Complex(z(W, d), z(W, d)) for _ in range(3))
    rho_f = torch.empty((), device="meta")
    redraw = torch.empty((), dtype=torch.bool, device="meta")
    s = analyze(lambda: transport.ota_round_fused(
        theta, lam, h, noise, 0.5, ChannelConfig(n_workers=W),
        chan_step=(w, rho_f, redraw)), ())
    # the stats pass with the fused channel step, then the demodulation
    assert {k: v["calls"] for k, v in s.kernels.items()} == {
        "ota_round_stats": 1, "ota_demodulate_dyn": 1}
    # the step's innovations are read once: the kernel's bytes count them
    assert s.kernels["ota_round_stats"]["bytes"] >= 7 * W * d * 4
    assert s.mem_bytes > 0
