"""The port's shard-local packing (``core.packing.ShardPackSpec`` and every
function over it) and sharding rules (``launch.shardings``) against the
JAX package's, in process and without ranks: the layout math is pure, so
the same tree gives the same spec, buffers, perms and masks bit for bit,
and the same shard dims for every registry family."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import cplx as jcplx  # noqa: E402
from repro.core import packing as jp  # noqa: E402

from repro_torch.core import packing as tp  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402

from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

W = 3


def _np_tree(shapes, seed):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal((W,) + s).astype(np.float32)
            for k, s in shapes.items()}


#: test_packing.py's mixed tree (flatten order b, norm, wo, wq): two
#: model-sharded leaves and a replicated segment of 5 + 1 elements that
#: pads unevenly
MIXED = {"wq": (4, 8), "wo": (8, 4), "norm": (5,), "b": ()}
MIXED_DIMS = [None, None, 0, 1]
#: one leaf per 2-D ownership class (flatten order b, gate, wo, wq): A
#: (wq: fsdp 0 x model 1), B (wo: model only), C (gate: fsdp only), D (b:
#: replicated, 3 elements over 4 shards)
GRID = {"wq": (4, 8), "wo": (8, 4), "gate": (6, 2), "b": (3,)}
GRID_DIMS = ([None, None, 0, 1], [None, 0, None, 0])

#: (case id, shapes, model dims, fsdp dims, n_model, n_fsdp); the 4-shard
#: cases pad their segments
CASES = [("mixed-2", MIXED, MIXED_DIMS, None, 2, 1),
         ("mixed-4", MIXED, MIXED_DIMS, None, 4, 1),
         ("grid-2x2", GRID, GRID_DIMS[0], GRID_DIMS[1], 2, 2)]


def _specs(case):
    _, shapes, md, fd, nm, nf = case
    arrs = _np_tree(shapes, 0)
    jtree = {k: jnp.asarray(v) for k, v in arrs.items()}
    ttree = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    js = jp.build_shard_packspec(jtree, md, nm, batch_dims=1, fsdp_dims=fd,
                                 n_fsdp=nf)
    ts = tp.build_shard_packspec(ttree, md, nm, batch_dims=1, fsdp_dims=fd,
                                 n_fsdp=nf)
    return arrs, jtree, ttree, js, ts


def _resident(arrs, ts, j):
    """Shard j's resident blocks of the global numpy tree, as JAX leaves
    and as torch leaves."""
    t_tree = tp.shard_tree(ts, {k: torch.from_numpy(v.copy())
                                for k, v in arrs.items()}, j)
    return ({k: jnp.asarray(v.numpy()) for k, v in t_tree.items()},
            {k: v.clone() for k, v in t_tree.items()})


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_spec_fields_equal_jax(case):
    _, _, _, js, ts = _specs(case)
    for f in ("n_model", "n_fsdp", "shard_dims", "fsdp_dims",
              "local_offsets", "a_local", "b_leaves", "b_offsets", "b_size",
              "b_chunk", "c_leaves", "c_offsets", "c_size", "c_chunk",
              "rep_leaves", "rep_offsets", "rep_size", "rep_chunk"):
        assert getattr(ts, f) == getattr(js, f), f
    for p in ("n_shards", "b_start", "c_start", "sharded_local", "d_local",
              "d_pad", "b_pad", "c_pad", "rep_pad", "has_padding"):
        assert getattr(ts, p) == getattr(js, p), p
    assert ts.spec.offsets == js.spec.offsets and ts.spec.d == js.spec.d


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pack_global_and_local_bit_exact(case):
    arrs, jtree, ttree, js, ts = _specs(case)
    jbuf = jp.pack_shard_global(js, jtree)
    tbuf = tp.pack_shard_global(ts, ttree)
    _eq(tbuf, jbuf)
    back = tp.unpack_shard_global(ts, tbuf)
    jback = jp.unpack_shard_global(js, jbuf)
    for k in arrs:
        _eq(back[k], jback[k])
        _eq(back[k], arrs[k])
    for j in range(ts.n_shards):
        jloc, tloc = _resident(arrs, ts, j)
        lp = tp.pack_shard_local(ts, tloc, j)
        _eq(lp, jp.pack_shard_local(js, jloc, j))
        _eq(lp, tbuf[:, j * ts.d_local:(j + 1) * ts.d_local])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_perms_masks_and_segments_bit_exact(case):
    arrs, _, _, js, ts = _specs(case)
    _eq(tp.shard_perm(ts), jp.shard_perm(js))
    for j in range(ts.n_shards):
        jm, jf = tp.split_idx(ts, j)
        _eq(tp.shard_valid_mask(ts, j), jp.shard_valid_mask(js, j))
        _eq(tp.shard_perm_local(ts, j),
            np.asarray(jp.shard_perm_local(js, j)).astype(np.int64))
        for tf, jf_, arg in ((tp.b_segment_perm, jp.b_segment_perm, jm),
                             (tp.c_segment_perm, jp.c_segment_perm, jf)):
            a, b = tf(ts, arg), jf_(js, arg)
            assert (a is None) == (b is None)
            if a is not None:
                _eq(a, np.asarray(b).astype(np.int64))
        jloc, tloc = _resident(arrs, ts, j)
        for tf, jf_ in ((tp.b_segment, jp.b_segment),
                        (tp.c_segment, jp.c_segment),
                        (tp.rep_segment, jp.rep_segment)):
            a, b = tf(ts, tloc), jf_(js, jloc)
            assert (a is None) == (b is None)
            if a is not None:
                _eq(a, b)
    rp = tp.rep_segment_perm(ts)
    _eq(rp, np.asarray(jp.rep_segment_perm(js)).astype(np.int64))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_unpack_local_from_summed_segments(case):
    """Each shard's chunks scattered into zeroed segments and summed over
    the shards that split them (the mesh's all-reduce, here a plain sum)
    rebuild every resident leaf, as JAX's do."""
    arrs, _, ttree, js, ts = _specs(case)
    locs = [tp.pack_shard_local(ts, _resident(arrs, ts, j)[1], j)
            for j in range(ts.n_shards)]
    jlocs = [jnp.asarray(x.numpy()) for x in locs]

    def summed(mod, spec, bufs, kind):
        chunk = getattr(mod, f"shard_{kind}_chunk")
        scatter = getattr(mod, f"scatter_{kind}_chunk")
        if chunk(spec, bufs[0]) is None:
            return lambda j: None
        nm = spec.n_model

        def seg(j):
            jm, jf = j % nm, j // nm
            if kind == "b":     # over the fsdp shards of model shard jm
                idx = [(f * nm + jm, f) for f in range(spec.n_fsdp)]
            elif kind == "c":   # over the model shards of fsdp shard jf
                idx = [(jf * nm + m, m) for m in range(nm)]
            else:               # over every shard
                idx = [(k, k) for k in range(spec.n_shards)]
            return sum(scatter(spec, chunk(spec, bufs[k]), a)
                       for k, a in idx)
        return seg

    tsegs = {k: summed(tp, ts, locs, k) for k in ("b", "c", "rep")}
    jsegs = {k: summed(jp, js, jlocs, k) for k in ("b", "c", "rep")}
    for j in range(ts.n_shards):
        out = tp.unpack_shard_local(ts, locs[j], tsegs["rep"](j),
                                    b_seg=tsegs["b"](j), c_seg=tsegs["c"](j))
        jout = jp.unpack_shard_local(js, jlocs[j], jsegs["rep"](j),
                                     b_seg=jsegs["b"](j),
                                     c_seg=jsegs["c"](j))
        want = _resident(arrs, ts, j)[1]
        for k in arrs:
            _eq(out[k], jout[k])
            _eq(out[k], want[k])


def test_cplx_global_roundtrip_equals_jax():
    case = CASES[2]
    arrs, _, _, js, ts = _specs(case)
    im = _np_tree(GRID, 1)
    tc = {k: Complex(torch.from_numpy(arrs[k].copy()),
                     torch.from_numpy(im[k].copy())) for k in arrs}
    jc = {k: jcplx.Complex(jnp.asarray(arrs[k]), jnp.asarray(im[k]))
          for k in arrs}
    tb = tp.pack_shard_global_cplx(ts, tc)
    jb = jp.pack_shard_global_cplx(js, jc)
    _eq(tb.re, jb.re)
    _eq(tb.im, jb.im)
    back = tp.unpack_shard_global_cplx(ts, tb)
    for k in arrs:
        _eq(back[k].re, arrs[k])
        _eq(back[k].im, im[k])


def test_one_by_one_grid_is_the_packed_layout():
    """A 1 x 1 grid (a pure-data mesh) packs every leaf in the replicated
    segment, in leaf order: the trainer's pure-data layout is PackSpec's."""
    arrs = _np_tree(MIXED, 0)
    tree = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    ts = tp.build_shard_packspec(tree, [None] * 4, 1, batch_dims=1)
    assert ts.d_pad == ts.spec.d and not ts.has_padding
    _eq(tp.pack_shard_local(ts, tree, 0), tp.pack(ts.spec, tree))


# ---------------------------------------------------------------------------
# the sharding rules on every registry family
# ---------------------------------------------------------------------------

def _families():
    from repro_torch.models.registry import list_archs
    return list_archs()


#: (mesh shape, axes): the (1, 2) model grid, the launcher's (1, 2, 1)
#: fsdp grid and a 2 x 2 shard grid
MESHES = [((1, 2), ("data", "model")), ((1, 2, 1), ("data", "fsdp", "model")),
          ((1, 2, 2), ("data", "fsdp", "model"))]


@pytest.mark.parametrize("arch", _families())
def test_shard_dims_and_pspecs_equal_jax(arch):
    from repro.launch import shardings as js
    from repro.models import get_model as jget_model

    from repro_torch.launch import shardings as ts
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves, tree_map

    jm = jget_model(arch, reduced=True)
    shapes = jax.eval_shape(jax.vmap(jm.init), jax.random.split(
        jax.random.PRNGKey(0), 2))
    tm = get_model(arch, reduced=True)
    p0 = tm.init(0, device="cpu")
    twork = tree_map(lambda l: l.expand((2,) + tuple(l.shape)), p0)
    jleaves = jax.tree_util.tree_leaves(shapes)
    tleaves = tree_leaves(twork)
    assert [tuple(a.shape) for a in jleaves] == \
        [tuple(b.shape) for b in tleaves]
    for shape, axes in MESHES:
        jmesh = jax.sharding.AbstractMesh(shape, axes)
        tmesh = abstract_mesh(shape, axes)
        assert ts.model_shard_dims(twork, tm.cfg, tmesh, multi_pod=False) \
            == js.model_shard_dims(shapes, jm.cfg, jmesh, multi_pod=False)
        assert ts.shard_dims_2d(twork, tm.cfg, tmesh, multi_pod=False) == \
            js.shard_dims_2d(shapes, jm.cfg, jmesh, multi_pod=False)
        for wd in (True, False):
            tree_t = twork if wd else p0
            tree_j = shapes if wd else jax.eval_shape(
                jm.init, jax.random.PRNGKey(0))
            tps = tree_leaves(ts.tree_pspecs(tree_t, tm.cfg, tmesh,
                                             worker_dim=wd, fsdp=True,
                                             multi_pod=False))
            jps = jax.tree_util.tree_leaves(
                js.tree_pspecs(tree_j, jm.cfg, jmesh, worker_dim=wd,
                               fsdp=True, multi_pod=False),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert [tuple(p) for p in jps] == [tuple(p) for p in tps]
        assert ts.rules_for(tm.cfg, tmesh, multi_pod=False,
                            fl_replicated=True) == \
            js.rules_for(jm.cfg, jmesh, multi_pod=False, fl_replicated=True)
        assert ts.batch_pspec((2, 4, 16), tmesh, 0, False) == \
            tuple(js.batch_pspec((2, 4, 16), jmesh, 0, False))
