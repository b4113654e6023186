"""The port's ``core.packing`` against the JAX package's: the same tree gives
the same leaf order, offsets, sizes and packed bits; roundtrips are bit
exact and restore the leaf dtypes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import cplx as jcplx  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402

from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.packing import (build_packspec, pack,  # noqa: E402
                                      pack_cplx, unpack, unpack_cplx)


def _np_tree(W, seed=0):
    """Mixed-dtype/shape tree with unsorted keys; W=None -> no worker dim."""
    lead = () if W is None else (W,)
    r = np.random.default_rng(seed)
    return {
        "w": r.standard_normal(lead + (5,)).astype(np.float32),
        "emb": jnp.asarray(r.standard_normal(lead + (7, 3)),
                           jnp.bfloat16),
        "scale": r.standard_normal(lead).astype(np.float32),  # scalar leaf
        "blk": {"z": r.standard_normal(lead + (2, 2, 2)).astype(np.float32),
                "a": r.standard_normal(lead + (4,)).astype(np.float32)},
    }


def _both(W):
    tree = _np_tree(W)
    jtree = {k: (jnp.asarray(v) if not isinstance(v, dict)
                 else {kk: jnp.asarray(vv) for kk, vv in v.items()})
             for k, v in tree.items()}
    ttree = model_params_from_numpy(
        {k: (np.asarray(v) if not isinstance(v, dict) else v)
         for k, v in tree.items()}, device="cpu")
    return jtree, ttree


@pytest.mark.parametrize("W", [1, 3])
def test_roundtrip_bit_exact(W):
    _, tree = _both(W)
    spec = build_packspec(tree, batch_dims=1)
    assert spec.d == 5 + 21 + 1 + 8 + 4
    buf = pack(spec, tree)
    assert buf.shape == (W, spec.d) and buf.dtype == torch.float32
    out = unpack(spec, buf)
    for name in ("w", "emb", "scale"):
        assert out[name].dtype == tree[name].dtype
        assert torch.equal(out[name], tree[name])
    for name in ("a", "z"):
        assert torch.equal(out["blk"][name], tree["blk"][name])


@pytest.mark.parametrize("W", [None, 3])
def test_layout_and_bits_equal_jax(W):
    jtree, ttree = _both(W)
    bd = 0 if W is None else 1
    jspec = jpacking.build_packspec(jtree, batch_dims=bd)
    spec = build_packspec(ttree, batch_dims=bd)
    assert spec.offsets == jspec.offsets and spec.sizes == jspec.sizes
    assert spec.shapes == jspec.shapes and spec.d == jspec.d
    want = np.asarray(jpacking.pack(jspec, jtree))
    assert np.array_equal(pack(spec, ttree).numpy(), want)


def test_unpack_views_and_cast_false_keeps_f32():
    _, tree = _both(2)
    spec = build_packspec(tree, batch_dims=1)
    buf = pack(spec, tree)
    out = unpack(spec, buf, cast=False)
    assert out["emb"].dtype == torch.float32
    assert out["w"].data_ptr() == buf[:, spec.offsets[
        spec.shapes.index((5,))]:].data_ptr()
    buf.add_(1.0)                        # views see the buffer's change
    assert torch.equal(out["w"], tree["w"] + 1.0)


def test_pack_cplx_roundtrip_and_equals_jax():
    _, tree = _both(3)
    r = np.random.default_rng(5)
    planes = {k: (r.standard_normal(v.shape).astype(np.float32),
                  r.standard_normal(v.shape).astype(np.float32))
              for k, v in (("w", tree["w"]), ("scale", tree["scale"]))}
    ctree = {k: Complex(torch.from_numpy(a), torch.from_numpy(b))
             for k, (a, b) in planes.items()}
    jctree = {k: jcplx.Complex(jnp.asarray(a), jnp.asarray(b))
              for k, (a, b) in planes.items()}
    spec = build_packspec(ctree, batch_dims=1)
    buf = pack_cplx(spec, ctree)
    jbuf = jpacking.pack_cplx(jpacking.build_packspec(
        jctree, batch_dims=1), jctree)
    assert np.array_equal(buf.re.numpy(), np.asarray(jbuf.re))
    assert np.array_equal(buf.im.numpy(), np.asarray(jbuf.im))
    back = unpack_cplx(spec, buf)
    for k in planes:
        assert isinstance(back[k], Complex)
        assert torch.equal(back[k].re, ctree[k].re)
        assert torch.equal(back[k].im, ctree[k].im)


def test_shape_mismatch_raises():
    _, tree = _both(3)
    spec = build_packspec(tree, batch_dims=1)
    bad = dict(tree, w=torch.zeros(3, 6))
    with pytest.raises(ValueError, match="does not end with"):
        pack(spec, bad)
    ragged = dict(tree, w=torch.zeros(2, 5))
    with pytest.raises(ValueError, match="leading dims"):
        pack(spec, ragged)
    with pytest.raises(ValueError, match="spec.d"):
        unpack(spec, torch.zeros(3, spec.d + 1))
    with pytest.raises(ValueError, match="leaves"):
        pack(spec, {"w": tree["w"]})
