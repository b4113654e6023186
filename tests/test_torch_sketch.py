"""The port's count-sketch codec (``repro_torch.core.sketch``) against the JAX
package's ``repro.core.sketch``: the hash on indices that straddle 2³²
(JAX given the ``uint32`` index mod 2³², the port the int64 index or a leaf
offset past 2³²), the packed, hashed and shard-local codecs with offsets,
and ``SketchPlan`` with JAX's buckets and signs.  Port against port: the
chunked, leaf-by-leaf encode against the one-buffer encode, and the
linearity property of ``tests/test_properties.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import sketch as jsk  # noqa: E402

from repro_torch.core import sketch as sk  # noqa: E402

from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SEED = 17
TOL = dict(rtol=1e-6, atol=1e-6)
#: indices around 2³² and past it, up to granite-8b's packed size
WRAP = np.array([0, 1, 7, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32,
                 2 ** 32 + 1, 2 ** 32 + 12_345, 2 ** 33 + 3,
                 8_053_362_688 - 1], dtype=np.int64)


def _j(x):
    return jnp.asarray(x)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("seed", [SEED, SEED + 101, 0])
@pytest.mark.parametrize("d_s", [8, 1000, 31_458_448])
def test_bucket_and_sign_straddle_2_32(seed, d_s):
    j_idx = _j((WRAP % 2 ** 32).astype(np.uint32))
    t_idx = torch.from_numpy(WRAP)
    np.testing.assert_array_equal(sk.bucket_of(t_idx, d_s, seed).numpy(),
                                  _np(jsk.bucket_of(j_idx, d_s, seed)))
    np.testing.assert_array_equal(sk.sign_of(t_idx, seed).numpy(),
                                  _np(jsk.sign_of(j_idx, seed)))


def test_leaf_offset_past_2_32_wraps_as_uint32():
    """A leaf at packed offset o ≥ 2³² hashes as (o + i) mod 2³², the
    offset JAX's ``uint32`` index arithmetic gives it."""
    n, d_s = 300, 97
    off = 2 ** 32 + 1_000
    jb = _np(jsk.packed_bucket(n, d_s, SEED, off - 2 ** 32))
    np.testing.assert_array_equal(sk.packed_bucket(n, d_s, SEED, off).numpy(),
                                  jb)
    # the wrap inside one leaf: [2³² − 100, 2³² + 200)
    off = 2 ** 32 - 100
    jb = np.concatenate([_np(jsk.packed_bucket(100, d_s, SEED, off)),
                         _np(jsk.packed_bucket(200, d_s, SEED, 0))])
    np.testing.assert_array_equal(sk.packed_bucket(n, d_s, SEED, off).numpy(),
                                  jb)
    np.testing.assert_array_equal(
        sk.packed_sign(n, SEED, off).numpy(),
        np.concatenate([_np(jsk.packed_sign(100, SEED, off)),
                        _np(jsk.packed_sign(200, SEED, 0))]))


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(3)
    return {"v1": rng.standard_normal(1_000).astype(np.float32),
            "vw": rng.standard_normal((3, 1_000)).astype(np.float32),
            "s1": rng.standard_normal(77).astype(np.float32),
            "sw": rng.standard_normal((3, 77)).astype(np.float32),
            "leaf": rng.standard_normal((5, 6, 7)).astype(np.float32)}


@pytest.mark.parametrize("key", ["v1", "vw"])
@pytest.mark.parametrize("offset", [0, 12_345, 2 ** 31 + 5])
def test_packed_codec_matches_jax(planes, key, offset):
    v = planes[key]
    want = _np(jsk.encode_packed(_j(v), 77, SEED, offset))
    got = sk.encode_packed(torch.from_numpy(v), 77, SEED, offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    s = planes["sw" if v.ndim == 2 else "s1"]
    want = _np(jsk.decode_packed(_j(s), v.shape[-1], SEED, offset))
    got = sk.decode_packed(torch.from_numpy(s), v.shape[-1], SEED, offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("offset", [0, 999])
def test_hashed_codec_matches_jax(planes, offset):
    leaf = planes["leaf"]
    want = _np(jsk.encode_hashed(_j(leaf), 77, SEED, offset))
    got = sk.encode_hashed(torch.from_numpy(leaf), 77, SEED, offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = _np(jsk.decode_hashed(_j(planes["s1"]), leaf.shape, SEED, offset))
    got = sk.decode_hashed(torch.from_numpy(planes["s1"]), leaf.shape, SEED,
                           offset)
    assert got.shape == leaf.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        sk.decode_hashed(torch.from_numpy(planes["s1"]), 11, SEED).numpy(),
        _np(jsk.decode_hashed(_j(planes["s1"]), 11, SEED)), **TOL)
    np.testing.assert_array_equal(
        sk.hashed_bucket((4, 9), 77, SEED, offset).numpy(),
        _np(jsk.hashed_bucket((4, 9), 77, SEED, offset)))
    np.testing.assert_array_equal(
        sk.hashed_sign((4, 9), SEED, offset).numpy(),
        _np(jsk.hashed_sign((4, 9), SEED, offset)))


@pytest.mark.parametrize("key", ["v1", "vw"])
def test_shard_local_codec_matches_jax(planes, key):
    v = planes[key]
    m = v.shape[-1]
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 2 ** 32, m, dtype=np.int64)
    idx[:5] = [2 ** 32 - 1, 0, 2 ** 32 - 2, 1, 2 ** 31]
    valid = rng.random(m) < 0.8
    j_idx = _j(idx.astype(np.uint32))
    want = _np(jsk.encode_shard_local(_j(v), j_idx, _j(valid), 77, SEED))
    got = sk.encode_shard_local(torch.from_numpy(v), torch.from_numpy(idx),
                                torch.from_numpy(valid), 77, SEED)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    s = planes["sw" if v.ndim == 2 else "s1"]
    want = _np(jsk.decode_shard_local(_j(s), j_idx, _j(valid), SEED))
    got = sk.decode_shard_local(torch.from_numpy(s), torch.from_numpy(idx),
                                torch.from_numpy(valid), SEED)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got.numpy()[..., ~valid].any()


def test_sketch_plan_with_jax_planes(planes):
    plan_j = jsk.SketchPlan.build(jax.random.PRNGKey(5), 1_000, 77)
    plan = sk.SketchPlan.from_planes(torch.from_numpy(_np(plan_j.bucket)),
                                     torch.from_numpy(_np(plan_j.sign)), 77)
    assert (plan.d, plan.d_s) == (1_000, 77)
    for key, skey in (("v1", "s1"), ("vw", "sw")):
        np.testing.assert_allclose(
            sk.encode(plan, torch.from_numpy(planes[key])).numpy(),
            _np(jsk.encode(plan_j, _j(planes[key]))), **TOL)
        np.testing.assert_allclose(
            sk.decode(plan, torch.from_numpy(planes[skey])).numpy(),
            _np(jsk.decode(plan_j, _j(planes[skey]))), **TOL)
    assert sk.encode_decode_gain(plan) == jsk.encode_decode_gain(plan_j)


def test_sketch_plan_build():
    gen = torch.Generator().manual_seed(0)
    plan = sk.SketchPlan.build(gen, 10_000, 64)
    assert plan.bucket.shape == (10_000,) and plan.sign.shape == (10_000,)
    assert int(plan.bucket.min()) >= 0 and int(plan.bucket.max()) < 64
    assert set(plan.sign.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(plan.sign.mean())) < 0.05
    assert sk.encode_decode_gain(plan) == 1.0 + 10_000 / 64


def test_chunked_leafwise_encode_equals_one_buffer():
    """Σ over leaves and chunks of ``encode_packed(chunk, offset)`` is the
    global encode of the packed buffer, up to the order of each bucket's
    sum."""
    rng = np.random.default_rng(6)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((3, 50), (777,), (2, 3, 41))]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    want = sk.encode_packed(flat, 61, SEED, 0)
    for chunk in (1, 64, 100, 10_000):
        got = sk.encode_chunked(leaves, 61, SEED, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(
        want.numpy(), _np(jsk.encode_packed(_j(flat.numpy()), 61, SEED, 0)),
        **TOL)
    out = torch.ones(61)
    sk.encode_chunked(leaves, 61, SEED, out=out, chunk=100)
    np.testing.assert_allclose(out.numpy(), want.numpy() + 1.0, **TOL)
    # the decode of a chunk at its offset is the slice of the whole decode
    whole = sk.decode_packed(want, flat.shape[0], SEED)
    for a, b in sk.chunks(flat.shape[0], 200):
        assert torch.equal(sk.decode_packed(want, b - a, SEED, a),
                           whole[a:b])


@given(seed=st.integers(0, 2 ** 16), d=st.integers(4, 256),
       ratio=st.integers(1, 8))
@settings(max_examples=25, deadline=None)
def test_sketch_linearity_and_scale(seed, d, ratio):
    """``tests/test_properties.py``'s property on the port: the encode is
    linear and decode ∘ encode correlates positively with its input."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(d, generator=g)
    d_s = max(4, d // ratio)
    s1 = sk.encode_hashed(v, d_s, seed=5)
    s2 = sk.encode_hashed(3.0 * v, d_s, seed=5)
    np.testing.assert_allclose((3.0 * s1).numpy(), s2.numpy(), rtol=1e-4,
                               atol=1e-4)
    vh = sk.decode_hashed(s1, tuple(v.shape), seed=5)
    assert float(torch.dot(v, vh)) > 0.0
