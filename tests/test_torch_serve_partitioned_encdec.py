"""The audio enc-dec family's partitioned serving (``repro_torch.serve`` on
(data, model) grids whose ``model`` axis splits the heads,
``models/partition``, ``models/encdec.py``) on gloo ranks on the CPU,
against the JAX package on the same parameters (its ``init``, converted):
its prefill's last logits, the cross cache ``prefill_cross`` fills, every
``decode_step``'s logits, its greedy tokens and its caches, and its cache
specs.

Cases, reduced seamless-m4t-medium in f32 (2 encoder and 2 decoder
layers), each a prompt's prefill over stub frames, the cross cache filled
from the same frames (``serve_step.prefill_cross``), the prompt ingested a
token at a time through the greedy step and a few tokens generated:

* on (1, 2), one spawn of two ranks: 4 KV heads, both caches on the
  rank's KV heads (``"heads"``), a batch of 2, the decoder's layer count
  (the batch's entry on the caches' dim 1, where the reference's rule puts
  it on dim 0); one KV head, the self cache on its slots (``"seq"``) and
  the cross cache on its 16 frames (``"seq"``), the ranks' partial
  softmaxes joined; one KV head over 15 frames, which the axis does not
  divide, so the cross cache is whole on every rank (``"batch"``) beside
  the self cache on its slots;
* on (1, 4), one spawn of four ranks: vocabulary 514, which does not
  divide the axis, so the logits and the greedy token are whole on every
  rank while the heads and both caches split four ways (a batch of 2,
  moved as above).

Bounds: the prefill's logits, the cross cache and every step's logits (a
rank's vocab columns) within rtol 1e-5 (atol 1e-5) of JAX's; the greedy
tokens equal JAX's and bit-equal across the ranks; each rank's caches
within 1e-5 of its blocks of JAX's under the reference's cache specs.
The collectives are counted per layer: decode all-gathers no parameter
over ``model`` but ``fc_out``'s bias where the layout splits it on its
layer dim, and reads no encoder leaf.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.launch import shardings as JSH  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serve import make_prefill as jmake_prefill  # noqa: E402

from repro_torch.launch.mesh import FakeMesh  # noqa: E402
from repro_torch.models.partition import partition_for  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
ARCH = "seamless-m4t-medium"
#: (name, config fields replaced, model axis, batch, prompt, greedy steps,
#: frames)
CASES = (
    ("heads", {}, 2, 2, 4, 4, 16),
    ("kv1-seq", {"n_kv_heads": 1}, 2, 3, 4, 4, 16),
    ("kv1-odd-frames", {"n_kv_heads": 1}, 2, 3, 4, 4, 15),
    ("vocab-514", {"vocab_size": 514}, 4, 2, 4, 4, 16),
)
BY_NAME = {c[0]: c for c in CASES}
NAMES = list(BY_NAME)
#: each case's (self cache, cross cache) layout
LAYOUT = {"heads": ("heads", "heads"), "kv1-seq": ("seq", "seq"),
          "kv1-odd-frames": ("seq", "batch"),
          "vocab-514": ("heads", "heads")}
RTOL = ATOL = 1e-5


def _jcfg(name):
    return dataclasses.replace(jreg.get_config(ARCH).reduced(),
                               param_dtype="float32", **BY_NAME[name][1])


def _jax_case(name):
    """JAX's run of a case, as ``torch_mesh.serve_encdec_run`` serves it:
    its params (numpy), the prefill's last logits, the cross cache of the
    frames, each greedy step's logits, the generated tokens and the cache
    at the end."""
    _, _, _, b, p, s, f = BY_NAME[name]
    jm = jreg.build_model(_jcfg(name))
    cfg = jm.cfg
    pj = jm.init(KEY)
    toks = jnp.asarray(tm.serve_tokens(cfg.vocab_size, b, p).numpy())
    frames = jnp.asarray(tm.encdec_frames(b, f, cfg.d_model).numpy())
    out = {"params": jax.tree.map(np.asarray, pj),
           "logits": np.asarray(jax.jit(jmake_prefill(jm))(
               pj, {"tokens": toks, "frames": frames})),
           "logits_steps": []}
    memory = jencdec.encode(pj, cfg, frames, remat=False)
    ks, vs = jencdec.prefill_cross(pj, cfg, memory)
    out["cross"] = {"cross_k": np.asarray(ks), "cross_v": np.asarray(vs)}
    cache = dict(jm.init_cache(b, p + s, n_frames=f), cross_k=ks,
                 cross_v=vs)
    step = jax.jit(jm.decode_step)
    tok, gen = toks[:, 0], []
    for i in range(p + s - 1):
        logits, cache = step(pj, cache, tok, jnp.int32(i))
        out["logits_steps"].append(np.asarray(logits))
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        if i + 1 < p:
            tok = toks[:, i + 1]
        else:
            tok = nxt
            gen.append(np.asarray(nxt))
    out["tokens"] = np.stack(gen, axis=1)
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    return {name: _jax_case(name) for name in NAMES}


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    """Each case's ranks' results: one spawn of two ranks for the (1, 2)
    cases, one of four for the (1, 4) case."""
    out = {}
    for m in (2, 4):
        cases = [(n, over, b, p, s, f)
                 for n, over, mm, b, p, s, f in CASES if mm == m]
        res = tm.spawn(tm.serve_encdec_rank, m,
                       tmp_path_factory.mktemp(f"encdec{m}"), (1, m), cases,
                       {c[0]: jax_ref[c[0]]["params"] for c in cases})
        out.update({c[0]: [r[c[0]] for r in res] for c in cases})
    return out


def _vocab_cols(x, got, name):
    """The rank's vocab columns of a (B, V) array (all of them where the
    vocab does not split)."""
    if name == "vocab-514":
        return x
    n, j = got["mesh"]["model"], got["coord"]["model"]
    v = x.shape[-1] // n
    return x[:, j * v:(j + 1) * v]


def _leaves(tree):
    """(path, leaf) of a nested tree of arrays, in flatten order."""
    return [("/".join(p), x) for p, x in tree_paths(tree)]


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_references_cache_spec(ranks, name):
    """Each leaf's spec is the JAX package's ``cache_pspecs`` for the same
    cache on the same mesh: ``self_k``/``self_v`` and ``cross_k``/
    ``cross_v`` (L, B, T, KV, hd) on their KV heads where they divide the
    axis, else each on its own sequence where it divides the axis, else
    whole.  Where the decoder's layer count equals the batch the
    reference's rule takes the layer dim for the batch's: the same entries
    stand on dim 1."""
    _, _, m, b, p, s, f = BY_NAME[name]
    jcfg = _jcfg(name)
    jm = jreg.build_model(jcfg)
    amesh = AbstractMesh((1, m), ("data", "model"),
                         axis_types=(AxisType.Explicit,) * 2)
    cache = jax.eval_shape(lambda: jm.init_cache(b, p + s, n_frames=f))
    ref = dict(_leaves(JSH.cache_pspecs(cache, jcfg, amesh, b,
                                        multi_pod=False)))
    self_l, cross_l = LAYOUT[name]
    moved = []
    for r in ranks[name]:
        assert r["layout"]["cache"] == self_l
        assert r["cross_layout"] == cross_l
        specs = _leaves(r["layout"]["cache_specs"])
        assert [k for k, _ in specs] == list(ref)
        moved = []
        for k, sp in specs:
            want = tuple(ref[k]) + (None,) * (len(sp) - len(tuple(ref[k])))
            if jcfg.n_layers == b:
                assert want[0] is not None and want[1] is None, (k, want)
                want = (want[1], want[0]) + want[2:]
                moved.append(k)
            assert tuple(sp) == want, k
            layout = self_l if k.startswith("self") else cross_l
            on = {"heads": 3, "seq": 2}.get(layout)
            assert [d for d, e in enumerate(want) if e == "model"] == (
                [] if on is None else [on]), (k, want)
        assert r["layout"]["cache_batch_moved"] == moved
    assert bool(moved) == (jcfg.n_layers == b)


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax(ranks, jax_ref, name):
    """Each rank's gathered prefill logits and every step's vocab columns
    against JAX's prefill and ``decode_step`` logits."""
    want = jax_ref[name]
    for got in ranks[name]:
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=RTOL, atol=ATOL)
        assert len(got["logits_steps"]) == len(want["logits_steps"])
        for i, (a, w) in enumerate(zip(got["logits_steps"],
                                       want["logits_steps"])):
            np.testing.assert_allclose(a, _vocab_cols(w, got, name),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i}")


def _block(want, got, k):
    specs = dict(_leaves(got["layout"]["cache_specs"]))
    return tm.cache_block(want, specs[k], got["coord"], got["mesh"])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_cross_is_the_ranks_block_of_jaxs(ranks, jax_ref, name):
    """``serve_step.prefill_cross`` gives each rank its block of JAX's
    ``prefill_cross`` of the same frames: its KV heads, or its frames with
    every KV head, or all of them."""
    for got in ranks[name]:
        for k in ("cross_k", "cross_v"):
            w = jax_ref[name]["cross"][k]
            scale = float(np.abs(w).max())
            c = got["cross"][k]
            block = _block(w, got, k)
            assert c.shape == block.shape, k
            np.testing.assert_allclose(c, block, rtol=0, atol=ATOL * scale,
                                       err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_tokens_and_cache_match_jax(ranks, jax_ref, name):
    """The ranks' greedy tokens are JAX's, and each rank's cache leaves
    are its blocks of JAX's cache at the end (the self K/V written by the
    owner of each slot)."""
    want = dict(_leaves(jax_ref[name]["cache"]))
    for got in ranks[name]:
        np.testing.assert_array_equal(got["tokens"], jax_ref[name]["tokens"])
        leaves = _leaves(got["cache"])
        assert [k for k, _ in leaves] == list(want)
        for k, c in leaves:
            block = _block(want[k], got, k)
            assert c.shape == block.shape, k
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(c, block, rtol=0, atol=ATOL * scale,
                                       err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_the_ranks_agree_bitwise(ranks, name):
    """The ranks' tokens and gathered prefill logits, bit for bit."""
    r0 = ranks[name][0]
    for got in ranks[name][1:]:
        np.testing.assert_array_equal(got["tokens"], r0["tokens"])
        np.testing.assert_array_equal(got["logits"], r0["logits"])


def _want_calls(name):
    """The collectives by op of (the prefill, the cross prefill, a decode
    step) on a rank: each encoder layer sums ``wo``'s and ``fc_out``'s
    rows, each decoder layer its self- and cross-attention's ``wo`` and
    its ``fc_out``; the embedding's sum and the logits' gather (or the
    greedy token's max and min) where the vocab splits; ``fc_out``'s bias
    gathered where the layout splits it on its layer dim (both stacks in
    the prefills, the decoder's alone in decode, which reads no encoder
    leaf).  With one KV head every attention gathers its K/V projections
    of the rank's ``wk``/``wv`` columns (``gather_kv``), and decode on the
    split sequences gathers the query heads and joins the partial
    softmaxes of the self cache, and of the cross cache where it lies on
    its frames."""
    _, over, m, *_ = BY_NAME[name]
    cfg = tm.partition_cfg(ARCH, over)
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    vocab = cfg.vocab_size % m == 0
    bias = int(Ld % m == 0)
    self_l, cross_l = LAYOUT[name]

    def calls(**kw):
        return {k: {"model": v} for k, v in kw.items() if v}
    kv = self_l != "heads"
    pre = calls(reduce_from=vocab + 2 * Le + 3 * Ld,
                all_gather=2 * bias,
                gather_kv=kv * (Le + 2 * Ld), gather_vocab=vocab)
    cross = calls(reduce_from=2 * Le, all_gather=2 * bias,
                  gather_kv=kv * (Le + Ld))
    seq_attn = Ld * ((self_l == "seq") + (cross_l == "seq"))
    dec = calls(reduce_from=vocab + 3 * Ld, all_gather=bias,
                gather_kv=kv * Ld, gather_heads=seq_attn,
                softmax_max=seq_attn, softmax_sum=seq_attn,
                vocab_max=vocab, vocab_min=vocab)
    return pre, cross, dec


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_layer(ranks, name):
    pre, cross, dec = _want_calls(name)
    for r in ranks[name]:
        assert r["calls"]["prefill"] == pre, r["calls"]["prefill"]
        assert r["calls"]["cross"] == cross, r["calls"]["cross"]
        assert r["calls"]["decode"] == dec, r["calls"]["decode"]


def test_the_plan_reads_both_caches():
    """The enc-dec's decode plan is laid out from its ``self_k`` leaf and
    its ``cross_k`` leaf beside it: on the KV heads together; where they do
    not split, the self cache on its slots and the cross cache on its
    frames or whole; a cache led by another leaf, or without the cross
    cache's shape, raises."""
    mesh = FakeMesh((1, 2), ("data", "model"))
    cfg = tm.partition_cfg(ARCH, {})
    shape = (cfg.n_layers, 3, 8, cfg.n_kv_heads, cfg.hd)
    part = partition_for(cfg, mesh, cache=shape, cache_leaf="self_k",
                         cross=shape[:2] + (16,) + shape[3:])
    assert (part.cache, part.cross_cache) == ("heads", "heads")
    kv1 = tm.partition_cfg(ARCH, {"n_kv_heads": 1})
    shape = (kv1.n_layers, 3, 8, 1, kv1.hd)
    for frames, layout, axes in ((16, "seq", ("model",)), (15, "batch", ())):
        part = partition_for(kv1, mesh, cache=shape, cache_leaf="self_k",
                             cross=shape[:2] + (frames,) + shape[3:])
        assert (part.cache, part.seq_axes) == ("seq", ("model",))
        assert (part.cross_cache, part.cross_seq_axes) == (layout, axes)
        assert part.cross.cache == layout
    with pytest.raises(ValueError, match="no decode layout"):
        partition_for(cfg, mesh, cache=shape, cache_leaf="k", cross=shape)
    with pytest.raises(ValueError, match="cross cache"):
        partition_for(cfg, mesh, cache=shape, cache_leaf="self_k")
