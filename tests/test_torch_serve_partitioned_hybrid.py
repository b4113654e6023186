"""The hybrid family's partitioned serving (``repro_torch.serve`` on (data,
model) grids whose ``model`` axis splits the RG-LRU channels,
``models/partition``, ``models/hybrid.py``) on gloo ranks on the CPU,
against the JAX package on the same parameters (its ``init``,
converted): its prefill's last logits, every ``decode_step``'s logits,
its greedy tokens and its cache, and its cache specs.

Cases, reduced recurrentgemma-2b in f32 (5 layers: one super-block and
the (rec, rec) tail), each a prompt's prefill, the prompt ingested a token
at a time through the greedy step and a few tokens generated:

* on (1, 2), one spawn of two ranks: the RG-LRU state ``lru`` and conv
  window ``conv`` on the rank's channels, the attention's rotating window
  (64 slots, one KV head) on its slots (``"seq"``); the same with a window
  of 8 slots, run past its wrap; 8 layers (two super-blocks) with a batch
  of 2, the super-blocks' count (the batch's entry on the cache's dim 1,
  where the reference's rule puts it on dim 0), past the wrap; and
  ``lru_width`` 129, which does not split: the plan is None, every layer
  is gathered and the cache splits over the batch alone (``"batch"``);
* on (1, 4), one spawn of four ranks: 2 heads, which do not split, so
  the attention runs whole on its gathered weights while the RG-LRU and
  MLP products and the window's slots split four ways, past the wrap.

Bounds: the prefill's logits and every step's logits (a rank's vocab
columns) within rtol 1e-5 (atol 1e-5) of JAX's; the greedy tokens equal
JAX's and bit-equal across the ranks; each rank's cache within 1e-5 of its
block of JAX's cache under the reference's cache specs.  The collectives
are counted per layer: decode all-gathers no parameter over ``model`` but
the attention's where its heads do not split.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.launch import shardings as JSH  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serve import make_prefill as jmake_prefill  # noqa: E402

from repro_torch.launch.mesh import FakeMesh  # noqa: E402
from repro_torch.launch.shardings import shard_dims_2d  # noqa: E402
from repro_torch.models.partition import (gathered_model_leaf,  # noqa: E402
                                          partition_for)
from repro_torch.tree import tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
ARCH = "recurrentgemma-2b"
#: (name, config fields replaced (5 layers unless given), model axis,
#: batch, prompt, greedy steps)
CASES = (
    ("recurrentgemma", {}, 2, 3, 4, 4),
    ("window-wrap", {"attn_window": 8}, 2, 3, 6, 8),
    ("super-eq-batch", {"n_layers": 8, "attn_window": 8}, 2, 2, 6, 8),
    ("lru-129", {"lru_width": 129}, 2, 3, 4, 4),
    ("heads-whole", {"n_heads": 2, "attn_window": 8}, 4, 2, 6, 8),
)
BY_NAME = {c[0]: c for c in CASES}
NAMES = list(BY_NAME)
#: each case's cache layout (its attention window's; the RG-LRU state on
#: its channels wherever the plan is not None)
LAYOUT = {n: "batch" if n == "lru-129" else "seq" for n in NAMES}
RTOL = ATOL = 1e-5


def _over(name):
    return {"n_layers": 5, **BY_NAME[name][1]}


def _jcfg(name):
    return dataclasses.replace(jreg.get_config(ARCH).reduced(),
                               param_dtype="float32", **_over(name))


def _jax_case(name):
    """JAX's run of a case, as ``torch_mesh.serve_run`` serves it: its
    params (numpy), the prefill's last logits, each greedy step's logits,
    the generated tokens and the cache at the end."""
    _, _, _, b, p, s = BY_NAME[name]
    jm = jreg.build_model(_jcfg(name))
    pj = jm.init(KEY)
    toks = jnp.asarray(tm.serve_tokens(jm.cfg.vocab_size, b, p).numpy())
    out = {"params": jax.tree.map(np.asarray, pj),
           "logits": np.asarray(jax.jit(jmake_prefill(jm))(
               pj, {"tokens": toks})),
           "logits_steps": []}
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(b, p + s)
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
        cases = [(n, ARCH, _over(n), b, p, s)
                 for n, _, mm, b, p, s in CASES if mm == m]
        res = tm.spawn(tm.serve_partitioned_rank, m,
                       tmp_path_factory.mktemp(f"hybrid{m}"), (1, m), cases,
                       {c[0]: jax_ref[c[0]]["params"] for c in cases})
        out.update({c[0]: [r[c[0]] for r in res] for c in cases})
    return out


def _vocab_cols(x, got, name):
    """The rank's vocab columns of a (B, V) array (all of them where the
    plan does not partition)."""
    if LAYOUT[name] == "batch":
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
    cache on the same mesh: ``lru`` (L?, B, dw) and ``conv`` (L?, B, K −
    1, dw) on dw, the super-blocks' ``k``/``v`` (L, B, window, 1, hd) on
    the window's slots; the tail's leaves lead with the batch.  Where the
    super-blocks' count equals the batch the reference's rule takes their
    dim for the batch's: the same entries stand on dim 1.  Where ``lru``
    is unbound the cache is whole on ``model``."""
    _, _, m, b, p, s = BY_NAME[name]
    jcfg = _jcfg(name)
    jm = jreg.build_model(jcfg)
    amesh = AbstractMesh((1, m), ("data", "model"),
                         axis_types=(AxisType.Explicit,) * 2)
    cache = jax.eval_shape(lambda: jm.init_cache(b, p + s))
    ref = dict(_leaves(JSH.cache_pspecs(cache, jcfg, amesh, b,
                                        multi_pod=False)))
    n_super = jcfg.n_layers // len(jcfg.block_pattern)
    for r in ranks[name]:
        assert r["layout"]["cache"] == LAYOUT[name]
        specs = _leaves(r["layout"]["cache_specs"])
        assert [k for k, _ in specs] == list(ref)
        moved = []
        for k, sp in specs:
            want = tuple(ref[k]) + (None,) * (len(sp) - len(tuple(ref[k])))
            if LAYOUT[name] == "batch":
                assert "model" not in tuple(sp), k
                continue
            if k.startswith("super/") and n_super == b:
                assert want[0] is not None and want[1] is None, (k, want)
                want = (want[1], want[0]) + want[2:]
                moved.append(k)
            assert tuple(sp) == want, k
            on = {"lru": -1, "conv": -1, "k": -3, "v": -3}[k.split("/")[-1]]
            assert want.index("model") == len(want) + on, (k, want)
        assert r["layout"]["cache_batch_moved"] == moved


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


@pytest.mark.parametrize("name", NAMES)
def test_tokens_and_cache_match_jax(ranks, jax_ref, name):
    """The ranks' greedy tokens are JAX's, and each rank's cache leaves
    are its blocks of JAX's cache (the rotating window past its wrap where
    the case runs past it)."""
    want = dict(_leaves(jax_ref[name]["cache"]))
    _, over, _, _, p, s = BY_NAME[name]
    assert (p + s - 1 > _jcfg(name).attn_window) == ("attn_window" in over)
    for got in ranks[name]:
        np.testing.assert_array_equal(got["tokens"], jax_ref[name]["tokens"])
        specs = dict(_leaves(got["layout"]["cache_specs"]))
        leaves = _leaves(got["cache"])
        assert [k for k, _ in leaves] == list(want)
        for k, c in leaves:
            block = tm.cache_block(want[k], specs[k], got["coord"],
                                   got["mesh"])
            assert c.shape == block.shape, k
            np.testing.assert_allclose(c, block, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_the_ranks_agree_bitwise(ranks, name):
    """The ranks' tokens and gathered prefill logits, bit for bit."""
    r0 = ranks[name][0]
    for got in ranks[name][1:]:
        np.testing.assert_array_equal(got["tokens"], r0["tokens"])
        np.testing.assert_array_equal(got["logits"], r0["logits"])


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if LAYOUT[n] != "batch"])
def test_collectives_per_layer(ranks, name):
    """Prefill: the embedding's sum, each recurrent layer's gather of the
    conv's channels and ``w_out`` sum, each MLP's ``down`` sum, the last
    logits' gather; where the heads split, the attention's ``wo`` sum and
    its K/V projections gathered (``gather_kv``: the one KV head's
    ``wk``/``wv`` are the rank's columns); where they do not, an
    all-gather of its four weights.  Decode (the last step): the same
    sums and gathers, the split softmax's max and sum over the window's
    slots, the greedy token's max and min; where the heads split, the
    query heads gathered and no parameter all-gathered."""
    cfg = tm.partition_cfg(ARCH, _over(name))
    m = BY_NAME[name][2]
    mesh = FakeMesh((1, m), ("data", "model"))
    full = tm._build(cfg).init(0, device="meta")
    md, _ = shard_dims_2d(full, cfg, mesh, multi_pod=False,
                          worker_dim=False)
    part = partition_for(cfg, mesh, decode=True)
    assert part.lru and part.ff and part.vocab
    heads = part.heads
    assert heads == (cfg.n_heads % m == 0)
    gathered = sorted("/".join(p) for (p, _), d in zip(tree_paths(full), md)
                      if gathered_model_leaf(p, d, part))
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    tail = cfg.n_layers - n_super * len(pat)
    n_rec = n_super * pat.count("rec") + tail
    n_attn = n_super * pat.count("attn")
    assert gathered == ([] if heads else [
        f"super/b2/temporal/attn/{w}/w" for w in ("wk", "wo", "wq", "wv")])
    sums = 1 + n_rec + n_attn * heads + cfg.n_layers
    common = {"reduce_from": {"model": sums},
              "gather_inner": {"model": n_rec}}
    attn = ({"gather_kv": {"model": n_attn}} if heads
            else {"all_gather": {"model": 4 * n_attn}})
    for r in ranks[name]:
        pre, dec = r["calls"]["prefill"], r["calls"]["decode"]
        assert pre == {**common, **attn,
                       "gather_vocab": {"model": 1}}, pre
        want = {**common, **attn, "vocab_max": {"model": 1},
                "vocab_min": {"model": 1},
                "softmax_max": {"model": n_attn},
                "softmax_sum": {"model": n_attn}}
        if heads:
            want["gather_heads"] = {"model": n_attn}
        assert dec == want, dec


def test_the_plan_reads_the_attention_leaf_and_the_state_beside_it():
    """The hybrid's decode plan is laid out from its super-blocks' ``k``
    leaf (the window's slots over ``model``) with the ``lru`` state of the
    same blocks on its channels; a cache led by another leaf raises, and
    where ``lru`` does not split the plan is None (the gathered path)."""
    cfg = tm.partition_cfg(ARCH, {"n_layers": 5})
    mesh = FakeMesh((1, 2), ("data", "model"))
    k = (1, 3, cfg.attn_window, cfg.n_kv_heads, cfg.hd)
    part = partition_for(cfg, mesh, cache=k, cache_leaf="k")
    assert part.lru and part.cache == "seq" and part.seq_axes == ("model",)
    with pytest.raises(ValueError, match="no decode layout"):
        partition_for(cfg, mesh, cache=(1, 3, cfg.lru_width),
                      cache_leaf="lru")
    odd = tm.partition_cfg(ARCH, {"n_layers": 5, "lru_width": 129})
    assert partition_for(odd, mesh, cache=k, cache_leaf="k") is None
