"""The SSM family's partitioned serving (``repro_torch.serve`` on a (1, 2)
(data, model) grid whose ``model`` axis splits the inner channels,
``models/partition``, ``models/ssm.py``) on two gloo ranks on the CPU,
against the JAX package on the same parameters (its ``init``, converted):
its prefill's last logits, every ``decode_step``'s logits, its greedy
tokens and its cache, and its cache specs.

Cases, reduced falcon-mamba in f32, a batch of 3, each a prompt's
prefill, the prompt ingested a token at a time through the greedy step
and a few tokens generated:

* d_inner 256, dt_rank 8: the state ``ssm`` and the conv window ``conv``
  on the rank's channels (``"inner"``); decode keeps ``x_proj``'s columns
  (the token's channels gathered, its columns projected and gathered) and
  ``dt_proj``'s rows (the product's partials reduce-scattered to the
  rank's channels);
* dt_rank 7: ``x_proj`` and ``dt_proj`` do not divide the axis and are
  replicated, so decode reads them whole;
* d_inner 255: ``inner`` is unbound, every layer is gathered and the
  cache splits over the batch alone (``"batch"``), as before.

Bounds: the prefill's logits and every step's logits (a rank's vocab
columns) within rtol 1e-5 (atol 1e-5) of JAX's; the greedy tokens equal
JAX's and bit-equal across the ranks; each rank's cache within 1e-5 of its
block of JAX's cache under the reference's cache specs.  The collectives
are counted per layer: decode all-gathers no parameter over ``model`` but
``dt_proj``'s bias (split on its layer dim), the prefill only ``x_proj``,
``dt_proj`` and that bias.
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
ARCH = "falcon-mamba-7b"
#: (name, arch, config fields replaced, batch, prompt, greedy steps)
CASES = (
    ("falcon-mamba", ARCH, {}, 3, 4, 4),
    ("dt-rank-7", ARCH, {"dt_rank": 7}, 3, 4, 4),
    ("inner-255", ARCH, {"d_inner": 255}, 3, 4, 4),
)
BY_NAME = {c[0]: c for c in CASES}
NAMES = list(BY_NAME)
#: each case's cache layout
LAYOUT = {"falcon-mamba": "inner", "dt-rank-7": "inner",
          "inner-255": "batch"}
#: the model-sharded leaves each case's prefill gathers over ``model``
PREFILL_GATHERED = {
    "falcon-mamba": ["layers/dt_proj/b", "layers/dt_proj/w",
                     "layers/x_proj/w"],
    "dt-rank-7": ["layers/dt_proj/b"],
}
RTOL = ATOL = 1e-5


def _jcfg(over):
    return dataclasses.replace(jreg.get_config(ARCH).reduced(),
                               param_dtype="float32", **over)


def _jax_case(name):
    """JAX's run of a case, as ``torch_mesh.serve_run`` serves it: its
    params (numpy), the prefill's last logits, each greedy step's logits,
    the generated tokens and the cache at the end."""
    _, _, over, b, p, s = BY_NAME[name]
    jm = jreg.build_model(_jcfg(over))
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
    """Each case's two ranks' results, from one spawn."""
    res = tm.spawn(tm.serve_moe_rank, 2, tmp_path_factory.mktemp("ssm"),
                   list(CASES), {n: jax_ref[n]["params"] for n in NAMES})
    return {name: [r[name] for r in res] for name in NAMES}


def _cfg(name):
    _, arch, over, *_ = BY_NAME[name]
    return tm.partition_cfg(arch, over)


def _vocab_cols(x, got, name):
    """The rank's vocab columns of a (B, V) array (all of them where the
    plan does not partition)."""
    if LAYOUT[name] == "batch":
        return x
    n, j = got["mesh"]["model"], got["coord"]["model"]
    v = x.shape[-1] // n
    return x[:, j * v:(j + 1) * v]


def _leaves(tree):
    """(path, leaf) of a nested dict of arrays, in flatten order."""
    return [("/".join(p), x) for p, x in tree_paths(tree)]


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_references_cache_spec(ranks, name):
    """The rank's cache layout and, where the plan partitions, each leaf's
    spec are the JAX package's ``cache_pspecs`` for the same cache on the
    same mesh: ``ssm`` (L, B, di, n) on di, ``conv`` (L, B, K − 1, di) on
    di; where ``inner`` is unbound the cache is whole on ``model``."""
    _, arch, over, b, p, s = BY_NAME[name]
    jcfg = _jcfg(over)
    jm = jreg.build_model(jcfg)
    amesh = AbstractMesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Explicit,) * 2)
    cache = jax.eval_shape(lambda: jm.init_cache(b, p + s))
    ref = dict(_leaves(JSH.cache_pspecs(cache, jcfg, amesh, b,
                                        multi_pod=False)))
    for r in ranks[name]:
        assert r["layout"]["cache"] == LAYOUT[name]
        assert r["layout"]["cache_batch_moved"] == []
        specs = _leaves(r["layout"]["cache_specs"])
        assert [k for k, _ in specs] == list(ref)
        for k, sp in specs:
            want = tuple(ref[k]) + (None,) * (len(sp) - len(tuple(ref[k])))
            assert tuple(sp) == want, k
            on = "model" in want
            assert on == (LAYOUT[name] == "inner"), k
            if on:
                assert want.index("model") == {"ssm": 2, "conv": 3}[k], k


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
    """The ranks' greedy tokens are JAX's, and each rank's ``ssm`` and
    ``conv`` are its blocks of JAX's cache."""
    want = dict(_leaves(jax_ref[name]["cache"]))
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
                                  if LAYOUT[n] == "inner"])
def test_collectives_per_layer(ranks, name):
    """Prefill: the embedding's sum, each layer's ``out_proj`` sum, its
    all-to-all and its gather of x's channels for ``x_proj``, the last
    logits' gather, and an all-gather over ``model`` of ``x_proj``,
    ``dt_proj`` and ``dt_proj``'s bias only.  Decode (the last step): the
    same sums, exchange and gather, the greedy token's max and min, an
    all-gather of ``dt_proj``'s bias (whole, once a step) and of no other
    parameter; where they split, each layer's ``x_proj`` columns gathered
    (``gather_proj``) and its ``dt_proj`` partials reduce-scattered
    (``scatter_inner``); where they are replicated, neither."""
    cfg = _cfg(name)
    L = cfg.n_layers
    mesh = FakeMesh((1, 2), ("data", "model"))
    full = tm._build(cfg).init(0, device="meta")
    md, _ = shard_dims_2d(full, cfg, mesh, multi_pod=False,
                          worker_dim=False)
    pre_part = partition_for(cfg, mesh, serve=True)
    dec_part = partition_for(cfg, mesh, decode=True)
    assert pre_part.inner and pre_part.vocab and pre_part.proj_cols == ()
    split = cfg.dt_rank % 2 == 0
    assert set(dec_part.proj_cols) == ({"x_proj", "dt_proj"} if split
                                       else set())
    paths = [(path, d) for (path, _), d in zip(tree_paths(full), md)]
    pre = sorted("/".join(p) for p, d in paths
                 if gathered_model_leaf(p, d, pre_part))
    assert pre == PREFILL_GATHERED[name]
    dec = sorted("/".join(p) for p, d in paths
                 if gathered_model_leaf(p, d, dec_part))
    assert dec == ["layers/dt_proj/b"]
    n_gather = 1 + 2 * L * split
    for r in ranks[name]:
        pre, dec = r["calls"]["prefill"], r["calls"]["decode"]
        assert pre == {"reduce_from": {"model": 1 + L},
                       "all_to_all": {"model": L},
                       "gather_inner": {"model": L},
                       "gather_vocab": {"model": 1},
                       "all_gather": {"model": n_gather}}, pre
        want = {"reduce_from": {"model": 1 + L}, "all_to_all": {"model": L},
                "gather_inner": {"model": L}, "vocab_max": {"model": 1},
                "vocab_min": {"model": 1}, "all_gather": {"model": 1}}
        if split:
            want.update(gather_proj={"model": L},
                        scatter_inner={"model": L})
        assert dec == want, dec


def test_a_plan_that_cannot_take_the_cache_raises():
    """The SSM's plan reads only its state's layout: a cache led by an
    attention leaf raises, it is not served gathered in silence."""
    cfg = _cfg("falcon-mamba")
    mesh = FakeMesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="no decode layout"):
        partition_for(cfg, mesh, cache=(cfg.n_layers, 2, 8, 1, 32),
                      cache_leaf="k")
