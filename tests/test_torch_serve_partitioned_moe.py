"""The MoE family's partitioned serving (``repro_torch.serve`` on a (1, 2)
(data, model) grid whose ``model`` axis splits the products,
``models/partition``, ``models/moe.py``) on two gloo ranks on the CPU,
against the JAX package on the same parameters (its ``init``, converted):
its prefill's last logits, every ``decode_step``'s logits, its greedy
tokens and its cache, and its cache specs.  One device's serving
(``torch_mesh.serve_run`` without a mesh) is the check of the routing:
every dispatch's picks and kept pairs, and the ranks' against it.

Cases, reduced and in f32, a batch of 3, each a prompt's prefill, the
prompt ingested a token at a time through the greedy step and a few
tokens generated (``max_seq`` even, so the sequence splits):

* qwen3-moe (GQA, 4 KV heads over ``model``: the cache's ``"heads"``
  layout; 4 experts top 2, each rank 2);
* qwen3-moe with one KV head: the cache's sequence over ``model``
  (``"seq"``), ``wk``/``wv`` as the rank's columns, their projections
  gathered (``kv_cols``);
* deepseek-v3 as ``ModelConfig.reduced`` has it: MLA with q-LoRA, the
  shared expert, a dense first layer and MTP in its params (never
  gathered, never read); the latent cache ``c_kv``/``k_rope`` split on
  the sequence, the partial softmaxes joined;
* deepseek-v3 without q-LoRA (MLA's ``wq``).

Bounds: the prefill's logits and every step's logits (a rank's vocab
columns) within rtol 1e-5 (atol 1e-5) of JAX's; the greedy tokens equal
JAX's and bit-equal across the ranks; each rank's cache within 1e-5 of its
block of JAX's cache under the reference's cache specs; every dispatch's
picks and kept pairs equal one device's.  The collectives are counted per
layer: decode gathers no parameter over ``model`` (the router, ``wq_a``
and ``wkv_a`` are the rank's columns, their one-token outputs gathered),
the prefill gathers only those three, and no MTP leaf is gathered.
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
from repro_torch.models.partition import (MTP_KEYS,  # noqa: E402
                                          gathered_model_leaf,
                                          partition_for)
from repro_torch.tree import tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
QWEN, DSV3 = "qwen3-moe-30b-a3b", "deepseek-v3-671b"
#: (name, arch, config fields replaced, batch, prompt, greedy steps)
CASES = (
    ("qwen3-moe", QWEN, {}, 3, 4, 4),
    ("qwen3-moe-kv1", QWEN, {"n_kv_heads": 1}, 3, 6, 4),
    ("deepseek-v3", DSV3, {}, 3, 4, 4),
    ("deepseek-v3-wq", DSV3, {"q_lora_rank": 0}, 3, 4, 4),
)
BY_NAME = {c[0]: c for c in CASES}
NAMES = list(BY_NAME)
#: each case's cache layout
LAYOUT = {"qwen3-moe": "heads", "qwen3-moe-kv1": "seq",
          "deepseek-v3": "seq", "deepseek-v3-wq": "seq"}
#: the model-sharded leaves each case's prefill gathers over ``model``
#: (the MTP head's are left out of serving altogether)
PREFILL_GATHERED = {
    "qwen3-moe": ["moe_layers/mlp/router/w"],
    "qwen3-moe-kv1": ["moe_layers/mlp/router/w"],
    "deepseek-v3": ["dense_layers/attn/wkv_a/w", "dense_layers/attn/wq_a/w",
                    "moe_layers/attn/wkv_a/w", "moe_layers/attn/wq_a/w",
                    "moe_layers/mlp/router/w"],
    "deepseek-v3-wq": ["dense_layers/attn/wkv_a/w", "moe_layers/attn/wkv_a/w",
                       "moe_layers/mlp/router/w"],
}
RTOL = ATOL = 1e-5


def _jcfg(arch, over):
    return dataclasses.replace(jreg.get_config(arch).reduced(),
                               param_dtype="float32", **over)


def _jax_case(name):
    """JAX's run of a case, as ``torch_mesh.serve_run`` serves it: its
    params (numpy), the prefill's last logits, each greedy step's logits,
    the generated tokens and the cache at the end."""
    _, arch, over, b, p, s = BY_NAME[name]
    jm = jreg.build_model(_jcfg(arch, over))
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
    res = tm.spawn(tm.serve_moe_rank, 2, tmp_path_factory.mktemp("moe"),
                   list(CASES), {n: jax_ref[n]["params"] for n in NAMES})
    return {name: [r[name] for r in res] for name in NAMES}


@pytest.fixture(scope="module")
def alone(jax_ref):
    """Each case served on one device, its dispatches recorded."""
    return {name: tm.serve_routed(arch, over=over, batch=b, prompt=p,
                                  steps=s, params=jax_ref[name]["params"])
            for name, (_, arch, over, b, p, s) in BY_NAME.items()}


def _cfg(name):
    _, arch, over, *_ = BY_NAME[name]
    return tm.partition_cfg(arch, over)


def _vocab_cols(x, got):
    """The rank's vocab columns of a (B, V) array."""
    n, j = got["mesh"]["model"], got["coord"]["model"]
    v = x.shape[-1] // n
    return x[:, j * v:(j + 1) * v]


def _leaves(tree):
    """(path, leaf) of a nested dict of arrays, in flatten order."""
    return [("/".join(p), x) for p, x in tree_paths(tree)]


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_references_cache_spec(ranks, name):
    """The rank's cache layout and each leaf's spec are the JAX package's
    ``cache_pspecs`` for the same cache on the same mesh: GQA's K/V on the
    KV heads (or the sequence), MLA's ``c_kv``/``k_rope`` on the
    sequence, though deepseek-v3's KV heads bind ``kv_heads``."""
    _, arch, over, b, p, s = BY_NAME[name]
    jcfg = _jcfg(arch, over)
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
            assert want[2] == ("model" if LAYOUT[name] == "seq" else None), k


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
            np.testing.assert_allclose(a, _vocab_cols(w, got), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {i}")


@pytest.mark.parametrize("name", NAMES)
def test_tokens_and_cache_match_jax(ranks, jax_ref, name):
    """The ranks' greedy tokens are JAX's, and each rank's cache (every
    stack's leaves) is its block of JAX's cache."""
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


@pytest.mark.parametrize("name", NAMES)
def test_picks_and_drops_equal_one_device(ranks, alone, jax_ref, name):
    """Every dispatch (the prefill's MoE layers, then each step's) picks
    the experts and keeps the pairs one device picks and keeps, on every
    rank; one device's tokens are JAX's."""
    cfg = _cfg(name)
    _, _, _, b, p, s = BY_NAME[name]
    n_moe = cfg.n_layers - cfg.first_dense_layers
    want = alone[name]["routing"]
    assert len(want) == n_moe * (p + s)
    np.testing.assert_array_equal(alone[name]["tokens"],
                                  jax_ref[name]["tokens"])
    for r in ranks[name]:
        assert len(r["routing"]) == len(want)
        for i, (got, w) in enumerate(zip(r["routing"], want)):
            for k in ("idx", "kept"):
                np.testing.assert_array_equal(got[k], w[k],
                                              err_msg=f"dispatch {i} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_layer(ranks, name):
    """Prefill: the embedding's sum, each layer's attention and MLP sums
    (a MoE layer's routed experts and its shared expert), the last
    logits' gather, and an all-gather over ``model`` of the router,
    ``wq_a`` and ``wkv_a`` only (each layer's), never of an MTP leaf.
    Decode (the last step): the same sums, the greedy token's max and
    min, no all-gather of a parameter, and each layer's small projections
    gathered in one ``gather_proj`` (MLA's ``wq_a`` and ``wkv_a``
    together, the router on its own); where the cache splits the
    sequence, each layer's query heads gathered and its softmax's max and
    sum; where the KV heads do not split, each layer's K and V
    projections gathered (``gather_kv``), in the prefill and in decode."""
    cfg = _cfg(name)
    nd = cfg.first_dense_layers
    nm = cfg.n_layers - nd
    L = cfg.n_layers
    got = ranks[name][0]
    mesh = FakeMesh((1, 2), ("data", "model"))
    full = tm._build(cfg).init(0, device="meta")
    md, _ = shard_dims_2d(full, cfg, mesh, multi_pod=False,
                          worker_dim=False)
    pre_part = partition_for(cfg, mesh, serve=True)
    dec_part = partition_for(cfg, mesh, decode=True)
    assert pre_part.heads and pre_part.vocab and pre_part.expert
    assert pre_part.proj_cols == ()
    assert set(dec_part.proj_cols) == (
        {"router", "wq_a", "wkv_a"} if cfg.q_lora_rank
        else {"router", "wkv_a"} if cfg.use_mla else {"router"})
    paths = [(path, d) for (path, _), d in zip(tree_paths(full), md)]
    pre = sorted("/".join(p) for p, d in paths
                 if gathered_model_leaf(p, d, pre_part)
                 and p[0] not in MTP_KEYS)
    assert pre == PREFILL_GATHERED[name]
    assert not [p for p, d in paths if gathered_model_leaf(p, d, dec_part)
                and p[0] not in MTP_KEYS]
    if cfg.mtp:
        # the plan would gather them: serving leaves them out
        assert any(gathered_model_leaf(p, d, pre_part) for p, d in paths
                   if p[0] in MTP_KEYS)
    stack = {"dense_layers": nd, "moe_layers": nm}
    n_gather = sum(stack[p.split("/")[0]] for p in pre)
    sums = 1 + 2 * nd + (1 + pre_part.expert
                         + bool(cfg.n_shared_experts)) * nm
    kv = {"model": L} if pre_part.kv_cols else None
    # a layer's gather_proj: MLA's wq_a/wkv_a in one, the router in one
    proj = L * cfg.use_mla + nm
    for r in ranks[name]:
        pre, dec = r["calls"]["prefill"], r["calls"]["decode"]
        assert pre == {k: v for k, v in {
            "reduce_from": {"model": sums}, "gather_vocab": {"model": 1},
            "all_gather": {"model": n_gather}, "gather_kv": kv}.items()
            if v}, pre
        want = {"reduce_from": {"model": sums}, "vocab_max": {"model": 1},
                "vocab_min": {"model": 1}, "gather_proj": {"model": proj}}
        if kv:
            want["gather_kv"] = kv
        if LAYOUT[name] == "seq":
            want.update(gather_heads={"model": L}, softmax_max={"model": L},
                        softmax_sum={"model": L})
        assert dec == want, dec


@pytest.mark.parametrize("name", NAMES)
def test_a_plan_that_cannot_take_the_cache_raises(name):
    """The plan reads only the caches it lays out: an attention leaf it
    does not know raises, it is not served gathered in silence."""
    cfg = _cfg(name)
    mesh = FakeMesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="no decode layout"):
        partition_for(cfg, mesh, cache=(cfg.n_layers, 2, 8, 16),
                      cache_leaf="ssm")
