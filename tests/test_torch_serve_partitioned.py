"""Partitioned serving (``repro_torch.serve`` on a (data, model) mesh whose
``model`` axis splits the products, ``models/partition``) on gloo ranks on
the CPU, against the JAX package on the same parameters (its ``init``,
converted): its prefill's last logits, every ``decode_step``'s logits,
its greedy tokens and its cache, its cache specs, and the per-device
module XLA partitions from its ``serve_step``.  One device's serving
(``torch_mesh.serve_run`` without a mesh) is the check between the ranks:
their logits, tokens and cache blocks against it.

Cases, reduced and in f32, each a prompt's prefill, the prompt ingested a
token at a time through the greedy step and a few tokens generated:

* on (1, 2), one spawn of two ranks: granite-8b and pixtral-12b (with stub
  patches) with the KV heads over ``model`` (``"heads"``), granite-8b
  also with a batch of 2 equal to its 2 layers (the batch's entry on the
  cache's dim 1, where the reference's rule puts it on dim 0); granite-8b
  with one KV head, whose cache splits its sequence over ``model``
  (``"seq"``), with and without a sliding window of 32 (its rotating
  buffer split over the ranks, the prompt and the steps past the window);
  one KV head, and 6 heads on 3 KV heads, over an odd ``max_seq`` that no
  axis splits (``"batch"``: each rank's query heads on the whole cache);
  and the greedy token of planted vocab-parallel rows;
* on (2, 2), one spawn of four ranks: one KV head and a batch of one,
  which the data axis cannot split, so the cache's sequence splits over
  (data, model), as ``long_500k``'s on the production mesh.

Bounds: the prefill's logits and every step's logits (a rank's vocab
columns) within rtol 1e-5 (atol 1e-5) of JAX's and of one device's; the
greedy tokens equal JAX's and one device's and bit-equal across the
ranks; each rank's cache within 1e-5 of its block of JAX's and of one
device's cache under the reference's cache specs; the collectives counted
per layer, with no all-gather over ``model`` but of the leaves whose
products do not partition.  The traced decode rank's flops equal XLA's
per-device module's within rtol 1e-2.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serve import make_prefill as jmake_prefill  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import FakeMesh  # noqa: E402
from repro_torch.launch.shardings import shard_dims_2d  # noqa: E402
from repro_torch.launch.trace_analysis import analyze  # noqa: E402
from repro_torch.models.partition import (gathered_model_leaf,  # noqa: E402
                                          partition_for)
from repro_torch.serve import generate  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
#: (name, arch, config fields replaced, batch, prompt, greedy steps) on
#: (1, 2); ``max_seq`` = prompt + steps (even, so the sequence splits); a
#: batch of 3, not the 2 layers, but in "batch-eq-layers" (the reference's
#: cache spec takes a leading dim of the batch's size for the batch's)
CASES_12 = (
    ("granite-8b", "granite-8b", {}, 3, 4, 3),
    ("batch-eq-layers", "granite-8b", {}, 2, 4, 3),
    ("pixtral-12b", "pixtral-12b", {}, 3, 4, 3),
    ("kv1", "granite-8b", {"n_kv_heads": 1}, 3, 6, 4),
    ("kv1-window", "granite-8b", {"n_kv_heads": 1, "sliding_window": 32},
     3, 30, 8),
    # an odd max_seq: the sequence cannot split, so the cache splits over
    # the batch alone and each rank's query heads read the whole cache's
    # KV heads (evenly, and repeated where 6 heads sit on 3 KV heads)
    ("kv1-odd", "granite-8b", {"n_kv_heads": 1}, 3, 4, 3),
    ("uneven-odd", "codeqwen1.5-7b", {"n_heads": 6, "n_kv_heads": 3}, 3, 4,
     3),
)
#: the batch of one on (2, 2)
CASES_22 = (("batch1", "granite-8b", {"n_kv_heads": 1}, 1, 8, 4),)
CASES = {c[0]: c for c in CASES_12 + CASES_22}
#: each case's cache layout and the K leaf's spec (L, B, T, KV, hd)
LAYOUT = {
    "granite-8b": ("heads", (None, "data", None, "model", None)),
    "pixtral-12b": ("heads", (None, "data", None, "model", None)),
    "batch-eq-layers": ("heads", (None, "data", None, "model", None)),
    "kv1": ("seq", (None, "data", "model", None, None)),
    "kv1-window": ("seq", (None, "data", "model", None, None)),
    "kv1-odd": ("batch", (None, "data", None, None, None)),
    "uneven-odd": ("batch", (None, "data", None, None, None)),
    "batch1": ("seq", (None, None, ("data", "model"), None, None)),
}
NAMES = list(CASES)
RTOL = ATOL = 1e-5


def _jcfg(arch, over):
    return dataclasses.replace(jreg.get_config(arch).reduced(),
                               param_dtype="float32", **over)


def _jax_case(name):
    """JAX's run of a case, as ``torch_mesh.serve_run`` serves it: its
    params (numpy), the prefill's last logits, each greedy step's logits,
    the generated tokens and the cache at the end."""
    _, arch, over, b, p, s = CASES[name]
    jcfg = _jcfg(arch, over)
    jm = jreg.build_model(jcfg)
    pj = jm.init(KEY)
    inputs = {k: jnp.asarray(v.numpy())
              for k, v in tm.serve_inputs(jcfg, b, p).items()}
    out = {"params": jax.tree.map(np.asarray, pj),
           "logits": np.asarray(jax.jit(jmake_prefill(jm))(pj, inputs)),
           "logits_steps": []}
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(b, p + s)
    toks = inputs["tokens"]
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
    """Each case's ranks' results: two ranks on (1, 2), four on (2, 2)."""
    out = {}
    for shape, cases, world in (((1, 2), CASES_12, 2),
                                ((2, 2), CASES_22, 4)):
        params = {c[0]: jax_ref[c[0]]["params"] for c in cases}
        res = tm.spawn(tm.serve_partitioned_rank, world,
                       tmp_path_factory.mktemp(f"serve{world}"), shape,
                       list(cases), params)
        for name, *_ in cases:
            out[name] = [r[name] for r in res]
        if "argmax" in res[0]:
            out["argmax"] = [r["argmax"] for r in res]
    return out


@pytest.fixture(scope="module")
def alone(jax_ref):
    """Each case served on one device."""
    return {name: tm.serve_run(arch, over=over, batch=b, prompt=p, steps=s,
                               params=jax_ref[name]["params"])
            for name, (_, arch, over, b, p, s) in CASES.items()}


def _cfg(name):
    _, arch, over, *_ = CASES[name]
    return tm.partition_cfg(arch, over)


def _vocab_cols(x, got):
    """The rank's vocab columns of a (B, V) array."""
    n, j = got["mesh"]["model"], got["coord"]["model"]
    v = x.shape[-1] // n
    return x[:, j * v:(j + 1) * v]


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_references_cache_spec(ranks, name):
    """The rank's cache layout and block are those of the JAX package's
    ``cache_pspecs`` for the same cache on the same mesh."""
    _, arch, over, b, p, s = CASES[name]
    jcfg = _jcfg(arch, over)
    jm = jreg.build_model(jcfg)
    got = ranks[name][0]
    shape = tuple(got["mesh"][a] for a in ("data", "model"))
    amesh = AbstractMesh(shape, ("data", "model"),
                         axis_types=(AxisType.Explicit,) * 2)
    cache = jax.eval_shape(lambda: jm.init_cache(b, p + s))
    ref = JSH.cache_pspecs(cache, jcfg, amesh, b, multi_pod=False)
    layout, kspec = LAYOUT[name]
    for r in ranks[name]:
        assert r["layout"]["cache"] == layout
        for k in ("k", "v"):
            want = tuple(ref[k]) + (None,) * (5 - len(tuple(ref[k])))
            if b == jcfg.n_layers:
                # the documented difference: the same entries, the data
                # axes on the batch's dim 1 instead of the layers' dim 0
                assert want[0] is not None and want[1] is None, want
                want = (want[1], want[0]) + want[2:]
                assert k in r["layout"]["cache_batch_moved"]
            else:
                assert r["layout"]["cache_batch_moved"] == []
            assert tuple(r["layout"]["cache_specs"][k]) == want == kspec


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
    """The ranks' greedy tokens are JAX's, and each rank's cache is its
    block of JAX's cache."""
    want = jax_ref[name]
    for got in ranks[name]:
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        for k, c in want["cache"].items():
            block = tm.cache_block(c, got["layout"]["cache_specs"][k],
                                   got["coord"], got["mesh"])
            assert got["cache"][k].shape == block.shape
            np.testing.assert_allclose(got["cache"][k], block, rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_one_device(ranks, alone, name):
    want = alone[name]
    for got in ranks[name]:
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=RTOL, atol=ATOL)
        assert len(got["logits_steps"]) == len(want["logits_steps"])
        for i, (a, w) in enumerate(zip(got["logits_steps"],
                                       want["logits_steps"])):
            np.testing.assert_allclose(a, _vocab_cols(w, got), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {i}")


@pytest.mark.parametrize("name", NAMES)
def test_tokens_equal_one_device_and_the_ranks_bitwise(ranks, alone, name):
    for got in ranks[name]:
        np.testing.assert_array_equal(got["tokens"], alone[name]["tokens"])
        np.testing.assert_array_equal(got["tokens"], ranks[name][0]["tokens"])
        # the gathered last logits too, bit for bit
        np.testing.assert_array_equal(got["logits"], ranks[name][0]["logits"])


@pytest.mark.parametrize("name", NAMES)
def test_cache_is_the_ranks_block_of_one_devices(ranks, alone, name):
    want = alone[name]["cache"]
    for got in ranks[name]:
        for k, c in want.items():
            block = tm.cache_block(c, got["layout"]["cache_specs"][k],
                                   got["coord"], got["mesh"])
            assert got["cache"][k].shape == block.shape
            np.testing.assert_allclose(got["cache"][k], block, rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_layer(ranks, name):
    """Prefill: the embedding's sum, each layer's attention and MLP sums,
    the last logits' gather.  Decode: the same sums, the greedy token's
    max and min over the vocab and, where the cache splits the sequence,
    each layer's query heads gathered over ``model`` (where the heads
    split) and its softmax's max and sum over the sequence's axes.  Where
    the KV heads do not split, each layer's K and V projections of the
    rank's ``wk``/``wv`` columns gathered (``gather_kv``), in the prefill
    and in decode.  No all-gather over ``model`` but of the leaves whose
    products do not partition (pixtral's ``projector``): never
    ``wk``/``wv``."""
    cfg = _cfg(name)
    L = cfg.n_layers
    got = ranks[name][0]
    mesh = FakeMesh(tuple(got["mesh"].values()), tuple(got["mesh"]))
    full = tm._build(cfg).init(0, device="meta")
    md, _ = shard_dims_2d(full, cfg, mesh, multi_pod=False,
                          worker_dim=False)
    part = partition_for(cfg, mesh, serve=True)
    assert part.heads and part.ff and part.vocab
    assert part.kv_cols == (not part.kv)
    still = [path for (path, _), d in zip(tree_paths(full), md)
             if gathered_model_leaf(path, d, part)]
    assert not any(p[-2] in ("wk", "wv") for p in still), still
    n_gather = sum(1 if path[0] != "layers" else L for path in still)
    # a decode step reads no projector, but gathers it with the unstacked
    # leaves
    gathered = {"model": n_gather} if n_gather else None
    layout = LAYOUT[name][0]
    seq = "+".join(a for a in ("data", "model")
                   if a in str(LAYOUT[name][1][2]))
    for r in ranks[name]:
        pre, dec = r["calls"]["prefill"], r["calls"]["decode"]
        assert pre.get("reduce_from") == {"model": 1 + 2 * L}, pre
        assert pre.get("gather_vocab") == {"model": 1}, pre
        assert pre.get("all_gather") == gathered, pre
        kv = {"model": L} if part.kv_cols else None
        assert pre.get("gather_kv") == kv, pre
        want = {"reduce_from": {"model": 1 + 2 * L},
                "vocab_max": {"model": 1}, "vocab_min": {"model": 1}}
        if gathered:
            want["all_gather"] = gathered
        if kv:
            want["gather_kv"] = kv
        if layout == "seq":
            want.update(gather_heads={"model": L},
                        softmax_max={seq: L}, softmax_sum={seq: L})
        assert dec == want, dec


def test_argmax_vocab_takes_the_first_maximum_of_the_whole_row(ranks):
    """A tie straddling the two vocab halves picks the lower index, as
    ``torch.argmax`` of the whole row does; so do ties inside one half;
    and random rows give ``torch.argmax``'s index."""
    rows = tm.argmax_rows()
    want = torch.argmax(rows, dim=-1).numpy()
    assert want.tolist() == [idx[0] for _, _, idx in tm.ARGMAX_TIES]
    for r in ranks["argmax"]:
        np.testing.assert_array_equal(r["planted"], want)
        np.testing.assert_array_equal(
            r["random"], np.argmax(r["random_rows"], axis=-1))


@pytest.mark.parametrize("name", NAMES)
def test_one_device_tokens_match_jax(alone, jax_ref, name):
    """One device's greedy tokens (``generate``, and the serving run) are
    JAX's on the same parameters, and its logits JAX's within 1e-5."""
    _, arch, over, b, p, s = CASES[name]
    want = jax_ref[name]
    params = convert.model_params_from_numpy(want["params"], device="cpu")
    prompts = tm.serve_tokens(_jcfg(arch, over).vocab_size, b, p)
    got = generate(tm._build(tm.partition_cfg(arch, over)), params,
                   prompts, n_steps=s, max_seq=p + s)
    np.testing.assert_array_equal(got.numpy(), want["tokens"])
    np.testing.assert_array_equal(alone[name]["tokens"], want["tokens"])
    np.testing.assert_allclose(alone[name]["logits"], want["logits"],
                               rtol=RTOL, atol=ATOL)
    for i, (a, w) in enumerate(zip(alone[name]["logits_steps"],
                                   want["logits_steps"])):
        np.testing.assert_allclose(a, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")


#: the reference's reduced granite-8b decode_32k compiled on a (1, 2)
#: ``Auto`` mesh of two forced host devices, with its cache specs (its
#: per-device module's text into ``argv[1]``)
_HLO_DECODE_12 = r"""
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
spec = build_spec("granite-8b", "decode_32k", mesh, multi_pod=False,
                  reduced=True)
rules = rules_for(get_config("granite-8b").reduced(), mesh, multi_pod=False)
with mesh:
    with axis_rules(mesh, rules):
        hlo = jax.jit(spec.fn, in_shardings=named(mesh, spec.in_shardings),
                      donate_argnums=spec.donate_argnums
                      ).lower(*spec.args).compile().as_text()
open(sys.argv[1], "w").write(hlo)
print("HLO_OK")
"""


def test_partitioned_decode_flops_match_the_references_partition(tmp_path):
    """The port's decode rank on a (1, 2) fake mesh (its heads on its
    block of the cache, its ff columns and vocab rows) counts the flops of
    the per-device module XLA partitions from the reference's
    ``serve_step`` over the same mesh, within rtol 1e-2, and half of one
    device's."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "decode_12.hlo"
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2"
                          ).strip())
    proc = subprocess.run([sys.executable, "-c", _HLO_DECODE_12, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=400, cwd=repo)
    assert "HLO_OK" in proc.stdout, proc.stdout + proc.stderr
    ref = hlo_analysis.analyze(out.read_text()).flops
    mesh = FakeMesh((1, 2), ("data", "model"))
    spec = specs.build_spec("granite-8b", "decode_32k", mesh,
                            multi_pod=False, reduced=True)
    assert spec.meta["cache_layout"] == "heads"
    s = analyze(spec.fn, spec.local_args, mesh)
    assert s.flops == pytest.approx(ref, rel=1e-2)
    one = FakeMesh((1, 1), ("data", "model"))
    whole = specs.build_spec("granite-8b", "decode_32k", one,
                             multi_pod=False, reduced=True)
    assert s.flops == pytest.approx(
        0.5 * analyze(whole.fn, whole.local_args, one).flops, rel=1e-2)
    assert "all_gather" not in s.mesh_stats
    assert s.mesh_stats["reduce_from"]["calls"] == 1 + 2 * 2
