"""The MoE family's partitioned training products
(``repro_torch.models.partition``, ``models/moe.py``) on a (1, 2) (data,
model) grid of two gloo ranks on the CPU, against the JAX package's
``model.loss`` and ``jax.grad`` on one device, from the same numpy
parameters (``repro_torch.convert``).

Each case holds W = 2 workers' parameters in the trainer's replicated
layout (``launch.shardings.shard_dims_2d``, ``core.packing
.ShardPackSpec``), so each rank keeps its block of every split leaf: its
E/2 routed experts, its attention heads (GQA's ``wq``/``wk``/``wv``
columns, or MLA's ``wq_b``/``wq`` columns and ``wk_b``/``wv_b`` heads),
``wo``'s rows, its shared expert's and dense MLP's hidden columns and its
vocab rows.  Every rank routes the whole (token, k) set alike.

* reduced qwen3-moe (GQA, 4 experts top 2);
* reduced deepseek-v3: MLA with q-LoRA, the shared expert, a dense first
  layer and the MTP head (its block's experts gathered: the layout splits
  them on their hidden dim);
* deepseek-v3 without q-LoRA (MLA's ``wq``);
* qwen3-moe under ``grouped_moe`` (16 token groups, a capacity each);
* qwen3-moe with 3 experts, which do not divide the axis: the experts stay
  gathered whole on every rank and the rest partitions.

Bounds: each rank's loss (W,) to rtol 1e-5 of JAX's, both ranks' losses
bit-equal; each rank's gradient of each block within 1e-5 of the largest
magnitude of JAX's gradient of that leaf; every dispatch's picks and kept
pairs equal to one device's (the port's, itself held to JAX's picks in
``tests/test_torch_moe.py``) and across the ranks.  The collectives are
counted per layer, and no leaf of a partitioned product is gathered over
``model``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402

from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.packing import (build_shard_packspec,  # noqa: E402
                                      shard_tree)
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.launch.shardings import shard_dims_2d  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.partition import gathered_model_leaf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
W, B, S = 2, 2, 16
QWEN, DSV3 = "qwen3-moe-30b-a3b", "deepseek-v3-671b"
#: (name, arch, config fields replaced on its reduced f32 config,
#: REPRO_OPT)
CASES = (
    ("qwen3-moe", QWEN, {}, None),
    ("deepseek-v3", DSV3, {}, None),
    ("deepseek-v3-wq", DSV3, {"q_lora_rank": 0}, None),
    ("qwen3-moe-grouped", QWEN, {}, "grouped_moe"),
    ("experts3", QWEN, {"n_experts": 3}, None),
)
NAMES = [c[0] for c in CASES]
#: the model-sharded leaves each case still gathers over ``model``
GATHERED = {
    "qwen3-moe": ["moe_layers/mlp/router/w"],
    "qwen3-moe-grouped": ["moe_layers/mlp/router/w"],
    "experts3": ["moe_layers/mlp/down", "moe_layers/mlp/gate",
                 "moe_layers/mlp/up"],
    "deepseek-v3": [
        "dense_layers/attn/wkv_a/w", "dense_layers/attn/wq_a/w",
        "moe_layers/attn/wkv_a/w", "moe_layers/attn/wq_a/w",
        "moe_layers/mlp/router/w", "mtp_block/attn/wkv_a/w",
        "mtp_block/attn/wq_a/w", "mtp_block/mlp/down", "mtp_block/mlp/gate",
        "mtp_block/mlp/router/w", "mtp_block/mlp/up", "mtp_proj/w"],
    "deepseek-v3-wq": [
        "dense_layers/attn/wkv_a/w", "moe_layers/attn/wkv_a/w",
        "moe_layers/mlp/router/w", "mtp_block/attn/wkv_a/w",
        "mtp_block/mlp/down", "mtp_block/mlp/gate", "mtp_block/mlp/router/w",
        "mtp_block/mlp/up", "mtp_proj/w"],
}


def _jax_case(name, arch, over, opt):
    """JAX's worker-led params (worker 1 a scaled copy of worker 0), the
    batch, its per-worker losses and the gradient of their sum."""
    jcfg = dataclasses.replace(jreg.get_config(arch).reduced(),
                               param_dtype="float32", **over)
    jm = jreg.build_model(jcfg)
    p0 = jm.init(KEY)
    params = jax.tree.map(lambda l: jnp.stack([l, l * 0.9 + 0.01]), p0)
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (W, B, S),
                                    dtype=np.int32)}

    def total(p):
        losses = jax.vmap(lambda q, b: jm.loss(q, b)[0])(
            p, jax.tree.map(jnp.asarray, batch))
        return losses.sum(), losses

    with tm.opt_env(opt):
        grads, losses = jax.jit(jax.grad(total, has_aux=True))(params)
        np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        return {"name": name, "arch": arch, "over": over, "opt": opt,
                "params": np_(params), "batch": batch,
                "losses": np.asarray(losses), "grads": np_(grads)}


@pytest.fixture(scope="module")
def jax_ref():
    return {c[0]: _jax_case(*c) for c in CASES}


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    cases = [{k: v for k, v in c.items() if k not in ("losses", "grads")}
             for c in jax_ref.values()]
    res = tm.spawn(tm.partitioned_rank, 2, tmp_path_factory.mktemp("moe"),
                   cases)
    return {name: [r[name] for r in res] for name in NAMES}


def _cfg(case):
    return tm.partition_cfg(case["arch"], case["over"])


def _layout(case):
    """The port's config, JAX's gradient as a torch tree, and the
    trainer's shard layout of it on (1, 2)."""
    cfg = _cfg(case)
    full = model_params_from_numpy(case["grads"], device="cpu")
    mesh = abstract_mesh((1, 2), ("data", "model"))
    md, fd = shard_dims_2d(full, cfg, mesh, multi_pod=False)
    sspec = build_shard_packspec(full, md, 2, batch_dims=1, fsdp_dims=fd,
                                 n_fsdp=1)
    return cfg, full, sspec


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax_and_ranks_agree_bitwise(ranks, jax_ref, name):
    want = jax_ref[name]["losses"]
    got = [r["loss"] for r in ranks[name]]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_grads_of_each_block_match_jax(ranks, jax_ref, name):
    case = jax_ref[name]
    _, full, sspec = _layout(case)
    paths = ["/".join(p) for p, _ in tree_paths(full)]
    for x in ranks[name]:
        want = tree_leaves(shard_tree(sspec, full, x["j"]))
        for path, g, w, whole in zip(paths, tree_leaves(x["grads"]), want,
                                     tree_leaves(full)):
            scale = float(whole.abs().max())
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{path} rank {x['j']}")


@pytest.mark.parametrize("name", NAMES)
def test_picks_and_drops_equal_one_device(ranks, jax_ref, name):
    """Every dispatch of the forward picks the experts and keeps the pairs
    one device picks and keeps on the same parameters and batch, and the
    ranks agree."""
    case = jax_ref[name]
    model = build_model(_cfg(case))
    params = model_params_from_numpy(case["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    with tm.opt_env(case["opt"]), moe.record_routing() as seen, torch.no_grad():
        model.loss(params, batch)
    n_moe = len(seen)
    assert n_moe == model.cfg.n_layers - model.cfg.first_dense_layers \
        + model.cfg.mtp
    for r in ranks[name]:
        assert len(r["routing"]) == n_moe
        for i, (got, want) in enumerate(zip(r["routing"], seen)):
            for k in ("idx", "kept"):
                np.testing.assert_array_equal(got[k], want[k].numpy(),
                                              err_msg=f"dispatch {i} {k}")
                np.testing.assert_array_equal(
                    got[k], ranks[name][0]["routing"][i][k])


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_layer(ranks, jax_ref, name):
    """Forward: the embedding's sums (the MTP's lookup too), each layer's
    attention and MLP sums (a MoE layer's routed experts where they split
    and its shared expert), each cross-entropy's max and sum, and
    all-gathers over ``model`` of the leaves whose products do not
    partition only.  Backward: ``copy_to`` at the input of each split
    product group (a MoE layer's dispatch input and gates where its
    experts split; MLA's q input and c_kv/k_rope) and of each
    unembedding."""
    case = jax_ref[name]
    cfg, full, sspec = _layout(case)
    nd = cfg.first_dense_layers
    nm = cfg.n_layers - nd
    part = ranks[name][0]["part"]
    assert part is not None and part.heads and part.ff and part.vocab
    split = cfg.n_experts % 2 == 0
    assert part.expert == split
    assert part.shared_ff == bool(cfg.n_shared_experts)
    entries = {"dense_layers": nd, "moe_layers": nm}
    gathered, n_gather = [], 0
    for (path, _), md in zip(tree_paths(full), sspec.shard_dims):
        if gathered_model_leaf(path, md, part):
            gathered.append("/".join(path))
            n_gather += entries.get(path[0], 1) if md != 0 else 1
    assert gathered == GATHERED[name]
    mtp = int(cfg.mtp)
    # a moe block's sums: attention, the split experts, the shared expert
    moe_sums = 1 + split + bool(cfg.n_shared_experts)
    # the MTP block's experts are gathered: attention and the shared one
    mtp_sums = 1 + bool(cfg.n_shared_experts)
    fwd_reduce = ((1 + mtp) + 2 * nd + moe_sums * nm + mtp * mtp_sums
                  + (1 + mtp))
    # copy_to: attention's input, an MLA layer's c_kv and k_rope; the
    # dense MLP's input; the dispatch input and gates; the shared expert
    attn_in = 3 if cfg.use_mla else 1
    bwd_copy = (attn_in + 1) * nd + (attn_in + 2 * split
                                     + bool(cfg.n_shared_experts)) * nm \
        + mtp * (attn_in + bool(cfg.n_shared_experts)) + 1 + mtp
    for r in ranks[name]:
        fwd, bwd = r["fwd"], r["bwd"]
        assert fwd.get("reduce_from") == {"model": fwd_reduce}, fwd
        assert fwd.get("pmax") == {"model": 1 + mtp}, fwd
        assert "copy_to" not in fwd and "psum" not in fwd
        assert fwd.get("all_gather") == {"model": n_gather}, fwd
        assert bwd["copy_to"] == {"model": bwd_copy}, bwd
        assert "pmax" not in bwd and "psum" not in bwd
