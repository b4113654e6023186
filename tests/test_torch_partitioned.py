"""The partitioned products (``repro_torch.models.partition``) on a (1, 2)
(data, model) grid of two gloo ranks on the CPU, against the JAX
package's ``model.loss`` and ``jax.grad`` on one device, from the same
numpy parameters (``repro_torch.convert``).

Each case holds W = 2 workers' parameters in the trainer's replicated
layout (``launch.shardings.shard_dims_2d``, ``core.packing
.ShardPackSpec``), so each rank keeps its column or row block of every
split leaf and the trainer's plan (``partition_for``, ``gather.make_plan``)
decides which products partition:

* reduced granite-8b (GQA, swiglu), starcoder2-15b (gelu, biases: the
  column biases on the rank's columns, ``fc_out``'s gathered on its layer
  dim and added after the sum), codeqwen1.5-7b (MHA, ``qkv_bias``) and
  pixtral-12b (the ``projector`` gathered, its output the residual
  stream), all in f32;
* a dense config with one KV head (``kv_heads`` unbound: ``wk``/``wv``
  gathered and read through ``copy_to``), one with 6 heads on 3 KV heads
  and biases (each rank's 3 query heads read KV heads 0, 0, 1: the KV
  heads repeated to one a head) and one under a sliding window (the
  masked einsum on the rank's heads).

Bounds: each rank's loss (W,) to rtol 1e-5 of JAX's, both ranks' losses
bit-equal; each rank's gradient of each block within 1e-5 of the largest
magnitude of JAX's gradient of that leaf.  The collectives are counted
per layer: a ``copy_to`` (backward psum) at the input of each column-split
product group and a ``reduce_from`` (forward psum) at each row-split
output, and no all-gather over ``model`` but of the leaves whose products
do not partition.
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
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.partition import gathered_model_leaf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
W, B, S = 2, 2, 16
#: (name, arch, config fields replaced on its reduced f32 config)
CASES = (
    ("granite-8b", "granite-8b", {}),
    ("starcoder2-15b", "starcoder2-15b", {}),
    ("codeqwen1.5-7b", "codeqwen1.5-7b", {}),
    ("pixtral-12b", "pixtral-12b", {}),
    ("kv1", "granite-8b", {"n_kv_heads": 1}),
    ("uneven", "codeqwen1.5-7b", {"n_heads": 6, "n_kv_heads": 3}),
    ("window", "granite-8b", {"n_kv_heads": 2, "sliding_window": 8}),
)
NAMES = [c[0] for c in CASES]


def _jax_case(name, arch, over):
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
    if jcfg.modality == "vision":
        batch["patches"] = rng.standard_normal(
            (W, B, jcfg.frontend_tokens, jcfg.frontend_dim)).astype(
                np.float32)

    def total(p):
        losses = jax.vmap(lambda q, b: jm.loss(q, b)[0])(
            p, jax.tree.map(jnp.asarray, batch))
        return losses.sum(), losses

    grads, losses = jax.jit(jax.grad(total, has_aux=True))(params)
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"name": name, "arch": arch, "over": over, "params": np_(params),
            "batch": batch, "losses": np.asarray(losses),
            "grads": np_(grads)}


@pytest.fixture(scope="module")
def jax_ref():
    return {name: _jax_case(name, arch, over) for name, arch, over in CASES}


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    cases = [{k: v for k, v in c.items() if k not in ("losses", "grads")}
             for c in jax_ref.values()]
    return tm.spawn(tm.partitioned_rank, 2,
                    tmp_path_factory.mktemp("part"), cases)


def _layout(case):
    """The port's config, JAX's gradient as a torch tree, and the
    trainer's shard layout of it on (1, 2)."""
    model = build_model(tm.partition_cfg(case["arch"], case["over"]))
    full = model_params_from_numpy(case["grads"], device="cpu")
    mesh = abstract_mesh((1, 2), ("data", "model"))
    md, fd = shard_dims_2d(full, model.cfg, mesh, multi_pod=False)
    sspec = build_shard_packspec(full, md, 2, batch_dims=1, fsdp_dims=fd,
                                 n_fsdp=1)
    return model.cfg, full, sspec


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax_and_ranks_agree_bitwise(ranks, jax_ref, name):
    want = jax_ref[name]["losses"]
    got = [r[name]["loss"] for r in ranks]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_grads_of_each_block_match_jax(ranks, jax_ref, name):
    case = jax_ref[name]
    _, full, sspec = _layout(case)
    paths = ["/".join(p) for p, _ in tree_paths(full)]
    for r in ranks:
        x = r[name]
        want = tree_leaves(shard_tree(sspec, full, x["j"]))
        for path, g, w, whole in zip(paths, tree_leaves(x["grads"]), want,
                                     tree_leaves(full)):
            scale = float(whole.abs().max())
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{path} rank {x['j']}")


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_layer(ranks, jax_ref, name):
    case = jax_ref[name]
    cfg, full, sspec = _layout(case)
    L = cfg.n_layers
    part = ranks[0][name]["part"]
    assert part is not None
    assert part.heads and part.ff and part.vocab
    assert part.kv == (cfg.n_kv_heads % 2 == 0)
    # the model-sharded leaves still gathered: none of a partitioned
    # product's
    gathered, n_gather = [], 0
    for (path, _), md in zip(tree_paths(full), sspec.shard_dims):
        if gathered_model_leaf(path, md, part):
            gathered.append("/".join(path))
            n_gather += 1 if (path[0] != "layers" or md == 0) else L
    want_gathered = {
        "starcoder2-15b": ["layers/mlp/fc_out/b"],
        "pixtral-12b": ["projector/w"],
        "kv1": ["layers/attn/wk/w", "layers/attn/wv/w"],
        "uneven": ["layers/attn/wk/b", "layers/attn/wk/w",
                   "layers/attn/wv/b", "layers/attn/wv/w"],
    }.get(name, [])
    assert gathered == want_gathered
    # a leaf read whole for the rank's own part sums its gradient (wk/wv
    # and their biases where the KV heads do not split)
    whole = 0 if part.kv else 2 * (1 + cfg.qkv_bias)
    for r in ranks:
        fwd, bwd = r[name]["fwd"], r[name]["bwd"]
        # forward: the embedding's sum, each layer's attention and MLP
        # outputs, and the cross-entropy's max and its one sum
        assert fwd.get("reduce_from") == {"model": 1 + 2 * L + 1}, fwd
        assert fwd.get("pmax") == {"model": 1}, fwd
        assert "copy_to" not in fwd and "psum" not in fwd
        assert fwd.get("all_gather", {}) == (
            {"model": n_gather} if n_gather else {}), fwd
        # backward: copy_to at the input of each layer's attention and MLP
        # and of the unembedding, and once a layer for each leaf read
        # whole; the checkpoint's recompute re-issues each layer's
        # attention sum (the MLP's output is not saved for the backward,
        # so its sum is not recomputed)
        assert bwd["copy_to"] == {"model": 2 * L + 1 + whole * L}, bwd
        assert bwd["reduce_from"] == {"model": L}, bwd
        assert "pmax" not in bwd and "psum" not in bwd
