"""The hybrid family's partitioned training products
(``repro_torch.models.partition``, ``models/hybrid.py``) on (1, 2) and
(1, 4) (data, model) grids of gloo ranks on the CPU, against the JAX
package's ``model.loss`` and ``jax.grad`` on one device, from the same
numpy parameters (``repro_torch.convert``).

Each case is reduced recurrentgemma-2b with 5 layers (one super-block of
rec, rec, attn, stacked, and the tail list of two rec layers), in f32,
with W = 2 workers' parameters in the trainer's replicated layout
(``launch.shardings.shard_dims_2d``, ``core.packing.ShardPackSpec``).
Where ``lru_width`` divides the axis each rank runs its lru_width/m
channels of every recurrent block: ``w_gelu``'s and ``w_rec``'s columns,
the conv and Λ on its channels, the conv's output gathered for its
``gate_a``/``gate_x`` columns, B12 on its channels, ``w_out``'s rows
summed; the local attention and the MLP take the dense family's plan.

* recurrentgemma on (1, 2): 4 heads split, the one KV head's ``wk``/``wv``
  gathered;
* heads whole on (1, 4): ``n_heads`` 2 does not divide the axis, so the
  attention runs whole on its gathered weights while the RG-LRU and MLP
  products split four ways;
* lru 129 on (1, 2): ``lru`` is unbound, the plan is None and every layer
  is gathered whole as before.

The gates' biases are the trap: the layout splits a stacked super-block's
(L, dw) bias on its last dim, and replicates the tail's (dw,).

Bounds: each rank's loss (W,) to rtol 1e-5 of JAX's, the ranks' losses
bit-equal; each rank's gradient of each block within 1e-5 of the largest
magnitude of JAX's gradient of that leaf.  The collectives are counted
per layer: no all-gather over ``model`` of an RG-LRU or MLP leaf.
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
from repro_torch.models.partition import gathered_model_leaf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
W, B, S = 2, 2, 16
ARCH = "recurrentgemma-2b"
#: one super-block and the (rec, rec) tail
LAYERS = 5
#: (name, config fields replaced on its reduced f32 config, model axis)
CASES = (
    ("recurrentgemma", {}, 2),
    ("heads-whole", {"n_heads": 2}, 4),
    ("lru-129", {"lru_width": 129}, 2),
)
NAMES = [c[0] for c in CASES]
BY_NAME = {c[0]: c for c in CASES}
#: the model-sharded leaves each case still gathers over ``model``
GATHERED = {
    "recurrentgemma": ["super/b2/temporal/attn/wk/w",
                       "super/b2/temporal/attn/wv/w"],
    "heads-whole": ["super/b2/temporal/attn/wk/w",
                    "super/b2/temporal/attn/wo/w",
                    "super/b2/temporal/attn/wq/w",
                    "super/b2/temporal/attn/wv/w"],
}
#: the RG-LRU and MLP leaves no partitioned case may gather over ``model``
NEVER_GATHERED = ("w_gelu", "w_rec", "gate_a", "gate_x", "w_out", "conv_w",
                  "conv_b", "lam", "gate", "up", "down")


def _over(name):
    return dict(BY_NAME[name][1], n_layers=LAYERS)


def _jax_case(name):
    """JAX's worker-led params (worker 1 a scaled copy of worker 0), the
    batch, its per-worker losses and the gradient of their sum."""
    over = _over(name)
    jcfg = dataclasses.replace(jreg.get_config(ARCH).reduced(),
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

    grads, losses = jax.jit(jax.grad(total, has_aux=True))(params)
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"name": name, "arch": ARCH, "over": over,
            "params": np_(params), "batch": batch,
            "losses": np.asarray(losses), "grads": np_(grads)}


@pytest.fixture(scope="module")
def jax_ref():
    return {name: _jax_case(name) for name in NAMES}


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    """Each case's ranks' results: one spawn of two ranks for the (1, 2)
    cases, one of four for the (1, 4) case."""
    out = {}
    for m in (2, 4):
        cases = [{k: v for k, v in jax_ref[name].items()
                  if k not in ("losses", "grads")}
                 for name in NAMES if BY_NAME[name][2] == m]
        res = tm.spawn(tm.partitioned_rank, m,
                       tmp_path_factory.mktemp(f"hybrid{m}"), cases, (1, m))
        out.update({c["name"]: [r[c["name"]] for r in res] for c in cases})
    return out


def _layout(case, m):
    """The port's config, JAX's gradient as a torch tree, and the
    trainer's shard layout of it on (1, m)."""
    cfg = tm.partition_cfg(ARCH, case["over"])
    full = model_params_from_numpy(case["grads"], device="cpu")
    mesh = abstract_mesh((1, m), ("data", "model"))
    md, fd = shard_dims_2d(full, cfg, mesh, multi_pod=False)
    sspec = build_shard_packspec(full, md, m, batch_dims=1, fsdp_dims=fd,
                                 n_fsdp=1)
    return cfg, full, sspec


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax_and_ranks_agree_bitwise(ranks, jax_ref, name):
    want = jax_ref[name]["losses"]
    got = [r["loss"] for r in ranks[name]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_grads_of_each_block_match_jax(ranks, jax_ref, name):
    case = jax_ref[name]
    _, full, sspec = _layout(case, BY_NAME[name][2])
    paths = ["/".join(p) for p, _ in tree_paths(full)]
    for x in ranks[name]:
        want = tree_leaves(shard_tree(sspec, full, x["j"]))
        for path, g, w, whole in zip(paths, tree_leaves(x["grads"]), want,
                                     tree_leaves(full)):
            scale = float(whole.abs().max())
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{path} rank {x['j']}")


def test_the_gates_biases_are_laid_out_two_ways(jax_ref):
    """The stacked super-block's gate biases (W, L, dw) are the rank's
    column block, the tail's (W, dw) are replicated and read on the rank's
    channels: the layout (``shard_dims_2d``) and the plan agree leaf by
    leaf."""
    _, full, sspec = _layout(jax_ref["recurrentgemma"], 2)
    dims = {"/".join(p): d for (p, _), d in zip(tree_paths(full),
                                                sspec.shard_dims)}
    for g in ("gate_a", "gate_x"):
        assert dims[f"super/b0/temporal/{g}/b"] == 1
        assert dims[f"super/b1/temporal/{g}/b"] == 1
        assert dims[f"tail/#0/temporal/{g}/b"] is None
        assert dims[f"tail/#1/temporal/{g}/b"] is None
        assert dims[f"tail/#0/temporal/{g}/w"] == 1


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_layer(ranks, jax_ref, name):
    """Forward: the embedding's sum, each recurrent layer's gather of the
    conv's channels (``gather_inner``) and ``w_out`` sum, the attention's
    ``wo`` sum (where its heads split), each MLP's ``down`` sum, the
    cross-entropy's max and sum, and all-gathers over ``model`` of the
    attention's gathered leaves only.  Backward: the checkpointed
    super-block's recompute repeats its forward collectives up to the last
    its backward needs (torch's checkpoint stops there, before the last
    MLP's sum); each
    recurrent layer reduce-scatters its gathered channels' gradient once,
    and sums (``copy_to``) at ``w_gelu``/``w_rec``'s input and for each
    replicated leaf read on its channels (``conv_w``, ``conv_b``, ``lam``,
    and the tail's gate biases); each split attention at ``wq``'s input and
    for ``wk``/``wv``, each MLP at its input, and the unembedding once.
    With ``lru`` unbound nothing partitions: gathers alone."""
    m = BY_NAME[name][2]
    case = jax_ref[name]
    cfg, full, sspec = _layout(case, m)
    part = ranks[name][0]["part"]
    gathered, n_gather = [], 0
    for (path, _), md in zip(tree_paths(full), sspec.shard_dims):
        if gathered_model_leaf(path, md, part):
            gathered.append("/".join(path))
            n_gather += 1
    if name == "lru-129":
        assert part is None
        for r in ranks[name]:
            assert set(r["fwd"]) == {"all_gather"}, r["fwd"]
            assert r["fwd"]["all_gather"] == {"model": n_gather}
            assert set(r["bwd"]) == {"all_gather"}, r["bwd"]
        return
    assert gathered == GATHERED[name]
    assert not any(p.split("/")[-2] in NEVER_GATHERED
                   or p.split("/")[-1] in NEVER_GATHERED for p in gathered)
    assert part.lru and part.ff and part.vocab and part.cache == "batch"
    assert part.heads == (name == "recurrentgemma")
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    tail = cfg.n_layers - n_super * len(pat)
    n_rec = n_super * pat.count("rec") + tail
    n_attn = n_super * pat.count("attn")
    heads = part.heads
    # the super-block's own collectives, which its recompute repeats
    sup_rec, sup_attn = pat.count("rec"), pat.count("attn")
    sup_sum = sup_rec + sup_attn * heads + len(pat) - 1
    fwd_sum = 2 + n_rec + n_attn * heads + cfg.n_layers
    copies = (4 * n_rec + 2 * tail + n_attn * 3 * heads + cfg.n_layers + 1)
    for r in ranks[name]:
        fwd, bwd = r["fwd"], r["bwd"]
        assert fwd == {"reduce_from": {"model": fwd_sum},
                       "pmax": {"model": 1},
                       "gather_inner": {"model": n_rec},
                       "all_gather": {"model": n_gather}}, fwd
        assert bwd == {"reduce_from": {"model": n_super * sup_sum},
                       "gather_inner": {"model": n_super * sup_rec},
                       "all_gather": {"model": n_gather},
                       "reduce_scatter": {"model": n_rec},
                       "copy_to": {"model": copies}}, bwd
