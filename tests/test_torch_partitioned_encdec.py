"""The audio enc-dec family's partitioned training products
(``repro_torch.models.partition``, ``models/encdec.py``) on (1, 2) and
(1, 4) (data, model) grids of gloo ranks on the CPU, against the JAX
package's ``model.loss`` and ``jax.grad`` on one device, from the same
numpy parameters (``repro_torch.convert``).

Each case is reduced seamless-m4t-medium (2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, d_ff 256, 16 stub frames) in f32, with W = 2
workers' parameters in the trainer's replicated layout
(``launch.shardings.shard_dims_2d``, ``core.packing.ShardPackSpec``).
Each rank runs its heads of the encoder's bidirectional attention and of
the decoder's self- and cross-attention (``wo``'s rows summed), its ff
columns of every MLP and, where ``vocab`` binds, its vocab rows of the
embedding and the logits (a vocab-parallel cross-entropy):

* seamless on (1, 2): 4 heads and 4 KV heads split, vocab 512 split;
* one KV head on (1, 2): ``kv_heads`` unbound, ``wk``/``wv`` gathered and
  read whole through ``copy_to`` (the encoder's, the decoder's self- and
  cross-attention's);
* vocab 514 on (1, 4): 4 heads split four ways, the vocab unbound (the
  table and the logits whole on every rank, as the full config's 256,206
  rows stay on 16 ranks).

The trap is the encoder memory: every decoder layer projects it through
its own K/V columns, so a rank's gradient of it is partial; the decoder
reads it through ``copy_to`` once, whose backward sums the ranks'.

Bounds: each rank's loss (W,) to rtol 1e-5 of JAX's, the ranks' losses
bit-equal; each rank's gradient of each block within 1e-5 of the largest
magnitude of JAX's gradient of that leaf.  The collectives are counted per
layer.  Then 3 noise-free replicated rounds (one local step at 1e-2) of
the seamless case on (1, 2), each from the rank's block of one device's
state before it, against one device's round: the losses to rtol 1e-5 and
each rank's Θ block within 1e-5 of its largest.
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
from repro_torch.models.partition import (FAMILIES,  # noqa: E402
                                          SERVE_FAMILIES,
                                          gathered_model_leaf)
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
W, B, S = 2, 2, 16
ARCH = "seamless-m4t-medium"
#: (name, config fields replaced on its reduced f32 config, model axis)
CASES = (
    ("seamless", {}, 2),
    ("kv1", {"n_kv_heads": 1}, 2),
    ("vocab-514", {"vocab_size": 514}, 4),
)
NAMES = [c[0] for c in CASES]
BY_NAME = {c[0]: c for c in CASES}
#: the model-sharded leaves each case still gathers over ``model``: the
#: MLP's ``fc_out`` bias, which the layout splits on its layer dim where
#: the layer count divides the axis, and ``wk``/``wv`` where the KV heads
#: do not split
_BIAS = ["dec_layers/mlp/fc_out/b", "enc_layers/mlp/fc_out/b"]
_KV = ["dec_layers/cross_attn/wk/w", "dec_layers/cross_attn/wv/w",
       "dec_layers/self_attn/wk/w", "dec_layers/self_attn/wv/w",
       "enc_layers/attn/wk/w", "enc_layers/attn/wv/w"]
GATHERED = {"seamless": _BIAS, "kv1": sorted(_BIAS + _KV), "vocab-514": []}
#: the rounds against one device
ROUNDS = 3


def _over(name):
    return dict(BY_NAME[name][1])


def _jcfg(name):
    return dataclasses.replace(jreg.get_config(ARCH).reduced(),
                               param_dtype="float32", **_over(name))


def _batch(cfg):
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(0, cfg.vocab_size, (W, B, S),
                                   dtype=np.int32),
            "frames": tm.encdec_frames(B, cfg.frontend_tokens, cfg.d_model,
                                       (W,)).numpy()}


def _jax_case(name):
    """JAX's worker-led params (worker 1 a scaled copy of worker 0), the
    batch, its per-worker losses and the gradient of their sum."""
    jcfg = _jcfg(name)
    jm = jreg.build_model(jcfg)
    p0 = jm.init(KEY)
    params = jax.tree.map(lambda l: jnp.stack([l, l * 0.9 + 0.01]), p0)
    batch = _batch(jcfg)

    def total(p):
        losses = jax.vmap(lambda q, b: jm.loss(q, b)[0])(
            p, jax.tree.map(jnp.asarray, batch))
        return losses.sum(), losses

    grads, losses = jax.jit(jax.grad(total, has_aux=True))(params)
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"name": name, "arch": ARCH, "over": _over(name),
            "params": np_(params), "batch": batch,
            "losses": np.asarray(losses), "grads": np_(grads)}


@pytest.fixture(scope="module")
def jax_ref():
    return {name: _jax_case(name) for name in NAMES}


@pytest.fixture(scope="module")
def spawned(jax_ref, tmp_path_factory):
    """One spawn of two ranks for the (1, 2) cases and the rounds, one of
    four for the (1, 4) case: each rank's results by case."""
    out = {}
    for m in (2, 4):
        cases = [{k: v for k, v in jax_ref[name].items()
                  if k not in ("losses", "grads")}
                 for name in NAMES if BY_NAME[name][2] == m]
        rounds = (dict(over=_over("seamless"),
                       batch=jax_ref["seamless"]["batch"], rounds=ROUNDS)
                  if m == 2 else None)
        out[m] = tm.spawn(tm.partitioned_encdec_rank, m,
                          tmp_path_factory.mktemp(f"encdec{m}"), cases,
                          (1, m), rounds)
    return out


@pytest.fixture(scope="module")
def ranks(spawned):
    return {name: [r[name] for r in spawned[BY_NAME[name][2]]]
            for name in NAMES}


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


def test_the_audio_family_partitions_in_training_and_serving():
    assert "audio" in FAMILIES and "audio" in SERVE_FAMILIES


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


def _gathers(full, sspec, part):
    """(the gathered leaves' paths, the all-gathers of one forward): a
    leaf split on its stacked entry dim once (``gather_params``), any
    other once an entry (``gather_entry``, inside the entry's
    checkpoint)."""
    paths, calls = [], 0
    for (path, x), md in zip(tree_paths(full), sspec.shard_dims):
        if gathered_model_leaf(path, md, part):
            paths.append("/".join(path))
            calls += 1 if md == 0 else x.shape[1]
    return sorted(paths), calls


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_layer(ranks, jax_ref, name):
    """Forward: the embedding's sum (where the vocab splits), each
    encoder layer's ``wo`` and ``fc_out`` sums, each decoder layer's self-
    and cross-attention ``wo`` sums and ``fc_out`` sum, the
    cross-entropy's max and sum (vocab-parallel), and all-gathers over
    ``model`` of the gathered leaves only.  Backward: each checkpointed
    layer's recompute repeats its forward collectives up to the last its
    backward needs (torch's checkpoint stops before the layer's ``fc_out``
    sum), so its attention sums and its per-entry gathers; ``copy_to``'s
    sums at each attention's and MLP's input, at the cross-attention's
    query input, for each gathered ``wk``/``wv`` read whole, once for the
    encoder memory and once for the unembedding."""
    m = BY_NAME[name][2]
    cfg, full, sspec = _layout(jax_ref[name], m)
    part = ranks[name][0]["part"]
    assert part.heads and part.ff and part.cache == "batch"
    assert part.kv == (name != "kv1")
    assert part.vocab == (name != "vocab-514")
    gathered, n_gather = _gathers(full, sspec, part)
    assert gathered == GATHERED[name]
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    vocab = part.vocab
    kv_copies = 0 if part.kv else 2
    fwd = {"reduce_from": {"model": vocab + 2 * Le + 3 * Ld + vocab}}
    if vocab:
        fwd["pmax"] = {"model": 1}
    entry_gathers = n_gather - sum(1 for p in gathered if p in _BIAS)
    bwd = {"reduce_from": {"model": Le + 2 * Ld},
           "copy_to": {"model": (2 + kv_copies) * Le
                       + (3 + 2 * kv_copies) * Ld + 1 + vocab}}
    if n_gather:
        fwd["all_gather"] = {"model": n_gather}
    if entry_gathers:
        bwd["all_gather"] = {"model": entry_gathers}
    for r in ranks[name]:
        assert r["fwd"] == fwd, r["fwd"]
        assert r["bwd"] == bwd, r["bwd"]


def test_rounds_match_one_device(spawned):
    """3 noise-free replicated rounds of reduced seamless on (1, 2), each
    model rank fed the whole batch (the tokens and the frames alike) and
    each round from the rank's block of one device's state before it,
    against one device's round: the losses and each rank's Θ block."""
    for r in spawned[2]:
        got = r["rounds"]
        assert len(got["losses"]) == ROUNDS
        np.testing.assert_allclose(got["losses"], got["losses_one"],
                                   rtol=1e-5, atol=0)
        for i in range(ROUNDS):
            for (path, a), (_, b) in zip(tree_paths(got["Theta"][i]),
                                         tree_paths(got["Theta_one"][i])):
                scale = float(np.abs(b).max()) or 1.0
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-5 * scale,
                    err_msg=f"round {i + 1} {'/'.join(path)}")
    np.testing.assert_array_equal(spawned[2][0]["rounds"]["losses"],
                                  spawned[2][1]["rounds"]["losses"])
