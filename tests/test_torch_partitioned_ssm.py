"""The SSM family's partitioned training products
(``repro_torch.models.partition``, ``models/ssm.py``) on a (1, 2) (data,
model) grid of two gloo ranks on the CPU, against the JAX package's
``model.loss`` and ``jax.grad`` on one device, from the same numpy
parameters (``repro_torch.convert``).

Each case holds W = 2 workers' parameters in the trainer's replicated
layout (``launch.shardings.shard_dims_2d``, ``core.packing
.ShardPackSpec``), so each rank keeps its block of every split leaf:
``in_proj``'s columns (rank 0 all of x, rank 1 all of z), ``out_proj``'s
rows, ``x_proj``'s columns, ``dt_proj``'s rows, ``dt_proj``'s bias on its
layer dim and its vocab rows.  Where ``d_inner`` divides the axis each
rank runs its d_inner/2 channels: ``in_proj``'s block, one all-to-all to
its x and z, the conv, x's channels gathered for ``x_proj``'s whole
product, its ``dt_proj`` columns, B12 on its channels, ``out_proj``'s
rows summed.

* reduced falcon-mamba (d_inner 256, ``x_proj`` 24 wide, dt_rank 8);
* the same under ``REPRO_OPT=chunked_scan`` (chunks of 8 steps);
* dt_rank 7: ``x_proj`` (23 wide) and ``dt_proj`` (7 rows) do not divide
  the axis, so they are replicated and read whole, not gathered;
* d_inner 255: ``inner`` is unbound, the plan is None and every layer is
  gathered whole as before.

Bounds: each rank's loss (W,) to rtol 1e-5 of JAX's, both ranks' losses
bit-equal; each rank's gradient of each block within 1e-5 of the largest
magnitude of JAX's gradient of that leaf.  The collectives are counted
per layer: no all-gather over ``model`` of ``in_proj``, ``out_proj``,
``conv_*``, ``A_log`` or ``D``.  The exchange itself is held to a plain
permutation on the two ranks, forward and backward, and its routes to
every rank's chunks on larger and odd axes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optflags as joptflags  # noqa: E402
from repro.models import registry as jreg  # noqa: E402

from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.packing import (build_shard_packspec,  # noqa: E402
                                      shard_tree)
from repro_torch.launch.mesh import FakeMesh, abstract_mesh  # noqa: E402
from repro_torch.launch.shardings import shard_dims_2d  # noqa: E402
from repro_torch.models.partition import (gathered_model_leaf,  # noqa: E402
                                          xz_routes)
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
W, B, S = 2, 2, 16
ARCH = "falcon-mamba-7b"
#: the chunk of the ``chunked_scan`` case: two chunks of the sequence
CHUNK = 8
#: (name, config fields replaced on its reduced f32 config, REPRO_OPT)
CASES = (
    ("falcon-mamba", {}, None),
    ("falcon-mamba-chunked", {}, "chunked_scan"),
    ("dt-rank-7", {"dt_rank": 7}, None),
    ("inner-255", {"d_inner": 255}, None),
)
NAMES = [c[0] for c in CASES]
#: the model-sharded leaves each case still gathers over ``model``
GATHERED = {
    "falcon-mamba": ["layers/dt_proj/b", "layers/dt_proj/w",
                     "layers/x_proj/w"],
    "falcon-mamba-chunked": ["layers/dt_proj/b", "layers/dt_proj/w",
                             "layers/x_proj/w"],
    "dt-rank-7": ["layers/dt_proj/b"],
    "inner-255": ["embed/table", "layers/dt_proj/b", "layers/dt_proj/w",
                  "layers/in_proj/w", "layers/x_proj/w"],
}
#: the leaves no partitioned case may gather over ``model``
NEVER_GATHERED = ("in_proj", "out_proj", "conv_w", "conv_b", "A_log", "D")


def _jax_case(name, over, opt):
    """JAX's worker-led params (worker 1 a scaled copy of worker 0), the
    batch, its per-worker losses and the gradient of their sum."""
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

    chunk = joptflags.SCAN_CHUNK
    try:
        joptflags.SCAN_CHUNK = CHUNK
        with tm.opt_env(opt):
            grads, losses = jax.jit(jax.grad(total, has_aux=True))(params)
    finally:
        joptflags.SCAN_CHUNK = chunk
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"name": name, "arch": ARCH, "over": over, "opt": opt,
            "scan_chunk": CHUNK if opt else None,
            "params": np_(params), "batch": batch,
            "losses": np.asarray(losses), "grads": np_(grads)}


@pytest.fixture(scope="module")
def jax_ref():
    return {c[0]: _jax_case(*c) for c in CASES}


@pytest.fixture(scope="module")
def spawned(jax_ref, tmp_path_factory):
    cases = [{k: v for k, v in c.items() if k not in ("losses", "grads")}
             for c in jax_ref.values()]
    return tm.spawn(tm.partitioned_ssm_rank, 2,
                    tmp_path_factory.mktemp("ssm"), cases)


@pytest.fixture(scope="module")
def ranks(spawned):
    return {name: [r[name] for r in spawned] for name in NAMES}


def _layout(case):
    """The port's config, JAX's gradient as a torch tree, and the
    trainer's shard layout of it on (1, 2)."""
    cfg = tm.partition_cfg(ARCH, case["over"])
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
def test_collectives_per_layer(ranks, jax_ref, name):
    """Forward: the embedding's sum, each layer's ``out_proj`` sum, its
    all-to-all and its gather of x's channels for ``x_proj``
    (``gather_inner``), the cross-entropy's max and sum, and all-gathers
    over ``model`` of ``x_proj``, ``dt_proj`` and ``dt_proj``'s bias only
    (those the layout splits).  Backward: each layer's all-to-all back
    and ``copy_to`` at ``in_proj``'s input, at the normed (dt, B, C), and
    of each replicated leaf read on the rank's channels (``conv_w``,
    ``conv_b``, ``D``, ``A_log``, ``dt_proj``'s columns and bias), and at
    the unembedding; the checkpointed recompute repeats the layer's
    gathers and exchange.
    With ``inner`` unbound nothing partitions: gathers alone."""
    case = jax_ref[name]
    cfg, full, sspec = _layout(case)
    L = cfg.n_layers
    part = ranks[name][0]["part"]
    gathered, n_gather = [], 0
    for (path, _), md in zip(tree_paths(full), sspec.shard_dims):
        if gathered_model_leaf(path, md, part):
            gathered.append("/".join(path))
            n_gather += L if path[0] == "layers" and md != 0 else 1
    assert gathered == GATHERED[name]
    if name == "inner-255":
        assert part is None
        for r in ranks[name]:
            assert set(r["fwd"]) == {"all_gather"}, r["fwd"]
            assert r["fwd"]["all_gather"] == {"model": n_gather}
            assert set(r["bwd"]) == {"all_gather"}, r["bwd"]
        return
    assert part.inner and part.vocab and part.cache == "batch"
    assert part.proj_cols == ()
    assert not any(p.split("/")[1] in NEVER_GATHERED for p in gathered)
    per_layer = n_gather - 1          # dt_proj's bias: once, whole
    for r in ranks[name]:
        fwd, bwd = r["fwd"], r["bwd"]
        assert fwd == {"reduce_from": {"model": 2 + L},
                       "pmax": {"model": 1}, "all_to_all": {"model": L},
                       "gather_inner": {"model": L},
                       "all_gather": {"model": n_gather}}, fwd
        assert bwd["copy_to"] == {"model": 8 * L + 1}, bwd
        assert bwd["all_to_all"] == {"model": 2 * L}, bwd
        assert bwd["gather_inner"] == {"model": L}, bwd
        assert bwd.get("all_gather", {"model": 0}) == {"model": per_layer}
        assert "pmax" not in bwd and "psum" not in bwd


def test_the_exchange_is_a_permutation(spawned):
    """On the (1, 2) grid rank 0's ``in_proj`` block is all of x and rank
    1's all of z: after the exchange rank j holds x's and z's columns
    ``[2j, 2j + 2)``, exactly; the gradient its block gets back is the
    loss's weights at the columns it sent, one all-to-all each way."""
    for r in spawned:
        ex, j = r["exchange"], r["exchange"]["j"]
        full, a = ex["full"], ex["a"]
        np.testing.assert_array_equal(ex["x"], full[:, 2 * j:2 * j + 2])
        np.testing.assert_array_equal(ex["z"], full[:, 4 + 2 * j:6 + 2 * j])
        np.testing.assert_array_equal(ex["grad"], a[:, 4 * j:4 * j + 4])
        assert ex["calls"] == {"all_to_all": {"model": 2}}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 16])
def test_the_exchange_routes_reach_every_ranks_chunks(n):
    """``partition.xz_routes`` on an axis of n ranks, simulated: each rank
    r sends its chunks 2r and 2r + 1 of ``[x | z]`` (2n chunks) in the
    order of its destinations, and receives, in the order of their
    sources, exactly chunk r (its x) and chunk n + r (its z)."""
    routes = [xz_routes(n, r) for r in range(n)]
    inbox = {j: [] for j in range(n)}
    for r, (flip, send, _recv) in enumerate(routes):
        chunks = [2 * r, 2 * r + 1][::-1 if flip else 1]
        dests = [j for j in range(n) for _ in range(send[j])]
        assert len(dests) == 2 and dests == sorted(dests)
        for j, c in zip(dests, chunks):
            inbox[j].append((r, c))
    for r, (_flip, _send, recv) in enumerate(routes):
        got = sorted(inbox[r])
        assert [src for src, _ in got] == [
            j for j in range(n) for _ in range(recv[j])]
        assert [c for _, c in got] == [r, n + r]


def test_fake_mesh_counts_the_exchange():
    """The dry run's mesh counts an all-to-all under its own kind: the
    result's bytes, once."""
    mesh = FakeMesh((1, 2), ("data", "model"))
    x = torch.empty((2, 3, 5), device="meta")
    y = mesh.all_to_all(x, "model", (1, 1), (1, 1))
    assert tuple(y.shape) == (2, 3, 5)
    assert mesh.stats["all_to_all"]["calls"] == 1
    assert mesh.coll == {"all-to-all": {"count": 1, "bytes": 2 * 3 * 5 * 4}}
