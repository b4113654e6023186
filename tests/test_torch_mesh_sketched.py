"""The port's sketched mode (A-FADMM-CS) on a mesh, on four gloo ranks on
the CPU (``tests/torch_mesh.spawn``), held to the JAX package's contract
and to the port's one-device run:

* the codec on a (1, 2, 2) (data, fsdp, model) grid: each rank's partial
  sketch of its shard, summed over the grid, equals the global encode of
  the whole delta within the chunked encode's rtol 1e-6 and atol 1e-6
  (``tests/test_packing.py``'s ``test_shard_local_codec_2d_grid``), and
  each rank's decode is its slice of the one-device decode bit for bit;
* the reference's 8-round smoke on that grid (``tests/test_shard_local.py``,
  ``SKETCHED_2D_SCENARIO_TRAIN_OK``): deep-fade truncation, the loss
  falling, truncated workers' sketch-space duals frozen, participation
  below 1;
* one round on the grid against one device: the loss, λ and each rank's
  Θ shard;
* a snapshot of the sketched state on the grid (Θ whole) restored into
  the ranks and resumed, bit for bit;
* ``REPRO_OPT=rs_grads`` against no flag: on the grid no rank sums a
  gradient, so no bit moves; on a (2, 2) (data, model) mesh the codec's
  fsdp dim rides the data axis, a worker's batch splits over it and the
  gathers' backward sums the gradient, by a reduce-scatter under the flag
  and by an all-reduce without, with equal bits; that round against one
  device within the split batch's rounding.

The expected values of the JAX round on a mesh are in
``tests/test_torch_shard_local.py``; the launcher's ``--mode sketched
--fsdp 2`` in ``tests/test_torch_launch.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.packing import (build_shard_packspec,  # noqa: E402
                                      shard_tree)
from repro_torch.core.sketch import encode_chunked  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.launch.shardings import shard_dims_2d  # noqa: E402
from repro_torch.train.llm_trainer import (SKETCH_SEED,  # noqa: E402
                                           _apply_packed)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOKENS = np.random.default_rng(3).integers(0, 128, (2, 2, 16))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sk")
    ck = tmp / "ck"
    ck.mkdir()
    return tm.spawn(tm.sketched_rank, 4, tmp, TOKENS, str(ck))


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec(shape, axes):
    """The codec's layout of reduced granite-8b (f32) on a mesh shape."""
    model = tm._f32_model("granite-8b")
    full = model.init(0, device="cpu")
    mesh = abstract_mesh(shape, axes)
    mdims, fdims = shard_dims_2d(full, model.cfg, mesh, multi_pod=False,
                                 worker_dim=False)
    fsdp = dict(zip(axes, shape)).get("fsdp",
                                      dict(zip(axes, shape))["data"])
    return build_shard_packspec(full, mdims, dict(zip(axes, shape))["model"],
                                fsdp_dims=fdims, n_fsdp=fsdp)


def test_grid_encode_equals_the_global_encode(ranks):
    codec = [r["codec"] for r in ranks]
    want = encode_chunked([_t(x) for x in tree_leaves(codec[0]["delta"])],
                          codec[0]["sketch"].shape[0], SKETCH_SEED)
    for c in codec:
        np.testing.assert_array_equal(c["sketch"], codec[0]["sketch"])
        np.testing.assert_allclose(c["sketch"], want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_grid_decode_is_its_slice_of_the_one_device_decode(ranks):
    codec = [r["codec"] for r in ranks]
    delta = tree_map(_t, codec[0]["delta"])
    one, sq = _apply_packed(tree_map(torch.zeros_like, delta),
                            _t(codec[0]["s"]), 1.0, True)
    sspec = _spec((1, 2, 2), ("data", "fsdp", "model"))
    assert {c["j"] for c in codec} == {0, 1, 2, 3}
    for c in codec:
        for g, w in zip(tree_leaves(c["decoded"]),
                        tree_leaves(shard_tree(sspec, one, c["j"]))):
            np.testing.assert_array_equal(g, w.numpy())
        # telemetry's ‖decode‖², each block counted once over the grid
        np.testing.assert_allclose(c["sq"], float(sq), rtol=1e-5)


def test_reference_scenario_smoke_trains_on_the_grid(ranks):
    for r in ranks:
        x = r["scenario"]
        assert x["lam_shape"] == (4, x["d_s"])
        assert all(np.isfinite(x["losses"])), x["losses"]
        assert x["losses"][-1] < x["losses"][0], x["losses"]
        assert min(x["participation"]) < 1.0, x["participation"]
    np.testing.assert_array_equal(ranks[0]["scenario"]["lam_re"],
                                  ranks[3]["scenario"]["lam_re"])


def test_reference_scenario_smoke_freezes_truncated_duals(ranks):
    for r in ranks:
        frozen = r["scenario"]["frozen"]
        assert frozen and all(frozen), frozen


def test_grid_round_equals_one_device(ranks):
    one = ranks[0]["one"]
    sspec = _spec((1, 2, 2), ("data", "fsdp", "model"))
    Theta = tree_map(_t, one["Theta"])
    for r in ranks:
        g = r["grid"][0]
        np.testing.assert_allclose(g["losses"], one["losses"], rtol=1e-6)
        np.testing.assert_allclose(g["lam_re"], one["lam_re"], rtol=0,
                                   atol=1e-6)
        for a, b in zip(tree_leaves(g["Theta"]),
                        tree_leaves(shard_tree(sspec, Theta, g["j"]))):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)


def _bit_equal(a, b):
    return (a["losses"] == b["losses"]
            and np.array_equal(a["lam_re"], b["lam_re"])
            and all(np.array_equal(x, y) for x, y in zip(
                tree_leaves(a["Theta"]), tree_leaves(b["Theta"]))))


def test_rs_grads_changes_no_bit_where_no_rank_sums_a_gradient(ranks):
    for r in ranks:
        plain, rs = r["grid"]
        assert _bit_equal(plain, rs)
        assert "reduce_scatter" not in rs["stats"]


def test_rs_grads_reduce_scatters_the_split_batch_with_equal_bits(ranks):
    for r in ranks:
        plain, rs = r["fsdp_data"]
        assert _bit_equal(plain, rs)
        assert "reduce_scatter" not in plain["stats"]
        assert rs["stats"]["reduce_scatter"]["calls"] > 0


def test_split_batch_round_is_one_devices_within_its_rounding(ranks):
    """Each rank's half of a worker's batch, the gradient summed over the
    data axis: the mean of two half-batch means against one device's mean,
    so the values agree to rounding, not to the bit."""
    one = ranks[0]["one"]
    sspec = _spec((2, 2), ("data", "model"))
    Theta = tree_map(_t, one["Theta"])
    for r in ranks:
        g = r["fsdp_data"][0]
        np.testing.assert_allclose(g["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(g["lam_re"], one["lam_re"], rtol=0,
                                   atol=1e-5)
        for a, b in zip(tree_leaves(g["Theta"]),
                        tree_leaves(shard_tree(sspec, Theta, g["j"]))):
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5)


def test_sketched_snapshot_restores_and_resumes_bit_for_bit(ranks):
    """``save_sharded`` writes Θ whole (the reference's global layout) and
    the (W, d_s) planes; each rank's restore is its state bit for bit, and
    a round from it equals the uninterrupted round."""
    for r in ranks:
        res = r["resume"]
        assert all(res["bits"]), res["bits"]
        assert res["step"] == 3
        assert res["shapes"]["Theta|embed|table"] == (512, 128)
        assert res["shapes"]["lam|re"][0] == 2
