"""The port's replicated mode on a mesh against its one-device run, port
against port, on gloo ranks on the CPU (``tests/torch_mesh.spawn``):

* a pure-data (2, 1) mesh draws one device's h (worker w's row of the
  packed plane from ``fold_in(kc, w)``, ``channel.rayleigh_rows``), so its
  rounds are one device's: reduced granite-8b (f32), noise-free, 3 rounds
  of 2 local steps across a redraw; every loss, α⁻¹, Θ, λ and h;
* cohort sampling on that mesh (a population of 4 split over the data
  ranks, 2 sampled a round, uniform and top-gain) against the one-device
  cohort run over 3 rounds, the unsampled rows keeping their bits;
* a truncating per-element scenario (``markov-doppler`` with a threshold)
  on the (1, 2) grid, whose RMS reads whole rows across the grid, against
  one device on its state and draws: the masks, participation, Θ and λ;
* the leafwise state (``packed_uplink=False``) on (2, 1) and (1, 2)
  against the packed state on the same θ, λ and h, one noise-free round.

The losses, Θ, λ and α⁻¹ are held to rtol 1e-6 (the reference's bar where
a psum regroups an f32 sum); h's rows and the masks to their bits.  On
the (1, 2) grid the forward partitions its products over the model axis
(``models/partition``), whose row-split sums regroup the products'
accumulation as the reference's partitioned program does: that state,
three rounds on, is held to the reference's own tight allclose for a
shard-local layout against another (``tests/test_shard_local.py``: rtol
1e-6, atol 1e-6).  Where
the runs happen to agree bit for bit, :func:`test_bits_recorded` says so.
One spawn of two ranks serves the file; rank 0 also runs the one-device
trainer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.tree import tree_leaves  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-6, atol=0.0)
#: the reference's bar for a shard-local layout against another
GRID_TOL = dict(rtol=1e-6, atol=1e-6)
ROUNDS = 3
PARTS = {
    "c1": ("data", (dict(), ROUNDS)),
    "cohort-uniform": ("data", (dict(population=4, cohort=2), ROUNDS)),
    "cohort-top-gain": ("data", (dict(population=4, cohort=2,
                                      cohort_policy="top-gain"), ROUNDS)),
    "leafwise-2x1": ("leafwise", ((2, 1), ("data", "model"))),
    "leafwise-1x2": ("leafwise", ((1, 2), ("data", "model"))),
    "truncation": ("truncation", (ROUNDS,)),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tm.spawn(tm.rounds_rank, 2, tmp_path_factory.mktemp("rounds"),
                    PARTS)


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(a, b, err_msg=msg, **tol)


def _against_one_device(ranks, name):
    """Each rank's rows of the run against rank 0's one-device run; True
    where every value is bit-equal."""
    one = ranks[0][name]["one"]
    bits = True
    for r in ranks:
        m, jd = r[name]["mesh"], r[name]["jd"]
        n = m["lam_re"].shape[0]
        rows = slice(jd * n, (jd + 1) * n)
        _close(m["losses"], one["losses"], msg="losses")
        _close(m["inv_alpha"], one["inv_alpha"], msg="inv_alpha")
        for a, b in zip(tree_leaves(m["Theta"]), tree_leaves(one["Theta"])):
            _close(a, b, msg="Theta")
            bits &= np.array_equal(a, b)
        for a, b in zip(tree_leaves(m["theta"]), tree_leaves(one["theta"])):
            _close(a, b[rows], msg="theta")
            bits &= np.array_equal(a, b[rows])
        for k in ("lam_re", "lam_im"):
            _close(m[k], one[k][rows], msg=k)
            bits &= np.array_equal(m[k], one[k][rows])
        # the draw: the rank's rows of one device's plane, bit for bit
        np.testing.assert_array_equal(m["h_re"], one["h_re"][rows])
        np.testing.assert_array_equal(m["h_im"], one["h_im"][rows])
        bits &= m["losses"] == one["losses"]
        bits &= m["inv_alpha"] == one["inv_alpha"]
    return bits


def test_pure_data_mesh_computes_one_devices_rounds(ranks):
    _against_one_device(ranks, "c1")


@pytest.mark.parametrize("policy", ["uniform", "top-gain"])
def test_cohort_on_a_pure_data_mesh_is_one_devices(ranks, policy):
    _against_one_device(ranks, f"cohort-{policy}")


def test_cohort_unsampled_rows_keep_their_bits(ranks):
    for r in ranks:
        kept = r["cohort-uniform"]["mesh"]["kept"]
        assert kept == [True] * ROUNDS, kept


def test_bits_recorded(ranks):
    """On the CPU each rank's one-worker products, its gathered cohort rows
    and the psum of two rows add in one device's order: the pure-data runs
    are one device's bit for bit (the tests above hold them to rtol
    1e-6)."""
    for name in ("c1", "cohort-uniform", "cohort-top-gain"):
        assert _against_one_device(ranks, name), name


def test_grid_truncation_masks_equal_one_devices(ranks):
    for r in ranks:
        x = r["truncation"]
        assert x["init_masks"][0] == x["init_masks"][1]
        assert x["mask_m"] == x["mask_1"]
        assert x["part_m"] == x["part_1"]
        # two of four start truncated, so the RMS decides
        assert 0.0 < min(x["part_1"]) < 1.0


def test_grid_truncation_state_equals_one_devices(ranks):
    for r in ranks:
        x = r["truncation"]
        _close(x["loss_m"], x["loss_1"], GRID_TOL, msg="loss")
        for a, b in zip(tree_leaves(x["Theta_m"]), tree_leaves(x["Theta_1"])):
            _close(a, b, GRID_TOL, msg="Theta")
        for a, b in zip(x["lam_m"], x["lam_1"]):
            _close(a, b, GRID_TOL, msg="lam")


@pytest.mark.parametrize("grid", ["2x1", "1x2"])
def test_leafwise_state_on_a_mesh_equals_packed(ranks, grid):
    for r in ranks:
        x = r[f"leafwise-{grid}"]
        assert x["theta_equal"]
        assert x["loss"][0] == x["loss"][1]
        _close(x["inv_alpha"][1], x["inv_alpha"][0], msg="inv_alpha")
        for a, b in zip(tree_leaves(x["Theta_l"]), tree_leaves(x["Theta_p"])):
            _close(a, b, msg="Theta")
        for a, b in zip(x["lam_l"], x["lam_p"]):
            _close(a, b, msg="lam")
