"""The port's checkpoints (``repro_torch.checkpoint``) and block driver
(``train.fl_trainer``: ``train_scan``, ``resume_state``, ``train_loop``,
``train(driver=…)``).

Against JAX: the four unit cases of ``tests/test_checkpoint_resume.py`` on
the port's ``save``/``restore``; a ``.npz`` that JAX's ``save`` writes from
a JAX ``AFadmmState`` (plain, under a scenario, under a fault plan) or an
LLM ``TreeFLState`` restores into the port's state equal to
``convert``'s state of the same leaves, and the port's ``save`` of that
state writes JAX's file again, key for key and bit for bit.  Port against
port, as the reference pins within JAX: the scan and loop drivers give equal
histories bit for bit, and a faulted, guarded run killed at round 37 (not a
block boundary) and resumed equals the uninterrupted 60-round run in its
final ``.npz`` and its loss trace; an empty directory is a fresh start."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.core import make as jmake  # noqa: E402
from repro.phy import make_scenario as jscenario  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (latest_round, restore,  # noqa: E402
                                    round_path, save)
from repro_torch.checkpoint.np_checkpoint import _walk  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.aggregators import make  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.subcarrier import SubcarrierPlan  # noqa: E402
from repro_torch.faults import FaultPlan, GuardConfig  # noqa: E402
from repro_torch.optim.local_solvers import exact_quadratic_solver  # noqa: E402
from repro_torch.phy import make_scenario  # noqa: E402
from repro_torch.train.fl_trainer import (resume_state, train,  # noqa: E402
                                          train_scan)

from helpers import default_cfgs  # noqa: E402
from test_torch_faults import fault_to_numpy  # noqa: E402
from test_torch_scenario import afadmm_to_numpy  # noqa: E402

KEY = jax.random.PRNGKey(0)


# ---------------------------------------------------------------------------
# the reference's four unit cases, on the port's save/restore
# ---------------------------------------------------------------------------

def test_round_path_and_latest_round(tmp_path):
    d = str(tmp_path)
    assert latest_round(d) is None
    assert latest_round(os.path.join(d, "nope")) is None  # missing dir
    assert round_path(d, 7).endswith("round_00000007.npz")
    for r in (2, 40, 7):
        save(round_path(d, r), {"x": torch.zeros(3)})
    assert latest_round(d) == 40
    names = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert names == ["round_00000002.npz", "round_00000007.npz",
                     "round_00000040.npz"]


def test_bf16_roundtrip_is_lossless(tmp_path):
    """bf16 is saved as f32 and cast back on restore: exact, since bf16 ->
    f32 is an embedding.  Host scalars come back as host values."""
    path = str(tmp_path / "ck.npz")
    tree = {"w": (torch.arange(37, dtype=torch.bfloat16) - 11.0) / 3.0,
            "b": torch.tensor(1.5),
            "n": torch.arange(4, dtype=torch.int32),
            "m": torch.tensor([True, False]), "step": 7, "flag": True}
    save(path, tree)
    with np.load(path) as z:
        assert z["w"].dtype == np.float32 and z["step"].dtype == np.int32
    like = {k: torch.zeros_like(v) if torch.is_tensor(v) else type(v)()
            for k, v in tree.items()}
    out = restore(path, like)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].float(), tree["w"].float())
    for k in ("b", "n", "m"):
        assert out[k].dtype == tree[k].dtype and torch.equal(out[k], tree[k])
    assert out["step"] == 7 and out["flag"] is True


def test_restore_shape_mismatch_names_leaf(tmp_path):
    path = str(tmp_path / "ck.npz")
    save(path, {"opt": {"mu": torch.zeros(3)}})
    with pytest.raises(ValueError, match=r"opt\|mu"):
        restore(path, {"opt": {"mu": torch.zeros(4)}})


def test_restore_missing_leaf_names_leaf(tmp_path):
    path = str(tmp_path / "ck.npz")
    save(path, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="extra"):
        restore(path, {"a": torch.zeros(2), "extra": torch.zeros(1)})


# ---------------------------------------------------------------------------
# a JAX-written checkpoint restores into the port
# ---------------------------------------------------------------------------

def _assert_trees_equal(a, b):
    """Same leaf paths, types, dtypes and bits."""
    la, lb = list(_walk(a)), list(_walk(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), p
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert torch.equal(x, y), p
        else:
            assert x == y, p


def _assert_npz_equal(pa, pb):
    with np.load(pa) as za, np.load(pb) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


_AFADMM_CASES = {
    "plain": ({}, {}),
    "scenario": (dict(scenario="markov-doppler"), {}),
    "faults": ({}, dict(straggler_prob=0.3, crash_at=((2, 1),))),
}


@pytest.mark.parametrize("case", list(_AFADMM_CASES))
def test_jax_afadmm_checkpoint_restores_into_the_port(case, tmp_path):
    W, d = 4, 6
    scn, fp = _AFADMM_CASES[case]
    acfg_j, ccfg_j, plan_j = default_cfgs(W, d, noisy=True)
    kw_j, kw = {}, {}
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=d, noisy=True)
    if scn:
        kw_j["scenario"] = jscenario(scn["scenario"], ccfg_j, csi_err=0.1)
        kw["scenario"] = make_scenario(scn["scenario"], ccfg, csi_err=0.1)
    if fp:
        kw_j["faults"] = jfaults.FaultPlan(**fp)
        kw["faults"] = FaultPlan(**fp)
    alg_j = jmake("afadmm", acfg_j, ccfg_j, plan_j, **kw_j)
    theta0 = jax.random.normal(KEY, (W, d))
    st_j = alg_j.init(KEY, theta0)
    # a few rounds, so the channel's age and the fault state move
    from helpers import make_linreg, make_solver
    prob = make_linreg(KEY, W=W, d=d)
    solver = make_solver(prob, 0.5)
    for r in range(2):
        st_j, _ = alg_j.round(jax.random.fold_in(KEY, r + 1), st_j, solver,
                              prob["grad_fn"])
    jpath = str(tmp_path / "jax.npz")
    jsave(jpath, st_j)

    alg = make("afadmm", AdmmConfig(), ccfg, SubcarrierPlan.build(d, d), **kw)
    like = alg.init(0, torch.zeros(W, d))
    got = restore(jpath, like)
    leaves = afadmm_to_numpy(st_j)
    if st_j.flt is not None:
        leaves["flt"] = fault_to_numpy(st_j.flt)
    _assert_trees_equal(got, convert.afadmm_state_from_numpy(leaves,
                                                             device="cpu"))
    # the port writes JAX's file back: the same keys, dtypes and bits
    ppath = str(tmp_path / "port.npz")
    save(ppath, got)
    _assert_npz_equal(jpath, ppath)


def test_jax_llm_checkpoint_restores_into_the_port(tmp_path):
    """The LLM trainer's packed state under a scenario and a fault plan,
    sgd's optimizer state included."""
    from repro.core.admm import AdmmConfig as JAdmm
    from repro.core.channel import ChannelConfig as JChan
    from repro.models import get_model as jget
    from repro.train.llm_trainer import FLConfig as JFL
    from repro.train.llm_trainer import make_fl_train as jmake_fl

    from repro_torch.models import get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train
    from torch_replay import llm_state

    fl = dict(n_workers=2, scenario="markov-doppler", csi_err=0.1)
    init_j, _ = jmake_fl(jget("granite-8b", reduced=True),
                         JFL(faults=jfaults.FaultPlan(straggler_prob=0.3),
                             **fl), JAdmm(), JChan(n_workers=2))
    # jitted: the same draws as the eager init, in a third of its time
    st_j = jax.jit(init_j)(KEY)
    jpath = str(tmp_path / "jax.npz")
    jsave(jpath, st_j)
    init, _ = make_fl_train(get_model("granite-8b", reduced=True),
                            FLConfig(faults=FaultPlan(straggler_prob=0.3),
                                     **fl), AdmmConfig(),
                            ChannelConfig(n_workers=2), device="cpu")
    got = restore(jpath, init(0))
    want = llm_state(st_j)
    # sgd's nu is a leaf of its own in JAX's file, restored as its own tree
    want = want._replace(opt=want.opt._replace(
        nu=convert.model_params_from_numpy(
            jax.tree.map(np.asarray, st_j.opt.nu), device="cpu")))
    _assert_trees_equal(got, want)
    ppath = str(tmp_path / "port.npz")
    save(ppath, got)
    _assert_npz_equal(jpath, ppath)


# ---------------------------------------------------------------------------
# the block driver: drivers agree, kill-and-resume is bitwise
# ---------------------------------------------------------------------------

W, D, ROUNDS, KILL = 8, 6, 60, 37


def _faulted_run():
    """A faulted, guarded, telemetered linreg A-FADMM on the port: its
    algorithm, θ0, solver, gradient and evaluator (data from numpy)."""
    rs = np.random.default_rng(0)
    X = torch.from_numpy(rs.standard_normal((W, 64, D)).astype(np.float32)
                         / 8.0)
    y = torch.from_numpy(rs.standard_normal((W, 64)).astype(np.float32))
    theta0 = torch.from_numpy(rs.standard_normal((W, D)).astype(np.float32))
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=D, coherence_iters=10,
                         snr_db=30.0, noisy=True)
    fp = FaultPlan(crash_at=((20, 2),), straggler_prob=0.2,
                   straggler_delay=4, nan_workers=1, burst_prob=0.1,
                   burst_std=5.0)
    gc = GuardConfig(policy="evict-retransmit", snr_floor_db=-20.0)
    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False,
                                    power_control=True), ccfg,
               SubcarrierPlan.build(D, D), faults=fp, guard=gc,
               telemetry=True)

    def grad_fn(th):
        r = torch.einsum("wmd,wd->wm", X, th) - y
        return 2.0 * torch.einsum("wmd,wm->wd", X, r)

    Xf, yf = X.reshape(-1, D), y.reshape(-1)
    eval_fn = lambda T: {"loss": torch.sum((yf - Xf @ T) ** 2)}  # noqa: E731
    return alg, theta0, exact_quadratic_solver(X, y, 0.5), grad_fn, eval_fn


def test_scan_and_loop_drivers_give_equal_histories():
    alg, theta0, solver, grad_fn, eval_fn = _faulted_run()
    hs = train(alg, theta0, solver, grad_fn, 23, 0, eval_fn, eval_every=5,
               driver="scan")
    hl = train(alg, theta0, solver, grad_fn, 23, 0, eval_fn, eval_every=5,
               driver="loop")
    assert hs.loss == hl.loss and len(hs.loss) == 6
    assert hs.channel_uses == hl.channel_uses
    assert hs.extra == hl.extra          # obs/tx_energy rows included
    assert all(len(row) == W for row in hs.extra["obs/tx_energy"])
    assert sum(hs.extra["guard/evicted"]) >= 1
    with pytest.raises(ValueError, match="driver"):
        train(alg, theta0, solver, grad_fn, 2, 0, driver="nope")


def test_scan_resume_bitwise_at_non_block_aligned_round(tmp_path):
    """60 faulted rounds, killed at round 37 (the coherence blocks are 10
    rounds, so 37 is not a boundary of the uninterrupted run), resumed:
    the final checkpoint and the loss trace are the uninterrupted run's."""
    alg, theta0, solver, grad_fn, eval_fn = _faulted_run()
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    hist_a = train_scan(alg, theta0, solver, grad_fn, ROUNDS, 0, eval_fn,
                        eval_every=6, checkpoint_dir=da,
                        checkpoint_every=ROUNDS)
    train_scan(alg, theta0, solver, grad_fn, KILL, 0, eval_fn, eval_every=6,
               checkpoint_dir=db, checkpoint_every=10 ** 9)
    st, r0 = resume_state(alg, theta0, 0, db)
    assert r0 == KILL
    hist_b = train(alg, theta0, solver, grad_fn, ROUNDS, 0, eval_fn,
                   eval_every=6, checkpoint_dir=db,
                   checkpoint_every=10 ** 9, resume=True)
    _assert_npz_equal(round_path(da, ROUNDS), round_path(db, ROUNDS))
    # the shared eval rounds 42, 48, 54, 59
    assert len(hist_b.loss) == 4
    assert hist_b.loss == hist_a.loss[-4:]
    n = ROUNDS - KILL
    assert hist_b.extra["obs/rx_snr_db"] == hist_a.extra["obs/rx_snr_db"][-n:]
    assert not bool(st.flt.alive[2])     # the crash survived the restore


def test_resume_state_empty_dir_is_fresh_start(tmp_path):
    alg, theta0, solver, grad_fn, _ = _faulted_run()
    st, r0 = resume_state(alg, theta0, 0, str(tmp_path))
    assert st is None and r0 == 0
    hist = train(alg, theta0, solver, grad_fn, 3, 0,
                 checkpoint_dir=str(tmp_path / "none"), checkpoint_every=1,
                 resume=True)
    assert len(hist.channel_uses) == 3
    assert latest_round(str(tmp_path / "none")) == 3
