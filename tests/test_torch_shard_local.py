"""The port's shard-local round and replicated trainer on a mesh of gloo
ranks on the CPU (``launch.mesh``, ``core.tree_ota
.ota_tree_round_shard_local``, ``train.llm_trainer.make_fl_train(mesh=)``,
``checkpoint.save_sharded``/``restore_sharded``), held to the JAX
package's contract (``tests/test_shard_local.py``, the shard-local case of
``tests/test_checkpoint_resume.py``):

* on (1, 2), noise-free, the fused and the composed rounds' Θ and λ are
  bit-equal to the port's leafwise round's, plain, with power control,
  masked and masked with CSI (α⁻¹ to rtol 1e-6: its energies sum in
  another order); one receive a shard a round; λ unpacks shard-locally;
* on (2, 2) (the data-split branch) and (1, 2, 2) (the 2-D grid) within
  the reference's allclose;
* a noisy guarded round (a NaN worker evicted, a burst on the first
  attempt, a retry, telemetry) against JAX's ``ota_tree_round_shard_local``
  on the same θ, λ, h and per-shard draws;
* reduced granite-8b, 3 trainer rounds on (1, 2) against JAX's
  ``make_fl_train(mesh=...)`` on its draws, one falcon-mamba-7b round, a
  JAX-written (1, 2) snapshot restored into the ranks and replayed on;
* the reference's scenario smoke on the grid: deep-fade truncation for 8
  rounds, the loss falling, truncated workers' λ rows frozen;
* the shard-local kill-and-resume, port against port, bit for bit, under
  the reference's markov-doppler, faults and guard;
* one round of the sketched mode on (1, 2) (reduced granite-8b, f32)
  against JAX's ``make_sketched(mesh=...)`` on its state and noise.

Expected values come from one JAX subprocess with four host devices,
shared by the file; the port's ranks run in two spawns (``torch_mesh``).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.packing import (build_shard_packspec,  # noqa: E402
                                      shard_tree, unpack_shard_global)
from repro_torch.core.tree_ota import ota_tree_round_leafwise  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.launch.shardings import shard_dims_2d  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

import torch_mesh as tm  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.checkpoint import save
from repro.core import cplx, transport
from repro.core.admm import AdmmConfig
from repro.core.channel import ChannelConfig, rayleigh
from repro.core.packing import (build_shard_packspec, pack_shard_global_cplx,
                                unpack_shard_global_cplx)
from repro.core.tree_ota import ota_tree_round_shard_local
from repro.faults import GuardConfig, guards as fg, plan as fp
from repro.models import registry as reg
from repro.models.sharding import axis_rules
from repro.train.llm_trainer import FLConfig, make_fl_train

assert jax.device_count() == 4, jax.devices()
out_dir = sys.argv[1]
KEY = jax.random.PRNGKey(0)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                         ("data", "model"))
res = {}
np_ = lambda tree: jax.tree.map(np.asarray, tree)

# --- a noisy guarded round: worker 1 NaN (evicted), a burst on attempt 0
W = 3
mk = lambda s, sh: jax.random.normal(jax.random.fold_in(KEY, s), sh)
theta = {"wq": mk(1, (W, 4, 8)), "wo": mk(2, (W, 8, 4)),
         "norm": mk(3, (W, 4)), "b": mk(4, (W,))}
theta["wq"] = theta["wq"].at[1, 0, 0].set(jnp.nan)
lam = jax.tree.map(lambda l: cplx.Complex(0.3 * mk(5, l.shape),
                                          0.3 * mk(6, l.shape)), theta)
h = jax.tree.map(lambda l: rayleigh(jax.random.fold_in(KEY, 7), l.shape),
                 theta)
Theta_prev = jax.tree.map(lambda l: 0.5 * jnp.ones(l.shape[1:]), theta)
ss = build_shard_packspec(theta, [None, None, 0, 1], 2, batch_dims=1)
ccfg = ChannelConfig(n_workers=W, snr_db=20.0)
acfg = AdmmConfig(rho=0.5, flip_on_change=False)
gcfg = GuardConfig(policy="evict-retransmit", snr_floor_db=0.0,
                   max_retries=2)
BURST = 50.0
plan = fp.FaultPlan(burst_prob=1.0, burst_std=BURST)
rf = fp.RoundFaults(alive=jnp.ones(W, bool), straggler=None, corrupt=None,
                    snapshot_due=None, burst_std=jnp.float32(BURST))
kround = jax.random.fold_in(KEY, 99)
with mesh:
    T, l_p, m = jax.jit(lambda t, lp, hp, k, Tp: ota_tree_round_shard_local(
        t, lp, hp, k, acfg, ccfg, ss, mesh, backend="jnp",
        Theta_prev=Tp, guard=gcfg, faults=(plan, rf, None),
        telemetry=True))(theta, pack_shard_global_cplx(ss, lam),
                         pack_shard_global_cplx(ss, h), kround, Theta_prev)
noise, burst, retry = [], [], []
for j in range(2):
    nk = jax.random.fold_in(kround, j)
    noise.append(np.asarray(transport.matched_filter_noise_re(
        nk, (ss.d_local,), ccfg)))
    burst.append(np.asarray(jax.random.normal(
        jax.random.fold_in(nk, fg.BURST_SALT), (ss.d_local,), jnp.float32)))
    retry.append([np.asarray(transport.matched_filter_noise_re(
        jax.random.fold_in(nk, fg.RETRY_SALT + a), (ss.d_local,), ccfg))
        for a in range(1, gcfg.max_retries + 1)])
aux = m.pop("_fault_aux")
res["guarded"] = dict(
    theta=np_(theta),
    lam={k: (np.asarray(c.re), np.asarray(c.im)) for k, c in lam.items()},
    h={k: (np.asarray(c.re), np.asarray(c.im)) for k, c in h.items()},
    Theta_prev=np_(Theta_prev), noise=noise, burst=burst, retry=retry,
    burst_std=BURST, Theta=np_(T), lam_re=np.asarray(l_p.re),
    lam_im=np.asarray(l_p.im), metrics=np_(m),
    evicted=np.asarray(aux["evicted"]))

# --- the trainer on the (1, 2) mesh: reduced granite-8b 3 rounds (a
# snapshot after round 1), reduced falcon-mamba-7b 1 round, f32
def trainer(arch, rounds, snap=None):
    cfg = dataclasses.replace(reg.get_config(arch).reduced(),
                              param_dtype="float32")
    Wt = 2
    flcfg = FLConfig(mode="replicated", n_workers=Wt, local_steps=1,
                     local_lr=1e-2)
    cc = ChannelConfig(n_workers=Wt, snr_db=40.0, coherence_iters=10)
    init_fn, step = make_fl_train(reg.build_model(cfg), flcfg,
                                  AdmmConfig(rho=0.5, flip_on_change=False),
                                  cc, mesh=mesh)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (Wt, 2, 16),
                                               dtype=np.int32)
    st = init_fn(KEY)
    d_local = st.lam.re.shape[1] // 2

    def state(st):
        return dict(theta=np_(st.theta), Theta=np_(st.Theta),
                    lam_re=np.asarray(st.lam.re), lam_im=np.asarray(st.lam.im),
                    h_re=np.asarray(st.chan.h.re),
                    h_im=np.asarray(st.chan.h.im), age=int(st.chan.age),
                    step=int(st.step),
                    opt={"mu": np_(st.opt.mu), "nu": None,
                         "count": int(st.opt.count)})

    out = dict(arch=arch, tokens=tokens, state=state(st), noise=[],
               losses=[])
    with mesh, axis_rules(mesh):
        jstep = jax.jit(step)
        for r in range(rounds):
            key = jax.random.fold_in(KEY, r)
            kc, kn = jax.random.split(key)
            out["noise"].append([np.asarray(transport.matched_filter_noise_re(
                jax.random.fold_in(kn, j), (d_local,), cc)) for j in range(2)])
            st, met = jstep(st, {"tokens": jnp.asarray(tokens)}, key)
            out["losses"].append(float(met["loss"]))
            if snap is not None and r + 1 == snap:
                path = f"{out_dir}/{arch}_round{snap}.npz"
                save(path, st)
                out.update(snapshot=path, snap_round=snap,
                           snap_state=state(st))
    out["final"] = dict(Theta=np_(st.Theta), lam_re=np.asarray(st.lam.re),
                        lam_im=np.asarray(st.lam.im))
    return out

res["granite"] = trainer("granite-8b", 3, snap=1)
res["falcon"] = trainer("falcon-mamba-7b", 1)

# --- one sketched round on the (1, 2) mesh: reduced granite-8b in f32, its
# round key's uplink noise kept for the port's replay
def sketched():
    cfg = dataclasses.replace(reg.get_config("granite-8b").reduced(),
                              param_dtype="float32")
    Wt = 2
    cc = ChannelConfig(n_workers=Wt, snr_db=40.0, coherence_iters=10)
    flcfg = FLConfig(mode="sketched", n_workers=Wt, local_steps=1,
                     local_lr=1e-2, sketch_ratio=16, sketch_lr=0.7)
    init_fn, step = make_fl_train(reg.build_model(cfg), flcfg,
                                  AdmmConfig(rho=0.5, flip_on_change=False),
                                  cc, mesh=mesh)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (Wt, 2, 16),
                                               dtype=np.int32)
    st = init_fn(KEY)
    key = jax.random.fold_in(KEY, 5)
    _, kn = jax.random.split(key)
    d_s = st.lam.re.shape[-1]
    out = dict(tokens=tokens, Theta0=np_(st.Theta),
               lam=(np.asarray(st.lam.re), np.asarray(st.lam.im)),
               h=(np.asarray(st.chan.h.re), np.asarray(st.chan.h.im)),
               age=int(st.chan.age),
               noise=np.asarray(transport.matched_filter_noise_re(
                   kn, (d_s,), cc)))
    with mesh, axis_rules(mesh):
        st, met = jax.jit(step)(st, {"tokens": jnp.asarray(tokens)}, key)
    out.update(loss=float(met["loss"]), Theta=np_(st.Theta),
               lam_re=np.asarray(st.lam.re))
    return out

res["sketched"] = sketched()
with open(f"{out_dir}/jax.pkl", "wb") as f:
    pickle.dump(res, f)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's expected values, from one subprocess with four
    host devices (the tier-1 process pins one)."""
    out = tmp_path_factory.mktemp("jax_shard_local")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4"
                          ).strip())
    proc = subprocess.run([sys.executable, "-c", _JAX, str(out)], env=env,
                          capture_output=True, text=True, timeout=400,
                          cwd=REPO)
    assert "JAX_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out / "jax.pkl", "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# the toy tree of the reference's parity contract
# ---------------------------------------------------------------------------

def _toy(W, seed):
    r = np.random.default_rng(seed)
    theta = {"wq": r.standard_normal((W, 4, 8)), "wo": r.standard_normal(
        (W, 8, 4)), "norm": r.standard_normal((W, 4)),
        "b": r.standard_normal((W,))}
    theta = {k: v.astype(np.float32) for k, v in theta.items()}

    def planes(scale):
        return {k: ((scale * r.standard_normal(v.shape)).astype(np.float32),
                    (scale * r.standard_normal(v.shape)).astype(np.float32))
                for k, v in theta.items()}

    lam, h = planes(0.3), planes(0.7)
    h_tx = {k: (re + 0.1, im - 0.05) for k, (re, im) in h.items()}
    return dict(theta=theta, lam=lam, h=h, h_tx=h_tx,
                mdims=[None, None, 0, 1])


MASK3 = np.array([True, False, True])
RUNS_12 = [dict(power_control=pc, fused=fz, mask=m, use_h_tx=csi)
           for fz in (None, False)
           for pc, m, csi in ((False, None, False), (True, None, False),
                              (True, MASK3, False), (True, MASK3, True))]
LABELS_12 = [f"{'fused' if r['fused'] is None else 'composed'}-"
             f"{['plain', 'pc', 'masked', 'masked+csi'][i % 4]}"
             for i, r in enumerate(RUNS_12)]
MASK4 = np.array([True, False, True, True])
RUNS_22 = [dict(power_control=True), dict(power_control=True, mask=MASK4),
           dict(power_control=False)]
RUNS_122 = [dict(power_control=False), dict(power_control=True),
            dict(power_control=True, mask=MASK3)]


def _case_12():
    return dict(_toy(3, 0), shape=(1, 2), axes=("data", "model"))


def _case_22():
    return dict(_toy(4, 1), shape=(2, 2), axes=("data", "model"))


def _case_122():
    r = np.random.default_rng(2)
    theta = {"wq": (3, 4, 8), "wo": (3, 8, 4), "gate": (3, 6, 2),
             "b": (3, 3)}
    theta = {k: r.standard_normal(s).astype(np.float32)
             for k, s in theta.items()}

    def planes(scale):
        return {k: ((scale * r.standard_normal(v.shape)).astype(np.float32),
                    (scale * r.standard_normal(v.shape)).astype(np.float32))
                for k, v in theta.items()}

    return dict(theta=theta, lam=planes(0.3), h=planes(0.7),
                mdims=[None, None, 0, 1], fdims=[None, 0, None, 0],
                shape=(1, 2, 2), axes=("data", "fsdp", "model"))


@pytest.fixture(scope="module")
def spawn_a(tmp_path_factory, jax_ref):
    """One spawn of two ranks on (1, 2) running every (1, 2) part."""
    tmp = tmp_path_factory.mktemp("spawn_a")
    ck = tmp / "ck"
    ck.mkdir()
    toy = _case_12()
    guarded = dict(jax_ref["guarded"], mdims=[None, None, 0, 1],
                   shape=(1, 2), axes=("data", "model"))
    parts = {"round": ("round", (toy, RUNS_12)),
             "checks": ("checks", (toy, RUNS_12)),
             "guarded": ("guarded", (guarded,)),
             "granite": ("replay", (jax_ref["granite"],)),
             "falcon": ("replay", (jax_ref["falcon"],)),
             "resume": ("resume", (str(ck),)),
             "scenario": ("scenario", ()),
             "sketched": ("sketched", (jax_ref["sketched"],))}
    return tm.spawn(tm.suite_rank, 2, tmp, parts, str(ck))


@pytest.fixture(scope="module")
def spawn_b(tmp_path_factory):
    """One spawn of four ranks: the (2, 2) and (1, 2, 2) parity runs."""
    return tm.spawn(tm.grid_rank, 4, tmp_path_factory.mktemp("spawn_b"),
                    [(_case_22(), RUNS_22), (_case_122(), RUNS_122)])


def _leafwise(case, run):
    """The port's leafwise round on the case's global tree."""
    tt = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    theta = {k: tt(v) for k, v in case["theta"].items()}
    ctree = lambda d: {k: Complex(tt(re), tt(im))  # noqa: E731
                       for k, (re, im) in d.items()}
    W = next(iter(theta.values())).shape[0]
    mask = run.get("mask")
    return ota_tree_round_leafwise(
        theta, ctree(case["lam"]), ctree(case["h"]),
        [torch.zeros(v.shape[1:]) for _, v in sorted(theta.items())],
        AdmmConfig(rho=0.5, power_control=run["power_control"],
                   flip_on_change=False),
        ChannelConfig(n_workers=W, noisy=False),
        mask=None if mask is None else tt(mask),
        h_tx=ctree(case["h_tx"]) if run.get("use_h_tx") else None)


def _spec(case):
    theta = {k: torch.from_numpy(np.array(v))
             for k, v in case["theta"].items()}
    return build_shard_packspec(
        theta, case["mdims"], dict(zip(case["axes"], case["shape"])).get(
            "model", 1), batch_dims=1, fsdp_dims=case.get("fdims"),
        n_fsdp=dict(zip(case["axes"], case["shape"])).get("fsdp", 1))


def _assemble(case, ranks, get):
    """The global Θ tree and λ planes from every rank's pieces
    (``get(rank) -> {"Theta", "lam_re", "lam_im"}``)."""
    ss = _spec(case)
    names = sorted(case["theta"])
    nm, nf = ss.n_model, ss.n_fsdp
    Theta = {}
    for i, n in enumerate(names):
        pieces = {(r["jd"], r["jm"], r["jf"]): get(r)["Theta"][n]
                  for r in ranks}
        fd = ss.fsdp_dims[i]
        Theta[n] = tm.place(case["theta"][n].shape[1:], pieces,
                            ss.shard_dims[i], fd, nm, nf, worker_dim=False)
    W = case["theta"][names[0]].shape[0]
    lam = {}
    for part in ("re", "im"):
        g = np.zeros((W, ss.d_pad), np.float32)
        for r in ranks:
            blk = get(r)[f"lam_{part}"]
            g[r["jd"] * blk.shape[0]:(r["jd"] + 1) * blk.shape[0],
              r["j"] * ss.d_local:(r["j"] + 1) * ss.d_local] = blk
        lam[part] = unpack_shard_global(ss, torch.from_numpy(g), cast=False)
    return Theta, lam, ss


def _check_round(case, ranks, run, i, tol):
    Theta, lam, _ = _assemble(case, ranks, lambda r: r["runs"][i])
    T_l, l_l, m_l = _leafwise(case, run)
    cmp = (np.testing.assert_array_equal if tol is None else
           lambda a, b, **kw: np.testing.assert_allclose(a, b, **tol, **kw))
    for n in case["theta"]:
        cmp(Theta[n], T_l[n].numpy(), err_msg=f"Theta[{n}]")
        cmp(lam["re"][n].numpy(), l_l[n].re.numpy(), err_msg=f"lam.re[{n}]")
        cmp(lam["im"][n].numpy(), l_l[n].im.numpy(), err_msg=f"lam.im[{n}]")
    # α⁻¹ sums each worker's energy per shard and then over the grid, the
    # leafwise round per leaf: the same terms in another order, so it is
    # held to rtol 1e-6 (Θ and λ do not read it on a noise-free link)
    for r in ranks:
        np.testing.assert_allclose(float(r["runs"][i]["inv_alpha"]),
                                   float(m_l["inv_alpha"]), rtol=1e-6)


@pytest.mark.parametrize("i", range(len(RUNS_12)), ids=LABELS_12)
def test_one_by_two_bit_equal_to_leafwise(spawn_a, i):
    _check_round(_case_12(), [r["round"] for r in spawn_a], RUNS_12[i], i,
                 None)


def test_unpack_shard_local_and_one_receive_per_shard(spawn_a):
    for r in spawn_a:
        assert r["checks"]["unpack_ok"]
        assert r["checks"]["calls"] == [{"receive": 0, "stats": 1},
                                        {"receive": 1, "stats": 0}]


@pytest.mark.parametrize("i", range(len(RUNS_22)),
                         ids=["pc", "masked", "plain"])
def test_data_split_within_allclose(spawn_b, i):
    _check_round(_case_22(), [r[0] for r in spawn_b], RUNS_22[i], i,
                 dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("i", range(len(RUNS_122)),
                         ids=["plain", "pc", "masked"])
def test_2d_grid_within_allclose(spawn_b, i):
    _check_round(_case_122(), [r[1] for r in spawn_b], RUNS_122[i], i,
                 dict(rtol=1e-6, atol=1e-7))


def test_guarded_noisy_round_matches_jax(spawn_a, jax_ref):
    want = jax_ref["guarded"]
    case = dict(want, mdims=[None, None, 0, 1], shape=(1, 2),
                axes=("data", "model"))
    ranks = [r["guarded"] for r in spawn_a]
    Theta, lam, ss = _assemble(case, ranks, lambda r: r)
    tol = dict(rtol=1e-5, atol=1e-5)
    for n in want["theta"]:
        np.testing.assert_allclose(Theta[n], want["Theta"][n], **tol,
                                   err_msg=f"Theta[{n}]")
    got_re = np.concatenate([r["lam_re"] for r in sorted(
        ranks, key=lambda r: r["j"])], axis=1)
    np.testing.assert_allclose(got_re, want["lam_re"], **tol)
    np.testing.assert_array_equal(ranks[0]["evicted"], want["evicted"])
    assert want["evicted"].tolist() == [False, True, False]
    m, wm = ranks[0]["metrics"], want["metrics"]
    assert sorted(m) == sorted(wm)
    assert float(m["guard/retries"]) == float(wm["guard/retries"]) == 1.0
    assert float(m["guard/healthy"]) == float(wm["guard/healthy"]) == 1.0
    for k in wm:
        np.testing.assert_allclose(np.asarray(m[k], np.float64),
                                   np.asarray(wm[k], np.float64),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _replay_check(ranks, want):
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-4)
    # the final Θ, reassembled, and λ's blocks against JAX's global planes
    d_local = ranks[0]["lam_re"].shape[1]
    for r in ranks:
        cols = slice(r["j"] * d_local, (r["j"] + 1) * d_local)
        np.testing.assert_allclose(r["lam_re"], want["final"]["lam_re"][
            :, cols], rtol=1e-3, atol=1e-3)


def test_trainer_replays_jax_granite(spawn_a, jax_ref):
    _replay_check([r["granite"] for r in spawn_a], jax_ref["granite"])


def test_trainer_replays_jax_falcon(spawn_a, jax_ref):
    _replay_check([r["falcon"] for r in spawn_a], jax_ref["falcon"])


def test_jax_snapshot_restores_into_ranks(spawn_a, jax_ref):
    want = jax_ref["granite"]
    for r in spawn_a:
        g = r["granite"]
        assert g["snapshot_bits"]
        np.testing.assert_allclose(g["losses_restored"],
                                   want["losses"][want["snap_round"]:],
                                   rtol=1e-4)


def test_shard_local_kill_and_resume_bit_equal(spawn_a):
    for r in spawn_a:
        res = r["resume"]
        assert all(res["bits"]), res["bits"]
        assert not res["alive"][1]       # the crash survives the resume
        assert res["step"] == 4


def test_scenario_trains_on_the_model_parallel_grid(spawn_a):
    for r in spawn_a:
        res = r["scenario"]
        assert all(np.isfinite(res["losses"])), res["losses"]
        assert res["losses"][-1] < res["losses"][0], res["losses"]
        assert min(res["participation"]) < 1.0, res["participation"]
        assert res["frozen"] and all(res["frozen"]), res["frozen"]
    assert spawn_a[0]["scenario"]["losses"] == \
        spawn_a[1]["scenario"]["losses"]


def test_sketched_round_matches_jax(spawn_a, jax_ref):
    """One sketched round of reduced granite-8b (f32) on the (1, 2) grid,
    from JAX's state on its round's noise, against the reference's round on
    its 2-device mesh: the loss to rtol 1e-5 and each rank's Θ shard to
    atol 1e-5 (``llm_sketched_check``'s bars); both ranks' λ agree."""
    want = jax_ref["sketched"]
    ranks = [r["sketched"] for r in spawn_a]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(ranks[0]["lam_re"], ranks[1]["lam_re"])
    np.testing.assert_allclose(ranks[0]["lam_re"], want["lam_re"],
                               rtol=1e-5, atol=1e-5)
    full = model_params_from_numpy(want["Theta"], device="cpu")
    model = tm._f32_model("granite-8b")
    mdims, fdims = shard_dims_2d(full, model.cfg,
                                 abstract_mesh((1, 2), ("data", "model")),
                                 multi_pod=False, worker_dim=False)
    sspec = build_shard_packspec(full, mdims, 2, fsdp_dims=fdims)
    for r in ranks:
        for g, w in zip(tree_leaves(r["Theta"]),
                        tree_leaves(shard_tree(sspec, full, r["j"]))):
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-5)


def test_min_reduce_fn_hooks_match_jax():
    """The transport's and the guard's ``min_reduce_fn`` (how a mesh takes
    the min-α across the data axes) against the JAX package's, with a
    reducer that binds; None keeps the hook-free bits."""
    import jax
    import jax.numpy as jnp
    from repro.core import transport as jt
    from repro.core.channel import ChannelConfig as JChannelConfig
    from repro.core.cplx import Complex as JComplex
    from repro.faults import guards as jg

    from repro_torch.core import transport as tt
    from repro_torch.faults import guards as tg

    r = np.random.default_rng(5)
    energy = r.uniform(1.0, 4.0, 4).astype(np.float32)
    mask = np.array([True, True, False, True])
    floor = np.float32(0.05)
    jf = lambda a: jnp.minimum(a, floor)  # noqa: E731
    tf = lambda a: torch.minimum(a, torch.tensor(floor))  # noqa: E731
    te = torch.from_numpy(energy)
    for m in (None, mask):
        tm_ = None if m is None else torch.from_numpy(m)
        want = jt.inv_alpha_from_energy(jnp.asarray(energy), 3.0,
                                        min_reduce_fn=jf, mask=m)
        got = tt.inv_alpha_from_energy(te, 3.0, tm_, min_reduce_fn=tf)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        assert float(got) == float(1.0 / torch.tensor(floor))   # it binds
        assert torch.equal(tt.inv_alpha_from_energy(te, 3.0, tm_),
                           tt.inv_alpha_from_energy(te, 3.0, tm_,
                                                    min_reduce_fn=None))
    W, d = 3, 64
    theta = r.standard_normal((W, d)).astype(np.float32)
    planes = [r.standard_normal((W, d)).astype(np.float32) for _ in range(4)]
    gcfg = dict(policy="retransmit", max_retries=1)
    jout = jg.guarded_ota_round(
        jnp.asarray(theta), JComplex(*map(jnp.asarray, planes[:2])),
        JComplex(*map(jnp.asarray, planes[2:])), jax.random.PRNGKey(0), 0.5,
        JChannelConfig(n_workers=W, noisy=False), jg.GuardConfig(**gcfg),
        min_reduce_fn=jf, backend="jnp")
    t_ = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    tout = tg.guarded_ota_round(
        t_(theta), Complex(t_(planes[0]), t_(planes[1])),
        Complex(t_(planes[2]), t_(planes[3])), torch.zeros(d), 0.5,
        ChannelConfig(n_workers=W, noisy=False), tg.GuardConfig(**gcfg),
        draws=tg.GuardDraws(retry_noise=(torch.zeros(d),)),
        min_reduce_fn=tf)
    np.testing.assert_allclose(float(tout.inv_alpha), float(jout.inv_alpha),
                               rtol=1e-6)
    np.testing.assert_allclose(tout.Theta.numpy(), np.asarray(jout.Theta),
                               rtol=1e-6, atol=1e-6)
