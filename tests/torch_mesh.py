"""Gloo ranks on the CPU for the port's mesh tests: :func:`spawn` starts
``world`` processes that join one process group through a ``FileStore``
under the test's temporary directory (no fixed port, so parallel pytest
workers never collide), each with one intra-op thread, runs a function of
this module (or of another module that imports no JAX) in each, and
returns each rank's pickled result.  The rank functions import only torch
and the port, so a spawned rank never pays for JAX."""
from __future__ import annotations

import contextlib
import os
import pickle
import traceback
from typing import Optional

import numpy as np
import torch
import torch.multiprocessing as mp

#: seconds a spawn may take before its ranks are killed
SPAWN_TIMEOUT = 240


def _entry(fn, rank: int, world: int, store: str, out: str, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=store, rank=rank,
                                world_size=world)
        res = fn(rank, *args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, tmp_path, *args):
    """``[fn(rank, *args) for each rank]``, the ranks run as processes of
    one gloo group; a rank's exception fails the call with its traceback."""
    out = str(tmp_path)
    store = "file://" + os.path.join(out, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(SPAWN_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
    errs = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
    if errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError("ranks failed (exit codes "
                             f"{[p.exitcode for p in procs]}):\n"
                             + "\n".join(errs))
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def to_np(tree):
    """Tensors (in dicts, lists, tuples) as numpy arrays, for pickling."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree) \
            if not hasattr(tree, "_fields") else \
            type(tree)(*(to_np(v) for v in tree))
    return tree


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the shard-local round on a toy tree, one rank's part
# ---------------------------------------------------------------------------

def rank_view(case: dict, mesh):
    """This rank's inputs of a round case: the shard-local spec, the rank's
    coordinates, θ's resident shards of its rows and the rank's blocks of
    the shard-packed λ, h and h_tx."""
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import (build_shard_packspec,
                                          pack_shard_global_cplx, shard_tree)
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.tree import tree_map

    theta = {k: t(v) for k, v in case["theta"].items()}

    def ctree(name):
        if case.get(name) is None:
            return None
        return {k: Complex(t(re), t(im))
                for k, (re, im) in case[name].items()}

    sspec = build_shard_packspec(
        theta, case["mdims"], mesh.shape.get("model", 1), batch_dims=1,
        fsdp_dims=case.get("fdims"), n_fsdp=mesh.shape.get("fsdp", 1))
    c = shard_coords(mesh, sspec)
    W = next(iter(theta.values())).shape[0]
    W_l = W // c.n_data
    rows = slice(c.jd * W_l, (c.jd + 1) * W_l)
    cols = slice(c.j * sspec.d_local, (c.j + 1) * sspec.d_local)

    def block(tree):
        if tree is None:
            return None
        p = pack_shard_global_cplx(sspec, tree)
        return Complex(p.re[rows, cols].clone(), p.im[rows, cols].clone())

    theta_l = tree_map(lambda l: l[rows].clone(),
                       shard_tree(sspec, theta, c.j))
    return (sspec, c, theta_l, block(ctree("lam")), block(ctree("h")),
            block(ctree("h_tx")))


def place(shape, pieces, md, fd, n_model, n_fsdp, worker_dim=True):
    """A global array of ``shape`` from the resident blocks
    ``pieces[(jd, jm, jf)]`` (with ``worker_dim``, worker rows ``jd``'s
    lead the block)."""
    out = np.zeros(shape, np.float32)
    lead = 1 if worker_dim else 0
    for (jd, jm, jf), blk in pieces.items():
        idx = [slice(None)] * len(shape)
        if worker_dim:
            idx[0] = slice(jd * blk.shape[0], (jd + 1) * blk.shape[0])
        for d, n, j in ((md, n_model, jm), (fd, n_fsdp, jf)):
            if d is not None:
                w = shape[lead + d] // n
                idx[lead + d] = slice(j * w, (j + 1) * w)
        out[tuple(idx)] = blk
    return out


def _f32_model(arch: str):
    import dataclasses

    from repro_torch.models import build_model, get_config

    return build_model(dataclasses.replace(get_config(arch).reduced(),
                                           param_dtype="float32"))


def _trainer(mesh, arch: str, W: int, **fl):
    """The replicated trainer the replays use: reduced ``arch`` in f32, one
    sgd step at 1e-2, 40 dB, coherence 10, on ``mesh`` and the CPU."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    return make_fl_train(
        _f32_model(arch), FLConfig(n_workers=W, local_steps=1,
                                   local_lr=1e-2, **fl),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10),
        mesh=mesh, device="cpu")


def _rank_state(case_state, sspec, c):
    from repro_torch import convert

    return convert.mesh_tree_fl_state_from_numpy(
        sspec, c, c.n_data, device="cpu", **case_state)


def _theta_out(st):
    return {"theta": to_np(st.theta), "Theta": to_np(st.Theta),
            "lam_re": to_np(st.lam.re), "lam_im": to_np(st.lam.im)}


def replay_rank(mesh, case: dict) -> dict:
    """JAX's ``make_fl_train(mesh=...)`` rounds replayed on this rank from
    JAX's state (``case["state"]``) with JAX's per-shard noise
    (``case["noise"][round][shard]``); with ``case["snapshot"]`` (JAX's
    snapshot after round ``case["snap_round"]``) also the snapshot
    restored, checked bit for bit against this rank's part of JAX's state
    of that round, and the rest of the rounds replayed from it."""
    from repro_torch.checkpoint import restore_sharded
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.train.llm_trainer import TreeRoundDraws

    W = case["tokens"].shape[0]
    init_fn, step = _trainer(mesh, case["arch"], W)
    like = init_fn(0)
    sspec = init_fn.layout["sspec"]
    c = shard_coords(mesh, sspec)
    W_l = W // c.n_data
    batch = {"tokens": t(case["tokens"])[c.jd * W_l:(c.jd + 1) * W_l]}

    def run(st, r0, r1):
        losses = []
        for r in range(r0, r1):
            draws = TreeRoundDraws(None, t(case["noise"][r][c.j]))
            st, m = step(st, batch, draws=draws)
            losses.append(float(m["loss"]))
        return st, losses

    st, losses = run(_rank_state(case["state"], sspec, c), 0,
                     len(case["noise"]))
    out = {"jd": c.jd, "j": c.j, "jm": c.jm, "jf": c.jf, "losses": losses,
           "d_pad": sspec.d_pad, **_theta_out(st)}
    if case.get("snapshot"):
        k = case["snap_round"]
        st_r = restore_sharded(case["snapshot"], like, mesh, sspec)
        want = _rank_state(case["snap_state"], sspec, c)
        out["snapshot_bits"] = all(
            bool(torch.equal(a, b)) for a, b in
            zip(_leaves(st_r), _leaves(want)))
        out["losses_restored"] = run(st_r, k, len(case["noise"]))[1]
    return out


def _leaves(st):
    from repro_torch.tree import tree_leaves

    out = tree_leaves(st.theta) + tree_leaves(st.Theta)
    out += [st.lam.re, st.lam.im, st.chan.h.re, st.chan.h.im]
    small = getattr(st.chan, "h_small", None)
    out += [] if small is None else [small.re, small.im]
    if st.flt is not None:
        out += [st.flt.alive, st.flt.n_evicted]
        out += [] if st.flt.stale is None else [st.flt.stale]
    return out


def resume_rank(mesh, ckdir: str) -> dict:
    """The shard-local kill-and-resume, port against port (the reference's
    setting): reduced granite-8b under ``markov-doppler`` with stragglers,
    bursts, a crash and the evict-retransmit guard, 4 rounds straight
    against 2 rounds, a snapshot (``save_sharded``), a fresh restore and 2
    more rounds."""
    from repro_torch.checkpoint import restore_sharded, round_path, \
        save_sharded
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.faults import FaultPlan, GuardConfig

    W = 2
    init_fn, step = _trainer(
        mesh, "granite-8b", W, scenario="markov-doppler",
        faults=FaultPlan(crash_at=((2, 1),), straggler_prob=0.3,
                         burst_prob=0.5, burst_std=20.0),
        guard=GuardConfig(policy="evict-retransmit", snr_floor_db=-40.0))
    tokens = np.random.default_rng(3).integers(0, 128, (W, 2, 16))
    st0 = init_fn(0)
    sspec = init_fn.layout["sspec"]
    c = shard_coords(mesh, sspec)
    batch = {"tokens": t(tokens)}

    def run(st, r0, r1):
        for r in range(r0, r1):
            st, _ = step(st, batch, key=2000 + r)
        return st

    full = run(st0, 0, 4)
    half = run(init_fn(0), 0, 2)
    path = round_path(ckdir, 2)
    save_sharded(path, half, mesh, sspec)
    resumed = run(restore_sharded(path, init_fn(0), mesh, sspec), 2, 4)
    return {"j": c.j, "bits": [bool(torch.equal(a, b)) for a, b in
                               zip(_leaves(full), _leaves(resumed))],
            "alive": to_np(full.flt.alive), "evicted": int(full.flt.n_evicted),
            "step": resumed.step}


def scenario_rank(mesh) -> dict:
    """The reference's scenario smoke on the model-parallel grid: reduced
    granite-8b (bf16, W = 4) under ``deep-fade-truncation`` (h_min 0.8) for
    8 rounds; a truncated worker's λ rows keep their bits."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.models import get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    W = 4
    init_fn, step = make_fl_train(
        get_model("granite-8b", reduced=True),
        FLConfig(n_workers=W, local_steps=1, local_lr=1e-2,
                 scenario="deep-fade-truncation", h_min=0.8),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0), mesh=mesh, device="cpu")
    st = init_fn(0)
    c = shard_coords(mesh, init_fn.layout["sspec"])
    tokens = np.random.default_rng(0).integers(0, 128, (W, 2, 16))
    batch = {"tokens": t(tokens)}
    losses, parts, frozen = [], [], []
    for r in range(8):
        prev = st.lam.re.clone()
        st, m = step(st, batch, key=r)
        msk = st.chan.mask
        if (~msk).any():
            frozen.append(bool(torch.equal(st.lam.re[~msk], prev[~msk])))
        losses.append(float(m["loss"]))
        parts.append(float(m["participation"]))
    return {"j": c.j, "losses": losses, "participation": parts,
            "frozen": frozen}


def guarded_rank(mesh, case: dict) -> dict:
    """The noisy guarded shard-local round (evict-retransmit, a burst on
    the first attempt, telemetry) on JAX's θ, λ, h and per-shard draws."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.packing import shard_tree
    from repro_torch.core.tree_ota import ota_tree_round_shard_local
    from repro_torch.faults import GuardConfig
    from repro_torch.faults import plan as fplan
    from repro_torch.faults.guards import GuardDraws

    sspec, c, theta_l, lam, h, _ = rank_view(case, mesh)
    W = lam.re.shape[0] * c.n_data
    Theta_prev = shard_tree(sspec, {k: t(v) for k, v in
                                    case["Theta_prev"].items()}, c.j)
    rf = fplan.RoundFaults(alive=torch.ones(W, dtype=torch.bool),
                           straggler=None, corrupt=None, snapshot_due=None,
                           burst_std=torch.tensor(case["burst_std"]))
    plan = fplan.FaultPlan(burst_prob=1.0, burst_std=case["burst_std"])
    gd = GuardDraws(burst=t(case["burst"][c.j]),
                    retry_noise=tuple(t(x) for x in case["retry"][c.j]))
    T, lam_new, m = ota_tree_round_shard_local(
        theta_l, lam, h, t(case["noise"][c.j]),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=20.0), sspec, mesh,
        Theta_prev=Theta_prev,
        guard=GuardConfig(policy="evict-retransmit", snr_floor_db=0.0,
                          max_retries=2), guard_draws=gd,
        faults=(plan, rf, None), telemetry=True)
    aux = m.pop("_fault_aux")
    return {"jd": c.jd, "j": c.j, "jm": c.jm, "jf": c.jf,
            "Theta": to_np(T), "lam_re": to_np(lam_new.re),
            "lam_im": to_np(lam_new.im), "metrics": to_np(m),
            "evicted": to_np(aux["evicted"])}


def checks_rank(mesh, case: dict, runs: list) -> dict:
    """On one rank: ``unpack_cplx_shard_local`` of λ against the rank's
    slice of the λ tree, and the calls each round body makes (one
    ``ota_round_stats`` fused, one ``receive`` composed)."""
    from repro_torch.core import transport
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.packing import shard_tree
    from repro_torch.core.tree_ota import (ota_tree_round_shard_local,
                                          unpack_cplx_shard_local)

    sspec, c, theta_l, lam, h, _ = rank_view(case, mesh)
    got = unpack_cplx_shard_local(sspec, lam, mesh)
    want_re = shard_tree(sspec, {k: t(re) for k, (re, _) in
                                 case["lam"].items()}, c.j)
    want_im = shard_tree(sspec, {k: t(im) for k, (_, im) in
                                 case["lam"].items()}, c.j)
    unpack_ok = all(torch.equal(got[k].re, want_re[k])
                    and torch.equal(got[k].im, want_im[k]) for k in got)
    calls = {"receive": 0, "stats": 0}
    orig = transport.receive, transport.ota_round_stats

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    counted = []
    transport.receive = count("receive", orig[0])
    transport.ota_round_stats = count("stats", orig[1])
    try:
        for fused in (None, False):
            calls.update(receive=0, stats=0)
            W = lam.re.shape[0] * c.n_data
            ota_tree_round_shard_local(
                theta_l, lam, h, torch.zeros(sspec.d_local),
                AdmmConfig(rho=0.5, flip_on_change=False),
                ChannelConfig(n_workers=W, noisy=False), sspec, mesh,
                fused=fused)
            counted.append(dict(calls))
    finally:
        transport.receive, transport.ota_round_stats = orig
    return {"unpack_ok": bool(unpack_ok), "calls": counted}


def suite_rank(rank: int, parts: dict, ckdir: str) -> dict:
    """Spawn A of ``tests/test_torch_shard_local.py`` on a (1, 2) grid: the
    parity runs, the checks, JAX's guarded round and trainer replays, the
    snapshot and the kill-and-resume, one result each."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    out = {}
    for name, (kind, args) in parts.items():
        fn = {"round": round_rank_on, "checks": checks_rank,
              "guarded": guarded_rank, "replay": replay_rank,
              "resume": resume_rank, "scenario": scenario_rank,
              "sketched": sketched_replay_rank}[kind]
        out[name] = fn(mesh, *args)
    return out


def round_rank_on(mesh, case: dict, runs: list) -> dict:
    """:func:`round_rank`'s work on a given mesh."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.tree_ota import ota_tree_round_shard_local

    sspec, c, theta_l, lam, h, h_tx = rank_view(case, mesh)
    W = lam.re.shape[0] * c.n_data
    ccfg = ChannelConfig(n_workers=W, noisy=False)
    out = {"jd": c.jd, "j": c.j, "jm": c.jm, "jf": c.jf, "runs": []}
    for run in runs:
        acfg = AdmmConfig(rho=0.5, power_control=run["power_control"],
                          flip_on_change=False)
        mask = run.get("mask")
        T, lam_new, m = ota_tree_round_shard_local(
            theta_l, lam, h, torch.zeros(sspec.d_local), acfg, ccfg, sspec,
            mesh, mask=None if mask is None else t(mask),
            h_tx_p=h_tx if run.get("use_h_tx") else None,
            fused=run.get("fused"))
        out["runs"].append(to_np({"Theta": T, "lam_re": lam_new.re,
                                  "lam_im": lam_new.im,
                                  "inv_alpha": m["inv_alpha"]}))
    return out


def grid_rank(rank: int, cases: list) -> list:
    """Spawn B: each ``(case, runs)`` of :func:`round_rank_on` on its own
    mesh over the 4 ranks."""
    from repro_torch.launch.mesh import make_mesh

    return [round_rank_on(make_mesh(case["shape"], case["axes"], "cpu"),
                          case, runs) for case, runs in cases]


# ---------------------------------------------------------------------------
# the pure-data mesh against one device, cohort sampling on it, the shard
# grid's row-wise truncation, the leafwise state on a mesh
# ---------------------------------------------------------------------------

def _own_trainer(mesh, W: int, local_steps: int = 2, coherence: int = 2,
                 **fl):
    """Reduced granite-8b in f32 on a noise-free link: ``local_steps`` sgd
    steps at 1e-2, ρ 0.5, 40 dB, coherence ``coherence``, on the CPU."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    n = fl.get("population") or W
    return make_fl_train(
        _f32_model("granite-8b"),
        FLConfig(n_workers=W, local_steps=local_steps, local_lr=1e-2, **fl),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=n, snr_db=40.0, coherence_iters=coherence,
                      noisy=False),
        mesh=mesh, device="cpu")


def _tokens(rows: int, seed: int = 7) -> torch.Tensor:
    return t(np.random.default_rng(seed).integers(0, 128, (rows, 2, 16)))


def _run_rounds(init_fn, step, batch, rounds: int, keep_idx=None):
    """``rounds`` rounds from ``init_fn(0)`` with round keys 1, 2, …: the
    losses, α⁻¹ and the final state; ``keep_idx(r)`` (a round's sampled
    population rows) adds whether every other row of θ and λ kept its
    bits."""
    st = init_fn(0)
    losses, inv_alpha, kept = [], [], []
    for r in range(rounds):
        prev = st
        st, m = step(st, batch, key=r + 1)
        losses.append(float(m["loss"]))
        inv_alpha.append(float(m["inv_alpha"]))
        if keep_idx is not None:
            kept.append(_rows_kept(prev, st, keep_idx(r)))
    return st, losses, inv_alpha, kept


def _rows_kept(prev, st, rows) -> bool:
    from repro_torch.tree import tree_leaves

    ok = True
    for a, b in zip(tree_leaves(prev.theta), tree_leaves(st.theta)):
        ok &= bool(torch.equal(a[rows], b[rows]))
    for a, b in ((prev.lam.re, st.lam.re), (prev.lam.im, st.lam.im)):
        ok &= bool(torch.equal(a[rows], b[rows]))
    return ok


def _replicated_out(st, losses, inv_alpha, kept=()):
    return {"losses": losses, "inv_alpha": inv_alpha, "kept": list(kept),
            "Theta": to_np(st.Theta), "theta": to_np(st.theta),
            "lam_re": to_np(st.lam.re), "lam_im": to_np(st.lam.im),
            "h_re": to_np(st.chan.h.re), "h_im": to_np(st.chan.h.im)}


def data_mesh_rank(rank: int, fl: dict, rounds: int) -> dict:
    """On a (2, 1) (data, model) mesh: ``rounds`` noise-free rounds of
    reduced granite-8b, 2 local steps, coherence 2 (a redraw in round 1),
    with the trainer options ``fl``; rank 0 also runs them on one device.
    Under uniform sampling each round's unsampled rows are checked for
    their bits."""
    from repro_torch.core import cohort as _cohort
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    W = fl.get("cohort") or 2
    init_fn, step = _own_trainer(mesh, W, **fl)
    tokens = _tokens(W)
    c = shard_coords(mesh)
    W_l = W // c.n_data
    N = fl.get("population") or W
    N_l = N // c.n_data
    keep_idx = None
    if fl.get("cohort_policy", "uniform") == "uniform" and "population" in fl:
        cfg = _cohort.CohortConfig(N, W)

        def keep_idx(r):
            idx = _cohort.sample_cohort(cfg, _cohort.draw_cohort(
                r + 1, cfg, "cpu")).tolist()
            return [i - c.jd * N_l for i in range(c.jd * N_l,
                                                  (c.jd + 1) * N_l)
                    if i not in idx]
    st, losses, ia, kept = _run_rounds(
        init_fn, step, {"tokens": tokens[c.jd * W_l:(c.jd + 1) * W_l]},
        rounds, keep_idx)
    out = {"jd": c.jd, "mesh": _replicated_out(st, losses, ia, kept)}
    if rank == 0:
        init1, step1 = _own_trainer(None, W, **fl)
        out["one"] = _replicated_out(*_run_rounds(init1, step1,
                                                  {"tokens": tokens},
                                                  rounds)[:3])
    return out


def leafwise_rank(mesh) -> dict:
    """The leafwise state on ``mesh`` against the packed one, one
    noise-free round of reduced granite-8b (W = 2, one local step) from the
    same θ, λ and h: the leafwise state's λ and h are the packed state's
    planes unpacked to the rank's leaf blocks."""
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import pack_shard_local, shard_valid_mask
    from repro_torch.core.tree_ota import (TreeChannel, shard_coords,
                                           unpack_cplx_shard_local)
    from repro_torch.train.llm_trainer import TreeRoundDraws
    from repro_torch.tree import tree_leaves, tree_map

    W = 2
    init_p, step_p = _own_trainer(mesh, W, local_steps=1, coherence=10)
    init_l, step_l = _own_trainer(mesh, W, local_steps=1, coherence=10,
                                  packed_uplink=False)
    sp = init_p(0)
    sl = init_l(0)
    sspec = init_p.layout["sspec"]
    c = shard_coords(mesh, sspec)
    rows = slice(c.jd * (W // c.n_data), (c.jd + 1) * (W // c.n_data))
    # a λ that is not zero: the round's own update from a first round
    sp, _ = step_p(sp, {"tokens": _tokens(W)[rows]},
                   draws=TreeRoundDraws(None, torch.zeros(sspec.d_local)))

    def tree(z):
        return tree_map(lambda x: Complex(x.re.clone(), x.im.clone()),
                        unpack_cplx_shard_local(sspec, z, mesh))
    sl = sl._replace(theta=tree_map(torch.clone, sp.theta),
                     Theta=tree_map(torch.clone, sp.Theta),
                     lam=tree(sp.lam), chan=TreeChannel(
                         h=tree(sp.chan.h), age=sp.chan.age),
                     opt=sp.opt)
    batch = {"tokens": _tokens(W, 8)[rows]}
    sp2, mp = step_p(sp, batch, draws=TreeRoundDraws(
        None, torch.zeros(sspec.d_local)))
    sl2, ml = step_l(sl, batch, draws=TreeRoundDraws(
        None, [torch.zeros(leaf.shape[1:]) for leaf in
               tree_leaves(sl.theta)]))
    valid = shard_valid_mask(sspec, c.j)
    lam_l = Complex(
        pack_shard_local(sspec, tree_map(lambda z: z.re, sl2.lam), c.j),
        pack_shard_local(sspec, tree_map(lambda z: z.im, sl2.lam), c.j))
    return {"Theta_p": to_np(sp2.Theta), "Theta_l": to_np(sl2.Theta),
            "theta_equal": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(sp2.theta), tree_leaves(sl2.theta))),
            "lam_p": to_np([sp2.lam.re[:, valid], sp2.lam.im[:, valid]]),
            "lam_l": to_np([lam_l.re[:, valid], lam_l.im[:, valid]]),
            "inv_alpha": [float(mp["inv_alpha"]), float(ml["inv_alpha"])],
            "loss": [float(mp["loss"]), float(ml["loss"])]}


def rounds_rank(rank: int, parts: dict) -> dict:
    """Spawn of ``tests/test_torch_mesh_rounds.py`` on two ranks: each
    part ``name -> (kind, args)`` on its mesh."""
    from repro_torch.launch.mesh import make_mesh

    out = {}
    for name, (kind, args) in parts.items():
        if kind == "data":
            out[name] = data_mesh_rank(rank, *args)
        elif kind == "leafwise":
            out[name] = leafwise_rank(make_mesh(*args, "cpu"))
        elif kind == "truncation":
            out[name] = grid_truncation_rank(
                make_mesh((1, 2), ("data", "model"), "cpu"), *args)
    return out


def grid_truncation_rank(mesh, rounds: int) -> dict:
    """``markov-doppler`` with a truncation threshold (a per-element,
    truncating scenario) on the (1, 2) grid against one device, noise-free,
    W = 4, one local step, from the one-device run's state and on its
    draws (each plane carried into the rank's columns of the shard-packed
    layout).  The threshold lies midway between the second and third
    weakest workers' initial RMS |h|, so two workers start truncated."""
    from repro_torch.convert import shard_fl_state, phy_planes
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import (build_packspec, pack_shard_global,
                                          shard_tree, unpack)
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.train.llm_trainer import TreeRoundDraws, draw_round

    W = 4
    h0 = _own_trainer(None, W, local_steps=1, scenario="markov-doppler",
                      h_min=1e-3)[0](0).chan.h
    rms = torch.sqrt((h0.re ** 2 + h0.im ** 2).mean(-1)).sort().values
    fl = dict(scenario="markov-doppler", h_min=float(rms[1] + rms[2]) / 2)
    init1, step1 = _own_trainer(None, W, local_steps=1, **fl)
    init_m, step_m = _own_trainer(mesh, W, local_steps=1, **fl)
    st1 = init1(0)
    init_m(0)
    sspec = init_m.layout["sspec"]
    c = shard_coords(mesh, sspec)
    spec1 = build_packspec(st1.theta, batch_dims=1)
    dl = sspec.d_local
    cols = slice(c.j * dl, (c.j + 1) * dl)

    def grid(x):
        """A one-device (W, D) plane in the shard-packed (W, d_pad)
        layout."""
        return pack_shard_global(sspec, unpack(spec1, x, cast=False))

    def cgrid(z):
        return None if z is None else Complex(grid(z.re), grid(z.im))

    glob = st1._replace(
        lam=cgrid(st1.lam),
        chan=phy_planes(st1.chan, spec1.d, grid))
    stm = shard_fl_state(glob, sspec, c, c.n_data)
    tokens = {"tokens": _tokens(W)}
    out = {"mask_1": [], "mask_m": [], "part_1": [], "part_m": [],
           "loss_1": [], "loss_m": []}
    cmask = [st1.chan.mask.tolist(), stm.chan.mask.tolist()]
    for r in range(rounds):
        d1 = draw_round(r + 1, st1, _ccfg(W), scenario=_scenario(fl, W))
        w = d1.phy.w
        dm = TreeRoundDraws(None, torch.zeros(dl), phy=d1.phy._replace(
            w=None if w is None else Complex(grid(w.re)[:, cols],
                                             grid(w.im)[:, cols])))
        st1, m1 = step1(st1, tokens, draws=d1)
        stm, mm = step_m(stm, tokens, draws=dm)
        out["mask_1"].append(st1.chan.mask.tolist())
        out["mask_m"].append(stm.chan.mask.tolist())
        out["part_1"].append(float(m1["participation"]))
        out["part_m"].append(float(mm["participation"]))
        out["loss_1"].append(float(m1["loss"]))
        out["loss_m"].append(float(mm["loss"]))
    lam1 = cgrid(st1.lam)
    out.update(
        init_masks=cmask, j=c.j,
        Theta_1=to_np(shard_tree(sspec, st1.Theta, c.j)),
        Theta_m=to_np(stm.Theta),
        lam_1=to_np([lam1.re[:, cols], lam1.im[:, cols]]),
        lam_m=to_np([stm.lam.re, stm.lam.im]))
    return out


def _ccfg(W: int):
    from repro_torch.core.channel import ChannelConfig

    return ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=2,
                         noisy=False)


def _scenario(fl: dict, W: int):
    from repro_torch.phy.scenario import make_scenario

    return make_scenario(fl["scenario"], _ccfg(W), h_min=fl["h_min"])


# ---------------------------------------------------------------------------
# the sketched mode on a mesh
# ---------------------------------------------------------------------------

def _sketched(mesh, W: int, model=None, **fl):
    """The sketched trainer on reduced granite-8b in f32 (or ``model``): W
    workers, one sgd step at 1e-2, ratio 16, sketch_lr 0.7, 40 dB,
    coherence 10, a noise-free link unless ``noisy=True``, on ``mesh`` and
    the CPU."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    kw = dict(mode="sketched", n_workers=W, local_steps=1, local_lr=1e-2,
              sketch_ratio=16, sketch_lr=0.7)
    kw.update(fl)
    noisy = kw.pop("noisy", False)
    return make_fl_train(
        model or _f32_model("granite-8b"), FLConfig(**kw),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10,
                      noisy=noisy), mesh=mesh, device="cpu")


def codec_rank(mesh) -> dict:
    """The codec of the sketched mode's grid on one rank: a random delta
    of reduced granite-8b's shape (the same on every rank; N(0, 10⁻⁴), an
    sgd step's size) encoded from the rank's shard and summed over the
    grid, and a random sketch decoded to the rank's shard (as ``Θ = 0 + 1 ·
    decode(s)``)."""
    from repro_torch.core.packing import shard_tree
    from repro_torch.train.llm_trainer import _SketchGrid
    from repro_torch.tree import tree_map

    model = _f32_model("granite-8b")
    full = model.init(0, device="cpu")
    grid = _SketchGrid(model, mesh)
    layout: dict = {}
    grid.init(full, layout)
    r = np.random.default_rng(11)
    delta = tree_map(lambda l: t((1e-2 * r.standard_normal(tuple(l.shape)))
                                 .astype(np.float32)), full)
    mine = tree_map(torch.clone, shard_tree(layout["sspec"], delta,
                                            layout["j"]))
    d_s = 4099
    out = torch.zeros((1, d_s))
    grid.encode(mine, out[0])
    s = t(r.standard_normal(d_s).astype(np.float32))
    zero = tree_map(torch.zeros_like, mine)
    dec, sq = grid.apply_delta(zero, s, 1.0, True)
    return {"sketch": to_np(grid.join(out)[0]), "decoded": to_np(dec),
            "sq": float(sq), "j": layout["j"], "jm": grid.jm, "jf": grid.jf,
            "delta": to_np(delta), "s": to_np(s)}


def sketched_round_rank(mesh, W: int, rounds: int, rs: bool,
                        tokens) -> dict:
    """``rounds`` noise-free sketched rounds (keys 1, 2, …) on ``mesh`` with
    or without ``REPRO_OPT=rs_grads``: each round's loss and the final Θ
    shard, λ and the layout's shard coordinates.  ``tokens`` (W, B, S):
    the rank takes its rows of each worker's batch."""
    from repro_torch.launch.mesh import axis_size, data_axes

    os.environ["REPRO_OPT"] = "rs_grads" if rs else ""
    try:
        init_fn, step = _sketched(mesh, W)
        st = init_fn(0)
        baxes = tuple(a for a in data_axes(False) if a in mesh.axis_names)
        nb = axis_size(mesh, baxes) if baxes else 1
        jb = mesh.axis_index(baxes) if baxes else 0
        B = tokens.shape[1] // nb
        batch = {"tokens": t(tokens)[:, jb * B:(jb + 1) * B]}
        losses = []
        for r in range(rounds):
            st, m = step(st, batch, key=r + 1)
            losses.append(float(m["loss"]))
    finally:
        os.environ.pop("REPRO_OPT", None)
    lay = init_fn.layout
    return {"losses": losses, "Theta": to_np(st.Theta),
            "lam_re": to_np(st.lam.re), "j": lay["j"],
            "stats": dict(mesh.stats)}


def sketched_scenario_rank(mesh) -> dict:
    """The reference's sketched smoke on the 2-D grid
    (``tests/test_shard_local.py``, ``SKETCHED_2D_SCENARIO_TRAIN_OK``):
    reduced granite-8b (bf16), W = 4, B = 2, T = 16, ratio 16, sketch_lr
    0.7, one sgd step at 1e-2, ``deep-fade-truncation`` with h_min 0.8, 40
    dB, 8 rounds."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    W = 4
    init_fn, step = make_fl_train(
        get_model("granite-8b", reduced=True),
        FLConfig(mode="sketched", n_workers=W, local_steps=1, local_lr=1e-2,
                 sketch_ratio=16, sketch_lr=0.7,
                 scenario="deep-fade-truncation", h_min=0.8),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0), mesh=mesh, device="cpu")
    st = init_fn(0)
    batch = {"tokens": _tokens(W, 0)}
    losses, parts, frozen = [], [], []
    d_s = st.lam.re.shape[-1]
    for r in range(8):
        prev = st.lam.re.clone()
        st, m = step(st, batch, key=r)
        msk = st.chan.mask
        if (~msk).any():
            frozen.append(bool(torch.equal(st.lam.re[~msk], prev[~msk])))
        losses.append(float(m["loss"]))
        parts.append(float(m["participation"]))
    return {"losses": losses, "participation": parts, "frozen": frozen,
            "lam_shape": tuple(st.lam.re.shape), "d_s": d_s,
            "lam_re": to_np(st.lam.re)}


def sketched_resume_rank(mesh, ckdir: str) -> dict:
    """The sketched state's snapshot on a mesh: 2 rounds, a snapshot
    (``save_sharded``: Θ gathered whole), a fresh restore and a third
    round, against 3 rounds straight; and the file's Θ against the ranks'
    shards."""
    from repro_torch.checkpoint import restore_sharded, save_sharded
    from repro_torch.tree import tree_leaves

    W = 2
    init_fn, step = _sketched(mesh, W)
    batch = {"tokens": _tokens(W)}
    st = init_fn(0)
    lay = init_fn.layout
    for r in range(2):
        st, _ = step(st, batch, key=r + 1)
    path = os.path.join(ckdir, "sketched.npz")
    save_sharded(path, st, mesh, lay["sspec"], lay["faxes"])
    back = restore_sharded(path, init_fn(0), mesh, lay["sspec"],
                           lay["faxes"])
    bits = [bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(st.Theta) + [st.lam.re, st.chan.h.re],
        tree_leaves(back.Theta) + [back.lam.re, back.chan.h.re])]
    st, _ = step(st, batch, key=3)
    back, _ = step(back, batch, key=3)
    bits += [bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(st.Theta) + [st.lam.re],
        tree_leaves(back.Theta) + [back.lam.re])]
    with np.load(path) as zf:
        shapes = {k: zf[k].shape for k in zf.files}
    return {"bits": bits, "shapes": shapes, "step": back.step}


def sketched_rank(rank: int, tokens, ckdir: str) -> dict:
    """Spawn of ``tests/test_torch_mesh_sketched.py`` on four ranks: the
    codec on the (1, 2, 2) grid; the reference's 8-round scenario smoke
    there; a snapshot and its restore there (files under ``ckdir``); one
    round with and without ``rs_grads`` on (1, 2, 2) (no rank
    sums a gradient) and on a (2, 2) (data, model) mesh, where the codec's
    fsdp dim rides the data axis and the gathers' backward sums each
    worker's split batch; rank 0 runs that round on one device too."""
    from repro_torch.launch.mesh import make_mesh

    grid = make_mesh((1, 2, 2), ("data", "fsdp", "model"), "cpu")
    out = {"codec": codec_rank(grid),
           "scenario": sketched_scenario_rank(grid),
           "grid": [sketched_round_rank(grid, 2, 1, rs, tokens)
                    for rs in (False, True)],
           "resume": sketched_resume_rank(grid, ckdir)}
    fsdp_data = make_mesh((2, 2), ("data", "model"), "cpu")
    out["fsdp_data"] = [sketched_round_rank(fsdp_data, 2, 1, rs, tokens)
                        for rs in (False, True)]
    if rank == 0:
        init_fn, step = _sketched(None, 2)
        st, m = step(init_fn(0), {"tokens": t(tokens)}, key=1)
        out["one"] = {"losses": [float(m["loss"])], "Theta": to_np(st.Theta),
                      "lam_re": to_np(st.lam.re)}
    return out


def sketched_replay_rank(mesh, case: dict) -> dict:
    """JAX's sketched round on its (1, 2) mesh replayed on this rank: the
    rank's shard of JAX's Θ, its (W, d_s) λ and h, the round's noise."""
    from repro_torch import convert
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import shard_tree
    from repro_torch.core.tree_ota import TreeChannel
    from repro_torch.train.llm_trainer import TreeRoundDraws
    from repro_torch.tree import tree_map

    W = case["tokens"].shape[0]
    init_fn, step = _sketched(mesh, W, noisy=True)
    st = init_fn(0)
    lay = init_fn.layout
    Theta = convert.model_params_from_numpy(case["Theta0"], device="cpu")
    st = st._replace(
        Theta=tree_map(torch.clone, shard_tree(lay["sspec"], Theta,
                                               lay["j"])),
        lam=Complex(t(case["lam"][0]), t(case["lam"][1])),
        chan=TreeChannel(h=Complex(t(case["h"][0]), t(case["h"][1])),
                         age=case["age"]))
    st, m = step(st, {"tokens": t(case["tokens"])},
                 draws=TreeRoundDraws(None, t(case["noise"])))
    return {"loss": float(m["loss"]), "Theta": to_np(st.Theta),
            "lam_re": to_np(st.lam.re), "j": lay["j"]}


# ---------------------------------------------------------------------------
# the dry run's collectives against a live round (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------

#: (name, mesh shape, FL mode, arch) of the rounds the dry-run test holds to
#: a live round (reduced; qwen3-moe's experts, heads and vocab partitioned on
#: (1, 2)), and that round's key
DRYRUN_ROUNDS = (("(1, 2)", (1, 2), "replicated", "granite-8b"),
                 ("(2, 1)", (2, 1), "replicated", "granite-8b"),
                 ("sketched (1, 2)", (1, 2), "sketched", "granite-8b"),
                 ("moe (1, 2)", (1, 2), "replicated", "qwen3-moe-30b-a3b"))
DRYRUN_KEY = 7
DRYRUN_SEQ = 16


def dryrun_trainer(mesh, mode: str, device, arch: str = "granite-8b"):
    """``(init_fn, train_step)`` of reduced ``arch``, 2 workers, one local
    sgd step, on ``mesh`` and ``device`` (``meta`` for the trace)."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models.registry import get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    return make_fl_train(
        get_model(arch, reduced=True),
        FLConfig(mode=mode, n_workers=2, local_steps=1, local_lr=1e-2,
                 sketch_ratio=16),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=2, snr_db=40.0), mesh=mesh, device=device)


def dryrun_batch(mesh, mode: str, device) -> dict:
    """The rank's tokens: its workers' rows (replicated), or every worker's
    one row (sketched)."""
    rows = 2 // mesh.shape["data"] if mode == "replicated" else 2
    if torch.device(device).type == "meta":
        return {"tokens": torch.empty((rows, 1, DRYRUN_SEQ),
                                      dtype=torch.int32, device=device)}
    g = torch.Generator().manual_seed(3)
    return {"tokens": torch.randint(0, 512, (rows, 1, DRYRUN_SEQ),
                                    generator=g, dtype=torch.int32)}


#: (arch, mesh shape) of the serving runs the dry-run test holds to one
#: device and to the trace: a dense family, the SSM family and the hybrid
#: family, whose products partition over the model axis; over the model
#: axis and over the data axis
DRYRUN_SERVE = tuple((arch, shape) for arch in ("granite-8b",
                                                "falcon-mamba-7b",
                                                "recurrentgemma-2b")
                     for shape in ((1, 2), (2, 1)))
#: the served batch, its prompt length and the greedy steps after it
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 2, 4, 3
#: (arch, mesh shape, prompt, steps) of the moe family's serving run the
#: dry-run test holds to the trace: an even ``max_seq``, so MLA's latent
#: cache splits its sequence over ``model``
DRYRUN_SERVE_MOE = (("deepseek-v3-671b", (1, 2), 4, 4),)


def serve_tokens(vocab: int, batch: int = SERVE_BATCH,
                 prompt: int = SERVE_PROMPT) -> torch.Tensor:
    """The served batch's prompts, (batch, prompt) int32."""
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, vocab, (batch, prompt), generator=g,
                         dtype=torch.int32)


def serve_rows(mesh, batch: int) -> slice:
    """The rank's rows of a served batch: its block over the data axis
    where the batch divides it, else every row (``shardings
    .batch_pspec``)."""
    n = mesh.axis_size("data")
    if batch % n or batch < n:
        return slice(0, batch)
    b = batch // n
    j = mesh.axis_index("data")
    return slice(j * b, (j + 1) * b)


def serve_inputs(cfg, batch: int, prompt: int) -> dict:
    """The served batch of ``cfg``: its prompts (:func:`serve_tokens`)
    and, for the vlm, stub patches (seed 6)."""
    inputs = {"tokens": serve_tokens(cfg.vocab_size, batch, prompt)}
    if cfg.modality == "vision":
        g = torch.Generator().manual_seed(6)
        inputs["patches"] = torch.randn(
            (batch, cfg.frontend_tokens, cfg.frontend_dim), generator=g)
    return inputs


def serve_run(arch: str, mesh=None, *, over=None, batch: int = SERVE_BATCH,
              prompt: int = SERVE_PROMPT, steps: int = SERVE_STEPS,
              params=None) -> dict:
    """Reduced ``arch`` (f32, the fields of ``over`` replaced; the port's
    seed-0 init, or ``params``, a numpy tree such as the JAX package's)
    served on the CPU: the prompt's prefill (its last logits), then the
    prompt ingested a token at a time through the greedy step and
    ``steps`` tokens generated, each step's logits (the rank's vocab
    columns under a partition), and the cache at the end.  Under ``mesh``
    (``launch.mesh``) the params are the rank's block (``.shard(full)``),
    the batch, the tokens and the logits the rank's rows of it, and the
    cache the rank's block of the whole one (``.init_cache``); ``stats``
    holds the mesh's collectives in the prefill and in the last step,
    ``layout`` the cache's layout and specs and ``coord`` the rank's
    coordinates."""
    from repro_torch.launch.trace_analysis import mesh_collectives
    from repro_torch.serve import make_prefill, make_serve_step

    model = (_f32_model(arch) if over is None
             else _build(partition_cfg(arch, over)))
    if params is None:
        full = model.init(0, device="cpu")
    else:
        from repro_torch.convert import model_params_from_numpy

        full = model_params_from_numpy(params, device="cpu")
    inputs = serve_inputs(model.cfg, batch, prompt)
    toks = inputs["tokens"]
    if mesh is not None:
        rows = serve_rows(mesh, batch)
        inputs = {k: v[rows] for k, v in inputs.items()}
        toks = inputs["tokens"]
    out: dict = {"stats": {}, "logits_steps": []}
    prefill = make_prefill(model, mesh)
    params = prefill.shard(full)
    if mesh is not None:
        mesh.reset_stats()
    out["logits"] = to_np(prefill(params, inputs))
    if mesh is not None:
        out["stats"]["prefill"] = mesh_collectives(mesh.stats)
        out["calls"] = {"prefill": {op: dict(v["axes"])
                                    for op, v in mesh.stats.items()}}

    def observed(p, c, tok, pos):
        logits, c = model.decode_step(p, c, tok, pos)
        out["logits_steps"].append(to_np(logits))
        return logits, c
    step = make_serve_step(model._replace(decode_step=observed), mesh)
    params = step.shard(full)
    if mesh is None:
        cache = model.init_cache(batch, prompt + steps, device="cpu")
    else:
        cache = step.init_cache(batch, prompt + steps, device="cpu")
    tok, gen = toks[:, 0], []
    for i in range(prompt + steps - 1):
        if mesh is not None:
            mesh.reset_stats()
        nxt, cache = step(params, cache, tok, i)
        if i + 1 < prompt:
            tok = toks[:, i + 1]
        else:
            tok = nxt
            gen.append(nxt)
    if mesh is not None:
        out["stats"]["decode"] = mesh_collectives(mesh.stats)
        out["calls"]["decode"] = {op: dict(v["axes"])
                                  for op, v in mesh.stats.items()}
        out["layout"] = {k: step.layout[k] for k in (
            "cache", "cache_specs", "cache_batch_moved")}
        out["coord"] = {a: mesh.axis_index(a) for a in mesh.axis_names}
        out["mesh"] = dict(mesh.shape)
    out["tokens"] = to_np(torch.stack(gen, dim=1))
    out["cache"] = to_np(cache)
    return out


def cache_block(x, spec, coord: dict, shape: dict):
    """The block of a whole cache leaf ``x`` (numpy) that ``spec`` gives the
    rank at ``coord`` (axis -> index) of a mesh of ``shape`` (axis ->
    size)."""
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        n, j = 1, 0
        for a in axes:
            n, j = n * shape[a], j * shape[a] + coord[a]
        w = x.shape[d] // n
        x = x.take(range(j * w, (j + 1) * w), axis=d)
    return x


def _build(cfg):
    from repro_torch.models import build_model

    return build_model(cfg)


def dryrun_rank(rank: int) -> dict:
    """One round of each of :data:`DRYRUN_ROUNDS` on this rank: the mesh's
    collectives in it (calls and bytes by op); then each serving run of
    :data:`DRYRUN_SERVE` and :data:`DRYRUN_SERVE_MOE` (:func:`serve_run`)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.trace_analysis import mesh_collectives

    out = {}
    for name, shape, mode, arch in DRYRUN_ROUNDS:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        init_fn, step = dryrun_trainer(mesh, mode, "cpu", arch)
        state = init_fn(0)
        batch = dryrun_batch(mesh, mode, "cpu")
        mesh.reset_stats()
        state, m = step(state, batch, key=DRYRUN_KEY)
        out[name] = {"stats": mesh_collectives(mesh.stats),
                     "loss": float(m["loss"])}
    for arch, shape in DRYRUN_SERVE:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        out[(arch, shape)] = serve_run(arch, mesh)
    for arch, shape, p, s in DRYRUN_SERVE_MOE:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        out[(arch, shape, p, s)] = serve_run(arch, mesh, prompt=p, steps=s)
    return out


# ---------------------------------------------------------------------------
# the partitioned products on (1, 2): loss and grads of each rank's block
# ---------------------------------------------------------------------------

def partition_cfg(arch: str, over: dict):
    """Reduced ``arch`` in f32 with the fields of ``over`` replaced: the
    port's config of a partitioned case (the test builds JAX's alike)."""
    import dataclasses

    from repro_torch.models import get_config

    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32", **over)


def partitioned_rank(rank: int, cases: list, shape=(1, 2)) -> dict:
    """Each case (``name``, ``arch``, ``over``, ``params``: the numpy
    worker-led tree, ``batch``, and optionally ``opt``, a ``REPRO_OPT``
    value, and ``scan_chunk``, a ``REPRO_SCAN_CHUNK``) on the (1, 2)
    grid (or the (1, m) ``shape``): the rank's blocks of the params under
    the trainer's layout and partition plan, the loss (W,), the gradient
    of each block, the mesh's collectives in the forward and in the backward
    (calls by axis), and the forward's MoE routing (``moe.record_routing``:
    each dispatch's picks and kept pairs)."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core.packing import build_shard_packspec, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import shard_dims_2d
    from repro_torch.models import build_model, moe
    from repro_torch.models import gather as G
    from repro_torch.models.partition import partition_for
    from repro_torch.tree import tree_map

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    j = mesh.axis_index("model")
    out = {}
    for case in cases:
        model = build_model(partition_cfg(case["arch"], case["over"]))
        full = model_params_from_numpy(case["params"], device="cpu")
        md, fd = shard_dims_2d(full, model.cfg, mesh, multi_pod=False)
        sspec = build_shard_packspec(full, md, shape[1], batch_dims=1,
                                     fsdp_dims=fd, n_fsdp=1)
        part = partition_for(model.cfg, mesh)
        plan = G.make_plan(full, sspec.shard_dims, sspec.fsdp_dims, mesh,
                           part=part)
        theta = tree_map(lambda l: l.clone().requires_grad_(),
                         shard_tree(sspec, full, j))
        batch = {k: t(v) for k, v in case["batch"].items()}

        def calls():
            return {op: dict(s["axes"]) for op, s in mesh.stats.items()}
        mesh.reset_stats()
        with G.gathering(plan), opt_env(case.get("opt")), \
                env_var("REPRO_SCAN_CHUNK", case.get("scan_chunk")):
            with moe.record_routing() as routing:
                loss, _ = model.loss(G.gather_params(theta), batch)
            fwd = calls()
            mesh.reset_stats()
            loss.sum().backward()
        out[case["name"]] = {
            "j": j, "loss": to_np(loss), "fwd": fwd, "bwd": calls(),
            "grads": to_np(tree_map(lambda l: l.grad, theta)),
            "routing": to_np(routing),
            "part": None if part is None else part._replace(mesh=None)}
    return out


def exchange_rank(rank: int) -> dict:
    """``Partition.inner_xz`` on the (1, 2) grid (reduced falcon-mamba's
    plan) for a (3, 8) ``[x | z]`` plane of d_inner 4 made from seed 0:
    the rank's block of it (columns ``[4j, 4j + 4)``) exchanged, the x and
    z it receives, and the gradient its block gets back for a loss that
    weighs each received entry by a plane ``a`` (seed 0, after the
    plane)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.partition import partition_for

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    part = partition_for(partition_cfg("falcon-mamba-7b", {}), mesh)
    j = part.index
    g = torch.Generator().manual_seed(0)
    full = torch.randn((3, 8), generator=g)
    a = torch.randn((3, 8), generator=g)
    xz = full[:, 4 * j:4 * j + 4].clone().requires_grad_()
    mesh.reset_stats()
    x, z = part.inner_xz(xz)
    ((x * a[:, 2 * j:2 * j + 2]).sum()
     + (z * a[:, 4 + 2 * j:6 + 2 * j]).sum()).backward()
    return {"j": j, "full": to_np(full), "a": to_np(a), "x": to_np(x),
            "z": to_np(z), "grad": to_np(xz.grad),
            "calls": {op: dict(v["axes"]) for op, v in mesh.stats.items()}}


def partitioned_ssm_rank(rank: int, cases: list) -> dict:
    """:func:`partitioned_rank`'s cases, then :func:`exchange_rank`'s
    (under ``"exchange"``), on one mesh's group."""
    out = partitioned_rank(rank, cases)
    out["exchange"] = exchange_rank(rank)
    return out


@contextlib.contextmanager
def env_var(name: str, value):
    """The environment variable ``name`` set to ``str(value)`` in the
    block (left as it is where None)."""
    prev = os.environ.get(name)
    if value is not None:
        os.environ[name] = str(value)
    try:
        yield
    finally:
        if value is not None:
            if prev is None:
                os.environ.pop(name)
            else:
                os.environ[name] = prev


def opt_env(value):
    """``REPRO_OPT`` set to ``value`` in the block (left as it is where
    None)."""
    return env_var("REPRO_OPT", value)


# ---------------------------------------------------------------------------
# partitioned serving (tests/test_torch_serve_partitioned.py)
# ---------------------------------------------------------------------------

#: planted vocab-parallel rows for ``Partition.argmax_vocab`` on (1, 2):
#: (name, the whole row's length, the indices set to the row's max)
ARGMAX_TIES = (("straddling", 16, (5, 11)), ("rank 1 alone", 16, (9, 14)),
               ("rank 0 alone", 16, (2, 3)), ("first and last", 16, (0, 15)))


def argmax_rows() -> torch.Tensor:
    """(len(ARGMAX_TIES), 16) rows below 1 with 2.0 at each case's
    indices."""
    g = torch.Generator().manual_seed(9)
    rows = torch.rand((len(ARGMAX_TIES), 16), generator=g)
    for i, (_, _, idx) in enumerate(ARGMAX_TIES):
        rows[i, list(idx)] = 2.0
    return rows


def serve_partitioned_rank(rank: int, shape, cases: list,
                           params: dict) -> dict:
    """Each case (name, arch, config fields replaced, batch, prompt,
    steps) served on a ``shape`` (data, model) mesh (:func:`serve_run`)
    from ``params[name]`` (a numpy tree), and on (1, 2) the greedy tokens
    of :func:`argmax_rows` (each rank its vocab half) and of 64 random
    rows."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.partition import partition_for

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    out = {name: serve_run(arch, mesh, over=over, batch=b, prompt=p,
                           steps=st, params=params[name])
           for name, arch, over, b, p, st in cases}
    if tuple(shape) == (1, 2):
        part = partition_for(_f32_model("granite-8b").cfg, mesh)
        j = mesh.axis_index("model")
        g = torch.Generator().manual_seed(10)
        rand = torch.randn((64, 16), generator=g)
        half = slice(j * 8, (j + 1) * 8)
        out["argmax"] = {
            "planted": to_np(part.argmax_vocab(argmax_rows()[:, half])),
            "random": to_np(part.argmax_vocab(rand[:, half])),
            "random_rows": to_np(rand)}
    return out


# ---------------------------------------------------------------------------
# the MoE family's partitioned serving
# (tests/test_torch_serve_partitioned_moe.py)
# ---------------------------------------------------------------------------

def serve_routed(arch: str, mesh=None, **kw) -> dict:
    """:func:`serve_run` with every MoE dispatch recorded
    (``moe.record_routing``: the prefill's, then each step's, each with
    its picks and kept pairs) under ``"routing"``."""
    from repro_torch.models import moe

    with moe.record_routing() as seen:
        out = serve_run(arch, mesh, **kw)
    out["routing"] = to_np(seen)
    return out


def serve_moe_rank(rank: int, cases: list, params: dict) -> dict:
    """Each case (name, arch, config fields replaced, batch, prompt,
    steps) served on the (1, 2) grid from ``params[name]`` (a numpy tree)
    with its MoE dispatches recorded (:func:`serve_routed`; none for a
    family without experts)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    return {name: serve_routed(arch, mesh, over=over, batch=b, prompt=p,
                               steps=st, params=params[name])
            for name, arch, over, b, p, st in cases}


# ---------------------------------------------------------------------------
# the enc-dec family on the model axis
# (tests/test_torch_partitioned_encdec.py,
# tests/test_torch_serve_partitioned_encdec.py)
# ---------------------------------------------------------------------------

def encdec_frames(batch: int, frames: int, d: int,
                  lead: tuple = ()) -> torch.Tensor:
    """The enc-dec's stub frame embeddings, (*lead, batch, frames, d) f32
    (seed 6)."""
    g = torch.Generator().manual_seed(6)
    return torch.randn(lead + (batch, frames, d), generator=g)


def _encdec_trainer(mesh, over: dict, W: int):
    """Reduced seamless-m4t-medium in f32 (the fields of ``over``
    replaced) on a noise-free link: one sgd step at 1e-2, ρ 0.5, 40 dB,
    coherence 10 (no redraw in the replayed rounds), on ``mesh`` and the
    CPU."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    return make_fl_train(
        _build(partition_cfg("seamless-m4t-medium", over)),
        FLConfig(n_workers=W, local_steps=1, local_lr=1e-2),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10,
                      noisy=False),
        mesh=mesh, device="cpu")


def _rank_block(st1, stm, sspec, j: int):
    """The rank's block of one device's state ``st1`` as the mesh trainer
    holds it (``stm``'s form): θ, Θ and the optimizer's trees cut by
    ``sspec``, λ and h packed shard-major and narrowed to the rank's
    columns, the channel's age and the step as they are."""
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import (build_packspec, pack_shard_global,
                                          unpack)
    from repro_torch.core.packing import shard_tree
    from repro_torch.tree import tree_map

    spec1 = build_packspec(st1.theta, batch_dims=1)
    dl = sspec.d_local

    def plane(z):
        return Complex(*(pack_shard_global(sspec, unpack(spec1, x,
                                                         cast=False))
                         [:, j * dl:(j + 1) * dl].contiguous()
                         for x in (z.re, z.im)))

    def cut(tree):
        return tree_map(lambda x: x.clone(), shard_tree(sspec, tree, j))
    opt = st1.opt._replace(mu=cut(st1.opt.mu), nu=cut(st1.opt.nu))
    return stm._replace(theta=cut(st1.theta), Theta=cut(st1.Theta),
                        lam=plane(st1.lam), opt=opt, step=st1.step,
                        chan=stm.chan._replace(h=plane(st1.chan.h),
                                               age=st1.chan.age))


def encdec_rounds_rank(mesh, over: dict, batch: dict, rounds: int) -> dict:
    """``rounds`` noise-free replicated rounds of reduced seamless on
    ``mesh`` (every model rank the whole batch: the tokens and the frames
    alike), each from the rank's block of one device's state before it
    (:func:`_rank_block`: the mesh draws its blocks of h from keys of its
    own, so along their own trajectories the runs part after round 1),
    and one device's round from that state, with round keys 1, 2, …: the
    losses, and each round's Θ block of the rank and of one device."""
    from repro_torch.core.packing import shard_tree

    b = {k: t(v) for k, v in batch.items()}
    W = b["tokens"].shape[0]
    init_fn, step = _encdec_trainer(mesh, over, W)
    init1, step1 = _encdec_trainer(None, over, W)
    stm, st1 = init_fn(0), init1(0)
    sspec = init_fn.layout["sspec"]
    j = mesh.axis_index("model")
    out = {"losses": [], "losses_one": [], "Theta": [], "Theta_one": []}
    for r in range(rounds):
        stm = _rank_block(st1, stm, sspec, j)
        stm, m = step(stm, b, key=r + 1)
        st1, m1 = step1(st1, b, key=r + 1)
        out["losses"].append(float(m["loss"]))
        out["losses_one"].append(float(m1["loss"]))
        out["Theta"].append(to_np(stm.Theta))
        out["Theta_one"].append(to_np(shard_tree(sspec, st1.Theta, j)))
    return out


def partitioned_encdec_rank(rank: int, cases: list, shape,
                            rounds: Optional[dict] = None) -> dict:
    """:func:`partitioned_rank`'s cases on the (1, m) ``shape``, then, with
    ``rounds`` (``over``, ``batch``, ``rounds``), :func:`encdec_rounds_rank`
    on the same mesh (under ``"rounds"``)."""
    from repro_torch.launch.mesh import make_mesh

    out = partitioned_rank(rank, cases, shape)
    if rounds is not None:
        out["rounds"] = encdec_rounds_rank(
            make_mesh(shape, ("data", "model"), "cpu"), **rounds)
    return out


def serve_encdec_run(mesh, *, over: dict, batch: int, prompt: int,
                     steps: int, frames: int, params) -> dict:
    """Reduced seamless (f32, ``over`` replaced, the numpy ``params``)
    served on ``mesh`` as :func:`serve_run` serves a family, over
    ``frames`` stub frames (:func:`encdec_frames`): the prefill's last
    logits (the tokens and the frames), the cross cache filled by
    ``serve_step.prefill_cross`` (the rank's block), the prompt ingested a
    token at a time and ``steps`` tokens generated (each step's logits,
    the rank's vocab columns); the collectives of the prefill, of the
    cross prefill and of the last step, the cache and its layout."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.serve import make_prefill, make_serve_step

    model = _build(partition_cfg("seamless-m4t-medium", over))
    cfg = model.cfg
    full = model_params_from_numpy(params, device="cpu")
    rows = serve_rows(mesh, batch)
    toks = serve_tokens(cfg.vocab_size, batch, prompt)[rows]
    fr = encdec_frames(batch, frames, cfg.d_model)[rows]

    def calls():
        return {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    out: dict = {"logits_steps": [], "calls": {}}
    prefill = make_prefill(model, mesh)
    pp = prefill.shard(full)
    mesh.reset_stats()
    out["logits"] = to_np(prefill(pp, {"tokens": toks, "frames": fr}))
    out["calls"]["prefill"] = calls()

    def observed(p, c, tok, pos):
        logits, c = model.decode_step(p, c, tok, pos)
        out["logits_steps"].append(to_np(logits))
        return logits, c
    step = make_serve_step(model._replace(decode_step=observed), mesh)
    params = step.shard(full)
    cache = step.init_cache(batch, prompt + steps, device="cpu",
                            n_frames=frames)
    mesh.reset_stats()
    ck, cv = step.prefill_cross(params, fr)
    out["calls"]["cross"] = calls()
    out["cross"] = to_np({"cross_k": ck, "cross_v": cv})
    cache["cross_k"].copy_(ck)
    cache["cross_v"].copy_(cv)
    tok, gen = toks[:, 0], []
    for i in range(prompt + steps - 1):
        mesh.reset_stats()
        nxt, cache = step(params, cache, tok, i)
        if i + 1 < prompt:
            tok = toks[:, i + 1]
        else:
            tok = nxt
            gen.append(nxt)
    out["calls"]["decode"] = calls()
    out["layout"] = {k: step.layout[k] for k in (
        "cache", "cache_specs", "cache_batch_moved")}
    part = step.layout["cache_part"]
    out["cross_layout"] = part.cross_cache
    out["coord"] = {a: mesh.axis_index(a) for a in mesh.axis_names}
    out["mesh"] = dict(mesh.shape)
    out["tokens"] = to_np(torch.stack(gen, dim=1))
    out["cache"] = to_np(cache)
    return out


def serve_encdec_rank(rank: int, shape, cases: list, params: dict) -> dict:
    """Each case (name, config fields replaced, batch, prompt, steps,
    frames) served on the ``shape`` (data, model) mesh
    (:func:`serve_encdec_run`) from ``params[name]``."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    return {name: serve_encdec_run(mesh, over=over, batch=b, prompt=p,
                                   steps=st, frames=f, params=params[name])
            for name, over, b, p, st, f in cases}
