"""Gloo ranks on the CPU for the port's mesh tests: :func:`spawn` starts
``world`` processes that join one process group through a ``FileStore``
under the test's temporary directory (no fixed port, so parallel pytest
workers never collide), each with one intra-op thread, runs a function of
this module (or of another module that imports no JAX) in each, and
returns each rank's pickled result.  The rank functions import only torch
and the port, so a spawned rank never pays for JAX."""
from __future__ import annotations

import os
import pickle
import traceback

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
              "resume": resume_rank, "scenario": scenario_rank}[kind]
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
