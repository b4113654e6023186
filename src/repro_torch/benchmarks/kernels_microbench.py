"""Microbenchmarks of the port's kernels and transport: the torch twin of
``benchmarks/kernels_microbench.py``, with its function names, sections,
return keys and flags.

Each section runs on the card unless the caller passes ``device="cpu"``
(``--device cpu``), where every kernel wrapper takes its plain version from
``kernels/ref.py``.  The hand-written kernels the sections launch on the
card: B1, B2, B3, B4, B5, B6, B8, B9, B10 and B11.

Keys are the reference's, except that the token ``jnp`` becomes ``plain``
and ``pallas`` becomes ``kernel`` wherever it stands in a key
(``jnp_us_per_round`` → ``plain_us_per_round``, ``max_abs_err_vs_jnp`` →
``max_abs_err_vs_plain``): the reference's jnp chain is the port's plain
chain, built from ``kernels/ref.py`` on the same device's tensors, and its
Pallas route is the port's hand-written kernels.  The transport keeps
refusing the backend ``"jnp"`` (``core/transport.check_backend_choice``);
the plain chains here are written out, never reached through it.

Timings:

* ``_time`` — the median wall µs of a call, the reference's ``iters`` and
  ``warmup``; each call ends in ``torch.cuda.synchronize()`` on the card.
* The plain chain (``plain_*``, ``ref_jit_us_per_call``,
  ``naive_plain_grad_us_per_call``) and the kernel column a ratio holds it
  against (``kernel_us_per_call``, ``interpret_grad_us_per_call``) are
  timed on the card by ``common.time_ms``, the CUDA-event timer of
  ``chip_smoke.py``'s kernel table (device time behind a GPU spin); on the
  CPU by ``_time``.

Counting: a ``*_dispatches`` key counts the hand-written kernels' wrapper
calls in the section's call — launches on the card (``kernels.build
.launches``), calls that take the plain version on the CPU (through
``kernels.build.set_plain_hook``) — but for the trainer's
``loop_n_dispatches`` and ``scan_n_dispatches``, which count its round and
block calls, as the reference's do.  An ``*_uplink_entries_*`` key counts
the calls of a receive wrapper (B2, B6/B7 or B8): one per uplink, as the
reference counts its outermost receive entry points.

The two mesh sections spawn their own gloo ranks (two on (1, 2), four on
(1, 2, 2)), on the one card or on the CPU.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_microbench \\
        [--device cpu] --out BENCH_torch_transport.json
    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_microbench \\
        [--device cpu] --phy --attn-bwd --shard-local   # BENCH_torch_*.json
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.benchmarks import common
from repro_torch.core import transport
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.channel import ChannelConfig, rayleigh
from repro_torch.core.cplx import Complex, czero
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ota, ref
from repro_torch.tree import tree_leaves, tree_map, tree_stack

Tensor = torch.Tensor

N = 1 << 20

#: the receive wrappers: one call is one uplink entry
UPLINK_WRAPPERS = ("ota_receive", "ota_receive_masked", "ota_round_stats",
                   "ota_round_theta")

#: seconds a spawn of mesh ranks may take before they are killed
SPAWN_TIMEOUT = 600


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _time(fn: Callable, iters: int = 10, warmup: int = 3) -> float:
    """Median wall time per call in µs.

    ``warmup`` calls absorb the first launches and allocations, then each of
    ``iters`` calls is timed on its own with ``time.perf_counter`` and the
    MEDIAN is reported.  Each call ends in ``torch.cuda.synchronize()`` on
    the card, so the time is the work's and not its enqueue's."""
    for _ in range(warmup):
        fn()
        _sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples) * 1e6)


def _device_us(fn: Callable, dev: torch.device, iters: int = 10,
               warmup: int = 3) -> float:
    """µs of a call of the plain chain, or of the kernel column a ratio
    holds it against: on the card the median device time of ``iters``
    CUDA-event timings (``common.time_ms``), elsewhere :func:`_time`."""
    if dev.type == "cuda":
        return 1e3 * common.time_ms(fn, runs=iters, warmup=warmup)
    return _time(fn, iters, warmup)


@contextlib.contextmanager
def _counted():
    """Count the kernel wrappers' calls inside the block, by wrapper name:
    the launches on the card and, on CPU tensors, the calls that take the
    plain version.  The counter fills when the block exits."""
    counts: collections.Counter = collections.Counter()
    before = collections.Counter(build.launches)

    def hook(name, fn, args, kwargs, flops, like):
        counts[name] += 1
        if prev is None:
            return fn(*args, **kwargs)
        return prev(name, fn, args, kwargs, flops, like)

    prev = build.set_plain_hook(hook)
    try:
        yield counts
    finally:
        build.set_plain_hook(prev)
        counts.update(build.launches - before)


def _uplink_entries(counts) -> int:
    return sum(counts[n] for n in UPLINK_WRAPPERS)


def _max_abs(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def _cplx_normal(gen, shape, scale: float = 0.3) -> Complex:
    dev = gen.device
    return Complex(scale * torch.randn(shape, generator=gen, device=dev),
                   scale * torch.randn(shape, generator=gen, device=dev))


def _flat_round_inputs(W: int, d: int, dev, key: int = 0):
    """θ ~ N(0, 1), λ with N(0, 0.3²) planes and Rayleigh h over (W, d)."""
    gen = rng.generator(key, dev)
    theta = torch.randn((W, d), generator=gen, device=dev)
    return theta, _cplx_normal(gen, (W, d)), rayleigh(gen, (W, d)), gen


def _plain_uplink(theta, lam, h, noise, rho, ccfg, mask=None) -> Tensor:
    """``transport.ota_uplink``'s chain from the plain versions: B1's,
    the min-α power scale, then B2's (B8's under ``mask``)."""
    s_re, s_im = ref.ota_modulate(theta, lam.re, lam.im, h.re, h.im, rho)
    inv_alpha = transport.power_scale(Complex(s_re, s_im), ccfg, mask=mask)
    if mask is None:
        return ref.ota_receive(s_re, s_im, h.re, h.im, noise, inv_alpha)
    return ref.ota_receive_masked(s_re, s_im, h.re, h.im, mask, noise,
                                  inv_alpha)


# ---------------------------------------------------------------------------
# B1 against its plain version
# ---------------------------------------------------------------------------

def microbench(device="cuda") -> dict:
    """B1 (``ota_modulate``) at N = 2²⁰ against its plain version: the
    largest error, the plain version's µs and the traffic model behind the
    fusion; on the card also B1's own µs (``kernel_us_per_call``)."""
    dev = resolve_device(device)
    gen = rng.generator(0, dev)
    args = [torch.randn(N, generator=gen, device=dev) for _ in range(5)]
    want = ref.ota_modulate(*args, 0.5)
    got = ota.ota_modulate(*args, 0.5)
    mod_err = _max_abs(zip(got, want))
    ref_us = _device_us(lambda: ref.ota_modulate(*args, 0.5), dev)

    # HBM-traffic model (bytes/element): naive = 5 reads + 2 writes per plane
    # with ~3 intermediate materialisations; fused = 5 reads + 2 writes.
    naive_traffic = (5 + 2 + 6) * 4
    fused_traffic = (5 + 2) * 4
    out = {
        "n_elements": N,
        "modulate_max_err_vs_ref": mod_err,
        "ref_jit_us_per_call": ref_us,
        "traffic_bytes_per_elem_naive": naive_traffic,
        "traffic_bytes_per_elem_fused": fused_traffic,
        "predicted_fusion_speedup": naive_traffic / fused_traffic,
    }
    if dev.type == "cuda":
        out["kernel_us_per_call"] = _device_us(
            lambda: ota.ota_modulate(*args, 0.5), dev)
    return out


# ---------------------------------------------------------------------------
# transport layer: composed and fused uplink, loop-vs-scan round driver
# ---------------------------------------------------------------------------

def _uplink_case(W: int, d: int, label: str, dev) -> dict:
    """One uplink at one model scale: the plain chain, the composed kernel
    route (``ota_uplink``: B1, B2) and the fused one (``ota_round_fused``:
    B6, B3)."""
    theta, lam, h, gen = _flat_round_inputs(W, d, dev)
    ccfg = ChannelConfig(n_workers=W, noisy=True)
    noise = transport.matched_filter_noise_re(gen, (d,), ccfg)

    def plain():
        return _plain_uplink(theta, lam, h, noise, 0.5, ccfg)

    def composed():
        return transport.ota_uplink(theta, lam, h, noise, 0.5, ccfg)[0]

    def fused():
        return transport.ota_round_fused(theta, lam, h, noise, 0.5, ccfg)[0]

    out = {"label": label, "W": W, "d": d}
    out["plain_us_per_round"] = _device_us(plain, dev)
    out["max_abs_err_vs_plain"] = _max_abs([(composed(), plain())])
    out["kernel_us_per_round"] = _time(composed)
    out["fused_us_per_round"] = _time(fused)
    # fused against composed, both on the kernel route
    out["speedup_fused_over_composed"] = (
        out["kernel_us_per_round"] / out["fused_us_per_round"])
    # the elementwise passes the fusion collapses (modulate, scale, mul,
    # sum, noise-add, div, eps-max -> one kernel): traffic model as above
    out["hbm_passes_unfused"] = 5
    out["hbm_passes_fused"] = 1
    return out


def _trainer_case(n_rounds: int, eval_every: int, dev) -> dict:
    """The loop driver against the scan (block) driver on the paper's linreg
    task.

    * ``*_seconds_end_to_end`` — one ``train`` call each, the card
      synchronised at its end.
    * ``compiled_dispatch`` — single rounds (``round``) against blocks of a
      coherence block's rounds (``scan_rounds``), issued back to back with
      no host reads: the per-round dispatches the block driver saves (n
      against n / coherence).
    """
    from repro_torch.train.fl_trainer import train

    task = common.make_linreg_task(0, device=dev)
    alg, solver = common.linreg_algorithm("afadmm", task)
    block = alg.ccfg.coherence_iters

    out = {"n_rounds": n_rounds, "workers": common.LINREG_WORKERS,
           "coherence_iters": block}
    hist = {}
    for driver in ("loop", "scan"):
        t0 = time.time()
        hist[driver] = train(alg, task.theta0, solver, task.grad_fn,
                             n_rounds, 1, eval_fn=task.eval_fn,
                             eval_every=eval_every, driver=driver)
        _sync()
        out[f"{driver}_seconds_end_to_end"] = time.time() - t0
    out["speedup_scan_over_loop_end_to_end"] = \
        out["loop_seconds_end_to_end"] / out["scan_seconds_end_to_end"]

    st = alg.init(1, task.theta0)

    def one_round(s, r):
        return alg.round(rng.fold_in(0, r), s, solver, task.grad_fn)[0]

    def one_block(s, c):
        return alg.scan_rounds(1, s, solver, task.grad_fn,
                               range(c * block, (c + 1) * block))[0]

    one_round(st, 0)                  # first launches
    one_block(st, 0)
    _sync()
    # both branches run exactly n_eff rounds, so the speedup compares equal
    # work even when the coherence block doesn't divide n_rounds
    n_chunks = n_rounds // block
    n_eff = n_chunks * block
    t0 = time.time()
    s = st
    for r in range(n_eff):
        s = one_round(s, r)
    _sync()
    t_loop = time.time() - t0
    t0 = time.time()
    s = st
    for c in range(n_chunks):
        s = one_block(s, c)
    _sync()
    t_scan = time.time() - t0
    out["compiled_dispatch"] = {
        "n_rounds_timed": n_eff,
        "loop_n_dispatches": n_eff, "loop_seconds": t_loop,
        "scan_n_dispatches": n_chunks, "scan_seconds": t_scan,
        "speedup_scan_over_loop": t_loop / t_scan,
    }

    out["history_bitwise_equal"] = bool(
        hist["loop"].loss == hist["scan"].loss
        and hist["loop"].channel_uses == hist["scan"].channel_uses)
    return out


def transport_microbench(device="cuda") -> dict:
    dev = resolve_device(device)
    d_mlp = int(common.make_mlp_task(0, device=dev).d)
    return {
        "uplink_linreg": _uplink_case(10, 6, "linreg (paper Sec. 5)", dev),
        "uplink_mlp": _uplink_case(common.MLP_WORKERS, d_mlp,
                                   "MLP (FAST scale)", dev),
        # eval_every=1 is the figure benchmarks' cadence (one eval host
        # read a round in the loop driver, the worst case the block driver
        # removes)
        "trainer_linreg_300r": _trainer_case(300, 1, dev),
        "optimised_metric": "uplink_mlp.speedup_fused_over_composed",
    }


# ---------------------------------------------------------------------------
# packed vs per-leaf tree uplink (one fused receive a round)
# ---------------------------------------------------------------------------

def _tree_uplink_case(label: str, theta, lam, h, W: int, dev) -> dict:
    """The packed tree round (``ota_tree_round``: one B6 pass) against the
    per-leaf one (one B2 a leaf) on one multi-leaf model."""
    from repro_torch.core.packing import build_packspec
    from repro_torch.core.tree_ota import ota_tree_round

    acfg = AdmmConfig(rho=0.5, power_control=True)
    ccfg = ChannelConfig(n_workers=W, noisy=True)
    spec = build_packspec(theta, batch_dims=1)
    noise = transport.matched_filter_noise_re(rng.generator(0, dev),
                                              (spec.d,), ccfg)
    out = {"label": label, "W": W, "n_leaves": len(tree_leaves(theta)),
           "d": spec.d}
    for name, packed in (("packed", True), ("per_leaf", False)):
        def round_fn(packed=packed):
            return ota_tree_round(theta, lam, h, noise, acfg, ccfg,
                                  packed=packed)[0]

        with _counted() as n:
            round_fn()
        out[f"{name}_uplink_entries_per_round"] = _uplink_entries(n)
        out[f"{name}_us_per_round"] = _time(round_fn, iters=30)
    out["speedup_packed_over_per_leaf"] = (
        out["per_leaf_us_per_round"] / out["packed_us_per_round"])
    out["optimised_metric"] = "speedup_packed_over_per_leaf"
    return out


def _mlp_trees(W: int, dev):
    """The 64-32-16-10 MLP's weight and bias leaves for W workers, zero
    duals and a Rayleigh block a leaf."""
    gen = rng.generator(1, dev)
    sizes = (64, 32, 16, 10)
    theta = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        theta[f"w{i}"] = torch.randn((W, a, b), generator=gen, device=dev)
        theta[f"b{i}"] = torch.randn((W, b), generator=gen, device=dev)
    lam = tree_map(lambda l: czero(tuple(l.shape), device=dev), theta)
    h = tree_map(lambda l: rayleigh(gen, tuple(l.shape)), theta)
    return theta, lam, h


def _transformer_trees(W: int, dev):
    """Reduced granite-8b's parameters for W workers (one init each), zero
    f32 duals and a Rayleigh block a leaf."""
    from repro_torch.core.tree_ota import init_channel_tree
    from repro_torch.models import get_model

    model = get_model("granite-8b", reduced=True)
    theta = tree_stack([model.init(rng.fold_in(2, w), device=dev)
                        for w in range(W)])
    lam = tree_map(lambda l: czero(tuple(l.shape), device=dev), theta)
    h = init_channel_tree(3, theta).h
    return theta, lam, h


def packed_microbench(device="cuda") -> dict:
    dev = resolve_device(device)
    W = 4
    mlp = _tree_uplink_case("MLP 64-32-16-10", *_mlp_trees(W, dev), W, dev)
    tfm = _tree_uplink_case("transformer granite-8b (reduced)",
                            *_transformer_trees(W, dev), W, dev)
    return {"uplink_mlp_tree": mlp, "uplink_transformer_tree": tfm}


# ---------------------------------------------------------------------------
# fused one-pass OTA round: wall-clock vs composed + leafwise
# ---------------------------------------------------------------------------

def _tree_err(a, b) -> float:
    return _max_abs(zip(tree_leaves(a), tree_leaves(b)))


def fused_round_microbench(device="cuda") -> dict:
    """On the persistently packed state of reduced granite-8b (W = 4) the
    fused receive (``ota_round_fused``: B6 then B3, one uplink entry a
    round) against the composed packed chain (B1, B2) and the leafwise
    round (B1, B2 a leaf), with the worker-chunk sweep; then a W = 256
    round streamed in cohorts of 32 (signal planes of one cohort live at a
    time)."""
    from repro_torch.core.packing import build_packspec, pack_cplx
    from repro_torch.core.tree_ota import (ota_tree_round,
                                           ota_tree_round_packed_state)

    dev = resolve_device(device)
    W = 4
    theta, lam, h = _transformer_trees(W, dev)
    spec = build_packspec(theta, batch_dims=1)
    lam_p = pack_cplx(spec, lam)
    h_p = pack_cplx(spec, h)
    acfg = AdmmConfig(rho=0.5, power_control=True, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, noisy=True)
    noise = transport.matched_filter_noise_re(rng.generator(0, dev),
                                              (spec.d,), ccfg)

    def packed_round(fused, worker_chunk=None):
        return lambda: ota_tree_round_packed_state(
            theta, lam_p, h_p, noise, acfg, ccfg, spec, fused=fused,
            worker_chunk=worker_chunk)[0]

    def leaf_round():
        return ota_tree_round(theta, lam, h, noise, acfg, ccfg,
                              packed=False)[0]

    out = {"W": W, "d": spec.d, "n_leaves": len(tree_leaves(theta))}
    with _counted() as n:
        packed_round(None)()
    out["fused_uplink_entries_per_round"] = _uplink_entries(n)

    # worker_chunk is the cohort the fused pass streams (a (chunk, D)
    # working set instead of (W, D)); 0 is the monolithic pass
    T_ref = packed_round(None)()
    sweep = {}
    for wc in (0, 1, 2):
        j = packed_round(None, worker_chunk=wc)
        err = _tree_err(T_ref, j())
        if err > 1e-4:
            raise RuntimeError(f"fused_round: worker_chunk {wc} is {err} "
                               f"from the monolithic pass")
        sweep[wc] = _time(j, iters=30)
    best_chunk = min(sweep, key=sweep.get)
    out["fused_chunk_sweep_us"] = {str(k): v for k, v in sweep.items()}
    out["fused_worker_chunk"] = best_chunk
    out["fused_packed_us_per_round"] = sweep[best_chunk]
    out["fused_monolithic_us_per_round"] = sweep[0]

    j_comp = packed_round(False)
    out["composed_max_abs_err_vs_fused"] = _tree_err(T_ref, j_comp())
    out["composed_packed_us_per_round"] = _time(j_comp, iters=30)
    out["leafwise_us_per_round"] = _time(leaf_round, iters=30)

    out["speedup_fused_over_composed"] = (
        out["composed_packed_us_per_round"]
        / out["fused_packed_us_per_round"])
    out["speedup_fused_over_leafwise"] = (
        out["leafwise_us_per_round"] / out["fused_packed_us_per_round"])

    # W=256 cohort-streamed round on flat planes: the scale the monolithic
    # pass cannot hold at O(W·D) signal memory
    Wb, db, chunk = 256, 1 << 15, 32
    tb, lb, hb, gb = _flat_round_inputs(Wb, db, dev, key=1)
    cb = ChannelConfig(n_workers=Wb, noisy=True)
    nb = transport.matched_filter_noise_re(gb, (db,), cb)
    out["w256_streamed"] = {
        "W": Wb, "d": db, "worker_chunk": chunk,
        "us_per_round": _time(lambda: transport.ota_round_fused(
            tb, lb, hb, nb, 0.5, cb, worker_chunk=chunk)[0], iters=5),
        "peak_signal_plane_elems": 4 * chunk * db,
        "monolithic_signal_plane_elems": 4 * Wb * db,
    }
    out["optimised_metric"] = "speedup_fused_over_composed"
    return out


# ---------------------------------------------------------------------------
# shard-local packed uplink (model-parallel meshes)
# ---------------------------------------------------------------------------

def _spawn(fn: Callable, world: int, dev: torch.device, *args) -> List[dict]:
    """``[fn(dev, *args) on rank r]`` for ``world`` ranks spawned as
    processes of one process group (gloo: the ranks share the one card, or
    the CPU) that meet through a file store in a temporary directory; a
    rank's exception fails the call with its traceback.  On the card the
    kernels are built first, once, for the ranks to load."""
    import multiprocessing

    if dev.type == "cuda":
        build.build()
    with tempfile.TemporaryDirectory(prefix="kernels_microbench_") as out:
        store = "file://" + os.path.join(out, "store")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn.__name__, r, world, store, out,
                                   str(dev), args))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, SPAWN_TIMEOUT - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        res, errs = [], []
        for r, p in enumerate(procs):
            path = os.path.join(out, f"rank{r}.json")
            if not os.path.exists(path):
                errs.append(f"rank {r}: no result (exit code {p.exitcode})")
                continue
            with open(path) as f:
                res.append(json.load(f))
            if "error" in res[-1]:
                errs.append(f"rank {r}:\n{res[-1]['error']}")
    if errs:
        raise RuntimeError(f"{fn.__name__}: ranks failed:\n" + "\n".join(errs))
    return res


def _rank_main(fn_name: str, rank: int, world: int, store: str, out: str,
               device: str, args) -> None:
    """One spawned rank: join the group, run ``fn_name`` of this module and
    write its result (or its traceback) to ``out``."""
    import datetime
    import traceback

    from repro_torch.launch.mesh import init_distributed

    dev = torch.device(device)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        init_distributed(device, init_method=store, rank=rank,
                         world_size=world,
                         timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT))
        res = globals()[fn_name](dev, *args)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except Exception:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _agreed(res: List[dict], key: str):
    """The ranks' common value of ``key``; the sorted list where they
    differ."""
    vals = sorted({r[key] for r in res})
    return vals[0] if len(vals) == 1 else vals


def _shard_local_rank(dev, iters: int, warmup: int) -> dict:
    """One rank of :func:`shard_local_microbench` on the (1, 2) grid."""
    from repro_torch.core.packing import (build_shard_packspec,
                                          pack_shard_global_cplx, shard_tree)
    from repro_torch.core.tree_ota import (ota_tree_round_leafwise,
                                           ota_tree_round_shard_local,
                                           shard_coords)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import model_shard_dims
    from repro_torch.models import get_model

    W, n_shards = 4, 2
    mesh = make_mesh((1, n_shards), ("data", "model"), dev)
    model = get_model("granite-8b", reduced=True)
    theta, lam, h = _transformer_trees(W, dev)
    dims = model_shard_dims(theta, model.cfg, mesh, multi_pod=False)
    sspec = build_shard_packspec(theta, dims, n_shards, batch_dims=1)
    c = shard_coords(mesh, sspec)
    cols = slice(c.j * sspec.d_local, (c.j + 1) * sspec.d_local)

    def block(tree) -> Complex:
        p = pack_shard_global_cplx(sspec, tree)
        return Complex(p.re[:, cols].contiguous(), p.im[:, cols].contiguous())

    theta_l = tree_map(torch.clone, shard_tree(sspec, theta, c.j))
    lam_b, h_b = block(lam), block(h)
    acfg = AdmmConfig(rho=0.5, power_control=True, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, noisy=False)
    noise = torch.zeros(sspec.d_local, device=dev)
    leaf_noise = [torch.zeros(tuple(l.shape[1:]), device=dev)
                  for l in tree_leaves(theta)]

    def shard_round():
        return ota_tree_round_shard_local(theta_l, lam_b, h_b, noise, acfg,
                                          ccfg, sspec, mesh)

    def leaf_round():
        return ota_tree_round_leafwise(theta, lam, h, leaf_noise, acfg, ccfg)

    with _counted() as n:
        T_s, lam_s, m_s = shard_round()
    us_shard = _time(lambda: shard_round()[0], iters, warmup)
    T_l, lam_l, m_l = leaf_round()
    us_leaf = _time(lambda: leaf_round()[0], iters, warmup)
    lam_lb = block(lam_l)
    ia_s, ia_l = float(m_s["inv_alpha"]), float(m_l["inv_alpha"])
    return {
        "d": sspec.spec.d, "d_local": sspec.d_local, "d_pad": sspec.d_pad,
        "n_leaves": len(tree_leaves(theta)),
        "uplink_entries": _uplink_entries(n),
        "theta_err": _tree_err(T_s, shard_tree(sspec, T_l, c.j)),
        "lam_err": _max_abs([(lam_s.re, lam_lb.re), (lam_s.im, lam_lb.im)]),
        # held to rtol 1e-6: α⁻¹ sums each worker's energy per shard and
        # then over the grid, the leafwise round per leaf
        "inv_alpha_equal": abs(ia_s - ia_l) <= 1e-6 * abs(ia_l),
        "us_shard": us_shard, "us_leaf": us_leaf,
    }


def shard_local_microbench(device="cuda", iters: int = 10,
                           warmup: int = 3) -> dict:
    """Under a model-parallel (1, 2) mesh of two spawned ranks the
    shard-local round (``ota_tree_round_shard_local``) issues exactly ONE
    uplink entry (B6) per shard per round, and its noise-free output equals
    the leafwise oracle (``ota_tree_round_leafwise``, run whole on each
    rank) bit for bit, with λ/h in the shard-local (W, d_local) blocks end
    to end.  Reduced granite-8b, W = 4; the errors are the largest over the
    ranks, the times rank 0's (``iters`` and ``warmup`` of its
    :func:`_time`)."""
    dev = resolve_device(device)
    res = _spawn(_shard_local_rank, 2, dev, iters, warmup)
    r0 = res[0]
    return {
        "n_shards": 2, "W": 4, "n_leaves": r0["n_leaves"],
        "d": r0["d"], "d_local": r0["d_local"], "d_pad": r0["d_pad"],
        "uplink_entries_per_shard_per_round": _agreed(res, "uplink_entries"),
        "leafwise_receive_dispatches_per_round": r0["n_leaves"],
        "noise_free_max_abs_err_vs_leafwise": max(r["theta_err"]
                                                  for r in res),
        "noise_free_lam_max_abs_err_vs_leafwise": max(r["lam_err"]
                                                      for r in res),
        "inv_alpha_equal": all(r["inv_alpha_equal"] for r in res),
        "shard_local_us_per_round": r0["us_shard"],
        "leafwise_us_per_round": r0["us_leaf"],
        "speedup_shard_local_over_leafwise": r0["us_leaf"] / r0["us_shard"],
        "optimised_metric": "speedup_shard_local_over_leafwise",
    }


# ---------------------------------------------------------------------------
# sketched A-FADMM-CS on the shard-local packed transport
# ---------------------------------------------------------------------------

def _sketched_rank(dev, iters: int, warmup: int) -> dict:
    """One rank of :func:`sketched_microbench` on the (1, 2, 2) grid."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.models.registry import packed_param_count
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    mesh = make_mesh((1, 2, 2), ("data", "fsdp", "model"), dev)
    model = get_model("granite-8b", reduced=True)
    W, B, T = 4, 2, 16
    gen = rng.generator(0, dev)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (W, B, T),
                                     generator=gen, device=dev)}
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0)
    flcfg = FLConfig(mode="sketched", n_workers=W, local_steps=1,
                     local_lr=1e-2, sketch_ratio=16, sketch_lr=0.7,
                     scenario="deep-fade-truncation", h_min=0.8)
    init_fn, train_step = make_fl_train(model, flcfg, acfg, ccfg, mesh=mesh,
                                        device=dev)
    # the full-dim replicated round on the same mesh: the uplink the sketch
    # compresses away (paper Sec. 6, consensus in d_s instead of d)
    init_r, step_r = make_fl_train(
        model, FLConfig(mode="replicated", n_workers=W, local_steps=1,
                        local_lr=1e-2), acfg, ccfg, mesh=mesh, device=dev)

    st = init_fn(0)
    with _counted() as n:
        _, met = train_step(st, batch, key=0)
    us_round = _time(lambda: train_step(st, batch, key=0), iters, warmup)
    st_r = init_r(0)
    us_repl = _time(lambda: step_r(st_r, batch, key=0), iters, warmup)
    return {"d": packed_param_count(model.cfg),
            "d_s": int(st.lam.re.shape[-1]),
            "uplink_entries": _uplink_entries(n),
            "scenario": flcfg.scenario,
            "participation": float(met["participation"]),
            "loss": float(met["loss"]),
            "us_round": us_round, "us_repl": us_repl}


def sketched_microbench(device="cuda", iters: int = 5,
                        warmup: int = 3) -> dict:
    """A-FADMM-CS rides the packed OTA transport: one sketched round issues
    exactly ONE uplink entry (the fused receive) per shard per round while
    the codec encodes and decodes shard-locally on a (data, fsdp, model) =
    (1, 2, 2) mesh of four spawned ranks, and the ``deep-fade-truncation``
    scenario threads its (W,) participation mask into the sketched round.
    Reduced granite-8b, W = 4, B = 2, T = 16, ratio 16; ``d`` is the model's
    packed length, ``d_s`` the sketch's; times are rank 0's (``iters`` and
    ``warmup`` of its :func:`_time`)."""
    dev = resolve_device(device)
    res = _spawn(_sketched_rank, 4, dev, iters, warmup)
    r0 = res[0]
    d, d_s = _agreed(res, "d"), _agreed(res, "d_s")
    return {
        "W": 4, "n_fsdp": 2, "n_model": 2,
        "d": d, "d_s": d_s, "compression_ratio": r0["d"] / r0["d_s"],
        "uplink_entries_per_shard_per_round": _agreed(res, "uplink_entries"),
        "scenario": r0["scenario"],
        "participation": r0["participation"],
        "loss_finite": all(np.isfinite(r["loss"]) for r in res),
        "sketched_us_per_round": r0["us_round"],
        "replicated_us_per_round": r0["us_repl"],
        "speedup_sketched_over_replicated": r0["us_repl"] / r0["us_round"],
        "optimised_metric": "speedup_sketched_over_replicated",
    }


# ---------------------------------------------------------------------------
# fault guards: guarded-vs-unguarded round overhead + chaos smoke
# ---------------------------------------------------------------------------

def faults_microbench(device="cuda") -> dict:
    """The round health guard on a HEALTHY slot against the unguarded fused
    round (its output BITWISE the unguarded round's: the guard adds only
    its O(d) checks), and a chaos run (2 of 8 workers crashed, one
    persistent-NaN worker, bursts, under ``evict-retransmit``) that stays
    finite end to end."""
    from repro_torch.faults import FaultPlan, GuardConfig, guarded_ota_round
    from repro_torch.faults import guards as _guards
    from repro_torch.train.fl_trainer import train

    dev = resolve_device(device)
    W, d, rho = 8, 1 << 16, 0.5
    theta, lam, h, gen = _flat_round_inputs(W, d, dev)
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    noise = transport.matched_filter_noise_re(gen, (d,), ccfg)
    gcfg = GuardConfig(policy="evict-retransmit", snr_floor_db=-60.0)
    draws = _guards.draw(gcfg, 0, d, ccfg, dev, bursts=False)

    def unguarded():
        return transport.ota_round_fused(theta, lam, h, noise, rho, ccfg)[0]

    def guarded():
        return guarded_ota_round(theta, lam, h, noise, rho, ccfg, gcfg,
                                 draws=draws).Theta

    out = {"W": W, "d": d,
           "healthy_max_abs_err_vs_unguarded": _max_abs([(guarded(),
                                                          unguarded())])}
    out["unguarded_us_per_round"] = _time(unguarded, iters=30)
    out["guarded_us_per_round"] = _time(guarded, iters=30)
    out["guard_overhead_x"] = (out["guarded_us_per_round"]
                               / out["unguarded_us_per_round"])

    # chaos on the paper's linreg task: workers 1 and 2 of 8 crash (25%),
    # worker 0 uploads NaN planes every round (evicted), bursts force
    # retransmissions; the guarded run must stay finite
    task = common.make_linreg_task(0, n_workers=W, device=dev)
    alg, solver = common.linreg_algorithm("afadmm", task)
    fp = FaultPlan(crash_at=((3, 1), (6, 2)), nan_workers=1,
                   burst_prob=0.2, burst_std=5.0)
    # the chaos floor sits ABOVE the burst SNR (~-36 dB at std 5) so burst
    # rounds retransmit instead of being accepted corrupted; the healthy
    # receive SNR is ~40 dB, far above the floor
    chaos_guard = dataclasses.replace(gcfg, snr_floor_db=0.0)
    alg = dataclasses.replace(
        alg, acfg=dataclasses.replace(alg.acfg, flip_on_change=False),
        faults=fp, guard=chaos_guard)
    hist = train(alg, task.theta0, solver, task.grad_fn, 40, 1,
                 eval_fn=task.eval_fn, eval_every=10, driver="scan")
    out["chaos"] = {
        "n_rounds": 40, "crashed_workers": 2, "nan_workers": 1,
        "all_evals_finite": bool(np.all(np.isfinite(hist.loss))),
        "final_loss_gap": float(hist.loss[-1]),
        "alive_final": float(hist.extra["fault/alive"][-1]),
        "guard_evictions": float(sum(hist.extra["guard/evicted"])),
        "guard_retries": float(sum(hist.extra["guard/retries"])),
    }
    # an OVERHEAD bound, not a speedup: the guard buys fault tolerance and
    # must cost (almost) nothing on the healthy path
    out["optimised_metric"] = "guard_overhead_x"
    return out


# ---------------------------------------------------------------------------
# observability: round telemetry overhead + structured-log smoke
# ---------------------------------------------------------------------------

def obs_microbench(device="cuda") -> dict:
    """Telemetry on against off on the fused round (Θ BITWISE the same: the
    ``obs/`` statistics reuse what the receive already has), and a 20-round
    ``MetricsSink`` run whose JSONL ``obs/validate`` accepts."""
    from repro_torch.faults import GuardConfig
    from repro_torch.obs.sink import MetricsSink, run_manifest
    from repro_torch.obs.validate import validate_run_dir
    from repro_torch.train.fl_trainer import train

    dev = resolve_device(device)
    W, d, rho = 8, 1 << 16, 0.5
    theta, lam, h, gen = _flat_round_inputs(W, d, dev)
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    noise = transport.matched_filter_noise_re(gen, (d,), ccfg)

    def off():
        return transport.ota_round_fused(theta, lam, h, noise, rho, ccfg)[0]

    def on():
        r = transport.ota_round_fused(theta, lam, h, noise, rho, ccfg,
                                      telemetry=True)
        return r[0], r[3]

    T1, telm = on()
    out = {"W": W, "d": d,
           "telemetry_max_abs_err": _max_abs([(T1, off())]),
           "telemetry_keys": sorted(telm)}
    out["bare_us_per_round"] = _time(off, iters=30)
    out["telemetry_us_per_round"] = _time(on, iters=30)
    out["telemetry_overhead_x"] = (out["telemetry_us_per_round"]
                                   / out["bare_us_per_round"])

    # structured-log smoke: a short flat-trainer run through a MetricsSink,
    # then the schema linter over the result.  The kernel route's unguarded
    # round exposes no receive SNR (nor does the JAX package's pallas
    # route), so the run takes the healthy-slot guard of faults_microbench,
    # whose accepted round is the unguarded one and whose telemetry
    # carries obs/rx_snr_db
    task = common.make_linreg_task(0, n_workers=W, device=dev)
    alg, solver = common.linreg_algorithm("afadmm", task)
    alg = dataclasses.replace(
        alg, acfg=dataclasses.replace(alg.acfg, flip_on_change=False),
        guard=GuardConfig(policy="evict-retransmit", snr_floor_db=-60.0),
        telemetry=True)
    with tempfile.TemporaryDirectory() as td:
        sink = MetricsSink(td)
        sink.write_manifest(run_manifest(bench="obs_microbench"))
        hist = train(alg, task.theta0, solver, task.grad_fn, 20, 1,
                     eval_fn=task.eval_fn, eval_every=10, driver="scan",
                     sink=sink)
        sink.log_done(20, 0.0)
        sink.close()
        violations = validate_run_dir(td)
    out["sink_rounds_logged"] = 20
    out["sink_jsonl_violations"] = violations
    out["sink_jsonl_valid"] = not violations
    out["snr_db_series_finite"] = bool(
        np.all(np.isfinite(hist.extra["obs/rx_snr_db"])))
    # an overhead bound, not a speedup: telemetry must be ~free when on and
    # bitwise absent when off
    out["optimised_metric"] = "telemetry_overhead_x"
    return out


# ---------------------------------------------------------------------------
# phy scenario engine: fused channel step + masked receive
# ---------------------------------------------------------------------------

def phy_microbench(device="cuda") -> dict:
    """The Gauss–Markov channel step is ONE fused launch (B9) a round at
    (W, d) = (8, 65,536) and matches its plain version ≤ 1e-6; the masked
    receive (B8) matches the plain masked chain, and the plain masked chain
    the unmasked one over the active subset (masked workers contribute
    exactly 0)."""
    from repro_torch.phy import innovation_scale
    from repro_torch.phy.fading import gauss_markov_step
    from repro_torch.phy.scenario import make_scenario

    dev = resolve_device(device)
    W, d = 8, 1 << 16
    gen = rng.generator(0, dev)
    h = rayleigh(gen, (W, d))
    w = rayleigh(gen, (W, d))
    rho = 0.9

    with _counted() as n:
        got = gauss_markov_step(h, w, rho, True)
    want = ref.fading_step(h.re, h.im, w.re, w.im, rho,
                           innovation_scale(rho), True)
    fad_err = _max_abs([(got.re, want[0]), (got.im, want[1])])

    # masked receive: parity + exact-zero contribution of masked workers
    theta = torch.randn((W, d), generator=gen, device=dev)
    lam = _cplx_normal(gen, (W, d))
    mask = torch.arange(W, device=dev) % 3 != 0      # drop workers 0, 3, 6
    ccfg = ChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    noise = transport.matched_filter_noise_re(gen, (d,), ccfg)
    T_j = _plain_uplink(theta, lam, h, noise, 0.5, ccfg, mask=mask)
    T_p, _ = transport.ota_uplink(theta, lam, h, noise, 0.5, ccfg, mask=mask)
    idx = torch.nonzero(mask)[:, 0]
    sub = lambda c: Complex(c.re[idx], c.im[idx])  # noqa: E731
    T_s = _plain_uplink(theta[idx], sub(lam), sub(h), noise, 0.5,
                        ChannelConfig(n_workers=int(idx.numel()), noisy=True,
                                      snr_db=20.0))
    masked_err = _max_abs([(T_p, T_j)])
    subset_err = _max_abs([(T_j, T_s)])

    # a full scenario round step (markov-doppler: its draw, then the AR(1)
    # step) at packed scale, the step's kernel as its plain version
    scn = make_scenario("markov-doppler", ccfg)
    st = scn.init(0, W, d, dev)

    def plain_step():
        w_r = scn.draw(1, st).w
        return ref.fading_step(st.h.re, st.h.im, w_r.re, w_r.im,
                               scn.cfg.rho, innovation_scale(scn.cfg.rho),
                               True)

    us = _device_us(plain_step, dev)

    # the scenario engine's per-round uplink: the composed masked round (B1,
    # B8) against the one-pass fused round (B6, B3) on the same planes
    comp_us = _time(lambda: transport.ota_uplink(
        theta, lam, h, noise, 0.5, ccfg, mask=mask)[0])
    fuse_us = _time(lambda: transport.ota_round_fused(
        theta, lam, h, noise, 0.5, ccfg, mask=mask)[0])
    return {
        "shape": {"W": W, "d": d, "rho": rho},
        "channel_step_dispatches_per_round": sum(n.values()),
        "channel_step_max_err_vs_plain": fad_err,
        "masked_receive_max_err_vs_plain": masked_err,
        "masked_vs_active_subset_max_err": subset_err,
        "scenario_step_us_per_round_plain": us,
        "participation": float(mask.float().mean()),
        "composed_masked_round_us": comp_us,
        "fused_masked_round_us": fuse_us,
        "speedup_fused_over_composed_masked_round": comp_us / fuse_us,
        "optimised_metric": "speedup_fused_over_composed_masked_round",
    }


# ---------------------------------------------------------------------------
# population-scale phy: the fused population step
# ---------------------------------------------------------------------------

SCALEUP_N = 65536
SCALEUP_RHO, SCALEUP_COH = 0.95, 4


def scaleup_inputs(dev):
    """(gcfg, h, w, pos, dest, shadow, dest_fresh, shadow_fresh) of the
    N = 65,536 frequency-flat population."""
    from repro_torch.phy import GeometryConfig
    from repro_torch.phy import geometry as _geo

    n = SCALEUP_N
    gcfg = GeometryConfig(speed_mps=15.0, shadowing_sigma_db=6.0,
                          slot_seconds=1.0)
    gen = rng.generator(0, dev)
    h = rayleigh(gen, (n, 1))
    w = rayleigh(gen, (n, 1))
    pos, dest = _geo.init_positions(gen, n, gcfg)
    fresh = _geo.uniform_disk(gen, n, gcfg.cell_radius_m)
    shadow = _geo.shadowing(gen, n, gcfg)
    shadow_fresh = _geo.shadowing(gen, n, gcfg)
    return gcfg, h, w, pos, dest, shadow, fresh, shadow_fresh


def scaleup_microbench(device="cuda") -> dict:
    """At N = 65,536 the fused population phy step
    (``phy.population.population_step``: one B10 launch) against the
    pre-fusion hot path: ``correlated_step`` → ``waypoint_shadow_step`` →
    ``worker_gains`` issued as eager per-function calls (B9, then plain
    torch).  The parity holds B10's plain version against the chain with
    B9's plain version: h, positions, waypoints and shadowing bit for bit;
    the gain is B10's exp(pexp·log(d₀/r)) against the chain's (d₀/r)^pexp,
    which part in the last bits.  Plus the structural pin: a freq-flat
    mobile ``Scenario.step`` is exactly ONE kernel launch for the whole phy
    (fading + mobility + shadowing + path gain)."""
    from repro_torch.phy import innovation_scale, population_step
    from repro_torch.phy import fading as _fading
    from repro_torch.phy import geometry as _geo
    from repro_torch.phy.scenario import make_scenario

    dev = resolve_device(device)
    rho, coh, age = SCALEUP_RHO, SCALEUP_COH, 0
    gcfg, h, w, pos, dest, shadow, fresh, sh_fresh = scaleup_inputs(dev)

    def fused():
        return population_step(h, w, age, pos, dest, shadow, fresh, sh_fresh,
                               gcfg, rho=rho, coherence_iters=coh)

    def composed():
        h2, age2, _ = _fading.correlated_step(h, w, age, rho, coh)
        p2, d2, s2 = _geo.waypoint_shadow_step(pos, dest, shadow, fresh,
                                               sh_fresh, gcfg)
        return h2, age2, p2, d2, s2, _geo.worker_gains(p2, s2, gcfg)

    # parity on the plain versions: B10's plain version against the chain
    # with B9's
    redraw = _fading.redraws(age, coh)
    flat = [x.reshape(-1).contiguous() for x in (h.re, h.im, w.re, w.im)]
    cols = [x.contiguous() for x in (pos[:, 0], pos[:, 1], dest[:, 0],
                                     dest[:, 1], fresh[:, 0], fresh[:, 1])]
    got = ref.population_step(
        *flat, *cols, shadow, sh_fresh, rho, innovation_scale(rho), redraw,
        gcfg.speed_mps * gcfg.slot_seconds, gcfg.ref_distance_m,
        gcfg.norm_distance_m, gcfg.pathloss_exp, True)
    hre, him = ref.fading_step(*flat, rho, innovation_scale(rho), redraw)
    p2, d2, s2 = _geo.waypoint_shadow_step(pos, dest, shadow, fresh, sh_fresh,
                                           gcfg)
    g2 = _geo.worker_gains(p2, s2, gcfg)
    parity = _max_abs([(got[0], hre), (got[1], him), (got[2], p2[:, 0]),
                       (got[3], p2[:, 1]), (got[6], s2), (got[7], g2)])

    fused_us = _time(fused)
    comp_us = _time(composed)

    # structural pin: the whole phy step of a freq-flat mobile scenario is
    # ONE kernel launch
    scn = make_scenario("urban-mobility", ChannelConfig(n_workers=256),
                        freq_flat=True)
    st = scn.init(0, 256, 32, dev)
    dr = scn.draw(1, st)
    with _counted() as n:
        scn.step(st, dr)
    return {
        "shape": {"N": SCALEUP_N, "rho": rho, "coherence_iters": coh},
        "fused_population_step_us": fused_us,
        "composed_eager_chain_us": comp_us,
        "speedup_fused_over_composed": comp_us / fused_us,
        "parity_max_abs_err_plain": parity,
        "scenario_step_kernel_dispatches": sum(n.values()),
        "optimised_metric": "speedup_fused_over_composed",
    }


# ---------------------------------------------------------------------------
# the card's lane: the autotuners
# ---------------------------------------------------------------------------

def device_microbench(device="cuda") -> dict:
    """The real-accelerator lane: with ``REPRO_BENCH_DEVICE=gpu`` on the
    card, B10's block-size sweep at N = 2²⁰ and the fused round's plan and
    cohort sweep at (256, 65,536); unset, or naming another platform than
    the one ``device`` is on, the reference's skip marker."""
    want = os.environ.get("REPRO_BENCH_DEVICE", "").lower()
    dev = torch.device(device)
    plat = "gpu" if dev.type == "cuda" else dev.type
    if not want:
        return {"skipped": True, "platform": plat,
                "reason": "REPRO_BENCH_DEVICE unset (opt-in lane)"}
    if plat != want:
        return {"skipped": True, "platform": plat,
                "reason": f"REPRO_BENCH_DEVICE={want} but the device "
                          f"{device!r} is on platform {plat}"}
    from repro_torch.phy.population import autotune_population_step

    dev = resolve_device(dev)
    pop = autotune_population_step(1 << 20, device=dev)
    rnd = transport.autotune_ota_round(256, 1 << 16, device=dev)
    return {
        "skipped": False,
        "platform": plat,
        "population_step_1M": pop,
        "ota_round_256x65536": rnd,
        "optimised_metric": "population_step_1M.best.us",
    }


# ---------------------------------------------------------------------------
# flash attention forward + backward launch counts
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v, causal: bool) -> Tensor:
    """Softmax attention in plain torch ops, differentiable: the (S, S)
    scores and their softmax are built."""
    s = ref._attention_scores(q, k, causal, q.shape[-1] ** -0.5)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.float()).to(q.dtype)


def _grads(attn, q, k, v):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    loss = torch.sum(torch.sin(attn(q, k, v)))
    return torch.autograd.grad(loss, (q, k, v))


def attn_bwd_microbench(device="cuda") -> dict:
    """B11's launch counts and gradient parity through
    ``kernels.flash_attention.flash_attention`` (an autograd Function): a
    gradient costs exactly 3 launches, 1 forward (o + lse residual) and 2
    backward (dq; dk/dv), no (S, S) tensor is built, and the cotangents are
    within 1e-5 of the plain attention's (f32, (2, 4, 256, 64), causal).
    ``interpret_grad_us_per_call`` keeps the reference's name for the
    flash gradient's µs."""
    from repro_torch.kernels.flash_attention import flash_attention

    dev = resolve_device(device)
    B, H, S, hd = 2, 4, 256, 64
    bq = bk = 128
    gen = rng.generator(0, dev)
    q, k, v = (torch.randn((B, H, S, hd), generator=gen, device=dev)
               for _ in range(3))

    def flash(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def plain(q, k, v):
        return _plain_attention(q, k, v, True)

    with _counted() as fwd, torch.no_grad():
        flash(q, k, v)
    with _counted() as total:
        got = _grads(flash, q, k, v)
    want = _grads(plain, q, k, v)
    errs = {f"max_abs_err_d{n}": _max_abs([(g, w)])
            for n, g, w in zip("qkv", got, want)}
    fwd_n, total_n = sum(fwd.values()), sum(total.values())
    us = _device_us(lambda: _grads(flash, q, k, v), dev, iters=3)
    naive_us = _device_us(lambda: _grads(plain, q, k, v), dev, iters=3)
    return {
        "shape": {"B": B, "H": H, "S": S, "hd": hd,
                  "block_q": bq, "block_k": bk},
        # 1 fwd; a gradient = the fwd with its residual + dq + dk/dv
        "fwd_dispatches": fwd_n,
        "grad_total_dispatches": total_n,
        "bwd_dispatches": total_n - fwd_n,
        # residual saved beyond the primals: one f32 (B,H,S) lse plane
        "residual_lse_bytes": B * H * S * 4,
        # what the plain backward materialises instead
        "naive_bwd_score_tensor_bytes": B * H * S * S * 4,
        "interpret_grad_us_per_call": us,
        "naive_plain_grad_us_per_call": naive_us,
        "speedup_flash_grad_over_naive": naive_us / us,
        "optimised_metric": "speedup_flash_grad_over_naive",
        **errs,
    }


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

#: (flag, function, output key, help) of each flagged section; a section
#: writes ``BENCH_torch_<key>.json`` unless ``--out-<flag>`` names a file
SECTIONS = (
    ("attn_bwd", attn_bwd_microbench, "attn_bwd",
     "flash-attention fwd+bwd launch counts / grad parity"),
    ("phy", phy_microbench, "phy",
     "phy scenario engine: fused channel-step launch count + masked-receive "
     "parity"),
    ("fused_round", fused_round_microbench, "fused_round",
     "fused one-pass OTA round: fused vs composed-packed vs leafwise + "
     "W=256 cohort stream"),
    ("faults", faults_microbench, "faults",
     "fault guard: guarded-vs-unguarded healthy-round overhead (bitwise "
     "parity) + 25%%-crash/NaN chaos smoke"),
    ("shard_local", shard_local_microbench, "shard_local",
     "shard-local packed uplink on a (1, 2) mesh of two spawned ranks: 1 "
     "receive/shard/round + bitwise leafwise parity"),
    ("sketched", sketched_microbench, "sketched",
     "sketched A-FADMM-CS on a (1, 2, 2) mesh of four spawned ranks: one "
     "fused receive per shard per round + wall-clock vs the full-dim "
     "replicated round"),
    ("obs", obs_microbench, "obs",
     "observability: telemetry-on vs bare fused-round overhead (bitwise "
     "parity) + MetricsSink JSONL schema smoke"),
    ("scaleup", scaleup_microbench, "scaleup",
     "population-scale phy: the one-launch population step vs the composed "
     "chain at N=65536 + the 1-launch freq-flat Scenario.step pin"),
    ("device_bench", device_microbench, "device",
     "the card's lane: honours REPRO_BENCH_DEVICE=gpu, skips elsewhere (no "
     "file written when skipped)"),
)


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(obj, indent=2, default=str) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu' (the plain "
                    "versions)")
    ap.add_argument("--out", default=None,
                    help="write the kernel and transport JSON to this path")
    ap.add_argument("--out-packed", default=None,
                    help="write the packed-vs-per-leaf uplink JSON to this "
                         "path")
    ap.add_argument("--packed-only", action="store_true",
                    help="skip the kernel/transport sections")
    for flag, _, key, what in SECTIONS:
        opt = flag.replace("_", "-")
        ap.add_argument(f"--{opt}", action="store_true",
                        help=f"{what} section")
        ap.add_argument(f"--out-{opt}", default=f"BENCH_torch_{key}.json",
                        help=f"where --{opt} writes its JSON")
    args = ap.parse_args(argv)
    chosen = [s for s in SECTIONS if getattr(args, s[0])]

    derived: Dict[str, dict] = {}
    if not (args.packed_only or chosen):
        derived = {"kernels": microbench(args.device),
                   "transport": transport_microbench(args.device)}
    out = dict(derived)
    if args.packed_only or args.out_packed:
        out["packed_uplink"] = packed_microbench(args.device)
    for flag, fn, key, _ in chosen:
        out[key] = fn(args.device)
    print(json.dumps(out, indent=2, default=str))
    if args.out and derived:
        _write(args.out, derived)
    if args.out_packed:
        _write(args.out_packed, out["packed_uplink"])
    for flag, _, key, _ in chosen:
        if key == "device" and out[key].get("skipped"):
            continue
        _write(getattr(args, f"out_{flag}"), out[key])
    return 0


if __name__ == "__main__":
    sys.exit(main())
