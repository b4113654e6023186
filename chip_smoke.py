#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi); TF32 is switched
             off for matmuls and cuDNN, so fp32 stays fp32.
2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``.
3. kernels — at the paper MLP's full width (W = 100 workers, d = 109,386)
             and at the other shapes the paths give a kernel (the fading
             step on (100, 1) planes; the population kernel at N = 10⁶ and
             65,536 workers), each CUDA kernel against its plain PyTorch
             version on the same inputs, with its device time (``ms``,
             median of CUDA-event timings behind a GPU spin), its time with
             the host's launch (``ms_with_launch``), the plain version's
             times, and its bound (bytes over the card's memory rate, or
             flops over its fp32 rate, whichever is larger).
4. mlp     — the main path: the paper's 784-128-64-10 MLP, 100 workers,
             4096 subcarriers, 20 local Adam steps per round, trained for 5
             rounds through ``make("afadmm", ...)`` and ``train``.
5. linreg  — the quickstart path: 10-worker linear regression over 10
             subcarriers with the flip rule on, 200 rounds.
6. scenario_markov   — the MLP of phase 4 under the ``markov-doppler``
             scenario with imperfect CSI (σ_e = 0.1), 5 rounds.
7. scenario_deepfade — the MLP under ``deep-fade-truncation`` (about 22 %
             of the workers drop each round), 5 rounds, and a check that
             the dropped workers' duals keep their pre-round bits.
8. scaleup — ``benchmarks/scaleup.py``'s largest full-transmit point: 65,536
             workers on the frequency-flat ``urban-mobility`` scenario,
             d = 32, 10 rounds of its proximal consensus task.
9. profile — one more round of phases 4 and 7 each under torch.profiler:
             device time by kernel family, and its share of the phase's
             round time.

Launch counts are reset just before each of phases 4–8 and read just
after.  Then come the kernel table as one JSON line, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  Without a card, or run from a
directory that lacks ``src/repro_torch``, it exits non-zero before printing
a result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
SEED = 0
W_FULL = 100
TIMED_RUNS = 25
#: (memory bytes/s, fp32 flop/s outside the tensor cores): NVIDIA data sheets
CARD_PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    raise SmokeFailure(f"no data-sheet peaks for card {name!r}")


#: GPU cycles to spin before each timed call (~3 ms on an H100): the host
#: enqueues the start event, the call's launches and the end event while the
#: card is still busy, so the interval holds device time only and not the
#: wrapper's host-side launch gap
SPIN_CYCLES = 5_000_000


def time_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 3,
            spin: bool = True) -> float:
    """Median over ``runs`` CUDA-event timings of one call of ``fn``.  With
    ``spin`` each call is queued behind a GPU spin, so only device time is
    measured; without it the interval also holds the host's time to issue
    the call (the wrapper's checks and launch) while the card waits."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})
    return name, smi


def phase_build(build):
    t0 = time.perf_counter()
    info = build.build()
    regs = {lib: [line.split("Used ")[1].strip()
                  for line in v["log"].splitlines() if "Used " in line]
            for lib, v in info.items()}
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "libraries": {lib: {"seconds": v["seconds"], "cached": v["cached"],
                              "ptxas": regs[lib]}
                        for lib, v in info.items()}})


def _max_err(outs, refs, rtol: float, atol: float):
    """(max |a − b|, max |a − b| / (atol + rtol·|b|)); the kernel agrees
    when the second is ≤ 1 (0 for an exact match when both are 0)."""
    max_abs, worst = 0.0, 0.0
    for a, b in zip(outs, refs):
        diff = (a - b).abs()
        max_abs = max(max_abs, float(diff.max()))
        worst = max(worst, _err_ratio(diff, atol + rtol * b.abs()))
    return max_abs, worst


def _err_ratio(diff, tol) -> float:
    """max diff/tol, with 0/0 = 0 and x/0 = inf for x > 0."""
    zero = tol == 0
    ratio = diff / tol.masked_fill(zero, 1.0)
    ratio = ratio.masked_fill(zero & (diff == 0), 0.0)
    ratio = ratio.masked_fill(zero & (diff > 0), float("inf"))
    return float(ratio.max())


def phase_kernels(torch, card):
    from repro_torch import rng
    from repro_torch.kernels import (admm_update, build, ota, phy_channel,
                                     phy_population, ref)
    from repro_torch.phy import doppler_rho, innovation_scale

    _, (mem_rate, f32_rate) = card_peaks(card)
    dev = torch.device("cuda")
    gen = rng.generator(SEED, dev)
    W, d = W_FULL, 109_386
    rho = 0.5

    def plane(scale=1.0):
        return torch.randn((W, d), generator=gen, device=dev) * scale

    theta, lam_re, lam_im, grad = plane(0.05), plane(), plane(), plane()
    h_re, h_im = plane(math.sqrt(0.5)), plane(math.sqrt(0.5))
    s_re, s_im, z_plane = plane(), plane(), plane(1e-3)
    Theta = torch.randn(d, generator=gen, device=dev) * 0.05
    noise = torch.randn(d, generator=gen, device=dev) * 7e-4
    ia = torch.tensor(0.37, device=dev)
    ia_zero = torch.zeros((), device=dev)
    plane_b = W * d * 4
    vec_b = d * 4

    # B8: deep-fade-truncation drops ~22 % of the workers (|h| < 0.5 for a
    # CN(0, 1) fade: 1 − e^{−1/4}); one dropped row holds NaN and Inf
    dropped = torch.randperm(W, generator=gen, device=dev)[:22]
    mask = torch.ones(W, dtype=torch.bool, device=dev)
    mask[dropped] = False
    s_re_bad, h_im_bad = s_re.clone(), h_im.clone()
    s_re_bad[dropped[0]] = float("nan")
    h_im_bad[dropped[0]] = float("inf")
    no_mask = torch.zeros(W, dtype=torch.bool, device=dev)
    active = int(mask.sum())
    # B9 at the markov-doppler preset's ρ (50 Hz Doppler, 1 ms slots)
    rho_f = doppler_rho(50.0, 1e-3)
    w_re, w_im = plane(math.sqrt(0.5)), plane(math.sqrt(0.5))
    # ... and on deep-fade-truncation's frequency-flat (W, 1) planes
    flat = [torch.randn((W, 1), generator=gen, device=dev) * math.sqrt(0.5)
            for _ in range(4)]
    # B10 at the scaleup benchmark's 10⁶-worker population and at the
    # scaleup phase's 65,536 workers (urban-mobility: 15 m/s over 1 ms
    # slots, 6 dB shadowing, exponent 3.2)
    pop_scalars = (doppler_rho(100.0, 1e-3), innovation_scale(
        doppler_rho(100.0, 1e-3)), True, 15.0 * 1e-3, 1.0, 250.0, 3.2, True)
    pops = {n: _population_inputs(torch, gen, dev, n)
            for n in (1_000_000, 65_536)}
    pop_bytes = {n: _population_bytes(torch, p, pop_scalars)
                 for n, p in pops.items()}

    def population_case(n: int, label: str):
        pop = pops[n]
        nbytes, arrived = pop_bytes[n]
        return (f"population_step{label}",
                "src/repro/kernels/phy_population.py:81", "phy_population",
                lambda: phy_population.population_step(*pop, *pop_scalars),
                lambda: ref.population_step(*pop, *pop_scalars),
                nbytes, 40 * n, (1e-5, 1e-5), [n], {"arrived": arrived})

    # name, TPU kernel, source, kernel call, plain call, bytes, flops, tol,
    # shape, extra fields of the row
    cases = [
        ("ota_modulate", "src/repro/kernels/ota.py:99", "ota",
         lambda: ota.ota_modulate(theta, lam_re, lam_im, h_re, h_im, rho),
         lambda: ref.ota_modulate(theta, lam_re, lam_im, h_re, h_im, rho),
         7 * plane_b, 6 * W * d, (1e-5, 1e-5)),
        ("ota_receive", "src/repro/kernels/ota.py:201", "ota",
         lambda: ota.ota_receive(s_re, s_im, h_re, h_im, noise, ia),
         lambda: ref.ota_receive(s_re, s_im, h_re, h_im, noise, ia),
         4 * plane_b + 2 * vec_b + 4, 8 * W * d + 3 * d, (1e-5, 1e-6)),
        ("ota_receive[inv_alpha=0]", "src/repro/kernels/ota.py:201", "ota",
         lambda: ota.ota_receive(s_re, s_im, h_re, h_im, noise, ia_zero),
         lambda: ref.ota_receive(s_re, s_im, h_re, h_im, noise, ia_zero),
         4 * plane_b + 2 * vec_b + 4, 8 * W * d + 3 * d, (1e-5, 1e-6)),
        ("admm_dual_update", "src/repro/kernels/admm_update.py:42",
         "admm_update",
         lambda: admm_update.admm_dual_update(lam_re, lam_im, h_re, h_im,
                                              theta, Theta, rho),
         lambda: ref.admm_dual_update(lam_re, lam_im, h_re, h_im, theta,
                                      Theta, rho),
         7 * plane_b + vec_b, 8 * W * d, (1e-5, 1e-5)),
        ("admm_dual_update[z plane]", "src/repro/kernels/admm_update.py:42",
         "admm_update",
         lambda: admm_update.admm_dual_update(lam_re, lam_im, h_re, h_im,
                                              theta, Theta, rho, z_plane),
         lambda: ref.admm_dual_update(lam_re, lam_im, h_re, h_im, theta,
                                      Theta, rho, z_plane),
         8 * plane_b + vec_b, 9 * W * d, (1e-5, 1e-5)),
        ("admm_flip_lambda", "src/repro/kernels/admm_update.py:63",
         "admm_update",
         lambda: admm_update.admm_flip_lambda(grad, theta, Theta, h_re, h_im,
                                              rho),
         lambda: ref.admm_flip_lambda(grad, theta, Theta, h_re, h_im, rho),
         6 * plane_b + vec_b, 12 * W * d, (1e-5, 1e-5)),
        # masked rows are never read: bytes and flops count active rows
        ("ota_receive_masked", "src/repro/kernels/phy_channel.py:100",
         "phy_channel",
         lambda: phy_channel.ota_receive_masked(s_re_bad, s_im, h_re,
                                                h_im_bad, mask, noise, ia),
         lambda: ref.ota_receive_masked(s_re_bad, s_im, h_re, h_im_bad, mask,
                                        noise, ia),
         4 * active * d * 4 + 2 * vec_b + W + 4, 8 * active * d + 3 * d,
         (1e-5, 1e-6)),
        ("ota_receive_masked[all masked]",
         "src/repro/kernels/phy_channel.py:100", "phy_channel",
         lambda: phy_channel.ota_receive_masked(s_re_bad, s_im, h_re,
                                                h_im_bad, no_mask, noise,
                                                ia_zero),
         lambda: ref.ota_receive_masked(s_re_bad, s_im, h_re, h_im_bad,
                                        no_mask, noise, ia_zero),
         2 * vec_b + W + 4, 3 * d, (0.0, 0.0)),
        ("fading_step", "src/repro/kernels/phy_channel.py:54", "phy_channel",
         lambda: phy_channel.fading_step(h_re, h_im, w_re, w_im, rho_f,
                                         innovation_scale(rho_f), True),
         lambda: ref.fading_step(h_re, h_im, w_re, w_im, rho_f,
                                 innovation_scale(rho_f), True),
         6 * plane_b, 6 * W * d, (1e-6, 1e-6)),
        # the held round reads only h: the innovations are not needed
        ("fading_step[redraw off]", "src/repro/kernels/phy_channel.py:54",
         "phy_channel",
         lambda: phy_channel.fading_step(h_re, h_im, w_re, w_im, rho_f,
                                         innovation_scale(rho_f), False),
         lambda: ref.fading_step(h_re, h_im, w_re, w_im, rho_f,
                                 innovation_scale(rho_f), False),
         4 * plane_b, 0, (0.0, 0.0)),
        ("fading_step[rho=0]", "src/repro/kernels/phy_channel.py:54",
         "phy_channel",
         lambda: phy_channel.fading_step(h_re, h_im, w_re, w_im, 0.0, 1.0,
                                         True),
         lambda: ref.fading_step(h_re, h_im, w_re, w_im, 0.0, 1.0, True),
         6 * plane_b, 6 * W * d, (0.0, 0.0)),
        ("fading_step[(100, 1)]", "src/repro/kernels/phy_channel.py:54",
         "phy_channel",
         lambda: phy_channel.fading_step(*flat, rho_f,
                                         innovation_scale(rho_f), True),
         lambda: ref.fading_step(*flat, rho_f, innovation_scale(rho_f),
                                 True),
         6 * W * 4, 6 * W, (1e-6, 1e-6), [W, 1], {}),
        population_case(1_000_000, ""),
        population_case(65_536, "[N=65,536]"),
    ]
    cases = [c if len(c) == 10 else (*c, [W, d], {}) for c in cases]
    results = {}
    for (name, replaces, lib, kernel, plain, nbytes, flops, (rtol, atol),
         shape, extra) in cases:
        fn_name = name.split("[")[0]
        before = build.launches[fn_name]
        out = kernel()
        torch.cuda.synchronize()
        require(build.launches[fn_name] == before + 1,
                f"{name}: the launch counter did not rise")
        outs = out if isinstance(out, tuple) else (out,)
        want = plain()
        refs = want if isinstance(want, tuple) else (want,)
        require(all(bool(torch.isfinite(o).all()) for o in outs),
                f"{name}: non-finite output")
        max_abs, err_over_tol = _max_err(outs, refs, rtol, atol)
        require(err_over_tol <= 1.0,
                f"{name}: kernel and plain version disagree beyond "
                f"rtol={rtol} atol={atol} (max abs err {max_abs}, "
                f"{err_over_tol} of the tolerance)")
        kernel_ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain)
        bytes_ms = nbytes / mem_rate * 1e3
        flops_ms = flops / f32_rate * 1e3
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{lib}.cu",
               "replaces": replaces, "max_abs_err": max_abs,
               "err_over_tol": err_over_tol,
               "rtol": rtol, "atol": atol, "ok": True,
               "ms": kernel_ms, "plain_ms": plain_ms,
               "kernel_ms": kernel_ms, "ref_ms": plain_ms,
               "ms_with_launch": time_ms(torch, kernel, spin=False),
               "plain_ms_with_launch": time_ms(torch, plain, spin=False),
               "bytes": nbytes, "flops": flops,
               "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
               "library_ms": None, "shape": shape, **extra}
        emit({"phase": "kernels", **row})
        results[name] = row
    return results


def _population_inputs(torch, gen, dev, n: int):
    """The twelve (n,) planes of one population step: CN(0, 1) fades and
    innovations, positions, waypoints and fresh waypoints uniform over a
    500 m cell, 6 dB log-normal shadowing; a tenth of the workers sit 1 mm
    from their waypoint, so they arrive and take the fresh draws."""
    def randn(scale=1.0):
        return torch.randn(n, generator=gen, device=dev) * scale

    def disk():
        r = 500.0 * torch.sqrt(torch.rand(n, generator=gen, device=dev))
        a = 2.0 * math.pi * torch.rand(n, generator=gen, device=dev)
        return r * torch.cos(a), r * torch.sin(a)

    s = math.sqrt(0.5)
    h_re, h_im, w_re, w_im = randn(s), randn(s), randn(s), randn(s)
    (px, py), (dx, dy), (fx, fy) = disk(), disk(), disk()
    dx[: n // 10] = px[: n // 10] + 1e-3
    dy[: n // 10] = py[: n // 10]
    shadow, shadow_fresh = 10.0 ** (randn(0.6)), 10.0 ** (randn(0.6))
    return (h_re, h_im, w_re, w_im, px, py, dx, dy, fx, fy, shadow,
            shadow_fresh)


def _population_bytes(torch, pop, scalars):
    """(bytes, arrived): what ``population_step`` must move on these
    inputs.  Every worker needs its fading planes (the innovations only when
    it redraws), position, waypoint and one shadowing value (the kept one, or
    the fresh one on arrival); an arriving worker also reads its fresh
    waypoint.  Eight planes go out."""
    _, _, _, _, px, py, dx, dy, *_ = pop
    _, _, redraw, step, *_ = scalars
    n = px.numel()
    ddx, ddy = dx - px, dy - py
    arrived = int((torch.sqrt(ddx * ddx + ddy * ddy) <= step).sum())
    planes_in = (4 if redraw else 2) + 4 + 1
    return 4 * (n * (planes_in + 8) + 2 * arrived), arrived


def _linreg_task(torch, dev, W: int, D: int, key: int):
    from repro_torch import rng
    from repro_torch.data.synthetic import linreg_dataset
    from repro_torch.optim.local_solvers import exact_quadratic_solver

    X, y, _ = linreg_dataset(key, n_samples=2000, d=D, device=dev)
    m = 2000 // W
    Xw = X[: m * W].reshape(W, m, D) / math.sqrt(m)
    yw = y[: m * W].reshape(W, m) / math.sqrt(m)
    theta_star = torch.linalg.solve(X.T @ X, X.T @ y)

    def f(th):
        return torch.mean((y - X @ th) ** 2)

    f_star = f(theta_star)

    def grad_fn(theta):
        r = torch.einsum("wmd,wd->wm", Xw, theta) - yw
        return 2.0 * torch.einsum("wmd,wm->wd", Xw, r)

    theta0 = torch.randn((W, D), generator=rng.generator(rng.fold_in(key, 9),
                                                         dev), device=dev)
    solver = exact_quadratic_solver(Xw, yw, 0.5)
    return theta0, solver, grad_fn, lambda T: {"loss": (f(T) - f_star).abs()}


def phase_mlp(torch):
    from repro_torch import rng
    from repro_torch.configs import paper_mlp as cfg
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.aggregators import make
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.subcarrier import SubcarrierPlan, analog_channel_uses
    from repro_torch.data.federated import make_batch_fn, split_iid
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.kernels import build
    from repro_torch.models.mlp import init_mlp_flat, make_loss_fns
    from repro_torch.optim.local_solvers import prox_adam_solver
    from repro_torch.optim.optimizers import adam
    from repro_torch.train.fl_trainer import train

    dev = torch.device("cuda")
    W, n_rounds, key = W_FULL, 5, SEED
    t0 = time.perf_counter()
    xtr, ytr, xte, yte = image_dataset(key, 60_000, 10_000,
                                       dim=cfg.LAYER_SIZES[0],
                                       cluster_std=3.0, device=dev)
    shards = split_iid(rng.fold_in(key, 1), 60_000, W, device=dev)
    flat0, unflatten = init_mlp_flat(rng.fold_in(key, 2), cfg.LAYER_SIZES,
                                     device=dev)
    d = flat0.numel()
    require(d == cfg.MODEL_SIZE_D, f"MLP has d={d}, want {cfg.MODEL_SIZE_D}")
    loss, grad, acc = make_loss_fns(unflatten)
    batch_fn = make_batch_fn((xtr, ytr), shards, batch_size=cfg.BATCH_SIZE)
    solver = prox_adam_solver(lambda th, b: grad(th, *b), adam(cfg.LOCAL_LR),
                              n_steps=cfg.LOCAL_ITERS, rho=cfg.RHO,
                              batch_fn=batch_fn)

    def grad_fn(theta):
        raise SmokeFailure("the flip rule is off; grad_fn must not run")

    def eval_fn(Theta):
        return {"loss": loss(Theta[None], xte[None], yte[None])[0],
                "accuracy": acc(Theta[None], xte[None], yte[None])[0]}

    theta0 = flat0[None].expand(W, d) + 0.01 * torch.randn(
        (W, d), generator=rng.generator(key, dev), device=dev)
    plan = SubcarrierPlan.build(d, cfg.N_SUBCARRIERS)
    require(analog_channel_uses(plan) == 27,
            f"{plan.n_slots} slots per upload, want 27")
    alg = make("afadmm", AdmmConfig(rho=cfg.RHO, flip_on_change=False),
               ChannelConfig(n_workers=W, n_subcarriers=cfg.N_SUBCARRIERS,
                             snr_db=40.0), plan)
    loss0 = float(eval_fn(theta0.mean(0))["loss"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # one round first, so the timed run excludes cuBLAS/allocator warm-up
    train(alg, theta0, solver, grad_fn, 1, key + 1)
    torch.cuda.synchronize()

    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train(alg, theta0, solver, grad_fn, n_rounds, key,
                 eval_fn=eval_fn, eval_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.launches)

    series = [hist.loss, hist.accuracy, *hist.extra.values()]
    require(all(math.isfinite(v) for s in series for v in s),
            f"non-finite metrics: {hist}")
    require(len(hist.loss) == n_rounds, f"{len(hist.loss)} evals")
    require(hist.loss[-1] < loss0, f"test loss {hist.loss[-1]} after "
            f"{n_rounds} rounds is not below the initial {loss0}")
    require(hist.channel_uses == [27.0] * n_rounds,
            f"channel uses {hist.channel_uses}, want 27 per round")
    for k in ("ota_modulate", "ota_receive", "admm_dual_update"):
        require(launches.get(k, 0) == n_rounds,
                f"{k} launched {launches.get(k, 0)} times in {n_rounds} rounds")
    require(launches.get("admm_flip_lambda", 0) == 0,
            "admm_flip_lambda launched with the flip rule off")
    emit({"phase": "mlp", "ok": True, "W": W, "d": d,
          "layers": list(cfg.LAYER_SIZES), "rounds": n_rounds,
          "local_steps": cfg.LOCAL_ITERS, "setup_s": setup_s,
          "seconds_per_round": run_s / n_rounds,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "loss_init": loss0, "loss": hist.loss, "accuracy": hist.accuracy,
          "inv_alpha": hist.extra["inv_alpha"],
          "channel_uses": hist.channel_uses, "launches": launches})
    run = dict(alg=alg, theta0=theta0, solver=solver, grad_fn=grad_fn,
               eval_fn=eval_fn, loss0=loss0)
    return launches, run, run_s / n_rounds


def phase_linreg(torch):
    from repro_torch.configs import paper_linreg as cfg
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.aggregators import make
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.subcarrier import SubcarrierPlan
    from repro_torch.kernels import build
    from repro_torch.train.fl_trainer import train

    dev = torch.device("cuda")
    W, D, n_rounds, key = 10, cfg.N_FEATURES, 200, SEED
    theta0, solver, grad_fn, eval_fn = _linreg_task(torch, dev, W, D, key)
    alg = make("afadmm", AdmmConfig(rho=0.5),
               ChannelConfig(n_workers=W, n_subcarriers=cfg.N_SUBCARRIERS,
                             snr_db=40.0),
               SubcarrierPlan.build(D, cfg.N_SUBCARRIERS))
    build.reset_launches()
    t0 = time.perf_counter()
    hist = train(alg, theta0, solver, grad_fn, n_rounds, key,
                 eval_fn=eval_fn, eval_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.launches)
    gaps = hist.loss
    worst = max(gaps[40:])
    require(all(math.isfinite(g) for g in gaps), "non-finite gap")
    require(worst < 1e-4, f"optimality gap {worst} >= 1e-4 after round 40")
    require(hist.channel_uses == [1.0] * n_rounds, "want 1 channel use/round")
    for k in ("ota_modulate", "ota_receive", "admm_dual_update",
              "admm_flip_lambda"):
        require(launches.get(k, 0) == n_rounds,
                f"{k} launched {launches.get(k, 0)} times in {n_rounds} rounds")
    emit({"phase": "linreg", "ok": True, "W": W, "d": D, "rounds": n_rounds,
          "seconds_per_round": run_s / n_rounds,
          "gap": {str(r): gaps[r] for r in (0, 40, 80, 120, 160, 199)},
          "max_gap_from_round_40": worst, "launches": launches})
    return launches


def _per_round(launches: dict, n_rounds: int, want: dict) -> None:
    """Each kernel in ``want`` launched want[k] times per round."""
    for k, per in want.items():
        require(launches.get(k, 0) == per * n_rounds,
                f"{k} launched {launches.get(k, 0)} times in {n_rounds} "
                f"rounds, want {per} per round")


def phase_scenario(torch, run, phase: str, preset: str, **overrides):
    """The paper MLP of phase ``mlp`` (same data, solver and initial
    models) under a ``repro_torch.phy`` scenario, 5 rounds."""
    from repro_torch.core.aggregators import make
    from repro_torch.kernels import build
    from repro_torch.phy import make_scenario
    from repro_torch.train.fl_trainer import train

    base = run["alg"]
    scn = make_scenario(preset, base.ccfg, **overrides)
    alg = make("afadmm", base.acfg, base.ccfg, base.plan, scenario=scn)
    theta0, solver, grad_fn = run["theta0"], run["solver"], run["grad_fn"]
    n_rounds, key = 5, SEED + 3
    train(alg, theta0, solver, grad_fn, 1, key + 1)      # warm-up
    torch.cuda.synchronize()

    build.reset_launches()
    t0 = time.perf_counter()
    hist = train(alg, theta0, solver, grad_fn, n_rounds, key,
                 eval_fn=run["eval_fn"], eval_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.launches)

    series = [hist.loss, hist.accuracy, *hist.extra.values()]
    require(all(math.isfinite(v) for s in series for v in s),
            f"{phase}: non-finite metrics: {hist}")
    require(hist.loss[-1] < run["loss0"], f"{phase}: test loss "
            f"{hist.loss[-1]} is not below the initial {run['loss0']}")
    out = {"phase": phase, "ok": True, "scenario": preset,
           "overrides": overrides, "rho": scn.cfg.rho, "rounds": n_rounds,
           "seconds_per_round": run_s / n_rounds, "loss_init": run["loss0"],
           "loss": hist.loss, "accuracy": hist.accuracy,
           "inv_alpha": hist.extra["inv_alpha"], "launches": launches}
    if scn.truncating:
        part = hist.extra["participation"]
        out["participation"] = part
        require(0.0 < statistics.mean(part) < 1.0,
                f"{phase}: mean participation {statistics.mean(part)} is "
                f"not strictly between 0 and 1")
        _per_round(launches, n_rounds, {
            "fading_step": 1, "ota_modulate": 1, "ota_receive_masked": 1,
            "admm_dual_update": 1, "ota_receive": 0})
        out["dual_freeze"] = _check_masked_duals(torch, alg, run, key)
    else:
        _per_round(launches, n_rounds, {
            "fading_step": 1, "ota_modulate": 1, "ota_receive": 1,
            "admm_dual_update": 1, "ota_receive_masked": 0})
    emit(out)
    return launches, alg, run_s / n_rounds


def _check_masked_duals(torch, alg, run, key: int) -> dict:
    """Rounds from ``alg.init`` until one drops a worker whose pre-round
    dual is non-zero: the dropped workers' duals must keep their pre-round
    bits exactly."""
    from repro_torch import rng

    st = alg.init(key, run["theta0"])
    for r in range(6):
        st2, _ = alg.round(rng.fold_in(key, r + 1), st, run["solver"],
                           run["grad_fn"])
        drop = ~st2.phys.mask
        for a, b in ((st2.lam.re, st.lam.re), (st2.lam.im, st.lam.im)):
            require(torch.equal(a[drop], b[drop]),
                    f"round {r}: a dropped worker's dual changed")
        pre = st.lam.re[drop].abs().amax(dim=1) if bool(drop.any()) else None
        if pre is not None and bool((pre > 0).any()):
            return {"round": r, "dropped": int(drop.sum()),
                    "dropped_with_nonzero_dual": int((pre > 0).sum())}
        st = st2
    raise SmokeFailure("no round in 6 dropped a worker that had a dual")


def _proximal_solver(rho: float):
    """Closed-form primal of the proximal-point objective
    f_n(θ) = ‖θ − θ_n^prev‖² (``benchmarks/scaleup.py``'s consensus task):
    2(θ − θ_prev) + Re{λ*h} + ρ|h|²(θ − Θ) = 0."""
    from repro_torch.core import cplx

    def solve(theta, lam, h, Theta, batch_idx=None):
        h2 = cplx.abs2(h)
        mu = cplx.cmul_conj(h, lam).re
        return (2.0 * theta - mu + rho * h2 * Theta[None, :]) \
            / (2.0 + rho * h2)
    return solve


def phase_scaleup(torch, card):
    """``benchmarks/scaleup.py``'s largest full-transmit point: W = 65,536
    workers, d = 32 over 32 subcarriers, 20 dB, ρ = 0.5, flip rule off,
    power control on, the frequency-flat ``urban-mobility`` scenario."""
    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.aggregators import make
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.subcarrier import SubcarrierPlan
    from repro_torch.kernels import build, ota
    from repro_torch.phy import make_scenario
    from repro_torch.train.fl_trainer import train

    _, (mem_rate, _) = card_peaks(card)
    dev = torch.device("cuda")
    W, D, n_sub, n_rounds, key = 65_536, 32, 32, 10, SEED
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=n_sub, snr_db=20.0)
    alg = make("afadmm", AdmmConfig(rho=0.5, flip_on_change=False,
                                    power_control=True), ccfg,
               SubcarrierPlan.build(D, n_sub),
               scenario=make_scenario("urban-mobility", ccfg,
                                      freq_flat=True))
    theta0 = torch.randn((W, D), generator=rng.generator(
        rng.fold_in(key, 1), dev), device=dev)
    solver = _proximal_solver(0.5)

    def grad_fn(theta):
        raise SmokeFailure("the flip rule is off; grad_fn must not run")

    def eval_fn(Theta):
        return {"loss": torch.sqrt(torch.mean(Theta * Theta))}

    train(alg, theta0, solver, grad_fn, 1, key + 1)      # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    hist = train(alg, theta0, solver, grad_fn, n_rounds, key,
                 eval_fn=eval_fn, eval_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.launches)
    series = [hist.loss, *hist.extra.values()]
    require(all(math.isfinite(v) for s in series for v in s),
            f"scaleup: non-finite Θ or metrics: {hist}")
    _per_round(launches, n_rounds, {
        "population_step": 1, "ota_modulate": 1, "ota_receive": 1,
        "admm_dual_update": 1, "fading_step": 0})

    # the receive at this shape: one thread per column has 32 columns
    gen = rng.generator(SEED + 5, dev)
    planes = [torch.randn((W, D), generator=gen, device=dev)
              for _ in range(4)]
    z = torch.randn(D, generator=gen, device=dev)
    ia = torch.tensor(0.5, device=dev)
    recv_ms = time_ms(torch, lambda: ota.ota_receive(*planes, z, ia))
    recv_bytes = 4 * W * D * 4 + 2 * D * 4 + 4
    emit({"phase": "scaleup", "ok": True, "W": W, "d": D,
          "scenario": "urban-mobility", "freq_flat": True, "rounds": n_rounds,
          "seconds_per_round": run_s / n_rounds, "theta_rms": hist.loss,
          "inv_alpha": hist.extra["inv_alpha"],
          "receive_ms": recv_ms, "receive_bytes": recv_bytes,
          "receive_bound_ms": recv_bytes / mem_rate * 1e3,
          "launches": launches})
    return launches


def _kernel_family(name: str) -> str:
    for fn in ("receive_masked_kernel", "fading_step_kernel",
               "population_step_kernel", "modulate_kernel", "receive_kernel",
               "dual_update_kernel", "flip_lambda_kernel"):
        if fn in name:
            return "port:" + fn
    if "gemm" in name or "xmma" in name:
        return "matmul"
    if "elementwise" in name:
        return "elementwise"
    if "reduce" in name:
        return "reduction"
    return "other"


def phase_profile(torch, path: str, alg, run, round_s: float):
    """One more MLP round of ``path`` under ``torch.profiler``: device time
    of every kernel (kernel events only: ``key_averages`` also credits each
    kernel's time to the ``aten::`` op that launched it), grouped by family,
    and its share of the unprofiled round time of that path's phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.fl_trainer import train

    theta0, solver, grad_fn = (run[k] for k in ("theta0", "solver",
                                                "grad_fn"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(alg, theta0, solver, grad_fn, 1, SEED + 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    families: dict = {}
    for e in kernels:
        fam = families.setdefault(_kernel_family(e.key),
                                  {"calls": 0, "device_ms": 0.0})
        fam["calls"] += e.count
        fam["device_ms"] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    emit({"phase": "profile", "path": path, "ok": True, "rounds": 1,
          "profiled_wall_ms": wall_ms, "round_ms": round_s * 1e3,
          "device_ms": device_ms if kernels else None,
          "busy_share": device_ms / (round_s * 1e3) if kernels else None,
          "families": families,
          "top": [{"name": e.key[:90], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in top]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is not at {SRC}/repro_torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    try:
        name, smi = phase_device(torch)
        phase_build(build)
        rows = phase_kernels(torch, name)
        paths = {}
        paths["mlp"], mlp_run, round_s = phase_mlp(torch)
        paths["linreg"] = phase_linreg(torch)
        paths["scenario_markov"], _, _ = phase_scenario(
            torch, mlp_run, "scenario_markov", "markov-doppler", csi_err=0.1)
        paths["scenario_deepfade"], fade_alg, fade_s = phase_scenario(
            torch, mlp_run, "scenario_deepfade", "deep-fade-truncation")
        paths["scaleup"] = phase_scaleup(torch, name)
        phase_profile(torch, "mlp", mlp_run["alg"], mlp_run, round_s)
        phase_profile(torch, "scenario_deepfade", fade_alg, mlp_run, fade_s)
    except SmokeFailure as e:
        emit({"ok": False, "error": str(e)})
        return 1
    table = []
    for row in rows.values():
        fn_name = row["name"].split("[")[0]
        by_path = {p: n.get(fn_name, 0) for p, n in paths.items()}
        row = dict(row, launches=sum(by_path.values()),
                   launches_by_path=by_path)
        if row["launches"] == 0:
            emit({"ok": False, "error": f"{fn_name} never ran on a main path"})
            return 1
        table.append(row)
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
