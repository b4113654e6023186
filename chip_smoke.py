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
             65,536 workers; the one-pass round at (65,536, 32); each LLM
             round's B6, dual update and demodulation at its (W, D) and
             (D,), D from the path's config: granite-8b's 637,554,688,
             falcon-mamba-7b's 476,967,488 and the reduced hybrid's
             568,192; flash attention B11 — forward,
             dq, dk/dv — at the LLM round's (2, 32, 4096, 128) in bf16 (the
             tensor-core kernels) and on a ragged causal and a non-causal
             (1, 2, 1000, 64) case in bf16 and in f32 (the SIMT kernels);
             B2 at the scaleup phase's (65,536, 32) on its split plan with
             the unsplit time beside it, and at the MLP's width on its
             unsplit plan, bit for bit a launch forced onto that path; B6
             at each LLM D on the column plan with the row plan's time
             beside it, and B7 at falcon-mamba-7b's D masked, with CSI and
             the fused channel step (each B2/B6/B7 row names its ``plan``);
             the gated linear scan B12 — forward
             and backward — at the SSM round's (2, 4,096, 131,072), the
             hybrid's full-width (2, 4,096, 2,560), the hybrid path's
             (4, 128, 128) and a ragged (3, 1,000, 100); the accumulate
             B13 at d = 109,386), in each
             mode a path uses, each CUDA kernel against its plain PyTorch
             version on the same inputs, with its device time (``ms``,
             median of CUDA-event timings behind a GPU spin), its time with
             the host's launch (``ms_with_launch``), the plain version's
             times, its bound (bytes over the card's memory rate, or
             operations over the card's rate for their type, whichever is
             larger) and, for B11, SDPA's time (``library_ms``).
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
9. fused_round — ``transport.ota_round_fused`` at W = 100, d = 109,386
             (power control, ``power_control=False``, ``worker_chunk=32``,
             a deep-fade mask with CSI error, the fused AR(1) step), each
             against the composed ``ota_uplink`` on the same inputs, with
             its launches gated and both timed.
10. chaos  — the MLP of phase 4 under ``markov-doppler`` for 20 rounds
             fault-free, then 20 with 25 workers crashing, a NaN worker and
             interference bursts under the evict-retransmit guard
             (``make("afadmm", ..., faults=..., guard=...)`` and ``train``).
11. profile — one more round of phases 4, 7 and 10 each under
             torch.profiler: device time by kernel family, its share of the
             phase's round time, and the guarded uplink's span.
12. accumulate — the worker-at-a-time receive at the paper MLP's width
             (W = 100, d = 109,386): ``transport.ota_accumulate`` (B13) once
             per worker, then ``ota_receive_accumulated`` (one B3), held
             against the stacked receive (B2) on the same draws.
13. llm    — the federated LLM trainer's replicated mode
             (``make_fl_train`` / ``train_step``) on granite-8b at full
             width (d_model 4096, 32/8 heads of 128, d_ff 14,336, vocabulary
             49,152, bf16) with 2 of its 36 layers: 2 workers, 1 × 4,096
             tokens each, 2 local sgd steps at lr 5e-4, 3 rounds; then one
             more round under torch.profiler.
14. llm_ssm — the same trainer on falcon-mamba-7b at full width (d_model
             4096, d_inner 8,192, state 16, dt rank 256, conv 4, vocabulary
             65,024, bf16) with 2 of its 64 layers: 2 workers, 1 × 4,096
             tokens each, 2 local sgd steps, 3 rounds; then one more round
             under torch.profiler.
15. llm_hybrid — the same trainer on recurrentgemma-2b at its reduced
             widths (one super-block: rec, rec, windowed attention) in f32,
             2 workers, 3 rounds on the card and the same rounds on the CPU
             from the same state and draws: losses to rtol 1e-5, Θ to atol
             1e-5.

Launch counts are reset just before each of phases 4–10 and 12–15 and read
just after.  Then come the kernel table as one JSON line, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  Without a card, or run from a
directory that lacks ``src/repro_torch``, it exits non-zero before printing
a result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
SEED = 0
W_FULL = 100
TIMED_RUNS = 25
#: (memory bytes/s, fp32 flop/s outside the tensor cores, dense bf16 flop/s
#: of the tensor cores): NVIDIA data sheets
CARD_PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
              "H100 NVL": (3.9e12, 60e12, 835e12),
              "H100": (3.35e12, 67e12, 989e12),
              "H200": (4.8e12, 67e12, 989e12)}


class SmokeFailure(Exception):
    pass


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    raise SmokeFailure(f"no data-sheet peaks for card {name!r}")


#: the profiler span around the guarded uplink (``core/admm.py``)
GUARD_SPAN = "guarded_ota_round"

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


#: elements compared at a time: a (2, 637,554,688) plane is 5.1 GB, and the
#: comparison's temporaries stay at a chunk's size
ERR_CHUNK = 1 << 26


def _max_err(outs, refs, rtol: float, atol: float):
    """(max |a − b|, max |a − b| / (atol + rtol·|b|)) in f32; the kernel
    agrees when the second is ≤ 1 (0 for an exact match when both are 0)."""
    max_abs, worst = 0.0, 0.0
    for a, b in zip(outs, refs):
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), ERR_CHUNK):
            x, y = a[i:i + ERR_CHUNK].float(), b[i:i + ERR_CHUNK].float()
            diff = (x - y).abs()
            max_abs = max(max_abs, float(diff.max()))
            worst = max(worst, _err_ratio(diff, atol + rtol * y.abs()))
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
    from repro_torch.kernels import (admm_update, build, ota, ota_round,
                                     phy_channel, phy_population, ref)
    from repro_torch.phy import doppler_rho, innovation_scale

    _, (mem_rate, f32_rate, _) = card_peaks(card)
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
    # B6/B7: the workers' CSI (σ_e = 0.1) and, under the mask, a NaN θ row
    tx_re, tx_im = h_re + 0.1 * plane(), h_im + 0.1 * plane()
    theta_bad = theta.clone()
    theta_bad[dropped[0]] = float("nan")
    bad_row = int(dropped[0])
    scale_f = innovation_scale(rho_f)
    # B6 at the scaleup phase's (65,536, 32)
    big = [torch.randn((65_536, 32), generator=gen, device=dev)
           * (0.05 if i == 0 else 1.0) for i in range(5)]
    y_vec, p2_vec = noise * 1e3, torch.rand(d, generator=gen, device=dev) * W
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

    def drop_nan_row(outs):
        """B6 under the mask: the NaN row's energy is NaN (it is every
        row's energy); compare the other rows."""
        require(bool(torch.isnan(outs[2][bad_row])),
                "the NaN row's energy is not NaN")
        keep = torch.arange(W, device=dev) != bad_row
        return (outs[0], outs[1], outs[2][keep])

    n_sm = ota_round.sm_count(dev)

    def receive_plan(rows, cols):
        return ota.receive_tiling(rows, cols, n_sm)

    def unsplit(rows, cols):
        return ota_round.Tiling("unsplit", 1, rows,
                                -(-cols // ota.RECEIVE_THREADS), 1)

    def receive_unsplit_bits(rows, cols):
        """B2 at the paper MLP's width keeps its one-thread-a-column
        kernel: the planner picks it, and its Θ is bit for bit a launch
        forced onto that path."""
        plan = receive_plan(rows, cols)
        require(plan.plan == "unsplit",
                f"ota_receive: ({rows}, {cols}) planned {plan}")
        got = ota.ota_receive(s_re, s_im, h_re, h_im, noise, ia)
        old = ota.ota_receive(s_re, s_im, h_re, h_im, noise, ia,
                              plan=unsplit(rows, cols))
        require(bool(torch.equal(got, old)),
                "ota_receive: the planned launch and the unsplit path differ")
        return {"plan": plan.plan, "bitwise_equal_to_unsplit": True}

    def round_plan(rows, cols):
        return {"plan": ota_round.tiling(rows, cols, n_sm).plan}

    # one pass of B6/B7: planes in and out, y and p2 (d,), energy (W,)
    def round_bytes(n_in, n_out, rows=W, cols=d, energy=True):
        return 4 * (rows * cols * (n_in + n_out) + 2 * cols
                    + (rows if energy else 0))

    # name, TPU kernel, source, kernel call, plain call, bytes, flops, tol,
    # shape, extra fields of the row[, outputs to compare]
    cases = [
        ("ota_modulate", "src/repro/kernels/ota.py:99", "ota",
         lambda: ota.ota_modulate(theta, lam_re, lam_im, h_re, h_im, rho),
         lambda: ref.ota_modulate(theta, lam_re, lam_im, h_re, h_im, rho),
         7 * plane_b, 6 * W * d, (1e-5, 1e-5)),
        ("ota_receive", "src/repro/kernels/ota.py:201", "ota",
         lambda: ota.ota_receive(s_re, s_im, h_re, h_im, noise, ia),
         lambda: ref.ota_receive(s_re, s_im, h_re, h_im, noise, ia),
         4 * plane_b + 2 * vec_b + 4, 8 * W * d + 3 * d, (1e-5, 1e-6),
         [W, d], receive_unsplit_bits(W, d)),
        ("ota_receive[inv_alpha=0]", "src/repro/kernels/ota.py:201", "ota",
         lambda: ota.ota_receive(s_re, s_im, h_re, h_im, noise, ia_zero),
         lambda: ref.ota_receive(s_re, s_im, h_re, h_im, noise, ia_zero),
         4 * plane_b + 2 * vec_b + 4, 8 * W * d + 3 * d, (1e-5, 1e-6),
         [W, d], {"plan": receive_plan(W, d).plan}),
        # B2 at the scaleup phase's (65,536, 32): four planes in, Θ out;
        # the worker axis split, its unsplit time beside it
        ("ota_receive[(65,536, 32)]", "src/repro/kernels/ota.py:201", "ota",
         lambda: ota.ota_receive(*big[1:], noise[:32], ia),
         lambda: ref.ota_receive(*big[1:], noise[:32], ia),
         4 * 4 * 65_536 * 32 + 2 * 4 * 32 + 4, 8 * 65_536 * 32 + 3 * 32,
         (1e-5, 1e-6), [65_536, 32], {
             "plan": receive_plan(65_536, 32).plan,
             "unsplit_ms": time_ms(torch, lambda: ota.ota_receive(
                 *big[1:], noise[:32], ia,
                 plan=unsplit(65_536, 32)))}),
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
        # y/p2 sum 100 terms of size ~1.4 in another order than the plain
        # version's: atol 1e-4 (a reordering moves such sums by ~1e-6 to
        # 1e-5); energies sum 109,386 terms and are held by rtol
        ("ota_round_stats", "src/repro/kernels/ota_round.py:203",
         "ota_round",
         lambda: ota_round.ota_round_stats(theta, lam_re, lam_im, h_re, h_im,
                                           rho),
         lambda: ref.ota_round_stats(theta, lam_re, lam_im, h_re, h_im, rho),
         round_bytes(5, 0), 18 * W * d, (1e-5, 1e-4), [W, d],
         round_plan(W, d)),
        # every row is read: the energy is promised for masked rows too
        ("ota_round_stats[mask, h_tx, NaN row]",
         "src/repro/kernels/ota_round.py:203", "ota_round",
         lambda: ota_round.ota_round_stats(theta_bad, lam_re, lam_im, h_re,
                                           h_im, rho, mask=mask,
                                           htx=(tx_re, tx_im)),
         lambda: ref.ota_round_stats(theta_bad, lam_re, lam_im, h_re, h_im,
                                     rho, mask=mask, htx=(tx_re, tx_im)),
         round_bytes(7, 0) + W, 18 * W * d, (1e-5, 1e-4), [W, d],
         round_plan(W, d), drop_nan_row),
        ("ota_round_stats[channel step]",
         "src/repro/kernels/ota_round.py:203", "ota_round",
         lambda: ota_round.ota_round_stats(
             theta, lam_re, lam_im, h_re, h_im, rho,
             chan=(w_re, w_im, rho_f, scale_f, True)),
         lambda: ref.ota_round_stats(
             theta, lam_re, lam_im, h_re, h_im, rho,
             chan=(w_re, w_im, rho_f, scale_f, True)),
         round_bytes(7, 2), 24 * W * d, (1e-5, 1e-4), [W, d],
         round_plan(W, d)),
        # the held channel reads no innovations
        ("ota_round_stats[channel step, held]",
         "src/repro/kernels/ota_round.py:203", "ota_round",
         lambda: ota_round.ota_round_stats(
             theta, lam_re, lam_im, h_re, h_im, rho,
             chan=(w_re, w_im, rho_f, scale_f, False)),
         lambda: ref.ota_round_stats(
             theta, lam_re, lam_im, h_re, h_im, rho,
             chan=(w_re, w_im, rho_f, scale_f, False)),
         round_bytes(5, 2), 18 * W * d, (1e-5, 1e-4), [W, d],
         round_plan(W, d)),
        # 65,536 terms a column: a reordering moves y by up to ~1e-3
        ("ota_round_stats[(65,536, 32)]",
         "src/repro/kernels/ota_round.py:203", "ota_round",
         lambda: ota_round.ota_round_stats(*big, rho),
         lambda: ref.ota_round_stats(*big, rho),
         round_bytes(5, 0, 65_536, 32), 18 * 65_536 * 32, (1e-5, 1e-3),
         [65_536, 32], round_plan(65_536, 32)),
        ("ota_round_theta", "src/repro/kernels/ota_round.py:223",
         "ota_round",
         lambda: ota_round.ota_round_theta(theta, lam_re, lam_im, h_re, h_im,
                                           noise, ia, rho),
         lambda: ref.ota_round_theta(theta, lam_re, lam_im, h_re, h_im,
                                     noise, ia, rho),
         round_bytes(5, 0, energy=False) + 4, 20 * W * d, (1e-5, 1e-6),
         [W, d], round_plan(W, d)),
        # elementwise, rounded as the plain version rounds
        ("ota_demodulate_dyn", "src/repro/kernels/ota.py:147", "ota",
         lambda: ota.ota_demodulate_dyn(y_vec, noise, p2_vec, ia),
         lambda: ref.ota_demodulate_dyn(y_vec, noise, p2_vec, ia),
         4 * vec_b + 4, 4 * d, (1e-6, 1e-7), [d], {}),
        ("ota_demodulate", "src/repro/kernels/ota.py:121", "ota",
         lambda: ota.ota_demodulate(y_vec, noise, p2_vec, 1.0),
         lambda: ref.ota_demodulate(y_vec, noise, p2_vec, 1.0),
         4 * vec_b, 4 * d, (1e-6, 1e-7), [d], {}),
        # one worker's term into the running sums: six (d,) planes in, two
        # out; rounded as the plain version rounds
        ("ota_accumulate", "src/repro/kernels/ota.py:171", "ota",
         lambda: ota.ota_accumulate(y_vec, p2_vec, s_re[0], s_im[0],
                                    h_re[0], h_im[0]),
         lambda: ref.ota_accumulate(y_vec, p2_vec, s_re[0], s_im[0],
                                    h_re[0], h_im[0]),
         8 * vec_b, 6 * d, (0.0, 0.0), [d], {}),
    ]
    cases = [c if len(c) >= 10 else (*c, [W, d], {}) for c in cases]
    results = {}
    for case in cases:
        row = _kernel_row(torch, build, mem_rate, f32_rate, *case)
        results[row["name"]] = row
    del cases
    shapes = _llm_round_shapes()
    for W, d in shapes:
        results.update(_llm_round_rows(torch, build, mem_rate, f32_rate, W,
                                       d))
    # B7 at the SSM round's ragged D (no multiple of 128) in every mode
    results.update(_llm_theta_row(torch, build, mem_rate, f32_rate,
                                  *shapes[1]))
    results.update(_flash_rows(torch, build, card))
    results.update(_scan_rows(torch, build, mem_rate, f32_rate))
    return results


def _kernel_row(torch, build, mem_rate, op_rate, name, replaces, lib, kernel,
                plain, nbytes, flops, tol, shape, extra, select=None,
                tol_of=None, library=None):
    """One row of the kernel table: launch once (the counter must rise),
    hold the outputs against the plain version, time both, and the library
    call that computes the same function where there is one.  ``tol`` is
    (rtol, atol); ``tol_of(ref)`` gives each output its own instead.
    ``flops`` are counted at ``op_rate``; ``select`` picks the outputs to
    compare."""
    fn_name = name.split("[")[0]
    before = build.launches[fn_name]
    out = kernel()
    torch.cuda.synchronize()
    require(build.launches[fn_name] == before + 1,
            f"{name}: the launch counter did not rise")
    outs = out if isinstance(out, tuple) else (out,)
    want = plain()
    refs = want if isinstance(want, tuple) else (want,)
    if select is not None:
        outs, refs = select(outs), select(refs)
    require(all(bool(torch.isfinite(o).all()) for o in outs),
            f"{name}: non-finite output")
    tols = [tol if tol_of is None else tol_of(b) for b in refs]
    max_abs, err_over_tol = 0.0, 0.0
    for a, b, (rtol, atol) in zip(outs, refs, tols):
        m_abs, ratio = _max_err([a], [b], rtol, atol)
        max_abs, err_over_tol = max(max_abs, m_abs), max(err_over_tol, ratio)
    require(err_over_tol <= 1.0,
            f"{name}: kernel and plain version disagree beyond (rtol, atol) "
            f"{tols} (max abs err {max_abs}, {err_over_tol} of the "
            f"tolerance)")
    del out, outs, want, refs
    kernel_ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain)
    bytes_ms = nbytes / mem_rate * 1e3
    flops_ms = flops / op_rate * 1e3
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{lib}.cu",
           "replaces": replaces, "max_abs_err": max_abs,
           "err_over_tol": err_over_tol,
           "rtol": tols[0][0], "atol": tols[0][1], "ok": True,
           "ms": kernel_ms, "plain_ms": plain_ms,
           "kernel_ms": kernel_ms, "ref_ms": plain_ms,
           "ms_with_launch": time_ms(torch, kernel, spin=False),
           "plain_ms_with_launch": time_ms(torch, plain, spin=False),
           "bytes": nbytes, "flops": flops, "op_rate": op_rate,
           "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
           "library_ms": None if library is None
           else time_ms(torch, library), "shape": shape, **extra}
    if tol_of is not None:
        row["output_tols"] = tols
    emit({"phase": "kernels", **row})
    return row


def _llm_round_shapes():
    """(W, D) of the packed round of each LLM path, D from the path's own
    config: granite-8b (``llm``, W·D = 1.28·10⁹, near 2³¹), falcon-mamba-7b
    (``llm_ssm``, whose D is not a multiple of B6's 128-column tiles) and
    the reduced hybrid (``llm_hybrid``)."""
    from repro_torch.models.registry import packed_param_count

    return [(LLM_WORKERS, packed_param_count(_llm_cfg(arch, n_layers)))
            for arch, n_layers in ((LLM_ARCH, LLM_LAYERS),
                                   (SSM_ARCH, SSM_LAYERS))] + [
        (HYBRID_WORKERS, packed_param_count(_hybrid_cfg()))]


def _llm_round_rows(torch, build, mem_rate, f32_rate, W: int, d: int):
    """The OTA kernels of an LLM round at its (W, D): B6 and B4 on the same
    five (W, D) planes (25.5 GB at granite's) and Θ, then B3 on three (D,)
    vectors; each set is freed when its rows are done."""
    from repro_torch import rng
    from repro_torch.kernels import admm_update, ota, ota_round, ref

    dev = torch.device("cuda")
    gen = rng.generator(SEED + 13, dev)
    shape = [W, d]
    label = f"[({W}, {d:,})]"
    theta, lam_re, lam_im, h_re, h_im = (
        torch.randn((W, d), generator=gen, device=dev)
        * (0.05 if i == 0 else math.sqrt(0.5)) for i in range(5))
    Theta = torch.randn(d, generator=gen, device=dev) * 0.05
    rows = {}
    plan = ota_round.tiling(W, d, ota_round.sm_count(dev))
    row_plan = ota_round.row_tiling(W, d)
    # y/p2 sum two workers (the same two terms in either order); the energy
    # sums up to 637.6 M terms, which the column plan groups per thread
    # over its grid stride, then per block, then over ~10³ block partials:
    # held by rtol 1e-4.  The row plan's time on the same planes (its
    # 128-column tiles and one-warp-a-row finalize) stands beside it.
    rows["b6"] = _kernel_row(
        torch, build, mem_rate, f32_rate, "ota_round_stats" + label,
        "src/repro/kernels/ota_round.py:203", "ota_round",
        lambda: ota_round.ota_round_stats(theta, lam_re, lam_im, h_re, h_im,
                                          0.5),
        lambda: ref.ota_round_stats(theta, lam_re, lam_im, h_re, h_im, 0.5),
        4 * (W * d * 5 + 2 * d + W), 18 * W * d, (1e-4, 1e-4), shape,
        {"plan": plan.plan, "tiling": list(plan),
         "row_plan_ms": time_ms(torch, lambda: ota_round.ota_round_stats(
             theta, lam_re, lam_im, h_re, h_im, 0.5, plan=row_plan))})
    # elementwise: five planes and Θ in, two planes out, as at (100, 109,386)
    rows["b4"] = _kernel_row(
        torch, build, mem_rate, f32_rate, "admm_dual_update" + label,
        "src/repro/kernels/admm_update.py:42", "admm_update",
        lambda: admm_update.admm_dual_update(lam_re, lam_im, h_re, h_im,
                                             theta, Theta, 0.5),
        lambda: ref.admm_dual_update(lam_re, lam_im, h_re, h_im, theta,
                                     Theta, 0.5),
        4 * (W * d * 7 + d), 8 * W * d, (1e-5, 1e-5), shape, {})
    del theta, lam_re, lam_im, h_re, h_im, Theta
    torch.cuda.empty_cache()
    # B3 at the round's (D,): y and p2 of two workers' sums, the matched
    # filter's noise, α⁻¹ on the device; rounded as the plain version rounds
    y = torch.randn(d, generator=gen, device=dev)
    noise = torch.randn(d, generator=gen, device=dev) * 7e-4
    p2 = torch.rand(d, generator=gen, device=dev) * W
    ia = torch.tensor(0.37, device=dev)
    rows["b3"] = _kernel_row(
        torch, build, mem_rate, f32_rate,
        f"ota_demodulate_dyn[({d:,})]",
        "src/repro/kernels/ota.py:147", "ota",
        lambda: ota.ota_demodulate_dyn(y, noise, p2, ia),
        lambda: ref.ota_demodulate_dyn(y, noise, p2, ia),
        4 * 4 * d + 4, 4 * d, (1e-6, 1e-7), [d], {})
    del y, noise, p2, ia
    torch.cuda.empty_cache()
    return {row["name"]: row for row in rows.values()}


#: columns of the chunked plain version of B7 at an LLM D: its temporaries
#: stay at a chunk's size
THETA_CHUNK = 1 << 26


def _llm_theta_row(torch, build, mem_rate, f32_rate, W: int, d: int):
    """B7 at an LLM round's (W, D) in the masked, CSI and fused-channel mode
    (nine (W, D) planes in, the stepped channel's two out: 42 GB at
    falcon-mamba-7b's D), worker 1 masked with a NaN θ row.  Θ is
    columnwise, so the plain version runs in column chunks into its
    outputs; the planes are freed after the row."""
    from repro_torch import rng
    from repro_torch.kernels import ota_round, ref

    dev = torch.device("cuda")
    gen = rng.generator(SEED + 29, dev)
    theta, lam_re, lam_im, h_re, h_im, tx_re, tx_im, w_re, w_im = (
        torch.randn((W, d), generator=gen, device=dev)
        * (0.05 if i == 0 else math.sqrt(0.5)) for i in range(9))
    theta[W - 1] = float("nan")
    mask = torch.arange(W, device=dev) != W - 1
    noise = torch.randn(d, generator=gen, device=dev) * 7e-4
    ia = torch.tensor(0.37, device=dev)
    rho_f = 0.9755
    chan = (w_re, w_im, rho_f, math.sqrt(1 - rho_f ** 2), True)
    planes = (theta, lam_re, lam_im, h_re, h_im)
    plan = ota_round.tiling(W, d, ota_round.sm_count(dev))

    def plain():
        Theta = torch.empty(d, device=dev)
        hn_re = torch.empty((W, d), device=dev)
        hn_im = torch.empty((W, d), device=dev)
        for a in range(0, d, THETA_CHUNK):
            b = min(d, a + THETA_CHUNK)
            out = ref.ota_round_theta(
                *(x[:, a:b] for x in planes), noise[a:b], ia, 0.5,
                mask=mask, htx=(tx_re[:, a:b], tx_im[:, a:b]),
                chan=(w_re[:, a:b], w_im[:, a:b], *chan[2:]))
            Theta[a:b], hn_re[:, a:b], hn_im[:, a:b] = out
        return Theta, hn_re, hn_im

    # Θ as at (100, 109,386); the column plan rounds as the plain version
    # does, so the two agree to the bit where the W = 2 sums run in order
    row = _kernel_row(
        torch, build, mem_rate, f32_rate,
        f"ota_round_theta[({W}, {d:,}) mask+csi+chan]",
        "src/repro/kernels/ota_round.py:223", "ota_round",
        lambda: ota_round.ota_round_theta(*planes, noise, ia, 0.5,
                                          mask=mask, htx=(tx_re, tx_im),
                                          chan=chan),
        plain, 4 * (W * d * 11 + 2 * d) + W + 4, 26 * W * d, (1e-5, 1e-6),
        [W, d], {"plan": plan.plan, "tiling": list(plan),
                 "mode": "mask+csi+chan"})
    del theta, lam_re, lam_im, h_re, h_im, tx_re, tx_im, w_re, w_im, planes
    del chan, noise, mask
    torch.cuda.empty_cache()
    return {row["name"]: row}


#: B11 rows: (label, B, H, S, hd, dtype name, causal).  The trainer's shape
#: (granite-8b: 32 heads of 128 after GQA's repeat, W·B = 2, S = 4,096) in
#: bf16, and a ragged causal S = 1,000 and a non-causal one in each dtype:
#: bf16 runs the tensor-core kernels, f32 the SIMT ones, each with its own
#: masking
FLASH_CASES = (("", 2, 32, 4096, 128, "bfloat16", True),
               ("[bf16 ragged (1, 2, 1000, 64)]", 1, 2, 1000, 64, "bfloat16",
                True),
               ("[bf16 non-causal (1, 2, 1000, 64)]", 1, 2, 1000, 64,
                "bfloat16", False),
               ("[f32 ragged (1, 2, 1000, 64)]", 1, 2, 1000, 64, "float32",
                True),
               ("[f32 non-causal (1, 2, 1000, 64)]", 1, 2, 1000, 64,
                "float32", False))
#: which cores each dtype's B11 kernels run on (``flash_attention.cu``)
FLASH_CORES = {"bfloat16": "tensor cores", "float32": "simt"}


def _flash_rows(torch, build, card):
    """B11's forward, dq and dk/dv against their plain versions on the same
    inputs (the backward kernels take the forward kernel's lse and δ, as the
    autograd.Function hands them over), with SDPA as the library yardstick.

    Tolerances.  bf16: the outputs are rounded to bf16 (half an ulp is 2e-3
    of a value, on either side), so rtol 1e-2, with atol 1e-3 of the
    largest reference value for entries near zero, where the f32 sums over
    up to 4,096 keys differ only in order.  f32: rtol 1e-4, atol 1e-5 of the
    largest value (summation order).  lse (f32 in both): rtol and atol
    1e-5 (summation order of l)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch import rng
    from repro_torch.kernels import flash_attention as fa, ref

    _, (mem_rate, f32_rate, bf16_rate) = card_peaks(card)
    dev = torch.device("cuda")
    rows = {}
    for label, B, H, S, hd, dtype_name, causal in FLASH_CASES:
        dtype = getattr(torch, dtype_name)
        gen = rng.generator(SEED + 17, dev)
        q, k, v, do = (torch.randn((B, H, S, hd), generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = fa.attention_delta(o, do)
        rtol, rel_atol = (1e-2, 1e-3) if dtype == torch.bfloat16 \
            else (1e-4, 1e-5)

        def tol_of(b, rtol=rtol, rel_atol=rel_atol, dtype=dtype):
            if b.dtype == torch.float32 and dtype != torch.float32:
                return (1e-5, 1e-5)                             # lse
            return (rtol, rel_atol * float(b.float().abs().max()))

        esize = q.element_size()
        plane = B * H * S * hd * esize
        vec = 4 * B * H * S
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        rate = bf16_rate if dtype == torch.bfloat16 else f32_rate
        backend = [SDPBackend.FLASH_ATTENTION] if dtype == torch.bfloat16 \
            else [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.MATH]

        def sdpa_fwd():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)

        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        with sdpa_kernel(backend):
            sdpa_out = F.scaled_dot_product_attention(*leaves,
                                                      is_causal=causal)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, leaves, do,
                                       retain_graph=True)

        sdpa_bwd_what = "SDPA backward (dq, dk and dv together)"
        specs = [
            ("flash_attention_fwd", "src/repro/kernels/flash_attention.py:125",
             lambda: fa.flash_attention_fwd(q, k, v, causal),
             lambda: ref.flash_attention_fwd(q, k, v, causal),
             4 * plane + vec, 4 * hd * pairs, sdpa_fwd, "SDPA forward"),
            ("flash_attention_dq", "src/repro/kernels/flash_attention.py:275",
             lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
             lambda: ref.flash_attention_bwd(q, k, v, do, causal, lse=lse,
                                             delta=delta)[0],
             5 * plane + 2 * vec, 6 * hd * pairs, sdpa_bwd, sdpa_bwd_what),
            ("flash_attention_dkv", "src/repro/kernels/flash_attention.py:291",
             lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, causal),
             lambda: ref.flash_attention_bwd(q, k, v, do, causal, lse=lse,
                                             delta=delta)[1:],
             6 * plane + 2 * vec, 8 * hd * pairs, sdpa_bwd, sdpa_bwd_what),
        ]
        for fn_name, replaces, kernel, plain, nbytes, flops, library, \
                lib_what in specs:
            row = _kernel_row(
                torch, build, mem_rate, rate, fn_name + label, replaces,
                "flash_attention", kernel, plain, nbytes, flops,
                (rtol, rel_atol), [B, H, S, hd],
                {"library": lib_what, "dtype": dtype_name, "causal": causal,
                 "cores": FLASH_CORES[dtype_name], "atol_of_max": rel_atol},
                tol_of=tol_of, library=library)
            rows[row["name"]] = row
        del q, k, v, do, o, lse, delta, leaves, sdpa_out
    torch.cuda.empty_cache()
    return rows


def _scan_cases():
    """B12 rows: (label, B, S, D), from the paths' configs.  The SSM
    round's planes (``llm_ssm``: W·B sequences of its tokens by
    d_inner·ssm_state channels), the hybrid's at full width
    (recurrentgemma-2b's lru_width at the granite path's W·B and S), the
    ``llm_hybrid`` path's reduced ones, and a ragged case."""
    from repro_torch.models import get_config

    ssm_cfg = get_config(SSM_ARCH)
    full, reduced = get_config(HYBRID_ARCH), _hybrid_cfg()
    return [("", LLM_WORKERS, SSM_SEQ, ssm_cfg.d_inner * ssm_cfg.ssm_state),
            ("[hybrid ({}, {}, {})]", LLM_WORKERS, LLM_SEQ, full.lru_width),
            ("[hybrid path ({}, {}, {})]", HYBRID_WORKERS * HYBRID_BATCH,
             HYBRID_SEQ, reduced.lru_width),
            ("[ragged ({}, {}, {})]", 3, 1000, 100)]


def _scan_rows(torch, build, mem_rate, f32_rate):
    """B12's forward and backward against their plain versions (sequential
    loops that round each step as the kernels do) on gates in (0, 1), as
    exp(dt·A) gives them.  Bytes: the forward needs a_1 … a_{S−1} (h_0 =
    b_0), all of b, and writes h; the backward needs a_1 … a_{S−1},
    h_0 … h_{S−2} and all of dh, and writes g = db and da.  No single
    PyTorch call computes a linear recurrence: ``library_ms`` is null.
    Both kernels are held to the plain versions' bits (tolerance 0)."""
    from repro_torch import rng
    from repro_torch.kernels import linear_scan as ls, ref

    dev = torch.device("cuda")
    rows = {}
    for label, B, S, D in _scan_cases():
        label = label.format(B, S, D)
        gen = rng.generator(SEED + 19, dev)
        a = torch.sigmoid(2.0 * torch.randn((B, S, D), generator=gen,
                                            device=dev))
        b = torch.randn((B, S, D), generator=gen, device=dev)
        dh = torch.randn((B, S, D), generator=gen, device=dev)
        h = ls.linear_scan_fwd(a, b)
        n, n1 = B * S * D, B * (S - 1) * D
        specs = [
            ("linear_scan_fwd", lambda: ls.linear_scan_fwd(a, b),
             lambda: ref.linear_scan(a, b), 4 * (n1 + 2 * n), 2 * n1),
            ("linear_scan_bwd", lambda: ls.linear_scan_bwd(a, h, dh),
             lambda: ref.linear_scan_bwd(a, h, dh), 4 * (2 * n1 + 3 * n),
             2 * n1 + n),
        ]
        for fn_name, kernel, plain, nbytes, flops in specs:
            row = _kernel_row(
                torch, build, mem_rate, f32_rate, fn_name + label,
                "src/repro/kernels/linear_scan.py:60", "linear_scan", kernel,
                plain, nbytes, flops, (0.0, 0.0), [B, S, D],
                {"library": "none: no PyTorch call computes a linear "
                 "recurrence"})
            rows[row["name"]] = row
        del a, b, dh, h
        torch.cuda.empty_cache()
    return rows


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
    from repro_torch.kernels import build, ota, ota_round
    from repro_torch.phy import make_scenario
    from repro_torch.train.fl_trainer import train

    _, (mem_rate, _, _) = card_peaks(card)
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

    # the receive at this shape: 32 columns, the worker axis split
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
          "receive_plan": list(ota.receive_tiling(
              W, D, ota_round.sm_count(dev))),
          "receive_bound_ms": recv_bytes / mem_rate * 1e3,
          "launches": launches})
    return launches


def phase_fused_round(torch):
    """``transport.ota_round_fused`` at the paper MLP's width (W = 100,
    d = 109,386), each variant held against the composed ``ota_uplink`` on
    the same inputs and noise plane, with its launches gated and both
    timed on the device."""
    from repro_torch import rng
    from repro_torch.core import transport
    from repro_torch.core.channel import ChannelConfig, rayleigh
    from repro_torch.kernels import build
    from repro_torch.phy import doppler_rho, gauss_markov_step, make_scenario

    dev = torch.device("cuda")
    W, d, rho = W_FULL, 109_386, 0.5
    gen = rng.generator(SEED + 7, dev)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0)
    theta = torch.randn((W, d), generator=gen, device=dev) * 0.05
    lam = rayleigh(gen, (W, d))
    h = rayleigh(gen, (W, d))
    w = rayleigh(gen, (W, d))
    noise = transport.matched_filter_noise_re(gen, (d,), ccfg)
    # deep-fade-truncation with CSI error 0.1: its state's broadcast fades,
    # estimates and participation mask
    fade = make_scenario("deep-fade-truncation", ccfg, csi_err=0.1).init(
        SEED + 8, W, d, dev)
    rho_f = doppler_rho(50.0, 1e-3)

    def composed_chan():
        h2 = gauss_markov_step(h, w, rho_f, True)
        return (*transport.ota_uplink(theta, lam, h2, noise, rho, ccfg), h2)

    variants = [
        ("power control", dict(),
         lambda: (*transport.ota_uplink(theta, lam, h, noise, rho, ccfg), h),
         {"ota_round_stats": 1, "ota_demodulate_dyn": 1}),
        ("power_control=False", dict(power_control=False),
         lambda: (*transport.ota_uplink(theta, lam, h, noise, rho, ccfg,
                                        power_control=False), h),
         {"ota_round_theta": 1}),
        ("worker_chunk=32", dict(worker_chunk=32),
         lambda: (*transport.ota_uplink(theta, lam, h, noise, rho, ccfg), h),
         {"ota_round_stats": 4, "ota_demodulate_dyn": 1}),
        ("deep-fade mask, h_tx", dict(mask=fade.mask, h_tx=fade.h_hat),
         lambda: (*transport.ota_uplink(theta, lam, fade.h, noise, rho, ccfg,
                                        mask=fade.mask, h_tx=fade.h_hat),
                  fade.h),
         {"ota_round_stats": 1, "ota_demodulate_dyn": 1}),
        ("channel step", dict(chan_step=(w, rho_f, True)), composed_chan,
         {"ota_round_stats": 1, "ota_demodulate_dyn": 1}),
    ]
    path_launches: dict = {}
    rows = []
    for label, kw, composed, want in variants:
        h_in = fade.h if "mask" in kw else h

        def fused(kw=kw, h_in=h_in):
            return transport.ota_round_fused(theta, lam, h_in, noise, rho,
                                             ccfg, **kw)

        build.reset_launches()
        T, ia, h_air = fused()
        torch.cuda.synchronize()
        launches = dict(build.launches)
        for k, v in launches.items():
            path_launches[k] = path_launches.get(k, 0) + v
        require(launches == want, f"fused_round[{label}]: launches "
                f"{launches}, want {want}")
        Tc, iac, hc = composed()
        require(bool(torch.isfinite(T).all()) and bool(torch.isfinite(ia)),
                f"fused_round[{label}]: non-finite Θ or α⁻¹")
        t_abs, t_ratio = _max_err([T], [Tc], 1e-5, 1e-6)
        ia_rel = float(((ia - iac).abs() / iac.abs()).max())
        h_abs, h_ratio = _max_err([h_air.re, h_air.im], [hc.re, hc.im], 1e-6,
                                  1e-6)
        require(t_ratio <= 1.0 and ia_rel <= 1e-5 and h_ratio <= 1.0,
                f"fused_round[{label}]: fused and composed disagree: Θ "
                f"{t_abs} ({t_ratio} of rtol 1e-5, atol 1e-6), α⁻¹ rel "
                f"{ia_rel}, h_air {h_abs}")
        fused_ms = time_ms(torch, fused)
        composed_ms = time_ms(torch, composed)
        rows.append({"variant": label, "launches": launches,
                     "theta_max_abs_err": t_abs, "theta_err_over_tol": t_ratio,
                     "inv_alpha_rel_err": ia_rel, "h_air_max_abs_err": h_abs,
                     "fused_ms": fused_ms, "composed_ms": composed_ms,
                     "composed_over_fused": composed_ms / fused_ms,
                     "fused_ms_with_launch": time_ms(torch, fused,
                                                     spin=False),
                     "composed_ms_with_launch": time_ms(torch, composed,
                                                        spin=False)})
    emit({"phase": "fused_round", "ok": True, "W": W, "d": d,
          "active_deep_fade": int(fade.mask.sum()), "rho_f": rho_f,
          "variants": rows})
    return path_launches


def phase_accumulate(torch, card):
    """The worker-at-a-time receive at the paper MLP's width (W = 100,
    d = 109,386): ``transport.ota_accumulate`` (B13) once per worker into
    the running sums, then ``ota_receive_accumulated`` (B3 with α⁻¹ on the
    device), against the stacked ``receive`` (B2) on the same signals,
    channel and noise plane, as ``tests/test_transport.py``'s accumulated
    receive does.  The launches are gated: 100 B13 and one demodulate."""
    from repro_torch import rng
    from repro_torch.core import transport
    from repro_torch.core.channel import ChannelConfig, rayleigh
    from repro_torch.core.cplx import Complex
    from repro_torch.kernels import build

    _, (mem_rate, _, _) = card_peaks(card)
    dev = torch.device("cuda")
    W, d = W_FULL, 109_386
    gen = rng.generator(SEED + 23, dev)
    ccfg = ChannelConfig(n_workers=W, snr_db=20.0)
    theta = torch.randn((W, d), generator=gen, device=dev)
    lam = rayleigh(gen, (W, d))
    h = rayleigh(gen, (W, d))
    s = transport.modulate(theta, lam, h, 0.5)
    noise = transport.matched_filter_noise_re(gen, (d,), ccfg)
    ia = torch.tensor(0.7, device=dev)
    want = transport.receive(s, h, noise, ia)

    def accumulated():
        acc = transport.ota_accumulate_init((d,))
        for w in range(W):
            acc = transport.ota_accumulate(acc, Complex(s.re[w], s.im[w]),
                                           Complex(h.re[w], h.im[w]))
        return transport.ota_receive_accumulated(acc, noise, ia)

    torch.cuda.synchronize()
    build.reset_launches()
    got = accumulated()
    torch.cuda.synchronize()
    launches = dict(build.launches)
    want_launches = {"ota_accumulate": W, "ota_demodulate_dyn": 1}
    require(launches == want_launches, f"accumulate: launches {launches}, "
            f"want {want_launches}")
    require(bool(torch.isfinite(got).all()), "accumulate: non-finite Θ")
    # both sum the 100 workers in order; B2's compiled loop may contract
    # y += h·s into multiply-adds, B13 rounds each product and sum
    t_abs, t_ratio = _max_err([got], [want], 1e-5, 1e-6)
    require(t_ratio <= 1.0, f"accumulate: Θ differs from the stacked "
            f"receive by {t_abs} ({t_ratio} of rtol 1e-5, atol 1e-6)")
    acc_ms = time_ms(torch, accumulated)
    recv_ms = time_ms(torch, lambda: transport.receive(s, h, noise, ia))
    emit({"phase": "accumulate", "ok": True, "W": W, "d": d,
          "theta_max_abs_err": t_abs, "theta_err_over_tol": t_ratio,
          "rtol": 1e-5, "atol": 1e-6,
          "accumulated_ms": acc_ms, "stacked_receive_ms": recv_ms,
          "accumulated_ms_with_launch": time_ms(torch, accumulated,
                                                spin=False),
          "accumulated_bytes": W * 8 * 4 * d + 4 * 4 * d,
          "accumulated_bound_ms": (W * 8 * 4 * d + 4 * 4 * d) / mem_rate
          * 1e3, "launches": launches})
    return launches


def _crash_schedule(n_workers: int):
    """The last 25 workers (75–99 of 100) crash, five a round over rounds
    2–6."""
    return tuple((2 + i // 5, n_workers - 25 + i) for i in range(25))


def phase_chaos(torch, run):
    """The paper MLP of phase ``mlp`` under ``markov-doppler`` (flip off,
    power control on), 20 rounds fault-free and 20 under a fault plan —
    25 workers crashing, a persistent NaN worker, interference bursts — with
    the evict-retransmit guard: ``tests/test_faults.py``'s chaos run at the
    paper's width."""
    from repro_torch import rng
    from repro_torch.core.aggregators import make
    from repro_torch.faults import FaultPlan, GuardConfig
    from repro_torch.kernels import build
    from repro_torch.phy import make_scenario
    from repro_torch.train.fl_trainer import train

    base = run["alg"]
    ccfg = base.ccfg
    scn = make_scenario("markov-doppler", ccfg)
    theta0, solver, grad_fn = run["theta0"], run["solver"], run["grad_fn"]
    n_rounds, key = 20, SEED + 11
    W = theta0.shape[0]

    def alg_with(**kw):
        return make("afadmm", base.acfg, ccfg, base.plan, scenario=scn, **kw)

    clean = alg_with()
    train(clean, theta0, solver, grad_fn, 1, key + 1)     # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    h0 = train(clean, theta0, solver, grad_fn, n_rounds, key,
               eval_fn=run["eval_fn"], eval_every=1)
    torch.cuda.synchronize()
    clean_s = (time.perf_counter() - t0) / n_rounds
    _per_round(dict(build.launches), n_rounds, {
        "fading_step": 1, "ota_modulate": 1, "ota_receive": 1,
        "admm_dual_update": 1, "ota_round_stats": 0})

    # burst reckoning from the fault-free round 0: its receive SNR without
    # a burst is Σy²/(α⁻²·d·σ²); a burst of std b divides it by 1 + b²/σ²
    diag = alg_with(guard=GuardConfig(policy="skip", snr_floor_db=0.0))
    _, m0 = diag.round(rng.fold_in(key, 1), diag.init(key, theta0), solver,
                       grad_fn)
    snr0_db = float(m0["guard/snr_db"])
    sigma2 = ccfg.noise_var_matched / 2.0

    def burst_snr_db(b):
        return snr0_db - 10.0 * math.log10(1.0 + b * b / sigma2)

    # 3 dB below the floor, so the burst also trips it in later rounds
    burst_std = 5.0
    while burst_snr_db(burst_std) > -3.0:
        burst_std = 10.0 ** (math.floor(math.log10(burst_std)) + 1)
    plan = FaultPlan(crash_at=_crash_schedule(W), nan_workers=1,
                     burst_prob=0.4, burst_std=burst_std)
    gcfg = GuardConfig(policy="evict-retransmit", snr_floor_db=0.0,
                       max_retries=2)
    chaos = alg_with(faults=plan, guard=gcfg)
    train(chaos, theta0, solver, grad_fn, 1, key + 1)     # warm-up
    torch.cuda.synchronize()

    build.reset_launches()
    t0 = time.perf_counter()
    h1 = train(chaos, theta0, solver, grad_fn, n_rounds, key,
               eval_fn=run["eval_fn"], eval_every=1)
    torch.cuda.synchronize()
    chaos_s = (time.perf_counter() - t0) / n_rounds
    launches = dict(build.launches)
    # B6 once plus the evict pass; B3′ once, the evict pass, two retries
    _per_round(launches, n_rounds, {
        "ota_round_stats": 2, "ota_demodulate": 4, "fading_step": 1,
        "admm_dual_update": 1, "ota_modulate": 0, "ota_receive": 0,
        "ota_receive_masked": 0, "ota_demodulate_dyn": 0})

    ex = h1.extra
    for r in range(n_rounds):
        require(all(math.isfinite(v[r]) for v in ex.values()),
                f"chaos: round {r} has non-finite metrics (θ or Θ): "
                f"{ {k: v[r] for k, v in ex.items()} }")
    require(all(math.isfinite(v) for v in h1.loss), "chaos: non-finite loss")
    require(ex["fault/alive"][-1] == W - 26,
            f"chaos: final fault/alive {ex['fault/alive'][-1]}, want "
            f"{W - 26}")
    require(sum(ex["guard/retries"]) > 0, "chaos: no retransmission fired")
    require(h1.loss[-1] < run["loss0"], f"chaos: final loss {h1.loss[-1]} "
            f"not below the initial {run['loss0']}")

    # rounds 0–6 again, one at a time: worker 0 evicted in round 0 with its
    # dual zeroed, every scheduled crash landed by round 6
    st = chaos.init(key, theta0)
    for r in range(7):
        st, _ = chaos.round(rng.fold_in(key, r + 1), st, solver, grad_fn)
        require(bool(torch.isfinite(st.Theta).all())
                and bool(torch.isfinite(st.theta).all()),
                f"chaos: non-finite Θ or θ in round {r}")
        if r == 0:
            require(not bool(st.flt.alive[0]) and int(st.flt.n_evicted) == 1,
                    "chaos: worker 0 was not evicted in round 0")
            require(not bool(st.lam.re[0].any())
                    and not bool(st.lam.im[0].any()),
                    "chaos: the evicted worker's dual is not zero")
    require(not bool(st.flt.alive[W - 25:].any())
            and int(st.flt.alive.sum()) == W - 26,
            f"chaos: {int(st.flt.alive.sum())} alive after round 6, want "
            f"{W - 26}")
    emit({"phase": "chaos", "ok": True, "W": W, "rounds": n_rounds,
          "scenario": "markov-doppler", "crashes": len(plan.crash_at),
          "nan_workers": 1, "burst_prob": plan.burst_prob,
          "burst_std": burst_std, "burst_reckoning": {
              "round0_snr_db": snr0_db, "round0_inv_alpha":
              float(m0["inv_alpha"]), "sigma": math.sqrt(sigma2),
              "burst_snr_db_at_std_5": burst_snr_db(5.0),
              "burst_snr_db": burst_snr_db(burst_std)},
          "seconds_per_round": chaos_s, "fault_free_seconds_per_round":
          clean_s, "loss_init": run["loss0"], "loss": h1.loss,
          "fault_free_loss": h0.loss,
          "final_loss_over_fault_free": h1.loss[-1] / h0.loss[-1],
          "alive": ex["fault/alive"], "bursts": ex["fault/burst"],
          "retries": ex["guard/retries"], "ok_first": ex["guard/ok_first"],
          "healthy": ex["guard/healthy"], "evicted": ex["guard/evicted"],
          "snr_db": ex["guard/snr_db"], "launches": launches})
    return launches, chaos, chaos_s


#: phase ``llm``: granite-8b at full width, depth cut 36 -> 2 (the round's
#: (W, D) f32 planes of λ and h alone take 16 bytes a parameter per worker)
LLM_ARCH = "granite-8b"
LLM_LAYERS, LLM_WORKERS, LLM_SEQ, LLM_ROUNDS = 2, 2, 4096, 3
#: local sgd step.  The reduced models' 1e-2 overshoots at full width (the
#: loss of rounds 1 -> 3 went 10.39 -> 16.16 on an H100), and so does 1e-3
#: (5.53, 4.13, 7.22 with or without the uplink noise); 5e-4 falls every
#: round of six (``tools/sweep_llm_lr.py``)
LLM_LR = 5e-4
#: launches per round: each layer's B11 forward runs twice a local step
#: (once more when its checkpoint is recomputed in the backward pass)
LLM_LAUNCHES = {"flash_attention_fwd": 2 * LLM_LAYERS * 2,
                "flash_attention_dq": LLM_LAYERS * 2,
                "flash_attention_dkv": LLM_LAYERS * 2,
                "ota_round_stats": 1, "ota_demodulate_dyn": 1,
                "admm_dual_update": 1, "ota_modulate": 0, "ota_receive": 0,
                "ota_round_theta": 0}
#: phase ``llm_ssm``: falcon-mamba-7b at full width, depth cut 64 -> 2, at
#: the granite path's 4,096 tokens a worker: the scan's f32 (W·B, S,
#: d_inner·n) planes are 4.3 GB each; the round peaks at 55.5 GB on an H100
SSM_ARCH, SSM_LAYERS, SSM_SEQ = "falcon-mamba-7b", 2, LLM_SEQ
#: 5e-4 falls every round of six, as 1e-3 and 2.5e-4 do; 1e-4 rises in
#: round 2 (``tools/sweep_llm_lr.py --arch falcon-mamba-7b``)
SSM_LR = 5e-4
#: each layer's B12 forward runs twice a local step (the checkpoint's
#: recompute), its backward once; no attention
SSM_LAUNCHES = {"linear_scan_fwd": 2 * SSM_LAYERS * 2,
                "linear_scan_bwd": SSM_LAYERS * 2,
                "ota_round_stats": 1, "ota_demodulate_dyn": 1,
                "admm_dual_update": 1, "flash_attention_fwd": 0,
                "ota_modulate": 0, "ota_receive": 0, "ota_round_theta": 0}


def _llm_cfg(arch: str, n_layers: int):
    """``arch`` at full width, cut to ``n_layers``."""
    import dataclasses

    from repro_torch.models import get_config

    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def _check_packed_d(phase: str, cfg, d: int) -> None:
    from repro_torch.models.registry import (analytic_param_count,
                                             packed_param_count)

    require(d == packed_param_count(cfg), f"{phase}: {d} parameters packed, "
            f"the analytic count is {analytic_param_count(cfg)} and "
            f"{packed_param_count(cfg)} with norm scales and biases")


def phase_llm(torch, phase: str, arch: str, n_layers: int, seq: int,
              lr: float, want_launches: dict):
    """The federated LLM trainer's replicated mode (``make_fl_train`` /
    ``train_step``) on ``arch`` at full width with ``n_layers`` of its
    layers, in bf16: W = 2 workers, per-worker batch 1 × ``seq`` tokens, 2
    local sgd steps at ``lr``, 3 rounds.  Returns (launches, a one-round
    callable for the profiler, s/round)."""
    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_config
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train
    from repro_torch.tree import tree_leaves

    full = get_config(arch)
    cfg = _llm_cfg(arch, n_layers)
    model = build_model(cfg)
    W, B, S = LLM_WORKERS, 1, seq
    local_steps = 2
    flcfg = FLConfig(mode="replicated", n_workers=W, local_steps=local_steps,
                     local_lr=lr, local_optimizer="sgd")
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10)
    t0 = time.perf_counter()
    init_fn, train_step = make_fl_train(model, flcfg, acfg, ccfg)
    state = init_fn(SEED)
    tokens = token_dataset(SEED + 1, B, S, cfg.vocab_size, n_workers=W)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    d = sum(leaf[0].numel() for leaf in tree_leaves(state.theta))
    _check_packed_d(phase, cfg, d)

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, drifts, inv_alphas, times = [], [], [], []
    for r in range(LLM_ROUNDS):
        t0 = time.perf_counter()
        state, m = train_step(state, batch, key=rng.fold_in(SEED, r + 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        drifts.append(float(m["theta_drift"]))
        inv_alphas.append(float(m["inv_alpha"]))
        require(math.isfinite(losses[-1]), f"{phase}: round {r} loss "
                f"{losses[-1]} is not finite")
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    _per_round(launches, LLM_ROUNDS, want_launches)
    require(losses[-1] < losses[0], f"{phase}: round {LLM_ROUNDS} loss "
            f"{losses[-1]} is not below round 1's {losses[0]} (losses "
            f"{losses}, s/round {times}, peak {peak / 1e9} GB)")
    require(all(math.isfinite(x) for x in drifts + inv_alphas),
            f"{phase}: non-finite theta_drift {drifts} or inv_alpha "
            f"{inv_alphas}")
    require(all(bool(torch.isfinite(leaf).all())
                for leaf in tree_leaves(state.Theta)), f"{phase}: non-finite "
            f"Θ")
    round_s = statistics.mean(times[1:])
    tokens_per_round = W * B * S * local_steps
    widths = {"dense": ("d_model", "n_heads", "n_kv_heads", "hd", "d_ff",
                        "vocab_size"),
              "ssm": ("d_model", "d_inner", "ssm_state", "dt_rank",
                      "conv1d_width", "vocab_size")}[cfg.family]
    reduced = {"n_layers": f"{full.n_layers} -> {n_layers}"}
    if seq != LLM_SEQ:
        reduced["seq"] = f"{LLM_SEQ} (the granite path's) -> {seq}"
    emit({"phase": phase, "ok": True, "arch": cfg.name, "reduced": reduced,
          **{("head_dim" if k == "hd" else k): getattr(cfg, k)
             for k in widths},
          "dtype": cfg.param_dtype, "D": d, "W": W, "batch_per_worker": B,
          "seq": S, "local_steps": local_steps, "local_lr": lr,
          "rounds": LLM_ROUNDS,
          "setup_s": setup_s, "round_s": times,
          "seconds_per_round": round_s,
          "tokens_per_s": tokens_per_round / round_s,
          "loss": losses, "theta_drift": drifts, "inv_alpha": inv_alphas,
          "peak_mem_gb": peak / 1e9, "launches": launches})
    keys = iter(range(100, 1000))

    def one_round():
        nonlocal state
        state, _ = train_step(state, batch, key=rng.fold_in(SEED,
                                                            next(keys)))
    return launches, one_round, round_s


#: phase ``llm_hybrid``: recurrentgemma-2b reduced, in f32 so the card can
#: be held to the CPU; 128 tokens run past its 64-token attention window
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_WORKERS, HYBRID_BATCH, HYBRID_SEQ, HYBRID_LR = 2, 2, 128, 1e-2
#: the rec layers of the one checkpointed super-block: B12 forward twice a
#: local step, backward once; the windowed attention takes no B11
HYBRID_LAUNCHES = {"linear_scan_fwd": 8, "linear_scan_bwd": 4,
                   "ota_round_stats": 1, "ota_demodulate_dyn": 1,
                   "admm_dual_update": 1, "flash_attention_fwd": 0}
#: card against CPU, f32: the sums of the local steps run in other orders
#: (cuBLAS, the round's reductions), and Θ divides by Σ|h|².  On an H100 the
#: per-round losses agreed to 0 and 6.1e-8 relative and Θ to 3.6e-7 after
#: three rounds: the per-round loss is held to rtol 1e-5, Θ to atol 1e-5
HYBRID_LOSS_RTOL = 1e-5
HYBRID_THETA_ATOL = 1e-5


def _hybrid_cfg():
    """recurrentgemma-2b at ``ModelConfig.reduced()``, in f32."""
    import dataclasses

    from repro_torch.models import get_config

    return dataclasses.replace(get_config(HYBRID_ARCH).reduced(),
                               param_dtype="float32")


def phase_llm_hybrid(torch):
    """``train_step`` on recurrentgemma-2b at ``ModelConfig.reduced()`` in
    f32 (one super-block), W = 2, 3 rounds on the card, and the same rounds
    on the CPU (the plain versions) from the same state and draws: the
    losses and Θ agree, the launches are exact, the loss falls."""
    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import (FLConfig, draw_round,
                                               make_fl_train)
    from repro_torch.tree import to_device, tree_leaves

    dev = torch.device("cuda")
    cfg = _hybrid_cfg()
    W = HYBRID_WORKERS
    model = build_model(cfg)
    flcfg = FLConfig(n_workers=W, local_steps=2, local_lr=HYBRID_LR)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=2)
    init_cpu, step_cpu = make_fl_train(model, flcfg, acfg, ccfg,
                                       device="cpu")
    _, step_gpu = make_fl_train(model, flcfg, acfg, ccfg)
    tokens = token_dataset(SEED + 5, HYBRID_BATCH, HYBRID_SEQ, cfg.vocab_size,
                           n_workers=W, device="cpu")

    st_cpu = init_cpu(SEED)
    _check_packed_d("llm_hybrid", cfg, st_cpu.lam.re.shape[1])
    st_gpu = to_device(st_cpu, dev)
    cpu_losses, gpu_losses, redraws = [], [], []
    build.reset_launches()
    for r in range(LLM_ROUNDS):
        draws = draw_round(rng.fold_in(SEED, r + 1), st_cpu, ccfg)
        redraws.append(draws.h_fresh is not None)
        st_cpu, m_cpu = step_cpu(st_cpu, {"tokens": tokens}, draws=draws)
        st_gpu, m_gpu = step_gpu(st_gpu, {"tokens": tokens.to(dev)},
                                 draws=to_device(draws, dev))
        cpu_losses.append(float(m_cpu["loss"]))
        gpu_losses.append(float(m_gpu["loss"]))
    torch.cuda.synchronize()
    launches = dict(build.launches)
    _per_round(launches, LLM_ROUNDS, HYBRID_LAUNCHES)
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu_losses, cpu_losses)]
    require(all(math.isfinite(x) for x in gpu_losses + cpu_losses),
            f"llm_hybrid: non-finite losses {gpu_losses}, {cpu_losses}")
    require(max(rel) <= HYBRID_LOSS_RTOL, f"llm_hybrid: card losses "
            f"{gpu_losses} differ from the CPU's {cpu_losses} by up to "
            f"{max(rel)} relative, beyond {HYBRID_LOSS_RTOL}")
    require(gpu_losses[-1] < gpu_losses[0], f"llm_hybrid: round "
            f"{LLM_ROUNDS} loss {gpu_losses[-1]} is not below round 1's "
            f"{gpu_losses[0]}")
    theta_gap = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree_leaves(st_gpu.Theta),
                                    tree_leaves(st_cpu.Theta)))
    require(theta_gap <= HYBRID_THETA_ATOL, f"llm_hybrid: card Θ differs "
            f"from the CPU's by {theta_gap} after {LLM_ROUNDS} rounds, beyond "
            f"{HYBRID_THETA_ATOL} (or is not finite)")
    emit({"phase": "llm_hybrid", "ok": True, "arch": cfg.name,
          "reduced": "ModelConfig.reduced(): one super-block (rec, rec, "
          "attn), d_model 128, lru_width 128, window 64", "dtype": "float32",
          "W": W, "batch_per_worker": HYBRID_BATCH, "seq": HYBRID_SEQ,
          "local_steps": 2, "local_lr": HYBRID_LR, "rounds": LLM_ROUNDS,
          "redraws": redraws, "loss": gpu_losses, "cpu_loss": cpu_losses,
          "loss_rel_err": rel, "loss_rtol": HYBRID_LOSS_RTOL,
          "Theta_max_abs_gap_after_3_rounds": theta_gap,
          "Theta_atol": HYBRID_THETA_ATOL,
          "launches": launches})
    return launches


def _kernel_family(name: str) -> str:
    for fn in ("linear_scan_fwd_kernel", "linear_scan_bwd_kernel",
               "accumulate_kernel", "receive_masked_kernel",
               "fading_step_kernel",
               "population_step_kernel", "demodulate_kernel",
               "modulate_kernel", "receive_kernel", "receive_split_kernel",
               "receive_finalize_kernel", "dual_update_kernel",
               "flip_lambda_kernel", "round_finalize_kernel", "round_kernel",
               # B6/B7's column plan and its energy finalize
               "round_cols_kernel", "round_energy_kernel",
               # B11: flash_<fwd|dq|dkv>_kernel (f32, SIMT) and _tc (bf16)
               "flash_fwd", "flash_dq", "flash_dkv"):
        if fn in name:
            return "port:" + fn
    if any(k in name for k in ("gemm", "xmma", "nvjet", "cutlass")):
        return "matmul"
    if "elementwise" in name:
        return "elementwise"
    if "reduce" in name:
        return "reduction"
    return "other"


def _mlp_round(alg, run):
    """One round of an MLP path, for the profiler."""
    from repro_torch.train.fl_trainer import train

    theta0, solver, grad_fn = (run[k] for k in ("theta0", "solver",
                                                "grad_fn"))
    return lambda: train(alg, theta0, solver, grad_fn, 1, SEED + 2)


def phase_profile(torch, path: str, run_once, round_s: float):
    """One more round of ``path`` (``run_once``) under ``torch.profiler``:
    device time of every kernel (kernel events only: ``key_averages`` also
    credits each kernel's time to the ``aten::`` op that launched it),
    grouped by family, and its share of the unprofiled round time of that
    path's phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the guarded uplink's span (core/admm.py) shows twice: on the host,
    # with the device time of the kernels launched inside it, and on the
    # device timeline, as its extent from first to last kernel
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key != GUARD_SPAN]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    families: dict = {}
    for e in kernels:
        fam = families.setdefault(_kernel_family(e.key),
                                  {"calls": 0, "device_ms": 0.0})
        fam["calls"] += e.count
        fam["device_ms"] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    host = [e for e in events
            if e.key == GUARD_SPAN and e.device_type == DeviceType.CPU]
    extent = [e for e in events
              if e.key == GUARD_SPAN and e.device_type == DeviceType.CUDA]
    guard = None
    if host and kernels:
        span_ms = host[0].device_time_total / 1e3

        def per_call(fam):
            f = families.get("port:" + fam)
            return f["device_ms"] / f["calls"] if f else 0.0

        # one unguarded fused pass: B6 (with its finalize, on either plan)
        # and one B3′
        base_ms = (per_call("round_kernel") + per_call("round_finalize_kernel")
                   + per_call("round_cols_kernel")
                   + per_call("round_energy_kernel")
                   + per_call("demodulate_kernel"))
        guard = {"span_device_ms": span_ms, "span_share": span_ms / device_ms,
                 "beyond_one_pass_ms": span_ms - base_ms,
                 "beyond_one_pass_share": (span_ms - base_ms) / device_ms,
                 "span_extent_on_device_ms":
                 extent[0].self_device_time_total / 1e3 if extent else None}
    emit({"phase": "profile", "path": path, "ok": True, "rounds": 1,
          "guard": guard,
          "profiled_wall_ms": wall_ms, "round_ms": round_s * 1e3,
          "device_ms": device_ms if kernels else None,
          "busy_share": device_ms / (round_s * 1e3) if kernels else None,
          "families": families,
          "top": [{"name": e.key[:90], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in top]})


def main() -> int:
    # the LLM rounds peak near 56 GB of the card's 80: let freed blocks be
    # remapped rather than held as reserved fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
        paths["fused_round"] = phase_fused_round(torch)
        paths["chaos"], chaos_alg, chaos_s = phase_chaos(torch, mlp_run)
        phase_profile(torch, "mlp", _mlp_round(mlp_run["alg"], mlp_run),
                      round_s)
        phase_profile(torch, "scenario_deepfade",
                      _mlp_round(fade_alg, mlp_run), fade_s)
        phase_profile(torch, "chaos", _mlp_round(chaos_alg, mlp_run), chaos_s)
        # the MLP paths' tensors go before the LLM round's ~60 GB
        del mlp_run, fade_alg, chaos_alg
        gc.collect()
        torch.cuda.empty_cache()
        paths["accumulate"] = phase_accumulate(torch, name)
        paths["llm"], llm_round, llm_s = phase_llm(
            torch, "llm", LLM_ARCH, LLM_LAYERS, LLM_SEQ, LLM_LR,
            LLM_LAUNCHES)
        phase_profile(torch, "llm", llm_round, llm_s)
        # granite's ~55 GB go before the SSM round's ~56 GB
        del llm_round
        gc.collect()
        torch.cuda.empty_cache()
        paths["llm_ssm"], ssm_round, ssm_s = phase_llm(
            torch, "llm_ssm", SSM_ARCH, SSM_LAYERS, SSM_SEQ, SSM_LR,
            SSM_LAUNCHES)
        phase_profile(torch, "llm_ssm", ssm_round, ssm_s)
        del ssm_round
        gc.collect()
        torch.cuda.empty_cache()
        paths["llm_hybrid"] = phase_llm_hybrid(torch)
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
