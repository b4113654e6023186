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
             falcon-mamba-7b's 476,967,488, the reduced hybrid's 568,192
             and 1-layer granite-8b's 419,442,688, where B9 and the guarded
             round's masked B6 with CSI and B3′ run too; B1, B2 and B4 on
             the leafwise round's embedding leaf (2, 201,326,592) and at
             the sampled cohort's (256, 32); flash attention B11 — forward,
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
             and backward — at the SSM round's (2, 4,096, 131,072), one
             512-step chunk of it (2, 512, 131,072), the hybrid's
             full-width (2, 4,096, 2,560), the hybrid path's
             (4, 128, 128) and a ragged (3, 1,000, 100), each on the
             planner's plan and again on the other (``thread`` or
             ``staged``, named in the row); the accumulate
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
11. baselines — the paper's comparison set on phase 4's MLP (its data,
             solver and initial models): D-FADMM, A-GD and FedAvg, 5
             rounds each through ``make(name, ...)`` and ``train``, and one
             more round of each under torch.profiler; none launches an OTA
             kernel.
12. figures — the torch twins of the paper's figures
             (``repro_torch.benchmarks``) on the card: fig2a, fig5 and fig3a
             at the FAST scale, then fig3a at the paper's (W = 100,
             784-128-64-10, 200 rounds); A-FADMM must reach the 1e-4 gap
             in fig2a.
13. profile — one more round of phases 4, 7 and 10 each under
             torch.profiler: device time by kernel family, its share of the
             phase's round time, and the guarded uplink's span.
14. accumulate — the worker-at-a-time receive at the paper MLP's width
             (W = 100, d = 109,386): ``transport.ota_accumulate`` (B13) once
             per worker, then ``ota_receive_accumulated`` (one B3), held
             against the stacked receive (B2) on the same draws.
15. llm    — the federated LLM trainer's replicated mode
             (``make_fl_train`` / ``train_step``) on granite-8b at full
             width (d_model 4096, 32/8 heads of 128, d_ff 14,336, vocabulary
             49,152, bf16) with 2 of its 36 layers: 2 workers, 1 × 4,096
             tokens each, 2 local sgd steps at lr 5e-4, 3 rounds; then one
             more round under torch.profiler.
16. llm_ssm — the same trainer on falcon-mamba-7b at full width (d_model
             4096, d_inner 8,192, state 16, dt rank 256, conv 4, vocabulary
             65,024, bf16) with 2 of its 64 layers: 2 workers, 1 × 4,096
             tokens each, 2 local sgd steps, 3 rounds; then one more round
             under torch.profiler.
17. llm_ssm_chunked — phase 16 again under ``REPRO_OPT=chunked_scan``
             (512-step chunks, each B12 launch of the round one a chunk)
             from the same state and draws: the first round's loss within
             1e-3 of phase 16's, a lower peak; then one more round under
             torch.profiler; then both runs again with f32 parameters
             (``llm_ssm_f32``, ``llm_ssm_chunked_f32``), every round's
             loss within 1e-4.
18. llm_hybrid — the same trainer on recurrentgemma-2b at its reduced
             widths (one super-block: rec, rec, windowed attention) in f32,
             2 workers, 3 rounds on the card and the same rounds on the CPU
             from the same state and draws: losses to rtol 1e-5, Θ to atol
             1e-5.
19. rec_block — one recurrentgemma-2b recurrent block
             (``models/hybrid.rec_block_fwd``) at full width, bf16, on
             (2, 1, 4,096, 2,560), forward and backward of a fixed scalar
             loss once on each B12 plan: output and parameter gradients
             equal bit for bit between the plans, one B12 launch a
             direction a run; each plan's device ms and B12's share.
20. scaleup_sampled — ``benchmarks/scaleup.py``'s sampled point through
             its torch twin: a uniform cohort of 256 from 10⁶ workers
             (``AFadmm(cohort=...)``), d = 32, frequency-flat
             ``urban-mobility``, 5 rounds: B10 over the population, B1, B2
             and B4 at (256, 32); the rows it did not sample keep their θ
             and λ bits; the round's peak above the state it carries.
21. llm_chaos — phase 15's trainer on granite-8b cut to 1 of its 36
             layers (D = 419,442,688) under ``markov-doppler`` with CSI
             error 0.1, stragglers and bursts (one forced through the
             round's fault draws) and the evict-retransmit guard, 3 rounds;
             then one more round under torch.profiler.
22. llm_cohort — the same 1-layer trainer over a population of 4, sampling
             the 2 strongest channels (``top-gain``) a round, 3 rounds: the
             unsampled workers keep their θ and λ bits.
23. llm_leafwise — one round of the same trainer with
             ``packed_uplink=False`` (one B1, B2 and B4 a leaf), noise-free
             with power control, then the leafwise round against the packed
             one on the same θ, λ and h: Θ, λ and α⁻¹ within 1e-6.
24. autotune — right after phase 3: ``autotune_population_step`` (B10's
             block size) at N = 10⁶ and ``autotune_ota_round`` (B6/B7's
             plan × the worker cohort) at (100, 109,386) and (2, D₁), with
             their tables and winners.
25. resume — after phase 10, on phase 4's MLP: the scan and loop drivers
             over 23 rounds bit for bit, a run killed after round 17 and
             resumed from its snapshot bit for bit (final ``.npz`` and
             history), each driver's s/round and a snapshot's MB and
             seconds.
26. telemetry — the MLP (after phase 25) and, after phase 23, granite-8b
             cut to 1 layer, each with telemetry off and on from the same
             state and keys: Θ, λ and the loss bit-equal, the JAX package's
             obs/ keys, the receive SNR in its window, ms a round off and
             on.
27. launch — ``repro_torch.launch.train`` on granite-8b cut to 1 layer
             (W = 2, 4,096 tokens, the scan driver, 4 rounds) with a run
             dir, telemetry, the profiler and the autotune cache, twice
             (measured, then cached): the run dir validates, every round is
             logged, the trace exists, the loss falls; then the reference's
             kill-and-resume of the reduced model with faults and the
             guard, bit for bit.

28. privacy — after phase 26: the privacy harness (``core/privacy.py``) on
             one A-FADMM round of phase 4's task: the eavesdropper's view,
             an ambiguity witness and its view (2 B1), their observation
             gap within an f32 bar, the inversion attack's RMSE.
29. decentralized — after phase 12: paper §6's chain GADMM through the
             twin ``ablation_decentralized`` (W = 8, d = 6, 40 dB, 300
             rounds: final gap < 1e-4, 2 channel uses a round), then the
             chain with an interior worker dead (its θ frozen, its dual
             zero, the gap falling); no OTA kernel.
30. examples — the example twins (``repro_torch.examples``): quickstart,
             ``train_llm_federated`` at its default width for 25 steps and
             ``privacy_attack_demo``, through their ``main``.
31. save_dots — right after phase 15: phase 15 again under
             ``REPRO_OPT=save_dots`` from the same state and draws: its
             launches, a bit-equal first-round loss, Θ within 1e-3, and its
             s/round, device and cuBLAS ms and peak beside phase 15's.
32. chunked_attn — after phase 19: one full-width recurrentgemma-2b
             local-attention sub-block ((2, 4,096, 2,560) bf16, window
             2,048) on the masked and the chunked path, forward and forward
             + backward: outputs and gradients within 2⁻⁶, each path's peak
             and ms; then phase 21's 1-layer granite-8b trainer under the
             flag, 3 rounds, B11 as ever (``chunked_attn_llm``).
33. llm_sketched_check — after phase 27: the sketched mode (A-FADMM-CS,
             ``make_fl_train(mode="sketched")``) on reduced granite-8b in
             f32 (W = 4, 2 × 16 tokens, ratio 16, sketch_lr 0.5, 2 sgd
             steps at 1e-2): 3 rounds on the card and on the CPU from the
             same state and draws (loss rtol 1e-5, Θ atol 1e-5), then 12
             rounds on the card, the last loss below 0.9 × the first.
34. llm_sketched — the sketched mode on granite-8b at full width and all
             36 layers (D = 8,053,362,688, bf16): W = 2, 1 × 4,096 tokens,
             2 sgd steps at 5e-4, ratio 256 (d_s = 31,458,448), 3 rounds:
             the peak within the card, λ and h (2, d_s), B11 288/144/144
             and B6, B3, B4 once a round; the codec's device ms; then one
             more round under torch.profiler.
35. serve — ``repro_torch.serve`` on granite-8b, falcon-mamba-7b,
             recurrentgemma-2b, qwen3-moe-30b-a3b (48 layers), pixtral-12b
             (40) and seamless-m4t-medium (12 + 12) at full width and
             depth, and deepseek-v3-671b cut to 4 of its 61 layers, bf16:
             8 prompts of 64 tokens, 64 greedy tokens through ``generate``
             (every step's logits finite, no kernel launched) and
             ``make_prefill`` (B11 × 36, B12 × 64, B12 × 18, B11 × 48,
             B11 × 40 over 256 stub patches a prompt, B11 × 12 over 1,024
             stub frames a prompt, none for MLA); each model's decode
             against its forward in f32 at 2 (3) layers, ≤ 8 tokens, the
             enc-dec's cross cache from ``prefill_cross``; one decode step
             profiled.  Its kernel rows: B6, B3 and B4 at (2, 31,458,448),
             B11 at the prefills' (8, 32, 64, 128), (8, 32, 320, 128) and
             (8, 16, 64, 64) and B12 at (8, 64, 131,072) and (8, 64,
             2,560).
36. llm_families_check — after phase 34: the replicated mode on reduced
             deepseek-v3-671b, qwen3-moe-30b-a3b, pixtral-12b and
             seamless-m4t-medium in f32 (W = 2, 2 × 32 tokens, the stub
             patches and frames), 3 rounds on the card and on the CPU from
             the same state and draws (loss rtol 1e-5, Θ atol 1e-5), the
             experts picked in round 1 equal pick for pick, round 1 run
             twice on the card bit-equal; one deepseek-v3 round under
             ``grouped_moe``.
37. llm_moe — the sketched mode (phase 34's setting) on qwen3-moe-30b-a3b
             at full width cut to 12 of its 48 layers (D = 7,788,611,584,
             d_s = 30,424,264): the peak within the card, λ and h (2, d_s),
             B11 96/48/48 and B6, B3, B4 once a round; the aux loss and the
             share of (token, k) pairs dropped; then one more round under
             torch.profiler with the dispatch's device ms.  Its kernel
             rows: B6, B3 and B4 at (2, 30,424,264), B11 at a worker's
             (1, 32, 4,096, 128).
38. llm_encdec — phase 15's replicated round on seamless-m4t-medium at full
             width and depth (D = 614,926,336), W = 2, 2 × 1,024 tokens a
             worker over 2 × 1,024 stub frames: B11 48/24/24 and B6, B3, B4
             once a round, the loss falling, then one more round under
             torch.profiler.  Its kernel rows: B6, B3 and B4 at (2,
             614,926,336), B11 at the decoder's (4, 16, 1,024, 64).

Launch counts are reset just before each of phases 4–12, 14–38 and read
just after.  Then come the kernel table as one JSON line, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  Without a card, or run from a
directory that lacks ``src/repro_torch``, it exits non-zero before printing
a result.
"""
from __future__ import annotations

import contextlib
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


#: the card's memory: every LLM phase's peak must stay within it
CARD_BYTES = 80e9


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
#: the profiler spans of the MoE dispatch (``models/moe.py``): the sort,
#: ranking and scatter into the capacity buffer; the gather and the sum
MOE_SPANS = ("moe_dispatch", "moe_combine")

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
    results.update(_robust_rows(torch, build, mem_rate, f32_rate))
    results.update(_flash_rows(torch, build, card))
    results.update(_scan_rows(torch, build, mem_rate, f32_rate))
    return results


def _robust_rows(torch, build, mem_rate, f32_rate):
    """The kernels of the ``llm_chaos``, ``llm_leafwise`` and
    ``scaleup_sampled`` paths at their shapes: at granite-8b's 1-layer
    (2, 419,442,688) B9 (``markov-doppler``'s step) and the guarded round's
    B6 (with the guard's mask and the workers' CSI; its plain version in
    column chunks, the energies summed over the chunks) and B3′; the
    leafwise round's B1, B2 and B4 on the embedding leaf (2, 201,326,592);
    and B1, B2, B4 at the sampled cohort's (256, 32).  Each set of planes
    is freed when its rows are done."""
    from repro_torch import rng
    from repro_torch.kernels import (admm_update, ota, ota_round,
                                     phy_channel, ref)
    from repro_torch.models.registry import packed_param_count
    from repro_torch.phy import doppler_rho, innovation_scale

    dev = torch.device("cuda")
    gen = rng.generator(SEED + 31, dev)
    rows = {}

    def planes(W, d, n, first_scale=math.sqrt(0.5)):
        return [torch.randn((W, d), generator=gen, device=dev)
                * (first_scale if i == 0 else math.sqrt(0.5))
                for i in range(n)]

    def add(*args, **kw):
        row = _kernel_row(torch, build, mem_rate, f32_rate, *args, **kw)
        rows[row["name"]] = row

    cfg = _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    W, D = LLM_WORKERS, packed_param_count(cfg)
    label = f"[({W}, {D:,})]"
    rho_f = doppler_rho(50.0, 1e-3)
    scale_f = innovation_scale(rho_f)
    h_re, h_im, w_re, w_im = planes(W, D, 4)
    add("fading_step" + label, "src/repro/kernels/phy_channel.py:54",
        "phy_channel",
        lambda: phy_channel.fading_step(h_re, h_im, w_re, w_im, rho_f,
                                        scale_f, True),
        lambda: ref.fading_step(h_re, h_im, w_re, w_im, rho_f, scale_f,
                                True),
        4 * 6 * W * D, 6 * W * D, (1e-6, 1e-6), [W, D], {})
    del w_re, w_im
    torch.cuda.empty_cache()
    theta, lam_re, lam_im, tx_re, tx_im = planes(W, D, 5, 0.05)
    tx_re.add_(h_re)
    tx_im.add_(h_im)
    mask = torch.ones(W, dtype=torch.bool, device=dev)
    stat_planes = (theta, lam_re, lam_im, h_re, h_im)
    plan = ota_round.tiling(W, D, ota_round.sm_count(dev))

    def stats_plain():
        y = torch.empty(D, device=dev)
        p2 = torch.empty(D, device=dev)
        energy = torch.zeros(W, device=dev)
        for a in range(0, D, THETA_CHUNK):
            b = min(D, a + THETA_CHUNK)
            out = ref.ota_round_stats(*(x[:, a:b] for x in stat_planes), 0.5,
                                      mask=mask,
                                      htx=(tx_re[:, a:b], tx_im[:, a:b]))
            y[a:b], p2[a:b] = out[0], out[1]
            energy += out[2]
        return y, p2, energy

    # as at the LLM D's without the mask: y/p2 of two workers, the energy
    # over 419 M terms in another grouping, rtol 1e-4
    add(f"ota_round_stats[({W}, {D:,}) mask+csi]",
        "src/repro/kernels/ota_round.py:203", "ota_round",
        lambda: ota_round.ota_round_stats(*stat_planes, 0.5, mask=mask,
                                          htx=(tx_re, tx_im)),
        stats_plain, 4 * (W * D * 7 + 2 * D + W) + W, 18 * W * D,
        (1e-4, 1e-4), [W, D], {"plan": plan.plan, "tiling": list(plan),
                               "mode": "mask+csi",
                               "plain": "in column chunks"})
    del theta, lam_re, lam_im, tx_re, tx_im, h_re, h_im, stat_planes
    torch.cuda.empty_cache()
    y = torch.randn(D, generator=gen, device=dev)
    noise = torch.randn(D, generator=gen, device=dev) * 7e-4
    p2 = torch.rand(D, generator=gen, device=dev) * W
    add(f"ota_demodulate[({D:,})]", "src/repro/kernels/ota.py:121", "ota",
        lambda: ota.ota_demodulate(y, noise, p2, 1.0),
        lambda: ref.ota_demodulate(y, noise, p2, 1.0),
        4 * 4 * D, 4 * D, (1e-6, 1e-7), [D], {})
    del y, noise, p2
    torch.cuda.empty_cache()
    leaf = cfg.vocab_size * cfg.d_model
    for rows_, cols, what in ((W, leaf, "embedding leaf"),
                              (SAMPLED_COHORT, 32, "sampled cohort")):
        lab = f"[({rows_}, {cols:,}) {what}]"
        theta, lam_re, lam_im, h_re, h_im = planes(rows_, cols, 5, 0.05)
        Theta = torch.randn(cols, generator=gen, device=dev) * 0.05
        noise = torch.randn(cols, generator=gen, device=dev) * 7e-4
        ia = torch.tensor(0.37, device=dev)
        add("ota_modulate" + lab, "src/repro/kernels/ota.py:99", "ota",
            lambda: ota.ota_modulate(theta, lam_re, lam_im, h_re, h_im, 0.5),
            lambda: ref.ota_modulate(theta, lam_re, lam_im, h_re, h_im, 0.5),
            4 * 7 * rows_ * cols, 6 * rows_ * cols, (1e-5, 1e-5),
            [rows_, cols], {})
        s_re, s_im = ota.ota_modulate(theta, lam_re, lam_im, h_re, h_im, 0.5)
        add("ota_receive" + lab, "src/repro/kernels/ota.py:201", "ota",
            lambda: ota.ota_receive(s_re, s_im, h_re, h_im, noise, ia),
            lambda: ref.ota_receive(s_re, s_im, h_re, h_im, noise, ia),
            4 * (4 * rows_ * cols + 2 * cols) + 4,
            8 * rows_ * cols + 3 * cols, (1e-5, 1e-6), [rows_, cols],
            {"plan": ota.receive_tiling(
                rows_, cols, ota_round.sm_count(dev)).plan})
        del s_re, s_im
        add("admm_dual_update" + lab, "src/repro/kernels/admm_update.py:42",
            "admm_update",
            lambda: admm_update.admm_dual_update(lam_re, lam_im, h_re, h_im,
                                                 theta, Theta, 0.5),
            lambda: ref.admm_dual_update(lam_re, lam_im, h_re, h_im, theta,
                                         Theta, 0.5),
            4 * (7 * rows_ * cols + cols), 8 * rows_ * cols, (1e-5, 1e-5),
            [rows_, cols], {})
        del theta, lam_re, lam_im, h_re, h_im, Theta, noise, ia
        torch.cuda.empty_cache()
    return rows


def _kernel_row(torch, build, mem_rate, op_rate, name, replaces, lib, kernel,
                plain, nbytes, flops, tol, shape, extra, select=None,
                tol_of=None, library=None, plain_times=None):
    """One row of the kernel table: launch once (the counter must rise),
    hold the outputs against the plain version, time both, and the library
    call that computes the same function where there is one.  ``tol`` is
    (rtol, atol); ``tol_of(ref)`` gives each output its own instead.
    ``flops`` are counted at ``op_rate``; ``select`` picks the outputs to
    compare; ``plain_times`` (``plain_ms``, ``plain_ms_with_launch``) of an
    earlier row on the same inputs spare timing the plain version again."""
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
    if plain_times is None:
        plain_times = (time_ms(torch, plain), time_ms(torch, plain,
                                                      spin=False))
    plain_ms, plain_ms_with_launch = plain_times
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
           "plain_ms_with_launch": plain_ms_with_launch,
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
    (``llm_ssm``, whose D is not a multiple of B6's 128-column tiles), the
    reduced hybrid (``llm_hybrid``), 1-layer granite-8b (``llm_chaos``) and
    the full-depth granite-8b's sketch (``llm_sketched``: (W, d_s)),
    qwen3-moe's 12-layer sketch (``llm_moe``) and seamless-m4t-medium
    (``llm_encdec``)."""
    from repro_torch.models.registry import packed_param_count
    from repro_torch.train.llm_trainer import _sketch_dim

    return [(LLM_WORKERS, packed_param_count(_llm_cfg(arch, n_layers)))
            for arch, n_layers in ((LLM_ARCH, LLM_LAYERS),
                                   (SSM_ARCH, SSM_LAYERS))] + [
        (HYBRID_WORKERS, packed_param_count(_hybrid_cfg())),
        (LLM_WORKERS, packed_param_count(_llm_cfg(LLM_ARCH,
                                                  ROBUST_LAYERS))),
        (LLM_WORKERS, _sketch_dim(packed_param_count(_llm_cfg(
            LLM_ARCH, SKETCH_LAYERS)), SKETCH_RATIO)),
        (LLM_WORKERS, _sketch_dim(packed_param_count(_llm_cfg(
            MOE_ARCH, MOE_LAYERS)), SKETCH_RATIO)),
        (LLM_WORKERS, packed_param_count(_llm_cfg(ENCDEC_ARCH,
                                                  ENCDEC_LAYERS)))]


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
                "float32", False),
               ("[bf16 prefill (8, 32, 64, 128)]", 8, 32, 64, 128,
                "bfloat16", True),
               # the paths of the moe, vlm and enc-dec families: qwen3-moe's
               # sketched workers one at a time (1 × 4,096 tokens),
               # seamless's decoder in training (W·B = 4 × 1,024) and in
               # the prefill (8 × 64, 16 heads of 64), pixtral's prefill
               # over 256 patches + 64 tokens
               ("[bf16 sketched (1, 32, 4096, 128)]", 1, 32, 4096, 128,
                "bfloat16", True),
               ("[bf16 enc-dec decoder (4, 16, 1024, 64)]", 4, 16, 1024, 64,
                "bfloat16", True),
               ("[bf16 vlm prefill (8, 32, 320, 128)]", 8, 32, 320, 128,
                "bfloat16", True),
               ("[bf16 enc-dec prefill (8, 16, 64, 64)]", 8, 16, 64, 64,
                "bfloat16", True))
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
    d_inner·ssm_state channels), one chunk of them (``llm_ssm_chunked``:
    ``SSM_SCAN_CHUNK`` steps), the hybrid's at full width
    (recurrentgemma-2b's lru_width at the granite path's W·B and S), the
    ``llm_hybrid`` path's reduced ones, and a ragged case."""
    from repro_torch.models import get_config

    ssm_cfg = get_config(SSM_ARCH)
    full, reduced = get_config(HYBRID_ARCH), _hybrid_cfg()
    return [("", LLM_WORKERS, SSM_SEQ, ssm_cfg.d_inner * ssm_cfg.ssm_state),
            ("[chunk ({}, {}, {})]", LLM_WORKERS, SSM_SCAN_CHUNK,
             ssm_cfg.d_inner * ssm_cfg.ssm_state),
            ("[hybrid ({}, {}, {})]", LLM_WORKERS, LLM_SEQ, full.lru_width),
            ("[hybrid path ({}, {}, {})]", HYBRID_WORKERS * HYBRID_BATCH,
             HYBRID_SEQ, reduced.lru_width),
            ("[ragged ({}, {}, {})]", 3, 1000, 100),
            ("[ssm prefill ({}, {}, {})]", SERVE_BATCH, SERVE_PROMPT,
             ssm_cfg.d_inner * ssm_cfg.ssm_state),
            ("[hybrid prefill ({}, {}, {})]", SERVE_BATCH, SERVE_PROMPT,
             full.lru_width)]


def _scan_rows(torch, build, mem_rate, f32_rate):
    """B12's forward and backward against their plain versions (sequential
    loops that round each step as the kernels do) on gates in (0, 1), as
    exp(dt·A) gives them, each case on the planner's plan (``scan_tiling``)
    and, where the planes allow it, as a second row on the other plan
    (named ``[…, <plan> plan]``, the plain version's times shared).  Bytes:
    the forward needs a_1 … a_{S−1} (h_0 = b_0), all of b, and writes h;
    the backward needs a_1 … a_{S−1}, h_0 … h_{S−2} and all of dh, and
    writes g = db and da.  No single PyTorch call computes a linear
    recurrence: ``library_ms`` is null.  Every row is held to the plain
    versions' bits (tolerance 0)."""
    from repro_torch import rng
    from repro_torch.kernels import linear_scan as ls, ota_round, ref

    dev = torch.device("cuda")
    n_sm = ota_round.sm_count(dev)
    rows = {}
    for label, B, S, D in _scan_cases():
        label = label.format(B, S, D)
        gen = rng.generator(SEED + 19, dev)
        a = torch.sigmoid(2.0 * torch.randn((B, S, D), generator=gen,
                                            device=dev))
        b = torch.randn((B, S, D), generator=gen, device=dev)
        dh = torch.randn((B, S, D), generator=gen, device=dev)
        h = ls.linear_scan_fwd(a, b)
        aligned = ota_round.aligned16(a, b, h, dh)
        planned = ls.scan_tiling(B, S, D, n_sm, aligned)
        plans = [planned] + [ls.resolve_plan("linear_scan", p, B, S, D, n_sm,
                                             aligned)
                             for p in ls.PLANS if p != planned.plan
                             and (p == "thread"
                                  or ls.staged_refusal(D, aligned) is None)]
        n, n1 = B * S * D, B * (S - 1) * D
        specs = [
            ("linear_scan_fwd", lambda t: ls.linear_scan_fwd(a, b, t),
             lambda: ref.linear_scan(a, b), 4 * (n1 + 2 * n), 2 * n1),
            ("linear_scan_bwd", lambda t: ls.linear_scan_bwd(a, h, dh, t),
             lambda: ref.linear_scan_bwd(a, h, dh), 4 * (2 * n1 + 3 * n),
             2 * n1 + n),
        ]
        for fn_name, kernel, plain, nbytes, flops in specs:
            plain_times = None
            for t in plans:
                name = fn_name + label
                if t is not planned:
                    inner = label[1:-1] + ", " if label else ""
                    name = f"{fn_name}[{inner}{t.plan} plan]"
                row = _kernel_row(
                    torch, build, mem_rate, f32_rate, name,
                    "src/repro/kernels/linear_scan.py:60", "linear_scan",
                    lambda t=t: kernel(t), plain, nbytes, flops, (0.0, 0.0),
                    [B, S, D],
                    {"plan": t.plan, "tiling": list(t),
                     "planner_plan": t is planned,
                     "library": "none: no PyTorch call computes a linear "
                     "recurrence"}, plain_times=plain_times)
                plain_times = (row["plain_ms"], row["plain_ms_with_launch"])
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
    from repro_torch.benchmarks.common import MinibatchGrad
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
               eval_fn=eval_fn, loss0=loss0,
               minibatch_grad=MinibatchGrad(grad, batch_fn))
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


def phase_scaleup(torch, card):
    """``benchmarks/scaleup.py``'s largest full-transmit point through its
    twin's algorithm (``repro_torch.benchmarks.scaleup.make_alg``): W =
    65,536 workers, d = 32 over 32 subcarriers, 20 dB, ρ = 0.5, flip rule
    off, power control on, the frequency-flat ``urban-mobility``
    scenario."""
    from repro_torch import rng
    from repro_torch.benchmarks import scaleup
    from repro_torch.kernels import build, ota, ota_round
    from repro_torch.train.fl_trainer import train

    _, (mem_rate, _, _) = card_peaks(card)
    dev = torch.device("cuda")
    W, D, n_rounds, key = 65_536, scaleup.D, 10, SEED
    alg = scaleup.make_alg(W, W)
    theta0 = torch.randn((W, D), generator=rng.generator(
        rng.fold_in(key, 1), dev), device=dev)
    solver = scaleup.proximal_solver(scaleup.RHO)

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


#: phase ``baselines``: the paper's comparison set on phase ``mlp``'s task;
#: A-GD's step is the figure benchmarks' (``fig3a_comm_efficiency``)
BASELINE_ROUNDS = 5
BASELINES = (("dfadmm", {}),
             ("analog_gd", dict(learning_rate=5e-2, epsilon=1e-6)),
             ("fedavg", {}))


def phase_baselines(torch, run, afadmm_s: float):
    """D-FADMM, A-GD and FedAvg (``make(name, ...)`` and ``train``) on the
    paper MLP of phase ``mlp``: its data, solver and initial models, W =
    100, d = 109,386, 4096 subcarriers, 20 local prox-Adam steps, 40 dB, 5
    rounds each, then one more round of each under torch.profiler.  None
    of them uses an OTA kernel: D-FADMM's uplink is digital and FedAvg's
    ideal, and A-GD's truncated inversion is plain torch as it is plain jnp
    in the JAX package, so each run's launch count is pinned at zero."""
    from repro_torch.configs import paper_mlp as cfg
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.aggregators import make
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.subcarrier import SubcarrierPlan
    from repro_torch.kernels import build
    from repro_torch.train.fl_trainer import train

    theta0 = run["theta0"]
    W, d = theta0.shape
    ccfg = ChannelConfig(n_workers=W, n_subcarriers=cfg.N_SUBCARRIERS,
                         snr_db=40.0)
    plan = SubcarrierPlan.build(d, cfg.N_SUBCARRIERS)
    out, all_launches, rounds = {}, {}, {}
    for name, kw in BASELINES:
        alg = make(name, AdmmConfig(rho=cfg.RHO, flip_on_change=False), ccfg,
                   plan, **kw)
        # one round first, so the timed run excludes the warm-up
        train(alg, theta0, run["solver"], run["minibatch_grad"], 1, SEED + 1)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        hist = train(alg, theta0, run["solver"], run["minibatch_grad"],
                     BASELINE_ROUNDS, SEED, eval_fn=run["eval_fn"])
        torch.cuda.synchronize()
        round_s = (time.perf_counter() - t0) / BASELINE_ROUNDS
        launches = dict(build.launches)
        series = [hist.loss, hist.accuracy, hist.channel_uses,
                  *hist.extra.values()]
        require(all(math.isfinite(v) for s_ in series for v in s_),
                f"baselines: {name} has non-finite metrics: {hist}")
        require(hist.loss[-1] < run["loss0"],
                f"baselines: {name}'s test loss {hist.loss[-1]} after "
                f"{BASELINE_ROUNDS} rounds is not below the initial mean "
                f"model's {run['loss0']}")
        require(not launches, f"baselines: {name} launched {launches}; "
                "none of the baselines runs an OTA kernel")
        all_launches.update(launches)
        rounds[name] = (alg, round_s)
        out[name] = {"seconds_per_round": round_s,
                     "per_afadmm_round": round_s / afadmm_s,
                     "loss": hist.loss, "accuracy": hist.accuracy,
                     "channel_uses": hist.channel_uses, "launches": launches,
                     **({k: kw[k] for k in kw})}
    emit({"phase": "baselines", "ok": True, "W": W, "d": d,
          "subcarriers": cfg.N_SUBCARRIERS, "local_steps": cfg.LOCAL_ITERS,
          "snr_db": 40.0, "rounds": BASELINE_ROUNDS,
          "loss_init": run["loss0"],
          "afadmm": {"seconds_per_round": afadmm_s,
                     "channel_uses": float(plan.n_slots)},
          **out})
    for name, (alg, round_s) in rounds.items():
        phase_profile(torch, "baselines:" + name,
                      lambda alg=alg: train(alg, theta0, run["solver"],
                                            run["minibatch_grad"], 1,
                                            SEED + 2), round_s)
    return all_launches


def phase_figures(torch):
    """The torch twins of the paper's figures (``repro_torch.benchmarks``)
    on the card at their default (FAST) scale, JAX's: fig2a (A-FADMM,
    D-FADMM, D-FADMM over 10× the subcarriers and A-GD, 300 linreg rounds),
    fig5 (A-FADMM at three ρ, 150 rounds each) and fig3a (A-FADMM, D-FADMM
    and A-GD on the FAST MLP, 25 rounds); then fig3a at the paper's scale
    (W = 100, 784-128-64-10, 200 rounds).  Every derived number and each
    function's seconds are recorded; A-FADMM must reach the 1e-4 gap in
    fig2a.  Only A-FADMM launches kernels: B1, B2 and B4 each round, B5
    each linreg round (the flip rule is on there)."""
    from repro_torch.benchmarks import common, fig2_linreg, fig5_rho
    from repro_torch.benchmarks import fig3_classification as fig3
    from repro_torch.kernels import build

    build.reset_launches()
    fast, paper = {}, {}
    for name, fn in (("fig2a_comm_efficiency",
                      fig2_linreg.fig2a_comm_efficiency),
                     ("fig5_rho_sensitivity", fig5_rho.fig5_rho_sensitivity),
                     ("fig3a_comm_efficiency", fig3.fig3a_comm_efficiency)):
        fast[name] = common.timed(lambda fn=fn: fn(device="cuda"))
    paper["fig3a_comm_efficiency"] = common.timed(
        lambda: fig3.fig3a_comm_efficiency(device="cuda",
                                           scale=common.PAPER_SCALE))
    torch.cuda.synchronize()
    launches = dict(build.launches)
    fig2a = fast["fig2a_comm_efficiency"]["derived"]
    require(fig2a["afadmm"]["rounds_to_1e-4"] is not None,
            f"figures: A-FADMM never reached the 1e-4 gap in fig2a: {fig2a}")
    linreg_rounds = common.LINREG_ROUNDS + 3 * 150
    afadmm_rounds = (linreg_rounds + common.FAST_SCALE.mlp_rounds
                     + common.PAPER_SCALE.mlp_rounds)
    for k, n in (("ota_modulate", afadmm_rounds),
                 ("ota_receive", afadmm_rounds),
                 ("admm_dual_update", afadmm_rounds),
                 ("admm_flip_lambda", linreg_rounds)):
        require(launches.pop(k, 0) == n,
                f"figures: {k} launched {build.launches.get(k, 0)} times in "
                f"{afadmm_rounds} A-FADMM rounds, want {n}")
    require(not launches, f"figures: unexpected launches {launches}")
    emit({"phase": "figures", "ok": True, "fast": fast, "paper": paper,
          "launches": dict(build.launches)})
    return dict(build.launches)


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


#: phase ``llm_ssm_chunked``: ``llm_ssm`` again under
#: ``REPRO_OPT=chunked_scan`` with chunks of 512 steps, from the same
#: initial state and draws: each B12 launch of the round becomes one a chunk
SSM_SCAN_CHUNK = 512
SSM_CHUNKS = -(-SSM_SEQ // SSM_SCAN_CHUNK)
SSM_CHUNKED_LAUNCHES = dict(
    SSM_LAUNCHES, linear_scan_fwd=SSM_CHUNKS * SSM_LAUNCHES["linear_scan_fwd"],
    linear_scan_bwd=SSM_CHUNKS * SSM_LAUNCHES["linear_scan_bwd"])
#: loss of the chunked rounds against the unchunked ones.  The chunked
#: scan rounds as the whole one step by step, but dA sums per chunk and the
#: C contraction runs per chunk, so the gradients differ in their last
#: bits; with bf16 parameters an sgd step at lr 5e-4 is below one bf16 ulp
#: for most of them, and which of them move by an ulp turns on those bits,
#: so the two bf16 runs fork after their first round (relative 1.2e-4,
#: 5.0e-4, 8.3e-3 in rounds 1-3 on an H100).  The gate holds the bf16
#: pair's first round, and every round of an f32 pair (the same runs with
#: f32 parameters, where the steps are far above the rounding: 0, 2.2e-6,
#: 1.4e-5) to a tighter bound
SSM_CHUNKED_LOSS_RTOL = 1e-3
SSM_CHUNKED_BF16_ROUNDS = 1
SSM_CHUNKED_F32_LOSS_RTOL = 1e-4


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


def _frontend(torch, cfg, lead: tuple, gen) -> dict:
    """A batch's stub frontend embeddings for leading dims ``lead`` (f32,
    from ``gen``, on its device): the vlm's patches (.., frontend_tokens,
    frontend_dim), the audio enc-dec's frames (.., frontend_tokens,
    d_model); none for a text model."""
    if cfg.family == "vlm":
        shape, key = (cfg.frontend_tokens, cfg.frontend_dim), "patches"
    elif cfg.family == "audio":
        shape, key = (cfg.frontend_tokens, cfg.d_model), "frames"
    else:
        return {}
    return {key: torch.randn(lead + shape, generator=gen, device=gen.device)}


#: the allocator's counters a round may move (``torch.cuda.memory_stats``):
#: device allocations and frees, retries after a failed allocation,
#: segments, and the bytes the allocator took from or gave back to the card
ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
               "segment.all.allocated", "segment.all.freed",
               "reserved_bytes.all.allocated", "reserved_bytes.all.freed")


def phase_llm(torch, phase: str, arch: str, n_layers: int, seq: int,
              lr: float, want_launches: dict, reference=None,
              loss_rounds: int = LLM_ROUNDS,
              loss_rtol: float = SSM_CHUNKED_LOSS_RTOL, dtype=None,
              fl=None, round_draws=None, check_round=None, gate=None,
              peak_below: bool = True, batch_per_worker: int = 1):
    """The federated LLM trainer's replicated mode (``make_fl_train`` /
    ``train_step``) on ``arch`` at full width with ``n_layers`` of its
    layers, in bf16 (or ``dtype``): W = 2 workers, per-worker batch
    ``batch_per_worker`` × ``seq`` tokens (with the family's stub patches or
    frames), 2 local sgd steps at ``lr``, 3 rounds.  With
    ``reference`` (an earlier run's summary, same state and draws) the loss
    of each of the first ``loss_rounds`` rounds must be within
    ``loss_rtol`` of its, and with ``peak_below`` the peak below its.
    ``fl``: more ``FLConfig`` fields (a scenario, faults, a guard, a
    population: the batch is then the cohort's); ``round_draws(r, key,
    state, ccfg)``: round r's draws (else the trainer draws from the key);
    ``check_round(r,
    before, after, metrics)``: a gate on each round; ``gate(metrics by
    round, state)``: a gate on the run, returning fields for the phase's
    line.  The peak must stay within the card's 80 GB.  Returns (launches,
    a one-round callable for the profiler, s/round, summary)."""
    import dataclasses

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
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    model = build_model(cfg)
    fl = dict(fl or {})
    W, B, S = fl.get("cohort", LLM_WORKERS), batch_per_worker, seq
    local_steps = 2
    flcfg = FLConfig(mode="replicated", n_workers=W, local_steps=local_steps,
                     local_lr=lr, local_optimizer="sgd", **fl)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=fl.get("population", W), snr_db=40.0,
                         coherence_iters=10)
    t0 = time.perf_counter()
    init_fn, train_step = make_fl_train(model, flcfg, acfg, ccfg)
    state = init_fn(SEED)
    tokens = token_dataset(SEED + 1, B, S, cfg.vocab_size, n_workers=W)
    batch = {"tokens": tokens, **_frontend(
        torch, cfg, (W, B), rng.generator(SEED + 2, torch.device("cuda")))}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    d = sum(leaf[0].numel() for leaf in tree_leaves(state.theta))
    _check_packed_d(phase, cfg, d)

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, drifts, inv_alphas, times, alloc = [], [], [], [], []
    extra: dict = {}
    for r in range(LLM_ROUNDS):
        key = rng.fold_in(SEED, r + 1)
        # the round's state and draws go in through lists the call empties,
        # so the trainer can free the old channel and the spent draws
        # mid-round; a check keeps only the old θ and λ
        pending = [None if round_draws is None
                   else round_draws(r, key, state, ccfg)]
        before = (state._replace(chan=None) if check_round is not None
                  else None)
        held = [state]
        state = None
        stats0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        state, m = train_step(held.pop(), batch, key=key,
                              draws=pending.pop())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        stats1 = torch.cuda.memory_stats()
        alloc.append({k: stats1.get(k, 0) - stats0.get(k, 0)
                      for k in ALLOC_STATS})
        losses.append(float(m["loss"]))
        drifts.append(float(m["theta_drift"]))
        inv_alphas.append(float(m["inv_alpha"]))
        for k, v in m.items():
            if k not in ("loss", "theta_drift", "inv_alpha"):
                extra.setdefault(k, []).append(float(v))
        require(math.isfinite(losses[-1]), f"{phase}: round {r} loss "
                f"{losses[-1]} is not finite")
        if check_round is not None:
            check_round(r, before, state, m)
        del before, m
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    _per_round(launches, LLM_ROUNDS, want_launches)
    require(peak <= CARD_BYTES, f"{phase}: peak {peak / 1e9} GB is above "
            f"the card's {CARD_BYTES / 1e9} GB")
    require(all(bool(torch.isfinite(leaf).all())
                for leaf in tree_leaves(state.theta)), f"{phase}: non-finite "
            f"θ")
    gated = {} if gate is None else gate(extra, state)
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
    summary = {"loss": losses, "peak_mem_gb": peak / 1e9,
               "seconds_per_round": round_s,
               "tokens_per_s": tokens_per_round / round_s}
    versus = None
    if reference is not None:
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, reference["loss"])]
        require(max(rel[:loss_rounds]) <= loss_rtol,
                f"{phase}: losses {losses} against {reference['loss']}: "
                f"relative {rel} > {loss_rtol} in the first {loss_rounds} "
                f"rounds")
        require(not peak_below or peak / 1e9 < reference["peak_mem_gb"],
                f"{phase}: peak {peak / 1e9} GB is not below "
                f"{reference['peak_mem_gb']} GB")
        versus = dict(reference, loss_rel_diff=rel,
                      loss_rtol=loss_rtol,
                      loss_gated_rounds=loss_rounds,
                      loss_bits_equal=losses == reference["loss"])
    widths = {"dense": ("d_model", "n_heads", "n_kv_heads", "hd", "d_ff",
                        "vocab_size"),
              "audio": ("d_model", "n_heads", "n_kv_heads", "hd", "d_ff",
                        "vocab_size", "n_enc_layers", "frontend_tokens"),
              "ssm": ("d_model", "d_inner", "ssm_state", "dt_rank",
                      "conv1d_width", "vocab_size")}[cfg.family]
    reduced = ({"n_layers": f"{full.n_layers} -> {n_layers}"}
               if n_layers != full.n_layers else {})
    if seq != LLM_SEQ and batch_per_worker == 1:
        reduced["seq"] = f"{LLM_SEQ} (the granite path's) -> {seq}"
    emit({"phase": phase, "ok": True, "arch": cfg.name, "reduced": reduced,
          **{("head_dim" if k == "hd" else k): getattr(cfg, k)
             for k in widths},
          "dtype": cfg.param_dtype, "D": d, "W": W, "batch_per_worker": B,
          "seq": S, **{k: list(v.shape) for k, v in batch.items()
                       if k != "tokens"},
          "local_steps": local_steps, "local_lr": lr,
          "rounds": LLM_ROUNDS,
          "setup_s": setup_s, "round_s": times, "alloc_per_round": alloc,
          "seconds_per_round": round_s,
          "tokens_per_s": tokens_per_round / round_s,
          "loss": losses, "theta_drift": drifts, "inv_alpha": inv_alphas,
          "peak_mem_gb": peak / 1e9, "launches": launches,
          **({} if versus is None else {"reference": versus}),
          **({"options": {k: repr(v) for k, v in fl.items()},
              "metrics": extra} if fl else {}), **gated})
    keys = iter(range(100, 1000))

    def one_round():
        nonlocal state
        state, _ = train_step(state, batch, key=rng.fold_in(SEED,
                                                            next(keys)))
    return launches, one_round, round_s, summary


@contextlib.contextmanager
def _opt_env(**env):
    """The environment variables ``env`` (``REPRO_OPT`` and its chunk
    sizes) inside the block; the environment as it was after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _chunked_scan():
    """``REPRO_OPT=chunked_scan`` with ``SSM_SCAN_CHUNK``-step chunks."""
    return _opt_env(REPRO_OPT="chunked_scan", REPRO_SCAN_CHUNK=SSM_SCAN_CHUNK)


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def phase_llm_ssm_chunked(torch, reference: dict):
    """Phase ``llm_ssm`` again under ``REPRO_OPT=chunked_scan`` from the
    same state and draws, held to ``llm_ssm``'s (``reference``) first-round
    loss and peak, then one more round under torch.profiler; then the f32
    pair (``llm_ssm_f32``, ``llm_ssm_chunked_f32``: both runs with f32
    parameters), every round's loss held (``SSM_CHUNKED_F32_LOSS_RTOL``).
    Returns each run's launches by phase."""
    paths = {}
    with _chunked_scan():
        paths["llm_ssm_chunked"], one_round, round_s, _ = phase_llm(
            torch, "llm_ssm_chunked", SSM_ARCH, SSM_LAYERS, SSM_SEQ, SSM_LR,
            SSM_CHUNKED_LAUNCHES, reference=reference,
            loss_rounds=SSM_CHUNKED_BF16_ROUNDS)
        phase_profile(torch, "llm_ssm_chunked", one_round, round_s)
    del one_round
    _free(torch)
    paths["llm_ssm_f32"], _, _, f32 = phase_llm(
        torch, "llm_ssm_f32", SSM_ARCH, SSM_LAYERS, SSM_SEQ, SSM_LR,
        SSM_LAUNCHES, dtype="float32")
    _free(torch)
    with _chunked_scan():
        paths["llm_ssm_chunked_f32"], _, _, _ = phase_llm(
            torch, "llm_ssm_chunked_f32", SSM_ARCH, SSM_LAYERS, SSM_SEQ,
            SSM_LR, SSM_CHUNKED_LAUNCHES, reference=f32,
            loss_rtol=SSM_CHUNKED_F32_LOSS_RTOL, dtype="float32")
    _free(torch)
    return paths


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


#: phase ``rec_block``: one recurrentgemma-2b recurrent block at full width
#: on the LLM paths' W = 2 × 1 × 4,096 tokens, forward and backward once on
#: each B12 plan; timed over REC_RUNS runs a plan, in turns
REC_RUNS = 5


def _rec_block_run(torch, hybrid, cfg, p, u, cot):
    """Forward and backward of Σ out·cot through one rec block: (out, the
    parameters' gradients in leaf order)."""
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.grad = None
    out = hybrid.rec_block_fwd(p, u, cfg)
    (out.float() * cot).sum().backward()
    return out.detach(), [leaf.grad for leaf in leaves]


def phase_rec_block(torch):
    """``models/hybrid.rec_block_fwd`` of recurrentgemma-2b at full width
    (d_model 2,560, lru_width 2,560, conv 4, bf16 parameters from a seed),
    input (2, 1, 4,096, 2,560), forward and backward of a fixed scalar loss
    on each B12 plan (``linear_scan.forced_plan``): the output and every
    parameter gradient equal bit for bit between the plans, one B12 launch
    a direction a run, all finite.  Records each plan's device ms (CUDA
    events, median of REC_RUNS, the plans in turns) and B12's share of a
    profiled run's kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    from repro_torch.kernels import build, linear_scan as ls
    from repro_torch.models import get_config, hybrid
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    p = hybrid.rec_block_init(SEED + 7, cfg, device=dev)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    gen = rng.generator(SEED + 8, dev)
    shape = (LLM_WORKERS, 1, LLM_SEQ, cfg.d_model)
    u = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    cot = torch.randn(shape, generator=gen, device=dev)
    runs, launches = {}, {}
    for plan in ls.PLANS:
        build.reset_launches()
        with ls.forced_plan(plan):
            runs[plan] = _rec_block_run(torch, hybrid, cfg, p, u, cot)
        torch.cuda.synchronize()
        got = dict(build.launches)
        require(got.get("linear_scan_fwd") == 1
                and got.get("linear_scan_bwd") == 1,
                f"rec_block: the {plan} plan launched {got}, want one B12 "
                f"forward and one backward")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    (out_t, grads_t), (out_s, grads_s) = runs["thread"], runs["staged"]
    require(all(bool(torch.isfinite(x).all()) for x in (out_t, *grads_t)),
            "rec_block: non-finite output or gradient")
    require(bool(torch.equal(out_t, out_s)), "rec_block: the plans' outputs "
            "differ")
    differ = [i for i, (x, y) in enumerate(zip(grads_t, grads_s))
              if not torch.equal(x, y)]
    require(not differ, f"rec_block: the plans' gradients of leaves {differ} "
            f"(in leaf order) differ")
    del runs, out_t, grads_t, out_s, grads_s

    def run(plan):
        with ls.forced_plan(plan):
            _rec_block_run(torch, hybrid, cfg, p, u, cot)

    times = {plan: [] for plan in ls.PLANS}
    for _ in range(REC_RUNS):
        for plan in ("thread", "staged", "staged", "thread"):
            times[plan].append(time_ms(torch, lambda: run(plan), runs=1,
                                       warmup=0))
    stats = {}
    for plan in ls.PLANS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(plan)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in kernels) / 1e3
        scan = sum(e.self_device_time_total for e in kernels
                   if "linear_scan" in e.key) / 1e3
        stats[plan] = {"device_ms": statistics.median(times[plan]),
                       "device_ms_runs": times[plan],
                       "profiled_kernel_ms": total, "b12_ms": scan,
                       "b12_share": scan / total if total else None}
    emit({"phase": "rec_block", "ok": True, "arch": cfg.name,
          "reduced": "one rec block (models/hybrid.rec_block_fwd), no "
          "embedding, mlp or attention", "d_model": cfg.d_model,
          "lru_width": cfg.lru_width, "conv1d_width": cfg.conv1d_width,
          "dtype": cfg.param_dtype, "input": list(shape),
          "loss": "sum(out * fixed N(0, 1) cotangent)",
          "bitwise_equal_between_plans": True, "plans": stats,
          "staged_saves_ms": stats["thread"]["device_ms"]
          - stats["staged"]["device_ms"], "launches": launches})
    return launches


#: phase ``scaleup_sampled``: the sampled point of
#: ``repro_torch/benchmarks/scaleup.py``, a 256-worker cohort of 10⁶
SAMPLED_POPULATION, SAMPLED_COHORT, SAMPLED_ROUNDS = 1_000_000, 256, 5
#: per round: B10 over the population, the uplink at cohort width
SAMPLED_LAUNCHES = {"population_step": 1, "ota_modulate": 1,
                    "ota_receive": 1, "admm_dual_update": 1,
                    "fading_step": 0, "ota_round_stats": 0}


def phase_scaleup_sampled(torch):
    """``benchmarks/scaleup.py``'s (10⁶, 256) point through its torch twin
    (``repro_torch.benchmarks.scaleup``): the twin's timed rounds and the
    round's peak above the state it carries, then ``SAMPLED_ROUNDS`` rounds
    of ``AFadmm(cohort=...)`` with their launches gated and, each round, the
    non-sampled rows' θ and λ held to their pre-round bits."""
    from repro_torch.benchmarks import scaleup
    from repro_torch.core.cohort import sample_cohort
    from repro_torch.kernels import build
    from repro_torch import rng

    dev = torch.device("cuda")
    N, W = SAMPLED_POPULATION, SAMPLED_COHORT
    point = scaleup.run_point(N, W, rounds=SAMPLED_ROUNDS, iters=5)
    alg = scaleup.make_alg(N, W)
    solve = scaleup.proximal_solver(scaleup.RHO)
    key = SEED + 17
    st = alg.init(key, torch.randn((N, scaleup.D), device=dev,
                                   generator=rng.generator(key, dev)))
    state_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    for r in range(SAMPLED_ROUNDS):
        k = rng.fold_in(key, r + 1)
        draws = alg.draw(k, st, solve)
        idx = sample_cohort(alg.cohort, draws.cohort)
        st2, m = alg.round(k, st, solve, scaleup.zero_grad, draws=draws)
        off = torch.ones(N, dtype=torch.bool, device=dev)
        off[idx] = False
        for a, b in ((st2.theta, st.theta), (st2.lam.re, st.lam.re),
                     (st2.lam.im, st.lam.im)):
            require(bool(torch.equal(a[off], b[off])),
                    f"scaleup_sampled: round {r} changed a row it did not "
                    f"sample")
        require(bool(torch.isfinite(st2.Theta).all()),
                f"scaleup_sampled: round {r} Θ is not finite")
        st = st2
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated() - state_bytes
    _per_round(launches, SAMPLED_ROUNDS, SAMPLED_LAUNCHES)
    plane = N * scaleup.D * 8         # one (N, d) complex64 plane
    emit({"phase": "scaleup_sampled", "ok": True, "population": N,
          "cohort": W, "d": scaleup.D, "scenario": "urban-mobility",
          "freq_flat": True, "rounds": SAMPLED_ROUNDS, "twin": point,
          "seconds_per_round": point["seconds_per_round"],
          "gated_rounds_s": run_s / SAMPLED_ROUNDS,
          "peak_above_state_bytes": point["peak_above_state_bytes"],
          "gated_rounds_peak_above_state_bytes": peak,
          "complex_plane_bytes": plane, "inv_alpha": float(m["inv_alpha"]),
          "launches": launches})
    return launches


#: phases ``llm_chaos``, ``llm_cohort``, ``llm_leafwise``: granite-8b at
#: full width cut to 1 of its 36 layers (D = 419,442,688), W = 2
ROBUST_LAYERS = 1
LLM_FLASH_1 = {"flash_attention_fwd": 2 * ROBUST_LAYERS * 2,
               "flash_attention_dq": ROBUST_LAYERS * 2,
               "flash_attention_dkv": ROBUST_LAYERS * 2}
#: a round of the 1-layer granite-8b packed uplink (phases ``telemetry``
#: and ``launch``): B11's, then B6, B3 and B4 once each
LLM_ROUND_1_LAUNCHES = dict(LLM_FLASH_1, ota_round_stats=1,
                            ota_demodulate_dyn=1, admm_dual_update=1,
                            ota_modulate=0, ota_receive=0, ota_round_theta=0)
#: stragglers (snapshots every 2 rounds) and bursts; a burst of std 100
#: drops the receive SNR by ~10·log10(1 + 100²/σ²) ≈ 80 dB at 40 dB, far
#: below the guard's 0 dB floor, and the retry (no burst) recovers
CHAOS_FAULTS = dict(straggler_prob=0.5, straggler_delay=2, burst_prob=0.2,
                    burst_std=100.0)
CHAOS_GUARD = dict(policy="evict-retransmit", snr_floor_db=0.0,
                   max_retries=2)
#: the round whose burst uniform is forced to 0 (a burst for certain)
CHAOS_BURST_ROUND = 1
#: per round: B9 steps the (2, D) fading; B6 once plus the guard's evict
#: pass; B3′ on the slot, the evict pass and two retries; one B4
CHAOS_LAUNCHES = dict(LLM_FLASH_1, fading_step=1, ota_round_stats=2,
                      ota_demodulate=4, admm_dual_update=1,
                      ota_demodulate_dyn=0, ota_modulate=0, ota_receive=0)
COHORT_LAUNCHES = dict(LLM_FLASH_1, ota_round_stats=1, ota_demodulate_dyn=1,
                       admm_dual_update=1, fading_step=0, ota_modulate=0)


def phase_llm_chaos(torch):
    """Phase ``llm``'s trainer on granite-8b (1 of 36 layers) under
    ``markov-doppler`` with CSI error 0.1, stragglers and bursts, and the
    evict-retransmit guard; round ``CHAOS_BURST_ROUND`` has its burst
    forced through its fault draws.  Gates: θ and Θ finite, the loss falls,
    at least one retransmission, participation in (0, 1]."""
    from repro_torch.faults import FaultPlan, GuardConfig
    from repro_torch.phy import make_scenario
    from repro_torch.train.llm_trainer import draw_round

    plan, gcfg = FaultPlan(**CHAOS_FAULTS), GuardConfig(**CHAOS_GUARD)
    fl = dict(scenario="markov-doppler", csi_err=0.1, faults=plan,
              guard=gcfg)

    def round_draws(r, key, state, ccfg):
        d = draw_round(key, state, ccfg, scenario=make_scenario(
            "markov-doppler", ccfg, csi_err=0.1), faults=plan, guard=gcfg)
        if r == CHAOS_BURST_ROUND:
            d = d._replace(faults=d.faults._replace(
                burst=torch.zeros_like(d.faults.burst)))
        return d

    def gate(metrics, state):
        require(sum(metrics["guard/retries"]) >= 1,
                f"llm_chaos: no retransmission: {metrics['guard/retries']}")
        require(metrics["fault/burst"][CHAOS_BURST_ROUND] == 1.0
                and metrics["guard/ok_first"][CHAOS_BURST_ROUND] == 0.0,
                "llm_chaos: the forced burst did not trip the guard")
        part = metrics["participation"]
        require(all(0.0 < p <= 1.0 for p in part),
                f"llm_chaos: participation {part} not in (0, 1]")
        return {"retransmissions": sum(metrics["guard/retries"]),
                "participation": part,
                "straggler_stale_shape": list(state.flt.stale.shape)}

    return phase_llm(torch, "llm_chaos", LLM_ARCH, ROBUST_LAYERS, LLM_SEQ,
                     LLM_LR, CHAOS_LAUNCHES, fl=fl, round_draws=round_draws,
                     gate=gate)


def phase_llm_cohort(torch):
    """Phase ``llm``'s trainer on granite-8b (1 of 36 layers) over a
    population of 4 workers, sampling the cohort of 2 strongest channels
    (``top-gain``) each round.  Gates: the unsampled rows keep their θ and
    λ bits each round; the loss falls."""
    from repro_torch.core.cohort import (CohortConfig, channel_weight,
                                         sample_cohort)
    from repro_torch.tree import tree_leaves

    cfg = CohortConfig(population=4, cohort=2, policy="top-gain")
    fl = dict(population=cfg.population, cohort=cfg.cohort,
              cohort_policy=cfg.policy)
    cohorts = []

    def check_round(r, before, after, m):
        idx = sample_cohort(cfg, None, channel_weight(after.chan.h))
        cohorts.append(sorted(idx.tolist()))
        for w in sorted(set(range(cfg.population)) - set(cohorts[-1])):
            same = all(bool(torch.equal(a[w], b[w])) for a, b in zip(
                tree_leaves(after.theta), tree_leaves(before.theta)))
            same = same and bool(torch.equal(after.lam.re[w],
                                             before.lam.re[w]))
            same = same and bool(torch.equal(after.lam.im[w],
                                             before.lam.im[w]))
            require(same, f"llm_cohort: round {r} changed worker {w}, "
                    f"which it did not sample")

    def gate(metrics, state):
        return {"cohorts": cohorts,
                "lam_shape": list(state.lam.re.shape)}

    return phase_llm(torch, "llm_cohort", LLM_ARCH, ROBUST_LAYERS, LLM_SEQ,
                     LLM_LR, COHORT_LAUNCHES, fl=fl, check_round=check_round,
                     gate=gate)


#: ``llm_leafwise``: the packed round against the leafwise one on the same
#: θ, λ and h, noise-free with power control: Θ and λ within rtol 1e-6
LEAFWISE_RTOL = 1e-6


def phase_llm_leafwise(torch):
    """One round of phase ``llm``'s trainer on granite-8b (1 of 36 layers)
    with ``packed_uplink=False`` (λ and h as per-leaf trees; one B1, B2 and
    B4 per leaf), noise-free with power control; then, on the same θ (after
    the local steps), λ and h, the leafwise round against the packed one
    (B6, B3, B4): Θ, λ and α⁻¹ within ``LEAFWISE_RTOL``, and the trainer's
    λ the leafwise round's bit for bit."""
    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.packing import build_packspec
    from repro_torch.core.tree_ota import ota_tree_round
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import (FLConfig, draw_round,
                                               make_fl_train)
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    W = LLM_WORKERS
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10,
                         noisy=False)
    init_fn, train_step = make_fl_train(
        build_model(cfg), FLConfig(n_workers=W, local_steps=2,
                                   local_lr=LLM_LR, packed_uplink=False),
        acfg, ccfg)
    state = init_fn(SEED)
    spec = build_packspec(state.theta, batch_dims=1)
    _check_packed_d("llm_leafwise", cfg, spec.d)
    batch = {"tokens": token_dataset(SEED + 1, 1, LLM_SEQ, cfg.vocab_size,
                                     n_workers=W)}
    draws = draw_round(rng.fold_in(SEED, 1), state, ccfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    new, m = train_step(state, batch, draws=draws)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    n = spec.n_leaves
    _per_round(launches, 1, dict(LLM_FLASH_1, ota_modulate=n, ota_receive=n,
                                 admm_dual_update=n, ota_round_stats=0,
                                 ota_demodulate_dyn=0))
    require(peak <= CARD_BYTES, f"llm_leafwise: peak {peak / 1e9} GB")
    require(math.isfinite(float(m["loss"])), "llm_leafwise: loss not finite")
    # the two rounds on the trainer's θ after its local steps
    theta = new.theta
    noise = list(draws.noise_re)
    rounds = {}
    for packed in (False, True):
        T, lam, mr = ota_tree_round(
            theta, state.lam, state.chan.h,
            noise if not packed else torch.zeros(spec.d, device=dev),
            acfg, ccfg, packed=packed)
        rounds[packed] = (tree_leaves(T), tree_leaves(lam),
                          float(mr["inv_alpha"]))
        del T, lam
    (T_l, l_l, ia_l), (T_p, l_p, ia_p) = rounds[False], rounds[True]
    require(all(bool(torch.equal(a.re, b.re)) and bool(torch.equal(a.im,
                                                                  b.im))
                for a, b in zip(tree_leaves(new.lam), l_l)),
            "llm_leafwise: the trainer's λ is not its leafwise round's")
    theta_err = _max_err(T_p, T_l, LEAFWISE_RTOL, 0.0)
    lam_err = _max_err([x for z in l_p for x in z], [x for z in l_l
                                                     for x in z],
                       LEAFWISE_RTOL, 0.0)
    bits = {"Theta": all(bool(torch.equal(a, b)) for a, b in zip(T_p, T_l)),
            "lam": all(bool(torch.equal(a.re, b.re))
                       and bool(torch.equal(a.im, b.im))
                       for a, b in zip(l_p, l_l))}
    ia_rel = abs(ia_p - ia_l) / abs(ia_l)
    out = {"phase": "llm_leafwise", "ok": True, "arch": cfg.name,
          "reduced": {"n_layers": f"36 -> {ROBUST_LAYERS}"}, "D": spec.d,
          "leaves": n, "W": W, "seq": LLM_SEQ, "noisy": False,
          "power_control": True, "round_s": round_s,
          "loss": float(m["loss"]),
          "peak_mem_gb": peak / 1e9, "inv_alpha_leafwise": ia_l,
          "inv_alpha_packed": ia_p, "inv_alpha_rel_diff": ia_rel,
          "theta_max_abs_err": theta_err[0], "theta_err_over_rtol":
          theta_err[1], "lam_max_abs_err": lam_err[0],
          "lam_err_over_rtol": lam_err[1], "bitwise_equal": bits,
          "launches": launches}
    require(theta_err[1] <= 1.0 and lam_err[1] <= 1.0
            and ia_rel <= LEAFWISE_RTOL,
            f"llm_leafwise: packed and leafwise differ beyond rtol "
            f"{LEAFWISE_RTOL}: {out}")
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# slice 11: the autotuners, the block driver and its snapshots, telemetry
# and the training launcher
# ---------------------------------------------------------------------------

def _d1() -> int:
    """D of granite-8b cut to ``ROBUST_LAYERS`` layers (419,442,688)."""
    from repro_torch.models.registry import packed_param_count

    return packed_param_count(_llm_cfg(LLM_ARCH, ROBUST_LAYERS))


def phase_autotune(torch):
    """The two autotuners on the card, each a sweep a user runs before a
    job: ``autotune_population_step`` (B10's block size) at the scaleup
    benchmark's N = 10⁶, and ``autotune_ota_round`` (B6/B7's plan by
    ``block_cols`` × the streamed round's ``worker_chunk``) at the paper
    MLP's (100, 109,386) and the 1-layer granite round's (2, D₁).  Every
    table row is timed with CUDA events (median of 10 after a warm-up);
    each sweep's winner is one of its rows."""
    from repro_torch.core.transport import autotune_ota_round
    from repro_torch.kernels import build
    from repro_torch.phy.population import autotune_population_step

    build.reset_launches()
    t0 = time.perf_counter()
    pop = autotune_population_step(1_000_000, device="cuda")
    pop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mlp = autotune_ota_round(W_FULL, 109_386, device="cuda")
    mlp_s = time.perf_counter() - t0
    d1 = _d1()
    t0 = time.perf_counter()
    llm = autotune_ota_round(LLM_WORKERS, d1, device="cuda")
    llm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(build.launches)
    _free(torch)
    for name, res in (("population", pop), ("mlp", mlp), ("llm", llm)):
        require(res["best"] in res["table"]
                and all(math.isfinite(r["us"]) and r["us"] > 0
                        for r in res["table"]),
                f"autotune: {name} sweep {res}")
    require(len(pop["table"]) == 4, f"autotune: {pop['table']}")
    require({r["worker_chunk"] for r in llm["table"]} == {0},
            f"autotune: at W = 2 only the monolithic pass is valid: "
            f"{llm['table']}")
    require(launches.get("population_step", 0) > 0
            and launches.get("ota_round_stats", 0) > 0,
            f"autotune: launches {launches}")
    emit({"phase": "autotune", "ok": True,
          "population": {"n": 1_000_000, "seconds": pop_s, **pop},
          "ota_round_mlp": {"W": W_FULL, "d": 109_386, "seconds": mlp_s,
                            **mlp},
          "ota_round_llm": {"W": LLM_WORKERS, "d": d1, "seconds": llm_s,
                            **llm},
          "launches": launches})
    return launches


#: a round of the paper MLP's A-FADMM (phases ``resume`` and
#: ``telemetry``): B1, B2 and B4 once each
MLP_ROUND_LAUNCHES = {"ota_modulate": 1, "ota_receive": 1,
                      "admm_dual_update": 1}
#: phase ``resume``: rounds of the uninterrupted run, the round the killed
#: run stops after (not a boundary of the 10-round coherence blocks) and
#: the eval cadence
RESUME_ROUNDS, RESUME_KILL, RESUME_EVAL_EVERY = 23, 17, 5


def _npz_diff(pa: str, pb: str) -> list:
    """Keys whose arrays differ (NaN equal to NaN) between two ``.npz``."""
    import numpy as np

    with np.load(pa) as za, np.load(pb) as zb:
        if sorted(za.files) != sorted(zb.files):
            return [f"key sets {sorted(za.files)} != {sorted(zb.files)}"]
        return [k for k in za.files
                if za[k].dtype != zb[k].dtype
                or not np.array_equal(za[k], zb[k], equal_nan=True)]


def _same_history(a, b) -> bool:
    return (a.loss == b.loss and a.accuracy == b.accuracy
            and a.channel_uses == b.channel_uses and a.extra == b.extra)


def phase_resume(torch, run):
    """The block driver on the paper MLP of phase ``mlp`` (W = 100, d =
    109,386, 20 local Adam steps, coherence 10, the ADMM state on the
    card): ``train(driver="scan")`` against ``train(driver="loop")`` over
    23 rounds, bit for bit; a run killed after round 17 with snapshots on
    and resumed with ``resume=True`` against the uninterrupted run, its
    final ``.npz`` leaf by leaf and its history.  Records each driver's
    s/round and a snapshot's size and write and restore seconds."""
    import tempfile

    from repro_torch.checkpoint import round_path, save
    from repro_torch.kernels import build
    from repro_torch.train.fl_trainer import resume_state, train

    alg, theta0, solver, grad_fn, eval_fn = (
        run[k] for k in ("alg", "theta0", "solver", "grad_fn", "eval_fn"))
    n, kill, key = RESUME_ROUNDS, RESUME_KILL, SEED + 21
    kw = dict(eval_fn=eval_fn, eval_every=RESUME_EVAL_EVERY)
    train(alg, theta0, solver, grad_fn, 1, key + 1)       # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    h_scan = train(alg, theta0, solver, grad_fn, n, key, driver="scan", **kw)
    torch.cuda.synchronize()
    scan_s = (time.perf_counter() - t0) / n
    launches = dict(build.launches)
    t0 = time.perf_counter()
    h_loop = train(alg, theta0, solver, grad_fn, n, key, driver="loop", **kw)
    torch.cuda.synchronize()
    loop_s = (time.perf_counter() - t0) / n
    require(_same_history(h_scan, h_loop),
            f"resume: the scan and loop drivers' histories differ: "
            f"loss {h_scan.loss} / {h_loop.loss}")
    _per_round(launches, n, MLP_ROUND_LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        da, db = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        h_a = train(alg, theta0, solver, grad_fn, n, key, checkpoint_dir=da,
                    checkpoint_every=n, **kw)
        train(alg, theta0, solver, grad_fn, kill, key, checkpoint_dir=db,
              checkpoint_every=10 ** 9, **kw)
        h_b = train(alg, theta0, solver, grad_fn, n, key, checkpoint_dir=db,
                    checkpoint_every=10 ** 9, resume=True, **kw)
        diff = _npz_diff(round_path(da, n), round_path(db, n))
        require(not diff, f"resume: the resumed run's final snapshot "
                f"differs from the uninterrupted run's in {diff}")
        tail = n - kill
        require(_same_history(h_a, h_scan), "resume: snapshots changed "
                "the run's history")
        require(h_b.loss == h_a.loss[-len(h_b.loss):]
                and all(h_b.extra[k] == v[-tail:]
                        for k, v in h_a.extra.items()),
                f"resume: the resumed history is not the uninterrupted "
                f"run's tail: loss {h_b.loss} / {h_a.loss}")
        t0 = time.perf_counter()
        st, r0 = resume_state(alg, theta0, key, db)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(r0 == n, f"resume: latest snapshot round {r0}, want {n}")
        path = os.path.join(tmp, "timed.npz")
        t0 = time.perf_counter()
        save(path, st)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del st
    emit({"phase": "resume", "ok": True, "W": theta0.shape[0],
          "d": theta0.shape[1], "rounds": n, "killed_after": kill,
          "coherence": alg.ccfg.coherence_iters,
          "scan_seconds_per_round": scan_s, "loop_seconds_per_round": loop_s,
          "scan_over_loop": scan_s / loop_s, "drivers_bitwise": True,
          "resume_bitwise": True, "loss": h_scan.loss,
          "resumed_loss": h_b.loss, "snapshot_mb": size / 1e6,
          "snapshot_save_s": save_s, "snapshot_restore_s": restore_s,
          "launches": launches})
    return launches


#: the obs/ keys of each path's round (the JAX package's ``pallas`` set):
#: the unguarded flat round exposes no receive internals, the packed LLM
#: round is the fused receive's full set
TELEMETRY_KEYS = {
    "mlp": {"obs/active_workers", "obs/min_alpha", "obs/theta_update_norm"},
    "llm": {"obs/active_workers", "obs/min_alpha", "obs/rx_snr_db",
            "obs/theta_update_norm", "obs/tx_energy"}}
TELEMETRY_LLM_ROUNDS = 3
#: obs/rx_snr_db's window on the LLM round.  The configured 40 dB is
#: P/(N0·B), B = 15 kHz; the receiver's real noise plane has variance
#: N0/(2T), T = 1 ms, so one worker at full power sees 40 + 10·log10(2BT)
#: = 54.8 dB a coefficient, and two superposed add up to 10·log10(6) dB
TELEMETRY_SNR_WINDOW_DB = 10.0


def _rx_snr_expect_db(ccfg) -> float:
    return ccfg.snr_db + 10.0 * math.log10(
        2.0 * ccfg.subcarrier_hz * ccfg.slot_seconds)


def _event_ms(torch, fn):
    """(fn's result, CUDA-event ms from before its launches to after
    them, host seconds), synchronising after."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def phase_telemetry_mlp(torch, run):
    """Telemetry off and on on the paper MLP of phase ``mlp``: 5 rounds of
    each from the same state and keys.  Gates: Θ, λ, θ and the eval loss
    bit-equal; the obs/ keys the JAX package's ``pallas`` route emits.
    Records the ms a round (CUDA events) with it off and on."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.kernels import build

    base, theta0, solver, grad_fn = (run[k] for k in ("alg", "theta0",
                                                      "solver", "grad_fn"))
    n, key = 5, SEED + 31
    out, ms, launches = {}, {}, {}
    per_round = {}
    for tel in (None, True):
        alg = dataclasses.replace(base, telemetry=tel)
        st = alg.init(key, theta0)
        st, _ = alg.round(rng.fold_in(key, 1), st, solver, grad_fn)
        build.reset_launches()
        times, m = [], None
        for r in range(1, n):
            (st, m), t, _ = _event_ms(torch, lambda: alg.round(
                rng.fold_in(key, r + 1), st, solver, grad_fn))
            times.append(t)
        launches = dict(build.launches)
        _per_round(launches, n - 1, MLP_ROUND_LAUNCHES)
        per_round[tel] = launches
        out[tel], ms[tel] = (st, m), statistics.median(times)
    (st0, m0), (st1, m1) = out[None], out[True]
    same = all(bool(torch.equal(a, b)) for a, b in (
        (st0.Theta, st1.Theta), (st0.theta, st1.theta),
        (st0.lam.re, st1.lam.re), (st0.lam.im, st1.lam.im)))
    loss = [float(run["eval_fn"](s.Theta)["loss"]) for s in (st0, st1)]
    require(same and loss[0] == loss[1], "telemetry: the MLP's state or "
            f"loss changed with telemetry on (loss {loss})")
    keys = {k for k in m1 if k.startswith("obs/")}
    require(keys == TELEMETRY_KEYS["mlp"] and not any(
        k.startswith("obs/") for k in m0), f"telemetry: MLP keys {keys}")
    require(all(math.isfinite(float(m1[k])) for k in keys),
            f"telemetry: non-finite MLP telemetry {m1}")
    emit({"phase": "telemetry", "path": "mlp", "ok": True,
          "W": theta0.shape[0], "d": theta0.shape[1], "rounds": n,
          "ms_per_round_off": ms[None], "ms_per_round_on": ms[True],
          "overhead_ms": ms[True] - ms[None], "bitwise_off_on": True,
          "keys": sorted(keys),
          "values": {k: float(m1[k]) for k in sorted(keys)},
          "launches_off": per_round[None], "launches": launches})
    return launches


def phase_telemetry_llm(torch):
    """Telemetry off and on on the 1-layer granite-8b round (full width,
    W = 2, 1 × 4,096 tokens, 2 sgd steps at 5e-4), 3 rounds each from the
    same state and keys.  Gates: Θ, λ and the loss bit-equal; the obs/
    keys of the JAX package's packed round; ``obs/rx_snr_db`` finite and
    within ``TELEMETRY_SNR_WINDOW_DB`` of the coefficient SNR the
    configuration implies; ``obs/tx_energy`` (W,).  Records the ms a round
    (CUDA events) off and on."""
    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train
    from repro_torch.tree import tree_leaves

    cfg = _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    model = build_model(cfg)
    W = LLM_WORKERS
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10)
    batch = {"tokens": token_dataset(SEED + 1, 1, LLM_SEQ, cfg.vocab_size,
                                     n_workers=W)}
    runs, launches, per_round = {}, {}, {}
    for tel in (None, True):
        flcfg = FLConfig(n_workers=W, local_steps=2, local_lr=LLM_LR,
                         telemetry=tel)
        init_fn, step = make_fl_train(model, flcfg, acfg, ccfg)
        held = [init_fn(SEED)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        losses, times, walls, metrics = [], [], [], []
        for r in range(TELEMETRY_LLM_ROUNDS):
            (state, m), t, wall = _event_ms(torch, lambda: step(
                held.pop(), batch, key=rng.fold_in(SEED, r + 1)))
            held.append(state)
            del state
            times.append(t)
            walls.append(wall)
            losses.append(float(m["loss"]))
            metrics.append({k: v.tolist() for k, v in m.items()
                            if k.startswith("obs/")})
        launches = dict(build.launches)
        _per_round(launches, TELEMETRY_LLM_ROUNDS, LLM_ROUND_1_LAUNCHES)
        per_round[tel] = launches
        st = held.pop()
        runs[tel] = dict(Theta=st.Theta, lam=st.lam, loss=losses, ms=times,
                         wall=walls, metrics=metrics,
                         peak=torch.cuda.max_memory_allocated())
        del st, held, init_fn, step
        _free(torch)
    off, on = runs[None], runs[True]
    same = (off["loss"] == on["loss"]
            and bool(torch.equal(off["lam"].re, on["lam"].re))
            and bool(torch.equal(off["lam"].im, on["lam"].im))
            and all(bool(torch.equal(a, b)) for a, b in zip(
                tree_leaves(off["Theta"]), tree_leaves(on["Theta"]))))
    require(same, f"telemetry: the LLM round changed with telemetry on "
            f"(loss {off['loss']} / {on['loss']})")
    expect = _rx_snr_expect_db(ccfg)
    for r, m in enumerate(on["metrics"]):
        require(set(m) == TELEMETRY_KEYS["llm"] and not off["metrics"][r],
                f"telemetry: LLM round {r} keys {sorted(m)}")
        snr = m["obs/rx_snr_db"]
        require(math.isfinite(snr)
                and abs(snr - expect) <= TELEMETRY_SNR_WINDOW_DB,
                f"telemetry: round {r} rx_snr_db {snr} is not within "
                f"{TELEMETRY_SNR_WINDOW_DB} dB of {expect}")
        require(len(m["obs/tx_energy"]) == W,
                f"telemetry: tx_energy {m['obs/tx_energy']} is not ({W},)")
    del runs
    _free(torch)
    ms_off = statistics.median(off["ms"][1:])
    ms_on = statistics.median(on["ms"][1:])
    emit({"phase": "telemetry", "path": "llm", "ok": True, "arch": cfg.name,
          "reduced": {"n_layers": f"36 -> {ROBUST_LAYERS}"}, "W": W,
          "seq": LLM_SEQ, "rounds": TELEMETRY_LLM_ROUNDS,
          "ms_per_round_off": ms_off, "ms_per_round_on": ms_on,
          "overhead_ms": ms_on - ms_off, "round_ms_off": off["ms"],
          "round_ms_on": on["ms"], "wall_s_off": off["wall"],
          "wall_s_on": on["wall"], "bitwise_off_on": True,
          "loss": on["loss"], "rx_snr_expect_db": expect,
          "metrics": on["metrics"], "peak_gb_off": off["peak"] / 1e9,
          "peak_gb_on": on["peak"] / 1e9, "launches_off": per_round[None],
          "launches": launches})
    return launches


#: phase ``launch``: the launcher's flags at granite-8b's full width
LAUNCH_ARGS = ["--arch", LLM_ARCH, "--workers", str(LLM_WORKERS), "--seq",
               str(LLM_SEQ), "--batch", "1", "--local-steps", "2",
               "--local-lr", str(LLM_LR), "--driver", "scan", "--rounds", "4",
               "--log-every", "2"]
LAUNCH_ROUNDS = 4
#: the kill-and-resume run of tests/test_checkpoint_resume.py, its flags
LAUNCH_RESUME_ARGS = ["--arch", LLM_ARCH, "--reduced", "--workers", "2",
                      "--seq", "16", "--local-steps", "1", "--driver",
                      "scan", "--log-every", "2", "--checkpoint-every", "2",
                      "--nan-workers", "1", "--burst-prob", "0.5",
                      "--burst-std", "20", "--straggler-prob", "0.3",
                      "--guard", "evict-retransmit", "--snr-floor-db", "-40"]


def _launch_quiet(launch, argv, model=None):
    """``repro_torch.launch.train.run`` on ``argv`` with its stdout kept
    (returned with the result), not printed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = launch.run(launch.parser().parse_args(argv), model)
    return res, buf.getvalue()


def phase_launch(torch):
    """``python -m repro_torch.launch.train`` through its ``run`` on
    granite-8b at full width cut to 1 layer (``ROBUST_LAYERS``): W = 2,
    1 × 4,096 tokens, 2 sgd steps at 5e-4, the scan driver for 4 rounds in
    blocks of 2, with ``--run-dir`` (telemetry on) and ``--autotune-cache``,
    three times.  The first call adds ``--profile`` and measures the sweep;
    the next two, plain CLI runs, read the sweep from the cache, and their
    rounds alone are timed and counted (B11's, B6, B3 and B4 a round).
    Each call records its blocks' seconds and the allocator's counters
    (``ALLOC_STATS``) over the call.  Gates:
    each run dir validates, every round is in ``metrics.jsonl``, the
    profiled call's trace file exists, the loss is finite and falls.  Then
    the reference's kill-and-resume on the card, its launches kept apart:
    reduced granite-8b with its faults and guard, 6 rounds, and 4 then
    resumed to 6: ``round_00000006.npz`` bit for bit."""
    import tempfile

    from repro_torch.checkpoint import round_path
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    from repro_torch.obs.sink import read_events
    from repro_torch.obs.validate import validate_run_dir

    model = build_model(_llm_cfg(LLM_ARCH, ROBUST_LAYERS))
    knobs = ("REPRO_OTA_BLOCK_COLS", "REPRO_OTA_WORKER_CHUNK")
    saved = {k: os.environ.get(k) for k in knobs}
    calls, launches = [], {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cache = os.path.join(tmp, "autotune.json")
            for i, profiled in enumerate((True, False, False)):
                rd = os.path.join(tmp, f"run{i}")
                _free(torch)
                torch.cuda.reset_peak_memory_stats()
                build.reset_launches()
                stats0 = torch.cuda.memory_stats()
                t0 = time.perf_counter()
                res, out = _launch_quiet(launch, [
                    *LAUNCH_ARGS, "--run-dir", rd, "--autotune-cache", cache,
                    *(["--profile"] if profiled else [])], model)
                total_s = time.perf_counter() - t0
                stats1 = torch.cuda.memory_stats()
                peak = torch.cuda.max_memory_allocated()
                if not profiled:
                    # a plain call's own launches (its sweep is a cache hit
                    # and launches nothing); the last one's are the path's
                    launches = dict(build.launches)
                    _per_round(launches, LAUNCH_ROUNDS, LLM_ROUND_1_LAUNCHES)
                del res["state"]
                _free(torch)
                errs = validate_run_dir(rd)
                events = read_events(rd)
                rounds = [e["round"] for e in events if e["event"] == "round"]
                losses = res["losses"]
                tune = res["autotune"]
                require(not errs, f"launch: run dir {errs}")
                require(rounds == list(range(LAUNCH_ROUNDS)),
                        f"launch: rounds {rounds}")
                if profiled:
                    require(res["trace"] is not None
                            and os.path.isfile(res["trace"]),
                            f"launch: no trace ({res['trace']})")
                require(all(math.isfinite(x) for x in losses)
                        and losses[-1] < losses[0],
                        f"launch: losses {losses}")
                require(tune is not None and tune["cached"] == (i > 0),
                        f"launch: call {i} autotune {tune}")
                round_s = res["seconds"] / res["rounds"]
                calls.append({
                    "profiled": profiled,
                    "autotune_cached": tune["cached"],
                    "autotune_best": tune["best"],
                    "autotune_table": tune["table"],
                    "seconds_per_round": round_s,
                    "tokens_per_s": LLM_WORKERS * LLM_SEQ * 2 / round_s,
                    "block_s": [e["seconds"] for e in events
                                if e["event"] == "block"],
                    "alloc": {k: stats1.get(k, 0) - stats0.get(k, 0)
                              for k in ALLOC_STATS},
                    "total_s": total_s, "peak_mem_gb": peak / 1e9,
                    "loss": losses,
                    "trace_mb": os.path.getsize(res["trace"]) / 1e6
                    if profiled else None,
                    "stdout": out.strip().splitlines()[-6:]})
            build.reset_launches()
            da, db = os.path.join(tmp, "ka"), os.path.join(tmp, "kb")
            _launch_quiet(launch, [*LAUNCH_RESUME_ARGS, "--rounds", "6",
                                   "--checkpoint-dir", da])
            _launch_quiet(launch, [*LAUNCH_RESUME_ARGS, "--rounds", "4",
                                   "--checkpoint-dir", db])
            res, out = _launch_quiet(launch, [
                *LAUNCH_RESUME_ARGS, "--rounds", "6", "--checkpoint-dir", db,
                "--resume"])
            require("resumed from round 4" in out, f"launch: {out}")
            diff = _npz_diff(round_path(da, 6), round_path(db, 6))
            require(not diff, f"launch: the resumed reduced run differs "
                    f"from the uninterrupted one in {diff}")
            torch.cuda.synchronize()
            resume_launches = dict(build.launches)
            del res
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _free(torch)
    emit({"phase": "launch", "ok": True, "arch": LLM_ARCH,
          "reduced": {"n_layers": f"36 -> {ROBUST_LAYERS}"},
          "argv": LAUNCH_ARGS, "calls": calls,
          "kill_resume": {"argv": LAUNCH_RESUME_ARGS, "killed_after": 4,
                          "rounds": 6, "bitwise": True,
                          "launches": resume_launches},
          "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# the privacy harness, decentralized GADMM, chunked_attn, save_dots and the
# example twins
# ---------------------------------------------------------------------------

#: the observation gap's bar, in units of 2⁻²⁴ (f32's unit roundoff) times
#: W times the largest product term |h|·|s| of either witness: each of the
#: two views rounds every term a few times (h·θ, λ/ρ, the sum, the complex
#: product) and sums W of them, so the two sums can part by a few roundings
#: of the largest term a worker; W·2⁻²⁴ of it is already above the
#: random-walk √W a sum of W roundings takes
PRIVACY_GAP_ULPS = 4.0


def phase_privacy(torch, run):
    """The privacy harness (``core/privacy.py``) on a real round of the
    paper MLP's A-FADMM (phase ``mlp``'s W = 100, d = 109,386): θ, λ, h and
    Θ after one round; the eavesdropper's view of it, an ambiguity witness
    (δ from a seed) and its view.  Gates: exactly 2 B1 launches and no
    other OTA kernel; max|θ'−θ| > 0.1; the observation gap within
    ``PRIVACY_GAP_ULPS``·W·2⁻²⁴ of the largest product term; the
    inversion attack's RMSE on worker 0 above 0 where the digital uplink's
    is 0; Thm 2's slack of 3.  Records the view's device ms and the gap."""
    from repro_torch import rng
    from repro_torch.core import cplx, privacy
    from repro_torch.kernels import build

    alg, theta0, solver, grad_fn = (run[k] for k in ("alg", "theta0",
                                                     "solver", "grad_fn"))
    key = SEED + 41
    st0 = alg.init(key, theta0)
    st, _ = alg.round(rng.fold_in(key, 1), st0, solver, grad_fn)
    theta, lam, h, rho = st.theta, st.lam, st.blk.h, alg.acfg.rho
    W, d = theta.shape
    torch.cuda.synchronize()
    build.reset_launches()
    view, view_ms, _ = _event_ms(torch, lambda: privacy.eavesdropper_view(
        theta, lam, h, rho, st0.Theta, st.Theta))
    theta2, lam2, h2 = privacy.construct_ambiguity(key + 1, theta, lam, h,
                                                   rho)
    view2 = privacy.eavesdropper_view(theta2, lam2, h2, rho, st0.Theta,
                                      st.Theta)
    gap = float(privacy.observation_gap(view, view2))
    guess = privacy.model_inversion_attack(view, W, rho, key)
    rmse = float(torch.sqrt(torch.mean((guess - theta[0]) ** 2)))
    torch.cuda.synchronize()
    launches = dict(build.launches)
    require({k: v for k, v in launches.items() if v} == {"ota_modulate": 2},
            f"privacy: launches {launches}, want 2 of ota_modulate and "
            f"nothing else")
    # the largest product term h·s of either witness: |h|·(|h|·|θ| + |λ|/ρ)
    habs = torch.sqrt(cplx.abs2(h))
    term = float(torch.max(habs * (habs * torch.maximum(theta.abs(),
                                                        theta2.abs())
                                   + torch.maximum(
                                       torch.sqrt(cplx.abs2(lam)),
                                       torch.sqrt(cplx.abs2(lam2))) / rho)))
    bar = PRIVACY_GAP_ULPS * W * 2.0 ** -24 * term
    y_max = float(torch.max(torch.maximum(view.y.re.abs(),
                                          view.y.im.abs())))
    moved = float((theta2 - theta).abs().max())
    received = theta.clone()   # a digital uplink decodes each θ_n verbatim
    digital_rmse = float(torch.sqrt(torch.mean((received[0] - theta[0])
                                               ** 2)))
    slack = privacy.underdetermination(W)["slack"]
    require(moved > 0.1, f"privacy: the witness moved θ by only {moved}")
    require(gap <= bar, f"privacy: observation gap {gap} above the f32 bar "
            f"{bar} ({PRIVACY_GAP_ULPS}·W·2⁻²⁴·{term})")
    require(rmse > 0.0 and digital_rmse == 0.0, f"privacy: attack RMSE "
            f"{rmse}, digital {digital_rmse}")
    require(slack == 3, f"privacy: Thm 2 slack {slack}")
    emit({"phase": "privacy", "ok": True, "W": W, "d": d,
          "round": "one A-FADMM round of phase mlp's task",
          "view_device_ms": view_ms, "observation_gap": gap,
          "gap_rel_to_max_y": gap / y_max, "gap_bar": bar,
          "gap_bar_rel_to_max_y": bar / y_max, "largest_term": term,
          "max_theta_shift": moved, "attack_rmse_worker0": rmse,
          "digital_rmse_worker0": digital_rmse,
          "underdetermination": privacy.underdetermination(W),
          "launches": launches})
    return launches


#: phase ``decentralized``: the masked chain's dead interior worker and
#: rounds
DEC_DEAD, DEC_MASKED_ROUNDS = 3, 100


def phase_decentralized(torch):
    """Paper §6's decentralized analog GADMM on the card: the torch twin
    ``ablation_decentralized`` at the paper's configuration (W = 8, d = 6,
    40 dB, ρ = 1, 300 rounds), then the same chain with interior worker
    ``DEC_DEAD`` dead for ``DEC_MASKED_ROUNDS`` rounds.  Gates: final gap
    < 1e-4, 2 channel uses a round; the dead row's θ bit for bit its
    initial one, its edge dual zero, the alive chain's consensus gap
    falling; no OTA kernel.  Records s/round of both runs."""
    from repro_torch.benchmarks import ablation_noniid as abl
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.decentralized import (AnalogGadmm,
                                                gadmm_quadratic_solver)
    from repro_torch.core.subcarrier import SubcarrierPlan
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    rounds = 300
    build.reset_launches()
    t0 = time.perf_counter()
    out = abl.ablation_decentralized(rounds, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    require(out["final_gap"] < 1e-4, f"decentralized: final gap "
            f"{out['final_gap']} >= 1e-4")
    require(out["channel_uses_per_round"] == 2.0, f"decentralized: "
            f"{out['channel_uses_per_round']} channel uses a round, want 2")

    key, W, d = abl.DECENTRALIZED_KEY, 8, 6
    X, y, theta0 = abl.decentralized_task(key, W, d, dev)
    m = X.shape[0] // W
    Xw = X[: m * W].reshape(W, m, d) / math.sqrt(m)
    yw = y[: m * W].reshape(W, m) / math.sqrt(m)
    alive = torch.ones(W, dtype=torch.bool, device=dev)
    alive[DEC_DEAD] = False
    alg = AnalogGadmm(ccfg=ChannelConfig(n_workers=W, n_subcarriers=d,
                                         noisy=True, snr_db=40.0),
                      plan=SubcarrierPlan.build(d, d), rho=1.0, mask=alive)
    t0 = time.perf_counter()
    st, met = alg.scan_rounds(key, alg.init(key, theta0),
                              gadmm_quadratic_solver(Xw, yw, alg.rho), None,
                              DEC_MASKED_ROUNDS)
    torch.cuda.synchronize()
    masked_s = time.perf_counter() - t0
    launches = dict(build.launches)
    require(not any(launches.values()), f"decentralized: OTA launches "
            f"{launches}")
    gaps = met["consensus_gap"].tolist()
    require(bool(torch.equal(st.theta[DEC_DEAD], theta0[DEC_DEAD])),
            "decentralized: the dead worker's θ moved")
    require(not bool(st.lam[DEC_DEAD].any()), "decentralized: the dead "
            "worker's edge dual is not zero")
    require(all(math.isfinite(g) for g in gaps) and gaps[-1] < gaps[0],
            f"decentralized: the masked chain's consensus gap went "
            f"{gaps[0]} -> {gaps[-1]}")
    emit({"phase": "decentralized", "ok": True, "W": W, "d": d,
          "rounds": rounds, **out, "seconds_per_round": run_s / rounds,
          "masked": {"dead": DEC_DEAD, "rounds": DEC_MASKED_ROUNDS,
                     "seconds_per_round": masked_s / DEC_MASKED_ROUNDS,
                     "consensus_gap_first": gaps[0],
                     "consensus_gap_last": gaps[-1],
                     "alive": float(met["gadmm_alive"][-1])},
          "launches": launches})
    return launches


#: phase ``chunked_attn``: the query chunk, and the bar on the chunked
#: path against the masked one in bf16.  Both compute each row's exact
#: softmax from f32 scores; only the score and PV products' shapes differ,
#: so cuBLAS may accumulate their f32 sums in another order, and a bf16
#: rounding of a weight, an output or a gradient element can flip.  One
#: flip is one bf16 ulp, at most 2⁻⁷ of the tensor's largest magnitude (8
#: significant bits); the bar is two of them
ATTN_CHUNK_ROWS = 512
ATTN_TOL_REL = 2.0 ** -6
ATTN_RUNS = 3


def _attn_err(a, b) -> float:
    """max|a − b| / max|b|."""
    ref = float(b.float().abs().max())
    return float((a.float() - b.float()).abs().max()) / max(ref, 1e-30)


def phase_chunked_attn(torch):
    """``REPRO_OPT=chunked_attn`` on the card.  First one recurrentgemma-2b
    local-attention sub-block (``models/hybrid.attn_block_fwd``: rmsnorm, 10
    heads over 1 KV head of 256, window 2,048) at full width, input
    (2, 4,096, 2,560) bf16, parameters from a seed: forward under no_grad
    and forward + backward of a fixed scalar loss, on the masked path and
    on the chunked one (512-row chunks).  Gates: output and every parameter
    gradient within ``ATTN_TOL_REL``.  Records each path's max error, peak
    above the inputs (``reset_peak_memory_stats`` around each) and device
    ms.  Then phase ``llm``'s trainer on granite-8b cut to 1 layer under the
    flag, 3 rounds: full causal attention keeps B11 (4 fwd, 2 dq, 2 dk/dv a
    round)."""
    from repro_torch import rng
    from repro_torch.models import get_config, hybrid
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    p = hybrid.attn_block_init(SEED + 9, cfg, device=dev)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    gen = rng.generator(SEED + 10, dev)
    shape = (LLM_WORKERS, LLM_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    cot = torch.randn(shape, generator=gen, device=dev)
    pos = torch.arange(LLM_SEQ, dtype=torch.int32, device=dev)
    flags = {"masked": "", "chunked": "chunked_attn"}

    def fwd():
        with torch.no_grad():
            return hybrid.attn_block_fwd(p, x, cfg, pos)

    def fwd_bwd():
        for leaf in leaves:
            leaf.grad = None
        out = hybrid.attn_block_fwd(p, x, cfg, pos)
        (out.float() * cot).sum().backward()
        return out.detach(), [leaf.grad for leaf in leaves]

    res, stats = {}, {}
    for path, flag in flags.items():
        with _opt_env(REPRO_OPT=flag, REPRO_ATTN_CHUNK=ATTN_CHUNK_ROWS):
            row = {}
            for mode, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
                _free(torch)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                res[path, mode] = fn()
                torch.cuda.synchronize()
                row[mode + "_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                row[mode + "_peak_above_inputs_gb"] = (
                    torch.cuda.max_memory_allocated() - base) / 1e9
            stats[path] = row
    out_m, out_c = res["masked", "fwd"], res["chunked", "fwd"]
    (bo_m, g_m), (bo_c, g_c) = res["masked", "fwd_bwd"], \
        res["chunked", "fwd_bwd"]
    errs = {"fwd": _attn_err(out_c, out_m), "fwd_bwd_out": _attn_err(bo_c,
                                                                     bo_m),
            "grads": [_attn_err(a, b) for a, b in zip(g_c, g_m)]}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out_m, out_c, bo_m, bo_c, *g_m, *g_c))
    require(finite, "chunked_attn: non-finite output or gradient")
    worst = max(errs["fwd"], errs["fwd_bwd_out"], *errs["grads"])
    require(worst <= ATTN_TOL_REL, f"chunked_attn: chunked against masked "
            f"{errs} above {ATTN_TOL_REL}")
    bitwise = (bool(torch.equal(out_m, out_c)) and bool(torch.equal(bo_m,
                                                                    bo_c))
               and all(bool(torch.equal(a, b)) for a, b in zip(g_m, g_c)))
    del res, out_m, out_c, bo_m, bo_c, g_m, g_c
    for path, flag in flags.items():
        with _opt_env(REPRO_OPT=flag, REPRO_ATTN_CHUNK=ATTN_CHUNK_ROWS):
            stats[path]["fwd_ms"] = time_ms(torch, fwd, runs=ATTN_RUNS,
                                            warmup=1)
            stats[path]["fwd_bwd_ms"] = time_ms(torch, fwd_bwd,
                                                runs=ATTN_RUNS, warmup=1)
    emit({"phase": "chunked_attn", "path": "block", "ok": True,
          "arch": cfg.name, "reduced": "one local-attention sub-block "
          "(models/hybrid.attn_block_fwd), no embedding, mlp or recurrence",
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
          "window": cfg.attn_window, "chunk": ATTN_CHUNK_ROWS,
          "dtype": cfg.param_dtype, "input": list(shape),
          "loss": "sum(out * fixed N(0, 1) cotangent)",
          "max_err_rel": errs, "tol_rel": ATTN_TOL_REL,
          "bitwise_equal": bitwise, "paths": stats})
    del p, leaves, x, cot
    _free(torch)
    with _opt_env(REPRO_OPT="chunked_attn",
                  REPRO_ATTN_CHUNK=ATTN_CHUNK_ROWS):
        launches, _, _, _ = phase_llm(
            torch, "chunked_attn_llm", LLM_ARCH, ROBUST_LAYERS, LLM_SEQ,
            LLM_LR, LLM_ROUND_1_LAUNCHES)
    _free(torch)
    return launches


#: phase ``save_dots``: Θ after phase ``llm``'s 3 rounds against ``llm``'s,
#: relative Frobenius distance a leaf
SAVE_DOTS_THETA_RTOL = 1e-3


def _keep_theta(store: dict):
    """A ``phase_llm`` gate that keeps the run's Θ leaves on the host."""
    from repro_torch.tree import tree_leaves

    def gate(metrics, state):
        store["Theta"] = [leaf.detach().cpu() for leaf in
                          tree_leaves(state.Theta)]
        return {}
    return gate


def phase_save_dots(torch, llm: dict, llm_theta: list, llm_profile: dict):
    """Phase ``llm`` again under ``REPRO_OPT=save_dots`` (each checkpointed
    layer keeps its matrix products' outputs), from the same state and
    draws, then one more round under torch.profiler.  Gates: ``llm``'s
    launches a round (B11's forward still runs again in the backward), the
    peak within the card, the first round's loss bit-equal to ``llm``'s
    (the forward is the same ops), Θ after 3 rounds within
    ``SAVE_DOTS_THETA_RTOL`` of ``llm``'s.  Records whether Θ is bit-equal,
    s/round, device and cuBLAS ms of the profiled round and the peak,
    beside ``llm``'s (``llm``: its summary, ``llm_theta``: its Θ leaves
    from ``_keep_theta``, ``llm_profile``: its profiled round)."""
    from repro_torch.tree import tree_leaves

    def gate(metrics, state):
        rel, equal = [], True
        for got, want in zip(tree_leaves(state.Theta), llm_theta):
            w = want.to(got.device).float()
            diff = got.float() - w
            rel.append(float(torch.linalg.vector_norm(diff)
                             / torch.linalg.vector_norm(w)))
            equal = equal and not bool(diff.any())
            del w, diff
        require(max(rel) <= SAVE_DOTS_THETA_RTOL, f"save_dots: Θ relative "
                f"distance {max(rel)} from llm's above "
                f"{SAVE_DOTS_THETA_RTOL}")
        return {"theta_rel_to_llm": max(rel), "theta_bitwise_llm": equal}

    with _opt_env(REPRO_OPT="save_dots"):
        launches, one_round, round_s, summary = phase_llm(
            torch, "save_dots", LLM_ARCH, LLM_LAYERS, LLM_SEQ, LLM_LR,
            LLM_LAUNCHES, reference=llm, loss_rounds=1, loss_rtol=0.0,
            gate=gate, peak_below=False)
        prof = phase_profile(torch, "save_dots", one_round, round_s)
    del one_round
    _free(torch)
    emit({"phase": "save_dots", "path": "against llm", "ok": True,
          "seconds_per_round": round_s, "llm_seconds_per_round":
          llm["seconds_per_round"], "device_ms": prof["device_ms"],
          "llm_device_ms": llm_profile["device_ms"],
          "matmul_ms": prof["matmul_ms"],
          "llm_matmul_ms": llm_profile["matmul_ms"],
          "peak_mem_gb": summary["peak_mem_gb"],
          "llm_peak_mem_gb": llm["peak_mem_gb"]})
    return launches


#: phase ``examples``: the LLM twin's steps, and its launches a step at its
#: default 8 layers: B11 as ``llm`` a layer, one packed round
EXAMPLE_LLM_STEPS, EXAMPLE_LLM_LAYERS = 25, 8
EXAMPLE_LLM_LAUNCHES = {"flash_attention_fwd": 2 * EXAMPLE_LLM_LAYERS * 2,
                        "flash_attention_dq": EXAMPLE_LLM_LAYERS * 2,
                        "flash_attention_dkv": EXAMPLE_LLM_LAYERS * 2,
                        "ota_round_stats": 1, "ota_demodulate_dyn": 1,
                        "admm_dual_update": 1}
EXAMPLE_QUICKSTART_ROUNDS = 200


def _quiet(torch, main, argv):
    """``main(argv)`` with its printing kept: (its result, its output's
    last lines, seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    torch.cuda.synchronize()
    return out, buf.getvalue().splitlines()[-3:], time.perf_counter() - t0


def phase_examples(torch):
    """The example twins on the card through their ``main``: the
    quickstart (A-FADMM linreg, 200 rounds), ``train_llm_federated`` at its
    default width (granite-family, d_model 256, 8 layers, 4 workers) for
    25 steps, and ``privacy_attack_demo``.  Gates: the quickstart's final
    gap < 1e-4 and B1, B2, B4 once a round; the LLM twin's loss falls and
    its B11, B6, B3, B4 a step; the demo's observation gap below the
    reference's 1e-4 and 2 B1."""
    from repro_torch.examples import (privacy_attack_demo, quickstart,
                                      train_llm_federated)
    from repro_torch.kernels import build

    total: dict = {}
    rows = {}

    def counted(name, main, argv):
        build.reset_launches()
        out, tail, secs = _quiet(torch, main, argv)
        got = dict(build.launches)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        rows[name] = {"result": out, "stdout_tail": tail, "seconds": secs,
                      "launches": got}
        return out, got

    out, got = counted("quickstart", quickstart.main, [])
    require(out["final_gap"] < 1e-4, f"examples: quickstart gap "
            f"{out['final_gap']}")
    _per_round(got, EXAMPLE_QUICKSTART_ROUNDS, {
        "ota_modulate": 1, "ota_receive": 1, "admm_dual_update": 1})
    require(got.get("admm_flip_lambda", 0) >= 1, f"examples: the "
            f"quickstart's flip rule never ran: {got}")
    out, got = counted("train_llm_federated", train_llm_federated.main,
                       ["--steps", str(EXAMPLE_LLM_STEPS)])
    require(out["loss"][-1] < out["loss"][0], f"examples: the LLM twin's "
            f"loss {out['loss']} did not fall")
    _per_round(got, EXAMPLE_LLM_STEPS, EXAMPLE_LLM_LAUNCHES)
    out, got = counted("privacy_attack_demo", privacy_attack_demo.main, [])
    require(out["observation_gap"] < 1e-4, f"examples: the demo's gap "
            f"{out['observation_gap']}")
    require({k: v for k, v in got.items() if v} == {"ota_modulate": 2},
            f"examples: the demo launched {got}")
    emit({"phase": "examples", "ok": True, **rows, "launches": total})
    return total


#: phase ``llm_sketched_check``: ``tests/test_fl_llm.py``'s sketched setting
#: (reduced granite-8b, W = 4, B = 2, S = 16, ratio 16, sketch_lr 0.5, 2
#: local sgd steps at 1e-2) in f32, so the card can be held to the CPU
SKETCH_CHECK_W, SKETCH_CHECK_B, SKETCH_CHECK_S = 4, 2, 16
SKETCH_CHECK_FL = dict(n_workers=SKETCH_CHECK_W, local_steps=2,
                       local_lr=1e-2, sketch_ratio=16, sketch_lr=0.5)
#: rounds held card against CPU, then rounds trained on the card alone to
#: the reference's own bar (the last loss below 0.9 × the first)
SKETCH_CHECK_ROUNDS, SKETCH_TRAIN_ROUNDS, SKETCH_TRAIN_BAR = 3, 12, 0.9
#: card against CPU, f32: the local steps' sums and the codec's scatter-add
#: (float atomics on the card) run in other orders, and the round divides
#: by Σ|h|²
SKETCH_LOSS_RTOL = 1e-5
SKETCH_THETA_ATOL = 1e-5


def _sketched_launches(cfg, W: int, local_steps: int) -> dict:
    """A sketched round's launches: B11 as each worker's local steps make
    it (the forward, and again in the checkpoint's recompute; dq and dk/dv
    once a step and layer), one B6 + B3 and one B4 on the (W, d_s)
    sketches."""
    n = W * local_steps * cfg.n_layers
    return {"flash_attention_fwd": 2 * n, "flash_attention_dq": n,
            "flash_attention_dkv": n, "ota_round_stats": 1,
            "ota_demodulate_dyn": 1, "admm_dual_update": 1,
            "ota_modulate": 0, "ota_receive": 0, "ota_round_theta": 0}


def phase_llm_sketched_check(torch):
    """The sketched mode (``make_fl_train(mode="sketched")``) on reduced
    granite-8b in f32: 3 rounds on the card and on the CPU (the plain
    versions) from the same state and draws, losses and Θ held; then 12
    rounds on the card from the initial state, the loss below 0.9 × its
    first.  Launches: B11 for every local step, B6, B3 and B4 once a
    round."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_config
    from repro_torch.train.llm_trainer import (FLConfig, draw_round,
                                               make_fl_train)
    from repro_torch.tree import to_device, tree_leaves

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LLM_ARCH).reduced(),
                              param_dtype="float32")
    model = build_model(cfg)
    W = SKETCH_CHECK_W
    flcfg = FLConfig(mode="sketched", **SKETCH_CHECK_FL)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0)
    init_cpu, step_cpu = make_fl_train(model, flcfg, acfg, ccfg,
                                       device="cpu")
    _, step_gpu = make_fl_train(model, flcfg, acfg, ccfg)
    tokens = token_dataset(SEED + 7, SKETCH_CHECK_B, SKETCH_CHECK_S,
                           cfg.vocab_size, n_workers=W, device="cpu")
    st0 = init_cpu(SEED)
    st_cpu, st_gpu = st0, to_device(st0, dev)
    cpu_losses, gpu_losses = [], []
    build.reset_launches()
    for r in range(SKETCH_CHECK_ROUNDS):
        draws = draw_round(rng.fold_in(SEED, r + 1), st_cpu, ccfg)
        st_cpu, m_cpu = step_cpu(st_cpu, {"tokens": tokens}, draws=draws)
        st_gpu, m_gpu = step_gpu(st_gpu, {"tokens": tokens.to(dev)},
                                 draws=to_device(draws, dev))
        cpu_losses.append(float(m_cpu["loss"]))
        gpu_losses.append(float(m_gpu["loss"]))
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu_losses, cpu_losses)]
    require(all(math.isfinite(x) for x in gpu_losses + cpu_losses),
            f"llm_sketched_check: non-finite losses {gpu_losses}, "
            f"{cpu_losses}")
    require(max(rel) <= SKETCH_LOSS_RTOL, f"llm_sketched_check: card losses "
            f"{gpu_losses} differ from the CPU's {cpu_losses} by up to "
            f"{max(rel)} relative, beyond {SKETCH_LOSS_RTOL}")
    theta_gap = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree_leaves(st_gpu.Theta),
                                    tree_leaves(st_cpu.Theta)))
    require(theta_gap <= SKETCH_THETA_ATOL, f"llm_sketched_check: card Θ "
            f"differs from the CPU's by {theta_gap} after "
            f"{SKETCH_CHECK_ROUNDS} rounds, beyond {SKETCH_THETA_ATOL}")
    st = to_device(st0, dev)
    batch = {"tokens": tokens.to(dev)}
    losses = []
    t0 = time.perf_counter()
    for r in range(SKETCH_TRAIN_ROUNDS):
        st, m = step_gpu(st, batch, key=rng.fold_in(SEED, 100 + r))
        losses.append(float(m["loss"]))
    round_s = (time.perf_counter() - t0) / SKETCH_TRAIN_ROUNDS
    launches = dict(build.launches)
    _per_round(launches, SKETCH_CHECK_ROUNDS + SKETCH_TRAIN_ROUNDS,
               _sketched_launches(cfg, W, SKETCH_CHECK_FL["local_steps"]))
    require(all(math.isfinite(x) for x in losses) and losses[-1]
            < SKETCH_TRAIN_BAR * losses[0], f"llm_sketched_check: the loss "
            f"went {losses[0]} -> {losses[-1]} in {SKETCH_TRAIN_ROUNDS} "
            f"rounds, not below {SKETCH_TRAIN_BAR}× (losses {losses})")
    emit({"phase": "llm_sketched_check", "ok": True, "arch": cfg.name,
          "reduced": "ModelConfig.reduced(): 2 layers, d_model 128",
          "dtype": "float32", **SKETCH_CHECK_FL,
          "batch_per_worker": SKETCH_CHECK_B, "seq": SKETCH_CHECK_S,
          "d_s": st0.lam.re.shape[1], "loss": gpu_losses,
          "cpu_loss": cpu_losses, "loss_rel_err": rel,
          "loss_rtol": SKETCH_LOSS_RTOL,
          "Theta_max_abs_gap": theta_gap, "Theta_atol": SKETCH_THETA_ATOL,
          "train_loss": losses, "train_bar": SKETCH_TRAIN_BAR,
          "seconds_per_round": round_s, "launches": launches})
    return launches


#: phase ``llm_sketched``: granite-8b at full width and full depth
#: (D = 8,053,362,688) in bf16, W = 2, 1 × 4,096 tokens a worker, 2 local
#: sgd steps at ``LLM_LR``, ratio 256 (d_s = 31,458,448), sketch_lr 1, 3
#: rounds, telemetry on for the model-space update norm
SKETCH_LAYERS, SKETCH_RATIO, SKETCH_LR, SKETCH_ROUNDS = 36, 256, 1.0, 3


def _codec_ms(torch, Theta, d_s: int) -> dict:
    """Device ms of the round's codec on ``Theta``'s leaves (a delta's size
    and layout): one worker's chunked encode, and one decode of a (d_s,)
    sketch a chunk at a time (its values summed so none is dropped)."""
    from repro_torch.core.sketch import (chunks, decode_packed,
                                         encode_chunked)
    from repro_torch.train.llm_trainer import SKETCH_SEED
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(Theta)
    s = torch.zeros(d_s, device=leaves[0].device)

    def encode():
        encode_chunked(leaves, d_s, SKETCH_SEED, out=s)

    def decode():
        acc, off = torch.zeros((), device=s.device), 0
        for leaf in leaves:
            n = leaf.numel()
            for a, b in chunks(n):
                acc += decode_packed(s, b - a, SKETCH_SEED, off + a).sum()
            off += n
        return acc

    return {"encode_ms": time_ms(torch, encode, runs=3, warmup=1),
            "decode_ms": time_ms(torch, decode, runs=3, warmup=1)}


def phase_llm_sketched(torch, phase: str = "llm_sketched",
                       arch: str = LLM_ARCH, n_layers: int = SKETCH_LAYERS):
    """The sketched mode on granite-8b at full width and all 36 layers
    (or ``arch`` cut to ``n_layers``), bf16: Θ is one shared model (16.1
    GB for granite-8b), λ and h (2, d_s).  Gates: the peak within the card,
    λ and h (W, d_s), every round's loss and Θ finite, the launches of
    every round (B11 288/144/144 for granite-8b, B6, B3, B4 once);
    recorded: s/round, tokens/s, the codec's device ms, the model-space
    update norm, one profiled round; for a moe arch the aux loss a round
    and the share of (token, k) pairs the capacity dropped."""
    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_config, moe
    from repro_torch.models.registry import packed_param_count
    from repro_torch.train.llm_trainer import (FLConfig, _sketch_dim,
                                               make_fl_train)
    from repro_torch.tree import tree_leaves

    cfg = _llm_cfg(arch, n_layers)
    routed = cfg.family == "moe"
    model = build_model(cfg)
    W, B, S, local_steps = LLM_WORKERS, 1, LLM_SEQ, 2
    flcfg = FLConfig(mode="sketched", n_workers=W, local_steps=local_steps,
                     local_lr=LLM_LR, sketch_ratio=SKETCH_RATIO,
                     sketch_lr=SKETCH_LR, telemetry=True)
    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_fn, train_step = make_fl_train(model, flcfg, acfg, ccfg)
    state = init_fn(SEED)
    tokens = token_dataset(SEED + 1, B, S, cfg.vocab_size, n_workers=W)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    d = sum(leaf.numel() for leaf in tree_leaves(state.Theta))
    _check_packed_d(phase, cfg, d)
    d_s = _sketch_dim(packed_param_count(cfg), SKETCH_RATIO)
    require(tuple(state.lam.re.shape) == (W, d_s)
            and tuple(state.chan.h.re.shape) == (W, d_s),
            f"{phase}: λ {tuple(state.lam.re.shape)} and h "
            f"{tuple(state.chan.h.re.shape)} are not ({W}, {d_s})")
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, times, norms, inv_alphas, auxs = [], [], [], [], []
    kept = pairs = 0
    for r in range(SKETCH_ROUNDS):
        held = [state]
        state = None
        routing = (moe.record_routing() if routed
                   else contextlib.nullcontext([]))
        t0 = time.perf_counter()
        with routing as seen:
            state, m = train_step(held.pop(), batch,
                                  key=rng.fold_in(SEED, r + 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        # each dispatch of the round, the checkpoints' recomputes too
        kept += sum(int(e["kept"].sum()) for e in seen)
        pairs += sum(e["kept"].numel() for e in seen)
        del seen
        losses.append(float(m["loss"]))
        norms.append(float(m["obs/theta_update_norm"]))
        inv_alphas.append(float(m["inv_alpha"]))
        if routed:
            auxs.append(float(m["aux"]))
        require(math.isfinite(losses[-1]) and math.isfinite(norms[-1]),
                f"{phase}: round {r} loss {losses[-1]} or update norm "
                f"{norms[-1]} is not finite")
        require(all(bool(torch.isfinite(leaf).all())
                    for leaf in tree_leaves(state.Theta)),
                f"{phase}: non-finite Θ after round {r}")
        del m
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    _per_round(launches, SKETCH_ROUNDS, _sketched_launches(cfg, W,
                                                           local_steps))
    require(peak <= CARD_BYTES and setup_peak <= CARD_BYTES,
            f"{phase}: peak {peak / 1e9} GB (set-up "
            f"{setup_peak / 1e9} GB) is above the card's "
            f"{CARD_BYTES / 1e9} GB")
    round_s = statistics.mean(times[1:])
    tokens_per_round = W * B * S * local_steps
    codec = _codec_ms(torch, state.Theta, d_s)
    codec_round_ms = W * codec["encode_ms"] + codec["decode_ms"]
    moe_fields = {}
    if routed:
        moe_fields = {
            "n_experts": cfg.n_experts, "top_k": cfg.n_experts_active,
            "moe_d_ff": cfg.moe_d_ff, "aux": auxs,
            "capacity": moe._capacity(B * S, cfg),
            "pairs_dispatched": pairs,
            "pairs_dropped_share": (pairs - kept) / pairs}
    reduced = ({} if n_layers == get_config(arch).n_layers else
               {"reduced": {"n_layers": f"{get_config(arch).n_layers} -> "
                                        f"{n_layers}"}})
    emit({"phase": phase, "ok": True, "arch": cfg.name, **reduced,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
          "dtype": cfg.param_dtype, "D": d, "d_s": d_s,
          "sketch_ratio": SKETCH_RATIO, "sketch_lr": SKETCH_LR, "W": W,
          "batch_per_worker": B, "seq": S, "local_steps": local_steps,
          "local_lr": LLM_LR, "rounds": SKETCH_ROUNDS, "setup_s": setup_s,
          "setup_peak_gb": setup_peak / 1e9, "round_s": times,
          "seconds_per_round": round_s,
          "tokens_per_s": tokens_per_round / round_s, "loss": losses,
          "model_space_update_norm": norms, "inv_alpha": inv_alphas,
          "peak_mem_gb": peak / 1e9, "codec_encode_ms": codec["encode_ms"],
          "codec_decode_ms": codec["decode_ms"],
          "codec_ms_per_round": codec_round_ms,
          "codec_share_of_round": codec_round_ms / (round_s * 1e3),
          **moe_fields, "launches": launches})
    keys = iter(range(100, 1000))

    def one_round():
        nonlocal state
        state, _ = train_step(state, batch, key=rng.fold_in(SEED,
                                                            next(keys)))
    return launches, one_round, round_s


#: phase ``llm_families_check``: the moe, vlm and audio families at their
#: ``ModelConfig.reduced()`` widths in f32, so the card can be held to the
#: CPU: W = 2, 2 × 32 tokens a worker (after the vlm's 16 stub patches;
#: over the enc-dec's 16 stub frames), 2 local sgd steps at 1e-2, 3 rounds
FAMILY_ARCHS = ("deepseek-v3-671b", "qwen3-moe-30b-a3b", "pixtral-12b",
                "seamless-m4t-medium")
FAMILY_W, FAMILY_B, FAMILY_S, FAMILY_LR = 2, 2, 32, 1e-2
#: card against CPU, f32, as ``llm_hybrid`` holds it
FAMILY_LOSS_RTOL = 1e-5
FAMILY_THETA_ATOL = 1e-5


def _family_launches(cfg, local_steps: int = 2) -> dict:
    """A replicated round's launches: B11 for each causal attention layer
    (qwen3-moe's and pixtral's layers, the enc-dec's decoder; MLA and the
    enc-dec's encoder run none) twice a local step (the checkpoint's
    recompute), dq and dk/dv once; B6, B3 and B4 once."""
    n = (0 if cfg.use_mla else cfg.n_layers) * local_steps
    return {"flash_attention_fwd": 2 * n, "flash_attention_dq": n,
            "flash_attention_dkv": n, "ota_round_stats": 1,
            "ota_demodulate_dyn": 1, "admm_dual_update": 1,
            "ota_modulate": 0, "ota_receive": 0, "ota_round_theta": 0}


def _theta_gap(torch, a, b) -> float:
    from repro_torch.tree import tree_leaves

    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _same_bits(torch, a, b) -> bool:
    """Every tensor of trees ``a`` and ``b`` equal bit for bit (a Complex
    leaf by its two planes)."""
    from repro_torch.tree import tree_leaves

    def planes(tree):
        return [t for leaf in tree_leaves(tree)
                for t in ((leaf.re, leaf.im) if hasattr(leaf, "re")
                          else (leaf,))]

    return all(bool(torch.equal(x, y))
               for x, y in zip(planes(a), planes(b)))


def phase_llm_families_check(torch):
    """``train_step`` (replicated) on reduced deepseek-v3-671b,
    qwen3-moe-30b-a3b, pixtral-12b and seamless-m4t-medium in f32, 3 rounds
    on the card and the same rounds on the CPU from the same state and
    draws.  Gates: each round's loss (rtol 1e-5), Θ after 3 rounds (atol
    1e-5), the experts picked in round 1 equal pick for pick, round 1 run
    twice on the card bit-equal in Θ, θ and λ (the dispatch accumulates
    nothing by index), the launches of each round.  Then one deepseek-v3
    round under ``grouped_moe``, card and CPU, its loss recorded.  Returns
    the gated rounds' launches."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_config, moe
    from repro_torch.train.llm_trainer import (FLConfig, draw_round,
                                               make_fl_train)
    from repro_torch.tree import to_device

    dev = torch.device("cuda")
    W = FAMILY_W
    total: dict = {}
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  param_dtype="float32")
        model = build_model(cfg)
        flcfg = FLConfig(n_workers=W, local_steps=2, local_lr=FAMILY_LR)
        acfg = AdmmConfig(rho=0.5, flip_on_change=False)
        ccfg = ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=2)
        init_cpu, step_cpu = make_fl_train(model, flcfg, acfg, ccfg,
                                           device="cpu")
        _, step_gpu = make_fl_train(model, flcfg, acfg, ccfg)
        batch = {"tokens": token_dataset(SEED + 11, FAMILY_B, FAMILY_S,
                                         cfg.vocab_size, n_workers=W,
                                         device="cpu"),
                 **_frontend(torch, cfg, (W, FAMILY_B),
                             rng.generator(SEED + 12, "cpu"))}
        batch_gpu = to_device(batch, dev)
        st0 = init_cpu(SEED)
        _check_packed_d("llm_families_check", cfg, st0.lam.re.shape[1])
        draws0 = draw_round(rng.fold_in(SEED, 1), st0, ccfg)
        # round 1 twice on the card from the same state and draws
        twice = [step_gpu(to_device(st0, dev), batch_gpu,
                          draws=to_device(draws0, dev))[0] for _ in range(2)]
        bit_equal = all(_same_bits(torch, getattr(twice[0], f),
                                   getattr(twice[1], f))
                        for f in ("Theta", "theta", "lam"))
        del twice
        st_cpu, st_gpu = st0, to_device(st0, dev)
        cpu_losses, gpu_losses, picks, terms = [], [], {}, {}
        build.reset_launches()
        for r in range(LLM_ROUNDS):
            draws = draw_round(rng.fold_in(SEED, r + 1), st_cpu, ccfg)
            with moe.record_routing() as on_cpu:
                st_cpu, m_cpu = step_cpu(st_cpu, batch, draws=draws)
            with moe.record_routing() as on_gpu:
                st_gpu, m_gpu = step_gpu(st_gpu, batch_gpu,
                                         draws=to_device(draws, dev))
            if r == 0:
                picks = {"dispatches": len(on_gpu),
                         "picks": sum(e["idx"].numel() for e in on_gpu),
                         "differing": sum(
                             int((a["idx"].cpu() != b["idx"]).sum())
                             for a, b in zip(on_gpu, on_cpu)),
                         "dropped": sum(int((~e["kept"]).sum())
                                        for e in on_gpu)}
                require(len(on_gpu) == len(on_cpu),
                        f"llm_families_check: {arch} dispatched "
                        f"{len(on_gpu)} times on the card, {len(on_cpu)} "
                        f"on the CPU")
            del on_cpu, on_gpu
            cpu_losses.append(float(m_cpu["loss"]))
            gpu_losses.append(float(m_gpu["loss"]))
            for k in ("aux", "mtp"):
                if k in m_gpu:
                    terms.setdefault(k, []).append(float(m_gpu[k]))
        torch.cuda.synchronize()
        launches = dict(build.launches)
        _per_round(launches, LLM_ROUNDS, _family_launches(cfg))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        rel = [abs(g - c) / abs(c) for g, c in zip(gpu_losses, cpu_losses)]
        gap = _theta_gap(torch, st_gpu.Theta, st_cpu.Theta)
        require(all(math.isfinite(x) for x in gpu_losses + cpu_losses),
                f"llm_families_check: {arch} non-finite losses "
                f"{gpu_losses}, {cpu_losses}")
        require(max(rel) <= FAMILY_LOSS_RTOL, f"llm_families_check: {arch} "
                f"card losses {gpu_losses} differ from the CPU's "
                f"{cpu_losses} by up to {max(rel)} relative, beyond "
                f"{FAMILY_LOSS_RTOL}")
        require(gap <= FAMILY_THETA_ATOL, f"llm_families_check: {arch} card "
                f"Θ differs from the CPU's by {gap} after {LLM_ROUNDS} "
                f"rounds, beyond {FAMILY_THETA_ATOL} (or is not finite)")
        require(picks.get("differing", 0) == 0, f"llm_families_check: "
                f"{arch} picked other experts on the card than on the CPU "
                f"in round 1: {picks}")
        require(bit_equal, f"llm_families_check: {arch} round 1 run twice "
                f"on the card gave other bits")
        grouped = {}
        if arch == "deepseek-v3-671b":
            with _opt_env(REPRO_OPT="grouped_moe"):
                _, g_cpu = step_cpu(st0, batch, draws=draws0)
                _, g_gpu = step_gpu(to_device(st0, dev), batch_gpu,
                                    draws=to_device(draws0, dev))
            grouped = {"grouped_moe_loss": float(g_gpu["loss"]),
                       "grouped_moe_cpu_loss": float(g_cpu["loss"]),
                       "ungrouped_loss": gpu_losses[0]}
        emit({"phase": "llm_families_check", "ok": True, "arch": arch,
              "family": cfg.family,
              "reduced": "ModelConfig.reduced(): 2 layers, d_model 128",
              "dtype": "float32", "W": W, "batch_per_worker": FAMILY_B,
              "seq": FAMILY_S, **{k: list(v.shape) for k, v in batch.items()
                                  if k != "tokens"},
              "local_steps": 2, "local_lr": FAMILY_LR,
              "rounds": LLM_ROUNDS, "loss": gpu_losses,
              "cpu_loss": cpu_losses, "loss_rel_err": rel,
              "loss_rtol": FAMILY_LOSS_RTOL, "Theta_max_abs_gap": gap,
              "Theta_atol": FAMILY_THETA_ATOL, "loss_terms": terms,
              "round1_routing": picks, "round1_twice_bit_equal": bit_equal,
              **grouped, "launches": launches})
        del st0, st_cpu, st_gpu, batch, batch_gpu, draws0
        _free(torch)
    return total


#: phase ``llm_moe``: qwen3-moe-30b-a3b at full width (d_model 2,048, 32/4
#: heads of 128, 128 experts top 8 of d_ff 768, vocabulary 151,936, bf16)
#: cut 48 -> 12 layers (D = 7,788,611,584), in ``llm_sketched``'s setting
MOE_ARCH, MOE_LAYERS = "qwen3-moe-30b-a3b", 12
#: phase ``llm_encdec``: seamless-m4t-medium at full width and depth (12 +
#: 12 layers, D = 614,926,336), replicated, W = 2, 2 × 1,024 tokens a
#: worker over 2 × 1,024 stub frames
ENCDEC_ARCH, ENCDEC_LAYERS, ENCDEC_BATCH, ENCDEC_SEQ = (
    "seamless-m4t-medium", 12, 2, 1024)


def phase_llm_encdec(torch):
    """``llm``'s replicated round on seamless-m4t-medium at full width and
    depth (B11 in the decoder's self-attention: 48/24/24 a round), then one
    more round under torch.profiler.  Returns the round's launches."""
    import dataclasses

    from repro_torch.models import get_config

    cfg = dataclasses.replace(get_config(ENCDEC_ARCH),
                              n_layers=ENCDEC_LAYERS)
    launches, one_round, round_s, _ = phase_llm(
        torch, "llm_encdec", ENCDEC_ARCH, ENCDEC_LAYERS, ENCDEC_SEQ, LLM_LR,
        _family_launches(cfg), batch_per_worker=ENCDEC_BATCH)
    phase_profile(torch, "llm_encdec", one_round, round_s)
    return launches


#: phase ``serve``: each family at full width and depth, bf16, random init:
#: a batch of 8 prompts of 64 tokens, 64 greedy tokens through ``generate``
#: (the prompt ingested through decode), and ``make_prefill`` on the same
#: prompts (the vlm's after 256 stub patches each, the enc-dec's over 1,024
#: stub frames each), whose launches are B11 a causal attention layer
#: (granite-8b's 36, qwen3-moe's 48, pixtral's 40, seamless's 12 decoder
#: layers; none for deepseek-v3's MLA) and B12 a recurrent layer (all 64 of
#: falcon-mamba-7b; 18 of recurrentgemma-2b's 26, its windowed attention
#: taking the masked path)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 64, 64
SERVE_ARCHS = (("granite-8b", {"flash_attention_fwd": 36}),
               ("falcon-mamba-7b", {"linear_scan_fwd": 64}),
               ("recurrentgemma-2b", {"linear_scan_fwd": 18}),
               ("qwen3-moe-30b-a3b", {"flash_attention_fwd": 48}),
               ("pixtral-12b", {"flash_attention_fwd": 40}),
               ("seamless-m4t-medium", {"flash_attention_fwd": 12}),
               ("deepseek-v3-671b", {}))
#: depth cuts of the served models: deepseek-v3's 3 dense layers and 1 of
#: its 58 MoE layers (with the MTP block its init builds: 25.79 B
#: parameters, 51.6 GB)
SERVE_LAYERS = {"deepseek-v3-671b": 4}
#: the weights a decode step does not read: the MTP block, the vision
#: projector, the encoder (the enc-dec decodes against its cross cache)
SERVE_UNREAD = ("mtp_block", "mtp_proj", "mtp_norm", "projector",
                "enc_layers", "enc_norm")
#: the decode-against-forward check: f32 at full width with 2 layers (the
#: hybrid 3: one of each kind; the enc-dec 2 + 2; deepseek-v3 one dense
#: and one MoE layer, without the MTP block decode never reads), 8 tokens
#: (at most 8 tokens no MoE pair is dropped), TF32 off; the enc-dec's
#: cross cache from ``prefill_cross`` over 1,024 stub frames
SERVE_CHECK_CUTS = {"granite-8b": {"n_layers": 2},
                    "falcon-mamba-7b": {"n_layers": 2},
                    "recurrentgemma-2b": {"n_layers": 3},
                    "qwen3-moe-30b-a3b": {"n_layers": 2},
                    "pixtral-12b": {"n_layers": 2},
                    "seamless-m4t-medium": {"n_layers": 2,
                                            "n_enc_layers": 2},
                    "deepseek-v3-671b": {"n_layers": 2,
                                         "first_dense_layers": 1,
                                         "mtp": False}}
SERVE_CHECK_TOKENS, SERVE_CHECK_RTOL = 8, 1e-4


def _serve_check(torch, arch: str) -> dict:
    """Token-by-token decode against the teacher-forced forward, f32, at
    full width: max |Δlogit| ≤ ``SERVE_CHECK_RTOL`` × max |logit| and the
    same argmax at every position."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.models import build_model, encdec, get_config

    cfg = dataclasses.replace(get_config(arch), **SERVE_CHECK_CUTS[arch],
                              param_dtype="float32")
    dev = torch.device("cuda")
    m = build_model(cfg)
    p = m.init(SEED + 5)
    n = SERVE_CHECK_TOKENS
    gen = rng.generator(SEED + 6, dev)
    toks = torch.randint(0, cfg.vocab_size, (1, n), device=dev,
                         generator=gen)
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch.update(_frontend(torch, cfg, (1,), gen))
    with torch.no_grad():
        fwd, _ = m.forward(p, batch, remat=False)
        cache = m.init_cache(1, n)
        if cfg.family == "audio":
            memory = encdec.encode(p, cfg, batch["frames"], remat=False)
            cache["cross_k"], cache["cross_v"] = encdec.prefill_cross(
                p, cfg, memory)
            del memory
        errs, agree = [], []
        for t in range(n):
            logits, cache = m.decode_step(p, cache, toks[:, t], t)
            errs.append(float((logits - fwd[:, t]).abs().max()))
            agree.append(bool(torch.equal(logits.argmax(-1),
                                          fwd[:, t].argmax(-1))))
    scale = float(fwd.abs().max())
    require(max(errs) <= SERVE_CHECK_RTOL * scale and all(agree),
            f"serve: {arch} decode against forward: max |Δ| {max(errs)} "
            f"(bar {SERVE_CHECK_RTOL * scale}), argmax equal {agree}")
    del m, p, fwd, cache, batch
    return {"cut": SERVE_CHECK_CUTS[arch], "max_abs_err": max(errs),
            "max_abs_logit": scale, "argmax_equal": all(agree)}


def phase_serve(torch, card):
    """Serving (``repro_torch.serve``) on granite-8b, falcon-mamba-7b,
    recurrentgemma-2b, qwen3-moe-30b-a3b, pixtral-12b and
    seamless-m4t-medium at full width and depth, and deepseek-v3-671b cut
    to 4 layers, bf16.  Gates: the ids' shape and range, every decode
    step's logits finite, the peak within the card, the prefill's launches
    (B11 or B12; none for MLA) and none in decode, and the f32
    decode-against-forward check.  Recorded: prefill ms, the wall and
    device ms of a decode step against its bound (the bytes of the weights
    it reads at the card's memory rate: every expert's, as the reference's
    decode runs all of them), tokens/s, the peak; one decode step
    profiled.  Returns the prefills' launches."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.kernels import build
    from repro_torch.models import build_model, get_config
    from repro_torch.serve import generate, make_prefill
    from repro_torch.tree import tree_leaves

    _, (mem_rate, _, _) = card_peaks(card)
    dev = torch.device("cuda")
    B, P, N = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    paths: dict = {}
    for arch, want in SERVE_ARCHS:
        check = _serve_check(torch, arch)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        full = get_config(arch)
        model = build_model(dataclasses.replace(
            full, n_layers=SERVE_LAYERS.get(arch, full.n_layers)))
        cfg = model.cfg
        t0 = time.perf_counter()
        params = model.init(SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()

        def nbytes(tree):
            return sum(leaf.numel() * leaf.element_size()
                       for leaf in tree_leaves(tree))

        weight_bytes = nbytes(params)
        decode_bytes = nbytes({k: v for k, v in params.items()
                               if k not in SERVE_UNREAD})
        gen = rng.generator(SEED + 3, dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                                generator=gen)
        batch = {"tokens": prompts, **_frontend(torch, cfg, (B,), gen)}
        prefill = make_prefill(model)
        build.reset_launches()
        last = prefill(params, batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.launches.items() if v}
        require(launches == want, f"serve: {arch} prefill launched "
                f"{launches}, want {want}")
        require(bool(torch.isfinite(last).all()) and tuple(last.shape)
                == (B, cfg.vocab_size), f"serve: {arch} prefill logits "
                f"{tuple(last.shape)} not finite or not ({B}, V)")
        prefill_ms = time_ms(torch, lambda: prefill(params, batch), runs=5,
                             warmup=1, spin=False)
        for k, v in launches.items():
            paths[k] = paths.get(k, 0) + v

        finite = []

        def observed_step(p, c, tok, pos):
            logits, c = model.decode_step(p, c, tok, pos)
            finite.append(torch.isfinite(logits).all())
            return logits, c

        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = generate(model._replace(decode_step=observed_step), params,
                       prompts, n_steps=N)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        require(not any(build.launches.values()), f"serve: {arch} decode "
                f"launched {dict(build.launches)}")
        require(tuple(ids.shape) == (B, N) and int(ids.min()) >= 0
                and int(ids.max()) < cfg.vocab_size, f"serve: {arch} ids "
                f"{tuple(ids.shape)} in [{int(ids.min())}, "
                f"{int(ids.max())}]")
        steps = P - 1 + N
        require(len(finite) == steps and bool(torch.stack(finite).all()),
                f"serve: {arch} non-finite logits in {steps} decode steps")
        step_ms = gen_s / steps * 1e3
        peak = torch.cuda.max_memory_allocated()
        require(peak <= CARD_BYTES, f"serve: {arch} peak {peak / 1e9} GB")
        cache = model.init_cache(B, P + N)
        tok = ids[:, -1]
        prof = phase_profile(
            torch, f"serve_decode:{arch}",
            lambda: model.decode_step(params, cache, tok, P), step_ms / 1e3)
        bound_ms = decode_bytes / mem_rate * 1e3
        emit({"phase": "serve", "ok": True, "arch": arch,
              **({"reduced": {"n_layers": f"{full.n_layers} -> "
                                          f"{cfg.n_layers}"}}
                 if cfg.n_layers != full.n_layers else {}),
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "vocab_size": cfg.vocab_size, "dtype": cfg.param_dtype,
              "params": sum(leaf.numel() for leaf in tree_leaves(params)),
              "weight_bytes": weight_bytes,
              "decode_weight_bytes": decode_bytes, "batch": B, "prompt": P,
              **{f"prefill_{k}": list(v.shape) for k, v in batch.items()
                 if k != "tokens"},
              "new_tokens": N, "init_s": init_s,
              "init_peak_gb": init_peak / 1e9, "prefill_ms": prefill_ms,
              "prefill_launches": launches, "decode_steps": steps,
              "generate_s": gen_s, "decode_ms_per_step": step_ms,
              "decode_device_ms_per_step": prof["device_ms"],
              "decode_bound_ms": bound_ms,
              "decode_over_bound": step_ms / bound_ms,
              "new_tokens_per_s": B * N / gen_s,
              "peak_mem_gb": peak / 1e9, "decode_vs_forward_f32": check})
        del model, params, prompts, batch, last, ids, cache, tok, finite
        _free(torch)
    return paths


def _kernel_family(name: str) -> str:
    for fn in ("linear_scan_fwd_kernel", "linear_scan_bwd_kernel",
               # B12's staged plan
               "linear_scan_fwd_staged_kernel",
               "linear_scan_bwd_staged_kernel",
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


def phase_profile(torch, path: str, run_once, round_s: float,
                  spans=()):
    """One more round of ``path`` (``run_once``) under ``torch.profiler``:
    device time of every kernel (kernel events only: ``key_averages`` also
    credits each kernel's time to the ``aten::`` op that launched it),
    grouped by family, and its share of the unprofiled round time of that
    path's phase; for each profiler range named in ``spans``, the device
    time of the kernels launched inside it.  Returns the device ms, the
    matrix products' (cuBLAS) ms and the spans' device ms."""
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
    ranges = (GUARD_SPAN, *MOE_SPANS)
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in ranges]
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
    spans_ms = {}
    for name in spans:
        on_host = [e for e in events
                   if e.key == name and e.device_type == DeviceType.CPU]
        spans_ms[name] = {
            "calls": on_host[0].count if on_host else 0,
            "device_ms": on_host[0].device_time_total / 1e3 if on_host
            else 0.0}
    emit({"phase": "profile", "path": path, "ok": True, "rounds": 1,
          "guard": guard, **({"spans": spans_ms} if spans else {}),
          "profiled_wall_ms": wall_ms, "round_ms": round_s * 1e3,
          "device_ms": device_ms if kernels else None,
          "busy_share": device_ms / (round_s * 1e3) if kernels else None,
          "families": families,
          "top": [{"name": e.key[:90], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in top]})
    return {"device_ms": device_ms if kernels else None,
            "matmul_ms": families.get("matmul", {}).get("device_ms", 0.0),
            "spans": spans_ms}


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
        # a microbenchmark sweep, not a main path: its launches are in its
        # own line, outside the kernel table's counts
        phase_autotune(torch)
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
        paths["baselines"] = phase_baselines(torch, mlp_run, round_s)
        paths["figures"] = phase_figures(torch)
        paths["decentralized"] = phase_decentralized(torch)
        paths["examples"] = phase_examples(torch)
        _free(torch)
        phase_profile(torch, "mlp", _mlp_round(mlp_run["alg"], mlp_run),
                      round_s)
        phase_profile(torch, "scenario_deepfade",
                      _mlp_round(fade_alg, mlp_run), fade_s)
        phase_profile(torch, "chaos", _mlp_round(chaos_alg, mlp_run), chaos_s)
        paths["resume"] = phase_resume(torch, mlp_run)
        paths["telemetry_mlp"] = phase_telemetry_mlp(torch, mlp_run)
        paths["privacy"] = phase_privacy(torch, mlp_run)
        # the MLP paths' tensors go before the LLM round's ~60 GB
        del mlp_run, fade_alg, chaos_alg
        gc.collect()
        torch.cuda.empty_cache()
        paths["accumulate"] = phase_accumulate(torch, name)
        llm_theta: dict = {}
        paths["llm"], llm_round, llm_s, llm_summary = phase_llm(
            torch, "llm", LLM_ARCH, LLM_LAYERS, LLM_SEQ, LLM_LR,
            LLM_LAUNCHES, gate=_keep_theta(llm_theta))
        llm_prof = phase_profile(torch, "llm", llm_round, llm_s)
        # granite's ~50 GB go before the next LLM round's
        del llm_round
        _free(torch)
        paths["save_dots"] = phase_save_dots(torch, llm_summary,
                                             llm_theta.pop("Theta"), llm_prof)
        paths["llm_ssm"], ssm_round, ssm_s, ssm_summary = phase_llm(
            torch, "llm_ssm", SSM_ARCH, SSM_LAYERS, SSM_SEQ, SSM_LR,
            SSM_LAUNCHES)
        phase_profile(torch, "llm_ssm", ssm_round, ssm_s)
        del ssm_round
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(phase_llm_ssm_chunked(torch, ssm_summary))
        paths["llm_hybrid"] = phase_llm_hybrid(torch)
        paths["rec_block"] = phase_rec_block(torch)
        _free(torch)
        paths["chunked_attn"] = phase_chunked_attn(torch)
        paths["scaleup_sampled"] = phase_scaleup_sampled(torch)
        _free(torch)
        paths["llm_chaos"], chaos_round, chaos_llm_s, _ = phase_llm_chaos(
            torch)
        phase_profile(torch, "llm_chaos", chaos_round, chaos_llm_s)
        del chaos_round
        _free(torch)
        paths["llm_cohort"] = phase_llm_cohort(torch)[0]
        _free(torch)
        paths["llm_leafwise"] = phase_llm_leafwise(torch)
        _free(torch)
        paths["telemetry_llm"] = phase_telemetry_llm(torch)
        _free(torch)
        paths["launch"] = phase_launch(torch)
        _free(torch)
        paths["llm_sketched_check"] = phase_llm_sketched_check(torch)
        _free(torch)
        paths["llm_sketched"], sketch_round, sketch_s = phase_llm_sketched(
            torch)
        phase_profile(torch, "llm_sketched", sketch_round, sketch_s)
        del sketch_round
        _free(torch)
        paths["llm_families_check"] = phase_llm_families_check(torch)
        _free(torch)
        paths["llm_moe"], moe_round, moe_s = phase_llm_sketched(
            torch, "llm_moe", MOE_ARCH, MOE_LAYERS)
        phase_profile(torch, "llm_moe", moe_round, moe_s, spans=MOE_SPANS)
        del moe_round
        _free(torch)
        paths["llm_encdec"] = phase_llm_encdec(torch)
        _free(torch)
        paths["serve"] = phase_serve(torch, name)
        _free(torch)
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
