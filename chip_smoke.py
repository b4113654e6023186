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
             round's masked B6 with CSI and B3′ run too, and at each mesh
             rank's block of phases 39 and 40 ((2, 209,721,344), (2,
             318,777,344), (1, 637,554,688)), of phase 52 ((2,
             238,483,744)) and phase 55's sketch (2, 3,563,750); B1, B2
             and B4 on
             the leafwise round's embedding leaf (2, 201,326,592) and at
             the sampled cohort's (256, 32); flash attention B11 — forward,
             dq, dk/dv — at the LLM round's (2, 32, 4096, 128) in bf16 (the
             tensor-core kernels), at a (1, 2) mesh rank's half of its heads
             (2, 16, 4096, 128) and the sketched mode's worker at a time
             (1, 16, 4096, 128), and on a ragged causal and a non-causal
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
             (4, 128, 128), a ragged (3, 1,000, 100), and a (1, 2) mesh
             rank's half of the channels in phases 52, 53, 55 and 56
             ((2, 4,096, 65,536), (8, 64, 65,536), (1, 4,096, 1,280),
             (8, 64, 1,280)), each on the
             planner's plan and again on the other (``thread`` or
             ``staged``, named in the row); the accumulate
             B13 at d = 109,386), in each
             mode a path uses, each CUDA kernel against its plain PyTorch
             version on the same inputs, with its device time (``ms``,
             median of CUDA-event timings behind a GPU spin), its time with
             the host's launch (``ms_with_launch``), the plain version's
             times (medians of ``PLAIN_RUNS`` calls), its bound (bytes
             over the card's memory rate, or operations over the card's
             rate for their type, whichever is larger) and, for B11, SDPA's
             time (``library_ms``).
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
             phase's round time, and the guarded uplink's span, summed
             from kineto's raw events (``_trace``: a trace of up to
             ``TRACE_CHECK_EVENTS`` events is held to ``key_averages``).
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
             (``llm_ssm_f32``, ``llm_ssm_chunked_f32``), round 1's loss
             within 1e-4, and each round of the f32 run again under the
             flag from its state (``llm_ssm_f32_rounds``), every round's
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
             logged, the trace exists, the loss falls, each call wrote
             ``compile_report.json`` (one block traced); then the reference's
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
             8 prompts of 64 tokens, 16 greedy tokens through ``generate``
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

39. llm_mesh_check — after phase 35: the replicated mode on a (data,
             model) = (1, 2) grid of two ranks spawned on the one card
             (gloo, ``launch.mesh``; the kernels built once, before the
             spawn): granite-8b cut to 1 of 36 layers (D = 419,442,688), W
             = 2, one sgd step, noise-free with power control.  The forward
             partitions its products over ``model`` (``models/partition``:
             each rank its 16 of 32 heads, its ff columns and vocab rows,
             the row-split products summed over the ranks), so round 1's
             loss is the two ranks' bit for bit and within 2⁻⁸ relative
             (one bf16 ulp) of the one-device trainer's from the same init
             (the gap recorded); then the shard-local round on the
             trainer's θ, λ and
             h against the one-rank packed round (B6, B3, B4 over the
             gathered (2, d_pad) planes): Θ, λ and α⁻¹ within 1e-6; B6, B3
             and B4 once a round on each rank.  Then the pure-data pin: the
             same 1-layer trainer on (2, 1) (one worker a rank) against one
             device, noise-free, 2 rounds of 2 local steps: every round's
             loss and α⁻¹, Θ, the rank's θ and λ rows within rtol 1e-6, its
             h rows bit-equal (each rank runs the one-device rounds in
             turn, twice, recording whether the two agree bit for bit and,
             where not, each layer's output digest and the cuBLAS settings;
             then the mesh's).  Then, in the same ranks, the
             partitioned forward held tight (``llm_mesh_partition_check``):
             reduced granite-8b and starcoder2-15b in f32 on (1, 2), 3
             rounds of the replicated mode from one device's init and h,
             against one device on the card: each round's loss within rtol
             1e-5 and Θ within atol 1e-5, the ranks' losses bit-equal, B11
             launched on half the heads, and no all-gather over ``model``
             but of the leaves whose products do not partition; then one
             sketched round of each, f32, against one device: the loss
             within rtol 1e-5, Θ_s within atol 1e-6, the Θ shard within
             atol 1e-5.
40. llm_mesh — phase 15's trainer (granite-8b, 2 of 36 layers, W = 2,
             4,096 tokens a worker, 2 rounds) on the (1, 2) grid (each rank
             half of every leaf, its heads, ff columns and vocab rows of
             every product) and the (2, 1) grid (one worker a rank): the
             loss falling, θ and Θ finite, the ranks' losses bit-equal,
             each rank's peak ≤ 40 GB; s/round, tokens/s, each rank's peak,
             the all-reduces' and all-gathers' calls, MB and ms a round,
             the backend and any staged collective.
41. llm_mesh_sketched_check — between phases 39 and 40, in the same
             ranks: the sketched mode on (1, 2) (Θ each rank's model shard,
             the (2, d_s) sketches whole on each), granite-8b cut to 1
             layer, one local step, noise-free, against the parent's
             one-device round (the forward partitioned as in 39): round
             1's loss the two ranks' bit for bit and within 2⁻⁸ relative of
             one device's, each rank's decoded Θ shard within 2⁻⁸ of each
             leaf's largest magnitude of one device's slice, the consensus
             sketch Θ_s the two ranks' bit for bit and within 2⁻⁴ of one
             device's in relative L2, where a control round with rank 1's
             ``wo`` partial products dropped must read past 2⁻⁴ (the
             readings against atol 1e-6 and rtol 1e-5, the bounds before
             the forward was partitioned, recorded; the f32 rounds of 39
             hold Θ_s to one device's at atol 1e-6).
42. llm_mesh_sketched — after phase 40: the sketched mode on (1, 2),
             granite-8b cut to 2 of 36 layers, W = 2, 1 × 4,096 tokens, 2
             sgd steps at 5e-4, ratio 256, 2 rounds (the forward
             partitioned): λ and h (2, d_s), the loss and Θ finite, the
             ranks' losses bit-equal, each rank's peak ≤ 40 GB; s/round,
             tokens/s, the all-reduces', all-gathers' and codec's ms a
             round.
43. llm_mesh_cohort_check — after phase 42: reduced granite-8b in f32 on
             (2, 1), a population of 4 sampling 2 by top-gain, 3 rounds
             against the parent's one-device run: the losses within rtol
             1e-6, Θ and the rank's θ and λ rows within 1e-6 of each
             tensor's largest magnitude.
46. serve_mesh — after phase 43, in the same spawn: partitioned serving
             on (1, 2) (``repro_torch.serve`` on a mesh, the cache's
             "heads" layout): granite-8b at full width cut to 12 of its
             36 layers in bf16, an 8 × 64 prefill and 79 greedy steps fed one
             device's tokens (the parent's run, and the same weights in
             f32): the ranks' tokens and logits bit-equal, the logits no
             further from the f32 run than one device's bf16 logits (RMS
             ratio ≤ 1.1; 2⁻⁶ of the largest logit recorded),
             the tokens equal wherever one device's top-2 margin exceeds
             twice the step's largest |Δ|, B11 12 times a prefill on each
             rank's 16 heads and none in decode, no all-gather over
             ``model`` of a partitioned leaf, each rank's peak ≤ 40 GB;
             then reduced f32 granite-8b in the heads layout, with one KV
             head (the sequence over ``model``) and with a window of 32
             past its wrap: logits and cache within 1e-5 of one device's,
             tokens equal.  Each rank first runs one device's prefill and
             8 steps twice and records whether they agree bit for bit, as
             phase 39's pure-data pin does with its one-device rounds.
47. llm_mesh_moe_check — after phase 42, in the same spawn: the MoE
             family's partitioned training products (``models/partition``:
             each rank its E/m routed experts on the whole routing, its
             heads, MLA's on its ``wq_b``/``wk_b``/``wv_b`` heads, the
             shared expert's and the dense layer's columns, its vocab rows)
             on reduced qwen3-moe and deepseek-v3 (q-LoRA, the shared
             expert, a dense first layer, MTP) in f32 on (1, 2), 3
             replicated rounds from one device's init and h against the
             parent's one-device rounds: each round's loss within rtol
             1e-5, Θ within atol 1e-5, the ranks' losses bit-equal, 0
             differing expert picks or kept pairs, B11 on half the heads,
             B6, B3 and B4 once a round a rank, no all-gather over
             ``model`` but of the leaves whose products stay whole.
48. llm_mesh_moe — after phase 47: qwen3-moe-30b-a3b at full width cut
             48 -> 2 layers (D = 1,557,407,744, d_s = 6,083,624), sketched
             on (1, 2) (64 experts, 16 heads, 2 KV heads, half the vocab a
             rank), W = 2, 1 × 4,096 tokens, 2 sgd steps, 2 rounds: λ and h
             (2, d_s), loss and Θ finite, the ranks' losses and picks
             bit-equal, B11 16/8/8 on 16 heads and B6, B3, B4 once a
             round, no expert leaf gathered, ≤ 40 GB a rank; s/round
             (round 2), tokens/s, the peaks, the collectives,
             the codec's ms, the dropped share, and the ``moe_dispatch``/
             ``moe_combine`` device ms of one more profiled round.  Its
             kernel rows: B6, B3 and B4 at (2, 6,083,624).
49. serve_mesh_moe — after phase 46, in the same spawn: the MoE family's
             partitioned serving on (1, 2): qwen3-moe-30b-a3b at full width
             cut 48 -> 8 layers, bf16 (each rank 64 experts, 16 heads, 2
             KV heads, the cache's "heads" layout, half the vocabulary),
             phase 46's 8 × 64 prefill and 79 greedy steps fed one
             device's tokens: the ranks' tokens, logits and expert picks
             bit-equal, the logits no further from the same weights in f32
             than one device's bf16 logits (RMS ratio ≤ 1.1), B11 8 times
             a prefill on each rank's 16 heads and none in decode, the
             prefill's only parameter all-gathers the routers', none in
             decode (the router's columns on the rank, its one-token
             logits gathered), each rank's peak ≤ 40 GB; prefill ms, a
             step's wall and device ms, the collectives, the dropped share.
50. serve_mesh_moe_check — after phase 49: reduced qwen3-moe (the KV
             heads; one KV head on the sequence) and deepseek-v3 (MLA's
             latent cache on the sequence; with and without q-LoRA, the
             shared expert, a dense first layer, MTP never gathered) in
             f32 on (1, 2) against the parent's one-device runs: logits
             and cache within 1e-5 of one device's, tokens equal, 0
             differing expert picks or kept pairs, the prefill's parameter
             all-gathers only the router's, ``wq_a``'s and ``wkv_a``'s,
             none in decode.
51–53. llm_mesh_ssm_check, llm_mesh_ssm, serve_mesh_ssm — after phase
             50, in the same spawn: the SSM family on its inner channels
             (``models/partition``, ``Partition.inner``): reduced
             falcon-mamba in f32 on (1, 2), 3 rounds each from one
             device's state (loss rtol 1e-5, Θ atol 1e-5, the ranks'
             losses bit-equal, B12 on the rank's channels, B6, B3 and B4
             once a round); falcon-mamba-7b at full width cut to 2 layers,
             2 replicated rounds (loss falls, ≤ 40 GB a rank); served at
             8 layers as phase 46 serves granite-8b (the state and conv
             window on the rank's channels), and a reduced f32 check.
54–56. llm_mesh_hybrid_check, llm_mesh_hybrid, serve_mesh_hybrid — after
             phase 53, the same three on the hybrid family's RG-LRU
             channels (``Partition.lru``): reduced recurrentgemma-2b at 5
             layers (a super-block and the tail list) in f32;
             recurrentgemma-2b at full width cut to 3 layers (rec, rec,
             attn), 2 rounds in the sketched mode (replicated, two ranks'
             blocks of λ, h and θ do not fit the card); served at 8
             layers (the state and
             conv window on the rank's channels, the attention's 2,048-slot
             window on its 1,024 slots), no parameter all-gathered, B12 × 6
             a prefill on (8, 64, 1,280), and the reduced check run 67
             steps, past its 64-slot window's wrap.
57–59. llm_mesh_encdec_check, llm_mesh_encdec, serve_mesh_encdec — after
             phase 56, the same three on the audio enc-dec's heads
             (``models/encdec.py``: each rank's heads of the encoder's
             and the decoder's attention, its ff columns, its vocab rows):
             reduced seamless-m4t-medium (2 + 2 layers) in f32, 3 rounds
             each from one device's state, B11 on the rank's 2 heads;
             seamless at full width cut to 4 + 4 layers, ``llm_encdec``'s
             W = 2 × 2 × 1,024 tokens over 1,024 stub frames, 2
             replicated rounds (loss falls, ≤ 40 GB a rank), B11 16/8/8 a
             round on (4, 8, 1,024, 64); served at full width and depth
             (12 + 12) over 1,024 stub frames a prompt, the cross cache
             from ``prefill_cross`` on the rank's KV heads, B11 × 12 a
             prefill on (8, 8, 64, 64), none in decode, no parameter
             all-gathered but ``fc_out``'s bias (split on its layer dim),
             and reduced f32 checks in both cache layouts (4 KV heads;
             one KV head, the self cache on its slots and the cross cache
             on its frames).
44. dryrun — last: the dry run's trace on ``meta`` (no kernel) against
             the card: phases 40's and 42's rounds traced on a fake-rank
             mesh count each rank's collectives (calls and bytes by op)
             exactly; phase 27's ``compile_report.json`` holds the trace's
             flops; phase 15's predicted peak within [0.9, 1.15] of its
             measured one and its temporaries (the peak less the state)
             within [0.9, 1.25], its predicted compute and memory terms beside
             its device time; the time to trace granite-8b train_4k on
             the 16 × 16 production mesh at full size.
45. microbench — after phase 30: the twin of
             ``benchmarks/kernels_microbench.py``
             (``repro_torch.benchmarks.kernels_microbench``) through its
             ``main`` with ``REPRO_BENCH_DEVICE=gpu``: the kernel, transport
             and packed sections, then every section flag (the shard-local
             section's two ranks and the sketched section's four spawned on
             the one card), its JSON files in a temporary directory; the
             launch and uplink-entry counts the reference reads, 0.0 where
             it says bit for bit, B9 within 1e-6 and B11's gradients within
             1e-5 of their plain versions (gates); the times recorded.

Launch counts are reset just before each of phases 4–12, 14–43, 45–59
and read just after (in each rank for phases 39–43 and 46–59, summed over
the ranks;
phase 45's spawned ranks count in their own sections).  Then
come the kernel table as one JSON line, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  Without a card, or run from a
directory that lacks ``src/repro_torch``, it exits non-zero before printing
a result.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
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
    from repro_torch.benchmarks.common import time_ms
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
             "unsplit_ms": time_ms(lambda: ota.ota_receive(
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


#: the plain versions' times in the kernel table: the median of this many
#: calls after one warm-up (a kernel's own times take ``TIMED_RUNS``); at
#: the paths' shapes a plain call takes up to 0.3 s, and 25 of them made
#: most of the kernel phase's time
PLAIN_RUNS = 5


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
    from repro_torch.benchmarks.common import time_ms

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
    kernel_ms = time_ms(kernel)
    if plain_times is None:
        plain_times = (time_ms(plain, runs=PLAIN_RUNS, warmup=1),
                       time_ms(plain, runs=PLAIN_RUNS, warmup=1, spin=False))
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
           "ms_with_launch": time_ms(kernel, spin=False),
           "plain_ms_with_launch": plain_ms_with_launch,
           "bytes": nbytes, "flops": flops, "op_rate": op_rate,
           "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
           "library_ms": None if library is None
           else time_ms(library), "shape": shape, **extra}
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
    (``llm_encdec``); then each mesh rank's block (:func:`_mesh_round_shapes`:
    ``llm_mesh_check``, ``llm_mesh``)."""
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
                                                  ENCDEC_LAYERS)))] + \
        _mesh_round_shapes()


def _mesh_round_shapes():
    """Each mesh rank's (W_local, d_local) block of the round: in
    ``llm_mesh_check`` (1 layer on the first grid) and ``llm_mesh`` (2
    layers on each grid), then the pure-data pin's (1 layer on (2, 1)),
    the sketched phases' (W, d_s) sketches (1 and 2 layers), the cohort
    check's (reduced granite-8b on (2, 1)), ``llm_mesh_moe``'s (W, d_s)
    sketches (qwen3-moe, 2 layers), ``llm_mesh_ssm``'s block
    (falcon-mamba-7b, 2 layers, on the first grid), ``llm_mesh_hybrid``'s
    (W, d_s) sketch (recurrentgemma-2b, 3 layers) and ``llm_mesh_encdec``'s
    block (seamless-m4t-medium, 4 + 4 layers, on the first grid: its
    layernorms split evenly too).  granite-8b's and
    falcon-mamba-7b's replicated segments (their norms, conv, ``A_log``,
    ``D``) split evenly, so d_local is D over the model axis with no
    padding (the phases gate that)."""
    import dataclasses

    from repro_torch.models import get_config
    from repro_torch.models.registry import packed_param_count
    from repro_torch.train.llm_trainer import _sketch_dim

    d1 = packed_param_count(_llm_cfg(LLM_ARCH, ROBUST_LAYERS))
    d2 = packed_param_count(_llm_cfg(LLM_ARCH, LLM_LAYERS))
    (data, model), = MESH_SHAPES[:1]
    pin_data = MESH_PIN_SHAPE[0]
    d_red = packed_param_count(dataclasses.replace(
        get_config(LLM_ARCH).reduced(), param_dtype="float32"))
    return [(LLM_WORKERS // data, d1 // model)] + [
        (LLM_WORKERS // data, d2 // model) for data, model in MESH_SHAPES] + [
        (LLM_WORKERS // pin_data, d1)] + [
        (LLM_WORKERS, _sketch_dim(d, SKETCH_RATIO)) for d in (
            d1, packed_param_count(_llm_cfg(LLM_ARCH, MESH_SKETCH_LAYERS)))
    ] + [(MESH_COHORT["cohort"] // pin_data, d_red),
         (LLM_WORKERS, _sketch_dim(packed_param_count(
             _llm_cfg(MOE_ARCH, MESH_MOE_LAYERS)), SKETCH_RATIO)),
         (LLM_WORKERS // data, packed_param_count(
             _llm_cfg(SSM_ARCH, MESH_SSM_LAYERS)) // model),
         (LLM_WORKERS, _sketch_dim(packed_param_count(
             _llm_cfg(HYBRID_ARCH, MESH_HYBRID_LAYERS)), SKETCH_RATIO)),
         (LLM_WORKERS // data, packed_param_count(
             _encdec_cfg(MESH_ENCDEC_LAYERS)) // model)]


def _llm_round_rows(torch, build, mem_rate, f32_rate, W: int, d: int):
    """The OTA kernels of an LLM round at its (W, D): B6 and B4 on the same
    five (W, D) planes (25.5 GB at granite's) and Θ, then B3 on three (D,)
    vectors; each set is freed when its rows are done."""
    from repro_torch import rng
    from repro_torch.benchmarks.common import time_ms
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
         "row_plan_ms": time_ms(lambda: ota_round.ota_round_stats(
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
               # a (1, 2) mesh rank's heads: the partitioned forward runs
               # 16 of granite-8b's 32 heads, on the replicated mode's two
               # workers and on the sketched mode's one at a time
               ("[bf16 model rank (2, 16, 4096, 128)]", 2, 16, 4096, 128,
                "bfloat16", True),
               ("[bf16 sketched model rank (1, 16, 4096, 128)]", 1, 16,
                4096, 128, "bfloat16", True),
               ("[bf16 enc-dec decoder (4, 16, 1024, 64)]", 4, 16, 1024, 64,
                "bfloat16", True),
               ("[bf16 vlm prefill (8, 32, 320, 128)]", 8, 32, 320, 128,
                "bfloat16", True),
               ("[bf16 enc-dec prefill (8, 16, 64, 64)]", 8, 16, 64, 64,
                "bfloat16", True),
               # a (1, 2) mesh rank's prefill (``serve_mesh``): 16 of
               # granite-8b's 32 heads over the 8 × 64 prompt
               ("[bf16 model-rank prefill (8, 16, 64, 128)]", 8, 16, 64, 128,
                "bfloat16", True),
               # a (1, 2) mesh rank of the enc-dec: 8 of seamless's 16
               # decoder heads in training (``llm_mesh_encdec``: W·B = 4 ×
               # 1,024) and in the prefill (``serve_mesh_encdec``: 8 × 64)
               ("[bf16 enc-dec model rank (4, 8, 1024, 64)]", 4, 8, 1024, 64,
                "bfloat16", True),
               ("[bf16 enc-dec model-rank prefill (8, 8, 64, 64)]", 8, 8, 64,
                64, "bfloat16", True))
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
    ``llm_hybrid`` path's reduced ones, a ragged case, the serving
    prefills', and a (1, 2) mesh rank's half of the SSM's channels in
    ``llm_mesh_ssm`` and in ``serve_mesh_ssm``'s prefill, and of the
    hybrid's RG-LRU channels in ``llm_mesh_hybrid`` (its sketched mode's
    worker at a time) and in ``serve_mesh_hybrid``'s prefill."""
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
             full.lru_width),
            ("[mesh ssm rank ({}, {}, {})]", LLM_WORKERS, SSM_SEQ,
             ssm_cfg.d_inner // MESH_RANKS * ssm_cfg.ssm_state),
            ("[mesh ssm prefill rank ({}, {}, {})]", SERVE_MESH_B,
             SERVE_MESH_P, ssm_cfg.d_inner // MESH_RANKS * ssm_cfg.ssm_state),
            ("[mesh hybrid rank ({}, {}, {})]", 1, LLM_SEQ,
             full.lru_width // MESH_RANKS),
            ("[mesh hybrid prefill rank ({}, {}, {})]", SERVE_MESH_B,
             SERVE_MESH_P, full.lru_width // MESH_RANKS)]


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
    from repro_torch.benchmarks.common import time_ms
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
    recv_ms = time_ms(lambda: ota.ota_receive(*planes, z, ia))
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
    from repro_torch.benchmarks.common import time_ms
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
        fused_ms = time_ms(fused)
        composed_ms = time_ms(composed)
        rows.append({"variant": label, "launches": launches,
                     "theta_max_abs_err": t_abs, "theta_err_over_tol": t_ratio,
                     "inv_alpha_rel_err": ia_rel, "h_air_max_abs_err": h_abs,
                     "fused_ms": fused_ms, "composed_ms": composed_ms,
                     "composed_over_fused": composed_ms / fused_ms,
                     "fused_ms_with_launch": time_ms(fused,
                                                     spin=False),
                     "composed_ms_with_launch": time_ms(composed,
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
    from repro_torch.benchmarks.common import time_ms
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
    acc_ms = time_ms(accumulated)
    recv_ms = time_ms(lambda: transport.receive(s, h, noise, ia))
    emit({"phase": "accumulate", "ok": True, "W": W, "d": d,
          "theta_max_abs_err": t_abs, "theta_err_over_tol": t_ratio,
          "rtol": 1e-5, "atol": 1e-6,
          "accumulated_ms": acc_ms, "stacked_receive_ms": recv_ms,
          "accumulated_ms_with_launch": time_ms(accumulated,
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
#: pair's first round, and the f32 pair's (the same runs with f32
#: parameters, where the steps are far above the rounding) to a tighter
#: bound, with every later f32 round held from one shared state
#: (:func:`phase_llm_ssm_f32_rounds`).  Along their own trajectories the
#: f32 runs fork too, by how much turns on the draw of h: Θ divides the
#: noise by Σ|h|², which the smallest pilots of a (2, D) draw make huge,
#: so a 1-ulp gap in round 1 grows by 6–90× a round.  On an H100 round 3
#: read 1.4e-5 with the trainer's earlier whole-plane draw of h and 3.3e-4
#: with its per-row one; across three keys of each rule, 1.2e-5 – 3.3e-4
#: (``tools/sweep_ssm_pair.py``, NVIDIA H100 80GB HBM3, 700 W)
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
    parameters), round 1's loss held (``SSM_CHUNKED_F32_LOSS_RTOL``), the
    later rounds' recorded, and every round held from a shared state
    (``llm_ssm_f32_rounds``).  Returns each run's launches by phase."""
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
            loss_rounds=SSM_CHUNKED_BF16_ROUNDS,
            loss_rtol=SSM_CHUNKED_F32_LOSS_RTOL, dtype="float32")
    _free(torch)
    paths["llm_ssm_f32_rounds"] = phase_llm_ssm_f32_rounds(torch)
    _free(torch)
    return paths


def phase_llm_ssm_f32_rounds(torch):
    """The f32 pair held round by round: each round of the unchunked f32
    run (``llm_ssm_f32``'s trainer, state and keys) is also run under
    ``REPRO_OPT=chunked_scan`` from the same state and key, and its loss
    is held to the unchunked round's within ``SSM_CHUNKED_F32_LOSS_RTOL``:
    the chunked scan's rounds, free of the fork the two runs' own
    trajectories take.  Launches: one round of each a round."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    cfg = dataclasses.replace(_llm_cfg(SSM_ARCH, SSM_LAYERS),
                              param_dtype="float32")
    W = LLM_WORKERS
    init_fn, step = make_fl_train(
        build_model(cfg), FLConfig(mode="replicated", n_workers=W,
                                   local_steps=2, local_lr=SSM_LR,
                                   local_optimizer="sgd"),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=W, snr_db=40.0, coherence_iters=10))
    state = init_fn(SEED)
    batch = {"tokens": token_dataset(SEED + 1, 1, SSM_SEQ, cfg.vocab_size,
                                     n_workers=W)}
    build.reset_launches()
    plain, chunked = [], []
    for r in range(LLM_ROUNDS):
        key = rng.fold_in(SEED, r + 1)
        with _chunked_scan():
            _, m = step(state, batch, key=key)
        chunked.append(float(m["loss"]))
        del m
        _free(torch)
        held = [state]
        state = None
        state, m = step(held.pop(), batch, key=key)
        plain.append(float(m["loss"]))
        del m
    launches = dict(build.launches)
    del state
    rel = [abs(a - b) / abs(b) for a, b in zip(chunked, plain)]
    _per_round(launches, LLM_ROUNDS, {
        k: SSM_LAUNCHES.get(k, 0) + SSM_CHUNKED_LAUNCHES.get(k, 0)
        for k in SSM_CHUNKED_LAUNCHES})
    require(max(rel) <= SSM_CHUNKED_F32_LOSS_RTOL, f"llm_ssm_f32_rounds: "
            f"chunked losses {chunked} against {plain} from the same "
            f"states: relative {rel} > {SSM_CHUNKED_F32_LOSS_RTOL}")
    emit({"phase": "llm_ssm_f32_rounds", "ok": True, "arch": cfg.name,
          "reduced": {"n_layers": f"64 -> {SSM_LAYERS}"}, "dtype": "float32",
          "rounds": LLM_ROUNDS, "loss": plain, "chunked_loss": chunked,
          "loss_rel_diff": rel, "loss_rtol": SSM_CHUNKED_F32_LOSS_RTOL,
          "launches": launches})
    return launches


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
    from repro_torch.benchmarks.common import time_ms
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
            times[plan].append(time_ms(lambda: run(plan), runs=1,
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
    calls, launches, report = [], {}, None
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
                rep_path = os.path.join(rd, "compile_report.json")
                require(os.path.isfile(rep_path), f"launch: call {i} wrote "
                        f"no compile_report.json: {out[-2000:]}")
                if report is None:
                    with open(rep_path) as f:
                        report = json.load(f)
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
          "compile_report": report, "launches": launches})
    return launches, report


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
    from repro_torch.benchmarks.common import time_ms
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
            stats[path]["fwd_ms"] = time_ms(fwd, runs=ATTN_RUNS,
                                            warmup=1)
            stats[path]["fwd_bwd_ms"] = time_ms(fwd_bwd,
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


#: the twin of ``benchmarks/kernels_microbench.py`` in two calls of its
#: ``main``: the kernel, transport and packed sections, then every flagged
#: section (files into a temporary directory, their ``BENCH_torch_`` names)
MICROBENCH_UNFLAGGED = ("transport", "packed")
MICROBENCH_FLAGGED = ("attn_bwd", "phy", "fused_round", "faults",
                      "shard_local", "sketched", "obs", "scaleup", "device")


def phase_microbench(torch):
    """``repro_torch.benchmarks.kernels_microbench.main`` in process with
    ``REPRO_BENCH_DEVICE=gpu``: ``--out``/``--out-packed``, then every
    section flag (the two mesh sections spawn their ranks, two and four, on
    the one card).  Gates, each contract the reference's docstrings state:
    the launch and uplink-entry counts the reference reads (B11 1 forward
    and 2 backward; B9 1; 1 packed, 6 and 11 per-leaf entries; 1 entry a
    shard on the (1, 2) and the (1, 2, 2) grids; d_local 196,928; W = 256
    streamed in cohorts of 32 over 4,194,304 of 33,554,432 signal-plane
    elements; 300 loop against 30 block dispatches; one B10 a freq-flat
    mobile scenario step); 0.0 where it says bit for bit (the guard on a
    healthy slot, telemetry on against off, shard-local against leafwise,
    loop against scan histories); B9 within 1e-6 and B11's gradients
    within 1e-5 of their plain versions; the sink's JSONL valid, the chaos
    run's evals and the sketched loss finite; the device lane run.  Times
    and ``inv_alpha_equal`` are recorded.  The spawned ranks' launches stay
    in their ranks: the phase's count is the parent's."""
    import io
    import tempfile

    from repro_torch.benchmarks import kernels_microbench as km
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mb_") as d, \
            _opt_env(REPRO_BENCH_DEVICE="gpu"):
        def out(name):
            return os.path.join(d, f"BENCH_torch_{name}.json")

        flagged = []
        for name in MICROBENCH_FLAGGED:
            opt = "device-bench" if name == "device" \
                else name.replace("_", "-")
            flagged += [f"--{opt}", f"--out-{opt}", out(name)]
        build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = (km.main(["--out", out("transport"), "--out-packed",
                           out("packed")]), km.main(flagged))
        torch.cuda.synchronize()
        launches = dict(build.launches)
        require(rc == (0, 0), f"microbench: main exited {rc}")
        # a skipped device lane writes no file
        res = {"device": {"skipped": True}}
        for name in MICROBENCH_UNFLAGGED + MICROBENCH_FLAGGED:
            if os.path.exists(out(name)):
                with open(out(name)) as f:
                    res[name] = json.load(f)
    seconds = time.perf_counter() - t0

    kern, tr = res["transport"]["kernels"], res["transport"]["transport"]
    trainer = tr["trainer_linreg_300r"]
    attn, phy, fr = res["attn_bwd"], res["phy"], res["fused_round"]
    sl, sk = res["shard_local"], res["sketched"]
    packed = res["packed"]
    want = {
        "attn_bwd fwd/bwd dispatches": ((attn["fwd_dispatches"],
                                         attn["bwd_dispatches"]), (1, 2)),
        "phy channel-step dispatches": (
            phy["channel_step_dispatches_per_round"], 1),
        "packed entries (mlp, granite)": (
            tuple(packed[k][f"{p}_uplink_entries_per_round"]
                  for k in ("uplink_mlp_tree", "uplink_transformer_tree")
                  for p in ("packed", "per_leaf")), (1, 6, 1, 11)),
        "fused_round entries": (fr["fused_uplink_entries_per_round"], 1),
        "w256 streamed": (tuple(fr["w256_streamed"][k] for k in (
            "W", "worker_chunk", "peak_signal_plane_elems",
            "monolithic_signal_plane_elems")), (256, 32, 4_194_304,
                                                33_554_432)),
        "shard_local entries, d_local": (
            (sl["uplink_entries_per_shard_per_round"], sl["d_local"]),
            (1, 196_928)),
        "sketched entries": (sk["uplink_entries_per_shard_per_round"], 1),
        "loop/scan dispatches": (
            (trainer["compiled_dispatch"]["loop_n_dispatches"],
             trainer["compiled_dispatch"]["scan_n_dispatches"]), (300, 30)),
        "scaleup scenario-step dispatches": (
            res["scaleup"]["scenario_step_kernel_dispatches"], 1),
        "bit for bit (guard, telemetry, shard-local θ and λ)": (
            (res["faults"]["healthy_max_abs_err_vs_unguarded"],
             res["obs"]["telemetry_max_abs_err"],
             sl["noise_free_max_abs_err_vs_leafwise"],
             sl["noise_free_lam_max_abs_err_vs_leafwise"]),
            (0.0, 0.0, 0.0, 0.0)),
        "loop and scan histories equal": (trainer["history_bitwise_equal"],
                                          True),
        "sink valid, chaos finite, sketched loss finite": (
            (res["obs"]["sink_jsonl_valid"],
             res["faults"]["chaos"]["all_evals_finite"], sk["loss_finite"]),
            (True, True, True)),
        "device lane ran": (res["device"]["skipped"], False),
    }
    bad = {k: got for k, (got, w) in want.items() if got != w}
    require(not bad, f"microbench: {bad}")
    require(phy["channel_step_max_err_vs_plain"] <= 1e-6,
            f"microbench: B9 is {phy['channel_step_max_err_vs_plain']} from "
            f"its plain version")
    attn_err = max(attn[f"max_abs_err_d{n}"] for n in "qkv")
    require(attn_err <= 1e-5, f"microbench: B11's gradients are {attn_err} "
            f"from the plain attention's")
    emit({"phase": "microbench", "ok": True, "seconds": seconds,
          "sections": res, "launches": launches})
    return launches


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
    from repro_torch.benchmarks.common import time_ms
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

    return {"encode_ms": time_ms(encode, runs=3, warmup=1),
            "decode_ms": time_ms(decode, runs=3, warmup=1)}


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
#: a batch of 8 prompts of 64 tokens, 16 greedy tokens through ``generate``
#: (the prompt ingested through decode), and ``make_prefill`` on the same
#: prompts (the vlm's after 256 stub patches each, the enc-dec's over 1,024
#: stub frames each), whose launches are B11 a causal attention layer
#: (granite-8b's 36, qwen3-moe's 48, pixtral's 40, seamless's 12 decoder
#: layers; none for deepseek-v3's MLA) and B12 a recurrent layer (all 64 of
#: falcon-mamba-7b; 18 of recurrentgemma-2b's 26, its windowed attention
#: taking the masked path)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 64, 16
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
    from repro_torch.benchmarks.common import time_ms
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
        prefill_ms = time_ms(lambda: prefill(params, batch), runs=5,
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


# ---------------------------------------------------------------------------
# slice 15: the replicated mode on a (data, model) grid of two ranks that
# share the card (gloo)
# ---------------------------------------------------------------------------

#: ranks of the mesh phases: both on the one card, so gloo (NCCL refuses
#: two ranks on one device)
MESH_RANKS = 2
#: the mesh phases' grids: the shard grid of 2 model shards, then one
#: worker a rank (the paper's one device a worker)
MESH_SHAPES = ((1, 2), (2, 1))
#: a rank's peak in ``llm_mesh`` (bytes): both ranks share the 80 GB
MESH_PEAK = 40e9
#: seconds the parent waits for its ranks before killing them, and a
#: collective's wait inside them
MESH_TIMEOUT = 600
#: collectives the mesh stages through the host itself: none, gloo takes
#: all-reduce and all-gather on CUDA tensors (``launch/mesh.py``)
STAGED_COLLECTIVES: list = []
#: B6, B3 and B4 once a round on each rank; B11 as in phase ``llm``
MESH_ROUND_LAUNCHES = {"ota_round_stats": 1, "ota_demodulate_dyn": 1,
                       "admm_dual_update": 1, "ota_modulate": 0,
                       "ota_receive": 0, "ota_round_theta": 0}


def _mesh_trainer(torch, cfg, mesh, noisy: bool, local_steps: int = 2,
                  device="cuda"):
    """The replicated trainer of phase ``llm`` (W = 2, ``local_steps`` sgd
    steps at ``LLM_LR``) on ``cfg``, on ``mesh`` (None: one device) and
    ``device`` (``meta``: phase ``dryrun``'s trace)."""
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    acfg = AdmmConfig(rho=0.5, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=LLM_WORKERS, snr_db=40.0,
                         coherence_iters=10, noisy=noisy)
    init_fn, step = make_fl_train(
        build_model(cfg), FLConfig(n_workers=LLM_WORKERS,
                                   local_steps=local_steps, local_lr=LLM_LR),
        acfg, ccfg, mesh=mesh, device=device)
    return init_fn, step, acfg, ccfg


def _mesh_batch(torch, cfg, rows=slice(None)):
    from repro_torch.data.synthetic import token_dataset

    return {"tokens": token_dataset(SEED + 1, 1, LLM_SEQ, cfg.vocab_size,
                                    n_workers=LLM_WORKERS)[rows]}


#: ``llm_mesh_check``'s local steps: with one, round 1's loss is the
#: forward's on the init alone (a second step's loss also reads h through
#: the penalty, and the mesh draws its blocks of h from keys of its own)
MESH_CHECK_STEPS = 1
#: a (1, 2) round-1 loss against one device's: the partitioned forward
#: (``models/partition``) sums each row-split product's two partial
#: products in bf16, regrouping its accumulation as the reference's
#: partitioned program does, so the loss is held to one bf16 ulp relative
#: (2⁻⁸) of one device's, and the two ranks' losses (the same psums) to
#: each other bit for bit
MESH_LOSS_RTOL = 2.0 ** -8


def _mesh_check_reference(torch) -> float:
    """Round 1's loss of the one-device trainer of ``llm_mesh_check``."""
    from repro_torch import rng

    cfg = _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    init_fn, step, _, _ = _mesh_trainer(torch, cfg, None, noisy=False,
                                        local_steps=MESH_CHECK_STEPS)
    return float(step(init_fn(SEED), _mesh_batch(torch, cfg),
                      key=rng.fold_in(SEED, 1))[1]["loss"])


def _mesh_stats(mesh, rounds: int) -> dict:
    """The mesh's collectives a round: calls, ms and MB."""
    return {op: {"calls_per_round": s["calls"] / rounds,
                 "ms_per_round": 1e3 * s["seconds"] / rounds,
                 "mb_per_round": s["bytes"] / rounds / 1e6}
            for op, s in sorted(mesh.stats.items())}


def _mesh_check_rank(torch, mesh, loss_ref: float) -> dict:
    """``llm_mesh_check`` on one rank: one trainer round of granite-8b cut
    to 1 layer on the (1, 2) grid, noise-free with power control; then the
    shard-local round alone on the trainer's θ (after its local steps), λ
    and h, and rank 0 runs the one-rank packed round (B6, B3, B4 over the
    gathered (W, d_pad) planes) on the same inputs and holds the mesh's Θ,
    λ and α⁻¹ to it."""
    from repro_torch import rng
    from repro_torch.core import cplx, transport
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import pack_shard_local
    from repro_torch.core.tree_ota import (ota_tree_round_shard_local,
                                          shard_coords)
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    cfg = _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    init_fn, step, acfg, ccfg = _mesh_trainer(torch, cfg, mesh, noisy=False,
                                              local_steps=MESH_CHECK_STEPS)
    state = init_fn(SEED)
    sspec = init_fn.layout["sspec"]
    c = shard_coords(mesh, sspec)
    batch = _mesh_batch(torch, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    t0 = time.perf_counter()
    new, m = step(state, batch, key=rng.fold_in(SEED, 1))
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = dict(build.launches)
    stats = _mesh_stats(mesh, 1)
    peak = torch.cuda.max_memory_allocated()
    loss = float(m["loss"])
    theta, lam, h = new.theta, state.lam, state.chan.h
    del new, m, state, step, init_fn
    T_mesh, lam_mesh, mr = ota_tree_round_shard_local(
        theta, lam, h, torch.zeros(sspec.d_local, device=dev), acfg, ccfg,
        sspec, mesh)
    ia_mesh = float(mr["inv_alpha"])
    Th_mesh = pack_shard_local(sspec, T_mesh, c.j)
    del lam, T_mesh, mr
    _free(torch)
    rank0 = c.j == 0

    def full(x):
        """The (…, d_pad) plane from every rank's (…, d_local) block, kept
        on rank 0 only."""
        out = mesh.all_gather(x, c.saxes, x.dim() - 1)
        return out if rank0 else None

    theta_p = full(pack_shard_local(sspec, theta, c.j))
    h_full = Complex(full(h.re), full(h.im))
    del theta, h
    out = {"loss": loss, "loss_ref": loss_ref, "round_s": round_s,
           "launches": launches, "collectives": stats, "peak": peak,
           "d_pad": sspec.d_pad, "d_local": sspec.d_local, "D": sspec.spec.d}
    if rank0:
        W = theta_p.shape[0]
        lam0 = cplx.czero((W, sspec.d_pad), device=dev)
        Th_ref, ia_ref, _ = transport.ota_round_fused(
            theta_p, lam0, h_full, torch.zeros(sspec.d_pad, device=dev),
            acfg.rho, ccfg, power_control=True)
        lam_ref = transport.dual_update(lam0, h_full, theta_p, Th_ref,
                                        acfg.rho)
        del lam0, theta_p, h_full
        _free(torch)
        out.update(inv_alpha_mesh=ia_mesh, inv_alpha_ref=float(ia_ref))
    Th = full(Th_mesh)
    if rank0:
        out["theta_err"] = _max_err([Th], [Th_ref], LEAFWISE_RTOL, 0.0)
        out["theta_bits_equal"] = bool(torch.equal(Th, Th_ref))
        del Th, Th_ref
    for part in ("re", "im"):
        x = full(getattr(lam_mesh, part))
        if rank0:
            ref = getattr(lam_ref, part)
            out[f"lam_{part}_err"] = _max_err([x], [ref], LEAFWISE_RTOL, 0.0)
            out[f"lam_{part}_bits_equal"] = bool(torch.equal(x, ref))
        del x
    mesh.timing = False
    return out


#: ``llm_mesh_partition_check``: the partitioned products held tight on the
#: card.  Reduced granite-8b (GQA, swiglu) and starcoder2-15b (gelu, the
#: biases, ``fc_out``'s gathered on its layer dim) in f32 on (1, 2), W = 2,
#: 2 sgd steps at 1e-2, noise-free, 3 rounds, from the one-device init and
#: the one-device h carried into the rank's block (so the rounds read the
#: same channel), against the one-device trainer on the card:
#: ``llm_hybrid``'s bars (each round's loss rtol 1e-5, Θ atol 1e-5).  Then
#: one sketched round of each on (1, 2) (1 sgd step, 4,096 tokens a worker,
#: ratio 256) against one device's: Θ_s at ``llm_mesh_sketched_check``'s
#: bound from before the forward was partitioned (atol 1e-6: in f32 an
#: update is far above the rounding, so the grid's codec is held tight on
#: the partitioned forward's gradients), the loss rtol 1e-5 and the Θ shard
#: atol 1e-5 (``test_sketched_round_matches_jax``'s bars: Θ sums the init
#: and the decode, an f32 ulp apart from one device's near zero)
MESH_PART_ARCHS = ("granite-8b", "starcoder2-15b")
MESH_PART_ROUNDS = 3
MESH_PART_LOSS_RTOL = HYBRID_LOSS_RTOL
MESH_PART_THETA_ATOL = HYBRID_THETA_ATOL


def _mesh_part_trainer(torch, cfg, mesh):
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    return make_fl_train(
        build_model(cfg), FLConfig(n_workers=LLM_WORKERS, local_steps=2,
                                   local_lr=1e-2),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=LLM_WORKERS, snr_db=40.0,
                      coherence_iters=10, noisy=False), mesh=mesh)


def _mesh_partition_rank(torch, mesh) -> dict:
    """``llm_mesh_partition_check`` on one rank: for each of
    ``MESH_PART_ARCHS``, the one-device rounds, then the same rounds on
    ``mesh`` from its init with the one-device h in the rank's block; the
    losses and the rank's Θ block against one device's, B11's head counts
    on the mesh, and the all-gathers over ``model`` against the leaves the
    plan still gathers (each whole, once a forward)."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import (build_packspec, pack_shard_global,
                                          shard_tree, unpack)
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.models import get_config
    from repro_torch.models.partition import gathered_model_leaf
    from repro_torch.tree import tree_leaves, tree_paths

    out = {}
    j = mesh.axis_index("model")
    for arch in MESH_PART_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  param_dtype="float32")
        batch = {"tokens": token_dataset(SEED + 5, SKETCH_CHECK_B,
                                         SKETCH_CHECK_S, cfg.vocab_size,
                                         n_workers=LLM_WORKERS)}
        init1, step1 = _mesh_part_trainer(torch, cfg, None)
        st1 = init1(SEED)
        init_m, step_m = _mesh_part_trainer(torch, cfg, mesh)
        stm = init_m(SEED)
        lay = init_m.layout
        sspec, plan = lay["sspec"], lay["plan"]
        spec1 = build_packspec(st1.theta, batch_dims=1)
        dl = sspec.d_local
        h = Complex(*(pack_shard_global(sspec, unpack(spec1, z, cast=False))
                      [:, j * dl:(j + 1) * dl].contiguous()
                      for z in (st1.chan.h.re, st1.chan.h.im)))
        stm = stm._replace(chan=stm.chan._replace(h=h))
        losses1 = []
        for r in range(MESH_PART_ROUNDS):
            st1, m = step1(st1, batch, key=rng.fold_in(SEED, r + 1))
            losses1.append(float(m["loss"]))
        heads = []
        mesh.reset_stats()
        losses = []
        with _b11_heads(heads):
            for r in range(MESH_PART_ROUNDS):
                stm, m = step_m(stm, batch, key=rng.fold_in(SEED, r + 1))
                losses.append(float(m["loss"]))
        gathers = mesh.stats.get("all_gather", {}).get("axes", {})
        # the leaves whose products do not partition, each gathered whole
        # (unstacked, or on its layer dim) once a forward
        still, whole = [], True
        for (path, _), md in zip(tree_paths(stm.theta), sspec.shard_dims):
            if gathered_model_leaf(path, md, plan.part):
                still.append("/".join(path))
                whole &= path[0] != "layers" or md == 0
        n_fwd = MESH_PART_ROUNDS * 2
        mine = shard_tree(sspec, st1.Theta, j)
        t_err = _max_err(tree_leaves(stm.Theta), tree_leaves(mine), 0.0,
                         MESH_PART_THETA_ATOL)
        out[arch] = {
            "losses": losses, "losses_one_device": losses1,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, losses1)),
            "Theta_max_abs": t_err[0], "Theta_over_atol": t_err[1],
            "heads": sorted(set(heads)), "n_heads": cfg.n_heads,
            "b11_fwd_launches": len(heads),
            "model_all_gathers": gathers.get("model", 0),
            "model_all_gathers_want": len(still) * n_fwd,
            "gathered_leaves": still, "gathered_whole": whole,
            "collectives": _mesh_stats(mesh, MESH_PART_ROUNDS),
            "partition": {k: getattr(plan.part, k)
                          for k in ("heads", "kv", "ff", "vocab")}}
        del st1, stm, init1, step1, init_m, step_m, h, mine
        _free(torch)
        # the sketched mode's round on the same grid: the codec against one
        # device's on gradients of the partitioned forward, in f32, at
        # ``llm_mesh_sketched_check``'s first bounds
        ref = _mesh_sketched_reference(torch, cfg)
        _free(torch)
        out[f"sketched {arch}"] = _mesh_sketched_check_rank(torch, mesh, ref,
                                                            cfg)
        _free(torch)
    return out


#: rounds of ``llm_mesh`` on each grid (``llm``'s 3 before the run's time
#: limit)
MESH_RUN_ROUNDS = 2


def _mesh_run_rank(torch, mesh) -> dict:
    """``llm_mesh`` on one rank: phase ``llm``'s trainer (granite-8b at
    full width, 2 of 36 layers, W = 2, 1 × 4,096 tokens a worker, 2 sgd
    steps at ``LLM_LR``, ``MESH_RUN_ROUNDS`` rounds) on ``mesh``, the
    collectives timed."""
    from repro_torch import rng
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.kernels import build
    from repro_torch.launch.trace_analysis import mesh_collectives
    from repro_torch.tree import tree_leaves

    cfg = _llm_cfg(LLM_ARCH, LLM_LAYERS)
    t0 = time.perf_counter()
    init_fn, step, _, _ = _mesh_trainer(torch, cfg, mesh, noisy=True)
    state = init_fn(SEED)
    c = shard_coords(mesh, init_fn.layout["sspec"])
    W_l = LLM_WORKERS // c.n_data
    batch = _mesh_batch(torch, cfg, slice(c.jd * W_l, (c.jd + 1) * W_l))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    losses, times = [], []
    for r in range(MESH_RUN_ROUNDS):
        # the state goes in through a list the call empties, so the trainer
        # can free the old θ and optimizer state mid-round
        held = [state]
        state = None
        t0 = time.perf_counter()
        state, m = step(held.pop(), batch, key=rng.fold_in(SEED, r + 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        del m
    mesh.timing = False
    finite = all(bool(torch.isfinite(leaf).all()) for leaf in
                 tree_leaves(state.theta) + tree_leaves(state.Theta))
    out = {"losses": losses, "round_s": times, "setup_s": setup_s,
           "peak": torch.cuda.max_memory_allocated(), "finite": finite,
           "launches": dict(build.launches),
           "collectives": _mesh_stats(mesh, MESH_RUN_ROUNDS),
           "counts": mesh_collectives(mesh.stats),
           "W_local": W_l, "d_local": init_fn.layout["sspec"].d_local}
    del state, step, init_fn
    _free(torch)
    return out


#: ``llm_mesh_check``'s pure-data pin: the (2, 1) grid (one worker a rank)
#: against one device, granite-8b cut to 1 layer, noise-free, 3 rounds of
#: 2 local steps (the second step reads h through the penalty, so the pin
#: holds the ranks to one device's draws of h); every round's loss, Θ, λ
#: and α⁻¹ within rtol 1e-6, h's rows bit for bit
MESH_PIN_SHAPE = (2, 1)
MESH_PIN_ROUNDS, MESH_PIN_STEPS = 2, 2
MESH_PIN_RTOL = 1e-6


def _sha1(torch, x) -> str:
    """A digest of a tensor's bytes."""
    t = x.detach().contiguous()
    return hashlib.sha1(t.view(torch.uint8).cpu().numpy().tobytes()
                        ).hexdigest()


def _cublas_settings(torch) -> dict:
    """The matrix products' settings in force (ROADMAP queue C item 1's
    watch: a GEMM whose algorithm moved would change bits)."""
    mm = torch.backends.cuda.matmul
    return {"allow_tf32": mm.allow_tf32,
            "allow_bf16_reduced_precision_reduction":
            mm.allow_bf16_reduced_precision_reduction,
            "allow_fp16_reduced_precision_reduction":
            mm.allow_fp16_reduced_precision_reduction,
            "CUBLAS_WORKSPACE_CONFIG": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG"),
            "deterministic_algorithms":
            torch.are_deterministic_algorithms_enabled(),
            "preferred_blas_library":
            str(torch.backends.cuda.preferred_blas_library())}


class _LayerDigests:
    """While entered, a digest of the output of every call of the
    transformer's ``block_fwd`` and ``block_decode`` (the checkpoint's
    recompute included), in call order, in :attr:`digests`."""

    NAMES = ("block_fwd", "block_decode")
    MODULE = "transformer"

    def __init__(self, torch):
        self.torch = torch
        self.kept: list = []

    @property
    def digests(self) -> list:
        return [f"{n}:{d}" for n, d in self.kept]

    def digest(self, y):
        return _sha1(self.torch, y)

    def _module(self):
        import importlib

        return importlib.import_module(f"repro_torch.models.{self.MODULE}")

    def __enter__(self):
        mod = self._module()
        self.saved = {n: getattr(mod, n) for n in self.NAMES}

        def wrap(name, fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                y = out[0] if isinstance(out, tuple) else out
                self.kept.append((name, self.digest(y)))
                return out
            return call
        for n, fn in self.saved.items():
            setattr(mod, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        mod = self._module()
        for n, fn in self.saved.items():
            setattr(mod, n, fn)


def _repeat_verdict(torch, same: bool, first: list, second: list) -> dict:
    """Whether a one-device reference run twice in one process agreed bit
    for bit; on a mismatch the two runs' layer digests from the first that
    differs, and the cuBLAS settings in force."""
    out = {"bits_equal": same, "cublas": _cublas_settings(torch),
           "layer_calls": [len(first), len(second)]}
    if not same:
        i = next((k for k, (a, b) in enumerate(zip(first, second))
                  if a != b), min(len(first), len(second)))
        out.update(first_differing_layer_call=i,
                   digests=[first[i:i + 12], second[i:i + 12]])
    return out


def _mesh_pin_rank(torch, mesh) -> dict:
    """The pure-data pin on one rank.  Each rank in turn (the others wait)
    runs the one-device trainer twice (the two runs recorded as bit-equal
    or not, with each layer's output digest where not: ROADMAP queue C
    item 1) and keeps the first run's workers' rows of the final state,
    the losses and α⁻¹; then the ranks run the same rounds on ``mesh`` and
    the rank holds its rows, and Θ whole, to them."""
    from repro_torch import rng
    from repro_torch.core.tree_ota import shard_coords
    from repro_torch.kernels import build
    from repro_torch.tree import tree_leaves

    cfg = _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    rank = torch.distributed.get_rank()
    jd, n_data = mesh.axis_index("data"), mesh.shape["data"]
    W_l = LLM_WORKERS // n_data
    rows = slice(jd * W_l, (jd + 1) * W_l)
    ref: dict = {}
    runs: list = []
    for turn in range(MESH_RANKS):
        torch.distributed.barrier()
        if rank != turn:
            continue
        for _ in range(2):
            init1, step1, _, _ = _mesh_trainer(
                torch, cfg, None, noisy=False, local_steps=MESH_PIN_STEPS)
            st = init1(SEED)
            batch = _mesh_batch(torch, cfg)
            losses, ias = [], []
            with _LayerDigests(torch) as dig:
                for r in range(MESH_PIN_ROUNDS):
                    st, m = step1(st, batch, key=rng.fold_in(SEED, r + 1))
                    losses.append(float(m["loss"]))
                    ias.append(float(m["inv_alpha"]))
            runs.append({"losses": losses, "inv_alpha": ias,
                         "Theta": [_sha1(torch, x)
                                   for x in tree_leaves(st.Theta)],
                         "digests": dig.digests})
            if not ref:
                ref = {"losses": losses, "inv_alpha": ias, "Theta": st.Theta,
                       "theta": [x[rows].clone()
                                 for x in tree_leaves(st.theta)],
                       "lam": [st.lam.re[rows].clone(),
                               st.lam.im[rows].clone()],
                       "h": [st.chan.h.re[rows].clone(),
                             st.chan.h.im[rows].clone()]}
            del st, step1, init1, m
            _free(torch)
    torch.distributed.barrier()
    a, b = runs
    repeat = _repeat_verdict(
        torch, all(a[k] == b[k] for k in ("losses", "inv_alpha", "Theta",
                                           "digests")),
        a["digests"], b["digests"])
    repeat["losses"] = [a["losses"], b["losses"]]
    init_fn, step, _, _ = _mesh_trainer(torch, cfg, mesh, noisy=False,
                                        local_steps=MESH_PIN_STEPS)
    state = init_fn(SEED)
    c = shard_coords(mesh, init_fn.layout["sspec"])
    batch = _mesh_batch(torch, cfg, rows)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    losses, ias, times = [], [], []
    for r in range(MESH_PIN_ROUNDS):
        t0 = time.perf_counter()
        state, m = step(state, batch, key=rng.fold_in(SEED, r + 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        ias.append(float(m["inv_alpha"]))
    mesh.timing = False
    launches = dict(build.launches)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    errs = {"Theta": _max_err(tree_leaves(state.Theta),
                              tree_leaves(ref["Theta"]), MESH_PIN_RTOL, 0.0),
            "theta": _max_err(tree_leaves(state.theta), ref["theta"],
                              MESH_PIN_RTOL, 0.0),
            "lam": _max_err([state.lam.re, state.lam.im], ref["lam"],
                            MESH_PIN_RTOL, 0.0)}
    bits = {"loss": losses == ref["losses"],
            "inv_alpha": ias == ref["inv_alpha"],
            "Theta": all(bool(torch.equal(a, b)) for a, b in zip(
                tree_leaves(state.Theta), tree_leaves(ref["Theta"]))),
            "theta": all(bool(torch.equal(a, b)) for a, b in zip(
                tree_leaves(state.theta), ref["theta"])),
            "lam": all(bool(torch.equal(a, b)) for a, b in zip(
                [state.lam.re, state.lam.im], ref["lam"])),
            "h": all(bool(torch.equal(a, b)) for a, b in zip(
                [state.chan.h.re, state.chan.h.im], ref["h"]))}
    out = {"losses": losses, "losses_one_device": ref["losses"],
           "inv_alpha": ias, "inv_alpha_one_device": ref["inv_alpha"],
           "loss_rel_err": rel(losses, ref["losses"]),
           "inv_alpha_rel_err": rel(ias, ref["inv_alpha"]),
           **{f"{k}_max_abs": v[0] for k, v in errs.items()},
           **{f"{k}_over_rtol": v[1] for k, v in errs.items()},
           "bits_equal": bits, "round_s": times,
           "peak": torch.cuda.max_memory_allocated(),
           "W_local": W_l, "d_local": init_fn.layout["sspec"].d_local,
           "jd": c.jd, "launches": launches,
           "collectives": _mesh_stats(mesh, MESH_PIN_ROUNDS),
           "one_device_repeat": repeat}
    del state, step, init_fn, ref
    _free(torch)
    return out


#: ``llm_mesh_sketched_check`` and ``llm_mesh_sketched``: the sketched mode
#: on the (1, 2) grid (Θ the rank's model shard, the (W, d_s) sketches
#: whole on each rank); granite-8b at full width, W = 2, 1 × 4,096 tokens
#: a worker, sgd at ``LLM_LR``, ratio 256.  The check: 1 layer, one local
#: step, noise-free, against one device; the run: 2 layers, 2 steps, 2
#: rounds (3 before the run's time limit; each worker's local steps gather
#: every layer, twice with the checkpoint's recompute)
MESH_SKETCH_SHAPE = (1, 2)
MESH_SKETCH_LAYERS, MESH_SKETCH_ROUNDS = 2, 2
#: Θ_s against one device's: the encode's scatter-add sums each bucket in
#: another order (float atomics, and the grid's psum of its partial
#: sketches), the chunked encode's tolerance; the decoded Θ shard against
#: the one-device Θ's slice to rtol 1e-5.  These two are recorded: the
#: forward partitioned over ``model`` (``models/partition``) rounds the
#: bf16 gradients otherwise than one device's, so a parameter whose bf16
#: update lies near a rounding boundary moves by one ulp of itself.  The
#: row-split products are summed in f32 and rounded once, as one device's
#: product is; the column-split products' input gradients are still summed
#: over the ranks in bf16.  A step at 5e-4 is below one bf16 ulp for most
#: parameters, so Θ_s sums the parameters' rounding flips, which the
#: reordered sums move.  Θ_s is held to one device's by its relative L2
#: distance, ``MESH_SKETCH_THETA_S_REL_L2``, which must lie between the
#: sound round's reading and a control's that drops rank 1's ``wo`` partial
#: products (:func:`_dropped_partial`); the ranks' Θ_s are held to each
#: other bit for bit.  On an H100 (700 W) the sound round read 0.0319 with
#: the f32 row sums (0.0323 with bf16 ones) and the control 1.18.  The Θ shard is held to ``MESH_SKETCH_SCALED_RTOL``
#: (2⁻⁸) of each leaf's largest magnitude; the codec is held to one
#: device's at atol 1e-6 in f32, on the partitioned forward's gradients
#: (``llm_mesh_partition_check``)
MESH_SKETCH_THETA_S_ATOL = 1e-6
MESH_SKETCH_THETA_RTOL = 1e-5
MESH_SKETCH_SCALED_RTOL = 2.0 ** -8
MESH_SKETCH_THETA_S_REL_L2 = 2.0 ** -4


def _mesh_sketched_trainer(torch, cfg, mesh, noisy: bool,
                           local_steps: int, device="cuda"):
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    return make_fl_train(
        build_model(cfg), FLConfig(
            mode="sketched", n_workers=LLM_WORKERS, local_steps=local_steps,
            local_lr=LLM_LR, sketch_ratio=SKETCH_RATIO, sketch_lr=SKETCH_LR),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=LLM_WORKERS, snr_db=40.0, coherence_iters=10,
                      noisy=noisy), mesh=mesh, device=device)


@contextlib.contextmanager
def _consensus_sketch(out: list):
    """Keep each sketched round's consensus sketch Θ_s (the packed round's
    Θ over the (W, d_s) sketches) in ``out``."""
    from repro_torch.train import llm_trainer

    inner = llm_trainer.ota_tree_round_packed_state

    def keep(*args, **kwargs):
        res = inner(*args, **kwargs)
        out.append(res[0].detach().clone())
        return res
    llm_trainer.ota_tree_round_packed_state = keep
    try:
        yield out
    finally:
        llm_trainer.ota_tree_round_packed_state = inner


def _mesh_sketched_reference(torch, cfg=None) -> dict:
    """The one-device round of ``llm_mesh_sketched_check`` (on ``cfg``,
    1-layer granite-8b by default): its loss and consensus sketch Θ_s (on
    the host)."""
    from repro_torch import rng

    cfg = cfg or _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    init_fn, step = _mesh_sketched_trainer(torch, cfg, None, noisy=False,
                                           local_steps=1)
    sketches: list = []
    with _consensus_sketch(sketches):
        _, m = step(init_fn(SEED), _mesh_batch(torch, cfg),
                    key=rng.fold_in(SEED, 1))
    return {"loss": float(m["loss"]), "Theta_s": sketches[0].cpu().numpy()}


@contextlib.contextmanager
def _dropped_partial(what: str):
    """A fault for the Θ_s gate's control: rank 1 of the model axis adds
    nothing to the sum of the row-split product ``what`` (its partial
    product dropped), so both ranks go on with rank 0's partial alone and
    issue the same collectives."""
    from repro_torch.models.partition import Partition

    inner = Partition.dense_rows

    def drop(self, p, x, n_full, name="row"):
        if name == what and self.index == 1:
            x = x * 0            # in the graph: its gradients are zeros
        return inner(self, p, x, n_full, name)
    Partition.dense_rows = drop
    try:
        yield
    finally:
        Partition.dense_rows = inner


def _mesh_sketched_control(torch, mesh, cfg, ref_s) -> float:
    """Θ_s's relative L2 distance from one device's (``ref_s``) in a
    round whose ``wo`` partial products of rank 1 are dropped
    (:func:`_dropped_partial`): the reading the Θ_s gate must refuse."""
    from repro_torch import rng

    init_fn, step = _mesh_sketched_trainer(torch, cfg, mesh, noisy=False,
                                           local_steps=1)
    sketches: list = []
    with _dropped_partial("wo"), _consensus_sketch(sketches):
        step(init_fn(SEED), _mesh_batch(torch, cfg),
             key=rng.fold_in(SEED, 1))
    rel = float((sketches[0] - ref_s).float().norm() / ref_s.float().norm())
    del init_fn, step, sketches
    _free(torch)
    return rel


def _mesh_sketched_check_rank(torch, mesh, ref: dict, cfg=None,
                              control: bool = False) -> dict:
    """``llm_mesh_sketched_check`` on one rank: one round on ``mesh`` (of
    ``cfg``, 1-layer granite-8b by default); the loss, Θ_s and the rank's
    decoded Θ shard against the one-device round (``ref``; its Θ is the
    one-device decode of its Θ_s over the full init).  With ``control``,
    also Θ_s's distance in a faulted round (:func:`_mesh_sketched_control`),
    after the counted round."""
    from repro_torch import rng
    from repro_torch.core.packing import shard_tree
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import _apply_packed
    from repro_torch.tree import tree_leaves

    cfg = cfg or _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    init_fn, step = _mesh_sketched_trainer(torch, cfg, mesh, noisy=False,
                                           local_steps=1)
    state = init_fn(SEED)
    lay = init_fn.layout
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    sketches: list = []
    t0 = time.perf_counter()
    with _consensus_sketch(sketches):
        state, m = step(state, _mesh_batch(torch, cfg),
                        key=rng.fold_in(SEED, 1))
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    mesh.timing = False
    launches = dict(build.launches)
    dev = torch.device("cuda")
    ref_s = torch.from_numpy(ref["Theta_s"]).to(dev)
    s_err = _max_err([sketches[0]], [ref_s], 0.0, MESH_SKETCH_THETA_S_ATOL)
    # one device's Θ after the round: its decode of its Θ_s over the init
    full = build_model(cfg).init(rng.split(SEED)[0], device=dev)
    one, _ = _apply_packed(full, ref_s, SKETCH_LR, False)
    del full
    mine = shard_tree(lay["sspec"], one, lay["j"])
    t_err = _max_err(tree_leaves(state.Theta), tree_leaves(mine),
                     MESH_SKETCH_THETA_RTOL, 0.0)
    s_rel = float((sketches[0] - ref_s).float().norm()
                  / ref_s.float().norm())
    s_sha1 = hashlib.sha1(sketches[0].cpu().numpy().tobytes()).hexdigest()
    t_scaled = _scaled_err(tree_leaves(state.Theta), tree_leaves(mine),
                           MESH_SKETCH_SCALED_RTOL)
    out = {"loss": float(m["loss"]), "loss_one_device": ref["loss"],
           "Theta_s_max_ref": float(ref_s.abs().max()),
           "Theta_s_rel_l2": s_rel, "Theta_s_sha1": s_sha1,
           "Theta_over_scaled": t_scaled[1],
           "Theta_s_max_abs": s_err[0], "Theta_s_over_atol": s_err[1],
           "Theta_s_bits_equal": bool(torch.equal(sketches[0], ref_s)),
           "Theta_max_abs": t_err[0], "Theta_over_rtol": t_err[1],
           "Theta_bits_equal": all(bool(torch.equal(a, b)) for a, b in zip(
               tree_leaves(state.Theta), tree_leaves(mine))),
           "lam_shape": list(state.lam.re.shape), "round_s": round_s,
           "peak": torch.cuda.max_memory_allocated(),
           "d_local": lay["sspec"].d_local, "j": lay["j"],
           "launches": launches, "collectives": _mesh_stats(mesh, 1)}
    del state, step, init_fn, one, mine, sketches
    _free(torch)
    if control:
        out["Theta_s_rel_l2_control"] = _mesh_sketched_control(
            torch, mesh, cfg, ref_s)
    return out


def _timed_methods(torch, cls, names, acc: dict):
    """Wrap ``cls``'s methods ``names`` so each call's wall ms (the card
    synchronised around it) adds into ``acc[name]``; returns the undo."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return res
        return timed
    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(cls, n, fn)
    return undo


def _mesh_sketched_rank(torch, mesh) -> dict:
    """``llm_mesh_sketched`` on one rank: granite-8b at full width cut to
    ``MESH_SKETCH_LAYERS``, 3 rounds, the collectives and the codec (the
    rank's encodes, the grid's psum, its decode) timed."""
    from repro_torch import rng
    from repro_torch.kernels import build
    from repro_torch.launch.trace_analysis import mesh_collectives
    from repro_torch.models.registry import packed_param_count
    from repro_torch.train import llm_trainer
    from repro_torch.tree import tree_leaves

    cfg = _llm_cfg(LLM_ARCH, MESH_SKETCH_LAYERS)
    t0 = time.perf_counter()
    init_fn, step = _mesh_sketched_trainer(torch, cfg, mesh, noisy=True,
                                           local_steps=2)
    state = init_fn(SEED)
    batch = _mesh_batch(torch, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    d_s = llm_trainer._sketch_dim(packed_param_count(cfg), SKETCH_RATIO)
    shapes_ok = (tuple(state.lam.re.shape) == (LLM_WORKERS, d_s)
                 and tuple(state.chan.h.re.shape) == (LLM_WORKERS, d_s))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    codec: dict = {}
    undo = _timed_methods(torch, llm_trainer._SketchGrid,
                          ("encode", "join", "apply_delta"), codec)
    losses, times, finite = [], [], True
    try:
        for r in range(MESH_SKETCH_ROUNDS):
            held = [state]
            state = None
            t0 = time.perf_counter()
            state, m = step(held.pop(), batch, key=rng.fold_in(SEED, r + 1))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            finite &= math.isfinite(losses[-1]) and all(
                bool(torch.isfinite(leaf).all())
                for leaf in tree_leaves(state.Theta))
            del m
    finally:
        undo()
        mesh.timing = False
    out = {"losses": losses, "round_s": times, "setup_s": setup_s,
           "finite": finite, "shapes_ok": shapes_ok, "d_s": d_s,
           "peak": torch.cuda.max_memory_allocated(),
           "launches": dict(build.launches),
           "collectives": _mesh_stats(mesh, MESH_SKETCH_ROUNDS),
           "counts": mesh_collectives(mesh.stats),
           "codec_ms_per_round": {k: v / MESH_SKETCH_ROUNDS
                                  for k, v in codec.items()},
           "d_local": init_fn.layout["sspec"].d_local,
           "D": packed_param_count(cfg)}
    del state, step, init_fn
    _free(torch)
    return out


#: ``llm_mesh_cohort_check``: cohort sampling on the (2, 1) grid (a
#: population of 4, 2 rows a rank; 2 sampled a round by top-gain, one a
#: rank) against one device: reduced granite-8b in f32 (at full width two
#: ranks' populations would not fit beside each other: ``llm_cohort``
#: alone peaks near 70 GB), 2 local sgd steps at 1e-2, noise-free, 3
#: rounds.  The losses within rtol 1e-6; Θ, θ and λ within 1e-6 of each
#: tensor's largest magnitude: at these widths cuBLAS takes another f32
#: GEMM for a rank's one worker than for one device's two (on an H100 the
#: check reads 1-ulp differences, 1.2e-7 of Θ's largest value, where the
#: CPU's runs are bit-equal), and an element near zero has no relative
#: error to hold
MESH_COHORT = dict(population=4, cohort=2, cohort_policy="top-gain")
MESH_COHORT_ROUNDS, MESH_COHORT_RTOL = 3, 1e-6


def _scaled_err(outs, refs, rtol: float):
    """(max |a − b|, max |a − b| / (rtol · max |b|)) over pairs of
    tensors, each held to its reference's largest magnitude."""
    worst_abs, worst = 0.0, 0.0
    for a, b in zip(outs, refs):
        scale = float(b.abs().max())
        m_abs, ratio = _max_err([a], [b], 0.0, rtol * scale)
        worst_abs, worst = max(worst_abs, m_abs), max(worst, ratio)
    return worst_abs, worst


def _mesh_cohort_trainer(torch, mesh):
    import dataclasses

    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import build_model, get_config
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train

    cfg = dataclasses.replace(get_config(LLM_ARCH).reduced(),
                              param_dtype="float32")
    init_fn, step = make_fl_train(
        build_model(cfg), FLConfig(n_workers=MESH_COHORT["cohort"],
                                   local_steps=2, local_lr=1e-2,
                                   **MESH_COHORT),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=MESH_COHORT["population"], snr_db=40.0,
                      coherence_iters=10, noisy=False), mesh=mesh)
    return cfg, init_fn, step


def _mesh_cohort_tokens(torch, cfg):
    from repro_torch.data.synthetic import token_dataset

    return token_dataset(SEED + 3, SKETCH_CHECK_B, SKETCH_CHECK_S,
                         cfg.vocab_size, n_workers=MESH_COHORT["cohort"])


def _mesh_cohort_reference(torch) -> dict:
    """The one-device cohort run of ``llm_mesh_cohort_check``: its losses
    and final Θ, θ and λ (on the host)."""
    from repro_torch import rng
    from repro_torch.tree import tree_leaves

    cfg, init_fn, step = _mesh_cohort_trainer(torch, None)
    st = init_fn(SEED)
    batch = {"tokens": _mesh_cohort_tokens(torch, cfg)}
    losses = []
    for r in range(MESH_COHORT_ROUNDS):
        st, m = step(st, batch, key=rng.fold_in(SEED, r + 1))
        losses.append(float(m["loss"]))
    host = lambda xs: [x.cpu().numpy() for x in xs]  # noqa: E731
    return {"losses": losses, "Theta": host(tree_leaves(st.Theta)),
            "theta": host(tree_leaves(st.theta)),
            "lam": host([st.lam.re, st.lam.im])}


def _mesh_cohort_rank(torch, mesh, ref: dict) -> dict:
    """``llm_mesh_cohort_check`` on one rank: the rounds on ``mesh``, its
    population rows of θ and λ and Θ against the one-device run's
    (:func:`_scaled_err`), and whether they are bit-equal."""
    from repro_torch import rng
    from repro_torch.kernels import build
    from repro_torch.tree import tree_leaves

    cfg, init_fn, step = _mesh_cohort_trainer(torch, mesh)
    state = init_fn(SEED)
    jd, n_data = mesh.axis_index("data"), mesh.shape["data"]
    n_l = MESH_COHORT["population"] // n_data
    c_l = MESH_COHORT["cohort"] // n_data
    rows = slice(jd * n_l, (jd + 1) * n_l)
    batch = {"tokens": _mesh_cohort_tokens(torch, cfg)[
        jd * c_l:(jd + 1) * c_l]}
    build.reset_launches()
    losses = []
    for r in range(MESH_COHORT_ROUNDS):
        state, m = step(state, batch, key=rng.fold_in(SEED, r + 1))
        losses.append(float(m["loss"]))
    launches = dict(build.launches)
    dev = torch.device("cuda")
    on = lambda xs: [torch.from_numpy(x).to(dev) for x in xs]  # noqa: E731
    got = {"Theta": tree_leaves(state.Theta),
           "theta": tree_leaves(state.theta),
           "lam": [state.lam.re, state.lam.im]}
    want = {"Theta": on(ref["Theta"]),
            "theta": [x[rows] for x in on(ref["theta"])],
            "lam": [x[rows] for x in on(ref["lam"])]}
    errs = {k: _scaled_err(got[k], want[k], MESH_COHORT_RTOL) for k in got}
    bits = {k: all(bool(torch.equal(a, b)) for a, b in zip(got[k], want[k]))
            for k in got}
    out = {"losses": losses, "losses_one_device": ref["losses"],
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                               zip(losses, ref["losses"])),
           "losses_bits_equal": losses == ref["losses"],
           **{f"{k}_max_abs": v[0] for k, v in errs.items()},
           **{f"{k}_over_rtol_of_max": v[1] for k, v in errs.items()},
           "bits_equal": bits, "launches": launches, "population_rows": n_l,
           "cohort_slots": c_l}
    del state, step, init_fn
    _free(torch)
    return out


# ---------------------------------------------------------------------------
# slice 20: partitioned serving on the (1, 2) grid
# ---------------------------------------------------------------------------

#: ``serve_mesh``: granite-8b at full width cut to ``SERVE_MESH_LAYERS`` of
#: its 36 layers (the run's time limit), bf16, served on the (1, 2) grid
#: (its 8 KV heads split over ``model``: the cache's "heads" layout): an
#: 8 × 64 prompt through ``make_prefill``, then through
#: the greedy step a token at a time, then 16 new tokens; the ranks feed one
#: device's tokens, so every step's logits are compared on the same inputs
SERVE_MESH_SHAPE = (1, 2)
SERVE_MESH_LAYERS = 12
SERVE_MESH_B, SERVE_MESH_P, SERVE_MESH_N = 8, 64, 16
SERVE_MESH_STEPS = SERVE_MESH_P - 1 + SERVE_MESH_N
#: a bound on a step's logits against one device's, 2⁻⁶ of the step's
#: largest |logit|, recorded, not gated: two valid bf16 runs of 36 layers
#: differ by more (each ~0.1 from an f32 run where the largest logit is
#: ~5); the tokens equal up to the first step whose one-device top-2
#: margin (a row's) is below that bound
SERVE_MESH_TOL = 2.0 ** -6
#: the gate on the bf16 logits: their RMS distance from the same weights
#: and inputs run in f32 on one device, over the prefill and over all the
#: steps, at most this multiple of one device's bf16 logits' distance
SERVE_MESH_F32_RATIO = 1.1
#: the one-device greedy steps each rank runs twice (ROADMAP C item 1)
SERVE_MESH_REPEAT_STEPS = 8
#: the rank's prefill timings
SERVE_MESH_PREFILL_RUNS = 3
#: the reduced f32 checks on (1, 2): (name, config fields replaced, prompt,
#: new tokens), a batch of 4: the heads layout; one KV head (the sequence
#: over ``model``); one KV head and a window of 32, the prompt and the new
#: tokens past it (the rotating buffer split over the sequence)
SERVE_MESH_CHECKS = (("heads", {}, 8, 8),
                     ("seq", {"n_kv_heads": 1}, 8, 8),
                     ("seq-window", {"n_kv_heads": 1, "sliding_window": 32},
                      40, 8))
SERVE_MESH_CHECK_B = 4
SERVE_MESH_CHECK_RTOL = 1e-5
#: the expected layout of each check's cache
SERVE_MESH_LAYOUTS = {"heads": "heads", "seq": "seq", "seq-window": "seq"}


def _serve_mesh_cfg():
    import dataclasses

    from repro_torch.models import get_config

    return dataclasses.replace(get_config(LLM_ARCH),
                               n_layers=SERVE_MESH_LAYERS)


def _serve_check_cfg(over: dict):
    import dataclasses

    from repro_torch.models import get_config

    return dataclasses.replace(get_config(LLM_ARCH).reduced(),
                               param_dtype="float32", **over)


def _greedy_run(step, params, cache, prompts, n_new: int, feed=None,
                every=None):
    """The prompt ingested through ``step`` a token at a time, then
    ``n_new`` greedy tokens: each step's logits (as ``model.decode_step``
    returned them, which ``step`` must call: see :func:`_observed`), the
    step's tokens and the cache.  ``feed`` (steps, B) replaces the greedy
    inputs (teacher forcing); ``every(i)`` runs after each step."""
    P = prompts.shape[1]
    logits, toks = [], []
    tok = prompts[:, 0]
    for i in range(P - 1 + n_new):
        nxt, cache = step(params, cache, tok, i)
        toks.append(nxt)
        if every is not None:
            every(i)
        if feed is not None and i + 1 < feed.shape[0]:
            tok = feed[i + 1]
        else:
            tok = prompts[:, i + 1] if i + 1 < P else nxt
    return toks, cache


def _observed(model, store: list):
    """``model`` whose ``decode_step`` keeps each step's logits in
    ``store``."""
    def observed(p, c, tok, pos):
        logits, c = model.decode_step(p, c, tok, pos)
        store.append(logits)
        return logits, c
    return model._replace(decode_step=observed)


def _serve_mesh_reference(torch, ref_dir: str) -> dict:
    """One device's runs ``serve_mesh`` holds the ranks to, saved to
    ``ref_dir``: granite-8b (bf16, ``SERVE_MESH_LAYERS`` layers): the
    prefill's last logits,
    every step's logits, inputs and greedy tokens; and each reduced f32
    check's prefill, step logits, tokens and final cache.  Returns the
    file's path, the steps' largest |logit| and smallest top-2 margin,
    and the one-device prefill and decode times."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.benchmarks.common import time_ms
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    model = build_model(_serve_mesh_cfg())
    params = model.init(SEED + 20)
    gen = rng.generator(SEED + 21, dev)
    prompts = torch.randint(0, model.cfg.vocab_size,
                            (SERVE_MESH_B, SERVE_MESH_P), device=dev,
                            generator=gen)
    prefill = make_prefill(model)
    last = prefill(params, {"tokens": prompts})
    prefill_ms = time_ms(lambda: prefill(params, {"tokens": prompts}),
                         runs=5, warmup=1, spin=False)
    store: list = []
    step = make_serve_step(_observed(model, store))
    cache = model.init_cache(SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = _greedy_run(step, params, cache, prompts, SERVE_MESH_N)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SERVE_MESH_STEPS * 1e3
    logits = torch.stack(store)                       # (steps, B, V)
    top2 = logits.float().topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]              # (steps, B)
    scale = logits.float().abs().amax(dim=(1, 2))
    feed = torch.cat([prompts[:, :1].T, torch.stack(toks)[:-1]])
    feed[:SERVE_MESH_P] = prompts.T
    # the same weights and inputs in f32 (TF32 off): the arithmetic both
    # bf16 runs are held to
    m32 = build_model(dataclasses.replace(model.cfg, param_dtype="float32"))
    p32 = tree_map(lambda x: x.float(), params)
    del params, cache, store
    _free(torch)
    last32 = make_prefill(m32)(p32, {"tokens": prompts})
    store = []
    c32 = m32.init_cache(SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N)
    _greedy_run(make_serve_step(_observed(m32, store)), p32, c32, prompts,
                SERVE_MESH_N, feed=feed)
    truth = torch.stack(store)
    one_err = {"prefill": _err_stats(last, last32),
               "steps": [_err_stats(a, b) for a, b in zip(logits, truth)]}
    data = {"prompts": prompts.cpu(), "prefill": last.cpu(),
            "logits": logits.cpu(), "tokens": torch.stack(toks).cpu(),
            "feed": feed.cpu(), "prefill_f32": last32.cpu(),
            "logits_f32": truth.cpu()}
    del model, m32, p32, c32, prefill, step, store, logits, last, last32
    del toks, truth
    _free(torch)
    for name, over, P, N in SERVE_MESH_CHECKS:
        m = build_model(_serve_check_cfg(over))
        p = m.init(SEED + 22)
        pr = torch.randint(0, m.cfg.vocab_size, (SERVE_MESH_CHECK_B, P),
                           device=dev, generator=rng.generator(SEED + 23,
                                                               dev))
        st: list = []
        last = make_prefill(m)(p, {"tokens": pr})
        c = m.init_cache(SERVE_MESH_CHECK_B, P + N)
        tk, c = _greedy_run(make_serve_step(_observed(m, st)), p, c, pr, N)
        data[name] = {"prompts": pr.cpu(), "prefill": last.cpu(),
                      "logits": torch.stack(st).cpu(),
                      "tokens": torch.stack(tk).cpu(),
                      "cache": {k: v.cpu() for k, v in c.items()}}
        del m, p, c, st, last, tk
    _free(torch)
    path = os.path.join(ref_dir, "serve_mesh_reference.pt")
    torch.save(data, path)
    return {"path": path, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "max_abs_logit": scale.tolist(), "margin": margin.tolist(),
            "one_device_vs_f32": one_err}


def _err_stats(a, b) -> dict:
    """``a`` against ``b``: the largest |Δ|, the sum of Δ² and the count
    (for an RMS over several blocks), in f32."""
    d = a.float() - b.float()
    return {"max_abs": float(d.abs().max()), "sum_sq": float((d * d).sum()),
            "n": d.numel()}


def _rms(stats: list) -> float:
    return math.sqrt(sum(s["sum_sq"] for s in stats)
                     / sum(s["n"] for s in stats))


def _serve_mesh_repeat(torch, model, params, prompts, data) -> dict:
    """One device's prefill and ``SERVE_MESH_REPEAT_STEPS`` greedy steps,
    run twice in this rank's process: whether the two runs' logits agree
    bit for bit (each layer's output digest kept for the verdict), and
    whether they are the parent's bits."""
    from repro_torch.serve import make_prefill, make_serve_step

    runs = []
    for _ in range(2):
        store: list = []
        step = make_serve_step(_observed(model, store))
        cache = model.init_cache(SERVE_MESH_B,
                                 SERVE_MESH_P + SERVE_MESH_N)
        feed = data["feed"][:SERVE_MESH_REPEAT_STEPS].to(prompts.device)
        with _LayerDigests(torch) as dig:
            last = make_prefill(model)(params, {"tokens": prompts})
            tok = feed[0]
            for i in range(SERVE_MESH_REPEAT_STEPS):
                _, cache = step(params, cache, tok, i)
                if i + 1 < SERVE_MESH_REPEAT_STEPS:
                    tok = feed[i + 1]
        runs.append({"prefill": _sha1(torch, last),
                     "steps": [_sha1(torch, x) for x in store],
                     "digests": dig.digests,
                     "parent": bool(torch.equal(last.cpu(), data["prefill"]))
                     and all(torch.equal(x.cpu(), y) for x, y in zip(
                         store, data["logits"][:SERVE_MESH_REPEAT_STEPS]))})
        del cache, store, last
    a, b = runs
    out = _repeat_verdict(torch, a["prefill"] == b["prefill"]
                          and a["steps"] == b["steps"]
                          and a["digests"] == b["digests"],
                          a["digests"], b["digests"])
    out["parent_bits_equal"] = [a["parent"], b["parent"]]
    return out


def _serve_mesh_full(torch, mesh, data: dict) -> dict:
    """``serve_mesh`` (a) on one rank: granite-8b at full width on
    ``mesh`` (``SERVE_MESH_LAYERS`` layers), its prefill and its
    teacher-forced greedy steps against one device's, timed, with the
    mesh's collectives, B11's launches and the rank's peaks.  Each rank
    first runs one device's prefill and steps twice in turn
    (:func:`_serve_mesh_repeat`)."""
    from repro_torch.kernels import build
    from repro_torch.models import build_model, layers
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    rank = torch.distributed.get_rank()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(_serve_mesh_cfg())
    t0 = time.perf_counter()
    full = model.init(SEED + 20)
    prompts = data["prompts"].to(dev)
    repeat = None
    for turn in range(MESH_RANKS):
        torch.distributed.barrier()
        if rank == turn:
            with torch.no_grad():
                repeat = _serve_mesh_repeat(torch, model, full, prompts,
                                            data)
            _free(torch)
    torch.distributed.barrier()
    store: list = []
    step = make_serve_step(_observed(model, store), mesh)
    prefill = make_prefill(model, mesh)
    params = step.shard(full)
    # the prefill's plan from the shapes alone: its blocks on ``meta``
    prefill.shard(tree_map(lambda x: x.to("meta"), full))
    del full
    cache = step.init_cache(SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _free(torch)
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    batch = {"tokens": prompts}
    b11_shapes = []
    b11 = layers.flash_attention

    def recorded(q, *args, **kwargs):
        b11_shapes.append(list(q.shape))
        return b11(q, *args, **kwargs)
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    layers.flash_attention = recorded
    try:
        last = prefill(params, batch)
    finally:
        layers.flash_attention = b11
    torch.cuda.synchronize()
    mesh.timing = False
    pre_launches = {k: v for k, v in build.launches.items() if v}
    pre_stats = _mesh_stats(mesh, 1)
    pre_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    ref_pre = data["prefill"].to(dev).float()
    pre_err = float((last.float() - ref_pre).abs().max())
    pre_scale = float(ref_pre.abs().max())
    times = []
    for _ in range(SERVE_MESH_PREFILL_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)

    feed = data["feed"].to(dev)
    step_s = []

    def tick(i):
        torch.cuda.synchronize()
        step_s.append(time.perf_counter())
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, cache = _greedy_run(step, params, cache, prompts, SERVE_MESH_N,
                              feed=feed, every=tick)
    mesh.timing = False
    dec_launches = {k: v for k, v in build.launches.items() if v}
    dec_stats = _mesh_stats(mesh, SERVE_MESH_STEPS)
    dec_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    walls = [(b - a) * 1e3 for a, b in zip([t1] + step_s[:-1], step_s)]
    peak = torch.cuda.max_memory_allocated()
    j = mesh.axis_index("model")
    errs, errs32, local = [], [], torch.stack(store)
    vl = local.shape[-1]
    cols = slice(j * vl, (j + 1) * vl)
    for i in range(SERVE_MESH_STEPS):
        ref = data["logits"][i][:, cols].to(dev)
        errs.append(float((local[i].float() - ref.float()).abs().max()))
        errs32.append(_err_stats(local[i],
                                 data["logits_f32"][i][:, cols].to(dev)))
    tokens = torch.stack(toks).cpu()
    gathered = mesh.all_gather(local, "model", -1, op="gather_vocab")
    out = {"prefill_max_abs_err": pre_err, "prefill_max_abs_logit": pre_scale,
           "prefill_sha1": _sha1(torch, last),
           "step_logits_sha1": _sha1(torch, gathered),
           "step_max_abs_err": errs, "step_vs_f32": errs32,
           "prefill_vs_f32": _err_stats(last, data["prefill_f32"].to(dev)),
           "tokens": tokens.tolist(),
           "tokens_one_device": data["tokens"].tolist(),
           "prefill_launches": pre_launches, "decode_launches": dec_launches,
           "prefill_b11_shapes": sorted(map(list, {tuple(x)
                                                   for x in b11_shapes})),
           "prefill_collectives": pre_stats, "prefill_calls": pre_calls,
           "decode_collectives": dec_stats, "decode_calls": dec_calls,
           "prefill_ms": times, "decode_wall_ms": walls,
           "setup_s": setup_s, "setup_peak": setup_peak, "peak": peak,
           "cache_layout": step.layout["cache"],
           "cache_block": list(cache["k"].shape),
           "one_device_repeat": repeat}
    del gathered, local, store
    # one more step's kernels on the device (the profiler's kernel events;
    # the step rewrites the last slot with the same token)
    out["decode_device_ms"] = _kernel_ms(
        torch, lambda: step(params, cache, feed[-1], SERVE_MESH_STEPS - 1))
    del params, cache, last, model, step, prefill
    _free(torch)
    return out


def _kernel_ms(torch, fn) -> float:
    """The device time of the kernels of one call of ``fn``
    (``torch.profiler``'s CUDA kernel events, as phase ``profile`` sums
    them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def _serve_mesh_check(torch, mesh, data: dict, over: dict, P: int,
                      N: int) -> dict:
    """``serve_mesh`` (b) on one rank: reduced f32 granite-8b with ``over``
    served greedily on ``mesh`` against one device's run on the card:
    the prefill's and every step's logits (the rank's vocab columns), the
    tokens, and the rank's cache against its block of one device's."""
    from repro_torch.launch.shardings import shard_leaf
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step

    dev = torch.device("cuda")
    m = build_model(_serve_check_cfg(over))
    full = m.init(SEED + 22)
    prompts = data["prompts"].to(dev)
    store: list = []
    prefill = make_prefill(m, mesh)
    last = prefill(prefill.shard(full), {"tokens": prompts})
    step = make_serve_step(_observed(m, store), mesh)
    params = step.shard(full)
    cache = step.init_cache(SERVE_MESH_CHECK_B, P + N)
    mesh.reset_stats()
    toks, cache = _greedy_run(step, params, cache, prompts, N)
    calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}

    def scaled(a, b):
        b = b.to(dev).float()
        return float((a.float() - b).abs().max() / b.abs().max())
    j = mesh.axis_index("model")
    vl = store[0].shape[-1]
    cache_err = max(scaled(cache[k], shard_leaf(
        data["cache"][k], step.layout["cache_specs"][k], mesh))
        for k in cache)
    out = {"layout": step.layout["cache"],
           "cache_block": list(cache["k"].shape),
           "prefill_rel_err": scaled(last, data["prefill"]),
           "step_rel_err": max(scaled(x, y[:, j * vl:(j + 1) * vl])
                               for x, y in zip(store, data["logits"])),
           "cache_rel_err": cache_err,
           "tokens_equal": bool(torch.equal(torch.stack(toks).cpu(),
                                            data["tokens"])),
           "tokens_sha1": _sha1(torch, torch.stack(toks)),
           "decode_calls": calls}
    del m, full, params, cache, store, last
    return out


def _serve_mesh_rank(torch, mesh, ref: dict) -> dict:
    """Phase ``serve_mesh`` on one rank: (a), then the reduced checks
    (b)."""
    data = torch.load(ref["path"])
    out = {"full": _serve_mesh_full(torch, mesh, data)}
    out["checks"] = {name: _serve_mesh_check(torch, mesh, data[name], over,
                                             P, N)
                     for name, over, P, N in SERVE_MESH_CHECKS}
    _free(torch)
    return out


#: ``llm_mesh_moe_check``: the MoE family's partitioned products held tight
#: on the card.  Reduced qwen3-moe (GQA, 4 experts top 2) and deepseek-v3
#: (MLA with q-LoRA, the shared expert, a dense first layer, MTP) in f32 on
#: (1, 2), W = 2, 2 sgd steps at 1e-2, noise-free, 3 replicated rounds from
#: one device's init and h, against the parent's one-device rounds on the
#: card: ``llm_mesh_partition_check``'s bars (each round's loss rtol 1e-5,
#: Θ atol 1e-5), the ranks' losses bit-equal, every dispatch's expert picks
#: and kept pairs one device's (0 differing), B11 on half the heads, B6, B3
#: and B4 once a round a rank, and no all-gather over ``model`` but of the
#: leaves whose products do not partition (the router, ``wq_a``,
#: ``wkv_a``, ``mtp_proj``, the MTP block's experts)
MESH_MOE_ARCHS = (MOE_ARCH, "deepseek-v3-671b")
MESH_MOE_CHECK_ROUNDS = 3
#: ``llm_mesh_moe``: qwen3-moe-30b-a3b at full width (d_model 2,048, 128
#: experts top 8, 32 heads on 4 KV heads, vocabulary 151,936, bf16) cut 48
#: -> 2 layers, the sketched mode on (1, 2) (each rank 64 experts, 16
#: heads, 2 KV heads, half the vocabulary), ratio 256, W = 2, 1 × 4,096
#: tokens a worker, 2 sgd steps at ``LLM_LR``, 2 rounds (3 before the
#: run's time limit), then one profiled
MESH_MOE_LAYERS, MESH_MOE_ROUNDS = 2, 2


def _moe_part_cfg(arch: str):
    import dataclasses

    from repro_torch.models import get_config

    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")


def _mesh_moe_reference(torch) -> dict:
    """The one-device rounds of ``llm_mesh_moe_check``, for each arch: the
    losses, the final Θ and every dispatch's picks and kept pairs (on the
    host)."""
    from repro_torch import rng
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves

    out = {}
    for arch in MESH_MOE_ARCHS:
        cfg = _moe_part_cfg(arch)
        batch = _check_batch(torch, cfg)
        init1, step1 = _mesh_part_trainer(torch, cfg, None)
        st = init1(SEED)
        losses = []
        with moe.record_routing() as seen:
            for r in range(MESH_MOE_CHECK_ROUNDS):
                st, m = step1(st, batch, key=rng.fold_in(SEED, r + 1))
                losses.append(float(m["loss"]))
        out[arch] = {
            "losses": losses,
            "Theta": [x.cpu().numpy() for x in tree_leaves(st.Theta)],
            "routing": [{k: e[k].cpu().numpy() for k in ("idx", "kept")}
                        for e in seen]}
        del st, init1, step1, seen
        _free(torch)
    return out


def _gathers_want(theta, sspec, part, forwards: int, lead: int) -> tuple:
    """The all-gathers over ``model`` ``forwards`` forwards make under
    ``part`` (``models/partition.gathered_model_leaf``), and the leaves
    gathered: an unstacked leaf, or one sharded on its layer dim, once a
    forward; a stacked leaf's entries each gathered in the forward and
    again in the checkpoint's recompute.  ``lead``: the leaves' leading
    worker dims."""
    from repro_torch.models.partition import gathered_model_leaf
    from repro_torch.models.transformer import STACKED_KEYS
    from repro_torch.tree import tree_paths

    n, still = 0, []
    for (path, leaf), md in zip(tree_paths(theta), sspec.shard_dims):
        if gathered_model_leaf(path, md, part):
            still.append("/".join(path))
            stacked = path[0] in STACKED_KEYS and md != 0
            n += 2 * leaf.shape[lead] if stacked else 1
    return n * forwards, still


@contextlib.contextmanager
def _b11_heads(heads: list):
    """Append the head count of each B11 forward launched in the block."""
    from repro_torch.kernels import flash_attention as fa

    inner = fa.flash_attention_fwd

    def fwd(q, *a, **kw):
        heads.append(int(q.shape[1]))
        return inner(q, *a, **kw)
    fa.flash_attention_fwd = fwd
    try:
        yield heads
    finally:
        fa.flash_attention_fwd = inner


def _picks_differ(seen: list, ref: list) -> int:
    """The expert picks and kept pairs that differ between two runs'
    dispatches (each dispatch's whole count where their number or shapes
    differ)."""
    import numpy as np

    n = abs(len(seen) - len(ref))
    for a, b in zip(seen, ref):
        for k in ("idx", "kept"):
            x = a[k].cpu().numpy()
            n += (int((x != b[k]).sum()) if x.shape == b[k].shape
                  else x.size)
    return n


def _mesh_moe_check_rank(torch, mesh, ref: dict) -> dict:
    """``llm_mesh_moe_check`` on one rank: for each of ``MESH_MOE_ARCHS``,
    the rounds on ``mesh`` from one device's init with its h carried into
    the rank's block, against the parent's one-device rounds (``ref``):
    the losses, the rank's Θ block, the picks, B11's head counts, the
    launches and the all-gathers over ``model``."""
    from repro_torch import rng
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import (build_packspec, pack_shard_global,
                                          shard_tree, unpack)
    from repro_torch.kernels import build
    from repro_torch.models import moe
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    out = {}
    j = mesh.axis_index("model")
    for arch in MESH_MOE_ARCHS:
        cfg = _moe_part_cfg(arch)
        batch = _check_batch(torch, cfg)
        init1, _ = _mesh_part_trainer(torch, cfg, None)
        st1 = init1(SEED)
        init_m, step_m = _mesh_part_trainer(torch, cfg, mesh)
        stm = init_m(SEED)
        sspec, plan = init_m.layout["sspec"], init_m.layout["plan"]
        spec1 = build_packspec(st1.theta, batch_dims=1)
        dl = sspec.d_local
        h = Complex(*(pack_shard_global(sspec, unpack(spec1, z, cast=False))
                      [:, j * dl:(j + 1) * dl].contiguous()
                      for z in (st1.chan.h.re, st1.chan.h.im)))
        stm = stm._replace(chan=stm.chan._replace(h=h))
        treedef = tree_flatten(st1.Theta)[1]
        del st1, init1, h
        heads: list = []
        build.reset_launches()
        mesh.reset_stats()
        losses = []
        with _b11_heads(heads), moe.record_routing() as seen:
            for r in range(MESH_MOE_CHECK_ROUNDS):
                stm, m = step_m(stm, batch, key=rng.fold_in(SEED, r + 1))
                losses.append(float(m["loss"]))
        gathers = mesh.stats.get("all_gather", {}).get("axes", {})
        want, still = _gathers_want(stm.theta, sspec, plan.part,
                                    MESH_MOE_CHECK_ROUNDS * 2, 1)
        dev = tree_leaves(stm.Theta)[0].device
        Theta1 = tree_unflatten(treedef, [torch.from_numpy(x).to(dev)
                                          for x in ref[arch]["Theta"]])
        t_err = _max_err(tree_leaves(stm.Theta),
                         tree_leaves(shard_tree(sspec, Theta1, j)), 0.0,
                         MESH_PART_THETA_ATOL)
        losses1 = ref[arch]["losses"]
        out[arch] = {
            "losses": losses, "losses_one_device": losses1,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, losses1)),
            "Theta_max_abs": t_err[0], "Theta_over_atol": t_err[1],
            "dispatches": len(seen),
            "picks_differing": _picks_differ(seen, ref[arch]["routing"]),
            "picks_sha1": _sha1(torch, torch.cat(
                [e["idx"].reshape(-1) for e in seen])),
            "heads": sorted(set(heads)), "n_heads": cfg.n_heads,
            "b11_fwd_launches": len(heads),
            "launches": dict(build.launches),
            "model_all_gathers": gathers.get("model", 0),
            "model_all_gathers_want": want, "gathered_leaves": still,
            "collectives": _mesh_stats(mesh, MESH_MOE_CHECK_ROUNDS),
            "partition": {k: getattr(plan.part, k)
                          for k in ("heads", "kv", "ff", "vocab", "expert",
                                    "shared_ff")
                          if k != "shared_ff" or cfg.n_shared_experts}}
        del stm, init_m, step_m, seen, Theta1
        _free(torch)
    return out


def _mesh_moe_rank(torch, mesh) -> dict:
    """``llm_mesh_moe`` on one rank: qwen3-moe at full width cut to
    ``MESH_MOE_LAYERS`` in the sketched mode on ``mesh``, the collectives
    and the codec timed, the routing recorded; then one more round under
    ``torch.profiler`` for the dispatch's and the combine's device ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    from repro_torch.kernels import build
    from repro_torch.launch.trace_analysis import mesh_collectives
    from repro_torch.models import moe
    from repro_torch.models.partition import partition_for
    from repro_torch.models.registry import packed_param_count
    from repro_torch.train import llm_trainer
    from repro_torch.tree import tree_leaves

    cfg = _llm_cfg(MOE_ARCH, MESH_MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_fn, step = _mesh_sketched_trainer(torch, cfg, mesh, noisy=True,
                                           local_steps=2)
    state = init_fn(SEED)
    batch = _mesh_batch(torch, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    d_s = llm_trainer._sketch_dim(packed_param_count(cfg), SKETCH_RATIO)
    shapes_ok = (tuple(state.lam.re.shape) == (LLM_WORKERS, d_s)
                 and tuple(state.chan.h.re.shape) == (LLM_WORKERS, d_s))
    part = partition_for(cfg, mesh)
    want, still = _gathers_want(state.Theta, init_fn.layout["sspec"], part,
                                MESH_MOE_ROUNDS * LLM_WORKERS * 2, 0)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    codec: dict = {}
    undo = _timed_methods(torch, llm_trainer._SketchGrid,
                          ("encode", "join", "apply_delta"), codec)
    losses, times, finite, heads, picks = [], [], True, [], []
    kept = pairs = 0
    try:
        for r in range(MESH_MOE_ROUNDS):
            held = [state]
            state = None
            t0 = time.perf_counter()
            with _b11_heads(heads), moe.record_routing() as seen:
                state, m = step(held.pop(), batch,
                                key=rng.fold_in(SEED, r + 1))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            finite &= math.isfinite(losses[-1]) and all(
                bool(torch.isfinite(leaf).all())
                for leaf in tree_leaves(state.Theta))
            kept += sum(int(e["kept"].sum()) for e in seen)
            pairs += sum(e["kept"].numel() for e in seen)
            picks.append(_sha1(torch, torch.cat(
                [e["idx"].reshape(-1) for e in seen])))
            del m, seen
    finally:
        undo()
        mesh.timing = False
    launches = dict(build.launches)
    gathers = mesh.stats.get("all_gather", {}).get("axes", {})
    out = {"losses": losses, "round_s": times, "setup_s": setup_s,
           "setup_peak": setup_peak, "finite": finite,
           "shapes_ok": shapes_ok, "d_s": d_s,
           "peak": torch.cuda.max_memory_allocated(), "launches": launches,
           "heads": sorted(set(heads)), "picks_sha1": picks,
           "pairs_dispatched": pairs,
           "pairs_dropped_share": (pairs - kept) / pairs,
           "collectives": _mesh_stats(mesh, MESH_MOE_ROUNDS),
           "counts": mesh_collectives(mesh.stats),
           "codec_ms_per_round": {k: v / MESH_MOE_ROUNDS
                                  for k, v in codec.items()},
           "model_all_gathers": gathers.get("model", 0),
           "model_all_gathers_want": want, "gathered_leaves": still,
           "d_local": init_fn.layout["sspec"].d_local,
           "D": packed_param_count(cfg),
           "partition": {k: getattr(part, k)
                         for k in ("heads", "kv", "ff", "vocab", "expert")}}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch, key=rng.fold_in(SEED, 100))
        torch.cuda.synchronize()
    spans = _trace(prof, MOE_SPANS)["spans"]
    out["spans"] = {name: {"calls": spans[name]["calls"],
                           "device_ms": spans[name]["device_us"] / 1e3}
                    for name in MOE_SPANS}
    del state, step, init_fn, m, prof
    _free(torch)
    return out


def _mesh_rank_main(rank: int, store: str, out_dir: str,
                    refs: dict) -> None:
    """One rank of the mesh phases, spawned by :func:`phase_llm_mesh`: it
    joins the gloo group through ``store``, runs ``llm_mesh_check`` (with
    its pure-data pin), ``llm_mesh_sketched_check``, ``llm_mesh`` on both
    grids, ``llm_mesh_sketched``, ``llm_mesh_moe_check``, ``llm_mesh_moe``,
    ``llm_mesh_cohort_check``, ``serve_mesh``, ``serve_mesh_moe``,
    ``serve_mesh_moe_check``, ``llm_mesh_ssm_check``, ``llm_mesh_ssm``,
    ``serve_mesh_ssm``, ``llm_mesh_hybrid_check``, ``llm_mesh_hybrid``,
    ``serve_mesh_hybrid``, ``llm_mesh_encdec_check``, ``llm_mesh_encdec``
    and ``serve_mesh_encdec`` against the parent's one-device ``refs``, and
    writes its results (or its traceback) to ``out_dir`` after each."""
    import datetime
    import traceback

    sys.path.insert(0, str(SRC))
    import torch

    res = {"rank": rank}

    def dump():
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)

    try:
        from repro_torch.launch.mesh import init_distributed, make_mesh

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["backend"] = init_distributed(
            "cuda", init_method=store, rank=rank, world_size=MESH_RANKS,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
        axes = ("data", "model")

        def on(shape):
            return make_mesh(shape, axes, "cuda")
        res["part_s"] = {}

        def part(key, fn, *args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            res["part_s"][key] = time.perf_counter() - t0
            return out

        res["check"] = part("check", _mesh_check_rank, torch,
                            on(MESH_SHAPES[0]), refs["loss"])
        _free(torch)
        res["pin"] = part("pin", _mesh_pin_rank, torch, on(MESH_PIN_SHAPE))
        dump()
        res["partition"] = part("partition", _mesh_partition_rank, torch,
                                on(MESH_SHAPES[0]))
        dump()
        res["sketched_check"] = part(
            "sketched_check", _mesh_sketched_check_rank, torch,
            on(MESH_SKETCH_SHAPE), refs["sketched"], control=True)
        dump()
        res["runs"] = {}
        for shape in MESH_SHAPES:
            res["runs"][str(shape)] = part(f"runs {shape}", _mesh_run_rank,
                                           torch, on(shape))
            dump()
        res["sketched"] = part("sketched", _mesh_sketched_rank, torch,
                               on(MESH_SKETCH_SHAPE))
        dump()
        res["moe_check"] = part("moe_check", _mesh_moe_check_rank, torch,
                                on(MESH_SHAPES[0]), refs["moe"])
        dump()
        res["moe"] = part("moe", _mesh_moe_rank, torch, on(MESH_SHAPES[0]))
        dump()
        res["cohort"] = part("cohort", _mesh_cohort_rank, torch,
                             on(MESH_PIN_SHAPE), refs["cohort"])
        dump()
        res["serve_mesh"] = part("serve_mesh", _serve_mesh_rank, torch,
                                 on(SERVE_MESH_SHAPE), refs["serve"])
        dump()
        res["serve_mesh_moe"] = part(
            "serve_mesh_moe", _serve_mesh_moe_rank, torch,
            on(SERVE_MESH_SHAPE), refs["serve_moe"])
        dump()
        for tag in CHANNEL_TAGS:
            fam = _channel_family(tag)
            res[f"{tag}_check"] = part(
                f"{tag}_check", _mesh_channels_check_rank, torch,
                on(MESH_SHAPES[0]), refs[tag], fam)
            dump()
            res[tag] = part(tag, _mesh_channels_rank, torch,
                            on(MESH_SHAPES[0]), fam)
            dump()
            res[f"serve_mesh_{tag}"] = part(
                f"serve_mesh_{tag}", _serve_mesh_channels_rank, torch,
                on(SERVE_MESH_SHAPE), refs[f"serve_{tag}"], fam)
            dump()
        torch.distributed.destroy_process_group()
    except Exception:
        res["error"] = traceback.format_exc()
        res["memory_gb"] = {"allocated": torch.cuda.memory_allocated() / 1e9,
                            "peak": torch.cuda.max_memory_allocated() / 1e9,
                            "reserved": torch.cuda.memory_reserved() / 1e9}
    dump()


def _spawn_mesh_ranks(refs: dict):
    """Run :func:`_mesh_rank_main` in ``MESH_RANKS`` spawned processes
    that meet through a file store in a temporary directory; wait for them
    (killing any still alive after ``MESH_TIMEOUT``) and return (each
    rank's results, their exit codes, the wall seconds)."""
    import multiprocessing
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as out_dir:
        store = "file://" + os.path.join(out_dir, "store")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank_main,
                             args=(r, store, out_dir, refs))
                 for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, MESH_TIMEOUT - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        wall_s = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        res = []
        for r in range(MESH_RANKS):
            path = os.path.join(out_dir, f"rank{r}.json")
            require(os.path.exists(path), f"llm_mesh: rank {r} wrote no "
                    f"result (exit codes {codes})")
            with open(path) as f:
                res.append(json.load(f))
    return res, codes, wall_s


def _summed(launch_lists) -> dict:
    out: dict = {}
    for ln in launch_lists:
        for k, v in ln.items():
            out[k] = out.get(k, 0) + v
    return out


def _rank_failures(res, part: str) -> str:
    return "\n".join(f"rank {r['rank']} ({r['memory_gb']}) without "
                     f"{part!r}:\n{r['error']}" for r in res
                     if "error" in r and part not in r)


def phase_llm_mesh(torch):
    """Phases ``llm_mesh_check``, ``llm_mesh_sketched_check``,
    ``llm_mesh``, ``llm_mesh_sketched``, ``llm_mesh_cohort_check``,
    ``serve_mesh``, ``serve_mesh_moe``, ``serve_mesh_moe_check``,
    ``llm_mesh_ssm_check``, ``llm_mesh_ssm``, ``serve_mesh_ssm``,
    ``llm_mesh_hybrid_check``, ``llm_mesh_hybrid``,
    ``serve_mesh_hybrid``, ``llm_mesh_encdec_check``, ``llm_mesh_encdec``
    and ``serve_mesh_encdec``: the replicated and the sketched mode, and
    partitioned serving of every family, on
    (data, model) grids of two ranks
    spawned on the one card,
    gloo between them (``launch.mesh``).  The
    kernels are built already (phase ``build``), so the ranks load them and
    do not race on the build directory.  The parent first runs the
    one-device rounds the checks hold the ranks to (each rank runs the
    full-width pure-data pin's itself), frees them, then waits for its
    ranks (killing them after ``MESH_TIMEOUT``), and gates their results.
    Returns each phase's launches, summed over the ranks, and each rank's
    collectives (calls and bytes by op) in ``llm_mesh`` on each grid and in
    ``llm_mesh_sketched``."""
    import tempfile

    refs: dict = {"seconds": {}}

    def ref(key, fn, *args):
        t0 = time.perf_counter()
        refs[key] = fn(torch, *args)
        _free(torch)
        refs["seconds"][key] = time.perf_counter() - t0

    ref("loss", _mesh_check_reference)
    ref("sketched", _mesh_sketched_reference)
    ref("cohort", _mesh_cohort_reference)
    ref("moe", _mesh_moe_reference)
    fams = [_channel_family(tag) for tag in CHANNEL_TAGS]
    for fam in fams:
        ref(fam["tag"], _free_running_reference, fam["check_cfg"],
            MESH_SSM_CHECK_ROUNDS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as ref_dir:
        ref("serve", _serve_mesh_reference, ref_dir)
        ref("serve_moe", _serve_mesh_moe_reference, ref_dir)
        for fam in fams:
            ref(f"serve_{fam['tag']}", _serve_mesh_channels_reference,
                ref_dir, fam)
        # the ranks share the card with this process: it holds no tensor
        res, exit_codes, wall_s = _spawn_mesh_ranks(refs)
    loss_ref = refs["loss"]
    for part in ("check", "pin"):
        require(all(part in r for r in res), f"llm_mesh_check: a rank "
                f"failed:\n" + _rank_failures(res, part))

    # llm_mesh_check: the (1, 2) round, then the (2, 1) pin
    chk = [r["check"] for r in res]
    c0 = chk[0]
    shapes = _mesh_round_shapes()
    for r, c in enumerate(chk):
        require((LLM_WORKERS, c["d_local"]) == shapes[0], f"llm_mesh_check: "
                f"a rank's block (2, {c['d_local']}) is not the kernel rows' "
                f"{shapes[0]}")
        require(c["loss"] == c0["loss"], f"llm_mesh_check: rank {r}'s "
                f"round-1 loss {c['loss']} is not rank 0's {c0['loss']} bit "
                f"for bit")
        require(abs(c["loss"] - loss_ref) <= MESH_LOSS_RTOL * abs(loss_ref),
                f"llm_mesh_check: rank {r}'s round-1 loss {c['loss']} is "
                f"not within {MESH_LOSS_RTOL} relative of the one-device "
                f"trainer's {loss_ref}")
        _per_round(dict(c["launches"]), 1, dict(
            {k: v * MESH_CHECK_STEPS // 2 for k, v in LLM_FLASH_1.items()},
            **MESH_ROUND_LAUNCHES))
    ia_rel = abs(c0["inv_alpha_mesh"] - c0["inv_alpha_ref"]) / abs(
        c0["inv_alpha_ref"])
    errs = {k: c0[k] for k in ("theta_err", "lam_re_err", "lam_im_err")}
    pins = [r["pin"] for r in res]
    for r, pin in enumerate(pins):
        tag = f"llm_mesh_check pure-data pin rank {r}"
        require((pin["W_local"], pin["d_local"]) in shapes, f"{tag}: block "
                f"({pin['W_local']}, {pin['d_local']}) is not one of the "
                f"kernel rows' {shapes}")
        require(pin["loss_rel_err"] <= MESH_PIN_RTOL
                and pin["inv_alpha_rel_err"] <= MESH_PIN_RTOL
                and all(pin[f"{k}_over_rtol"] <= 1.0
                        for k in ("Theta", "theta", "lam")),
                f"{tag}: the (2, 1) rounds differ from one device's beyond "
                f"rtol {MESH_PIN_RTOL}: {pin}")
        require(pin["bits_equal"]["h"], f"{tag}: the rank's h is not its "
                f"rows of one device's h")
        require(pin["losses"] == pins[0]["losses"], f"{tag}: losses "
                f"{pin['losses']} are not rank 0's {pins[0]['losses']}")
        _per_round(dict(pin["launches"]), MESH_PIN_ROUNDS,
                   dict(LLM_FLASH_1, **MESH_ROUND_LAUNCHES))
    check = {"phase": "llm_mesh_check", "ok": True, "arch": LLM_ARCH,
             "reduced": {"n_layers": f"36 -> {ROBUST_LAYERS}"},
             "grid": {"data": 1, "model": 2}, "ranks": MESH_RANKS,
             "backend": res[0]["backend"], "staged_collectives":
             STAGED_COLLECTIVES, "D": c0["D"],
             "d_pad": c0["d_pad"], "d_local": c0["d_local"],
             "W": LLM_WORKERS, "seq": LLM_SEQ,
             "local_steps": MESH_CHECK_STEPS, "noisy": False,
             "power_control": True, "loss": [c["loss"] for c in chk],
             "loss_one_device": loss_ref,
             "loss_rel_gap": abs(c0["loss"] - loss_ref) / abs(loss_ref),
             "loss_rtol": MESH_LOSS_RTOL, "ranks_loss_bits_equal": True,
             "loss_bits_equal_one_device": c0["loss"] == loss_ref,
             "round_s": [c["round_s"] for c in chk],
             "peak_mem_gb": [c["peak"] / 1e9 for c in chk],
             "inv_alpha_mesh": c0["inv_alpha_mesh"],
             "inv_alpha_one_rank": c0["inv_alpha_ref"],
             "inv_alpha_rel_diff": ia_rel,
             **{f"{k}_max_abs": v[0] for k, v in errs.items()},
             **{f"{k}_over_rtol": v[1] for k, v in errs.items()},
             "bitwise_equal": {k: c0[f"{k}_bits_equal"]
                               for k in ("theta", "lam_re", "lam_im")},
             "collectives": [c["collectives"] for c in chk],
             "launches": [c["launches"] for c in chk],
             "pure_data_pin": {
                 "grid": dict(zip(("data", "model"), MESH_PIN_SHAPE)),
                 "rounds": MESH_PIN_ROUNDS, "local_steps": MESH_PIN_STEPS,
                 "noisy": False, "rtol": MESH_PIN_RTOL,
                 "ranks": [{k: v for k, v in pin.items() if k != "launches"}
                           for pin in pins],
                 "launches": [pin["launches"] for pin in pins]}}
    require(all(v[1] <= 1.0 for v in errs.values())
            and ia_rel <= LEAFWISE_RTOL,
            f"llm_mesh_check: the mesh round and the one-rank packed round "
            f"differ beyond rtol {LEAFWISE_RTOL}: {check}")
    emit(check)

    # llm_mesh_partition_check
    require(all("partition" in r for r in res),
            "llm_mesh_partition_check: a rank failed:\n"
            + _rank_failures(res, "partition"))
    pc = [r["partition"] for r in res]
    for arch in MESH_PART_ARCHS:
        for r, c in enumerate(p[arch] for p in pc):
            tag = f"llm_mesh_partition_check {arch} rank {r}"
            require(c["losses"] == pc[0][arch]["losses"], f"{tag}: losses "
                    f"{c['losses']} are not rank 0's "
                    f"{pc[0][arch]['losses']} bit for bit")
            require(c["loss_rel_err"] <= MESH_PART_LOSS_RTOL, f"{tag}: the "
                    f"losses {c['losses']} differ from one device's "
                    f"{c['losses_one_device']} beyond rtol "
                    f"{MESH_PART_LOSS_RTOL}")
            require(c["Theta_over_atol"] <= 1.0, f"{tag}: Θ differs from one "
                    f"device's block by {c['Theta_max_abs']}, beyond atol "
                    f"{MESH_PART_THETA_ATOL}")
            require(all(c["partition"].values()), f"{tag}: the plan does "
                    f"not partition every product: {c['partition']}")
            require(c["heads"] == [c["n_heads"] // MESH_RANKS]
                    and c["b11_fwd_launches"] > 0, f"{tag}: B11 ran on "
                    f"{c['heads']} heads, not {c['n_heads'] // MESH_RANKS}")
            require(c["gathered_whole"] and c["model_all_gathers"]
                    == c["model_all_gathers_want"], f"{tag}: "
                    f"{c['model_all_gathers']} all-gathers over model, "
                    f"want {c['model_all_gathers_want']} (the leaves "
                    f"{c['gathered_leaves']} once a forward)")
        for r, c in enumerate(p[f"sketched {arch}"] for p in pc):
            tag = f"llm_mesh_partition_check sketched {arch} rank {r}"
            c0 = pc[0][f"sketched {arch}"]
            require(c["loss"] == c0["loss"] and abs(
                c["loss"] - c["loss_one_device"]) <= MESH_PART_LOSS_RTOL
                * abs(c["loss_one_device"]), f"{tag}: loss {c['loss']} "
                f"(rank 0 {c0['loss']}, one device "
                f"{c['loss_one_device']})")
            require(c["Theta_s_sha1"] == c0["Theta_s_sha1"], f"{tag}: Θ_s "
                    f"is not rank 0's bit for bit")
            require(c["Theta_s_over_atol"] <= 1.0, f"{tag}: Θ_s differs "
                    f"from one device's by {c['Theta_s_max_abs']}, beyond "
                    f"atol {MESH_SKETCH_THETA_S_ATOL}")
            require(c["Theta_max_abs"] <= MESH_PART_THETA_ATOL, f"{tag}: "
                    f"the decoded Θ shard differs from one device's slice by "
                    f"{c['Theta_max_abs']}, beyond atol "
                    f"{MESH_PART_THETA_ATOL}")
    emit({"phase": "llm_mesh_partition_check", "ok": True,
          "archs": list(MESH_PART_ARCHS),
          "reduced": "ModelConfig.reduced(): 2 layers, d_model 128",
          "dtype": "float32", "grid": {"data": 1, "model": 2},
          "W": LLM_WORKERS, "batch": SKETCH_CHECK_B, "seq": SKETCH_CHECK_S,
          "local_steps": 2, "local_lr": 1e-2, "noisy": False,
          "rounds": MESH_PART_ROUNDS, "loss_rtol": MESH_PART_LOSS_RTOL,
          "Theta_atol": MESH_PART_THETA_ATOL,
          "sketched": {"local_steps": 1, "sketch_ratio": SKETCH_RATIO,
                       "seq": LLM_SEQ, "Theta_s_atol":
                       MESH_SKETCH_THETA_S_ATOL, "Theta_atol":
                       MESH_PART_THETA_ATOL},
          "ranks": [{a: {k: v for k, v in p[a].items()
                         if k not in ("launches", "collectives")}
                     for a in p} for p in pc]})

    # llm_mesh_sketched_check
    require(all("sketched_check" in r for r in res),
            "llm_mesh_sketched_check: a rank failed:\n"
            + _rank_failures(res, "sketched_check"))
    sk = [r["sketched_check"] for r in res]
    cfg1 = _llm_cfg(LLM_ARCH, ROBUST_LAYERS)
    for r, c in enumerate(sk):
        tag = f"llm_mesh_sketched_check rank {r}"
        ref_l = refs["sketched"]["loss"]
        require(c["loss"] == sk[0]["loss"], f"{tag}: round-1 loss "
                f"{c['loss']} is not rank 0's {sk[0]['loss']} bit for bit")
        require(abs(c["loss"] - ref_l) <= MESH_LOSS_RTOL * abs(ref_l),
                f"{tag}: round-1 loss {c['loss']} is not within "
                f"{MESH_LOSS_RTOL} relative of one device's {ref_l}")
        require(c["Theta_s_sha1"] == sk[0]["Theta_s_sha1"], f"{tag}: Θ_s "
                f"is not rank 0's bit for bit")
        require(c["Theta_s_rel_l2"] <= MESH_SKETCH_THETA_S_REL_L2
                < c["Theta_s_rel_l2_control"], f"{tag}: Θ_s is "
                f"{c['Theta_s_rel_l2']} from one device's in relative L2, "
                f"the control with rank 1's wo partial dropped "
                f"{c['Theta_s_rel_l2_control']}: the bound "
                f"{MESH_SKETCH_THETA_S_REL_L2} must lie between them")
        require(c["Theta_over_scaled"] <= 1.0, f"{tag}: the decoded Θ shard "
                f"differs from one device's slice by {c['Theta_max_abs']}, "
                f"beyond {MESH_SKETCH_SCALED_RTOL} of a leaf's largest "
                f"magnitude")
        _per_round(dict(c["launches"]), 1,
                   _sketched_launches(cfg1, LLM_WORKERS, 1))
    emit({"phase": "llm_mesh_sketched_check", "ok": True, "arch": LLM_ARCH,
          "reduced": {"n_layers": f"36 -> {ROBUST_LAYERS}"},
          "grid": dict(zip(("data", "model"), MESH_SKETCH_SHAPE)),
          "W": LLM_WORKERS, "seq": LLM_SEQ, "local_steps": 1,
          "sketch_ratio": SKETCH_RATIO, "noisy": False,
          "d_s": sk[0]["lam_shape"][1], "loss_one_device":
          refs["sketched"]["loss"], "loss": [c["loss"] for c in sk],
          "loss_rel_gap": abs(sk[0]["loss"] - refs["sketched"]["loss"])
          / abs(refs["sketched"]["loss"]), "loss_rtol": MESH_LOSS_RTOL,
          "ranks_loss_bits_equal": True,
          "loss_bits_equal_one_device": sk[0]["loss"]
          == refs["sketched"]["loss"],
          "Theta_s_atol": MESH_SKETCH_THETA_S_ATOL,
          "Theta_rtol": MESH_SKETCH_THETA_RTOL,
          "gate_rtol_of_max": MESH_SKETCH_SCALED_RTOL,
          "Theta_s_rel_l2_bound": MESH_SKETCH_THETA_S_REL_L2,
          "Theta_s_rel_l2": sk[0]["Theta_s_rel_l2"],
          "Theta_s_rel_l2_control": [c["Theta_s_rel_l2_control"]
                                     for c in sk],
          "ranks": [{k: v for k, v in c.items() if k != "launches"}
                    for c in sk],
          "launches": [c["launches"] for c in sk]})

    require(all(len(r.get("runs", {})) == len(MESH_SHAPES) for r in res),
            "llm_mesh: a rank failed:\n" + "\n".join(
                f"rank {r['rank']} ({r['memory_gb']}) after "
                f"{sorted(r.get('runs', {}))}:\n{r['error']}"
                for r in res if "error" in r))

    # llm_mesh
    runs = {}
    for shape in MESH_SHAPES:
        per = [r["runs"][str(shape)] for r in res]
        for r, run in enumerate(per):
            tag = f"llm_mesh {shape} rank {r}"
            require((run["W_local"], run["d_local"]) in shapes,
                    f"{tag}: block ({run['W_local']}, {run['d_local']}) is "
                    f"not one of the kernel rows' {shapes[1:]}")
            require(run["losses"][-1] < run["losses"][0],
                    f"{tag}: round {MESH_RUN_ROUNDS} loss "
                    f"{run['losses'][-1]} is "
                    f"not below round 1's {run['losses'][0]}")
            require(run["finite"], f"{tag}: non-finite θ or Θ")
            require(run["losses"] == per[0]["losses"], f"{tag}: losses "
                    f"{run['losses']} are not rank 0's {per[0]['losses']}")
            require(run["peak"] <= MESH_PEAK, f"{tag}: peak "
                    f"{run['peak'] / 1e9} GB above {MESH_PEAK / 1e9} GB")
            _per_round(dict(run["launches"]), MESH_RUN_ROUNDS,
                       {k: v for k, v in LLM_LAUNCHES.items()})
        s_round = statistics.mean(max(per[r]["round_s"][i]
                                      for r in range(MESH_RANKS))
                                  for i in range(1, MESH_RUN_ROUNDS))
        tokens = LLM_WORKERS * LLM_SEQ * 2
        runs[str(shape)] = {
            "grid": dict(zip(("data", "model"), shape)),
            "W_local": per[0]["W_local"], "d_local": per[0]["d_local"],
            "loss": per[0]["losses"], "round_s": [p["round_s"] for p in per],
            "seconds_per_round": s_round, "tokens_per_s": tokens / s_round,
            "setup_s": [p["setup_s"] for p in per],
            "peak_mem_gb": [p["peak"] / 1e9 for p in per],
            "collectives": [p["collectives"] for p in per],
            "launches": [p["launches"] for p in per]}
    emit({"phase": "llm_mesh", "ok": True, "arch": LLM_ARCH,
          "reduced": {"n_layers": f"36 -> {LLM_LAYERS}"},
          "ranks": MESH_RANKS, "backend": res[0]["backend"],
          "staged_collectives": STAGED_COLLECTIVES, "W": LLM_WORKERS,
          "seq": LLM_SEQ, "local_steps": 2, "local_lr": LLM_LR,
          "rounds": MESH_RUN_ROUNDS, "timing": "every collective synchronised "
          "and timed (Mesh.timing)", "grids": runs})

    # llm_mesh_sketched
    require(all("sketched" in r for r in res), "llm_mesh_sketched: a rank "
            "failed:\n" + _rank_failures(res, "sketched"))
    sr = [r["sketched"] for r in res]
    cfg2 = _llm_cfg(LLM_ARCH, MESH_SKETCH_LAYERS)
    for r, run in enumerate(sr):
        tag = f"llm_mesh_sketched rank {r}"
        require(run["shapes_ok"], f"{tag}: λ or h is not ({LLM_WORKERS}, "
                f"{run['d_s']})")
        require(run["finite"], f"{tag}: a loss or Θ is not finite: "
                f"{run['losses']}")
        require(run["losses"] == sr[0]["losses"], f"{tag}: losses "
                f"{run['losses']} are not rank 0's {sr[0]['losses']}")
        require(run["peak"] <= MESH_PEAK, f"{tag}: peak {run['peak'] / 1e9} "
                f"GB above {MESH_PEAK / 1e9} GB")
        _per_round(dict(run["launches"]), MESH_SKETCH_ROUNDS,
                   _sketched_launches(cfg2, LLM_WORKERS, 2))
    s_round = statistics.mean(max(sr[r]["round_s"][i]
                                  for r in range(MESH_RANKS))
                              for i in range(1, MESH_SKETCH_ROUNDS))
    emit({"phase": "llm_mesh_sketched", "ok": True, "arch": LLM_ARCH,
          "reduced": {"n_layers": f"36 -> {MESH_SKETCH_LAYERS}"},
          "grid": dict(zip(("data", "model"), MESH_SKETCH_SHAPE)),
          "ranks": MESH_RANKS, "backend": res[0]["backend"],
          "W": LLM_WORKERS, "seq": LLM_SEQ, "local_steps": 2,
          "local_lr": LLM_LR, "sketch_ratio": SKETCH_RATIO,
          "rounds": MESH_SKETCH_ROUNDS, "D": sr[0]["D"], "d_s": sr[0]["d_s"],
          "d_local": sr[0]["d_local"], "loss": sr[0]["losses"],
          "round_s": [run["round_s"] for run in sr],
          "seconds_per_round": s_round,
          "tokens_per_s": LLM_WORKERS * LLM_SEQ * 2 / s_round,
          "setup_s": [run["setup_s"] for run in sr],
          "peak_mem_gb": [run["peak"] / 1e9 for run in sr],
          "collectives": [run["collectives"] for run in sr],
          "codec_ms_per_round": [run["codec_ms_per_round"] for run in sr],
          "timing": "every collective and codec call synchronised and "
          "timed", "launches": [run["launches"] for run in sr]})

    # llm_mesh_cohort_check
    require(all("cohort" in r for r in res), "llm_mesh_cohort_check: a rank "
            "failed:\n" + _rank_failures(res, "cohort"))
    require(all(c == 0 for c in exit_codes),
            f"llm_mesh: rank exit codes {exit_codes}")
    co = [r["cohort"] for r in res]
    for r, c in enumerate(co):
        require(c["losses"] == co[0]["losses"], f"llm_mesh_cohort_check "
                f"rank {r}: losses {c['losses']} are not rank 0's "
                f"{co[0]['losses']}")
        require(c["loss_rel_err"] <= MESH_COHORT_RTOL
                and all(c[f"{k}_over_rtol_of_max"] <= 1.0
                        for k in ("Theta", "theta", "lam")),
                f"llm_mesh_cohort_check rank {r}: the (2, 1) cohort rounds "
                f"differ from one device's beyond rtol {MESH_COHORT_RTOL}: "
                f"{c}")
        _per_round(dict(c["launches"]), MESH_COHORT_ROUNDS, {
            "flash_attention_fwd": 8, "flash_attention_dq": 4,
            "flash_attention_dkv": 4, **MESH_ROUND_LAUNCHES})
    emit({"phase": "llm_mesh_cohort_check", "ok": True, "arch": LLM_ARCH,
          "reduced": "ModelConfig.reduced(): 2 layers, d_model 128",
          "dtype": "float32", "grid": dict(zip(("data", "model"),
                                               MESH_PIN_SHAPE)),
          **MESH_COHORT, "rounds": MESH_COHORT_ROUNDS,
          "rtol": MESH_COHORT_RTOL, "noisy": False,
          "ranks": [{k: v for k, v in c.items() if k != "launches"}
                    for c in co],
          "launches": [c["launches"] for c in co], "wall_s": wall_s,
          "references_s": refs["seconds"],
          "rank_part_s": [r.get("part_s") for r in res]})

    moe_launches = _gate_mesh_moe(res, refs["moe"])
    serve_launches = _gate_serve_mesh(res, refs["serve"])
    serve_moe_launches = _gate_serve_mesh_moe(res, refs["serve_moe"])
    channel_launches = {}
    for fam in fams:
        channel_launches.update(_gate_mesh_channels(res, refs, fam))

    counts = {str(shape): [r["runs"][str(shape)]["counts"] for r in res]
              for shape in MESH_SHAPES}
    counts["sketched"] = [run["counts"] for run in sr]
    return ({"llm_mesh_check": _summed([c["launches"] for c in chk]
                                       + [p["launches"] for p in pins]),
             "llm_mesh_sketched_check": _summed(c["launches"] for c in sk),
             "llm_mesh": _summed(p["launches"] for r in res
                                 for p in r["runs"].values()),
             "llm_mesh_sketched": _summed(run["launches"] for run in sr),
             "llm_mesh_cohort_check": _summed(c["launches"] for c in co),
             **moe_launches, "serve_mesh": serve_launches,
             **serve_moe_launches, **channel_launches},
            counts)


def _gate_mesh_moe(res: list, ref: dict) -> dict:
    """Phases ``llm_mesh_moe_check`` and ``llm_mesh_moe``: their gates on
    the ranks' results and their lines; returns each phase's launches,
    summed over the ranks."""
    require(all("moe_check" in r for r in res), "llm_mesh_moe_check: a "
            "rank failed:\n" + _rank_failures(res, "moe_check"))
    mc = [r["moe_check"] for r in res]
    for arch in MESH_MOE_ARCHS:
        cfg = _moe_part_cfg(arch)
        for r, c in enumerate(p[arch] for p in mc):
            tag = f"llm_mesh_moe_check {arch} rank {r}"
            require(c["losses"] == mc[0][arch]["losses"], f"{tag}: losses "
                    f"{c['losses']} are not rank 0's "
                    f"{mc[0][arch]['losses']} bit for bit")
            require(c["loss_rel_err"] <= MESH_PART_LOSS_RTOL, f"{tag}: the "
                    f"losses {c['losses']} differ from one device's "
                    f"{c['losses_one_device']} beyond rtol "
                    f"{MESH_PART_LOSS_RTOL}")
            require(c["Theta_over_atol"] <= 1.0, f"{tag}: Θ differs from one "
                    f"device's block by {c['Theta_max_abs']}, beyond atol "
                    f"{MESH_PART_THETA_ATOL}")
            require(c["picks_differing"] == 0 and c["dispatches"] == len(
                ref[arch]["routing"]) and c["picks_sha1"]
                == mc[0][arch]["picks_sha1"], f"{tag}: "
                f"{c['picks_differing']} expert picks or kept pairs differ "
                f"from one device's over {c['dispatches']} dispatches")
            require(all(c["partition"].values()), f"{tag}: the plan does "
                    f"not partition every product: {c['partition']}")
            if not cfg.use_mla:
                require(c["heads"] == [c["n_heads"] // MESH_RANKS]
                        and c["b11_fwd_launches"] > 0, f"{tag}: B11 ran on "
                        f"{c['heads']} heads, not "
                        f"{c['n_heads'] // MESH_RANKS}")
            _per_round(dict(c["launches"]), MESH_MOE_CHECK_ROUNDS,
                       MESH_ROUND_LAUNCHES)
            require(c["model_all_gathers"] == c["model_all_gathers_want"]
                    and not any("mlp/gate" in p or "mlp/up" in p
                                or "mlp/down" in p for p in
                                c["gathered_leaves"]
                                if p.startswith("moe_layers")),
                    f"{tag}: {c['model_all_gathers']} all-gathers over "
                    f"model, want {c['model_all_gathers_want']} (the leaves "
                    f"{c['gathered_leaves']})")
    emit({"phase": "llm_mesh_moe_check", "ok": True,
          "archs": list(MESH_MOE_ARCHS),
          "reduced": "ModelConfig.reduced(): 2 layers, d_model 128, "
          "4 experts top 2", "dtype": "float32",
          "grid": {"data": 1, "model": 2}, "W": LLM_WORKERS,
          "batch": SKETCH_CHECK_B, "seq": SKETCH_CHECK_S, "local_steps": 2,
          "local_lr": 1e-2, "noisy": False, "rounds": MESH_MOE_CHECK_ROUNDS,
          "loss_rtol": MESH_PART_LOSS_RTOL,
          "Theta_atol": MESH_PART_THETA_ATOL,
          "ranks": [{a: {k: v for k, v in p[a].items()
                         if k not in ("launches", "collectives")}
                     for a in p} for p in mc],
          "collectives": [{a: p[a]["collectives"] for a in p} for p in mc],
          "launches": [{a: p[a]["launches"] for a in p} for p in mc]})

    require(all("moe" in r for r in res), "llm_mesh_moe: a rank failed:\n"
            + _rank_failures(res, "moe"))
    mr = [r["moe"] for r in res]
    cfg = _llm_cfg(MOE_ARCH, MESH_MOE_LAYERS)
    for r, run in enumerate(mr):
        tag = f"llm_mesh_moe rank {r}"
        require(run["shapes_ok"] and (LLM_WORKERS, run["d_s"])
                in _mesh_round_shapes(), f"{tag}: λ or h is not "
                f"({LLM_WORKERS}, {run['d_s']}), or not a kernel row's shape")
        require(run["finite"], f"{tag}: a loss or Θ is not finite: "
                f"{run['losses']}")
        require(run["losses"] == mr[0]["losses"]
                and run["picks_sha1"] == mr[0]["picks_sha1"], f"{tag}: "
                f"losses {run['losses']} or picks are not rank 0's")
        require(run["heads"] == [cfg.n_heads // MESH_RANKS], f"{tag}: B11 "
                f"ran on {run['heads']} heads, not "
                f"{cfg.n_heads // MESH_RANKS}")
        require(all(run["partition"].values()), f"{tag}: the plan does not "
                f"partition every product: {run['partition']}")
        require(run["model_all_gathers"] == run["model_all_gathers_want"]
                and not any(p.startswith("moe_layers/mlp/") and
                            p.split("/")[2] in ("gate", "up", "down")
                            for p in run["gathered_leaves"]),
                f"{tag}: {run['model_all_gathers']} all-gathers over model, "
                f"want {run['model_all_gathers_want']} (the leaves "
                f"{run['gathered_leaves']})")
        require(max(run["peak"], run["setup_peak"]) <= MESH_PEAK,
                f"{tag}: peak {run['peak'] / 1e9} GB (set-up "
                f"{run['setup_peak'] / 1e9} GB) above {MESH_PEAK / 1e9} GB")
        _per_round(dict(run["launches"]), MESH_MOE_ROUNDS,
                   _sketched_launches(cfg, LLM_WORKERS, 2))
    s_round = statistics.median(max(mr[r]["round_s"][i]
                                    for r in range(MESH_RANKS))
                                for i in range(1, MESH_MOE_ROUNDS))
    emit({"phase": "llm_mesh_moe", "ok": True, "arch": MOE_ARCH,
          "reduced": {"n_layers": f"48 -> {MESH_MOE_LAYERS}"},
          "grid": {"data": 1, "model": 2}, "ranks": MESH_RANKS,
          "backend": res[0]["backend"], "W": LLM_WORKERS, "seq": LLM_SEQ,
          "local_steps": 2, "local_lr": LLM_LR, "sketch_ratio": SKETCH_RATIO,
          "rounds": MESH_MOE_ROUNDS, "D": mr[0]["D"], "d_s": mr[0]["d_s"],
          "d_local": mr[0]["d_local"], "experts_a_rank":
          cfg.n_experts // MESH_RANKS, "heads_a_rank":
          cfg.n_heads // MESH_RANKS, "loss": mr[0]["losses"],
          "round_s": [run["round_s"] for run in mr],
          "seconds_per_round": s_round,
          "tokens_per_s": LLM_WORKERS * LLM_SEQ * 2 / s_round,
          "setup_s": [run["setup_s"] for run in mr],
          "peak_mem_gb": [run["peak"] / 1e9 for run in mr],
          "setup_peak_mem_gb": [run["setup_peak"] / 1e9 for run in mr],
          "collectives": [run["collectives"] for run in mr],
          "codec_ms_per_round": [run["codec_ms_per_round"] for run in mr],
          "spans_profiled_round": [run["spans"] for run in mr],
          "pairs_dispatched": mr[0]["pairs_dispatched"],
          "pairs_dropped_share": mr[0]["pairs_dropped_share"],
          "model_all_gathers": [run["model_all_gathers"] for run in mr],
          "gathered_leaves": mr[0]["gathered_leaves"],
          "timing": "every collective and codec call synchronised and "
          "timed; the spans from one more round under torch.profiler",
          "launches": [run["launches"] for run in mr]})
    return {"llm_mesh_moe_check": _summed(
                p[a]["launches"] for p in mc for a in MESH_MOE_ARCHS),
            "llm_mesh_moe": _summed(run["launches"] for run in mr)}


def _gate_serve_mesh(res: list, ref: dict) -> dict:
    """Phase ``serve_mesh``'s gates on the ranks' results, and its line;
    returns the launches of its prefill and decode, summed over the
    ranks."""
    from repro_torch.models import get_config

    require(all("serve_mesh" in r for r in res), "serve_mesh: a rank "
            "failed:\n" + _rank_failures(res, "serve_mesh"))
    full = [r["serve_mesh"]["full"] for r in res]
    f0 = full[0]
    bound = [SERVE_MESH_TOL * s for s in ref["max_abs_logit"]]
    # the first step whose one-device top-2 margin (a row's) is below the
    # 2⁻⁶ bound
    low = next((i for i, (mg, b) in enumerate(zip(ref["margin"], bound))
                if min(mg) < b), SERVE_MESH_STEPS)
    errs = [max(f["step_max_abs_err"][i] for f in full)
            for i in range(SERVE_MESH_STEPS)]
    agree = [a == b for a, b in zip(f0["tokens"], f0["tokens_one_device"])]
    # where one device's top-2 margin exceeds twice the step's largest
    # |Δlogit|, the two argmaxes must agree
    sure = [(i, b) for i in range(SERVE_MESH_STEPS)
            for b in range(SERVE_MESH_B) if ref["margin"][i][b] > 2 * errs[i]]
    differ = [(i, b) for i, b in sure
              if f0["tokens"][i][b] != f0["tokens_one_device"][i][b]]
    # the distance of each bf16 run from the same weights in f32
    one32 = ref["one_device_vs_f32"]
    rms = {"prefill": (_rms([f["prefill_vs_f32"] for f in full[:1]]),
                       _rms([one32["prefill"]])),
           "steps": (_rms([e for f in full for e in f["step_vs_f32"]]),
                     _rms(one32["steps"]))}
    ratio = {k: a / b for k, (a, b) in rms.items()}
    cfg = _serve_mesh_cfg()
    n_layers = cfg.n_layers
    for r, f in enumerate(full):
        tag = f"serve_mesh rank {r}"
        require(f["tokens"] == f0["tokens"] and f["prefill_sha1"]
                == f0["prefill_sha1"] and f["step_logits_sha1"]
                == f0["step_logits_sha1"], f"{tag}: the tokens or logits are "
                f"not rank 0's bit for bit")
        require(f["cache_layout"] == "heads", f"{tag}: the cache's layout is "
                f"{f['cache_layout']!r}, not the KV heads'")
        require(f["prefill_launches"] == {"flash_attention_fwd": n_layers}
                and not f["decode_launches"], f"{tag}: prefill launched "
                f"{f['prefill_launches']}, decode {f['decode_launches']}")
        want = [[SERVE_MESH_B, cfg.n_heads // MESH_RANKS, SERVE_MESH_P,
                 cfg.hd]]
        require(f["prefill_b11_shapes"] == want, f"{tag}: B11 ran on "
                f"{f['prefill_b11_shapes']}, not the rank's heads {want}")
        for part in ("prefill_calls", "decode_calls"):
            require("model" not in f[part].get("all_gather", {}),
                    f"{tag}: an all-gather over model of a partitioned leaf "
                    f"in {part}: {f[part]}")
        require(max(f["peak"], f["setup_peak"]) <= MESH_PEAK, f"{tag}: peak "
                f"{f['peak'] / 1e9} GB, set-up {f['setup_peak'] / 1e9} GB, "
                f"above {MESH_PEAK / 1e9} GB")
    require(all(r <= SERVE_MESH_F32_RATIO for r in ratio.values()),
            f"serve_mesh: the mesh's logits are further from the f32 run "
            f"than one device's bf16 logits are, beyond "
            f"{SERVE_MESH_F32_RATIO}× in RMS: {rms}")
    require(not differ, f"serve_mesh: the tokens differ from one device's "
            f"at (step, row) {differ}, where its top-2 margin exceeds twice "
            f"the step's largest |Δlogit|")
    require(all(agree[:low]), f"serve_mesh: the tokens differ from one "
            f"device's at step {agree.index(False)}, before step {low}, the "
            f"first whose one-device top-2 margin is below the bound")
    checks = [r["serve_mesh"]["checks"] for r in res]
    for name, _, _, _ in SERVE_MESH_CHECKS:
        for r, c in enumerate(ch[name] for ch in checks):
            tag = f"serve_mesh check {name} rank {r}"
            require(c["layout"] == SERVE_MESH_LAYOUTS[name], f"{tag}: layout "
                    f"{c['layout']!r}")
            require(max(c["prefill_rel_err"], c["step_rel_err"])
                    <= SERVE_MESH_CHECK_RTOL, f"{tag}: logits "
                    f"{c['prefill_rel_err']} / {c['step_rel_err']} from one "
                    f"device's, beyond {SERVE_MESH_CHECK_RTOL}")
            require(c["tokens_equal"] and c["tokens_sha1"]
                    == checks[0][name]["tokens_sha1"], f"{tag}: the tokens "
                    f"are not one device's, or not rank 0's")
            require(c["cache_rel_err"] <= SERVE_MESH_CHECK_RTOL, f"{tag}: the "
                    f"cache differs from its block of one device's by "
                    f"{c['cache_rel_err']}")
            require("model" not in c["decode_calls"].get("all_gather", {}),
                    f"{tag}: an all-gather over model of a partitioned leaf: "
                    f"{c['decode_calls']}")
    walls = [statistics.median(f["decode_wall_ms"]) for f in full]

    def per_rank(key):
        return [f[key] for f in full]
    emit({"phase": "serve_mesh", "ok": True, "arch": LLM_ARCH,
          "reduced": {"n_layers": f"{get_config(LLM_ARCH).n_layers} -> "
                                  f"{n_layers}"},
          "n_layers": n_layers, "dtype": "bfloat16",
          "grid": dict(zip(("data", "model"), SERVE_MESH_SHAPE)),
          "ranks": MESH_RANKS, "backend": res[0]["backend"],
          "batch": SERVE_MESH_B, "prompt": SERVE_MESH_P,
          "new_tokens": SERVE_MESH_N, "decode_steps": SERVE_MESH_STEPS,
          "inputs": "one device's tokens (teacher forced)",
          "cache_layout": f0["cache_layout"], "cache_block":
          f0["cache_block"], "tol_of_max_logit": SERVE_MESH_TOL,
          "prefill_max_abs_err": f0["prefill_max_abs_err"],
          "prefill_max_abs_logit": f0["prefill_max_abs_logit"],
          "step_max_abs_err": errs, "step_bound": bound,
          "worst_step_err_over_bound": max(e / b for e, b in zip(errs, bound)),
          "prefill_err_over_bound": f0["prefill_max_abs_err"]
          / (SERVE_MESH_TOL * f0["prefill_max_abs_logit"]),
          "rms_vs_f32": {k: {"mesh": a, "one_device": b}
                         for k, (a, b) in rms.items()},
          "rms_vs_f32_ratio": ratio, "f32_ratio_bound": SERVE_MESH_F32_RATIO,
          "max_abs_vs_f32": {
              "mesh_steps": max(e["max_abs"] for f in full
                                for e in f["step_vs_f32"]),
              "one_device_steps": max(e["max_abs"] for e in one32["steps"]),
              "mesh_prefill": f0["prefill_vs_f32"]["max_abs"],
              "one_device_prefill": one32["prefill"]["max_abs"]},
          "first_low_margin_step": low,
          "rows_sure": len(sure), "rows_sure_differ": len(differ),
          "tokens_equal_steps": sum(agree), "tokens_equal_all": all(agree),
          "ranks_bits_equal": True,
          "prefill_ms": per_rank("prefill_ms"),
          "prefill_ms_one_device": ref["prefill_ms"],
          "decode_wall_ms_per_step": walls,
          "decode_wall_ms_per_step_one_device": ref["step_ms"],
          "decode_device_ms_per_step": per_rank("decode_device_ms"),
          "setup_s": per_rank("setup_s"),
          "setup_peak_gb": [f["setup_peak"] / 1e9 for f in full],
          "peak_mem_gb": [f["peak"] / 1e9 for f in full],
          "prefill_collectives": per_rank("prefill_collectives"),
          "decode_collectives_per_step": per_rank("decode_collectives"),
          "prefill_launches": per_rank("prefill_launches"),
          "prefill_b11_shapes": f0["prefill_b11_shapes"],
          "one_device_repeat": per_rank("one_device_repeat"),
          "timing": "every collective synchronised and timed (Mesh.timing)",
          "checks": {"dtype": "float32", "batch": SERVE_MESH_CHECK_B,
                     "rtol": SERVE_MESH_CHECK_RTOL,
                     "cases": {name: {"over": over, "prompt": P,
                                      "new_tokens": N,
                                      "ranks": [ch[name] for ch in checks]}
                               for name, over, P, N in SERVE_MESH_CHECKS}}})
    return _summed([f["prefill_launches"] for f in full]
                   + [f["decode_launches"] for f in full])


# ---------------------------------------------------------------------------
# slice 22: the MoE family's partitioned serving on the (1, 2) grid
# ---------------------------------------------------------------------------

#: ``serve_mesh_moe``: qwen3-moe-30b-a3b at full width (d_model 2,048, 128
#: experts top 8, 32 heads on 4 KV heads, vocabulary 151,936) cut 48 -> 8
#: layers, bf16, served on the (1, 2) grid (each rank 64 experts, 16 heads,
#: 2 KV heads, the cache's "heads" layout, half the vocabulary): the
#: ``serve_mesh`` run (an 8 × 64 prefill, the prompt a token at a time, 16
#: new tokens, the ranks fed one device's tokens) on it
SERVE_MOE_LAYERS = 8
#: ``serve_mesh_moe_check``: the CPU test's four cases in f32 on (1, 2),
#: a batch of ``SERVE_MESH_CHECK_B``: (name, arch, config fields replaced
#: on its reduced config, prompt, new tokens; an even ``max_seq``, so the
#: sequence splits) and each cache's layout: qwen3-moe (the KV heads),
#: with one KV head (the sequence, ``wk``/``wv`` the rank's columns),
#: deepseek-v3 (MLA's latent cache on the sequence; q-LoRA, the shared
#: expert, a dense first layer, MTP) and without q-LoRA
SERVE_MOE_CHECKS = (("qwen3-moe", MOE_ARCH, {}, 8, 8),
                    ("qwen3-moe-kv1", MOE_ARCH, {"n_kv_heads": 1}, 8, 8),
                    ("deepseek-v3", "deepseek-v3-671b", {}, 8, 8),
                    ("deepseek-v3-wq", "deepseek-v3-671b",
                     {"q_lora_rank": 0}, 8, 8))
SERVE_MOE_LAYOUTS = {"qwen3-moe": "heads", "qwen3-moe-kv1": "seq",
                     "deepseek-v3": "seq", "deepseek-v3-wq": "seq"}


def _serve_moe_check_cfg(arch: str, over: dict):
    import dataclasses

    return dataclasses.replace(_moe_part_cfg(arch), **over)


def _routing_host(seen: list) -> list:
    """Each dispatch's picks and kept pairs, on the host."""
    return [{k: e[k].cpu() for k in ("idx", "kept")} for e in seen]


def _dropped(seen: list) -> float:
    """The share of (token, k) pairs the dispatches dropped."""
    kept = sum(int(e["kept"].sum()) for e in seen)
    return 1.0 - kept / max(1, sum(e["kept"].numel() for e in seen))


def _serve_full_reference(torch, cfg, seed: int):
    """One device's full-width serving run the partitioned serving parts
    hold their ranks to: ``cfg`` in bf16 from ``model.init(seed)``, an
    ``SERVE_MESH_B`` × ``SERVE_MESH_P`` prompt (``seed + 1``; the
    enc-dec's stub frames from ``seed + 2``, its cross cache filled from
    them), the prefill's last logits and ``SERVE_MESH_STEPS`` greedy
    steps' logits, inputs and tokens, then the same weights in f32 fed the
    same tokens.
    Returns (the data on the host, the prefill's ms, a step's ms, the bf16
    logits' distance from the f32 run)."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.benchmarks.common import time_ms
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    dev = resolve_device("cuda")
    model = build_model(cfg)
    params = model.init(seed)
    prompts = torch.randint(0, model.cfg.vocab_size,
                            (SERVE_MESH_B, SERVE_MESH_P), device=dev,
                            generator=rng.generator(seed + 1, dev))
    extra = _frontend(torch, model.cfg, (SERVE_MESH_B,),
                      rng.generator(seed + 2, dev))
    batch = {"tokens": prompts, **extra}
    prefill = make_prefill(model)
    last = prefill(params, batch)
    prefill_ms = time_ms(lambda: prefill(params, batch),
                         runs=5, warmup=1, spin=False)
    store: list = []
    step = make_serve_step(_observed(model, store))
    cache = model.init_cache(SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N)
    _fill_cross(step, params, cache, extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = _greedy_run(step, params, cache, prompts, SERVE_MESH_N)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SERVE_MESH_STEPS * 1e3
    logits = torch.stack(store)                       # (steps, B, V)
    feed = torch.cat([prompts[:, :1].T, torch.stack(toks)[:-1]])
    feed[:SERVE_MESH_P] = prompts.T
    m32 = build_model(dataclasses.replace(model.cfg, param_dtype="float32"))
    p32 = tree_map(lambda x: x.float(), params)
    del params, cache, store
    _free(torch)
    last32 = make_prefill(m32)(p32, batch)
    store = []
    c32 = m32.init_cache(SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N)
    step32 = make_serve_step(_observed(m32, store))
    _fill_cross(step32, p32, c32, extra)
    _greedy_run(step32, p32, c32, prompts, SERVE_MESH_N, feed=feed)
    truth = torch.stack(store)
    one_err = {"prefill": _err_stats(last, last32),
               "steps": [_err_stats(a, b) for a, b in zip(logits, truth)]}
    data = {"prompts": prompts.cpu(), "prefill": last.cpu(),
            "logits": logits.cpu(), "tokens": torch.stack(toks).cpu(),
            "feed": feed.cpu(), "prefill_f32": last32.cpu(),
            "logits_f32": truth.cpu(),
            **{k: v.cpu() for k, v in extra.items()}}
    del model, m32, p32, c32, prefill, step, step32, store, logits, last
    del last32, batch, extra
    del toks, truth
    _free(torch)
    return data, prefill_ms, step_ms, one_err


def _serve_mesh_moe_reference(torch, ref_dir: str) -> dict:
    """One device's runs ``serve_mesh_moe`` and ``serve_mesh_moe_check``
    hold the ranks to, saved to ``ref_dir``: qwen3-moe (bf16, 8 layers):
    the prefill's last logits, every step's logits, the inputs and greedy
    tokens, and the same weights in f32 fed the same tokens; each reduced
    f32 check's prefill, step logits, tokens, final cache and every
    dispatch's picks and kept pairs.  Returns the file's path, the
    one-device times and its bf16 logits' distance from the f32 run."""
    from repro_torch import rng
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model, moe
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    data, prefill_ms, step_ms, one_err = _serve_full_reference(
        torch, _llm_cfg(MOE_ARCH, SERVE_MOE_LAYERS), SEED + 30)
    t_checks = time.perf_counter()
    for name, arch, over, P, N in SERVE_MOE_CHECKS:
        m = build_model(_serve_moe_check_cfg(arch, over))
        p = m.init(SEED + 32)
        pr = torch.randint(0, m.cfg.vocab_size, (SERVE_MESH_CHECK_B, P),
                           device=dev, generator=rng.generator(SEED + 33,
                                                               dev))
        st: list = []
        with moe.record_routing() as seen:
            last = make_prefill(m)(p, {"tokens": pr})
            c = m.init_cache(SERVE_MESH_CHECK_B, P + N)
            tk, c = _greedy_run(make_serve_step(_observed(m, st)), p, c,
                                pr, N)
        data[name] = {"prompts": pr.cpu(), "prefill": last.cpu(),
                      "logits": torch.stack(st).cpu(),
                      "tokens": torch.stack(tk).cpu(),
                      "cache": tree_map(lambda x: x.cpu(), c),
                      "routing": _routing_host(seen)}
        del m, p, c, st, last, tk, seen
    _free(torch)
    path = os.path.join(ref_dir, "serve_mesh_moe_reference.pt")
    torch.save(data, path)
    return {"path": path, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "one_device_vs_f32": one_err,
            "seconds": {"full": t_checks - t_start,
                        "checks": time.perf_counter() - t_checks}}


def _serve_mesh_moe_full(torch, mesh, data: dict) -> dict:
    """``serve_mesh_moe`` on one rank: qwen3-moe at full width cut to
    ``SERVE_MOE_LAYERS`` on ``mesh``, its prefill and its teacher-forced
    greedy steps against one device's (and the f32 run's), timed, with the
    mesh's collectives, B11's launches and shapes, the dispatches' dropped
    share and the rank's peaks."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import build_model, layers, moe
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    dev = resolve_device("cuda")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(_llm_cfg(MOE_ARCH, SERVE_MOE_LAYERS))
    t0 = time.perf_counter()
    full = model.init(SEED + 30)
    prompts = data["prompts"].to(dev)
    store: list = []
    step = make_serve_step(_observed(model, store), mesh)
    prefill = make_prefill(model, mesh)
    params = step.shard(full)
    # the prefill's plan from the shapes alone: the blocks are the step's
    prefill.shard(tree_map(lambda x: x.to("meta"), full))
    del full
    cache = step.init_cache(SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _free(torch)
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    batch = {"tokens": prompts}
    b11_shapes = []
    b11 = layers.flash_attention

    def recorded(q, *args, **kwargs):
        b11_shapes.append(list(q.shape))
        return b11(q, *args, **kwargs)
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    layers.flash_attention = recorded
    try:
        with moe.record_routing() as seen_pre:
            last = prefill(params, batch)
    finally:
        layers.flash_attention = b11
    torch.cuda.synchronize()
    mesh.timing = False
    pre_launches = {k: v for k, v in build.launches.items() if v}
    pre_stats = _mesh_stats(mesh, 1)
    pre_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    times = []
    for _ in range(SERVE_MESH_PREFILL_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)

    feed = data["feed"].to(dev)
    step_s = []

    def tick(i):
        torch.cuda.synchronize()
        step_s.append(time.perf_counter())
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with moe.record_routing() as seen_dec:
        toks, cache = _greedy_run(step, params, cache, prompts,
                                  SERVE_MESH_N, feed=feed, every=tick)
    mesh.timing = False
    dec_launches = {k: v for k, v in build.launches.items() if v}
    dec_stats = _mesh_stats(mesh, SERVE_MESH_STEPS)
    dec_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    walls = [(b - a) * 1e3 for a, b in zip([t1] + step_s[:-1], step_s)]
    peak = torch.cuda.max_memory_allocated()
    j = mesh.axis_index("model")
    local = torch.stack(store)
    vl = local.shape[-1]
    cols = slice(j * vl, (j + 1) * vl)
    errs, errs32 = [], []
    for i in range(SERVE_MESH_STEPS):
        errs.append(float((local[i].float() - data["logits"][i][:, cols]
                           .to(dev).float()).abs().max()))
        errs32.append(_err_stats(local[i],
                                 data["logits_f32"][i][:, cols].to(dev)))
    tokens = torch.stack(toks).cpu()
    gathered = mesh.all_gather(local, "model", -1, op="gather_vocab")
    part = step.layout["cache_part"]
    out = {"prefill_max_abs_err": float((last.float() - data["prefill"].to(
               dev).float()).abs().max()),
           "prefill_sha1": _sha1(torch, last),
           "step_logits_sha1": _sha1(torch, gathered),
           "step_max_abs_err": errs, "step_vs_f32": errs32,
           "prefill_vs_f32": _err_stats(last, data["prefill_f32"].to(dev)),
           "tokens_sha1": _sha1(torch, torch.stack(toks)),
           "tokens_equal_one_device": float(
               (tokens == data["tokens"]).float().mean()),
           "prefill_launches": pre_launches, "decode_launches": dec_launches,
           "prefill_b11_shapes": sorted(map(list, {tuple(x)
                                                   for x in b11_shapes})),
           "prefill_collectives": pre_stats, "prefill_calls": pre_calls,
           "decode_collectives": dec_stats, "decode_calls": dec_calls,
           "prefill_ms": times, "decode_wall_ms": walls,
           "setup_s": setup_s, "setup_peak": setup_peak, "peak": peak,
           "cache_layout": step.layout["cache"],
           "cache_block": list(cache["moe"]["k"].shape),
           "proj_cols": list(part.proj_cols),
           "experts_local": int(params["moe_layers"]["mlp"]["gate"]
                                .shape[1]),
           "picks_sha1": _sha1(torch, torch.cat(
               [e["idx"].reshape(-1) for e in seen_pre + seen_dec])),
           "dropped_prefill": _dropped(seen_pre),
           "dropped_decode": _dropped(seen_dec),
           "dispatches": [len(seen_pre), len(seen_dec)]}
    del gathered, local, store, seen_pre, seen_dec
    out["decode_device_ms"] = _kernel_ms(
        torch, lambda: step(params, cache, feed[-1], SERVE_MESH_STEPS - 1))
    del params, cache, last, model, step, prefill
    _free(torch)
    return out


def _serve_mesh_moe_check(torch, mesh, data: dict, arch: str, over: dict,
                          P: int, N: int) -> dict:
    """``serve_mesh_moe_check`` on one rank: a reduced f32 case served
    greedily on ``mesh`` against one device's run on the card: the
    prefill's and every step's logits (the rank's vocab columns), the
    tokens, every dispatch's picks and kept pairs, and the rank's cache
    against its block of one device's."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.shardings import shard_leaf
    from repro_torch.models import build_model, moe
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_leaves, tree_map

    dev = resolve_device("cuda")
    m = build_model(_serve_moe_check_cfg(arch, over))
    full = m.init(SEED + 32)
    prompts = data["prompts"].to(dev)
    store: list = []
    prefill = make_prefill(m, mesh)
    step = make_serve_step(_observed(m, store), mesh)
    params = step.shard(full)
    cache = step.init_cache(SERVE_MESH_CHECK_B, P + N)
    mesh.reset_stats()
    with moe.record_routing() as seen:
        last = prefill(prefill.shard(full), {"tokens": prompts})
        pre_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
        mesh.reset_stats()
        toks, cache = _greedy_run(step, params, cache, prompts, N)
    calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}

    def scaled(a, b):
        b = b.to(dev).float()
        return float((a.float() - b).abs().max() / b.abs().max())
    j = mesh.axis_index("model")
    vl = store[0].shape[-1]
    blocks = tree_map(lambda x, sp: shard_leaf(x, sp, mesh), data["cache"],
                      step.layout["cache_specs"])
    out = {"layout": step.layout["cache"],
           "cache_block": list(tree_leaves(cache)[0].shape),
           "prefill_rel_err": scaled(last, data["prefill"]),
           "step_rel_err": max(scaled(x, y[:, j * vl:(j + 1) * vl])
                               for x, y in zip(store, data["logits"])),
           "cache_rel_err": max(scaled(a, b) for a, b in zip(
               tree_leaves(cache), tree_leaves(blocks))),
           "tokens_equal": bool(torch.equal(torch.stack(toks).cpu(),
                                            data["tokens"])),
           "tokens_sha1": _sha1(torch, torch.stack(toks)),
           "dispatches": len(seen),
           "picks_differing": _picks_differ(seen, [
               {k: e[k].numpy() for k in ("idx", "kept")}
               for e in data["routing"]]),
           "prefill_calls": pre_calls, "decode_calls": calls}
    del m, full, params, cache, store, last, seen
    return out


def _serve_mesh_moe_rank(torch, mesh, ref: dict) -> dict:
    """Phases ``serve_mesh_moe`` and ``serve_mesh_moe_check`` on one
    rank."""
    t0 = time.perf_counter()
    data = torch.load(ref["path"])
    out = {"full": _serve_mesh_moe_full(torch, mesh, data)}
    t1 = time.perf_counter()
    out["checks"] = {name: _serve_mesh_moe_check(torch, mesh, data[name],
                                                 arch, over, P, N)
                     for name, arch, over, P, N in SERVE_MOE_CHECKS}
    _free(torch)
    out["seconds"] = {"full": t1 - t0, "checks": time.perf_counter() - t1}
    return out


def _gate_serve_mesh_moe(res: list, ref: dict) -> dict:
    """Phases ``serve_mesh_moe`` and ``serve_mesh_moe_check``: their gates
    on the ranks' results and their lines; returns each phase's launches,
    summed over the ranks."""
    cfg = _llm_cfg(MOE_ARCH, SERVE_MOE_LAYERS)
    require(all("serve_mesh_moe" in r for r in res), "serve_mesh_moe: a "
            "rank failed:\n" + _rank_failures(res, "serve_mesh_moe"))
    full = [r["serve_mesh_moe"]["full"] for r in res]
    f0 = full[0]
    one32 = ref["one_device_vs_f32"]
    rms = {"prefill": (_rms([f["prefill_vs_f32"] for f in full[:1]]),
                       _rms([one32["prefill"]])),
           "steps": (_rms([e for f in full for e in f["step_vs_f32"]]),
                     _rms(one32["steps"]))}
    ratio = {k: a / b for k, (a, b) in rms.items()}
    L, n = cfg.n_layers, MESH_RANKS
    for r, f in enumerate(full):
        tag = f"serve_mesh_moe rank {r}"
        require(all(f[k] == f0[k] for k in (
            "tokens_sha1", "prefill_sha1", "step_logits_sha1",
            "picks_sha1")), f"{tag}: the tokens, logits or expert picks are "
                f"not rank 0's bit for bit")
        require(f["cache_layout"] == "heads" and f["cache_block"] == [
            L, SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N,
            cfg.n_kv_heads // n, cfg.hd], f"{tag}: the cache's layout "
            f"{f['cache_layout']!r}, block {f['cache_block']}")
        require(f["experts_local"] == cfg.n_experts // n
                and f["proj_cols"] == ["router"], f"{tag}: the rank holds "
                f"{f['experts_local']} experts, decode keeps the columns of "
                f"{f['proj_cols']}")
        require(f["prefill_launches"] == {"flash_attention_fwd": L}
                and not f["decode_launches"], f"{tag}: prefill launched "
                f"{f['prefill_launches']}, decode {f['decode_launches']}")
        want = [[SERVE_MESH_B, cfg.n_heads // n, SERVE_MESH_P, cfg.hd]]
        require(f["prefill_b11_shapes"] == want, f"{tag}: B11 ran on "
                f"{f['prefill_b11_shapes']}, not the rank's heads {want}")
        # the prefill gathers each layer's router alone; decode no leaf
        require(f["prefill_calls"].get("all_gather") == {"model": L}
                and "all_gather" not in f["decode_calls"], f"{tag}: "
                f"parameter all-gathers in the prefill "
                f"{f['prefill_calls'].get('all_gather')}, in decode "
                f"{f['decode_calls'].get('all_gather')}")
        require(max(f["peak"], f["setup_peak"]) <= MESH_PEAK, f"{tag}: peak "
                f"{f['peak'] / 1e9} GB, set-up {f['setup_peak'] / 1e9} GB, "
                f"above {MESH_PEAK / 1e9} GB")
    require(all(x <= SERVE_MESH_F32_RATIO for x in ratio.values()),
            f"serve_mesh_moe: the mesh's logits are further from the f32 run "
            f"than one device's bf16 logits are, beyond "
            f"{SERVE_MESH_F32_RATIO}× in RMS: {rms}")
    walls = [statistics.median(f["decode_wall_ms"]) for f in full]

    def per_rank(key):
        return [f[key] for f in full]
    emit({"phase": "serve_mesh_moe", "ok": True, "arch": MOE_ARCH,
          "n_layers": L, "reduced": f"depth only: {L} of 48 layers",
          "dtype": "bfloat16",
          "grid": dict(zip(("data", "model"), SERVE_MESH_SHAPE)),
          "ranks": MESH_RANKS, "backend": res[0]["backend"],
          "batch": SERVE_MESH_B, "prompt": SERVE_MESH_P,
          "new_tokens": SERVE_MESH_N, "decode_steps": SERVE_MESH_STEPS,
          "inputs": "one device's tokens (teacher forced)",
          "experts_local": f0["experts_local"],
          "proj_cols": f0["proj_cols"], "cache_layout": f0["cache_layout"],
          "cache_block": f0["cache_block"],
          "prefill_max_abs_err": f0["prefill_max_abs_err"],
          "step_max_abs_err": [max(f["step_max_abs_err"][i] for f in full)
                               for i in range(SERVE_MESH_STEPS)],
          "rms_vs_f32": {k: {"mesh": a, "one_device": b}
                         for k, (a, b) in rms.items()},
          "rms_vs_f32_ratio": ratio, "f32_ratio_bound": SERVE_MESH_F32_RATIO,
          "tokens_equal_one_device": f0["tokens_equal_one_device"],
          "ranks_bits_equal": True,
          "prefill_ms": per_rank("prefill_ms"),
          "prefill_ms_one_device": ref["prefill_ms"],
          "decode_wall_ms_per_step": walls,
          "decode_wall_ms_per_step_one_device": ref["step_ms"],
          "decode_device_ms_per_step": per_rank("decode_device_ms"),
          "setup_s": per_rank("setup_s"),
          "setup_peak_gb": [f["setup_peak"] / 1e9 for f in full],
          "peak_mem_gb": [f["peak"] / 1e9 for f in full],
          "prefill_collectives": per_rank("prefill_collectives"),
          "decode_collectives_per_step": per_rank("decode_collectives"),
          "dropped_share": {"prefill": f0["dropped_prefill"],
                            "decode": f0["dropped_decode"]},
          "dispatches": f0["dispatches"],
          "prefill_launches": per_rank("prefill_launches"),
          "prefill_b11_shapes": f0["prefill_b11_shapes"],
          "seconds": {"one_device_reference": ref["seconds"]["full"],
                      "ranks": [r["serve_mesh_moe"]["seconds"]["full"]
                                for r in res]},
          "timing": "every collective synchronised and timed (Mesh.timing)"})

    checks = [r["serve_mesh_moe"]["checks"] for r in res]
    for name, arch, over, P, N in SERVE_MOE_CHECKS:
        c_cfg = _serve_moe_check_cfg(arch, over)
        nm = c_cfg.n_layers - c_cfg.first_dense_layers
        # the prefill's parameter gathers: each layer's wq_a and wkv_a
        # (MLA), each MoE layer's router; never an MTP leaf
        gathers = (c_cfg.n_layers * (1 + bool(c_cfg.q_lora_rank))
                   * c_cfg.use_mla + nm)
        for r, c in enumerate(ch[name] for ch in checks):
            tag = f"serve_mesh_moe_check {name} rank {r}"
            require(c["layout"] == SERVE_MOE_LAYOUTS[name], f"{tag}: layout "
                    f"{c['layout']!r}")
            require(max(c["prefill_rel_err"], c["step_rel_err"])
                    <= SERVE_MESH_CHECK_RTOL, f"{tag}: logits "
                    f"{c['prefill_rel_err']} / {c['step_rel_err']} from one "
                    f"device's, beyond {SERVE_MESH_CHECK_RTOL}")
            require(c["tokens_equal"] and c["tokens_sha1"]
                    == checks[0][name]["tokens_sha1"], f"{tag}: the tokens "
                    f"are not one device's, or not rank 0's")
            require(c["cache_rel_err"] <= SERVE_MESH_CHECK_RTOL, f"{tag}: the "
                    f"cache differs from its block of one device's by "
                    f"{c['cache_rel_err']}")
            require(c["picks_differing"] == 0 and c["dispatches"]
                    == nm * (P + N), f"{tag}: {c['picks_differing']} picks "
                    f"or kept pairs differ from one device's over "
                    f"{c['dispatches']} dispatches")
            require(c["prefill_calls"].get("all_gather") == {"model": gathers}
                    and "all_gather" not in c["decode_calls"], f"{tag}: "
                    f"parameter all-gathers in the prefill "
                    f"{c['prefill_calls'].get('all_gather')} (want "
                    f"{gathers}), in decode "
                    f"{c['decode_calls'].get('all_gather')}")
    emit({"phase": "serve_mesh_moe_check", "ok": True, "dtype": "float32",
          "grid": dict(zip(("data", "model"), SERVE_MESH_SHAPE)),
          "batch": SERVE_MESH_CHECK_B, "rtol": SERVE_MESH_CHECK_RTOL,
          "seconds": {"one_device_reference": ref["seconds"]["checks"],
                      "ranks": [r["serve_mesh_moe"]["seconds"]["checks"]
                                for r in res]},
          "reduced": "ModelConfig.reduced()",
          "cases": {name: {"arch": arch, "over": over, "prompt": P,
                           "new_tokens": N,
                           "ranks": [ch[name] for ch in checks]}
                    for name, arch, over, P, N in SERVE_MOE_CHECKS}})
    return {"serve_mesh_moe": _summed([f["prefill_launches"] for f in full]
                                      + [f["decode_launches"]
                                         for f in full]),
            "serve_mesh_moe_check": {}}


# ---------------------------------------------------------------------------
# the SSM and hybrid families partitioned on the model axis by their
# channels, and the enc-dec by its heads: llm_mesh_<tag>_check,
# llm_mesh_<tag> and serve_mesh_<tag> for ssm, hybrid and encdec
# ---------------------------------------------------------------------------

#: ``llm_mesh_ssm_check``: reduced falcon-mamba-7b (d_inner 256, x_proj 24
#: wide, dt_rank 8) in f32 on (1, 2), W = 2, 2 sgd steps at 1e-2,
#: noise-free, 3 replicated rounds from one device's init and h, against
#: the parent's one-device rounds on the card: each round's loss rtol 1e-5,
#: Θ atol 1e-5 (``llm_mesh_partition_check``'s bars), the ranks' losses
#: bit-equal, B12 forward and backward on the rank's channels (W·B, S,
#: d_inner/2 · n), B6, B3 and B4 once a round a rank, and no all-gather
#: over ``model`` but of ``x_proj``, ``dt_proj`` and ``dt_proj``'s bias
MESH_SSM_CHECK_ROUNDS = 3
#: ``llm_mesh_ssm``: falcon-mamba-7b at full width (d_model 4,096, d_inner
#: 8,192, vocabulary 65,024, bf16) cut 64 -> 2 layers, replicated on (1,
#: 2) (each rank 4,096 channels and half the vocabulary), W = 2, 1 × 4,096
#: tokens a worker, 2 sgd steps at ``SSM_LR``, ``MESH_RUN_ROUNDS`` rounds
MESH_SSM_LAYERS = 2
#: ``serve_mesh_ssm``: falcon-mamba-7b in bf16 at full width, 8 of 64
#: layers, ``serve_mesh``'s 8 × 64 prefill and 79 greedy steps fed one
#: device's tokens; then reduced f32 falcon-mamba, a batch of
#: ``SERVE_MESH_CHECK_B``, a prompt of 8 and 8 new tokens
SERVE_SSM_LAYERS = 8
SERVE_SSM_CHECK_P, SERVE_SSM_CHECK_N = 8, 8
#: the leaves the SSM's partitioned training still gathers over ``model``
#: (decode: ``dt_proj``'s bias alone, split on its layer dim)
SSM_GATHERED = ["layers/dt_proj/b", "layers/dt_proj/w", "layers/x_proj/w"]
#: ``llm_mesh_hybrid_check``: reduced recurrentgemma-2b cut to 5 layers
#: (one super-block of rec, rec, attn and the (rec, rec) tail list, so the
#: stacked entries and the list both run) in f32 on (1, 2), with
#: ``llm_mesh_ssm_check``'s trainer, rounds and bars: B12 on the rank's
#: lru_width/2 channels, no all-gather over ``model`` but of the one KV
#: head's ``wk``/``wv``
MESH_HYBRID_CHECK_LAYERS = 5
#: the families of the channel parts, in the order the ranks run them (the
#: enc-dec's parts, ``encdec``, split its heads as the others split their
#: channels)
CHANNEL_TAGS = ("ssm", "hybrid", "encdec")
#: ``llm_mesh_hybrid``: recurrentgemma-2b at full width (d_model 2,560,
#: lru_width 2,560, 10 heads, d_ff 7,680, vocabulary 256,000, bf16) cut 26
#: -> 3 layers (one super-block, rec, rec, attn: the least depth that runs
#: both temporal blocks) on (1, 2) (each rank 1,280 channels, 5 heads, 3,840
#: ff columns and half the vocabulary), W = 2, 1 × 4,096 tokens a worker, 2
#: sgd steps at ``LLM_LR``, ``MESH_RUN_ROUNDS`` rounds, in the sketched mode
#: (ratio ``SKETCH_RATIO``, as ``llm_mesh_moe``): replicated, a rank's
#: (2, 456,160,000) block of λ, h, θ and the optimizer is 21.0 GB and the
#: round's trace peaks at 43.5 GB a rank (``launch/trace_analysis`` on
#: ``meta``, which read ``llm_mesh_ssm``'s 27.13 GB against 27.20 measured
#: on an H100), so two ranks do not fit the card; sketched, the trace reads
#: 10.5 GB
MESH_HYBRID_LAYERS = 3
#: ``serve_mesh_hybrid``: recurrentgemma-2b in bf16 at full width, 8 of 26
#: layers (two super-blocks and the tail), ``serve_mesh``'s 8 × 64 prefill
#: and 79 greedy steps fed one device's tokens; then the check's 5 layers
#: in f32, a batch of ``SERVE_MESH_CHECK_B``, a prompt of 8 and 60 new
#: tokens: 67 steps, past the 64-slot window's wrap
SERVE_HYBRID_LAYERS = 8
SERVE_HYBRID_CHECK_P, SERVE_HYBRID_CHECK_N = 8, 60
#: the leaves the hybrid's partitioned training still gathers over
#: ``model`` (serving keeps their columns and gathers their projections)
HYBRID_GATHERED = ["super/b2/temporal/attn/wk/w",
                   "super/b2/temporal/attn/wv/w"]
#: ``llm_mesh_encdec``: seamless-m4t-medium at full width (d_model 1,024,
#: 16 heads and 16 KV heads of 64, d_ff 4,096, vocabulary 256,206, bf16),
#: depth cut 12 + 12 -> 4 + 4 layers, replicated on (1, 2) (each rank 8
#: heads, 2,048 ff columns and half the vocabulary), ``llm_encdec``'s
#: settings: W = 2, 2 × 1,024 tokens a worker over 2 × 1,024 stub frames,
#: 2 sgd steps at ``LLM_LR``, ``MESH_RUN_ROUNDS`` rounds
MESH_ENCDEC_LAYERS = 4
#: ``serve_mesh_encdec``: seamless-m4t-medium in bf16 at full width and
#: depth (12 + 12 layers), ``serve_mesh``'s 8 × 64 prefill over 1,024 stub
#: frames a prompt, the cross cache from ``serve_step.prefill_cross`` of
#: the same frames, 79 greedy steps fed one device's tokens; then reduced
#: f32 seamless in both cache layouts: 4 KV heads (``"heads"``) and one KV
#: head (the self cache on its slots and the cross cache on its 16 frames,
#: ``"seq"``), a batch of ``SERVE_MESH_CHECK_B``, a prompt of 8 and 8 new
#: tokens
SERVE_ENCDEC_CHECKS = (("heads", {}, "heads"),
                       ("seq", {"n_kv_heads": 1}, "seq"))
SERVE_ENCDEC_CHECK_P, SERVE_ENCDEC_CHECK_N = 8, 8
#: ``llm_mesh_encdec_check``: reduced seamless-m4t-medium (2 encoder and 2
#: decoder layers, d_model 128, 4 heads and 4 KV heads of 32, d_ff 256,
#: vocabulary 512, 16 stub frames) in f32 on (1, 2), with
#: ``llm_mesh_ssm_check``'s trainer, rounds and bars: B11 on the rank's 2
#: heads (W·B, 2, 16, 32), B6, B3 and B4 once a round a rank.  The leaves
#: it, ``llm_mesh_encdec`` and the prefills still gather over ``model``
#: (decode: the decoder's alone): ``fc_out``'s bias, which the layout
#: splits on its layer dim (each rank adds it whole after the row sum)
ENCDEC_GATHERED = ["dec_layers/mlp/fc_out/b", "enc_layers/mlp/fc_out/b"]


class _SsmDigests(_LayerDigests):
    """:class:`_LayerDigests` of the SSM's ``block_fwd`` and
    ``block_decode``: the sum of each output's 16-bit words in int64, kept
    on the device until :attr:`digests` reads them, so a full-width round
    pays no copy to the host."""

    MODULE = "ssm"

    def digest(self, y):
        return y.detach().contiguous().view(self.torch.int16).sum(
            dtype=self.torch.int64)

    @property
    def digests(self) -> list:
        return [f"{n}:{int(v)}" for n, v in self.kept]


class _HybridDigests(_SsmDigests):
    """:class:`_SsmDigests` of the hybrid's layers (``_layer_fwd``,
    ``_layer_decode``: a temporal block and its MLP block)."""

    NAMES = ("_layer_fwd", "_layer_decode")
    MODULE = "hybrid"


class _EncdecDigests(_SsmDigests):
    """:class:`_SsmDigests` of the enc-dec's attention blocks: the
    encoder's (``_bidir_attention``), the decoder's cross-attention in
    training and the prefill (``_cross_attention``) and in decode
    (``_cross_decode``)."""

    NAMES = ("_bidir_attention", "_cross_attention", "_cross_decode")
    MODULE = "encdec"


def _encdec_cfg(n_layers: int):
    """seamless-m4t-medium at full width, ``n_layers`` encoder and
    ``n_layers`` decoder layers."""
    import dataclasses

    return dataclasses.replace(_llm_cfg(ENCDEC_ARCH, n_layers),
                               n_enc_layers=n_layers)


@contextlib.contextmanager
def _flash_shapes(shapes: list):
    """Append ``[direction, *q.shape]`` of each B11 launch in the block
    (``fwd``, ``dq``, ``dkv``)."""
    from repro_torch.kernels import flash_attention as fa

    saved = {d: getattr(fa, f"flash_attention_{d}")
             for d in ("fwd", "dq", "dkv")}

    def wrap(d, fn):
        def call(q, *a, **kw):
            shapes.append([d] + list(q.shape))
            return fn(q, *a, **kw)
        return call
    for d, fn in saved.items():
        setattr(fa, f"flash_attention_{d}", wrap(d, fn))
    try:
        yield shapes
    finally:
        for d, fn in saved.items():
            setattr(fa, f"flash_attention_{d}", fn)


def _channel_family(tag: str) -> dict:
    """What the three parts of a family partitioned on the model axis run
    and gate: ``"ssm"`` (falcon-mamba-7b's inner channels), ``"hybrid"``
    (recurrentgemma-2b's RG-LRU channels) or ``"encdec"``
    (seamless-m4t-medium's heads).  ``serve_checks``: (name, the reduced
    f32 config, prompt, new tokens, the cache's layout) of each serving
    check; ``run_batch``: a worker's (rows, tokens) in the run part."""
    import dataclasses

    if tag == "ssm":
        check = _moe_part_cfg(SSM_ARCH)
        return {"tag": tag, "arch": SSM_ARCH, "flag": "inner",
                "unit": "channels", "check_cfg": check,
                "check_reduced": "ModelConfig.reduced(): 2 layers, d_model "
                "128, d_inner 256, ssm_state 8, dt_rank 8",
                "run_cfg": _llm_cfg(SSM_ARCH, MESH_SSM_LAYERS),
                "run_reduced": {"n_layers": f"64 -> {MESH_SSM_LAYERS}"},
                "run_batch": (1, LLM_SEQ),
                "serve_cfg": _llm_cfg(SSM_ARCH, SERVE_SSM_LAYERS),
                "serve_checks": [(tag, check, SERVE_SSM_CHECK_P,
                                  SERVE_SSM_CHECK_N, "inner")],
                "gathered": SSM_GATHERED, "layout": "inner",
                "proj_cols": ["dt_proj", "x_proj"], "run_mode": "replicated",
                "digests": _SsmDigests, "shapes": _scan_shapes}
    if tag == "hybrid":
        check = dataclasses.replace(_moe_part_cfg(HYBRID_ARCH),
                                    n_layers=MESH_HYBRID_CHECK_LAYERS)
        return {"tag": tag, "arch": HYBRID_ARCH, "flag": "lru",
                "unit": "channels", "check_cfg": check,
                "check_reduced": "ModelConfig.reduced() at 5 layers (one "
                "super-block and the tail): d_model 128, lru_width 128, 4 "
                "heads, 1 KV head, window 64",
                "run_cfg": _llm_cfg(HYBRID_ARCH, MESH_HYBRID_LAYERS),
                "run_reduced": {"n_layers": f"26 -> {MESH_HYBRID_LAYERS}"},
                "run_batch": (1, LLM_SEQ),
                "serve_cfg": _llm_cfg(HYBRID_ARCH, SERVE_HYBRID_LAYERS),
                "serve_checks": [(tag, check, SERVE_HYBRID_CHECK_P,
                                  SERVE_HYBRID_CHECK_N, "seq")],
                "gathered": HYBRID_GATHERED, "layout": "seq",
                "proj_cols": [], "run_mode": "sketched",
                "digests": _HybridDigests, "shapes": _scan_shapes}
    check = _moe_part_cfg(ENCDEC_ARCH)
    return {"tag": tag, "arch": ENCDEC_ARCH, "flag": "heads",
            "unit": "heads", "check_cfg": check,
            "check_reduced": "ModelConfig.reduced(): 2 + 2 layers, d_model "
            "128, 4 heads and 4 KV heads of 32, d_ff 256, vocabulary 512, "
            "16 stub frames",
            "run_cfg": _encdec_cfg(MESH_ENCDEC_LAYERS),
            "run_reduced": {"n_enc_layers": f"12 -> {MESH_ENCDEC_LAYERS}",
                            "n_layers": f"12 -> {MESH_ENCDEC_LAYERS}"},
            "run_batch": (ENCDEC_BATCH, ENCDEC_SEQ),
            "serve_cfg": _encdec_cfg(ENCDEC_LAYERS),
            "serve_checks": [
                (name, dataclasses.replace(check, **over),
                 SERVE_ENCDEC_CHECK_P, SERVE_ENCDEC_CHECK_N, layout)
                for name, over, layout in SERVE_ENCDEC_CHECKS],
            "gathered": ENCDEC_GATHERED, "layout": "heads",
            "proj_cols": [], "run_mode": "replicated",
            "digests": _EncdecDigests, "shapes": _flash_shapes}


def _channel_batch(torch, cfg, rows: int, seq: int, seed: int) -> dict:
    """The workers' batch of a channel part: ``rows`` × ``seq`` tokens a
    worker (``token_dataset`` from ``seed``) and, for the enc-dec, its stub
    frames (W, rows, frontend_tokens, d_model) from ``seed + 1``."""
    from repro_torch import rng
    from repro_torch.data.synthetic import token_dataset

    tokens = token_dataset(seed, rows, seq, cfg.vocab_size,
                           n_workers=LLM_WORKERS)
    return {"tokens": tokens, **_frontend(
        torch, cfg, (LLM_WORKERS, rows),
        rng.generator(seed + 1, tokens.device))}


def _check_batch(torch, cfg) -> dict:
    """A reduced f32 check's batch (the MoE and channel checks'): W = 2
    workers' ``SKETCH_CHECK_B`` × ``SKETCH_CHECK_S`` tokens, and the
    enc-dec's frames."""
    return _channel_batch(torch, cfg, SKETCH_CHECK_B, SKETCH_CHECK_S,
                          SEED + 5)


def _kernel_shapes_want(cfg, n: int, rows: int, seq: int,
                        train: bool = True) -> list:
    """The distinct launch shapes of the family's kernel on a rank of a
    (1, n) grid over ``rows`` × ``seq`` tokens: B12's (rows, seq, the
    rank's scan width) forward and, in training, backward; B11's q (rows,
    the rank's heads, seq, hd) forward and, in training, dq and dk/dv."""
    if cfg.family == "audio":
        q = [rows, cfg.n_heads // n, seq, cfg.hd]
        dirs = ("dkv", "dq", "fwd") if train else ("fwd",)
    else:
        q = [rows, seq, _scan_width(cfg, n)]
        dirs = ("bwd", "fwd") if train else ("fwd",)
    return [[d] + q for d in dirs]


def _rec_layers(cfg) -> tuple:
    """(the recurrent layers in checkpointed stacked entries, those
    outside them): every SSM layer is stacked; the hybrid's super-blocks
    hold their pattern's, the tail list the rest."""
    if cfg.family == "ssm":
        return cfg.n_layers, 0
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    return (n_super * pat.count("rec"),
            pat[:cfg.n_layers - n_super * len(pat)].count("rec"))


def _channels(cfg, n: int) -> int:
    """A rank's channels of the family's split width on an axis of n (the
    enc-dec's: its heads)."""
    if cfg.family == "audio":
        return cfg.n_heads // n
    return (cfg.d_inner if cfg.family == "ssm" else cfg.lru_width) // n


def _scan_width(cfg, n: int) -> int:
    """The last dim of B12's planes on a rank: the SSM's channels by its
    state, the hybrid's channels."""
    c = _channels(cfg, n)
    return c * cfg.ssm_state if cfg.family == "ssm" else c


def _channel_round_launches(cfg, mode: str = "replicated") -> dict:
    """A round's launches (2 local steps, all workers at once; the
    sketched mode runs them a worker at a time): each recurrent layer's
    B12 forward once a step and once more where its checkpoint is
    recomputed, its backward once; the enc-dec's B11 so in each decoder
    layer's self-attention (forward, dq, dk/dv); B6, B3 and B4 once."""
    steps = 2 * (LLM_WORKERS if mode == "sketched" else 1)
    if cfg.family == "audio":
        n = steps * cfg.n_layers
        return dict(MESH_ROUND_LAUNCHES, flash_attention_fwd=2 * n,
                    flash_attention_dq=n, flash_attention_dkv=n,
                    linear_scan_fwd=0)
    ckpt, plain = _rec_layers(cfg)
    return dict(MESH_ROUND_LAUNCHES, flash_attention_fwd=0,
                linear_scan_fwd=steps * (2 * ckpt + plain),
                linear_scan_bwd=steps * (ckpt + plain))


def _prefill_launches(cfg) -> dict:
    """A prefill's launches: B12 a recurrent layer; the enc-dec's B11 a
    decoder layer."""
    if cfg.family == "audio":
        return {"flash_attention_fwd": cfg.n_layers}
    return {"linear_scan_fwd": sum(_rec_layers(cfg))}


def _param_gathers(cfg, steps: int, n: int = MESH_RANKS) -> tuple:
    """The all-gathers over ``model`` of (a prefill, ``steps`` decode
    steps) on (1, n): the SSM's prefill gathers ``x_proj`` and ``dt_proj``
    (each layer's) and ``dt_proj``'s bias (once), its decode the bias
    alone once a step; the hybrid's gather none (its heads split, the one
    KV head's projections gathered instead); the enc-dec's prefill each
    stack's ``fc_out`` bias where the layout splits it on its layer dim,
    its decode the decoder's once a step (and, in ``prefill_cross``, the
    prefill's)."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1, steps
    if cfg.family == "audio":
        dec = int(cfg.n_layers % n == 0)
        return int(cfg.n_enc_layers % n == 0) + dec, dec * steps
    return 0, 0


def _cache_blocks_want(cfg, B: int, n: int, T: int = 0,
                       layout: str = "") -> dict:
    """Each cache leaf's block on a rank of a (1, n) grid, by path: the
    SSM's ``ssm`` and ``conv`` on its channels; the hybrid's ``lru`` and
    ``conv`` on its channels, its attention's ``k``/``v`` on the window's
    slots; the enc-dec's self (``T`` slots) and cross (its frames) caches
    on their KV heads (``layout`` ``"heads"``), else on their sequences."""
    if cfg.family == "audio":
        F, KV, L = cfg.frontend_tokens, cfg.n_kv_heads, cfg.n_layers
        if layout == "heads":
            self_, cross = [L, B, T, KV // n, cfg.hd], [L, B, F, KV // n,
                                                        cfg.hd]
        else:
            self_, cross = [L, B, T // n, KV, cfg.hd], [L, B, F // n, KV,
                                                        cfg.hd]
        return {"cross_k": cross, "cross_v": cross, "self_k": self_,
                "self_v": self_}
    K1, c = cfg.conv1d_width - 1, _channels(cfg, n)
    if cfg.family == "ssm":
        L = cfg.n_layers
        return {"ssm": [L, B, c, cfg.ssm_state], "conv": [L, B, K1, c]}
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    out = {}
    for i, kind in enumerate(pat):
        if kind == "rec":
            out[f"super/b{i}/conv"] = [n_super, B, K1, c]
            out[f"super/b{i}/lru"] = [n_super, B, c]
        else:
            for k in ("k", "v"):
                out[f"super/b{i}/{k}"] = [n_super, B, cfg.attn_window // n,
                                          cfg.n_kv_heads, cfg.hd]
    for j, kind in enumerate(pat[:cfg.n_layers - n_super * len(pat)]):
        out[f"tail/#{j}/conv"] = [B, K1, c]
        out[f"tail/#{j}/lru"] = [B, c]
    return out


def _leaf_shapes(tree) -> dict:
    from repro_torch.tree import tree_paths

    return {"/".join(p): list(x.shape) for p, x in tree_paths(tree)}


@contextlib.contextmanager
def _scan_shapes(shapes: list):
    """Append ``[direction, *shape]`` of each B12 launch in the block."""
    from repro_torch.kernels import linear_scan as ls

    fwd, bwd = ls.linear_scan_fwd, ls.linear_scan_bwd

    def f(a, *args, **kw):
        shapes.append(["fwd"] + list(a.shape))
        return fwd(a, *args, **kw)

    def g(a, *args, **kw):
        shapes.append(["bwd"] + list(a.shape))
        return bwd(a, *args, **kw)
    ls.linear_scan_fwd, ls.linear_scan_bwd = f, g
    try:
        yield shapes
    finally:
        ls.linear_scan_fwd, ls.linear_scan_bwd = fwd, bwd


def _distinct(shapes: list) -> list:
    return sorted(map(list, {tuple(x) for x in shapes}))


def _free_running_reference(torch, cfg, rounds: int) -> dict:
    """The one-device rounds of a channel check (``cfg``, ``rounds``)
    along their own trajectory: the losses (recorded beside the mesh's,
    not gated)."""
    from repro_torch import rng

    batch = _check_batch(torch, cfg)
    init1, step1 = _mesh_part_trainer(torch, cfg, None)
    st = init1(SEED)
    losses = []
    for r in range(rounds):
        st, m = step1(st, batch, key=rng.fold_in(SEED, r + 1))
        losses.append(float(m["loss"]))
    del st, init1, step1
    _free(torch)
    return {"losses": losses}


def _rank_state(torch, st1, stm, sspec, j: int):
    """The rank's block of one device's state ``st1`` as the mesh trainer
    holds it (``stm``'s form): θ, Θ and the optimizer's trees cut by
    ``sspec``, λ and h packed shard-major and narrowed to the rank's
    columns, the channel's age and the step as they are."""
    from repro_torch.core.cplx import Complex
    from repro_torch.core.packing import (build_packspec, pack_shard_global,
                                          shard_tree, unpack)
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


def _mesh_channels_check_rank(torch, mesh, ref: dict, fam: dict) -> dict:
    """A channel check (``llm_mesh_ssm_check``, ``llm_mesh_hybrid_check``)
    on one rank: each round run on ``mesh`` from the rank's block of one
    device's state before it (:func:`_rank_state`) and held to one
    device's round from that state: the loss and the rank's Θ block; B12's
    shapes, the launches, the all-gathers over ``model`` and each layer's
    output digests of the mesh's rounds.  Along their own trajectories the
    two runs fork: falcon-mamba at lr 1e-2 turns a regrouped f32 sum's
    last bit into a loss gap that grows about 10× a round (one device with
    ``out_proj``'s contraction summed in two halves read 3.5e-6 and 2.0e-5
    relative in rounds 2 and 3 on the CPU), so the free-running losses
    beside the parent's (``ref``) are recorded, not gated."""
    from repro_torch import rng
    from repro_torch.core.packing import shard_tree
    from repro_torch.kernels import build
    from repro_torch.tree import tree_leaves

    j = mesh.axis_index("model")
    cfg = fam["check_cfg"]
    rounds = MESH_SSM_CHECK_ROUNDS
    batch = _check_batch(torch, cfg)
    init1, step1 = _mesh_part_trainer(torch, cfg, None)
    st1 = init1(SEED)
    init_m, step_m = _mesh_part_trainer(torch, cfg, mesh)
    stm = init_m(SEED)
    sspec, plan = init_m.layout["sspec"], init_m.layout["plan"]
    free = stm = _rank_state(torch, st1, stm, sspec, j)
    shapes: list = []
    losses, losses1, t_errs, free_losses = [], [], [], []
    launches: dict = {}
    mesh.reset_stats()
    dig = fam["digests"](torch)
    for r in range(rounds):
        key = rng.fold_in(SEED, r + 1)
        stm = _rank_state(torch, st1, stm, sspec, j)
        build.reset_launches()
        with fam["shapes"](shapes), dig:
            stm, m = step_m(stm, batch, key=key)
        launches = _summed([launches, dict(build.launches)])
        st1, m1 = step1(st1, batch, key=key)
        losses.append(float(m["loss"]))
        losses1.append(float(m1["loss"]))
        t_errs.append(_max_err(tree_leaves(stm.Theta),
                               tree_leaves(shard_tree(sspec, st1.Theta, j)),
                               0.0, MESH_PART_THETA_ATOL))
    n_gathers = mesh.stats.get("all_gather", {}).get("axes", {}).get(
        "model", 0)
    want, still = _gathers_want(stm.theta, sspec, plan.part, rounds * 2, 1)
    collectives = _mesh_stats(mesh, rounds)
    for r in range(rounds):
        free, m = step_m(free, batch, key=rng.fold_in(SEED, r + 1))
        free_losses.append(float(m["loss"]))
    out = {"losses": losses, "losses_one_device": losses1,
           "loss_rel_err": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, losses1)),
           "Theta_max_abs": max(e[0] for e in t_errs),
           "Theta_over_atol": max(e[1] for e in t_errs),
           "free_running": {"losses": free_losses,
                            "losses_one_device": ref["losses"],
                            "loss_rel_gap": [abs(a - b) / abs(b) for a, b
                                             in zip(free_losses,
                                                    ref["losses"])]},
           "kernel_shapes": _distinct(shapes), "launches": launches,
           "model_all_gathers": n_gathers,
           "model_all_gathers_want": want, "gathered_leaves": still,
           "collectives": collectives,
           fam["flag"]: getattr(plan.part, fam["flag"]),
           "digests": dig.digests}
    del stm, st1, free, init_m, step_m, init1, step1
    _free(torch)
    return out


def _mesh_channels_rank(torch, mesh, fam: dict) -> dict:
    """``llm_mesh_ssm``, ``llm_mesh_hybrid`` or ``llm_mesh_encdec`` on one
    rank: the family at full width cut to its depth on ``mesh``
    (replicated, or sketched where ``fam["run_mode"]`` says), the
    collectives timed, the kernel's shapes and each layer's output
    digests recorded."""
    from repro_torch import rng
    from repro_torch.kernels import build
    from repro_torch.launch.trace_analysis import mesh_collectives
    from repro_torch.models.partition import partition_for
    from repro_torch.tree import tree_leaves

    cfg = fam["run_cfg"]
    sketched = fam["run_mode"] == "sketched"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if sketched:
        init_fn, step = _mesh_sketched_trainer(torch, cfg, mesh, noisy=True,
                                               local_steps=2)
    else:
        init_fn, step, _, _ = _mesh_trainer(torch, cfg, mesh, noisy=True)
    state = init_fn(SEED)
    batch = _channel_batch(torch, cfg, *fam["run_batch"], SEED + 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    sspec, part = init_fn.layout["sspec"], partition_for(cfg, mesh)
    # the replicated mode's local steps run every worker's rows at once
    # (θ leads with W), the sketched mode's a worker at a time on Θ
    want, still = (_gathers_want(state.Theta, sspec, part, MESH_RUN_ROUNDS
                                 * LLM_WORKERS * 2, 0) if sketched else
                   _gathers_want(state.theta, sspec, part,
                                 MESH_RUN_ROUNDS * 2, 1))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    losses, times, shapes = [], [], []
    with fam["shapes"](shapes), fam["digests"](torch) as dig:
        for r in range(MESH_RUN_ROUNDS):
            held = [state]
            state = None
            t0 = time.perf_counter()
            state, m = step(held.pop(), batch, key=rng.fold_in(SEED, r + 1))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            del m
    mesh.timing = False
    gathers = mesh.stats.get("all_gather", {}).get("axes", {})
    finite = all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(leaf).all()) for leaf in tree_leaves(
            state.Theta) + ([] if sketched else tree_leaves(state.theta)))
    out = {"losses": losses, "round_s": times, "setup_s": setup_s,
           "setup_peak": setup_peak,
           "peak": torch.cuda.max_memory_allocated(), "finite": finite,
           "launches": dict(build.launches),
           "kernel_shapes": _distinct(shapes),
           "collectives": _mesh_stats(mesh, MESH_RUN_ROUNDS),
           "counts": mesh_collectives(mesh.stats),
           "model_all_gathers": gathers.get("model", 0),
           "model_all_gathers_want": want, "gathered_leaves": still,
           "d_local": sspec.d_local,
           "round_block": list(state.lam.re.shape),
           fam["flag"]: getattr(part, fam["flag"]), "digests": dig.digests}
    del state, step, init_fn
    _free(torch)
    return out


def _fill_cross(step, params, cache, inputs: dict) -> None:
    """The enc-dec's cross cache filled in place from its batch's frames
    (``serve_step.prefill_cross``: the rank's block under a mesh); nothing
    for another family."""
    if "frames" in inputs:
        ck, cv = step.prefill_cross(params, inputs["frames"])
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)


def _serve_mesh_channels_reference(torch, ref_dir: str, fam: dict) -> dict:
    """One device's runs ``serve_mesh_<tag>`` holds the ranks to, saved to
    ``ref_dir``: the family in bf16 at its serving depth: the prefill's
    last logits, every step's logits, the inputs and greedy tokens, and
    the same weights in f32 fed the same tokens; each reduced f32 check's
    prefill, step logits, tokens and final cache (the enc-dec's cross
    cache filled from its frames first).  Returns the file's path, the
    one-device times and its bf16 logits' distance from the f32 run."""
    from repro_torch import rng
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    data, prefill_ms, step_ms, one_err = _serve_full_reference(
        torch, fam["serve_cfg"], SEED + 40)
    t_check = time.perf_counter()
    data["check"] = {}
    for name, cfg_c, P, N, _ in fam["serve_checks"]:
        m = build_model(cfg_c)
        p = m.init(SEED + 42)
        pr = torch.randint(0, m.cfg.vocab_size, (SERVE_MESH_CHECK_B, P),
                           device=dev,
                           generator=rng.generator(SEED + 43, dev))
        extra = _frontend(torch, m.cfg, (SERVE_MESH_CHECK_B,),
                          rng.generator(SEED + 44, dev))
        st: list = []
        last = make_prefill(m)(p, {"tokens": pr, **extra})
        c = m.init_cache(SERVE_MESH_CHECK_B, P + N)
        step = make_serve_step(_observed(m, st))
        _fill_cross(step, p, c, extra)
        tk, c = _greedy_run(step, p, c, pr, N)
        data["check"][name] = {
            "prompts": pr.cpu(), "prefill": last.cpu(),
            "logits": torch.stack(st).cpu(),
            "tokens": torch.stack(tk).cpu(),
            "cache": tree_map(lambda x: x.cpu(), c),
            **{k: v.cpu() for k, v in extra.items()}}
        del m, p, c, st, last, tk, step
        _free(torch)
    path = os.path.join(ref_dir, f"serve_mesh_{fam['tag']}_reference.pt")
    torch.save(data, path)
    return {"path": path, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "one_device_vs_f32": one_err,
            "seconds": {"full": t_check - t_start,
                        "check": time.perf_counter() - t_check}}


def _serve_mesh_channels_full(torch, mesh, data: dict, fam: dict) -> dict:
    """``serve_mesh_<tag>`` on one rank: the family at full width cut to
    its serving depth on ``mesh``, its prefill (and the enc-dec's cross
    cache from its frames) and its teacher-forced greedy steps against one
    device's (and the f32 run's), timed, with the mesh's collectives, the
    kernel's launches and shapes, each layer's output digests and the
    rank's peaks."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    dev = resolve_device("cuda")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(fam["serve_cfg"])
    t0 = time.perf_counter()
    full = model.init(SEED + 40)
    prompts = data["prompts"].to(dev)
    store: list = []
    step = make_serve_step(_observed(model, store), mesh)
    prefill = make_prefill(model, mesh)
    params = step.shard(full)
    # the prefill's plan from the shapes alone: the blocks are the step's
    prefill.shard(tree_map(lambda x: x.to("meta"), full))
    del full
    cache = step.init_cache(SERVE_MESH_B, SERVE_MESH_P + SERVE_MESH_N)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _free(torch)
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    batch = {"tokens": prompts, **{k: data[k].to(dev) for k in ("frames",)
                                   if k in data}}
    pre_shapes: list = []
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    with fam["shapes"](pre_shapes), fam["digests"](torch) as dig_pre:
        last = prefill(params, batch)
    torch.cuda.synchronize()
    mesh.timing = False
    pre_launches = {k: v for k, v in build.launches.items() if v}
    pre_stats = _mesh_stats(mesh, 1)
    pre_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    times = []
    for _ in range(SERVE_MESH_PREFILL_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)

    mesh.reset_stats()
    _fill_cross(step, params, cache, batch)
    torch.cuda.synchronize()
    cross_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    feed = data["feed"].to(dev)
    step_s = []

    def tick(i):
        torch.cuda.synchronize()
        step_s.append(time.perf_counter())
    dec_shapes: list = []
    build.reset_launches()
    mesh.reset_stats()
    mesh.timing = True
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with fam["shapes"](dec_shapes), fam["digests"](torch) as dig_dec:
        toks, cache = _greedy_run(step, params, cache, prompts,
                                  SERVE_MESH_N, feed=feed, every=tick)
    mesh.timing = False
    dec_launches = {k: v for k, v in build.launches.items() if v}
    dec_stats = _mesh_stats(mesh, SERVE_MESH_STEPS)
    dec_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
    walls = [(b - a) * 1e3 for a, b in zip([t1] + step_s[:-1], step_s)]
    peak = torch.cuda.max_memory_allocated()
    j = mesh.axis_index("model")
    local = torch.stack(store)
    vl = local.shape[-1]
    cols = slice(j * vl, (j + 1) * vl)
    errs, errs32 = [], []
    for i in range(SERVE_MESH_STEPS):
        errs.append(float((local[i].float() - data["logits"][i][:, cols]
                           .to(dev).float()).abs().max()))
        errs32.append(_err_stats(local[i],
                                 data["logits_f32"][i][:, cols].to(dev)))
    tokens = torch.stack(toks).cpu()
    gathered = mesh.all_gather(local, "model", -1, op="gather_vocab")
    part = step.layout["cache_part"]
    out = {"prefill_max_abs_err": float((last.float() - data["prefill"].to(
               dev).float()).abs().max()),
           "prefill_sha1": _sha1(torch, last),
           "step_logits_sha1": _sha1(torch, gathered),
           "step_max_abs_err": errs, "step_vs_f32": errs32,
           "prefill_vs_f32": _err_stats(last, data["prefill_f32"].to(dev)),
           "tokens_sha1": _sha1(torch, torch.stack(toks)),
           "tokens_equal_one_device": float(
               (tokens == data["tokens"]).float().mean()),
           "prefill_launches": pre_launches, "decode_launches": dec_launches,
           "prefill_kernel_shapes": _distinct(pre_shapes),
           "decode_kernel_shapes": _distinct(dec_shapes),
           "cross_calls": cross_calls,
           "prefill_collectives": pre_stats, "prefill_calls": pre_calls,
           "decode_collectives": dec_stats, "decode_calls": dec_calls,
           "prefill_ms": times, "decode_wall_ms": walls,
           "setup_s": setup_s, "setup_peak": setup_peak, "peak": peak,
           "cache_layout": step.layout["cache"],
           "cache_blocks": _leaf_shapes(cache),
           "proj_cols": list(part.proj_cols),
           "digests": dig_pre.digests + dig_dec.digests}
    del gathered, local, store
    out["decode_device_ms"] = _kernel_ms(
        torch, lambda: step(params, cache, feed[-1], SERVE_MESH_STEPS - 1))
    del params, cache, last, model, step, prefill
    _free(torch)
    return out


def _serve_mesh_channels_check(torch, mesh, data: dict, fam: dict) -> dict:
    """Serving's reduced f32 checks on one rank, by name: the family
    served greedily on ``mesh`` (the enc-dec's cross cache filled from its
    frames, ``serve_step.prefill_cross``) against one device's run on the
    card: the prefill's and every step's logits (the rank's vocab
    columns), the tokens, and each cache leaf of the rank against its
    block of one device's."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.shardings import shard_leaf
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import tree_leaves, tree_paths

    dev = resolve_device("cuda")

    def scaled(a, b):
        b = b.to(dev).float()
        return float((a.float() - b).abs().max() / b.abs().max())
    out = {}
    for name, cfg_c, P, N, _ in fam["serve_checks"]:
        ref = data[name]
        m = build_model(cfg_c)
        full = m.init(SEED + 42)
        prompts = ref["prompts"].to(dev)
        extra = {k: ref[k].to(dev) for k in ("frames",) if k in ref}
        store: list = []
        prefill = make_prefill(m, mesh)
        step = make_serve_step(_observed(m, store), mesh)
        params = step.shard(full)
        cache = step.init_cache(SERVE_MESH_CHECK_B, P + N)
        mesh.reset_stats()
        last = prefill(prefill.shard(full), {"tokens": prompts, **extra})
        pre_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
        mesh.reset_stats()
        _fill_cross(step, params, cache, extra)
        cross_calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
        mesh.reset_stats()
        toks, cache = _greedy_run(step, params, cache, prompts, N)
        calls = {op: dict(v["axes"]) for op, v in mesh.stats.items()}
        j = mesh.axis_index("model")
        vl = store[0].shape[-1]
        out[name] = {
            "layout": step.layout["cache"],
            "cache_blocks": _leaf_shapes(cache),
            "prefill_rel_err": scaled(last, ref["prefill"]),
            "step_rel_err": max(scaled(x, y[:, j * vl:(j + 1) * vl])
                                for x, y in zip(store, ref["logits"])),
            "cache_rel_err": {
                "/".join(p): scaled(c, shard_leaf(w, sp, mesh))
                for (p, c), w, sp in zip(
                    tree_paths(cache), tree_leaves(ref["cache"]),
                    tree_leaves(step.layout["cache_specs"]))},
            "tokens_equal": bool(torch.equal(torch.stack(toks).cpu(),
                                             ref["tokens"])),
            "tokens_sha1": _sha1(torch, torch.stack(toks)),
            "prefill_calls": pre_calls, "cross_calls": cross_calls,
            "decode_calls": calls}
        del m, full, params, cache, store, last
    return out


def _serve_mesh_channels_rank(torch, mesh, ref: dict, fam: dict) -> dict:
    """Phase ``serve_mesh_ssm`` or ``serve_mesh_hybrid`` on one rank: the
    full-width run, then the reduced f32 check."""
    t0 = time.perf_counter()
    data = torch.load(ref["path"])
    out = {"full": _serve_mesh_channels_full(torch, mesh, data, fam)}
    t1 = time.perf_counter()
    out["check"] = _serve_mesh_channels_check(torch, mesh, data["check"],
                                              fam)
    _free(torch)
    out["seconds"] = {"full": t1 - t0, "check": time.perf_counter() - t1}
    return out


def _unequal_ranks(phase: str, per: list, keys: tuple) -> None:
    """Where the ranks' results differ in any of ``keys``: the line of
    ``phase`` with both ranks' losses (or digests of their outputs) and
    per-layer output digests from the first layer call that differs
    (ROADMAP queue C item 1's dump), then the phase fails."""
    if all(all(p[k] == per[0][k] for k in keys) for p in per):
        return
    first, second = per[0]["digests"], per[1]["digests"]
    i = next((k for k, (a, b) in enumerate(zip(first, second)) if a != b),
             min(len(first), len(second)))
    emit({"phase": phase, "ok": False, "ranks_bits_equal": False,
          "ranks": [{k: p[k] for k in keys} for p in per],
          "layer_calls": [len(first), len(second)],
          "first_differing_layer_call": i,
          "digests": [first[max(0, i - 2):i + 12],
                      second[max(0, i - 2):i + 12]]})
    require(False, f"{phase}: the ranks' {', '.join(keys)} are not bit-equal "
            f"(first differing layer call {i})")


def _gate_mesh_channels(res: list, refs: dict, fam: dict) -> dict:
    """Phases ``llm_mesh_<tag>_check``, ``llm_mesh_<tag>`` and
    ``serve_mesh_<tag>`` of a family partitioned on the model axis (its
    channels, or the enc-dec's heads): their gates on the ranks' results
    and their lines; returns each phase's launches, summed over the
    ranks."""
    from repro_torch.models import get_config

    tag, flag, arch = fam["tag"], fam["flag"], fam["arch"]
    p_check, p_run = f"llm_mesh_{tag}_check", f"llm_mesh_{tag}"
    p_serve = f"serve_mesh_{tag}"
    n = MESH_RANKS
    key = f"{tag}_check"
    require(all(key in r for r in res), f"{p_check}: a rank failed:\n"
            + _rank_failures(res, key))
    sc = [r[key] for r in res]
    cfg = fam["check_cfg"]
    want_shapes = _kernel_shapes_want(cfg, n, LLM_WORKERS * SKETCH_CHECK_B,
                                      SKETCH_CHECK_S)
    _unequal_ranks(p_check, sc, ("losses",))
    for r, c in enumerate(sc):
        t = f"{p_check} rank {r}"
        require(c[flag], f"{t}: the plan does not split the {fam['unit']}")
        require(c["loss_rel_err"] <= MESH_PART_LOSS_RTOL, f"{t}: the losses "
                f"{c['losses']} differ from one device's "
                f"{c['losses_one_device']} beyond rtol {MESH_PART_LOSS_RTOL}")
        require(c["Theta_over_atol"] <= 1.0, f"{t}: Θ differs from one "
                f"device's block by {c['Theta_max_abs']}, beyond atol "
                f"{MESH_PART_THETA_ATOL}")
        require(c["kernel_shapes"] == want_shapes, f"{t}: the kernel ran "
                f"on {c['kernel_shapes']}, not the rank's {fam['unit']} "
                f"{want_shapes}")
        _per_round(dict(c["launches"]), MESH_SSM_CHECK_ROUNDS,
                   _channel_round_launches(cfg))
        require(c["gathered_leaves"] == fam["gathered"] and
                c["model_all_gathers"] == c["model_all_gathers_want"],
                f"{t}: {c['model_all_gathers']} all-gathers over model, "
                f"want {c['model_all_gathers_want']} (the leaves "
                f"{c['gathered_leaves']})")
    emit({"phase": p_check, "ok": True, "arch": arch,
          "reduced": fam["check_reduced"], "dtype": "float32",
          "grid": {"data": 1, "model": 2}, "W": LLM_WORKERS,
          "batch": SKETCH_CHECK_B, "seq": SKETCH_CHECK_S, "local_steps": 2,
          "local_lr": 1e-2, "noisy": False, "rounds": MESH_SSM_CHECK_ROUNDS,
          "loss_rtol": MESH_PART_LOSS_RTOL,
          "Theta_atol": MESH_PART_THETA_ATOL, "ranks_bits_equal": True,
          "ranks": [{k: v for k, v in c.items()
                     if k not in ("launches", "collectives", "digests")}
                    for c in sc],
          "collectives": [c["collectives"] for c in sc],
          "launches": [c["launches"] for c in sc]})

    require(all(tag in r for r in res), f"{p_run}: a rank failed:\n"
            + _rank_failures(res, tag))
    sr = [r[tag] for r in res]
    full = get_config(arch)
    cfg_run = fam["run_cfg"]
    mode = fam["run_mode"]
    b_run, s_run = fam["run_batch"]
    rows = (1 if mode == "sketched" else LLM_WORKERS) * b_run
    want_shapes = _kernel_shapes_want(cfg_run, n, rows, s_run)
    _unequal_ranks(p_run, sr, ("losses",))
    for r, run in enumerate(sr):
        t = f"{p_run} rank {r}"
        require(run[flag], f"{t}: the plan does not split the "
                f"{fam['unit']}")
        require(tuple(run["round_block"]) in _mesh_round_shapes(),
                f"{t}: the round's block {run['round_block']} (λ, h) is "
                f"not one of the kernel rows' shapes")
        require(run["losses"][-1] < run["losses"][0], f"{t}: round "
                f"{MESH_RUN_ROUNDS} loss {run['losses'][-1]} is not below "
                f"round 1's {run['losses'][0]}")
        require(run["finite"], f"{t}: non-finite θ or Θ")
        require(max(run["peak"], run["setup_peak"]) <= MESH_PEAK,
                f"{t}: peak {run['peak'] / 1e9} GB (set-up "
                f"{run['setup_peak'] / 1e9} GB) above {MESH_PEAK / 1e9} GB")
        require(run["kernel_shapes"] == want_shapes, f"{t}: the kernel ran "
                f"on {run['kernel_shapes']}, not the rank's {fam['unit']} "
                f"{want_shapes}")
        _per_round(dict(run["launches"]), MESH_RUN_ROUNDS,
                   _channel_round_launches(cfg_run, mode))
        require(run["gathered_leaves"] == fam["gathered"] and
                run["model_all_gathers"] == run["model_all_gathers_want"],
                f"{t}: {run['model_all_gathers']} all-gathers over model, "
                f"want {run['model_all_gathers_want']} (the leaves "
                f"{run['gathered_leaves']})")
    s_round = statistics.mean(max(sr[r]["round_s"][i] for r in range(n))
                              for i in range(1, MESH_RUN_ROUNDS))
    emit({"phase": p_run, "ok": True, "arch": arch,
          "reduced": fam["run_reduced"],
          "grid": {"data": 1, "model": 2}, "ranks": n,
          "backend": res[0]["backend"], "W": LLM_WORKERS,
          "batch_per_worker": b_run, "seq": s_run,
          "local_steps": 2, "local_lr": LLM_LR, "rounds": MESH_RUN_ROUNDS,
          "mode": mode, **({"sketch_ratio": SKETCH_RATIO}
                           if mode == "sketched" else {}),
          f"{fam['unit']}_a_rank": _channels(full, n),
          "d_local": sr[0]["d_local"],
          "round_block": sr[0]["round_block"],
          "loss": sr[0]["losses"], "ranks_bits_equal": True,
          "round_s": [run["round_s"] for run in sr],
          "seconds_per_round": s_round,
          "tokens_per_s": LLM_WORKERS * b_run * s_run * 2 / s_round,
          "setup_s": [run["setup_s"] for run in sr],
          "peak_mem_gb": [run["peak"] / 1e9 for run in sr],
          "setup_peak_mem_gb": [run["setup_peak"] / 1e9 for run in sr],
          "kernel_shapes": sr[0]["kernel_shapes"],
          "collectives": [run["collectives"] for run in sr],
          "model_all_gathers": [run["model_all_gathers"] for run in sr],
          "gathered_leaves": sr[0]["gathered_leaves"],
          "timing": "every collective synchronised and timed (Mesh.timing)",
          "launches": [run["launches"] for run in sr]})

    require(all(p_serve in r for r in res), f"{p_serve}: a rank failed:\n"
            + _rank_failures(res, p_serve))
    ref = refs[f"serve_{tag}"]
    fs = [r[p_serve]["full"] for r in res]
    f0 = fs[0]
    one32 = ref["one_device_vs_f32"]
    rms = {"prefill": (_rms([f["prefill_vs_f32"] for f in fs[:1]]),
                       _rms([one32["prefill"]])),
           "steps": (_rms([e for f in fs for e in f["step_vs_f32"]]),
                     _rms(one32["steps"]))}
    ratio = {k: a / b for k, (a, b) in rms.items()}
    cfg8 = fam["serve_cfg"]
    c = _channels(cfg8, n)
    T = SERVE_MESH_P + SERVE_MESH_N
    pre_gathers, step_gathers = _param_gathers(cfg8, SERVE_MESH_STEPS)
    _unequal_ranks(p_serve, fs, ("tokens_sha1", "prefill_sha1",
                                 "step_logits_sha1"))
    for r, f in enumerate(fs):
        t = f"{p_serve} rank {r}"
        blocks = _cache_blocks_want(cfg8, SERVE_MESH_B, n, T, fam["layout"])
        require(f["cache_layout"] == fam["layout"]
                and f["cache_blocks"] == blocks,
                f"{t}: the cache's layout {f['cache_layout']!r}, blocks "
                f"{f['cache_blocks']}")
        require(sorted(f["proj_cols"]) == fam["proj_cols"], f"{t}: decode "
                f"keeps the rank's block of {f['proj_cols']}")
        require(f["prefill_launches"] == _prefill_launches(cfg8)
                and not f["decode_launches"], f"{t}: prefill launched "
                f"{f['prefill_launches']}, decode {f['decode_launches']}")
        want = _kernel_shapes_want(cfg8, n, SERVE_MESH_B, SERVE_MESH_P,
                                   train=False)
        require(f["prefill_kernel_shapes"] == want
                and not f["decode_kernel_shapes"], f"{t}: the kernel ran on "
                f"{f['prefill_kernel_shapes']}, not the rank's "
                f"{fam['unit']} {want}")
        got = [x.get("all_gather", {}).get("model", 0)
               for x in (f["prefill_calls"], f["decode_calls"])]
        require(got == [pre_gathers, step_gathers], f"{t}: parameter "
                f"all-gathers over model in the prefill and decode {got}, "
                f"want {[pre_gathers, step_gathers]}")
        if cfg8.family == "audio":
            got = f["cross_calls"].get("all_gather", {}).get("model", 0)
            require(got == pre_gathers, f"{t}: prefill_cross all-gathered "
                    f"{got} parameters over model, want {pre_gathers}")
        require(max(f["peak"], f["setup_peak"]) <= MESH_PEAK, f"{t}: peak "
                f"{f['peak'] / 1e9} GB, set-up {f['setup_peak'] / 1e9} GB, "
                f"above {MESH_PEAK / 1e9} GB")
    require(all(x <= SERVE_MESH_F32_RATIO for x in ratio.values()),
            f"{p_serve}: the mesh's logits are further from the f32 run "
            f"than one device's bf16 logits are, beyond "
            f"{SERVE_MESH_F32_RATIO}× in RMS: {rms}")
    checks = [r[p_serve]["check"] for r in res]
    for name, cfg_c, P, N, layout in fam["serve_checks"]:
        pre_c, step_c = _param_gathers(cfg_c, P - 1 + N)
        for r, ck in enumerate(ch[name] for ch in checks):
            t = f"{p_serve} check {name} rank {r}"
            require(ck["layout"] == layout and ck["cache_blocks"]
                    == _cache_blocks_want(cfg_c, SERVE_MESH_CHECK_B, n,
                                          P + N, layout),
                    f"{t}: layout {ck['layout']!r}, blocks "
                    f"{ck['cache_blocks']}")
            require(max(ck["prefill_rel_err"], ck["step_rel_err"],
                        *ck["cache_rel_err"].values())
                    <= SERVE_MESH_CHECK_RTOL, f"{t}: logits "
                    f"{ck['prefill_rel_err']} / {ck['step_rel_err']}, cache "
                    f"{ck['cache_rel_err']} from one device's, beyond "
                    f"{SERVE_MESH_CHECK_RTOL} of their largest")
            require(ck["tokens_equal"] and ck["tokens_sha1"]
                    == checks[0][name]["tokens_sha1"], f"{t}: the tokens "
                    f"are not one device's, or not rank 0's")
            got = [x.get("all_gather", {}).get("model", 0)
                   for x in (ck["prefill_calls"], ck["decode_calls"])]
            require(got == [pre_c, step_c], f"{t}: parameter all-gathers "
                    f"over model in the prefill and decode {got}, want "
                    f"{[pre_c, step_c]}")
    walls = [statistics.median(f["decode_wall_ms"]) for f in fs]

    def per_rank(k):
        return [f[k] for f in fs]
    emit({"phase": p_serve, "ok": True, "arch": arch,
          "n_layers": cfg8.n_layers,
          "reduced": ("none: full depth" if cfg8.n_layers == full.n_layers
                      else f"depth only: {cfg8.n_layers} of "
                      f"{full.n_layers} layers"), "dtype": "bfloat16",
          "grid": dict(zip(("data", "model"), SERVE_MESH_SHAPE)),
          "ranks": n, "backend": res[0]["backend"],
          "batch": SERVE_MESH_B, "prompt": SERVE_MESH_P,
          "new_tokens": SERVE_MESH_N, "decode_steps": SERVE_MESH_STEPS,
          "inputs": "one device's tokens (teacher forced)",
          f"{fam['unit']}_a_rank": c, "proj_cols": f0["proj_cols"],
          "cache_layout": f0["cache_layout"],
          "cache_blocks": f0["cache_blocks"],
          "prefill_max_abs_err": f0["prefill_max_abs_err"],
          "step_max_abs_err": [max(f["step_max_abs_err"][i] for f in fs)
                               for i in range(SERVE_MESH_STEPS)],
          "rms_vs_f32": {k: {"mesh": a, "one_device": b}
                         for k, (a, b) in rms.items()},
          "rms_vs_f32_ratio": ratio, "f32_ratio_bound": SERVE_MESH_F32_RATIO,
          "tokens_equal_one_device": f0["tokens_equal_one_device"],
          "ranks_bits_equal": True,
          "prefill_ms": per_rank("prefill_ms"),
          "prefill_ms_one_device": ref["prefill_ms"],
          "decode_wall_ms_per_step": walls,
          "decode_wall_ms_per_step_one_device": ref["step_ms"],
          "decode_device_ms_per_step": per_rank("decode_device_ms"),
          "setup_s": per_rank("setup_s"),
          "setup_peak_gb": [f["setup_peak"] / 1e9 for f in fs],
          "peak_mem_gb": [f["peak"] / 1e9 for f in fs],
          "prefill_collectives": per_rank("prefill_collectives"),
          "decode_collectives_per_step": per_rank("decode_collectives"),
          "prefill_launches": per_rank("prefill_launches"),
          "prefill_kernel_shapes": f0["prefill_kernel_shapes"],
          **({"frames": cfg8.frontend_tokens,
              "prefill_cross_collectives": per_rank("cross_calls")}
             if cfg8.family == "audio" else {}),
          "check": {"reduced": fam["check_reduced"], "dtype": "float32",
                    "batch": SERVE_MESH_CHECK_B,
                    "rtol": SERVE_MESH_CHECK_RTOL,
                    "cases": {name: {"prompt": P, "new_tokens": N,
                                     "layout": layout,
                                     "ranks": [ch[name] for ch in checks]}
                              for name, _, P, N, layout
                              in fam["serve_checks"]}},
          "seconds": {"one_device_reference": ref["seconds"],
                      "ranks": [r[p_serve]["seconds"] for r in res]},
          "timing": "every collective synchronised and timed (Mesh.timing)"})
    return {p_check: _summed(c["launches"] for c in sc),
            p_run: _summed(run["launches"] for run in sr),
            p_serve: _summed([f["prefill_launches"] for f in fs]
                             + [f["decode_launches"] for f in fs])}


# ---------------------------------------------------------------------------
# the dry run: one rank's trace on meta against the live runs
# ---------------------------------------------------------------------------

#: phase ``dryrun``'s band for the trace's predicted peak over phase
#: ``llm``'s measured one (``torch.cuda.max_memory_allocated``), and for its
#: predicted temporaries (the peak less the state, the trace's arguments)
#: over the measured peak less the same state: set around the two equal
#: readings on an H100 (52.28 GB against 49.80, 1.050; temporaries 25.50
#: against 23.02, 1.108), so a tracker that misses the temporaries or
#: their frees falls outside
DRYRUN_PEAK_BAND = (0.9, 1.15)
DRYRUN_TEMP_BAND = (0.9, 1.25)


def _traced(torch, init_fn, step, mesh, batch: dict, keys) -> object:
    """The trace (``launch/trace_analysis``) of ``step`` over ``keys`` from
    ``init_fn(SEED)``, all on ``meta``, as rank 0 of ``mesh``."""
    from repro_torch.launch.trace_analysis import tracing

    state = init_fn(SEED)
    with tracing(mesh, (state, batch)) as tr:
        for key in keys:
            state, _ = step(state, batch, key=key)
    return tr.summary()


def _meta_tokens(torch, *shape):
    return {"tokens": torch.empty(shape, dtype=torch.int32, device="meta")}


def phase_dryrun(torch, llm: dict, llm_prof: dict, launch_report: dict,
                 mesh_counts: dict):
    """The dry run (``repro_torch.launch.dryrun``: one rank's program traced
    on ``meta`` under a fake-rank mesh) against what the card ran.  Gates:
    the trace of ``llm_mesh``'s rounds on (1, 2) and (2, 1) and of
    ``llm_mesh_sketched``'s counts the calls and bytes of each collective
    op that both live ranks' ``Mesh.stats`` recorded, exactly; phase
    ``launch``'s ``compile_report.json`` holds the flops of this trace of
    the launcher's config (one block of 2 rounds); the predicted peak of
    ``llm``'s round is within :data:`DRYRUN_PEAK_BAND` of the measured
    one, and its temporaries within :data:`DRYRUN_TEMP_BAND`.  Recorded beside the measurements: ``llm``'s predicted compute
    and memory terms (H100 rates) against its round's device time, and the
    time to trace granite-8b train_4k on the 16 × 16 production mesh at
    full size."""
    from repro_torch import rng
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import FakeMesh
    from repro_torch.models import build_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig

    t0 = time.perf_counter()
    axes = ("data", "model")
    grids = {}
    cfg = _llm_cfg(LLM_ARCH, LLM_LAYERS)
    keys = [rng.fold_in(SEED, r + 1) for r in range(MESH_RUN_ROUNDS)]
    for shape in MESH_SHAPES:
        fake = FakeMesh(shape, axes)
        init_fn, step, _, _ = _mesh_trainer(torch, cfg, fake, noisy=True,
                                            device="meta")
        summ = _traced(torch, init_fn, step, fake, _meta_tokens(
            torch, LLM_WORKERS // shape[0], 1, LLM_SEQ), keys)
        grids[str(shape)] = summ
    cfg2 = _llm_cfg(LLM_ARCH, MESH_SKETCH_LAYERS)
    fake = FakeMesh(MESH_SKETCH_SHAPE, axes)
    init_fn, step = _mesh_sketched_trainer(torch, cfg2, fake, noisy=True,
                                           local_steps=2, device="meta")
    grids["sketched"] = _traced(
        torch, init_fn, step, fake,
        _meta_tokens(torch, LLM_WORKERS, 1, LLM_SEQ),
        [rng.fold_in(SEED, r + 1) for r in range(MESH_SKETCH_ROUNDS)])
    collectives = {}
    for name, summ in grids.items():
        for r, live in enumerate(mesh_counts[name]):
            require(summ.mesh_stats == live, f"dryrun: the trace of "
                    f"{name}'s rounds counts {summ.mesh_stats}, rank {r} "
                    f"recorded {live}")
        collectives[name] = {"calls_and_bytes": summ.mesh_stats,
                             "by_kind_count": summ.coll_count,
                             "by_kind_bytes": summ.coll_bytes,
                             "trace_s": summ.seconds}
    del grids

    # the launcher's compile report against this trace of its config
    args = launch.parser().parse_args([*LAUNCH_ARGS, "--run-dir", "unused"])
    flcfg, acfg, ccfg = launch.configs(args, telemetry_on=True)
    per = math.gcd(args.log_every, args.rounds)
    init_fn, step = make_fl_train(
        build_model(_llm_cfg(LLM_ARCH, ROBUST_LAYERS)), flcfg, acfg, ccfg,
        device="meta")
    lsum = _traced(torch, init_fn, step, None, _meta_tokens(
        torch, args.workers, args.batch, args.seq),
        [rng.fold_in(args.seed, 2000 + r) for r in range(per)])
    require(launch_report["flops"] == lsum.flops
            and launch_report["rounds_per_dispatch"] == per,
            f"dryrun: launch's compile_report.json {launch_report} against "
            f"the dry run's {lsum.flops} flops over {per} rounds")

    # phase llm's one-device round: predicted against measured
    init_fn, step = make_fl_train(
        build_model(cfg), FLConfig(n_workers=LLM_WORKERS, local_steps=2,
                                   local_lr=LLM_LR),
        AdmmConfig(rho=0.5, flip_on_change=False),
        ChannelConfig(n_workers=LLM_WORKERS, snr_db=40.0,
                      coherence_iters=10), device="meta")
    rsum = _traced(torch, init_fn, step, None,
                   _meta_tokens(torch, LLM_WORKERS, 1, LLM_SEQ), keys[:1])
    peak = llm["peak_mem_gb"] * 1e9
    ratio = rsum.peak_bytes / peak
    temp_ratio = (rsum.peak_bytes - rsum.arg_bytes) / (peak - rsum.arg_bytes)
    lo, hi = DRYRUN_PEAK_BAND
    require(lo <= ratio <= hi, f"dryrun: llm's predicted peak "
            f"{rsum.peak_bytes / 1e9} GB is {ratio} of the measured "
            f"{peak / 1e9} GB, outside {DRYRUN_PEAK_BAND}")
    lo, hi = DRYRUN_TEMP_BAND
    require(lo <= temp_ratio <= hi, f"dryrun: llm's predicted temporaries "
            f"are {temp_ratio} of the measured peak less the state "
            f"({rsum.arg_bytes / 1e9} GB), outside {DRYRUN_TEMP_BAND}")
    compute_ms = 1e3 * rsum.flops / dryrun.PEAK_FLOPS
    memory_ms = 1e3 * rsum.mem_bytes / dryrun.HBM_BW

    # the planning question at full size: granite-8b train_4k on 16 x 16
    full = dryrun.run_one("granite-8b", "train_4k", multi_pod=False)
    emit({"phase": "dryrun", "ok": True,
          "hardware": dryrun.HARDWARE,
          "mesh_collectives": collectives,
          "launch": {"argv": LAUNCH_ARGS, "rounds_per_dispatch": per,
                     "flops": lsum.flops,
                     "compile_report_flops": launch_report["flops"],
                     "trace_s": lsum.seconds},
          "llm": {"arch": LLM_ARCH, "n_layers": LLM_LAYERS,
                  "predicted_peak_gb": rsum.peak_bytes / 1e9,
                  "predicted_args_gb": rsum.arg_bytes / 1e9,
                  "measured_peak_gb": peak / 1e9, "peak_ratio": ratio,
                  "peak_band": DRYRUN_PEAK_BAND,
                  "temp_ratio": temp_ratio, "temp_band": DRYRUN_TEMP_BAND,
                  "flops": rsum.flops, "hbm_bytes": rsum.mem_bytes,
                  "predicted_compute_ms": compute_ms,
                  "predicted_memory_ms": memory_ms,
                  "measured_device_ms": llm_prof.get("device_ms"),
                  "measured_round_ms": 1e3 * llm["seconds_per_round"],
                  "trace_s": rsum.seconds},
          "granite_train_4k_16x16": {
              "spec_s": full["timings"]["spec_s"],
              "trace_s": full["timings"]["trace_s"],
              "roofline": full["roofline"], "memory": full["memory"],
              "collectives": full["collectives"]["by_kind_count"]},
          "seconds": time.perf_counter() - t0})


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


#: a trace of at most this many events is also summed through
#: ``key_averages``, and :func:`_trace` must agree with it
TRACE_CHECK_EVENTS = 20_000
TRACE_CHECK_RTOL = 1e-9


def _trace_by_events(prof, ranges: tuple) -> dict:
    """:func:`_trace`'s sums from kineto's raw events: the device events
    grouped by (name, is a device-side range), each group's calls and µs,
    and for each name in ``ranges`` its calls on the host and the µs of the
    device events linked to a host op inside one of those calls, on its
    thread (as ``key_averages`` nests host ops and credits each device
    event to the op it links to)."""
    import bisect

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    names: dict = {}
    device: dict = {}
    ops: dict = {}
    calls = {r: {} for r in ranges}
    linked = []
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        if _filter_name(raw) or getattr(e, "is_hidden_event",
                                        lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = _rewrite_name(raw, with_wildcard=True)
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        kind = e.device_type()
        if kind == DeviceType.CPU:
            if is_async:
                continue
            span = (e.start_ns(), e.end_ns(), e.start_thread_id())
            if e.linked_correlation_id() == 0:
                ops.setdefault(e.correlation_id(), []).append(span)
            if name in calls:
                calls[name].setdefault(span[2], []).append(span[:2])
        elif kind == DeviceType.CUDA:
            ns = e.end_ns() - e.start_ns()
            if e.linked_correlation_id() > 0:
                linked.append((e.linked_correlation_id(), ns))
            got = device.setdefault((name, e.is_user_annotation()), [0, 0])
            got[0] += 1
            if not is_async:
                got[1] += ns
    spans = {}
    for r, by_thread in calls.items():
        for t in by_thread.values():
            t.sort()
        starts = {t: [s for s, _ in v] for t, v in by_thread.items()}
        ns = 0
        for corr, dur in linked:
            for start, end, thread in ops.get(corr, ()):
                if thread not in by_thread:
                    continue
                i = bisect.bisect_right(starts[thread], start) - 1
                if i >= 0 and end <= by_thread[thread][i][1]:
                    ns += dur
        spans[r] = {"calls": sum(len(v) for v in by_thread.values()),
                    "device_us": ns / 1e3}
    return {"device": {k: (n, ns / 1e3) for k, (n, ns) in device.items()},
            "spans": spans}


def _trace_by_averages(prof, ranges: tuple) -> dict:
    """:func:`_trace_by_events`'s sums through ``key_averages``."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    device = {(e.key, e.is_user_annotation): (e.count,
                                              e.self_device_time_total)
              for e in events if e.device_type == DeviceType.CUDA}
    spans = {}
    for r in ranges:
        host = [e for e in events
                if e.key == r and e.device_type == DeviceType.CPU]
        spans[r] = {"calls": host[0].count if host else 0,
                    "device_us": host[0].device_time_total if host else 0.0}
    return {"device": device, "spans": spans}


def _trace(prof, ranges: tuple = ()) -> dict:
    """The device time of one profiled call: ``kernels``, (name, calls, µs)
    of every device event of nonzero time that is not a device-side range
    (``key_averages``' CUDA events whose ``self_device_time_total`` is
    positive), ``ranges_on_device``, each device-side range's µs, and
    ``spans``, for each name in ``ranges`` its calls on the host and the
    device µs of the kernels launched inside them.  Summed from kineto's
    raw events: ``key_averages`` builds a Python object an event (~80 µs
    each on this host's CPU, tens of seconds for a full-depth round); a
    trace of at most ``TRACE_CHECK_EVENTS`` events is summed both ways and
    must agree within ``TRACE_CHECK_RTOL``."""
    got = _trace_by_events(prof, ranges)
    n_events = len(prof.profiler.kineto_results.events())
    if n_events <= TRACE_CHECK_EVENTS:
        want = _trace_by_averages(prof, ranges)

        def close(a, b):
            return abs(a - b) <= TRACE_CHECK_RTOL * max(abs(a), abs(b), 1.0)

        dev_a, dev_b = got["device"], want["device"]
        same = set(dev_a) == set(dev_b) and all(
            dev_a[k][0] == dev_b[k][0] and close(dev_a[k][1], dev_b[k][1])
            for k in dev_a) and all(
            got["spans"][r]["calls"] == want["spans"][r]["calls"]
            and close(got["spans"][r]["device_us"],
                      want["spans"][r]["device_us"]) for r in ranges)
        require(same, f"profile: the raw events' sums are not "
                f"key_averages': {got} against {want}")
    kernels = [(k, n, us) for (k, note), (n, us) in got["device"].items()
               if us > 0 and k not in ranges]
    return {"kernels": kernels, "events": n_events,
            "checked": n_events <= TRACE_CHECK_EVENTS,
            "ranges_on_device": {k: us for (k, note), (n, us)
                                 in got["device"].items() if k in ranges},
            "spans": got["spans"]}


def phase_profile(torch, path: str, run_once, round_s: float,
                  spans=()):
    """One more round of ``path`` (``run_once``) under ``torch.profiler``:
    device time of every kernel (kernel events only: ``key_averages`` also
    credits each kernel's time to the ``aten::`` op that launched it),
    grouped by family, and its share of the unprofiled round time of that
    path's phase; for each profiler range named in ``spans``, the device
    time of the kernels launched inside it (summed by :func:`_trace`, whose
    own seconds the line records).  Returns the device ms, the matrix
    products' (cuBLAS) ms and the spans' device ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    # the guarded uplink's span (core/admm.py) shows twice: on the host,
    # with the device time of the kernels launched inside it, and on the
    # device timeline, as its extent from first to last kernel
    trace = _trace(prof, (GUARD_SPAN, *MOE_SPANS))
    del prof
    kernels = trace["kernels"]
    device_ms = sum(us for _, _, us in kernels) / 1e3
    families: dict = {}
    for key, n, us in kernels:
        fam = families.setdefault(_kernel_family(key),
                                  {"calls": 0, "device_ms": 0.0})
        fam["calls"] += n
        fam["device_ms"] += us / 1e3
    top = sorted(kernels, key=lambda k: k[2], reverse=True)[:8]
    guard = None
    if trace["spans"][GUARD_SPAN]["calls"] and kernels:
        span_ms = trace["spans"][GUARD_SPAN]["device_us"] / 1e3

        def per_call(fam):
            f = families.get("port:" + fam)
            return f["device_ms"] / f["calls"] if f else 0.0

        # one unguarded fused pass: B6 (with its finalize, on either plan)
        # and one B3′
        base_ms = (per_call("round_kernel") + per_call("round_finalize_kernel")
                   + per_call("round_cols_kernel")
                   + per_call("round_energy_kernel")
                   + per_call("demodulate_kernel"))
        extent = trace["ranges_on_device"].get(GUARD_SPAN)
        guard = {"span_device_ms": span_ms, "span_share": span_ms / device_ms,
                 "beyond_one_pass_ms": span_ms - base_ms,
                 "beyond_one_pass_share": (span_ms - base_ms) / device_ms,
                 "span_extent_on_device_ms":
                 None if extent is None else extent / 1e3}
    spans_ms = {name: {"calls": trace["spans"][name]["calls"],
                       "device_ms": trace["spans"][name]["device_us"] / 1e3}
                for name in spans}
    emit({"phase": "profile", "path": path, "ok": True, "rounds": 1,
          "guard": guard, **({"spans": spans_ms} if spans else {}),
          "profiled_wall_ms": wall_ms, "round_ms": round_s * 1e3,
          "device_ms": device_ms if kernels else None,
          "busy_share": device_ms / (round_s * 1e3) if kernels else None,
          "families": families,
          "top": [{"name": key[:90], "calls": n, "device_ms": us / 1e3}
                  for key, n, us in top],
          "trace_events": trace["events"],
          "trace_checked_by_key_averages": trace["checked"],
          "trace_s": time.perf_counter() - t0})
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
        paths["microbench"] = phase_microbench(torch)
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
        paths["launch"], launch_report = phase_launch(torch)
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
        mesh_paths, mesh_counts = phase_llm_mesh(torch)
        paths.update(mesh_paths)
        phase_dryrun(torch, llm_summary, llm_prof, launch_report,
                     mesh_counts)
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
