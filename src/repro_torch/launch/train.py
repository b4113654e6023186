"""Training launcher: federated A-FADMM training of an LLM the port builds.
Counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --reduced --rounds 50 --workers 4 --local-steps 2 [--device cpu]

The reference's flags, parsing and output lines (``round …``, ``resumed
from round N``, ``autotune[cache|measured]: …``, ``done: …``,
``profile: …``), plus ``--device`` (the card unless ``cpu`` is asked for).
Drivers: ``--driver loop`` runs one round a step and reads its metrics back;
``--driver scan`` runs blocks of ``gcd(log_every, rounds − r0)`` rounds
with one host copy of their stacked metrics a block.  Round r's batch key
is ``fold_in(key, 1000 + r)`` and its round key ``fold_in(key, 2000 + r)``,
by the global index, so a resumed run (``--checkpoint-dir`` +
``--resume``) equals the uninterrupted one bit for bit.

``--mode sketched`` runs A-FADMM-CS (one shared model, (W, d_s) duals;
``--sketch-ratio``, ``--sketch-lr``): its state's fields (``Theta``,
``lam``, ``chan``, ``step``, ``flt``) are the snapshot's keys, as the
reference writes them.  Every arch trains: a round's batch adds the stub
patches (vlm) or frames (audio) to the tokens.

``--fsdp N`` (N > 1) trains either mode on the reference's ``(n // N, N,
1)`` (data, fsdp, model) mesh of the ``n`` ranks that
``torch.distributed.run`` starts:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch granite-8b --reduced --fsdp 2 \
        [--mode sketched]

Each rank joins the process group with the backend ``launch.mesh`` picks
(NCCL where every rank has a card, gloo where ranks share one or run on
the CPU), builds the batch of all workers from the round key and keeps its
workers' rows (the replicated mode) or its rows of every worker's batch
(the sketched mode, whose Θ the fsdp axis shards).  Only rank 0 writes
the run dir, the log lines and the snapshots (``checkpoint.save_sharded``:
the JAX package's global layout; every rank restores its part).  Refused
by name: an N that does not divide the rank count (a CLI error that says
"must divide"), workers (replicated) or a batch (sketched) that do not
split over the data ranks, and ``--population`` in the sketched mode (the
trainer's ValueError).

With ``--run-dir`` the launcher traces one dispatch (one round, or one
block of the scan driver) of the same trainer on ``meta`` tensors under a
fake-rank copy of its mesh before the first round
(``launch/trace_analysis.py``, the reference's AOT compile) and writes
``compile_report.json`` (``obs.profiling.compile_report``, with
``trace_seconds`` and ``rounds_per_dispatch``); the manifest points to
it.  A trace that fails is printed and recorded in the manifest, and the
run goes on.

:func:`run` takes the parsed arguments and, optionally, a model built by
the caller (a full-width model cut to fewer layers, say); :func:`main`
parses ``argv`` and calls it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch import rng
from repro_torch.checkpoint import (gather_fl_state, latest_round, restore,
                                    restore_sharded, round_path, save,
                                    save_sharded)
from repro_torch.core.admm import AdmmConfig
from repro_torch.core.aggregators import stack_rows
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.synthetic import token_dataset
from repro_torch.core.tree_ota import shard_coords
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (fsdp_mesh_shape, init_distributed,
                                     make_mesh)
from repro_torch.models.registry import (Model, get_model, list_archs,
                                         packed_param_count)
from repro_torch.phy import list_scenarios
from repro_torch.train.llm_trainer import FLConfig, make_fl_train

#: the file the launcher's trace of one dispatch writes into the run dir
COMPILE_REPORT = "compile_report.json"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run takes (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--mode", default="replicated",
                    choices=["replicated", "sketched"])
    ap.add_argument("--sketch-ratio", type=int, default=256,
                    help="sketched mode: compression ratio, "
                         "d_s = ceil(packed_size / ratio)")
    ap.add_argument("--sketch-lr", type=float, default=1.0,
                    help="step size applied to the decoded sketch delta")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="shard parameters over an 'fsdp' mesh axis of this "
                         "size: the (n // N, N, 1) (data, fsdp, model) mesh "
                         "of the n ranks torch.distributed.run starts")
    ap.add_argument("--backend", default=None, choices=["jnp", "pallas"],
                    help="OTA transport backend (the port takes 'pallas', "
                         "its kernels, and refuses 'jnp')")
    ap.add_argument("--driver", default="loop", choices=["loop", "scan"],
                    help="round driver: one round and one host read a step, "
                         "or blocks of --log-every rounds and one host copy "
                         "a block")
    ap.add_argument("--scenario", default=None, choices=list_scenarios(),
                    help="repro_torch.phy wireless scenario preset (default: "
                         "the block-fading channel)")
    ap.add_argument("--doppler-hz", type=float, default=None,
                    help="override the scenario's Doppler frequency "
                         "(rho = J0(2*pi*f_d*T))")
    ap.add_argument("--csi-err", type=float, default=None,
                    help="worker CSI error std sigma_e "
                         "(h_hat = h + CN(0, sigma_e^2))")
    ap.add_argument("--h-min", type=float, default=None,
                    help="deep-fade truncation threshold on the per-worker "
                         "RMS |h| (workers below it skip the round)")
    ap.add_argument("--slots-per-round", type=int, default=None,
                    help="wall-clock slots the scenario physics advances "
                         "per round (default: the preset's 1)")
    ap.add_argument("--ota-fused", default=None, choices=["on", "off"],
                    help="one-pass fused OTA receive (default on; off keeps "
                         "the composed per-primitive chain)")
    ap.add_argument("--ota-worker-chunk", type=int, default=None,
                    help="stream the receive over worker cohorts of this "
                         "size (0/None = monolithic, or set "
                         "REPRO_OTA_WORKER_CHUNK)")
    ap.add_argument("--ota-block-rows", type=int, default=None,
                    help="population kernel block size (sets "
                         "REPRO_OTA_BLOCK_ROWS)")
    ap.add_argument("--ota-block-cols", type=int, default=None,
                    help="fused-round kernel column tile, which picks its "
                         "plan (32, 64, 96, 128; 256, 1024 at W <= 16; or "
                         "REPRO_OTA_BLOCK_COLS)")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--population", type=int, default=None,
                    help="worker-population size N: state carries N rows "
                         "while only --cohort workers uplink per round")
    ap.add_argument("--cohort", type=int, default=None,
                    help="workers sampled per round (requires --population; "
                         "cohort == population disables sampling bitwise)")
    ap.add_argument("--cohort-policy", default="uniform",
                    choices=["uniform", "top-gain", "prop-h2"],
                    help="cohort sampling policy")
    ap.add_argument("--autotune-cache", default=None,
                    help="JSON file caching the autotuned OTA round plan and "
                         "worker cohort per (W, d, device); measured once, "
                         "reused across runs — fills REPRO_OTA_BLOCK_COLS / "
                         "REPRO_OTA_WORKER_CHUNK unless set explicitly")
    ap.add_argument("--batch", type=int, default=2, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-lr", type=float, default=1e-2)
    ap.add_argument("--rho", type=float, default=0.5)
    ap.add_argument("--snr-db", type=float, default=40.0)
    ap.add_argument("--coherence", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    # --- fault injection / round health guard (repro_torch.faults) ---------
    ap.add_argument("--crash-prob", type=float, default=0.0,
                    help="per-round per-worker permanent-crash hazard")
    ap.add_argument("--crash-at", default=None,
                    help="deterministic crash schedule 'round:worker,...'")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="per-round probability a worker uploads its stale "
                         "snapshot instead of the fresh model")
    ap.add_argument("--straggler-delay", type=int, default=4)
    ap.add_argument("--nan-workers", type=int, default=0,
                    help="workers [0,k) corrupt every upload")
    ap.add_argument("--corrupt-prob", type=float, default=0.0)
    ap.add_argument("--corrupt-mode", default="nan",
                    choices=["nan", "inf", "spike"])
    ap.add_argument("--burst-prob", type=float, default=0.0,
                    help="per-round PS interference-burst hazard")
    ap.add_argument("--burst-std", type=float, default=10.0)
    ap.add_argument("--guard", default=None,
                    choices=["skip", "retransmit", "evict",
                             "evict-retransmit"],
                    help="round health guard policy (default: no guard)")
    ap.add_argument("--snr-floor-db", type=float, default=None,
                    help="guard receive-SNR floor (default: finiteness "
                         "check only)")
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--power-backoff", type=float, default=2.0,
                    help="per-retry transmit power ramp gamma")
    # --- durable progress (checkpoint/resume) ------------------------------
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for periodic full-state snapshots "
                         "(round_NNNNNNNN.npz)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot cadence in rounds (scan driver: at the "
                         "first block boundary crossing each multiple)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest snapshot in "
                         "--checkpoint-dir; bitwise the uninterrupted run")
    # --- observability (repro_torch.obs) -----------------------------------
    ap.add_argument("--run-dir", default=None,
                    help="structured run logs: manifest.json + one "
                         "metrics.jsonl event per round (every round, both "
                         "drivers); --resume appends to the same log")
    ap.add_argument("--telemetry", default=None, choices=["on", "off"],
                    help="obs/ channel telemetry (default: on iff --run-dir "
                         "is set; off is bitwise the trainer without it)")
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler trace into RUN_DIR/trace plus "
                         "wall-clock spans (s/block series) in "
                         "RUN_DIR/profile.json")
    return ap


def _faults(args):
    crash_at = ()
    if args.crash_at:
        crash_at = tuple(tuple(int(x) for x in pair.split(":"))
                         for pair in args.crash_at.split(","))
    faults = guard = None
    if (args.crash_prob > 0 or crash_at or args.straggler_prob > 0
            or args.nan_workers > 0 or args.corrupt_prob > 0
            or args.burst_prob > 0):
        from repro_torch.faults import FaultPlan
        faults = FaultPlan(
            crash_prob=args.crash_prob, crash_at=crash_at,
            straggler_prob=args.straggler_prob,
            straggler_delay=args.straggler_delay,
            nan_workers=args.nan_workers, corrupt_prob=args.corrupt_prob,
            corrupt_mode=args.corrupt_mode, burst_prob=args.burst_prob,
            burst_std=args.burst_std)
    if args.guard is not None:
        from repro_torch.faults import GuardConfig
        guard = GuardConfig(policy=args.guard,
                            snr_floor_db=args.snr_floor_db,
                            max_retries=args.max_retries,
                            power_backoff=args.power_backoff)
    return faults, guard


def _log(r: int, metrics: dict) -> None:
    """stdout keeps the scalar summary; vector leaves (obs/tx_energy) only
    go to the structured sink."""
    m = {k: float(v) for k, v in metrics.items()
         if not k.startswith("_") and torch.as_tensor(v).dim() == 0}
    rest = {k: round(v, 4) for k, v in m.items() if k != "loss"}
    print(f"round {r:4d}  loss={m['loss']:.4f}  {json.dumps(rest)}",
          flush=True)


def configs(args: argparse.Namespace, telemetry_on: bool):
    """The run's ``(FLConfig, AdmmConfig, ChannelConfig)`` from the parsed
    flags (``telemetry_on``: the ``obs/`` keys, on with ``--run-dir``
    unless ``--telemetry`` says otherwise)."""
    faults, guard = _faults(args)
    flcfg = FLConfig(mode=args.mode, n_workers=args.workers,
                     local_steps=args.local_steps, local_lr=args.local_lr,
                     sketch_ratio=args.sketch_ratio,
                     sketch_lr=args.sketch_lr,
                     transport_backend=args.backend,
                     scenario=args.scenario, doppler_hz=args.doppler_hz,
                     csi_err=args.csi_err, h_min=args.h_min,
                     slots_per_round=args.slots_per_round,
                     ota_fused=None if args.ota_fused is None
                     else args.ota_fused == "on",
                     ota_worker_chunk=args.ota_worker_chunk,
                     ota_block_cols=args.ota_block_cols,
                     faults=faults, guard=guard,
                     telemetry=True if telemetry_on else None,
                     population=args.population, cohort=args.cohort,
                     cohort_policy=args.cohort_policy)
    acfg = AdmmConfig(rho=args.rho, flip_on_change=False)
    ccfg = ChannelConfig(n_workers=args.population or args.workers,
                         snr_db=args.snr_db, coherence_iters=args.coherence)
    return flcfg, acfg, ccfg


def trace_dispatch(model: Model, flcfg: FLConfig, acfg: AdmmConfig,
                   ccfg: ChannelConfig, mesh, key: int, batch: dict,
                   rounds: Sequence[int]):
    """The trace of one dispatch: ``rounds`` (their global indices) of the
    trainer on ``meta`` tensors, as rank 0 of a fake-rank copy of
    ``mesh`` (None: one device), from its init at ``key`` on the rank's
    ``batch`` shapes.  Returns the ``TraceSummary``."""
    from repro_torch.launch.mesh import FakeMesh
    from repro_torch.launch.trace_analysis import tracing

    fake = None if mesh is None else FakeMesh(
        tuple(mesh.shape[a] for a in mesh.axis_names), mesh.axis_names)
    init_fn, train_step = make_fl_train(model, flcfg, acfg, ccfg, mesh=fake,
                                        device="meta")
    st = init_fn(key)
    mb = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    with tracing(fake, (st, mb)) as tr:
        for r in rounds:
            st, _ = train_step(st, mb, key=rng.fold_in(key, 2000 + r))
    return tr.summary()


def run(args: argparse.Namespace, model: Optional[Model] = None) -> dict:
    """Train per ``args`` (:func:`parser`'s namespace), on ``model`` if
    given (else ``get_model(args.arch, reduced=args.reduced)``).  Returns
    ``{"state", "losses", "seconds", "rounds", "autotune", "trace"}``: the
    final trainer state, every round's loss this run, the wall seconds and
    the number of this run's rounds, the autotune result (or None) and the
    profiler's Chrome trace path (or None)."""
    mesh = None
    if args.fsdp > 1:
        try:
            shape = fsdp_mesh_shape(int(os.environ.get("WORLD_SIZE", 1)),
                                    args.fsdp)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if args.population is not None and args.cohort is None:
        raise SystemExit("--population requires --cohort (use "
                         "--cohort == --population to disable sampling)")
    if args.ota_block_rows is not None:
        # the knobs are read when a round runs (repro_torch.optflags)
        os.environ["REPRO_OTA_BLOCK_ROWS"] = str(args.ota_block_rows)
    dev = resolve_device(args.device)
    if args.fsdp > 1:
        if dev.type == "cuda" and dev.index is None:
            # a card a rank where there are enough, else the ranks share
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        init_distributed(dev)
        mesh = make_mesh(shape, ("data", "fsdp", "model"), dev)
    main_rank = mesh is None or torch.distributed.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    telemetry_on = (args.telemetry == "on") if args.telemetry is not None \
        else args.run_dir is not None

    key = args.seed
    if model is None:
        model = get_model(args.arch, reduced=args.reduced)
    cfg = model.cfg
    W = args.workers
    #: rows the batch (and the uplink) carries per round: the cohort width
    #: under population sampling, else every worker
    W_round = args.cohort if args.population is not None else W
    flcfg, acfg, ccfg = configs(args, telemetry_on)
    init_fn, train_step = make_fl_train(model, flcfg, acfg, ccfg, mesh=mesh,
                                        device=dev)

    sink = timer = None
    if args.run_dir or args.profile:
        from repro_torch.obs.profiling import SpanTimer
        timer = SpanTimer()

    tuned = None
    if args.autotune_cache and mesh is not None:
        say("autotune: skipped (one device only)", flush=True)
    elif args.autotune_cache:
        if args.mode == "replicated" and (flcfg.packed_uplink is not False
                                          or args.scenario is not None):
            from repro_torch.core.transport import autotune_ota_round_cached
            # before the state exists: the sweep's (W, D) planes are gone
            # when the run's are made
            tuned = autotune_ota_round_cached(
                W_round, packed_param_count(cfg), ccfg,
                cache_path=args.autotune_cache, device=dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            best = tuned["best"]
            # explicit flags win over the autotuner
            if args.ota_block_cols is None:
                os.environ["REPRO_OTA_BLOCK_COLS"] = str(best["block_cols"])
            if args.ota_worker_chunk is None:
                os.environ["REPRO_OTA_WORKER_CHUNK"] = \
                    str(best["worker_chunk"])
            print(f"autotune[{'cache' if tuned['cached'] else 'measured'}]"
                  f": block_cols={best['block_cols']} "
                  f"worker_chunk={best['worker_chunk']}", flush=True)
        else:
            print("autotune: skipped (replicated packed state only)",
                  flush=True)

    # per-worker non-IID token streams, cohort-wide under sampling
    data = token_dataset(rng.fold_in(key, 1), n_sequences=64,
                         seq_len=args.seq, vocab_size=cfg.vocab_size,
                         n_workers=W_round, device=dev)
    st = init_fn(key)
    # the batch rows of this rank: its workers' (replicated), or its rows
    # of every worker's batch (sketched)
    mine = (slice(None),)
    if mesh is not None:
        sspec = init_fn.layout["sspec"]
        faxes = init_fn.layout.get("faxes", ("fsdp",))
        c = shard_coords(mesh)
        flag, n = (("--workers", W_round) if args.mode == "replicated"
                   else ("--batch", args.batch))
        if n % c.n_data:
            raise SystemExit(f"{flag} {n} does not split over the "
                             f"{c.n_data} data ranks")
        part = slice(c.jd * (n // c.n_data), (c.jd + 1) * (n // c.n_data))
        mine = (part,) if args.mode == "replicated" else (slice(None), part)

    def snapshot(path: str, st) -> None:
        if mesh is None:
            save(path, st)
        else:
            save_sharded(path, st, mesh, sspec, faxes)

    r0 = 0
    if args.resume and args.checkpoint_dir:
        latest = latest_round(args.checkpoint_dir)
        if latest is not None:
            path = round_path(args.checkpoint_dir, latest)
            st = (restore(path, st) if mesh is None
                  else restore_sharded(path, st, mesh, sspec, faxes))
            r0 = latest
            say(f"resumed from round {r0} ({path})", flush=True)

    def maybe_checkpoint(stop: int, st, last: int) -> int:
        """Snapshot the whole trainer state (θ, λ, Θ, channel and fault
        state: every random plane comes from the global round index, so
        the snapshot alone resumes bit for bit)."""
        if (args.checkpoint_dir and args.checkpoint_every > 0
                and (stop - last >= args.checkpoint_every
                     or stop == args.rounds)):
            snapshot(round_path(args.checkpoint_dir, stop), st)
            return stop
        return last

    def make_batch(r: int) -> dict:
        """Round r's batch: each worker's sequences, and the stub
        frontend's embeddings (the vlm's patches, the audio enc-dec's
        frames) drawn from the same generator, as the reference draws
        them from the round's key."""
        gen = rng.generator(rng.fold_in(key, 1000 + r), dev)
        idx = torch.randint(0, data.shape[1], (W_round, args.batch),
                            generator=gen, device=dev)
        batch = {"tokens": torch.gather(
            data, 1, idx[:, :, None].expand(-1, -1, data.shape[2]))}
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(
                (W_round, args.batch, cfg.frontend_tokens, cfg.frontend_dim),
                generator=gen, device=dev)
        if cfg.family == "audio":
            batch["frames"] = torch.randn(
                (W_round, args.batch, cfg.frontend_tokens, cfg.d_model),
                generator=gen, device=dev)
        return {k: v[mine] for k, v in batch.items()}

    def step(st, r: int):
        return train_step(st, make_batch(r), key=rng.fold_in(key, 2000 + r))

    if args.run_dir and main_rank:
        from repro_torch.obs.profiling import compile_report
        from repro_torch.obs.sink import MetricsSink, run_manifest
        # one dispatch: a round, or a block of the scan driver
        per = (max(1, math.gcd(args.log_every, args.rounds - r0))
               if args.driver == "scan" else 1)
        report = why = None
        os.makedirs(args.run_dir, exist_ok=True)
        try:
            t_tr = time.time()
            summary = trace_dispatch(model, flcfg, acfg, ccfg, mesh, key,
                                     make_batch(r0), range(r0, r0 + per))
            compile_report(summary, os.path.join(args.run_dir,
                                                 COMPILE_REPORT),
                           trace_seconds=time.time() - t_tr,
                           rounds_per_dispatch=per)
            report = COMPILE_REPORT
        except Exception as e:
            why = f"trace failed: {type(e).__name__}: {e}"
            print(f"obs: compile report unavailable ({why})", flush=True)
        sink = MetricsSink(args.run_dir, resume=args.resume)
        sink.write_manifest(run_manifest(
            arch=args.arch, reduced=args.reduced, mode=args.mode,
            driver=args.driver, backend=args.backend, device=str(dev),
            telemetry=telemetry_on, rounds=args.rounds, workers=W,
            seed=args.seed, log_every=args.log_every,
            mesh_shape=None if mesh is None else dict(mesh.shape),
            model=dataclasses.asdict(cfg),
            flconfig=dataclasses.asdict(flcfg),
            admm=dataclasses.asdict(acfg),
            channel=dataclasses.asdict(ccfg),
            compile_report=report, compile_report_why=why,
            argv=vars(args)))
        if r0 > 0:
            sink.log_resume(r0)

    trace_ctx = contextlib.nullcontext(None)
    if args.profile and args.run_dir and main_rank:
        from repro_torch.obs.profiling import trace_session
        trace_ctx = trace_session(os.path.join(args.run_dir, "trace"))

    losses = []
    t0 = time.time()
    with trace_ctx as trace:
        last = r0
        if args.driver == "scan":
            block = max(1, math.gcd(args.log_every, args.rounds - r0))
            for start in range(r0, args.rounds, block):
                tb = time.time()
                rows: dict = {}
                for r in range(start, start + block):
                    st, m = step(st, r)
                    for k, v in m.items():
                        if not k.startswith("_"):
                            rows.setdefault(k, []).append(v)
                # the block's one host copy (the timing is then real)
                ms = {k: stack_rows(v).cpu() for k, v in rows.items()}
                del rows
                bs = time.time() - tb
                if timer is not None:
                    timer.add("execute", bs)
                if sink is not None:
                    sink.log_rounds(start, ms)
                    sink.log_block(start + block - 1, bs, block)
                losses += ms["loss"].tolist()
                if main_rank:
                    _log(start + block - 1,
                         {k: v[-1] for k, v in ms.items()})
                last = maybe_checkpoint(start + block, st, last)
        else:
            for r in range(r0, args.rounds):
                tr = time.time()
                st, metrics = step(st, r)
                metrics = {k: v.cpu() if torch.is_tensor(v) else v
                           for k, v in metrics.items()
                           if not k.startswith("_")}
                if timer is not None:
                    timer.add("execute", time.time() - tr)
                if sink is not None:
                    sink.log_round(r, metrics)
                losses.append(float(metrics["loss"]))
                if main_rank and (r % args.log_every == 0
                                  or r == args.rounds - 1):
                    _log(r, metrics)
                last = maybe_checkpoint(r + 1, st, last)
        dt = time.time() - t0      # the rounds, not the trace's export
    say(f"done: {args.rounds} rounds in {dt:.1f}s "
        f"({dt / args.rounds:.2f}s/round)", flush=True)
    if sink is not None:
        sink.log_done(args.rounds - r0, dt)
        sink.close()
    trace_path = None if trace is None else trace.path
    if timer is not None:
        summ = timer.summary()
        if args.run_dir and main_rank:
            with open(os.path.join(args.run_dir, "profile.json"), "w") as f:
                json.dump({"spans": summ, "series": timer.series,
                           "trace": trace_path,
                           "trace_error": None if trace is None
                           else trace.error}, f, indent=2, sort_keys=True)
                f.write("\n")
        parts = ", ".join(f"{k}={v['seconds']:.2f}s/{int(v['count'])}x"
                          for k, v in sorted(summ.items()))
        say(f"profile: {parts}", flush=True)

    if args.checkpoint:
        Theta = (st.Theta if mesh is None
                 else gather_fl_state(st, mesh, sspec, faxes).Theta)
        if main_rank:
            save(args.checkpoint, Theta)
        say(f"saved global model to {args.checkpoint}")
    return {"state": st, "losses": losses, "seconds": dt,
            "rounds": args.rounds - r0, "autotune": tuned,
            "trace": trace_path}


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
