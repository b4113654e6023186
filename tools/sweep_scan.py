#!/usr/bin/env python3
"""Sweep the gated linear scan's plans on the card: B12 forward and backward
(``linear_scan_fwd`` / ``linear_scan_bwd``), one thread a sequence
(``"thread"``) against a walker warp fed by a TMA producer warp through a
shared-memory ring (``"staged"``).

    python3 tools/sweep_scan.py [--parts check,params,regime,threshold]

Parts (all by default), each printing one JSON line a case with its device
time (median of CUDA-event timings behind a GPU spin), its bytes bound at
the card's memory rate, and whether the plans agree bit for bit:

* ``check`` — the thread plan, the planner's staged plan and both of its
  stage lengths against the plain loops (``kernels/ref.py``) bit for bit on
  ragged shapes (S ∈ {1, 31, 32, 33, 127, 128, 129, 1,000}, D ∈ {4, 100,
  2,560}, rows ∈ {1, 3}), each launch polled with a time limit: a kernel
  that does not finish exits the script with code 3.
* ``params`` — the staged plan's channels a block (cb ∈ {8, 16, 32}), steps
  a stage (T ∈ {16 … 256}) and stages in the ring (2, 3, 4, 6) against the
  thread plan, at the shapes the paths give B12: the hybrid at full width
  (2, 4,096, 2,560), the ``llm_hybrid`` path's (4, 128, 128), the ragged
  (3, 1,000, 100) and the SSM's (2, 4,096, 131,072).
* ``regime`` — cb = 32 and seven (T, stages) pairs at (2, 4,096, D) for
  D = 256 … 8,192: where long stages give way to short ones.
* ``threshold`` — both plans, the staged one on the planner's parameters,
  over rows·D = 512 … 262,144 sequences at S ∈ {128, 1,000, 4,096},
  rows = 2: where ``scan_tiling``'s threshold belongs.

The last line is a summary: the fastest staged parameters at each
``params`` shape, the fastest (T, stages) at each ``regime`` D and, for
each S, the least sequence count from which the thread plan is at least as
fast as the staged one in both directions.

Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MEM_RATE = 3.35e12           # H100 SXM, bytes/s (NVIDIA data sheet)
PARTS = ("check", "params", "regime", "threshold")
PARAM_SHAPES = ((2, 4096, 2560), (4, 128, 128), (3, 1000, 100),
                (2, 4096, 131_072))
WATCHDOG_S = 20.0


def _time_ms(torch, fn, runs=25):
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _emit(**row):
    if "us" in row and "bound_us" in row:
        row["over_bound"] = row["us"] / row["bound_us"]
    print(json.dumps(row), flush=True)


def _bound_us(direction, rows, S, D):
    """Bytes the function must move over the card's memory rate: the
    forward reads a_1 … a_{S−1} and all of b and writes h; the backward
    reads a_1 … a_{S−1}, h_0 … h_{S−2} and all of dh and writes da, g."""
    n, n1 = rows * S * D, rows * (S - 1) * D
    nbytes = 4 * (n1 + 2 * n) if direction == "fwd" else 4 * (2 * n1 + 3 * n)
    return nbytes / MEM_RATE * 1e6


def _inputs(torch, rows, S, D, seed=19):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    a = torch.sigmoid(2.0 * torch.randn((rows, S, D), generator=g,
                                        device="cuda"))
    b = torch.randn((rows, S, D), generator=g, device="cuda")
    dh = torch.randn((rows, S, D), generator=g, device="cuda")
    return a, b, dh


def _watched(torch, fn, what):
    """fn(), then wait for the card with a time limit: a launch that never
    finishes (a TMA load that never lands on its mbarrier) ends the script
    rather than the machine's time."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > WATCHDOG_S:
            print(json.dumps({"part": "check", "ok": False, "hung": what}),
                  flush=True)
            import os
            os._exit(3)
        time.sleep(0.01)
    return out


def _run(ls, direction, a, b, h, dh, plan):
    if direction == "fwd":
        return (ls.linear_scan_fwd(a, b, plan),)
    return ls.linear_scan_bwd(a, h, dh, plan)


def part_check(torch):
    from repro_torch.kernels import linear_scan as ls, ref

    bad = 0
    for rows in (1, 3):
        for S in (1, 31, 32, 33, 127, 128, 129, 1000):
            for D in (4, 100, 2560):
                a, b, dh = _inputs(torch, rows, S, D)
                h = ref.linear_scan(a, b)
                want_bwd = ref.linear_scan_bwd(a, h, dh)
                plans = [ls.resolve_plan("check", p, rows, S, D)
                         for p in ls.PLANS]
                plans += [ls.ScanTiling("staged", ls.STAGED_CHANNELS, *st)
                          for st in (ls.LONG_STAGES, ls.SHORT_STAGES)]
                for t in plans:
                    got_h = _watched(torch, lambda: ls.linear_scan_fwd(
                        a, b, t), f"fwd {list(t)} {(rows, S, D)}")
                    got = _watched(torch, lambda: ls.linear_scan_bwd(
                        a, h, dh, t), f"bwd {list(t)} {(rows, S, D)}")
                    ok = bool(torch.equal(got_h, h)) and all(
                        bool(torch.equal(x, y)) for x, y in zip(got,
                                                                 want_bwd))
                    bad += not ok
                    _emit(part="check", shape=[rows, S, D], tiling=list(t),
                          bitwise=ok)
    if bad:
        print(json.dumps({"part": "check", "ok": False, "failed": bad}),
              flush=True)
        sys.exit(1)


def part_params(torch, summary):
    from repro_torch.kernels import linear_scan as ls

    for rows, S, D in PARAM_SHAPES:
        a, b, dh = _inputs(torch, rows, S, D)
        h = ls.linear_scan_fwd(a, b, "thread")
        for direction in ("fwd", "bwd"):
            want = _run(ls, direction, a, b, h, dh, "thread")
            bound = _bound_us(direction, rows, S, D)
            us = _time_ms(torch, lambda: _run(ls, direction, a, b, h, dh,
                                              "thread")) * 1e3
            _emit(part="params", dir=direction, shape=[rows, S, D],
                  plan="thread", us=us, bound_us=bound)
            best = None
            for cb in (8, 16, 32):
                for T in (16, 32, 64, 128, 256):
                    for stages in (2, 3, 4, 6):
                        t = ls.ScanTiling("staged", cb, T, stages)
                        try:
                            got = _run(ls, direction, a, b, h, dh, t)
                        except RuntimeError:  # the ring exceeds 227 KB
                            continue
                        same = all(bool(torch.equal(x, y))
                                   for x, y in zip(got, want))
                        del got
                        us_t = _time_ms(torch, lambda t=t: _run(
                            ls, direction, a, b, h, dh, t)) * 1e3
                        _emit(part="params", dir=direction,
                              shape=[rows, S, D], plan="staged",
                              tiling=list(t), bitwise_thread=same, us=us_t,
                              bound_us=bound, thread_us=us)
                        if same and (best is None or us_t < best[0]):
                            best = (us_t, list(t))
            summary.setdefault("params", {})[f"{direction} {rows, S, D}"] = {
                "thread_us": us, "best_staged_us": best[0] if best else None,
                "best_staged": best[1] if best else None, "bound_us": bound}
        del a, b, dh, h
        torch.cuda.empty_cache()


def part_regime(torch, summary):
    from repro_torch.kernels import linear_scan as ls

    pairs = ((16, 4), (32, 3), (32, 4), (64, 2), (64, 3), (128, 2), (128, 3))
    for D in (256, 1024, 2048, 2560, 4096, 8192):
        shape = (2, 4096, D)
        a, b, dh = _inputs(torch, *shape)
        h = ls.linear_scan_fwd(a, b, "thread")
        for direction in ("fwd", "bwd"):
            times = {}
            for T, stages in pairs:
                t = ls.ScanTiling("staged", ls.STAGED_CHANNELS, T, stages)
                times[f"{T}x{stages}"] = _time_ms(torch, lambda: _run(
                    ls, direction, a, b, h, dh, t)) * 1e3
            _emit(part="regime", dir=direction, shape=list(shape),
                  sequences=2 * D, us_by_steps_x_stages=times,
                  planner=list(ls.staged_tiling(2, D)),
                  bound_us=_bound_us(direction, *shape))
            summary.setdefault("regime", {})[f"{direction} {D}"] = min(
                times, key=times.get)
        del a, b, dh, h
        torch.cuda.empty_cache()


def part_threshold(torch, summary):
    from repro_torch.kernels import linear_scan as ls

    rows = 2
    for S in (128, 1000, 4096):
        cross = None
        for p in range(9, 19):
            D = (1 << p) // rows
            a, b, dh = _inputs(torch, rows, S, D)
            h = ls.linear_scan_fwd(a, b, "thread")
            t = ls.staged_tiling(rows, D)
            thread_wins = True
            for direction in ("fwd", "bwd"):
                want = _run(ls, direction, a, b, h, dh, "thread")
                got = _run(ls, direction, a, b, h, dh, t)
                same = all(bool(torch.equal(x, y)) for x, y in zip(got, want))
                del got, want
                us = _time_ms(torch, lambda: _run(ls, direction, a, b, h, dh,
                                                  "thread")) * 1e3
                us_t = _time_ms(torch, lambda: _run(ls, direction, a, b, h,
                                                    dh, t)) * 1e3
                _emit(part="threshold", dir=direction, shape=[rows, S, D],
                      sequences=rows * D, tiling=list(t), staged_us=us_t,
                      thread_us=us, bitwise_thread=same,
                      bound_us=_bound_us(direction, rows, S, D),
                      planner=ls.scan_tiling(rows, S, D).plan)
                thread_wins = thread_wins and us <= us_t
            if thread_wins and cross is None:
                cross = rows * D
            del a, b, dh, h
            torch.cuda.empty_cache()
        summary.setdefault("thread_from_sequences", {})[str(S)] = cross


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    parts = args.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}; the parts are {PARTS}")
    import torch

    if not torch.cuda.is_available():
        print("sweep_scan: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, linear_scan as ls

    build.build(["linear_scan"])
    summary = {"card": torch.cuda.get_device_name(0),
               "planner": {"staged_below_per_sm": ls.STAGED_BELOW_PER_SM,
                           "channels": ls.STAGED_CHANNELS,
                           "long_stages_below_per_sm":
                           ls.LONG_STAGES_BELOW_PER_SM,
                           "long": ls.LONG_STAGES,
                           "short": ls.SHORT_STAGES}}
    if "check" in parts:
        part_check(torch)
    if "params" in parts:
        part_params(torch, summary)
    if "regime" in parts:
        part_regime(torch, summary)
    if "threshold" in parts:
        part_threshold(torch, summary)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
