#!/usr/bin/env python3
"""Sweep the one-pass round kernel B6 (``ota_round_stats``) on the card over
its grid and register budget, at the shapes the port's paths give it.

    python3 tools/sweep_ota_round.py

For each ``__launch_bounds__`` minimum of blocks per SM (``kMinBlocksPerSm``
at 1, 4, 6, 8: a register cap of 255, 64, 42 or 32 a thread) the source is
compiled once
into the git-ignored build directory; each build is then timed with 1, 2
and 4 columns per lane at (100, 109,386) and (65,536, 32), checked against
the plain version, and printed as one JSON line with its device time
(median of CUDA-event timings behind a GPU spin) and its bytes bound.
Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MIN_BLOCKS = (1, 4, 6, 8)
COLS_PER_LANE = (1, 2, 4)
SHAPES = ((100, 109_386), (65_536, 32))
MEM_RATE = 3.35e12           # H100 SXM, bytes/s (NVIDIA data sheet)


def _compile(build, mb):
    src = (build.CSRC / "ota_round.cu").read_text()
    src, n = re.subn(r"constexpr int kMinBlocksPerSm = \d+;",
                     f"constexpr int kMinBlocksPerSm = {mb};", src)
    if n != 1:
        raise RuntimeError("ota_round.cu has no kMinBlocksPerSm constant")
    out = build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"ota_round_mb{mb}.cu"
    cu.write_text(src)
    so = out / f"libota_round_mb{mb}.so"
    return so, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_ota_round: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ota_round, ref

    procs = {mb: _compile(build, mb) for mb in MIN_BLOCKS}
    libs = {}
    for mb, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        fn = lib.ota_round_stats
        fn.argtypes = build.SIGNATURES["ota_round"]["ota_round_stats"]
        fn.restype = ctypes.c_int
        regs = [ln.split("Used ")[1].strip() for ln in log.splitlines()
                if "Used " in ln]
        libs[mb] = (fn, regs)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for W, d in SHAPES:
        planes = [torch.randn((W, d), generator=g, device=dev)
                  * (0.05 if i == 0 else 1.0) for i in range(5)]
        want = ref.ota_round_stats(*planes, 0.5)
        nbytes = 4 * (5 * W * d + 2 * d + W)
        for k in COLS_PER_LANE:
            n_tiles = -(-d // (32 * k))
            slices = max(1, min(-(-ota_round.TARGET_BLOCKS // n_tiles),
                                -(-W // ota_round.WARPS),
                                ota_round.MAX_SLICES))
            rows = -(-W // slices)
            n_slices = -(-W // rows)
            y, p2, e = (torch.empty(n, device=dev) for n in (d, d, W))
            y_part = torch.empty((d, n_slices), device=dev)
            p2_part = torch.empty((d, n_slices), device=dev)
            e_part = torch.empty((W, n_tiles), device=dev)
            for mb, (fn, regs) in libs.items():
                def call(fn=fn):
                    err = fn(*(p.data_ptr() for p in planes), None, None,
                             None, None, None, y_part.data_ptr(),
                             p2_part.data_ptr(), e_part.data_ptr(),
                             y.data_ptr(), p2.data_ptr(), e.data_ptr(), None,
                             None, W, d, k, rows, 2.0, 0.0, 0.0, 0, stream)
                    if err:
                        raise RuntimeError(f"cudaError_t {err}")
                call()
                torch.cuda.synchronize()
                ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-3)
                         for a, b in zip((y, p2, e), want))
                ms = _time_ms(torch, call)
                print(json.dumps({
                    "shape": [W, d], "cols_per_lane": k,
                    "min_blocks_per_sm": mb, "ptxas": regs, "grid":
                    [n_tiles, n_slices], "ok": ok, "us": ms * 1e3,
                    "bound_us": nbytes / MEM_RATE * 1e6,
                    "over_bound": ms * 1e-3 / (nbytes / MEM_RATE)}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
