#!/usr/bin/env python3
"""Sweep the OTA round kernels' plans on the card: B6/B7 (``ota_round_stats``
/ ``ota_round_theta``) and B2 (``ota_receive``).

    python3 tools/sweep_ota_round.py [--parts column,threshold,receive,row]
                                     [--parent DIR]

Parts (all but ``row`` by default), each printing one JSON line a case with
its device time (median of CUDA-event timings behind a GPU spin), its bytes
bound at the card's memory rate and whether it agrees with the plain
version:

* ``column`` — the column plan's ``__launch_bounds__`` minimum of blocks
  per SM (``kColMinBlocksPerSm`` 2, 3, 4: a register cap of 128, 85 or 64;
  one nvcc each, swapped in under the wrappers) × its grid's blocks per SM
  (1–8) and its scalar loads, against the row plan, for B6 and B7 at the
  LLM rounds' (2, 637,554,688) and (2, 476,967,488) (~26 GB of planes).
* ``threshold`` — row against column plan for W = 2 … 16 at W·d = 2²⁷ and
  at d = 109,386: where the column plan's threshold on W belongs.
* ``receive`` — B2 at (65,536, 32) unsplit and split toward 132 … 8,448
  blocks; split against unsplit over W = 16 … 16,384 at d = 32 (the split's
  least W), and both at (100, 109,386).
* ``row`` — the row plan's ``__launch_bounds__`` minimum of blocks per SM
  (``kMinBlocksPerSm`` 1, 4, 6, 8: a register cap of 255, 64, 42 or 32 a
  thread; one nvcc each into the git-ignored build directory) × 1, 2 and 4
  columns per lane at (100, 109,386) and (65,536, 32).

``--parent DIR``: DIR holds an earlier checkout of the repo (``git
archive``); its ``ota.cu`` and ``ota_round.cu`` are built and the row plan
of B6/B7 at (100, 109,386) and (65,536, 32) and the unsplit B2 at
(100, 109,386) are compared bit for bit with this tree's.

Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MEM_RATE = 3.35e12           # H100 SXM, bytes/s (NVIDIA data sheet)
LLM_SHAPES = ((2, 637_554_688), (2, 476_967_488))
PARTS = ("column", "threshold", "receive", "row")


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


def _planes(torch, W, d, n, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.randn((W, d), generator=g, device="cuda")
            * (0.05 if i == 0 else math.sqrt(0.5)) for i in range(n)]


def _close(torch, got, want, rtol, atol):
    return all(torch.allclose(a, b, rtol=rtol, atol=atol)
               for a, b in zip(got, want))


def _round_bytes(W, d, theta=False):
    return 4 * (5 * W * d + (2 * d if theta else 2 * d + W))


def _variants(build, lib, const, values):
    """``csrc/<lib>.cu`` with ``constexpr int <const>`` set to each value,
    built into the git-ignored build directory, one nvcc each, all at once:
    {value: (library path, ptxas's register lines)}."""
    out = build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{lib}.cu").read_text()
    procs = {}
    for v in values:
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {v};", src)
        if n != 1:
            raise RuntimeError(f"{lib}.cu has no {const} constant")
        cu = out / f"{lib}_{const}{v}.cu"
        cu.write_text(text)
        so = out / f"lib{lib}_{const}{v}.so"
        procs[v] = (so, _nvcc(build, cu, so))
    built = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(log)
        built[v] = (so, [ln.split("Used ")[1].strip()
                         for ln in log.splitlines() if "Used " in ln])
    return built


def _install(build, lib, so):
    """Load ``so`` as library ``lib``: the wrappers launch its kernels."""
    build._loaded[lib] = dll = ctypes.CDLL(str(so))
    for name, argtypes in build.SIGNATURES[lib].items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def part_column(torch):
    from repro_torch.kernels import build, ota_round

    variants = _variants(build, "ota_round", "kColMinBlocksPerSm", (2, 3, 4))
    for lb, (so, regs) in variants.items():
        _install(build, "ota_round", so)
        _column_cases(torch, lb, regs)
    build._loaded.pop("ota_round")


def _column_cases(torch, lb, regs):
    from repro_torch.kernels import ota_round, ref

    n_sm = ota_round.sm_count(torch.device("cuda"))
    for W, d in LLM_SHAPES:
        planes = _planes(torch, W, d, 5, 1)
        noise = torch.randn(d, device="cuda") * 1e-3
        ia = torch.tensor(0.37, device="cuda")
        want = ref.ota_round_stats(*planes, 0.5)
        want_theta = ref.ota_demodulate_dyn(want[0], noise, want[1], ia)
        plans = [("row", ota_round.row_tiling(W, d))] if lb == 2 else []
        plans += [(f"column bps={b}", ota_round.column_tiling(
            W, d, n_sm, blocks_per_sm=b)) for b in (1, 2, 3, 4, 6, 8)]
        plans.append(("column scalar", ota_round.column_tiling(
            W, d, n_sm, aligned=False)))
        for label, t in plans:
            got = ota_round.ota_round_stats(*planes, 0.5, plan=t)
            ok = _close(torch, got, want, 1e-4, 1e-4)
            del got
            us = _time_ms(torch, lambda t=t: ota_round.ota_round_stats(
                *planes, 0.5, plan=t)) * 1e3
            _emit(part="column", kernel="B6", shape=[W, d], plan=label,
                  col_min_blocks_per_sm=lb, ptxas=regs,
                  tiling=list(t), ok=ok, us=us,
                  bound_us=_round_bytes(W, d) / MEM_RATE * 1e6)
            got = ota_round.ota_round_theta(*planes, noise, ia, 0.5, plan=t)
            ok = _close(torch, got, (want_theta,), 1e-5, 1e-6)
            del got
            us = _time_ms(torch, lambda t=t: ota_round.ota_round_theta(
                *planes, noise, ia, 0.5, plan=t)) * 1e3
            _emit(part="column", kernel="B7", shape=[W, d], plan=label,
                  col_min_blocks_per_sm=lb, tiling=list(t), ok=ok, us=us,
                  bound_us=_round_bytes(W, d, True) / MEM_RATE * 1e6)
        del planes, want, want_theta, noise
        torch.cuda.empty_cache()


def part_threshold(torch):
    from repro_torch.kernels import ota_round, ref

    n_sm = ota_round.sm_count(torch.device("cuda"))
    for W in (2, 3, 4, 6, 8, 12, 16):
        for d in ((1 << 27) // W // 4 * 4, 109_386):
            planes = _planes(torch, W, d, 5, W)
            want = ref.ota_round_stats(*planes, 0.5)
            for t in (ota_round.row_tiling(W, d),
                      ota_round.column_tiling(W, d, n_sm)):
                got = ota_round.ota_round_stats(*planes, 0.5, plan=t)
                ok = _close(torch, got, want, 1e-4, 1e-4)
                us = _time_ms(torch, lambda t=t: ota_round.ota_round_stats(
                    *planes, 0.5, plan=t)) * 1e3
                _emit(part="threshold", kernel="B6", shape=[W, d],
                      plan=t.plan, tiling=list(t), ok=ok, us=us,
                      bound_us=_round_bytes(W, d) / MEM_RATE * 1e6)
            del planes, want


def part_receive(torch):
    from repro_torch.kernels import ota, ota_round, ref
    from repro_torch.kernels.ota_round import Tiling

    def case(W, d, t, label):
        planes = _planes(torch, W, d, 4, 7)
        noise = torch.randn(d, device="cuda") * 1e-3
        ia = torch.tensor(0.5, device="cuda")
        want = ref.ota_receive(*planes, noise, ia)
        got = ota.ota_receive(*planes, noise, ia, plan=t)
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
        us = _time_ms(torch, lambda: ota.ota_receive(*planes, noise, ia,
                                                     plan=t)) * 1e3
        _emit(part="receive", kernel="B2", shape=[W, d], plan=label,
              tiling=list(t), ok=ok, us=us,
              bound_us=4 * (4 * W * d + 2 * d + 1) / MEM_RATE * 1e6)

    def unsplit(W, d):
        return Tiling("unsplit", 1, W, -(-d // ota.RECEIVE_THREADS), 1)

    def split(W, d, target=ota.RECEIVE_TARGET_BLOCKS):
        return ota_round.row_tiling(W, d, target)._replace(plan="split")

    W, d = 65_536, 32
    case(W, d, unsplit(W, d), "unsplit")
    for target in (132, 264, 528, 1056, 2112, 4224, 8448):
        case(W, d, split(W, d, target), f"split target={target}")
    for W in (16, 32, 64, 128, 256, 512, 1024, 4096, 16_384):
        case(W, 32, unsplit(W, 32), "unsplit")
        case(W, 32, split(W, 32), "split")
    case(100, 109_386, unsplit(100, 109_386), "unsplit")
    case(100, 109_386, split(100, 109_386), "split")


def _nvcc(build, cu: Path, so: Path):
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _bind(build, so: Path, lib: str, names):
    dll = ctypes.CDLL(str(so))
    fns = {}
    for name in names:
        fn = getattr(dll, name)
        fn.argtypes = build.SIGNATURES[lib][name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def part_row(torch):
    from repro_torch.kernels import build, ota_round, ref

    libs = {mb: (_bind(build, so, "ota_round", ["ota_round_stats"])
                 ["ota_round_stats"], regs)
            for mb, (so, regs) in _variants(build, "ota_round",
                                            "kMinBlocksPerSm",
                                            (1, 4, 6, 8)).items()}
    stream = torch.cuda.current_stream().cuda_stream
    for W, d in ((100, 109_386), (65_536, 32)):
        planes = _planes(torch, W, d, 5, 0)
        want = ref.ota_round_stats(*planes, 0.5)
        for k in (1, 2, 4):
            n_tiles = -(-d // (32 * k))
            slices = max(1, min(-(-ota_round.TARGET_BLOCKS // n_tiles),
                                -(-W // ota_round.WARPS),
                                ota_round.MAX_SLICES))
            rows = -(-W // slices)
            n_slices = -(-W // rows)
            y, p2, e = (torch.empty(n, device="cuda") for n in (d, d, W))
            y_part = torch.empty((d, n_slices), device="cuda")
            p2_part = torch.empty((d, n_slices), device="cuda")
            e_part = torch.empty((W, n_tiles), device="cuda")
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
                ok = _close(torch, (y, p2, e), want, 1e-5, 1e-3)
                _emit(part="row", kernel="B6", shape=[W, d],
                      cols_per_lane=k, min_blocks_per_sm=mb, ptxas=regs,
                      grid=[n_tiles, n_slices], ok=ok,
                      us=_time_ms(torch, call) * 1e3,
                      bound_us=_round_bytes(W, d) / MEM_RATE * 1e6)


def part_parent(torch, parent: Path):
    """The row plan of B6/B7 and the unsplit B2, bit for bit against the
    parent's build of the same entry points (whose signatures this tree
    keeps)."""
    from repro_torch.kernels import build, ota, ota_round
    from repro_torch.kernels.ota_round import _chan_scalars, _common_args

    out = build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {lib: _nvcc(build, csrc / f"{lib}.cu", out / f"lib{lib}.so")
             for lib in ("ota", "ota_round")}
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(log)
    old = {**_bind(build, out / "libota.so", "ota", ["ota_receive"]),
           **_bind(build, out / "libota_round.so", "ota_round",
                   ["ota_round_stats", "ota_round_theta"])}
    stream = torch.cuda.current_stream().cuda_stream

    def ptrs(*ts):
        return [None if t is None else t.data_ptr() for t in ts]

    for W, d in ((100, 109_386), (65_536, 32)):
        planes = _planes(torch, W, d, 9, 3)
        base = planes[:5]
        mask = torch.arange(W, device="cuda") % 5 != 2
        chan = (planes[7], planes[8], 0.9755, math.sqrt(1 - 0.9755 ** 2),
                True)
        noise = torch.randn(d, device="cuda") * 1e-3
        ia = torch.tensor(0.37, device="cuda")
        for mode, kw in (("plain", {}),
                         ("mask+csi+chan", dict(mask=mask, htx=tuple(
                             planes[5:7]), chan=chan))):
            t = ota_round.tiling(W, d)
            assert t.plan == "row", t
            common = _common_args(*base, kw.get("mask"), kw.get("htx"),
                                  kw.get("chan"))
            new = ota_round.ota_round_stats(*base, 0.5, **kw)
            y, p2, e = (torch.empty(n, device="cuda") for n in (d, d, W))
            h_new = ((torch.empty_like(base[0]), torch.empty_like(base[0]))
                     if "chan" in kw else (None, None))
            parts = (None, None)
            if t.n_slices > 1:
                parts = tuple(torch.empty((d, t.n_slices), device="cuda")
                              for _ in range(2))
            e_part = (torch.empty((W, t.n_tiles), device="cuda")
                      if t.n_tiles > 1 else None)
            err = old["ota_round_stats"](
                *common, *ptrs(*parts, e_part, y, p2, e, *h_new), W, d, t.k,
                t.rows_per_slice, 2.0, *_chan_scalars(kw.get("chan")),
                stream)
            torch.cuda.synchronize()
            same = err == 0 and all(
                torch.equal(a.nan_to_num(), b.nan_to_num())
                for a, b in zip(new, (y, p2, e) + tuple(
                    x for x in h_new if x is not None)))
            _emit(part="parent", kernel="B6", shape=[W, d], mode=mode,
                  plan=t.plan, bitwise_equal=same)
            new = ota_round.ota_round_theta(*base, noise, ia, 0.5, **kw)
            th = torch.empty(d, device="cuda")
            err = old["ota_round_theta"](
                *common, *ptrs(noise, ia, *parts, th, *h_new), W, d, t.k,
                t.rows_per_slice, 2.0, *_chan_scalars(kw.get("chan")),
                stream)
            torch.cuda.synchronize()
            same = err == 0 and all(
                torch.equal(a, b) for a, b in zip(new, (th,) + tuple(
                    x for x in h_new if x is not None)))
            _emit(part="parent", kernel="B7", shape=[W, d], mode=mode,
                  plan=t.plan, bitwise_equal=same)
        if ota.receive_tiling(W, d).plan == "unsplit":
            new = ota.ota_receive(*planes[1:5], noise, ia)
            th = torch.empty(d, device="cuda")
            err = old["ota_receive"](*ptrs(*planes[1:5], noise, ia, th), W,
                                     d, stream)
            torch.cuda.synchronize()
            _emit(part="parent", kernel="B2", shape=[W, d], plan="unsplit",
                  bitwise_equal=err == 0 and torch.equal(new, th))
        del planes, base, chan
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="column,threshold,receive",
                    help=f"comma-separated, of {', '.join(PARTS)}")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier checkout to compare bits with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_ota_round: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _emit(part="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)
    fns = {"column": part_column, "threshold": part_threshold,
           "receive": part_receive, "row": part_row}
    for part in filter(None, args.parts.split(",")):
        if part not in fns:
            ap.error(f"unknown part {part!r}; the parts are {PARTS}")
        fns[part](torch)
    if args.parent is not None:
        part_parent(torch, args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
