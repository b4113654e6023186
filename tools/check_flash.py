#!/usr/bin/env python3
"""Hold B11's CUDA kernels (forward, dq, dk/dv) against their plain versions
on the card at every head width, causal and not, over ragged shapes that
span one to eight tiles of each kernel, with ``chip_smoke.py``'s tolerance
(rtol 1e-2, atol 1e-3 of the largest reference value for bf16; rtol 1e-4,
atol 1e-5 of it for f32; lse rtol and atol 1e-5).

    python3 tools/check_flash.py [--dtype bfloat16|float32] [--hd 128 ...]

One line per case with each output's error over its tolerance (≤ 1 is a
pass), then the count of failing cases; exits 1 if any case fails.  A
kernel that does not finish within ``--limit`` seconds (a deadlocked
barrier) ends the process with exit code 3, which takes the kernel down
with it.  Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: (B, H, S, T): one tile, ragged S = T, T < S, T > S, many tiles
SHAPES = ((1, 2, 128, 128), (1, 2, 100, 100), (2, 2, 96, 40),
          (1, 3, 40, 130), (2, 3, 128, 128), (1, 2, 1000, 1000),
          (1, 2, 384, 200), (1, 2, 200, 384), (2, 4, 300, 300))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--hd", type=int, nargs="+", default=[16, 32, 64, 128])
    p.add_argument("--limit", type=float, default=30.0,
                   help="seconds a launch may take before the process ends")
    args = p.parse_args()
    import torch

    from repro_torch.kernels import build, flash_attention as fa, ref

    if not torch.cuda.is_available():
        print("check_flash: no CUDA device", file=sys.stderr)
        return 1
    build.build(["flash_attention"])
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    rtol, rel_atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-5)

    def finish(what: str) -> None:
        ev = torch.cuda.Event()
        ev.record()
        t0 = time.monotonic()
        while not ev.query():
            if time.monotonic() - t0 > args.limit:
                print(f"check_flash: {what} did not finish in {args.limit} s",
                      flush=True)
                os._exit(3)
            time.sleep(0.01)

    def over(a, b, rtol=rtol, atol=None):
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            return float("inf")
        atol = rel_atol * float(b.abs().max()) if atol is None else atol
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    failed = 0
    for hd in args.hd:
        for causal in (False, True):
            for B, H, S, T in SHAPES:
                g = torch.Generator(device=dev)
                g.manual_seed(11)
                q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                               .to(dtype) for shape in
                               ((B, H, S, hd), (B, H, T, hd), (B, H, T, hd),
                                (B, H, S, hd)))
                case = f"hd={hd} causal={causal} {(B, H, S, T)}"
                o, lse = fa.flash_attention_fwd(q, k, v, causal)
                finish(f"forward at {case}")
                delta = fa.attention_delta(o, do)
                dq = fa.flash_attention_dq(q, k, v, do, lse, delta, causal)
                finish(f"dq at {case}")
                dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta,
                                                causal)
                finish(f"dk/dv at {case}")
                o_ref, lse_ref = ref.flash_attention_fwd(q, k, v, causal)
                want = ref.flash_attention_bwd(q, k, v, do, causal, lse=lse,
                                               delta=delta)
                errs = {"o": over(o, o_ref),
                        "lse": over(lse, lse_ref, 1e-5, 1e-5),
                        "dq": over(dq, want[0]), "dk": over(dk, want[1]),
                        "dv": over(dv, want[2])}
                bad = max(errs.values()) > 1
                failed += bad
                print(("FAIL " if bad else "ok   ") + case + " " +
                      " ".join(f"{n}={e:.3g}" for n, e in errs.items()),
                      flush=True)
    print(f"failing cases: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
