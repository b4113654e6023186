#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s f32 pair of phase ``llm_ssm_chunked``
(falcon-mamba-7b at full width, 2 of its 64 layers, the unchunked scan
against ``REPRO_OPT=chunked_scan``) drift apart along their own
trajectories over 3 rounds, for several draws of the initial fading h:
the trainer's per-row draw (``channel.rayleigh_rows``) and a whole-plane
draw from one generator, each from the round key and from two folds of
it.

    python3 tools/sweep_ssm_pair.py

One line a draw: the unchunked run's losses, the chunked run's and their
relative gap by round; the table goes to ``chiprun_out/ssm_pair.json``.
Needs one NVIDIA GPU with ~60 GB free and nvcc.
"""
import contextlib
import io
import json
import os
import sys

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.SRC))
from repro_torch import rng  # noqa: E402
from repro_torch.core.channel import rayleigh  # noqa: E402
from repro_torch.core.tree_ota import TreeChannel  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.train import llm_trainer as lt  # noqa: E402

PER_ROW = lt.init_channel_packed
#: (rule, fold of the init key's channel half or None)
DRAWS = (("whole", None), ("rows", None), ("whole", 7), ("rows", 7),
         ("rows", 11), ("whole", 11))


def draw(kind: str, salt):
    """The trainer's first fading block by ``kind``'s rule."""
    def init(key, rows, d, device):
        k = key if salt is None else rng.fold_in(key, salt)
        if kind == "rows":
            return PER_ROW(k, rows, d, device)
        return TreeChannel(h=rayleigh(rng.generator(k, device),
                                      (len(rows), d)), age=0)
    return init


def main() -> int:
    cs.phase_device(torch)
    cs.phase_build(build)
    out = {}
    for kind, salt in DRAWS:
        lt.init_channel_packed = draw(kind, salt)
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet):
            _, _, _, ref = cs.phase_llm(
                torch, "f32", cs.SSM_ARCH, cs.SSM_LAYERS, cs.SSM_SEQ,
                cs.SSM_LR, cs.SSM_LAUNCHES, dtype="float32")
            cs._free(torch)
            with cs._chunked_scan():
                _, _, _, got = cs.phase_llm(
                    torch, "chunked_f32", cs.SSM_ARCH, cs.SSM_LAYERS,
                    cs.SSM_SEQ, cs.SSM_LR, cs.SSM_CHUNKED_LAUNCHES,
                    reference=ref, loss_rtol=1.0, dtype="float32")
            cs._free(torch)
        a, b = ref["loss"], got["loss"]
        rel = [abs(x - y) / abs(y) for x, y in zip(b, a)]
        out[f"{kind}-{salt}"] = {"unchunked": a, "chunked": b, "rel": rel}
        print(kind, salt, a, b, rel, flush=True)
    lt.init_channel_packed = PER_ROW
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/ssm_pair.json", "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
