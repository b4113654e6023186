#!/usr/bin/env python3
"""Does the card give the mesh check's round-1 loss the same bits every
time?  ``chip_smoke.py``'s ``llm_mesh_check`` holds two ranks' round-1
loss (granite-8b at full width cut to 1 layer, the (1, 2) grid over gloo
on one card, the forward partitioned over the model axis) to each other
bit for bit and to one device's within one bf16 ulp relative; this
repeats its pieces:

* ``gather``: two ranks each run the first local step's forward and
  backward ``K`` times, with a digest of every tensor the gathers return,
  of every partial product the partitioned forward sums over the ranks
  (``launch.mesh.reduce_from``'s output) and of every gradient, against
  their first run and each other's;
* ``b11``: two processes on the card at once each launch B11's forward,
  dq and dk/dv at (2, 32, 4,096, 128) bf16 thousands of times and count
  the launches whose outputs differ from their first;
* ``one``: the one-device round-1 loss 8 times;
* ``mesh``: ``chip_smoke.py``'s phases ``llm``, ``launch`` and its mesh
  phases (``llm_mesh_check`` to ``llm_mesh_cohort_check``), in its order,
  their gates exiting 1: the ranks' losses bit-equal to each other in
  every phase, and within each phase's stated bounds of one device (a
  rank loss that once missed one device's, and now would miss its peer's,
  is ROADMAP queue C item 1).

    python3 tools/check_mesh_bits.py [--parts gather,b11,one,mesh]

Needs one NVIDIA GPU with ~40 GB free (``mesh``: the whole card) and nvcc.
"""
import argparse
import hashlib
import json
import multiprocessing
import os
import sys
import tempfile
import time

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402

#: forwards a rank; launches a process
K, N_FWD, N_BWD = 6, 4000, 1500


def digest(t) -> str:
    import torch

    return hashlib.sha1(t.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()[:12]


def gather_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of ``gather``: its results to ``out_dir``."""
    import datetime
    import traceback

    sys.path.insert(0, str(cs.SRC))
    import torch

    res = {"rank": rank}
    try:
        from repro_torch.launch import mesh as M
        from repro_torch.launch.mesh import init_distributed, make_mesh
        from repro_torch.models import build_model
        from repro_torch.models import gather as G
        from repro_torch.tree import tree_leaves, tree_map

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        init_distributed("cuda", init_method=store, rank=rank, world_size=2,
                         timeout=datetime.timedelta(seconds=300))
        mesh = make_mesh((1, 2), ("data", "model"), "cuda")
        cfg = cs._llm_cfg(cs.LLM_ARCH, cs.ROBUST_LAYERS)
        init_fn, _, _, _ = cs._mesh_trainer(torch, cfg, mesh, noisy=False,
                                            local_steps=1)
        st = init_fn(cs.SEED)
        plan = init_fn.layout["plan"]
        batch = cs._mesh_batch(torch, cfg)
        model = build_model(cfg)
        seen, sums = [], []
        inner = G._Gather.forward
        inner_sum = M._ReduceFrom.forward

        def fwd(ctx, x, *a):
            out = inner(ctx, x, *a)
            torch.cuda.synchronize()
            seen.append((tuple(out.shape), digest(out)))
            return out

        def fwd_sum(ctx, x, *a):
            out = inner_sum(ctx, x, *a)
            torch.cuda.synchronize()
            sums.append((tuple(out.shape), digest(out)))
            return out
        G._Gather.forward = staticmethod(fwd)
        M._ReduceFrom.forward = staticmethod(fwd_sum)
        runs = []
        for _ in range(K):
            seen.clear()
            sums.clear()
            leaves = tree_map(lambda l: l.detach().requires_grad_(), st.theta)
            with G.gathering(plan):
                losses, _ = model.loss(G.gather_params(leaves), batch)
                loss = float(losses.detach().float().mean())
                losses.sum().backward()
            torch.cuda.synchronize()
            runs.append({"loss": loss, "gathers": list(seen),
                         "sums": list(sums),
                         "grad": [digest(l.grad)
                                  for l in tree_leaves(leaves)]})
        res["runs"] = runs
        torch.distributed.destroy_process_group()
    except Exception:
        res["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def b11_process(rank: int, out_dir: str) -> None:
    """One process of ``b11``: its counts to ``out_dir``."""
    sys.path.insert(0, str(cs.SRC))
    import torch

    from repro_torch.kernels import flash_attention as fa

    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda").manual_seed(rank)
    shape = (2, 32, 4096, 128)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o0, l0 = fa.flash_attention_fwd(q, k, v)
    t0 = time.perf_counter()
    bad_fwd = sum(not (torch.equal(o, o0) and torch.equal(l, l0))
                  for o, l in (fa.flash_attention_fwd(q, k, v)
                               for _ in range(N_FWD)))
    delta = fa.attention_delta(o0, do)
    dq0 = fa.flash_attention_dq(q, k, v, do, l0, delta)
    dk0, dv0 = fa.flash_attention_dkv(q, k, v, do, l0, delta)
    bad_dq = bad_dkv = 0
    for _ in range(N_BWD):
        bad_dq += not torch.equal(
            fa.flash_attention_dq(q, k, v, do, l0, delta), dq0)
        dk, dv = fa.flash_attention_dkv(q, k, v, do, l0, delta)
        bad_dkv += not (torch.equal(dk, dk0) and torch.equal(dv, dv0))
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"b11_{rank}.json"), "w") as f:
        json.dump({"rank": rank, "bad_fwd": bad_fwd, "bad_dq": bad_dq,
                   "bad_dkv": bad_dkv,
                   "seconds": time.perf_counter() - t0}, f)


def spawn(target, args_of) -> None:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="gather,b11,one")
    args = ap.parse_args()
    parts = args.parts.split(",")
    import torch

    cs.phase_device(torch)
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build

    cs.phase_build(build)
    rc = 0
    with tempfile.TemporaryDirectory() as d:
        if "gather" in parts:
            spawn(gather_rank, lambda r: (r, "file://" + d + "/store", d))
            res = [json.load(open(f"{d}/rank{r}.json")) for r in range(2)]
            for r in res:
                if "error" in r:
                    print("rank", r["rank"], r["error"], flush=True)
                    continue
                base = r["runs"][0]
                for i, run in enumerate(r["runs"]):
                    print("gather rank", r["rank"], "run", i, run["loss"],
                          "gathers differing from run 0:",
                          [j for j, (a, b) in enumerate(
                              zip(run["gathers"], base["gathers"])) if a != b],
                          "sums differing from run 0:",
                          [j for j, (a, b) in enumerate(
                              zip(run["sums"], base["sums"])) if a != b],
                          "sums differing from rank 0:",
                          [j for j, (a, b) in enumerate(
                              zip(run["sums"], res[0]["runs"][i]["sums"]))
                           if a != b] if "runs" in res[0] else None,
                          "grads differing:",
                          [j for j, (a, b) in enumerate(
                              zip(run["grad"], base["grad"])) if a != b],
                          flush=True)
        if "mesh" in parts:
            # the smoke's own order: phases llm and launch, then the mesh
            # phases, whose gates fail on a rank's loss that misses one
            # device's
            cs.phase_llm(torch, "llm", cs.LLM_ARCH, cs.LLM_LAYERS,
                         cs.LLM_SEQ, cs.LLM_LR, cs.LLM_LAUNCHES)
            cs._free(torch)
            cs.phase_launch(torch)
            cs._free(torch)
            try:
                cs.phase_llm_mesh(torch)
                print("mesh: every gate held", flush=True)
            except cs.SmokeFailure as e:
                print("mesh:", e, flush=True)
                rc = 1
        if "b11" in parts:
            spawn(b11_process, lambda r: (r, d))
            for r in range(2):
                print("b11", json.load(open(f"{d}/b11_{r}.json")),
                      flush=True)
    if "one" in parts:
        print("one-device round-1 losses",
              [cs._mesh_check_reference(torch) for _ in range(8)],
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
