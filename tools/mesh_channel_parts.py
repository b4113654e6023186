"""Card check of chip_smoke's channel parts alone: the build, B12's rows
(and, for the hybrid, B6/B3/B4's; for the enc-dec, B11's and B6/B3/B4's)
at a mesh rank's shapes, the parent's one-device references, two ranks
spawned on the card running each family's check, run and serving parts,
and their gates; the lines also go to ``--out`` (default
``results/channel_parts.jsonl``).

    python3 tools/mesh_channel_parts.py [ssm] [hybrid] [encdec] [--out FILE]
"""
import argparse
import datetime
import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

def rank_main(rank, store, out_dir, refs, tags):
    sys.path.insert(0, str(cs.SRC))
    import torch
    res = {"rank": rank, "part_s": {}}
    try:
        from repro_torch.launch.mesh import init_distributed, make_mesh
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["backend"] = init_distributed(
            "cuda", init_method=store, rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=cs.MESH_TIMEOUT))
        on = lambda: make_mesh((1, 2), ("data", "model"), "cuda")  # noqa
        for tag in tags:
            fam = cs._channel_family(tag)
            for key, fn, args in (
                    (f"{tag}_check", cs._mesh_channels_check_rank,
                     (refs[tag], fam)),
                    (tag, cs._mesh_channels_rank, (fam,)),
                    (f"serve_mesh_{tag}", cs._serve_mesh_channels_rank,
                     (refs[f"serve_{tag}"], fam))):
                t0 = time.perf_counter()
                res[key] = fn(torch, on(), *args)
                res["part_s"][key] = time.perf_counter() - t0
        torch.distributed.destroy_process_group()
    except Exception:
        res["error"] = traceback.format_exc()
        res["memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tags", nargs="*", choices=cs.CHANNEL_TAGS,
                    default=["hybrid"])
    ap.add_argument("--out", default="results/channel_parts.jsonl")
    args = ap.parse_args()
    tags = tuple(args.tags)
    import torch
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    log = open(args.out, "w")
    emit0 = cs.emit

    def emit(obj):
        log.write(json.dumps(obj) + "\n")
        log.flush()
        emit0(obj)
    cs.emit = emit
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build
    t_all = time.perf_counter()
    name, smi = cs.phase_device(torch)
    print(smi, flush=True)
    cs.phase_build(build)
    _, (mem, f32, _) = cs.card_peaks(name)
    orig = cs._scan_cases
    cs._scan_cases = lambda: [c for c in orig() if any(
        f"mesh {t}" in c[0] for t in tags)]
    t0 = time.perf_counter()
    rows = cs._scan_rows(torch, build, mem, f32)
    if "hybrid" in tags:
        # the sketched round's (W, d_s): the last but one of the blocks
        d = cs._mesh_round_shapes()[-2]
        rows.update(cs._llm_round_rows(torch, build, mem, f32, *d))
    if "encdec" in tags:
        # the replicated round's (W, d_local): the last of the blocks, and
        # B11 at the rank's heads
        d = cs._mesh_round_shapes()[-1]
        rows.update(cs._llm_round_rows(torch, build, mem, f32, *d))
        cs.FLASH_CASES = tuple(c for c in cs.FLASH_CASES
                               if "enc-dec model" in c[0])
        rows.update(cs._flash_rows(torch, build, name))
    keep = ("ms", "ms_with_launch", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err", "shape", "plan")
    emit({"phase": "rows", "seconds": time.perf_counter() - t0,
          "rows": {k: {kk: v[kk] for kk in keep if kk in v}
                   for k, v in rows.items()}})
    cs._free(torch)
    refs = {"seconds": {}}
    with tempfile.TemporaryDirectory() as ref_dir:
        for tag in tags:
            fam = cs._channel_family(tag)
            t0 = time.perf_counter()
            refs[tag] = cs._free_running_reference(
                torch, fam["check_cfg"], cs.MESH_SSM_CHECK_ROUNDS)
            refs[f"serve_{tag}"] = cs._serve_mesh_channels_reference(
                torch, ref_dir, fam)
            refs["seconds"][tag] = time.perf_counter() - t0
            cs._free(torch)
        store = "file://" + os.path.join(ref_dir, "store")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, store, ref_dir,
                                                     refs, tags))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(cs.MESH_TIMEOUT)
        for p in procs:
            if p.is_alive():
                p.kill()
        res = []
        for r in range(2):
            with open(os.path.join(ref_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
    emit({"phase": "spawn", "wall_s": time.perf_counter() - t0,
          "references_s": refs["seconds"],
          "part_s": [r.get("part_s") for r in res],
          "errors": [r.get("error") for r in res]})
    launches = {}
    for tag in tags:
        launches.update(cs._gate_mesh_channels(res, refs,
                                               cs._channel_family(tag)))
    emit({"phase": "done", "launches": launches,
          "seconds": time.perf_counter() - t_all})


if __name__ == "__main__":
    main()
