"""The torch twin of ``benchmarks/kernels_microbench.py``
(``repro_torch.benchmarks.kernels_microbench``) against the reference on the
CPU.

Every section the reference runs on the installed JAX runs once on each
side, both ``_time``s cut to one warm-up and one timed call: the reference
in four JAX processes started with the module
(``tests/torch_microbench_ref.py``; the shard-local section on two forced
host devices), the twin in this one.  The twin's keys are the reference's
with the token ``jnp`` as ``plain`` and ``pallas`` as ``kernel``; its
structural numbers (shapes, counts, traffic model, rounds) and booleans
are the reference's; each error is under the reference's stated tolerance
(1e-6 for the channel step, 1e-5 for the flash gradients, and 1e-5 where
it states none), and 0.0 where the reference reads 0.0 — but for the
scaleup parity, whose gain is B10's exp/log form against the chain's pow
(held to rtol 1e-5 of the largest gain, its other outputs bit for bit in a
test of their own).

The reference's sketched section needs explicit mesh axes the installed JAX
refuses, so the twin's is held to its contract: one uplink entry per shard
per round, a finite loss, and the ``d`` and ``d_s`` of the reference's
one-device sketched trainer.  Two spawns of gloo ranks: the shard-local
section's two and the sketched section's four."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import kernels_microbench as km  # noqa: E402

from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "tests" / "torch_microbench_ref.py"
#: the reference's sections in four JAX processes started together (the
#: tests that need no reference section run first, while they work): each
#: group's sections in its order, on 1 device, or on 2 forced host devices
REF_GROUPS = ((("sketched_shapes", "microbench", "attn_bwd_microbench",
                "phy_microbench", "scaleup_microbench", "obs_microbench",
                "faults_microbench"), 1),
              (("fused_round_microbench", "packed_microbench"), 1),
              (("transport_microbench",), 1),
              (("shard_local_microbench",), 2))
SECTIONS = tuple(n for g, _ in REF_GROUPS[:3] for n in g
                 if n != "sketched_shapes")
#: seconds to wait for the reference's sections
REF_TIMEOUT = 600

#: keys whose values are the same on both sides
STRUCTURAL = {"W", "d", "n_leaves", "d_local", "d_pad", "n_shards",
              "n_elements", "N", "B", "H", "S", "hd", "block_q", "block_k",
              "rho", "coherence_iters", "n_rounds", "workers",
              "n_rounds_timed", "telemetry_keys", "residual_lse_bytes",
              "naive_bwd_score_tensor_bytes", "peak_signal_plane_elems",
              "monolithic_signal_plane_elems", "worker_chunk",
              "crashed_workers", "nan_workers", "sink_rounds_logged",
              "sink_jsonl_violations", "participation", "label",
              "optimised_metric", "predicted_fusion_speedup"}
#: the reference's stated tolerances (its docstrings); others 1e-5
TOLS = {"channel_step_max_err_vs_jnp": 1e-6, "max_abs_err_dq": 1e-5,
        "max_abs_err_dk": 1e-5, "max_abs_err_dv": 1e-5}
DEFAULT_TOL = 1e-5


def _structural(key: str) -> bool:
    return (key in STRUCTURAL or key.endswith("_dispatches")
            or "uplink_entries" in key or key.startswith("hbm_passes")
            or key.startswith("traffic_bytes"))


def mapped(key: str) -> str:
    """The twin's name of a reference key."""
    return "_".join({"jnp": "plain", "pallas": "kernel"}.get(t, t)
                    for t in key.split("_"))


class Reference:
    """The reference's sections from its JAX processes, each read when its
    file appears."""

    def __init__(self, tmp: Path):
        self.dir = tmp
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                               str(ROOT)]))
        self.logs, self.procs = [], []
        for i, (names, n_dev) in enumerate(REF_GROUPS):
            flags = env.get("XLA_FLAGS", "")
            if n_dev > 1:
                flags += (" --xla_force_host_platform_device_count="
                          f"{n_dev}")
            self.logs.append(open(tmp / f"ref{i}.log", "w"))
            self.procs.append(subprocess.Popen(
                [sys.executable, str(REF), str(tmp), *names],
                env=dict(env, XLA_FLAGS=flags.strip()), cwd=ROOT,
                stdout=subprocess.DEVNULL, stderr=self.logs[-1]))

    def __getitem__(self, name: str) -> dict:
        path = self.dir / f"{name}.json"
        t0 = time.time()
        while not path.exists():
            done = [p for p in self.procs if p.poll() is not None]
            if any(p.returncode for p in done) or len(done) == len(
                    self.procs):
                if path.exists():
                    break
                errs = "\n".join(f.name + ":\n" + Path(f.name).read_text()
                                 for f in self.logs)
                raise AssertionError(f"the reference wrote no {name}:\n"
                                     f"{errs[-4000:]}")
            assert time.time() - t0 < REF_TIMEOUT, f"{name}: timed out"
            time.sleep(0.2)
        res = json.loads(path.read_text())
        assert "error" not in res, res["error"]
        return res

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = Reference(tmp_path_factory.mktemp("reference"))
    yield ref
    ref.close()


@pytest.fixture(autouse=True)
def fast_time(monkeypatch):
    """The twin's ``_time``: one warm-up and one timed call."""
    orig = km._time
    monkeypatch.setattr(km, "_time", lambda fn, iters=10, warmup=3: orig(
        fn, iters=1, warmup=1))


def compare(ref, twin, path: str = "") -> None:
    if isinstance(ref, dict):
        assert isinstance(twin, dict), path
        assert {mapped(k) for k in ref} == set(twin), path
        for k, v in ref.items():
            compare(v, twin[mapped(k)], f"{path}.{k}")
        return
    key = path.rsplit(".", 1)[-1]
    if isinstance(ref, bool):
        assert twin is ref, (path, twin, ref)
    elif _structural(key):
        assert twin == ref, (path, twin, ref)
    elif "err" in key:
        if key == "parity_max_abs_err_jnp":
            return                   # test_scaleup_parity_bits
        tol = 0.0 if ref == 0.0 else TOLS.get(key, DEFAULT_TOL)
        assert 0.0 <= twin <= tol, (path, twin, ref, tol)
    elif isinstance(ref, (int, float)):
        assert isinstance(twin, (int, float)) and np.isfinite(twin), path
        assert twin >= 0.0, path
    else:
        assert type(twin) is type(ref), (path, twin, ref)


def test_sketched_holds_its_contract(reference):
    twin = km.sketched_microbench("cpu", iters=1, warmup=1)
    one = reference["sketched_shapes"]
    assert twin["uplink_entries_per_shard_per_round"] == 1
    assert (twin["d"], twin["d_s"]) == (one["d"], one["d_s"])
    assert twin["compression_ratio"] == one["d"] / one["d_s"]
    assert twin["loss_finite"] is True
    assert (twin["W"], twin["n_fsdp"], twin["n_model"]) == (4, 2, 2)
    assert twin["scenario"] == "deep-fade-truncation"
    assert 0.0 <= twin["participation"] <= 1.0


def test_scaleup_parity_bits():
    """B10's plain version against the pre-fusion chain with B9's: h,
    positions, waypoints and shadowing bit for bit; the gain, exp(pexp ·
    log(d₀/r)) against (d₀/r)^pexp, within rtol 1e-5 — and the section's
    parity is that gain's difference."""
    from repro_torch.phy import geometry as geo
    from repro_torch.phy import innovation_scale

    dev = torch.device("cpu")
    gcfg, h, w, pos, dest, shadow, fresh, sh_fresh = km.scaleup_inputs(dev)
    rho = km.SCALEUP_RHO
    flat = [x.reshape(-1).contiguous() for x in (h.re, h.im, w.re, w.im)]
    cols = [x.contiguous() for x in (pos[:, 0], pos[:, 1], dest[:, 0],
                                     dest[:, 1], fresh[:, 0], fresh[:, 1])]
    for redraw in (False, True):
        got = km.ref.population_step(
            *flat, *cols, shadow, sh_fresh, rho, innovation_scale(rho),
            redraw, gcfg.speed_mps * gcfg.slot_seconds, gcfg.ref_distance_m,
            gcfg.norm_distance_m, gcfg.pathloss_exp, True)
        hre, him = km.ref.fading_step(*flat, rho, innovation_scale(rho),
                                      redraw)
        p2, d2, s2 = geo.waypoint_shadow_step(pos, dest, shadow, fresh,
                                              sh_fresh, gcfg)
        for a, b in zip(got[:7], (hre, him, p2[:, 0], p2[:, 1], d2[:, 0],
                                  d2[:, 1], s2)):
            assert torch.equal(a, b)
        g2 = geo.worker_gains(p2, s2, gcfg)
        torch.testing.assert_close(got[7], g2, rtol=1e-5, atol=0.0)
    parity = km.scaleup_microbench("cpu")["parity_max_abs_err_plain"]
    assert parity == float((got[7] - g2).abs().max())
    assert parity <= 1e-5 * float(g2.abs().max())


@pytest.mark.parametrize("want", [None, "gpu"])
def test_device_lane_skips_on_the_cpu(monkeypatch, want):
    if want is None:
        monkeypatch.delenv("REPRO_BENCH_DEVICE", raising=False)
    else:
        monkeypatch.setenv("REPRO_BENCH_DEVICE", want)
    got = km.device_microbench("cpu")
    assert got["skipped"] is True and got["platform"] == "cpu"
    assert ("unset" in got["reason"]) == (want is None)


def test_device_lane_runs_the_autotuners_on_its_platform(monkeypatch):
    """``REPRO_BENCH_DEVICE`` naming the device's platform runs the lane:
    here the CPU, the autotuners cut to toy sizes."""
    from repro_torch.phy import population

    pop, rnd = population.autotune_population_step, \
        km.transport.autotune_ota_round
    monkeypatch.setattr(population, "autotune_population_step",
                        lambda n, device: pop(1024, device=device, iters=1))
    monkeypatch.setattr(km.transport, "autotune_ota_round",
                        lambda W, d, device: rnd(8, 256, device=device,
                                                 iters=1))
    monkeypatch.setenv("REPRO_BENCH_DEVICE", "cpu")
    got = km.device_microbench("cpu")
    assert got["skipped"] is False and got["platform"] == "cpu"
    assert got["population_step_1M"]["best"]["us"] > 0.0
    assert got["ota_round_256x65536"]["best"]["us"] > 0.0


def test_cli_writes_its_json_under_its_own_names(tmp_path, monkeypatch,
                                                 capsys):
    """A flagged section writes ``BENCH_torch_<section>.json`` (or the file
    its ``--out-`` flag names), never a reference file; a skipped device
    lane writes nothing."""
    monkeypatch.chdir(tmp_path)
    assert km.main(["--device", "cpu", "--phy", "--device-bench"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == {"phy", "device"}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_torch_phy.json"]
    assert json.loads((tmp_path / "BENCH_torch_phy.json").read_text()) \
        == printed["phy"]
    out = tmp_path / "phy.json"
    assert km.main(["--device", "cpu", "--phy", "--out-phy", str(out)]) == 0
    assert set(json.loads(out.read_text())) == set(printed["phy"])


def test_shard_local_matches_the_reference(reference):
    twin = km.shard_local_microbench("cpu", iters=1, warmup=1)
    ref = reference["shard_local_microbench"]
    compare(ref, twin, "shard_local")
    assert twin["uplink_entries_per_shard_per_round"] == 1
    assert twin["noise_free_max_abs_err_vs_leafwise"] == 0.0
    assert twin["noise_free_lam_max_abs_err_vs_leafwise"] == 0.0


@pytest.mark.parametrize("name", SECTIONS)
def test_section_matches_the_reference(name, reference):
    twin = getattr(km, name)(device="cpu")
    compare(reference[name], twin, name)
