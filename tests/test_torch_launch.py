"""The port's training launcher (``python -m repro_torch.launch.train``) and
its autotuners, on the CPU (``--device cpu``) at the reduced granite-8b.

In process, through ``main(argv)``: the run-dir case of
``tests/test_obs.py`` (the scan driver logs every round of each block, the
manifest says why there is no compile report, ``--profile`` writes a
trace), the kill-and-resume of ``tests/test_checkpoint_resume.py`` with its
fault flags (6 rounds against 4 then resumed to 6: ``round_00000006.npz``
bit for bit), the two drivers agreeing bit for bit, and the refusals.  The
autotune smokes of ``tests/test_fused_round.py`` and
``tests/test_population.py`` (on the CPU one plan a worker chunk), the JSON
cache (measured, then hit; a corrupt file counts as empty) and the
launcher's ``autotune[...]`` lines.  One subprocess runs the module as a
user would."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import round_path  # noqa: E402
from repro_torch.core import transport  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.obs.sink import read_events  # noqa: E402
from repro_torch.obs.validate import validate_run_dir  # noqa: E402
from repro_torch.phy.population import autotune_population_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
        "--workers", "2", "--seq", "16", "--local-steps", "1"]
#: tests/test_checkpoint_resume.py's faults and guard
_FAULT_FLAGS = ["--nan-workers", "1", "--burst-prob", "0.5",
                "--burst-std", "20", "--straggler-prob", "0.3",
                "--guard", "evict-retransmit", "--snr-floor-db", "-40"]


def _npz_equal(pa, pb):
    with np.load(pa) as za, np.load(pb) as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_launcher_run_dir_scan_logs_every_round(tmp_path, capsys):
    rd = str(tmp_path / "run")
    assert main([*BASE, "--batch", "1", "--rounds", "4", "--log-every", "2",
                 "--driver", "scan", "--run-dir", rd, "--profile"]) == 0
    out = capsys.readouterr().out
    evs = read_events(rd)
    assert [e["round"] for e in evs if e["event"] == "round"] == [0, 1, 2, 3]
    assert sum(e["event"] == "block" for e in evs) == 2
    assert any(e["event"] == "done" for e in evs)
    m = evs[0]["metrics"]
    assert "obs/rx_snr_db" in m and "loss" in m
    assert len(m["obs/tx_energy"]) == 2
    assert validate_run_dir(rd) == []
    # stdout cadence: log_every=2 -> 2 round lines
    assert out.count("round ") == 2 and "done: 4 rounds" in out
    man = json.load(open(os.path.join(rd, "manifest.json")))
    assert man["telemetry"] is True and man["driver"] == "scan"
    assert man["compile_report"] is None and "HLO" in \
        man["compile_report_why"]
    assert not os.path.exists(os.path.join(rd, "compile_report.json"))
    prof = json.load(open(os.path.join(rd, "profile.json")))
    assert prof["spans"]["execute"]["count"] == 2.0
    assert prof["trace"] and os.path.isfile(prof["trace"])


def _launch(ckpt_dir, rounds, *extra):
    return main([*BASE, "--rounds", str(rounds), "--driver", "scan",
                 "--log-every", "2", "--checkpoint-dir", ckpt_dir,
                 "--checkpoint-every", "2", *_FAULT_FLAGS, *extra])


def test_launcher_kill_resume_bitwise(tmp_path, capsys):
    """Faults and guard on: 6 rounds; 4 rounds, then resumed to 6 — the
    final snapshots (θ, λ, Θ, channel and fault state) are bit for bit
    the same."""
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    _launch(da, 6)
    _launch(db, 4)
    capsys.readouterr()
    _launch(db, 6, "--resume")
    assert "resumed from round 4" in capsys.readouterr().out
    _npz_equal(round_path(da, 6), round_path(db, 6))


def test_launcher_drivers_agree_bitwise(tmp_path):
    paths = {}
    for driver in ("loop", "scan"):
        paths[driver] = str(tmp_path / f"{driver}.npz")
        main([*BASE, "--rounds", "3", "--log-every", "3", "--driver",
              driver, "--checkpoint", paths[driver]])
    _npz_equal(paths["loop"], paths["scan"])


@pytest.mark.parametrize("flags,exc,match", [
    (["--fsdp", "2"], NotImplementedError, "item 6"),
    (["--mode", "sketched"], NotImplementedError, "item 5"),
    (["--backend", "jnp"], ValueError, "jnp"),
    (["--ota-block-cols", "512"], ValueError, "take"),
], ids=["fsdp", "sketched", "jnp", "block-cols"])
def test_launcher_refuses_by_name(flags, exc, match):
    with pytest.raises(exc, match=match):
        main([*BASE, "--rounds", "1", *flags])


def test_autotune_sweep_returns_usable_config():
    res = transport.autotune_ota_round(4, 256, iters=2,
                                       block_cols_grid=(256,),
                                       worker_chunks=(0, 2), device="cpu")
    assert {"block_cols", "worker_chunk", "plan", "us"} <= set(res["best"])
    assert res["best"] in res["table"] and len(res["table"]) == 2
    # a chunk of W or more is the monolithic pass: skipped
    res = transport.autotune_ota_round(4, 64, iters=1, worker_chunks=(0, 4),
                                       device="cpu")
    assert [r["worker_chunk"] for r in res["table"]] == [0]


def test_autotune_population_step_smoke():
    res = autotune_population_step(128, iters=2, device="cpu")
    assert res["best"]["us"] > 0.0
    assert len(res["table"]) == 1          # the CPU has no block-size knob
    assert res["best"]["block_rows"] in {r["block_rows"]
                                         for r in res["table"]}


def test_tuning_knobs_are_checked_on_any_device(monkeypatch):
    """The knobs the sweeps set are checked before the CPU branch: a block
    size B10 cannot take, a column tile no B6/B7 plan covers at this W,
    whether the fused round is given it or reads it from
    ``REPRO_OTA_BLOCK_COLS``."""
    from repro_torch.kernels import ota_round, phy_population
    planes = [torch.zeros(8) for _ in range(12)]
    scalars = (0.9, 0.4, True, 0.1, 1.0, 250.0, 3.2, True)
    with pytest.raises(ValueError, match="block_rows 48"):
        phy_population.population_step(*planes, *scalars, block_rows=48)
    assert len(phy_population.population_step(*planes, *scalars,
                                               block_rows=512)) == 8
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.cplx import Complex
    rows = [torch.zeros(20, 64) for _ in range(5)]
    uplink = (rows[0], Complex(rows[1], rows[2]), Complex(rows[3], rows[4]))
    with pytest.raises(ValueError, match=r"take \(32, 64, 96, 128\)"):
        transport.ota_round_stats(*uplink, 0.5, block_cols=256)
    assert transport.ota_round_stats(*uplink, 0.5, block_cols=64)[0].shape \
        == (64,)
    fused = (*uplink, torch.zeros(64), 0.5, ChannelConfig(n_workers=20))
    with pytest.raises(ValueError, match="ota_block_cols=256"):
        transport.ota_round_fused(*fused, block_cols=256)
    monkeypatch.setenv("REPRO_OTA_BLOCK_COLS", "1024")
    with pytest.raises(ValueError, match="ota_block_cols=1024"):
        transport.ota_round_fused(*fused)
    monkeypatch.setenv("REPRO_OTA_BLOCK_COLS", "96")
    assert transport.ota_round_fused(*fused)[0].shape == (64,)
    assert ota_round.block_cols_choices(2, 6) == (32, 64, 96, 128, 256)
    t = ota_round.tiling_for_cols(2, 64, 1024)
    assert (t.plan, t.k) == ("column", 4)
    assert ota_round.block_cols_of(t) == 1024
    assert ota_round.tiling_for_cols(100, 109_386, 128) == \
        ota_round.tiling(100, 109_386)


def test_autotune_cache_measures_once_and_survives_corruption(tmp_path,
                                                               capsys):
    cache = str(tmp_path / "tune.json")
    with open(cache, "w") as f:
        f.write("{not json")
    a = transport.autotune_ota_round_cached(2, 64, cache_path=cache,
                                            iters=1, device="cpu")
    b = transport.autotune_ota_round_cached(2, 64, cache_path=cache,
                                            iters=1, device="cpu")
    assert a["cached"] is False and b["cached"] is True
    assert b["best"] == a["best"] and "2x64:cpu" in json.load(open(cache))
    # the launcher: the first call measures, the second reads the cache
    cache = str(tmp_path / "launch.json")
    old = {k: os.environ.get(k) for k in ("REPRO_OTA_BLOCK_COLS",
                                          "REPRO_OTA_WORKER_CHUNK")}
    try:
        for _ in range(2):
            main([*BASE, "--rounds", "1", "--autotune-cache", cache])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = capsys.readouterr().out
    assert "autotune[measured]: block_cols=" in out
    assert "autotune[cache]: block_cols=" in out


def test_launcher_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE,
         "--rounds", "2", "--log-every", "1"], env=env, capture_output=True,
        text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("round ") == 2
    assert "done: 2 rounds" in proc.stdout
