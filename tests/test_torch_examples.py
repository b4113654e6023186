"""The example twins (``repro_torch.examples``) at toy flags on the CPU:
each runs through its ``main(argv)``, prints what its JAX twin prints and
returns its headline numbers."""
import math

import pytest

pytest.importorskip("torch")

from repro_torch.examples import (privacy_attack_demo,  # noqa: E402
                                  quickstart, train_llm_federated)


def test_quickstart_reaches_the_papers_gap(capsys):
    out = quickstart.main(["--rounds", "41", "--device", "cpu"])
    assert out["final_gap"] < 1e-4 and out["channel_uses_per_round"] == 1.0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round   0  optimality gap")
    assert lines[-1].startswith("NB: one channel use per round")


def test_privacy_attack_demo_finds_an_ambiguity_witness(capsys):
    out = privacy_attack_demo.main(["--device", "cpu"])
    assert out["observation_gap"] < 1e-4      # the reference's bar
    assert out["max_theta_diff"] > 0.1 and out["rmse"] > 0.0
    assert "=== A-FADMM (analog over-the-air uplink) ===" in \
        capsys.readouterr().out


def test_train_llm_federated_trains_at_toy_width(capsys):
    out = train_llm_federated.main(
        ["--d-model", "64", "--layers", "1", "--seq", "16", "--workers",
         "2", "--batch", "1", "--steps", "26", "--device", "cpu"])
    assert len(out["loss"]) == 2 and all(map(math.isfinite, out["loss"]))
    assert out["loss"][-1] < out["loss"][0]
    assert capsys.readouterr().out.startswith("model: granite-64d1L")
