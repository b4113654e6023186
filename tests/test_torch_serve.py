"""The port's serving layer (``repro_torch.serve``) against the JAX
package's: ``generate``'s greedy ids on the same f32 parameters and prompts
for the dense, SSM and hybrid families; ``make_prefill`` and
``make_serve_step``; the generate-and-checkpoint round trip of
``tests/test_system.py``, port against port; the twins of
``examples/serve_batched.py`` and ``benchmarks/serve_microbench.py`` at
toy flags on the CPU."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks.run import main as run_main  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import (generate, make_prefill,  # noqa: E402
                               make_serve_step)

from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("arch", ["granite-8b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_generate_matches_jax(arch):
    jcfg = dataclasses.replace(jreg.get_config(arch).reduced(),
                               param_dtype="float32")
    jm = jreg.build_model(jcfg)
    pj = jm.init(KEY)
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 4),
                                                dtype=np.int32)
    want = np.asarray(jgenerate(jm, pj, jnp.asarray(prompts), n_steps=5,
                                max_seq=12))
    m = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    p = convert.model_params_from_numpy(jax.tree.map(np.asarray, pj),
                                        device="cpu")
    got = generate(m, p, torch.from_numpy(prompts), n_steps=5, max_seq=12)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_and_serve_step():
    m = reg.get_model("granite-8b", reduced=True)
    p = m.init(0, device="cpu")
    toks = torch.randint(0, m.cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    last = make_prefill(m)(p, {"tokens": toks})
    logits, _ = m.forward(p, {"tokens": toks})
    assert torch.equal(last, logits[:, -1]) and not last.requires_grad
    cache = m.init_cache(2, 8, device="cpu")
    tok, cache2 = make_serve_step(m)(p, cache, toks[:, 0], 0)
    assert tok.dtype == torch.int32 and tok.shape == (2,)
    assert cache2 is cache and cache["k"][:, :, 0].abs().sum() > 0
    assert not cache["k"][:, :, 1:].any()


def test_generate_and_checkpoint_roundtrip(tmp_path):
    m = reg.get_model("recurrentgemma-2b", reduced=True)
    params = m.init(0, device="cpu")
    prompts = torch.randint(0, m.cfg.vocab_size, (2, 4),
                            generator=torch.Generator().manual_seed(0))
    out1 = generate(m, params, prompts, n_steps=4, max_seq=32)
    path = os.path.join(tmp_path, "ck.npz")
    save(path, params)
    params2 = restore(path, params)
    out2 = generate(m, params2, prompts, n_steps=4, max_seq=32)
    assert torch.equal(out1, out2)
    assert out1.shape == (2, 4)


def test_serve_batched_twin(capsys):
    out = serve_batched.main(["--arch", "recurrentgemma-2b", "--batch", "2",
                              "--prompt-len", "3", "--new-tokens", "4",
                              "--device", "cpu"])
    assert out["ids"].shape == (2, 4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=recurrentgemma-2b (reduced: 3L")
    assert lines[1].startswith("decoded 8 tokens in")
    assert lines[2].startswith("  request 0: [")


def test_serve_microbench_twin(capsys):
    assert run_main(["--only", "serve_microbench", "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "name,us_per_call,derived"
    name, us, derived = rows[1].split(",", 2)
    assert name == "serve_microbench" and float(us) > 0
    import json
    d = json.loads(derived)
    for arch in ("granite-8b", "falcon-mamba-7b", "recurrentgemma-2b"):
        assert d[arch]["shape_ok"] is True and d[arch]["tok_per_s"] > 0
    assert d["qwen3-moe-30b-a3b"] == {
        "error": "not ported: ROADMAP queue A item 5 (moe)"}
