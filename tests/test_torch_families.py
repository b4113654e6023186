"""Every family the registry builds, and the moe, vlm and audio families on
the trainer and the launcher, against the JAX package: the four config
modules; ``packed_param_count`` against JAX's ``PackSpec.d`` and the
port's own tree for all 10 archs; every arch's reduced model initing,
running forward, loss with gradients and a decode step on the CPU; two
replayed replicated rounds of reduced deepseek-v3-671b, pixtral-12b and
seamless-m4t-medium (f32, W = 2) from JAX's ``init_fn`` state on JAX's
draws, and one sketched round of reduced qwen3-moe-30b-a3b; the moe
round's loss terms; the launcher's batch for vlm and audio, one reduced
round each."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.admm import AdmmConfig as JAdmmConfig  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.packing import build_packspec as jbuild_packspec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import llm_trainer as jtrainer  # noqa: E402

from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.llm_trainer import FLConfig, make_fl_train  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_replay import (llm_round_draws, llm_state,  # noqa: E402,F401
                          one_thread, sketch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
W, B, S = 2, 1, 16
#: the replayed rounds: losses to rtol 1e-5, Θ and λ to atol 1e-5
LOSS_RTOL, STATE_ATOL = 1e-5, 1e-5
NEW_CONFIGS = ("qwen3_moe_30b_a3b", "deepseek_v3_671b", "pixtral_12b",
               "seamless_m4t_medium")


@pytest.mark.parametrize("module", NEW_CONFIGS)
def test_config_modules_equal_jax(module):
    ours = importlib.import_module(f"repro_torch.configs.{module}")
    theirs = importlib.import_module(f"repro.configs.{module}")
    assert ours.ARCH == theirs.ARCH
    assert ours.CONFIG == reg.get_config(ours.ARCH)
    assert ours.REDUCED == ours.CONFIG.reduced()
    for mine, ref in ((ours.CONFIG, theirs.CONFIG),
                      (ours.REDUCED, theirs.REDUCED)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", sorted(reg.ARCHS))
def test_packed_param_count_equals_jax_packspec(name):
    """D of the packed round: JAX's ``PackSpec.d`` of its reduced tree
    (shapes through ``jax.eval_shape``), the port's leaf count, and
    ``packed_param_count``."""
    shapes = jax.eval_shape(jreg.get_model(name, reduced=True).init, KEY)
    cfg = reg.get_config(name).reduced()
    got = sum(leaf.numel() for leaf in tree_leaves(
        reg.build_model(cfg).init(0, device="cpu")))
    assert reg.packed_param_count(cfg) == jbuild_packspec(shapes).d == got


def _batch(cfg, lead, seed=1):
    """tokens (*lead, S) and the family's stub embeddings, numpy."""
    g = np.random.default_rng(seed)
    out = {"tokens": g.integers(0, cfg.vocab_size, lead + (S,),
                                dtype=np.int32)}
    if cfg.family == "vlm":
        out["patches"] = g.standard_normal(
            lead + (cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = g.standard_normal(
            lead + (cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(reg.ARCHS))
def test_every_arch_trains_and_decodes_reduced(name):
    """``get_model(arch, reduced=True)`` in its own dtype: init, forward,
    the loss with every gradient finite, and a decode step; no family is
    refused."""
    m = reg.get_model(name, reduced=True)
    p = m.init(0, device="cpu")
    for leaf in tree_leaves(p):
        leaf.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in _batch(m.cfg, (2,)).items()}
    logits, aux = m.forward(p, batch)
    extra = m.cfg.frontend_tokens if m.cfg.family == "vlm" else 0
    assert tuple(logits.shape) == (2, S + extra, m.cfg.vocab_size)
    loss, metrics = m.loss(p, batch)
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    loss.backward()
    assert all(leaf.grad is not None and bool(torch.isfinite(
        leaf.grad).all()) for leaf in tree_leaves(p))
    with torch.no_grad():
        cache = m.init_cache(2, 4, device="cpu")
        out, cache2 = m.decode_step(p, cache, batch["tokens"][:, 0], 0)
    assert tuple(out.shape) == (2, m.cfg.vocab_size) and cache2 is cache
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# the trainer, replayed against JAX's
# ---------------------------------------------------------------------------

def _configs():
    kw = dict(n_workers=W, snr_db=40.0, coherence_iters=2)
    admm = dict(rho=0.5, flip_on_change=False)
    return (JAdmmConfig(**admm), JChannelConfig(**kw), AdmmConfig(**admm),
            ChannelConfig(**kw))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=msg)


def _replay(name, mode, rounds, fl):
    """JAX's init state and ``rounds`` jitted rounds of ``name`` (reduced,
    f32), the port's rounds from JAX's state on JAX's draws; the states
    and metrics of both."""
    jcfg = dataclasses.replace(jreg.get_config(name).reduced(),
                               param_dtype="float32")
    jacfg, jccfg, acfg, ccfg = _configs()
    init_fn, step = jtrainer.make_fl_train(
        jreg.build_model(jcfg), jtrainer.FLConfig(mode=mode, **fl), jacfg,
        jccfg)
    _, step_t = make_fl_train(
        reg.build_model(ModelConfig(**dataclasses.asdict(jcfg))),
        FLConfig(mode=mode, **fl), acfg, ccfg, device="cpu")
    nb = _batch(jcfg, (W, B))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    st_j = init_fn(KEY)
    st = (sketch_state if mode == "sketched" else llm_state)(st_j)
    step = jax.jit(step)
    out = []
    for r in range(rounds):
        key = jax.random.fold_in(KEY, r)
        draws = llm_round_draws(key, st_j, jccfg)
        st_j, m_j = step(st_j, jb, key)
        st, m = step_t(st, tb, draws=draws)
        out.append((st_j, m_j, st, m))
    return out


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "pixtral-12b",
                                  "seamless-m4t-medium"])
def test_replicated_rounds_match_jax(name):
    """Two replicated rounds (the fused uplink, across a coherence
    redraw): the round's loss, θ, Θ and λ; a moe round reports its aux and
    MTP terms beside the loss."""
    fl = dict(n_workers=W, local_steps=1, local_lr=1e-2)
    for r, (st_j, m_j, st, m) in enumerate(_replay(name, "replicated", 2,
                                                   fl)):
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"round {r}")
        for g, w in zip(tree_leaves(st.Theta),
                        jax.tree_util.tree_leaves(st_j.Theta)):
            _close(g, w, STATE_ATOL, f"Θ, round {r}")
        for g, w in zip(tree_leaves(st.theta),
                        jax.tree_util.tree_leaves(st_j.theta)):
            _close(g, w, STATE_ATOL, f"θ, round {r}")
        _close(st.lam.re, st_j.lam.re, STATE_ATOL, f"λ, round {r}")
        _close(st.lam.im, st_j.lam.im, STATE_ATOL, f"λ, round {r}")
        terms = {"aux", "mtp"} if name.startswith("deepseek") else set()
        assert terms <= set(m) and not ({"aux", "mtp"} - terms) & set(m)
        assert all(bool(torch.isfinite(m[k])) for k in terms)


def test_sketched_round_of_qwen3_moe_matches_jax():
    """One sketched round of reduced qwen3-moe (ratio 16): the loss, Θ and
    the (W, d_s) λ; the round reports the workers' mean aux term."""
    fl = dict(n_workers=W, local_steps=1, local_lr=1e-2, sketch_ratio=16,
              sketch_lr=0.5)
    ((st_j, m_j, st, m),) = _replay("qwen3-moe-30b-a3b", "sketched", 1, fl)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                               rtol=LOSS_RTOL)
    for g, w in zip(tree_leaves(st.Theta),
                    jax.tree_util.tree_leaves(st_j.Theta)):
        _close(g, w, STATE_ATOL, "Θ")
    _close(st.lam.re, st_j.lam.re, STATE_ATOL, "λ")
    assert "aux" in m and "mtp" not in m and bool(torch.isfinite(m["aux"]))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, key", [("pixtral-12b", "patches"),
                                       ("seamless-m4t-medium", "frames")])
def test_launcher_batch_carries_the_frontend_embeddings(name, key, capsys):
    """One reduced round on the CPU through ``launch.train.run``: the batch
    the model sees holds the tokens and the stub patches (vlm) or frames
    (audio), worker-led, f32 draws of the round's generator."""
    base = reg.get_model(name, reduced=True)
    seen = []

    def loss(params, batch, remat=True):
        seen.append({k: v.clone() for k, v in batch.items()})
        return base.loss(params, batch, remat)

    args = launch.parser().parse_args(
        ["--arch", name, "--reduced", "--device", "cpu", "--workers", "2",
         "--batch", "1", "--seq", "8", "--local-steps", "1", "--rounds", "1"])
    out = launch.run(args, base._replace(loss=loss))
    cfg = base.cfg
    width = cfg.frontend_dim if key == "patches" else cfg.d_model
    assert sorted(seen[0]) == sorted(["tokens", key])
    assert tuple(seen[0]["tokens"].shape) == (2, 1, 8)
    assert tuple(seen[0][key].shape) == (2, 1, cfg.frontend_tokens, width)
    assert seen[0][key].dtype == torch.float32
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 1
    assert "done: 1 rounds" in capsys.readouterr().out
