"""The port's sketched mode (A-FADMM-CS, paper §6) against the JAX package's
``make_sketched`` on one device: the linear-model pipeline of
``tests/test_fl_llm.py`` and reduced granite-8b in f32 (W = 4, B = 2,
S = 16, ratio 16, sketch_lr 0.5, 2 local sgd steps at 1e-2), each from
JAX's own ``init_fn`` state on JAX's draws, one round and three replayed
rounds across a coherence redraw, noisy and noise-free; one markov-doppler
round under the evict-retransmit guard; a JAX-written ``SketchFLState``
snapshot restored into the port; the refusals; the launcher's
``--mode sketched``.  Port against port: telemetry's model-space update
norm."""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.core import cplx as jcplx  # noqa: E402
from repro.core.admm import AdmmConfig as JAdmmConfig  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.phy import make_scenario as jmake_scenario  # noqa: E402
from repro.train import llm_trainer as jtrainer  # noqa: E402

from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.packing import build_packspec  # noqa: E402
from repro_torch.faults import GuardConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.llm_trainer import (SKETCH_SEED, FLConfig,  # noqa: E402
                                           SketchFLState, _sketch_dim,
                                           draw_round, make_fl_train)
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_replay import (llm_round_draws, one_thread,  # noqa: E402,F401
                          sketch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

W, B, S = 4, 2, 16
KEY = jax.random.PRNGKey(0)
SKETCH = dict(n_workers=W, local_steps=2, local_lr=1e-2, sketch_ratio=16,
              sketch_lr=0.5)
#: f32 on both sides, as ``tests/test_torch_llm_trainer.py`` holds the
#: replicated mode: the local steps' sums run in other orders (B11's plain
#: version against JAX's einsum) and the round divides by Σ|h|²
ONE_ROUND_TOL = dict(rtol=1e-4, atol=1e-4)
REPLAY_TOL = dict(rtol=1e-3, atol=1e-3)
_GUARD = dict(policy="evict-retransmit", snr_floor_db=-60.0, max_retries=2)


def _jax_cfg():
    return dataclasses.replace(jreg.get_config("granite-8b").reduced(),
                               param_dtype="float32")


def _configs(coherence_iters=2, noisy=True, n_workers=W):
    kw = dict(n_workers=n_workers, snr_db=40.0, noisy=noisy,
              coherence_iters=coherence_iters)
    admm = dict(rho=0.5, flip_on_change=False)
    return (JAdmmConfig(**admm), JChannelConfig(**kw), AdmmConfig(**admm),
            ChannelConfig(**kw))


def _tokens(cfg, rows=W):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (rows, B, S),
                                             dtype=np.int32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


def _close_state(got, want, tol, msg=""):
    for g, w in zip(tree_leaves(got.Theta),
                    jax.tree_util.tree_leaves(want.Theta)):
        _close(g, w, tol, msg)
    _close(got.lam.re, want.lam.re, tol, msg)
    _close(got.lam.im, want.lam.im, tol, msg)


def _jax_run(rounds, noisy=True, coherence_iters=2, fl=None, n_workers=W,
             sketch=SKETCH):
    """JAX's init state and ``rounds`` jitted sketched rounds of reduced
    granite-8b in f32, with the draws of each round made from its key."""
    fl = dict(fl or {})
    jcfg = _jax_cfg()
    jacfg, jccfg, _, _ = _configs(coherence_iters, noisy, n_workers)
    flj = dict(fl)
    if "guard" in fl:
        flj["guard"] = jfaults.GuardConfig(**fl["guard"])
    flcfg = jtrainer.FLConfig(mode="sketched", **dict(sketch, **flj))
    init_fn, step = jtrainer.make_fl_train(jreg.build_model(jcfg), flcfg,
                                           jacfg, jccfg)
    scn = None
    if fl.get("scenario") is not None:
        scn = jmake_scenario(fl["scenario"], jccfg)
    tokens = _tokens(jcfg, sketch["n_workers"])
    st = init_fn(KEY)
    step = jax.jit(step)
    states, metrics, draws = [st], [], []
    for r in range(rounds):
        key = jax.random.fold_in(KEY, r)
        draws.append(llm_round_draws(key, st, jccfg, scenario=scn,
                                     guard=flj.get("guard")))
        st, m = step(st, {"tokens": jnp.asarray(tokens)}, key)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()
                        if not k.startswith("_")})
    return dict(cfg=jcfg, tokens=tokens, states=states, metrics=metrics,
                draws=draws, noisy=noisy, coherence_iters=coherence_iters,
                fl=fl, sketch=sketch, n_workers=n_workers)


def _port_trainer(run, **extra):
    _, _, acfg, ccfg = _configs(run["coherence_iters"], run["noisy"],
                                run["n_workers"])
    model = reg.build_model(ModelConfig(**dataclasses.asdict(run["cfg"])))
    fl = dict(run["fl"])
    if "guard" in fl:
        fl["guard"] = GuardConfig(**fl["guard"])
    flcfg = FLConfig(mode="sketched", **dict(run["sketch"], **fl, **extra))
    return make_fl_train(model, flcfg, acfg, ccfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _cached_run(noisy: bool):
    return _jax_run(3, noisy=noisy)


@pytest.fixture(scope="module", params=[True, False],
                ids=["noisy", "noise-free"])
def replay(request):
    return _cached_run(request.param)


@pytest.fixture(scope="module")
def noisy_run():
    return _cached_run(True)


def _replay_rounds(run, rounds, tol):
    _, step = _port_trainer(run)
    st = sketch_state(run["states"][0])
    batch = {"tokens": torch.from_numpy(run["tokens"])}
    for r in range(rounds):
        build.reset_launches()
        st, m = step(st, batch, draws=run["draws"][r])
        assert not build.launches      # CPU tensors: plain versions only
        want = run["metrics"][r]
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["inv_alpha"]), want["inv_alpha"],
                                   **tol)
        _close_state(st, run["states"][r + 1], tol, f"round {r}")
        assert st.step == r + 1
    return st


def test_one_round_matches_jax(replay):
    _replay_rounds(replay, 1, ONE_ROUND_TOL)


def test_three_replayed_rounds_across_a_redraw(replay):
    st = _replay_rounds(replay, 3, REPLAY_TOL)
    assert [d.h_fresh is not None for d in replay["draws"]] == [
        False, True, False]
    # the injected block is JAX's eager draw of the jitted step's own
    _close(st.chan.h.re, replay["states"][-1].chan.h.re,
           dict(rtol=1e-6, atol=1e-7))


def test_sketched_state_layout(noisy_run):
    """λ and h are (W, d_s) with d_s = ceil(D / 16); Θ is the model's one
    tree; the per-worker sketch state is far below the model (the JAX
    package's ``test_sketched_state_is_small``)."""
    init_fn, _ = _port_trainer(noisy_run)
    st = init_fn(0)
    assert isinstance(st, SketchFLState)
    D = build_packspec(st.Theta).d
    d_s = _sketch_dim(D, 16)
    assert d_s == noisy_run["states"][0].lam.re.shape[1]
    assert st.lam.re.shape == (W, d_s) and st.chan.h.re.shape == (W, d_s)
    assert not st.lam.re.any() and not st.lam.im.any()
    assert st.step == 0 and st.flt is None
    sk_total = sum(leaf.numel() for leaf in (st.lam.re, st.lam.im))
    assert sk_total < D


def test_markov_doppler_guard_round_matches_jax():
    """``tests/test_phy.py``'s sketched markov-doppler setting (W = 2,
    ratio 64) with the evict-retransmit guard, one round on JAX's draws."""
    sketch = dict(SKETCH, n_workers=2, sketch_ratio=64)
    run = _jax_run(1, coherence_iters=10, n_workers=2, sketch=sketch,
                   fl=dict(scenario="markov-doppler", guard=_GUARD))
    _, step = _port_trainer(run)
    st = sketch_state(run["states"][0])
    assert st.chan.h.re.shape == st.lam.re.shape
    batch = {"tokens": torch.from_numpy(run["tokens"])}
    st, m = step(st, batch, draws=run["draws"][0])
    want = run["metrics"][0]
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    for k in want:
        if k.startswith("guard/") and k != "guard/snr_db":
            assert float(m[k]) == want[k], k
    _close_state(st, run["states"][1], ONE_ROUND_TOL)


def _linear_model():
    d_in, d_out = 4, 3

    def jinit(key):
        kw, _ = jax.random.split(key)
        return {"w": jax.random.normal(kw, (d_in, d_out)) * 0.3,
                "b": jnp.zeros((d_out,))}

    def jloss(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return jnp.mean((pred - batch["y"]) ** 2), {}

    def tloss(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    jm = jreg.Model(cfg=None, init=jinit, forward=None, loss=jloss,
                    init_cache=None, decode_step=None)
    return jm, tloss


def test_linear_pipeline_matches_jax():
    """``tests/test_fl_llm.py``'s linear-model pipeline (noise-free, ratio
    2, sketch_lr 0.7, non-zero duals) on JAX's state and draws: Θ, λ and
    α⁻¹ as JAX's ``make_sketched`` computes them."""
    jm, tloss = _linear_model()
    flj = jtrainer.FLConfig(mode="sketched", n_workers=W, local_steps=2,
                            local_lr=1e-2, sketch_ratio=2, sketch_lr=0.7)
    jacfg = JAdmmConfig(rho=0.5, flip_on_change=False)
    jccfg = JChannelConfig(n_workers=W, noisy=False, snr_db=20.0)
    init_j, step_j = jtrainer.make_sketched(jm, flj, jacfg, jccfg)
    k = jax.random.PRNGKey(7)
    batch = {"x": jax.random.normal(k, (W, 5, 4)),
             "y": jax.random.normal(jax.random.fold_in(k, 1), (W, 5, 3))}
    st = init_j(KEY)
    st = st._replace(lam=jcplx.Complex(
        0.2 * jax.random.normal(jax.random.fold_in(k, 2), st.lam.re.shape),
        0.2 * jax.random.normal(jax.random.fold_in(k, 3), st.lam.im.shape)))
    key = jax.random.fold_in(KEY, 42)
    draws = llm_round_draws(key, st, jccfg)
    new_j, m_j = jax.jit(step_j)(st, batch, key)

    model = reg.Model(cfg=None, init=None, forward=None, loss=tloss,
                      init_cache=None, decode_step=None)
    flcfg = FLConfig(mode="sketched", n_workers=W, local_steps=2,
                     local_lr=1e-2, sketch_ratio=2, sketch_lr=0.7)
    _, step = make_fl_train(model, flcfg, AdmmConfig(rho=0.5,
                                                     flip_on_change=False),
                            ChannelConfig(n_workers=W, noisy=False,
                                          snr_db=20.0), device="cpu")
    new, m = step(sketch_state(st), jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a)), batch), draws=draws)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(m["inv_alpha"]), float(m_j["inv_alpha"]),
                               **tol)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), **tol)
    _close_state(new, new_j, tol)


def test_jax_written_state_restores_and_steps(tmp_path, noisy_run):
    """A ``SketchFLState`` snapshot the JAX package writes restores into the
    port (every leaf bit for bit), and one round from it matches JAX's."""
    path = os.path.join(tmp_path, "sketched.npz")
    st_j = noisy_run["states"][1]
    jsave(path, st_j)
    init_fn, step = _port_trainer(noisy_run)
    st = restore(path, init_fn(0))
    assert isinstance(st, SketchFLState) and st.step == 1
    for g, w in zip(tree_leaves(st.Theta),
                    jax.tree_util.tree_leaves(st_j.Theta)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(st.lam.re.numpy(), np.asarray(st_j.lam.re))
    assert np.array_equal(st.chan.h.im.numpy(), np.asarray(st_j.chan.h.im))
    assert st.chan.age == int(st_j.chan.age)
    st, m = step(st, {"tokens": torch.from_numpy(noisy_run["tokens"])},
                 draws=noisy_run["draws"][1])
    np.testing.assert_allclose(float(m["loss"]),
                               noisy_run["metrics"][1]["loss"],
                               rtol=1e-5)
    _close_state(st, noisy_run["states"][2], ONE_ROUND_TOL)


def test_telemetry_reports_the_model_space_norm(noisy_run):
    """Telemetry leaves the round's state bit for bit and reports
    sketch_lr · ‖decoded consensus‖ as ``obs/theta_update_norm``."""
    st0 = sketch_state(noisy_run["states"][0])
    batch = {"tokens": torch.from_numpy(noisy_run["tokens"])}
    out = []
    for tel in (None, True):
        _, step = _port_trainer(noisy_run, telemetry=tel)
        out.append(step(st0, batch, draws=noisy_run["draws"][0]))
    (a, _), (b, mb) = out
    for x, y in zip(tree_leaves(a.Theta), tree_leaves(b.Theta)):
        assert torch.equal(x, y)
    assert torch.equal(a.lam.re, b.lam.re)
    # Θ moved by sketch_lr · decode(consensus): recover it and its norm
    D = build_packspec(a.Theta).d
    delta = torch.cat([(x - y).reshape(-1) for x, y in zip(
        tree_leaves(a.Theta), tree_leaves(st0.Theta))])
    assert delta.shape == (D,)
    norm = float(mb["obs/theta_update_norm"])
    np.testing.assert_allclose(norm, float(delta.norm()), rtol=1e-4)
    assert np.isfinite(norm) and norm > 0


def test_refusals():
    _, _, acfg, ccfg = _configs()
    model = reg.get_model("granite-8b", reduced=True)
    with pytest.raises(ValueError, match="replicated-mode feature"):
        make_fl_train(model, FLConfig(mode="sketched", population=4,
                                      cohort=2), acfg, ccfg, device="cpu")
    with pytest.raises(ValueError, match="positive compression ratio"):
        _sketch_dim(100, 0)
    with pytest.raises(ValueError, match="positive compression ratio"):
        jtrainer._sketch_dim(100, 0)
    assert _sketch_dim(100, 16) == jtrainer._sketch_dim(100, 16) == 8
    assert _sketch_dim(10_000, 16) == jtrainer._sketch_dim(10_000, 16)
    assert SKETCH_SEED == jtrainer.SKETCH_SEED


def test_draws_are_the_sketch_planes(noisy_run):
    """The trainer's own draws are (W, d_s) planes, as JAX's are."""
    init_fn, _ = _port_trainer(noisy_run)
    st = init_fn(0)
    d = draw_round(5, st, _configs()[3])
    assert d.noise_re.shape == (st.lam.re.shape[1],)
    assert d.h_fresh is None
    st = st._replace(chan=st.chan._replace(age=1))
    d = draw_round(5, st, _configs()[3])
    assert isinstance(d.h_fresh, Complex)
    assert d.h_fresh.re.shape == st.lam.re.shape


def test_launch_sketched_runs(tmp_path):
    from repro_torch.launch.train import main

    rc = main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
               "--mode", "sketched", "--sketch-ratio", "16", "--workers",
               "2", "--batch", "1", "--seq", "16", "--local-steps", "1",
               "--rounds", "3", "--log-every", "1", "--run-dir",
               str(tmp_path / "run")])
    assert rc == 0
    from repro_torch.obs.validate import validate_run_dir
    assert validate_run_dir(str(tmp_path / "run")) == []

