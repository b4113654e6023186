"""The port's federated LLM trainer (replicated mode, packed state) against
the JAX package's ``make_fl_train`` on reduced granite-8b (W = 4 workers,
B = 2, S = 16, 2 local sgd steps): the state layout, one round and five
replayed rounds across a coherence redraw from JAX's own ``init_fn`` state
with JAX's draws injected, the fused/composed uplinks, the ideal-channel
consensus, training, the refused options and JAX's ValueErrors, and
``token_dataset``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.admm import AdmmConfig as JAdmmConfig  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.core.channel import rayleigh as jrayleigh  # noqa: E402
from repro.core.packing import build_packspec as jbuild_packspec  # noqa: E402
from repro.data.synthetic import token_dataset as jtoken_dataset  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import llm_trainer as jtrainer  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core.admm import AdmmConfig  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.packing import (build_packspec, pack_cplx,  # noqa: E402
                                      unpack_cplx)
from repro_torch.core.tree_ota import ota_tree_round_packed_state  # noqa: E402
from repro_torch.data.synthetic import token_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.llm_trainer import (FLConfig, TreeRoundDraws,  # noqa: E402
                                           make_fl_train)
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

W, B, S = 4, 2, 16
ROUNDS = 5
KEY = jax.random.PRNGKey(0)
#: f32 on both sides.  The round divides by Σ|h|² (Eq. 24), which amplifies
#: the summation-order differences of the local steps (the port's attention
#: is B11's plain version, JAX's the masked einsum) where the pilot sum is
#: small; one round holds to 1e-4, five rounds to 1e-3
ONE_ROUND_TOL = dict(rtol=1e-4, atol=1e-4)
REPLAY_TOL = dict(rtol=1e-3, atol=1e-3)


def _jax_cfg():
    return dataclasses.replace(jreg.get_config("granite-8b").reduced(),
                               param_dtype="float32")


def _configs(coherence_iters):
    kw = dict(n_workers=W, snr_db=40.0, coherence_iters=coherence_iters)
    admm = dict(rho=0.5, flip_on_change=False)
    return (JAdmmConfig(**admm), JChannelConfig(**kw), AdmmConfig(**admm),
            ChannelConfig(**kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state_from_jax(st):
    return convert.tree_fl_state_from_numpy(
        _np(st.theta), _np(st.Theta), np.asarray(st.lam.re),
        np.asarray(st.lam.im), np.asarray(st.chan.h.re),
        np.asarray(st.chan.h.im), int(st.chan.age), int(st.step),
        opt={"mu": _np(st.opt.mu), "nu": None, "count": int(st.opt.count)},
        device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **tol)


def _close_state(got, want, tol):
    for g, w in zip(tree_leaves(got.theta), jax.tree_util.tree_leaves(
            want.theta)):
        _close(g, w, tol)
    for g, w in zip(tree_leaves(got.Theta), jax.tree_util.tree_leaves(
            want.Theta)):
        _close(g, w, tol)
    _close(got.lam.re, want.lam.re, tol)
    _close(got.lam.im, want.lam.im, tol)
    assert got.chan.age == int(want.chan.age)
    # the injected block is JAX's eager draw, the jitted step's own draw
    # may differ from it in the last ulp
    _close(got.chan.h.re, want.chan.h.re, dict(rtol=1e-6, atol=1e-7))


@pytest.fixture(scope="module")
def replay():
    """JAX's init_fn state and ROUNDS rounds of its jitted train_step under
    coherence_iters = 2 (redraws in rounds 1 and 3), with every round's
    draws as JAX makes them from the round key."""
    jcfg = _jax_cfg()
    jacfg, jccfg, _, _ = _configs(2)
    flcfg = jtrainer.FLConfig(mode="replicated", n_workers=W, local_steps=2,
                              local_lr=1e-2)
    init_fn, step = jtrainer.make_fl_train(jreg.build_model(jcfg), flcfg,
                                           jacfg, jccfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (W, B, S),
                                               dtype=np.int32)
    st0 = init_fn(KEY)
    D = jbuild_packspec(st0.theta, batch_dims=1).d
    step = jax.jit(step)
    states, metrics, draws = [st0], [], []
    st = st0
    for r in range(ROUNDS):
        key = jax.random.fold_in(KEY, r)
        kc, kn = jax.random.split(key)
        redraw = int(st.chan.age) + 1 >= jccfg.coherence_iters
        h = jrayleigh(kc, (W, D)) if redraw else None
        noise = jtransport.matched_filter_noise_re(kn, (D,), jccfg)
        draws.append(TreeRoundDraws(
            None if h is None else Complex(torch.tensor(np.asarray(h.re)),
                                           torch.tensor(np.asarray(h.im))),
            torch.tensor(np.asarray(noise))))
        st, m = step(st, {"tokens": jnp.asarray(tokens)}, key)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=jcfg, tokens=tokens, states=states, metrics=metrics,
                draws=draws, D=D)


def _port_trainer(jcfg, coherence_iters=2, **fl):
    _, _, acfg, ccfg = _configs(coherence_iters)
    model = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    flcfg = FLConfig(mode="replicated", n_workers=W, local_steps=2,
                     local_lr=1e-2, **fl)
    return make_fl_train(model, flcfg, acfg, ccfg, device="cpu")


def test_packed_state_layout(replay):
    init_fn, _ = _port_trainer(replay["cfg"])
    st = init_fn(0)
    D = replay["D"]
    assert st.lam.re.shape == (W, D) and st.lam.re.dtype == torch.float32
    assert not st.lam.re.any() and not st.lam.im.any()
    assert st.chan.h.re.shape == (W, D) and st.chan.age == 0
    assert build_packspec(st.theta, batch_dims=1).d == D
    jst = replay["states"][0]
    assert [tuple(l.shape) for l in tree_leaves(st.theta)] == [
        tuple(l.shape) for l in jax.tree_util.tree_leaves(jst.theta)]
    for T, t in zip(tree_leaves(st.Theta), tree_leaves(st.theta)):
        assert torch.equal(T, t.float().mean(0).to(t.dtype))
    assert st.opt.nu is st.opt.mu and st.opt.count == 0 and st.step == 0
    # workers differ, and the real parts of a CN(0, 1) block have var 1/2
    emb = st.theta["embed"]["table"]
    assert not torch.equal(emb[0], emb[1])
    assert abs(float(st.chan.h.re.var()) - 0.5) < 0.05


def test_one_round_matches_jax(replay):
    _, step = _port_trainer(replay["cfg"])
    st = _state_from_jax(replay["states"][0])
    batch = {"tokens": torch.from_numpy(replay["tokens"])}
    build.reset_launches()
    st1, m = step(st, batch, draws=replay["draws"][0])
    assert not build.launches          # CPU tensors: plain versions only
    want = replay["metrics"][0]
    for k in ("loss", "theta_drift", "inv_alpha"):
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4, atol=0)
    _close_state(st1, replay["states"][1], ONE_ROUND_TOL)
    assert st1.step == 1 and st1.opt.count == 2


def test_five_replayed_rounds_across_a_redraw(replay):
    _, step = _port_trainer(replay["cfg"])
    st = _state_from_jax(replay["states"][0])
    batch = {"tokens": torch.from_numpy(replay["tokens"])}
    for r in range(ROUNDS):
        st, m = step(st, batch, draws=replay["draws"][r])
        want = replay["metrics"][r]
        for k in ("loss", "theta_drift", "inv_alpha"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-3)
        _close_state(st, replay["states"][r + 1], REPLAY_TOL)
    assert [d.h_fresh is not None for d in replay["draws"]] == [
        False, True, False, True, False]


def test_fused_and_composed_uplinks_agree_bitwise(replay):
    batch = {"tokens": torch.from_numpy(replay["tokens"])}
    out = []
    for fused in (None, False):
        _, step = _port_trainer(replay["cfg"], ota_fused=fused)
        st, m = step(_state_from_jax(replay["states"][0]), batch,
                     draws=replay["draws"][0])
        out.append((st, m))
    (a, ma), (b, mb) = out
    assert torch.equal(ma["inv_alpha"], mb["inv_alpha"])
    assert torch.equal(a.lam.re, b.lam.re) and torch.equal(a.lam.im,
                                                           b.lam.im)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.Theta),
                                                 tree_leaves(b.Theta)))


def test_worker_chunk_streams_the_same_round(replay):
    """``ota_worker_chunk`` = 3 < W streams the fused round in two cohorts:
    the sums group differently, so tolerance-equal."""
    batch = {"tokens": torch.from_numpy(replay["tokens"])}
    outs = []
    for chunk in (None, 3):
        _, step = _port_trainer(replay["cfg"], ota_worker_chunk=chunk)
        outs.append(step(_state_from_jax(replay["states"][0]), batch,
                         draws=replay["draws"][0])[0])
    for x, y in zip(tree_leaves(outs[0].Theta), tree_leaves(outs[1].Theta)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_ideal_channel_equals_digital_consensus():
    """h ≡ 1, no noise, no power control: the packed tree round is the
    D-FADMM update Θ = mean(θ + Re{λ}/ρ), λ' = λ + ρ(θ − Θ) (Appendix A,
    Eqs. 21-22; the port of tests/test_fl_llm.py's ideal-channel test)."""
    r = np.random.default_rng(3)
    theta = {"w": torch.from_numpy(r.standard_normal((W, 8, 3)).astype(
        np.float32)), "b": torch.from_numpy(r.standard_normal((W, 5)).astype(
            np.float32))}
    lam = {k: Complex(torch.from_numpy(0.3 * r.standard_normal(
        v.shape).astype(np.float32)), torch.zeros(v.shape))
        for k, v in theta.items()}
    spec = build_packspec(theta, batch_dims=1)
    lam_p = pack_cplx(spec, lam)
    ones = torch.ones(W, spec.d)
    acfg = AdmmConfig(rho=0.5, power_control=False)
    ccfg = ChannelConfig(n_workers=W, noisy=False)
    Theta, lam_new, m = ota_tree_round_packed_state(
        theta, lam_p, Complex(ones, torch.zeros_like(ones)),
        torch.zeros(spec.d), acfg, ccfg, spec)
    assert float(m["inv_alpha"]) == 1.0
    lam_new_t = unpack_cplx(spec, lam_new)
    for name in ("w", "b"):
        want = (theta[name] + lam[name].re / acfg.rho).mean(0)
        torch.testing.assert_close(Theta[name], want, rtol=1e-5, atol=1e-6)
        want_lam = lam[name].re + acfg.rho * (theta[name] - want[None])
        torch.testing.assert_close(lam_new_t[name].re, want_lam, rtol=1e-5,
                                   atol=1e-6)


def test_twelve_rounds_lower_the_loss():
    """The port's own init and draws, bf16 as the config says: 12 rounds
    lower the loss by 10 % (JAX's test_fl_mode_trains bar)."""
    model = reg.get_model("granite-8b", reduced=True)
    _, _, acfg, ccfg = _configs(10)
    init_fn, step = make_fl_train(
        model, FLConfig(mode="replicated", n_workers=W, local_steps=2,
                        local_lr=1e-2), acfg, ccfg, device="cpu")
    st = init_fn(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (W, B, S), dtype=np.int32))
    losses = []
    for r in range(12):
        st, m = step(st, {"tokens": tokens}, key=r)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0], losses
    assert st.theta["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("override,exc", [
    (dict(mode="bogus"), ValueError),
    # JAX's ValueErrors: scenarios, faults, guards and sampling need the
    # packed state; a population needs its cohort
    (dict(scenario="markov-doppler", packed_uplink=False), ValueError),
    (dict(faults=object(), packed_uplink=False), ValueError),
    (dict(guard=object(), packed_uplink=False), ValueError),
    # telemetry rides the packed receive (JAX's refusal and wording)
    (dict(telemetry=True, packed_uplink=False), ValueError),
    (dict(population=8, cohort=4, packed_uplink=False), ValueError),
    (dict(population=8), ValueError),
    (dict(transport_backend="jnp"), ValueError),
    # a column tile no plan of the fused kernel takes
    (dict(ota_block_cols=512), ValueError),
    (dict(doppler_hz=5.0), ValueError),
    (dict(cohort=2), ValueError),
], ids=lambda v: "-".join(v) if isinstance(v, dict) else v.__name__)
def test_unsupported_options_raise(override, exc):
    model = reg.get_model("granite-8b", reduced=True)
    _, _, acfg, ccfg = _configs(10)
    flcfg = dataclasses.replace(FLConfig(n_workers=W), **override)
    with pytest.raises(exc):
        make_fl_train(model, flcfg, acfg, ccfg, device="cpu")


def test_transport_backend_pallas_is_the_ports_route():
    """JAX's ``transport_backend``: None and "pallas" build the same
    trainer (the kernels on CUDA tensors, their plain versions here); "jnp"
    and unknown names are refused by name."""
    model = reg.get_model("granite-8b", reduced=True)
    _, _, acfg, ccfg = _configs(10)
    for backend in (None, "pallas"):
        init_fn, step = make_fl_train(
            model, FLConfig(n_workers=W, transport_backend=backend), acfg,
            ccfg, device="cpu")
        assert callable(init_fn) and callable(step)
    for backend, match in (("jnp", "'jnp'"), ("xla", "unknown")):
        with pytest.raises(ValueError, match=match):
            make_fl_train(model, FLConfig(n_workers=W,
                                          transport_backend=backend),
                          acfg, ccfg, device="cpu")


def test_token_dataset_shape_dtype_and_skew():
    """Same distribution as JAX's: each worker's most frequent token takes
    the Zipf(2) head's share, 1/Σ r⁻² over the vocabulary, and workers
    disagree on which token that is."""
    V, n, L = 512, 4, 512
    toks = token_dataset(0, n, L, V, n_workers=4, device="cpu")
    assert toks.shape == (4, n, L) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < V
    jtoks = np.asarray(jtoken_dataset(KEY, n, L, V, n_workers=4))
    head = 1.0 / float(np.sum(np.arange(1, V + 1, dtype=np.float64) ** -2.0))
    tops = []
    for w in range(4):
        counts = torch.bincount(toks[w].reshape(-1).long(), minlength=V)
        jcounts = np.bincount(jtoks[w].reshape(-1), minlength=V)
        tops.append(int(counts.argmax()))
        # 2,048 draws: the head's share has std ~0.011
        assert abs(float(counts.max()) / (n * L) - head) < 0.05
        assert abs(jcounts.max() / (n * L) - head) < 0.05
    assert len(set(tops)) > 1
