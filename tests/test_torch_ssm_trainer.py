"""The port's federated LLM trainer (replicated mode, packed state) on the
SSM and hybrid families against the JAX package's ``make_fl_train``:
reduced falcon-mamba-7b and reduced recurrentgemma-2b in f32 (W = 4
workers, B = 2, S = 16, 2 local sgd steps), the packed layout, one round
and five replayed rounds across a coherence redraw from JAX's own
``init_fn`` state with JAX's draws injected, as
``tests/test_torch_llm_trainer.py`` replays granite-8b."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.channel import rayleigh as jrayleigh  # noqa: E402
from repro.core.packing import build_packspec as jbuild_packspec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import llm_trainer as jtrainer  # noqa: E402

from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.core.packing import build_packspec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.llm_trainer import (FLConfig, TreeRoundDraws,  # noqa: E402
                                           make_fl_train)
from repro_torch.tree import to_device, tree_leaves  # noqa: E402
from test_torch_llm_trainer import (_close_state, _configs,  # noqa: E402
                                    _state_from_jax)
from test_torch_llm_trainer import B, S, W  # noqa: E402
from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROUNDS = 5
KEY = jax.random.PRNGKey(0)
#: f32 on both sides.  Θ divides by Σ|h|² (Eq. 24), which amplifies the
#: summation-order differences of the local steps (the port's scan is B12's
#: sequential plain version, JAX's the associative scan) where the pilot sum
#: is small: one round holds to 1e-4, five rounds to 1e-3
ONE_ROUND_TOL = dict(rtol=1e-4, atol=1e-4)
REPLAY_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module", params=["falcon-mamba-7b",
                                        "recurrentgemma-2b"])
def replay(request):
    """JAX's init_fn state and ROUNDS rounds of its jitted train_step under
    coherence_iters = 2 (redraws in rounds 1 and 3), with every round's
    draws as JAX makes them from the round key."""
    jcfg = dataclasses.replace(jreg.get_config(request.param).reduced(),
                               param_dtype="float32")
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


def _port_step(jcfg):
    _, _, acfg, ccfg = _configs(2)
    model = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    flcfg = FLConfig(mode="replicated", n_workers=W, local_steps=2,
                     local_lr=1e-2)
    return make_fl_train(model, flcfg, acfg, ccfg, device="cpu")


def test_packed_state_layout_equals_jax(replay):
    """The port's own init packs θ in JAX's leaf order (the hybrid's tail
    list included): same offsets, shapes and D."""
    init_fn, _ = _port_step(replay["cfg"])
    st = init_fn(0)
    jspec = jbuild_packspec(replay["states"][0].theta, batch_dims=1)
    spec = build_packspec(st.theta, batch_dims=1)
    assert spec.d == replay["D"] == jspec.d
    assert spec.offsets == jspec.offsets and spec.shapes == jspec.shapes
    assert st.lam.re.shape == (W, spec.d) and st.chan.h.re.shape == (W,
                                                                       spec.d)
    assert replay["cfg"].param_count() < spec.d


def test_one_round_matches_jax(replay):
    _, step = _port_step(replay["cfg"])
    st = _state_from_jax(replay["states"][0])
    build.reset_launches()
    st1, m = step(st, {"tokens": torch.from_numpy(replay["tokens"])},
                  draws=replay["draws"][0])
    assert not build.launches          # CPU tensors: plain versions only
    want = replay["metrics"][0]
    for k in ("loss", "theta_drift", "inv_alpha"):
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4, atol=0)
    _close_state(st1, replay["states"][1], ONE_ROUND_TOL)
    assert st1.step == 1 and st1.opt.count == 2


def test_five_replayed_rounds_across_a_redraw(replay):
    _, step = _port_step(replay["cfg"])
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
    assert [tuple(l.shape) for l in tree_leaves(st.theta)] == [
        tuple(l.shape) for l in jax.tree_util.tree_leaves(
            replay["states"][-1].theta)]


def test_to_device_moves_a_state_and_draws_whole(replay):
    """``tree.to_device`` copies every field of a trainer state and a
    round's draws (the hybrid's tail list, ``Complex`` pairs, a missing
    redraw), keeps host values and sgd's ``nu is mu`` alias, and the moved
    state runs the same round to the same bits."""
    _, step = _port_step(replay["cfg"])
    st = _state_from_jax(replay["states"][0])
    draws = replay["draws"][1]
    st2, draws2 = to_device(st, "cpu"), to_device(draws, "cpu")
    assert type(st2) is type(st) and type(st2.chan.h) is Complex
    assert st2.opt.nu is st2.opt.mu and st2.step == st.step
    assert st2.chan.age == st.chan.age and type(draws2.h_fresh) is Complex
    assert to_device(replay["draws"][0], "cpu").h_fresh is None
    for a, b in zip(tree_leaves(st2.theta), tree_leaves(st.theta)):
        assert a is not b and not a.requires_grad and torch.equal(a, b)
    batch = {"tokens": torch.from_numpy(replay["tokens"])}
    (_, m), (_, m2) = (step(st, batch, draws=draws),
                       step(st2, batch, draws=draws2))
    assert float(m["loss"]) == float(m2["loss"])
