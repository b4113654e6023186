"""The models' optimisation flags in the port against the JAX package's:
``chunked_attn`` (``layers._attention_chunked`` and the reference's dispatch
order) and ``save_dots`` (the checkpoint policy that keeps the matrix
products), at small shapes and the reduced configs, on the same numpy
inputs."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import optflags as joptflags  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402

from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_llm_models import KEY, _close, _t  # noqa: E402

#: f32 attention: the same expressions, summation order only
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
#: f32 grads through the softmax and the projections
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
#: the reduced models' f32 loss against JAX's (tests/test_torch_ssm_models.py)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
#: 40 query rows in chunks of 16: the last chunk is padded by 8 rows
S, CHUNK = 40, 16
CFG = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=64, param_dtype="float32")
ARCHS = ("granite-8b", "falcon-mamba-7b", "recurrentgemma-2b")
#: the hybrid's 72 tokens run past its reduced 64-token attention window
SEQ = {"granite-8b": 16, "falcon-mamba-7b": 24, "recurrentgemma-2b": 72}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def chunked(monkeypatch):
    """``REPRO_OPT=chunked_attn`` with 16-row chunks, in both packages."""
    monkeypatch.setenv("REPRO_OPT", "chunked_attn")
    monkeypatch.setenv("REPRO_ATTN_CHUNK", str(CHUNK))
    monkeypatch.setattr(joptflags, "ATTN_CHUNK", CHUNK)


@pytest.mark.parametrize("window", [None, 12], ids=["causal", "window12"])
def test_attention_chunked_equals_jax(window):
    """S = 40 is not a multiple of the 16-row chunk."""
    qg, k, v = _x((2, S, 2, 2, 16), 1), _x((2, S, 2, 16), 2), \
        _x((2, S, 2, 16), 3)
    want = jL._attention_chunked(jnp.asarray(qg), jnp.asarray(k),
                                 jnp.asarray(v), window, CHUNK)
    got = L._attention_chunked(torch.from_numpy(qg), torch.from_numpy(k),
                               torch.from_numpy(v), window, CHUNK)
    assert got.shape == (2, S, 2, 2, 16)
    _close(got, want, FWD_TOL)
    # one row at a time, the chunked path is the masked one
    masked = torch.einsum(
        "bkgst,btkh->bskgh",
        L._attn_weights(torch.from_numpy(qg), torch.from_numpy(k),
                        L.causal_mask(S, window)), torch.from_numpy(v))
    torch.testing.assert_close(got, masked, rtol=1e-6, atol=1e-6)


def test_windowed_attention_under_the_flag_equals_jax(chunked):
    """A sliding window under ``chunked_attn`` takes the chunked path in
    both packages: forward and grads of Σ out·cot against JAX's."""
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    params = jL.attention_init(KEY, jcfg)
    x, cot = _x((2, S, 64)), _x((2, S, 64), 7)
    pos = jnp.broadcast_to(jnp.arange(S), (2, S))

    def f(p, xx):
        out, _ = jL.attention_fwd(p, xx, jcfg, pos, 12)
        return jnp.sum(out * cot), out

    (_, want), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(params,
                                                             jnp.asarray(x))
    p = _t(params, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    calls = []
    real = L._attention_chunked
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "_attention_chunked",
                   lambda *a: calls.append(a[3]) or real(*a))
        out, _ = L.attention_fwd(p, xt, tcfg, torch.arange(S), 12)
    assert calls == [12]
    _close(out, want, FWD_TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, w in zip(tree_leaves(p), jax.tree_util.tree_leaves(jgp)):
        _close(got.grad, w, GRAD_TOL)
    _close(xt.grad, jgx, GRAD_TOL)


@pytest.mark.parametrize("seq,window,route", [
    (S, None, "flash"), (S, 12, "chunked"), (12, 8, "masked"),
    (CHUNK, 8, "masked")])
def test_dispatch_order_under_the_flag(chunked, monkeypatch, seq, window,
                                       route):
    """The reference's order: B11 wherever there is no window and S ≥ 16
    (its plain version on the CPU), then the chunked path only for
    S > ATTN_CHUNK, else the masked einsum."""
    taken = []
    flash, chunk = L.flash_attention, L._attention_chunked
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a, **k: taken.append("flash") or flash(*a,
                                                                       **k))
    monkeypatch.setattr(L, "_attention_chunked",
                        lambda *a: taken.append("chunked") or chunk(*a))
    tcfg = ModelConfig(**CFG)
    p = _t(jL.attention_init(KEY, JModelConfig(**CFG)))
    out, _ = L.attention_fwd(p, torch.from_numpy(_x((2, seq, 64))), tcfg,
                             torch.arange(seq), window)
    assert taken == ([] if route == "masked" else [route])
    assert bool(torch.isfinite(out).all())


class _CountDots(TorchDispatchMode):
    """Counts the matrix products the dispatcher runs."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in transformer._DOTS:
            self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(tm, params, tokens, remat=True):
    p = _t(params, requires_grad=True)
    with _CountDots() as fwd:
        loss, _ = tm.loss(p, {"tokens": torch.from_numpy(tokens)},
                          remat=remat)
    with _CountDots() as bwd:
        loss.backward()
    return (loss.detach(), [leaf.grad for leaf in tree_leaves(p)],
            sum(fwd.n.values()), sum(bwd.n.values()))


@pytest.mark.parametrize("name", ARCHS)
def test_save_dots_equals_the_plain_remat_and_recomputes_no_dot(
        name, monkeypatch):
    """Under ``save_dots`` each reduced family (f32) gives the loss and the
    gradients of the unflagged port bit for bit, its loss within
    ``LOSS_TOL`` of JAX's under the same flag, and its backward runs
    exactly the matrix products of a backward without checkpoints: no
    forward product runs again (the plain checkpoint runs them again)."""
    jcfg = dataclasses.replace(jreg.get_config(name).reduced(),
                               param_dtype="float32")
    params = jreg.build_model(jcfg).init(KEY)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               (2, SEQ[name]), dtype=np.int32)
    tm = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    monkeypatch.delenv("REPRO_OPT", raising=False)
    plain = _loss_and_grads(tm, params, tokens)
    no_remat = _loss_and_grads(tm, params, tokens, remat=False)
    monkeypatch.setenv("REPRO_OPT", "save_dots")
    dots = _loss_and_grads(tm, params, tokens)
    want, _ = jreg.build_model(jcfg).loss(params,
                                          {"tokens": jnp.asarray(tokens)})

    assert torch.equal(dots[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(dots[1], plain[1]))
    _close(dots[0], want, LOSS_TOL)
    assert dots[2] == plain[2] == no_remat[2]          # the same forward
    assert dots[3] == no_remat[3] < plain[3]
