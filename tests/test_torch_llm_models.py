"""The port's transformer models against the JAX package's: the registry
(every architecture field for field, the analytic parameter counts), the
layers (rmsnorm, rope, dense, the MLPs, GQA attention forward and grads)
and reduced granite-8b end to end (logits, loss and its grads) from JAX's
own parameters, on the same numpy inputs.

The JAX side runs its default attention, the masked einsum; the port's
full causal attention (S ≥ 16) runs B11's plain version on the CPU, so
these tests also hold B11's wiring against the reference attention."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402

from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

KEY = jax.random.PRNGKey(0)
#: f32 forward: same expressions, summation order only (the bound
#: tests/test_attention_dispatch.py puts on flash against the einsum)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
#: f32 grads through softmax, norms and the residual stream
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, requires_grad=False):
    out = model_params_from_numpy(_np(tree), device="cpu")
    if requires_grad:
        for leaf in tree_leaves(out):
            leaf.requires_grad_()
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jreg.ARCHS))
def test_archs_and_param_counts_equal_jax(name):
    jc, tc = jreg.ARCHS[name], reg.ARCHS[name]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    assert tc.hd == jc.hd and tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.reduced().param_count() == jc.reduced().param_count()
    assert str(tc.dtype) == f"torch.{jc.dtype.name}"


def test_registry_lists_and_refuses_unported_families():
    assert reg.list_archs() == jreg.list_archs()
    with pytest.raises(KeyError):
        reg.get_config("nope")
    for name in ("qwen3-moe-30b-a3b", "seamless-m4t-medium"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            reg.get_model(name, reduced=True)
    # decode is ported (tests/test_torch_decode.py holds it against JAX)
    m = reg.get_model("granite-8b", reduced=True)
    assert tuple(m.init_cache(1, 8, device="cpu")["k"].shape) == (
        2, 1, 8, 4, 32)
    sw = reg.get_model("granite-8b", reduced=True, sliding_window=8)
    assert sw.cfg.sliding_window == 8


@pytest.mark.parametrize("name", [n for n in sorted(reg.ARCHS)
                                  if reg.ARCHS[n].family in reg.FAMILIES])
@pytest.mark.parametrize("extra_layers", [0, 1])
def test_packed_param_count_equals_both_trees(name, extra_layers):
    """``packed_param_count`` is the number of parameters in JAX's tree
    (shapes only, through ``jax.eval_shape``) and in the port's, at the
    reduced config and one layer deeper (a hybrid tail)."""
    cfg = reg.ARCHS[name].reduced()
    cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers + extra_layers)
    jcfg = dataclasses.replace(jreg.ARCHS[name].reduced(),
                               n_layers=cfg.n_layers)
    shapes = jax.eval_shape(jreg.build_model(jcfg).init, KEY)
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes))
    got = sum(leaf.numel() for leaf in tree_leaves(
        reg.build_model(cfg).init(0, device="cpu")))
    assert reg.packed_param_count(cfg) == want == got
    with pytest.raises(NotImplementedError, match="qwen3-moe-30b-a3b"):
        reg.packed_param_count(reg.ARCHS["qwen3-moe-30b-a3b"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

CFG = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=64, param_dtype="float32")
JCFG, TCFG = JModelConfig(**CFG), ModelConfig(**CFG)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rmsnorm_rope_dense_match():
    x = _x((2, 8, 64))
    scale = _x((64,), 2)
    _close(L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jL.rmsnorm({"scale": scale}, x), FWD_TOL)
    xh = _x((2, 8, 4, 16), 3)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    _close(L.rope(torch.from_numpy(xh), torch.from_numpy(pos.copy()), 1e4),
           jL.rope(xh, pos, 1e4), FWD_TOL)
    p = jL.dense_init(KEY, 64, 32, jnp.float32, bias=True)
    p = dict(p, b=jnp.asarray(_x((32,), 4)))
    _close(L.dense(_t(p), torch.from_numpy(x)), jL.dense(p, x), FWD_TOL)
    lp = {"scale": _x((64,), 5), "bias": _x((64,), 6)}
    _close(L.layernorm(_t(lp), torch.from_numpy(x)), jL.layernorm(lp, x),
           FWD_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu_mlp", "geglu"])
def test_mlp_matches(act):
    jc = dataclasses.replace(JCFG, mlp_act=act)
    tc = dataclasses.replace(TCFG, mlp_act=act)
    p = jL.mlp_init(KEY, jc)
    x = _x((2, 8, 64))
    _close(L.mlp(_t(p), torch.from_numpy(x), tc), jL.mlp(p, x, jc), FWD_TOL)


@pytest.fixture(scope="module", params=[None, 16], ids=["full", "window16"])
def attention_case(request):
    """GQA attention (4 heads over 2 KV heads, S = 64): JAX's forward and
    its grads w.r.t. params and x of Σ out·cot, traced once."""
    window = request.param
    params = jL.attention_init(KEY, JCFG)
    x = _x((2, 64, 64))
    cot = _x((2, 64, 64), 7)
    pos = jnp.broadcast_to(jnp.arange(64), (2, 64))

    def f(p, xx):
        out, _ = jL.attention_fwd(p, xx, JCFG, pos, window)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return dict(window=window, params=params, x=x, cot=cot, out=out,
                grads=grads)


def test_attention_fwd_and_grads_match(attention_case):
    c = attention_case
    p = _t(c["params"], requires_grad=True)
    x = torch.from_numpy(c["x"]).requires_grad_()
    out, kv = L.attention_fwd(p, x, TCFG, torch.arange(64), c["window"])
    assert kv["k"].shape == (2, 64, 2, 16)
    _close(out, c["out"], FWD_TOL)
    (out * torch.from_numpy(c["cot"])).sum().backward()
    jp_grads, jx_grad = c["grads"]
    for got, want in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp_grads)):
        _close(got.grad, want, GRAD_TOL)
    _close(x.grad, jx_grad, GRAD_TOL)


@pytest.mark.parametrize("n_kv_heads", [1, 2, 4], ids=["mqa", "gqa", "mha"])
def test_attention_hands_b11_contiguous_grouped_heads(monkeypatch,
                                                      n_kv_heads):
    """B11's wrapper refuses non-contiguous operands on the card: for every
    group size (MHA's g = 1 included) ``attention_fwd`` hands it contiguous
    (B, H, S, hd) q, k, v, the KV heads repeated as head = kv·g + i (the
    output and the input's gradient equal the masked einsum's, which
    groups the heads itself)."""
    cfg = dataclasses.replace(TCFG, n_kv_heads=n_kv_heads)
    real, seen = L.flash_attention, []

    def spy(q, k, v, causal):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(L, "flash_attention", spy)
    p = L.attention_init(0, cfg, device="cpu")
    S, hd, g = 16, cfg.hd, cfg.n_heads // n_kv_heads
    xs = [torch.from_numpy(_x((2, S, 64))).requires_grad_() for _ in "ab"]
    out, _ = L.attention_fwd(p, xs[0], cfg, torch.arange(S), None)
    assert seen == [True]
    x = xs[1]
    pos = torch.arange(S)
    qg = L.rope(L._split_heads(L.dense(p["wq"], x), cfg.n_heads, hd), pos,
                cfg.rope_theta).reshape(2, S, n_kv_heads, g, hd)
    k = L.rope(L._split_heads(L.dense(p["wk"], x), n_kv_heads, hd), pos,
               cfg.rope_theta)
    v = L._split_heads(L.dense(p["wv"], x), n_kv_heads, hd)
    w = L._attn_weights(qg, k, L.causal_mask(S, None))
    o = torch.einsum("bkgst,btkh->bskgh", w, v).reshape(2, S, -1)
    want = L.dense(p["wo"], o)
    _close(out, want.detach().numpy(), dict(rtol=1e-5, atol=1e-6))
    out.sum().backward()
    want.sum().backward()
    _close(xs[0].grad, xs[1].grad.numpy(), dict(rtol=1e-4, atol=1e-6))


def test_attention_worker_axis_equals_per_worker_calls(attention_case):
    """Leaves with a leading worker dim apply per worker (W folded into the
    attention batch)."""
    c = attention_case
    p1 = _t(c["params"])
    p2 = _t(jax.tree.map(lambda l: l * 1.5, c["params"]))
    stacked = {k: {kk: torch.stack([p1[k][kk], p2[k][kk]]) for kk in p1[k]}
               for k in p1}
    x = torch.from_numpy(np.stack([c["x"], c["x"][::-1].copy()]))
    both, _ = L.attention_fwd(stacked, x, TCFG, torch.arange(64), c["window"])
    for w, p in enumerate((p1, p2)):
        one, _ = L.attention_fwd(p, x[w], TCFG, torch.arange(64), c["window"])
        torch.testing.assert_close(both[w], one, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# reduced granite-8b end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    """Reduced granite-8b in f32: JAX's params, logits, loss and grads."""
    jcfg = dataclasses.replace(jreg.get_config("granite-8b").reduced(),
                               param_dtype="float32")
    jm = jreg.build_model(jcfg)
    params = jm.init(KEY)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, _ = jm.forward(params, batch)
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params,
                                                                  batch)
    return dict(cfg=jcfg, params=params, tokens=tokens, logits=logits,
                loss=loss, grads=grads)


def _port_model(jcfg):
    return reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))


def test_lm_forward_loss_and_grads_match(granite):
    tm = _port_model(granite["cfg"])
    p = _t(granite["params"], requires_grad=True)
    batch = {"tokens": torch.from_numpy(granite["tokens"])}
    logits, aux = tm.forward(p, batch)
    assert float(aux) == 0.0
    _close(logits, granite["logits"], dict(rtol=1e-4, atol=1e-4))
    loss, metrics = tm.loss(p, batch)
    _close(loss, granite["loss"], FWD_TOL)
    assert metrics["xent"] is loss
    loss.backward()
    for got, want in zip(tree_leaves(p),
                         jax.tree_util.tree_leaves(granite["grads"])):
        _close(got.grad, want, GRAD_TOL)


def test_remat_on_and_off_give_equal_bits(granite):
    tm = _port_model(granite["cfg"])
    batch = {"tokens": torch.from_numpy(granite["tokens"])}
    out = []
    for remat in (True, False):
        p = _t(granite["params"], requires_grad=True)
        loss, _ = tm.loss(p, batch, remat=remat)
        loss.backward()
        out.append((loss.detach(), [l.grad for l in tree_leaves(p)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_worker_led_params_give_one_loss_per_worker(granite):
    tm = _port_model(granite["cfg"])
    p = _t(granite["params"])
    pw = tree_map(lambda l: torch.stack([l, l * 0.9]), p)
    tok = torch.from_numpy(granite["tokens"])
    losses, _ = tm.loss(pw, {"tokens": torch.stack([tok, tok.flip(1)])})
    assert losses.shape == (2,)
    l0, _ = tm.loss(p, {"tokens": tok})
    torch.testing.assert_close(losses[0], l0, rtol=1e-6, atol=1e-6)


def test_bf16_loss_matches_within_bf16_rounding():
    """Reduced granite in its own bf16: activations round at other places
    in the two frameworks (and the port's attention is B11's f32 softmax
    where JAX's is the einsum), so the loss is held to 2e-2 relative."""
    jm = jreg.get_model("granite-8b", reduced=True)
    params = jm.init(KEY)
    tokens = np.random.default_rng(4).integers(0, jm.cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    want, _ = jm.loss(params, {"tokens": jnp.asarray(tokens)})
    tm = reg.get_model("granite-8b", reduced=True)
    got, _ = tm.loss(_t(params), {"tokens": torch.from_numpy(tokens)})
    assert _t(params)["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)
