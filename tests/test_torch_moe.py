"""The port's moe family (``repro_torch.models.moe``) against the JAX
package's on reduced deepseek-v3-671b (MLA with and without q_lora, a
shared expert, MTP, one leading dense layer) and qwen3-moe-30b-a3b (GQA,
B11's plain version on the CPU) in f32, from JAX's parameters: the
sort-based dispatch (a case whose capacity drops pairs, and one under
``grouped_moe``) with the experts picked compared one by one, ``moe_apply``
with its gradients, MLA's forward and gradients, the model's logits, aux
and MTP logits, its loss and every gradient leaf, decode token by token on
the logits and every cache leaf.  Port against port: a worker-led tree's
per-worker losses, decode against the forward at ≤ 8 tokens (where no pair
is dropped), and a dispatch with no accumulating scatter in either
direction and a stable sort."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
ARCHS = ("deepseek-v3-671b", "qwen3-moe-30b-a3b")
#: f32 on both sides, the same expressions in other summation orders
TOL = dict(rtol=1e-5, atol=1e-6)
#: gradients through the softmaxes, norms and the residual stream: the
#: reorderings grow to ~1e-6 of the largest entry
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _f32(name):
    return dataclasses.replace(jreg.get_config(name).reduced(),
                               param_dtype="float32")


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _t(tree, requires_grad=False):
    out = convert.model_params_from_numpy(jax.tree.map(np.asarray, tree),
                                          device="cpu")
    if requires_grad:
        for leaf in tree_leaves(out):
            leaf.requires_grad_()
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX model and parameters (module-wide)."""
    out = {}
    for name in ARCHS:
        jm = jreg.build_model(_f32(name))
        out[name] = (jm, jax.jit(jm.init)(KEY))
    return out


# ---------------------------------------------------------------------------
# the dispatch and moe_apply
# ---------------------------------------------------------------------------

def _moe_layer(models, name):
    """The first MoE layer's ``mlp`` params (JAX) of ``name``."""
    _, pj = models[name]
    return jax.tree.map(lambda l: l[0], pj["moe_layers"]["mlp"])


def _skewed(pj_mlp, x):
    """Router and inputs that send most tokens' top pick to expert 0: a
    shared direction in x, aligned with router column 0."""
    d = x.shape[-1]
    u = (np.ones(d) / np.sqrt(d)).astype(np.float32)
    w = np.array(pj_mlp["router"]["w"])
    w[:, 0] += 4.0 * u
    return dict(pj_mlp, router={"w": jnp.asarray(w)}), x + 2.0 * u


def _jax_picks(pj_mlp, x, K):
    logits = jnp.einsum("nd,de->ne", jnp.asarray(x.reshape(-1, x.shape[-1])),
                        pj_mlp["router"]["w"])
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), K)[1])


@pytest.mark.parametrize("case", ["plain", "drops", "grouped"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_and_dispatch_match_jax(models, monkeypatch, name, case):
    """``moe_apply`` (the shared expert for deepseek-v3) on (2, 32) tokens:
    its output, aux loss, the experts picked (every pick equal) and the
    gradients of every leaf and of x.  ``drops`` skews the router so that
    the capacity (40 a expert) drops pairs; ``grouped`` runs
    ``grouped_moe`` (16 groups of 4 tokens, capacity 8)."""
    jm, _ = models[name]
    cfg = jm.cfg
    pj = _moe_layer(models, name)
    x = _x((2, 32, cfg.d_model))
    if case == "drops":
        pj, x = _skewed(pj, x)
    if case == "grouped":
        monkeypatch.setenv("REPRO_OPT", "grouped_moe")
    cot = _x((2, 32, cfg.d_model), 7)

    def f(p, xx):
        out, aux = jmoe.moe_apply(p, xx, cfg)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (want, want_aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(pj, jnp.asarray(x))
    p = _t(pj, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    with moe.record_routing() as seen:
        out, aux = moe.moe_apply(p, xt, _port_cfg(cfg))
    _close(out, want)
    _close(aux, want_aux)
    picks = seen[0]["idx"].reshape(-1, cfg.n_experts_active).numpy()
    assert int((picks != _jax_picks(pj, x, cfg.n_experts_active)).sum()) == 0
    dropped = int((~seen[0]["kept"]).sum())
    if case == "drops":
        assert dropped > 8, dropped
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    for got, w in zip(tree_leaves(p), jax.tree_util.tree_leaves(gp)):
        _close(got.grad, w, GRAD_TOL)
    _close(xt.grad, gx, GRAD_TOL)


def test_moe_apply_routes_each_worker_alone(models):
    """With leaves led by W = 2 workers the routing, the capacity and the
    aux loss are per worker: each equals its single-worker call, bit for
    bit in the picks."""
    cfg = _port_cfg(models["qwen3-moe-30b-a3b"][0].cfg)
    pj, x = _skewed(_moe_layer(models, "qwen3-moe-30b-a3b"),
                    _x((2, 32, cfg.d_model)))
    p1 = _t(pj)
    p2 = tree_map(lambda l: l * 0.9, p1)
    pw = tree_map(lambda a, b: torch.stack([a, b]), p1, p2)
    xs = torch.from_numpy(np.stack([x, x[:, ::-1].copy()]))
    with moe.record_routing() as seen:
        both, aux = moe.moe_apply(pw, xs, cfg)
        ones = [moe.moe_apply(p, xs[w], cfg) for w, p in enumerate((p1, p2))]
    assert tuple(aux.shape) == (2,)
    for w, (one, one_aux) in enumerate(ones):
        torch.testing.assert_close(both[w], one, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(aux[w], one_aux, rtol=1e-6, atol=1e-7)
        assert torch.equal(seen[0]["idx"][w], seen[1 + w]["idx"])
        assert torch.equal(seen[0]["kept"][w], seen[1 + w]["kept"][0])


class _Ops(TorchDispatchMode):
    """The aten ops a block of code runs (and their keyword arguments)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func, args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def test_dispatch_sorts_stably_and_never_accumulates(models):
    """Forward and backward of a dropping dispatch: the sort is the stable
    one, and no op adds into a tensor by index (no ``index_add``,
    ``scatter_add`` or accumulating ``index_put``), the ops whose float
    atomics run in no fixed order on the card."""
    cfg = _port_cfg(models["qwen3-moe-30b-a3b"][0].cfg)
    pj, x = _skewed(_moe_layer(models, "qwen3-moe-30b-a3b"),
                    _x((2, 32, cfg.d_model)))
    p = _t(pj, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    with _Ops() as mode:
        out, aux = moe.moe_apply(p, xt, cfg)
        (out.sum() + aux).backward()
    names = [str(f) for f, _, _ in mode.ops]
    sorts = [(a, k) for f, a, k in mode.ops if "aten.sort" in str(f)]
    assert sorts and any(k.get("stable") or (len(a) > 1 and a[1] is True)
                         for a, k in sorts), sorts
    assert not [n for n in names if "index_add" in n or "scatter_add" in n
                or "scatter_reduce" in n]
    accumulating = [a for f, a, k in mode.ops if "index_put" in str(f)
                    and (k.get("accumulate") or (len(a) > 3 and a[3]))]
    assert not accumulating


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "no_q_lora"])
def test_mla_fwd_matches_jax(models, q_lora):
    """MLA's forward (the absorbed scores, f32 products), its compressed
    cache and the gradients of every leaf and of x, with the low-rank q
    and with the plain one."""
    cfg = models["deepseek-v3-671b"][0].cfg
    if not q_lora:
        cfg = dataclasses.replace(cfg, q_lora_rank=0)
    pj = jmoe.mla_init(jax.random.PRNGKey(3), cfg)
    x = _x((2, 16, cfg.d_model))
    cot = _x((2, 16, cfg.d_model), 8)
    pos = jnp.broadcast_to(jnp.arange(16), (2, 16))

    def f(p, xx):
        out, cache = jmoe.mla_fwd(p, xx, cfg, pos, None)
        return jnp.sum(out * cot), (out, cache)

    (_, (want, wcache)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(pj, jnp.asarray(x))
    p = _t(pj, requires_grad=True)
    assert ("wq_a" in p) == q_lora
    xt = torch.from_numpy(x).requires_grad_()
    out, cache = moe.mla_fwd(p, xt, _port_cfg(cfg), torch.arange(16), None)
    _close(out, want)
    _close(cache["c_kv"], wcache["c_kv"])
    _close(cache["k_rope"], wcache["k_rope"])
    (out * torch.from_numpy(cot)).sum().backward()
    for got, w in zip(tree_leaves(p), jax.tree_util.tree_leaves(gp)):
        _close(got.grad, w, GRAD_TOL)
    _close(xt.grad, gx, GRAD_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _tokens(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_lm_forward_loss_and_grads_match_jax(models, name):
    """The logits, the aux loss summed over the MoE layers and the MTP
    logits (deepseek-v3), then the loss ``xent + 0.1·mtp + aux``, its
    metrics and every gradient leaf."""
    jm, pj = models[name]
    cfg = jm.cfg
    tokens = _tokens(cfg, (2, 16))
    logits, aux, mtp = jax.jit(lambda p_, t_: jmoe.lm_forward(
        p_, cfg, t_, return_mtp=cfg.mtp))(pj, jnp.asarray(tokens))
    (loss, jmet), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        pj, {"tokens": jnp.asarray(tokens)})
    m = reg.build_model(_port_cfg(cfg))
    p = _t(pj, requires_grad=True)
    tt = torch.from_numpy(tokens)
    got, got_aux, got_mtp = moe.lm_forward(p, m.cfg, tt, return_mtp=cfg.mtp)
    _close(got, logits, dict(rtol=1e-5, atol=1e-5))
    _close(got_aux, aux)
    assert (got_mtp is None) == (mtp is None)
    if mtp is not None:
        _close(got_mtp, mtp, dict(rtol=1e-5, atol=1e-5))
    l, met = m.loss(p, {"tokens": tt})
    _close(l, loss)
    assert sorted(met) == sorted(jmet)
    for k in met:
        _close(met[k], jmet[k])
    l.backward()
    for g, w in zip(tree_leaves(p), jax.tree_util.tree_leaves(grads)):
        _close(g.grad, w, GRAD_TOL)


def test_worker_led_tree_gives_each_workers_loss(models):
    """Deepseek-v3 with leaves led by W = 2 workers: each worker's loss and
    loss terms equal its single-worker call (the MTP roll along each
    worker's sequence, the capacity per worker)."""
    jm, pj = models["deepseek-v3-671b"]
    m = reg.build_model(_port_cfg(jm.cfg))
    p = _t(pj)
    pw = tree_map(lambda l: torch.stack([l, l * 0.9]), p)
    tok = torch.from_numpy(_tokens(jm.cfg, (2, 16)))
    losses, met = m.loss(pw, {"tokens": torch.stack([tok, tok.flip(-1)])})
    assert tuple(losses.shape) == (2,) and tuple(met["mtp"].shape) == (2,)
    for w, (pp, tt) in enumerate(((p, tok), (tree_map(
            lambda l: l * 0.9, p), tok.flip(-1)))):
        one, one_met = m.loss(pp, {"tokens": tt})
        torch.testing.assert_close(losses[w], one, rtol=1e-6, atol=1e-6)
        for k in ("xent", "aux", "mtp"):
            torch.testing.assert_close(met[k][w], one_met[k], rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_jax_token_by_token(models, name):
    """8 tokens through JAX's jitted decode step and the port's: every
    step's logits, and every cache leaf at the end (MLA's compressed c_kv
    and k_rope of the dense and the MoE layers; GQA's K and V), written in
    place; no kernel launched."""
    jm, pj = models[name]
    cfg = jm.cfg
    m = reg.build_model(_port_cfg(cfg))
    p = _t(pj)
    toks = _tokens(cfg, (2, 8), 5)
    cj = jm.init_cache(2, 8)
    c = m.init_cache(2, 8, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(c)] == [
        x.shape for x in jax.tree_util.tree_leaves(cj)]
    step = jax.jit(jm.decode_step)
    build.reset_launches()
    for t in range(8):
        lj, cj = step(pj, cj, jnp.asarray(toks[:, t]), jnp.int32(t))
        lt, c2 = m.decode_step(p, c, torch.from_numpy(toks[:, t]), t)
        assert c2 is c
        _close(lt, lj, dict(rtol=1e-5, atol=1e-5))
    assert not build.launches
    for got, want in zip(tree_leaves(c), jax.tree_util.tree_leaves(cj)):
        _close(got, want, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_equals_own_forward(name):
    """At ≤ 8 tokens no (token, k) pair is dropped (an expert meets at most
    one pair a token, and the capacity is at least 8), so the decode steps'
    logits equal the teacher-forced forward's, argmax for argmax."""
    cfg = dataclasses.replace(reg.get_config(name).reduced(),
                              param_dtype="float32")
    m = reg.build_model(cfg)
    p = m.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 8), 6))
    fwd, _ = m.forward(p, {"tokens": toks}, remat=False)
    cache = m.init_cache(1, 8, device="cpu")
    for t in range(8):
        logits, cache = m.decode_step(p, cache, toks[:, t], t)
        assert float((logits - fwd[:, t]).abs().max()) < 1e-4 * float(
            fwd.abs().max())
        assert torch.equal(logits.argmax(-1), fwd[:, t].argmax(-1))
