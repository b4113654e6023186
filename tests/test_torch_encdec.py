"""The port's audio enc-dec family (``repro_torch.models.encdec``) and the
vlm arch's vision frontend (``models/transformer.py``) against the JAX
package's, on reduced seamless-m4t-medium and pixtral-12b in f32 from
JAX's parameters: ``encode``, ``decode_forward`` (its self-attention B11's
plain version on the CPU), ``prefill_cross``, the loss and every gradient
leaf; decode token by token on the logits and every cache leaf, from the
zero cross cache ``generate`` starts from and from ``prefill_cross``'s;
pixtral's forward and loss over stub patches, and its gradients.  Port
against port: decode against the forward with the prefilled cross cache,
and the stacked init filled in place gives ``tree_stack``'s tensors."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402

from repro_torch import convert, rng  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_stack  # noqa: E402

from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(1)
TOL = dict(rtol=1e-5, atol=1e-6)
#: logits, and K/V caches, after every layer: f32 reorderings of ~1e-6 of
#: their scale
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
#: gradients through the softmaxes, layernorms and the residual stream
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _f32(name):
    return dataclasses.replace(jreg.get_config(name).reduced(),
                               param_dtype="float32")


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


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def seamless():
    jcfg = _f32("seamless-m4t-medium")
    jm = jreg.build_model(jcfg)
    pj = jax.jit(jm.init)(KEY)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    frames = _normal((2, jcfg.frontend_tokens, jcfg.d_model), 3)
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    memory = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(
        pj, jnp.asarray(frames))
    logits = jax.jit(lambda p, t, m: jencdec.decode_forward(p, jcfg, t, m))(
        pj, jnp.asarray(tokens), memory)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        pj, batch)
    return dict(jm=jm, pj=pj, tokens=tokens, frames=frames, memory=memory,
                logits=logits, loss=loss, grads=grads,
                m=reg.build_model(ModelConfig(**dataclasses.asdict(jcfg))))


def test_encode_decode_forward_and_loss_match_jax(seamless):
    """The encoder memory (bidirectional, RoPE, no kernel), the
    teacher-forced decoder's logits (cross K/V recomputed in each layer),
    the loss and every gradient leaf."""
    c = seamless
    m, cfg = c["m"], c["m"].cfg
    p = _t(c["pj"], requires_grad=True)
    memory = encdec.encode(p, cfg, torch.from_numpy(c["frames"]))
    _close(memory, c["memory"])
    logits = encdec.decode_forward(p, cfg, torch.from_numpy(c["tokens"]),
                                   memory)
    _close(logits, c["logits"], LOGIT_TOL)
    batch = {"tokens": torch.from_numpy(c["tokens"]),
             "frames": torch.from_numpy(c["frames"])}
    loss, metrics = m.loss(p, batch)
    _close(loss, c["loss"])
    assert sorted(metrics) == ["xent"]
    loss.backward()
    for g, w in zip(tree_leaves(p), jax.tree_util.tree_leaves(c["grads"])):
        _close(g.grad, w, GRAD_TOL)


def test_prefill_cross_matches_jax(seamless):
    c = seamless
    p = _t(c["pj"])
    ks, vs = encdec.prefill_cross(p, c["m"].cfg,
                                  torch.from_numpy(np.array(c["memory"])))
    jk, jv = jencdec.prefill_cross(c["pj"], c["jm"].cfg, c["memory"])
    assert tuple(ks.shape) == jk.shape
    _close(ks, jk)
    _close(vs, jv)


@pytest.mark.parametrize("prefilled", [False, True],
                         ids=["zero_cross", "prefill_cross"])
def test_decode_matches_jax_token_by_token(seamless, prefilled):
    """8 tokens through JAX's jitted decode step and the port's: the
    logits of every step and every cache leaf at the end, from the zero
    cross cache (``generate``'s start) or the one ``prefill_cross`` makes;
    the self K/V written in place, the cross K/V left as they were."""
    c = seamless
    jm, m = c["jm"], c["m"]
    p = _t(c["pj"])
    cj = jm.init_cache(2, 8)
    cache = m.init_cache(2, 8, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(cache)] == [
        x.shape for x in jax.tree_util.tree_leaves(cj)]
    if prefilled:
        jk, jv = jencdec.prefill_cross(c["pj"], jm.cfg, c["memory"])
        cj = dict(cj, cross_k=jk, cross_v=jv)
        cache["cross_k"], cache["cross_v"] = encdec.prefill_cross(
            p, m.cfg, torch.from_numpy(np.array(c["memory"])))
    cross = cache["cross_k"].clone()
    step = jax.jit(jm.decode_step)
    toks = c["tokens"]
    for t in range(8):
        lj, cj = step(c["pj"], cj, jnp.asarray(toks[:, t]), jnp.int32(t))
        lt, c2 = m.decode_step(p, cache, torch.from_numpy(toks[:, t]), t)
        assert c2 is cache
        _close(lt, lj, LOGIT_TOL)
    for got, want in zip(tree_leaves(cache), jax.tree_util.tree_leaves(cj)):
        _close(got, want, LOGIT_TOL)
    assert torch.equal(cache["cross_k"], cross)


def test_decode_with_prefilled_cross_equals_own_forward():
    """Port against port (``tests/test_models_smoke.py``'s check): decode
    from ``prefill_cross``'s cache gives the teacher-forced forward's
    logits, argmax for argmax."""
    cfg = dataclasses.replace(reg.get_config("seamless-m4t-medium").reduced(),
                              param_dtype="float32")
    m = reg.build_model(cfg)
    p = m.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 8),
                         generator=torch.Generator().manual_seed(3))
    frames = torch.from_numpy(_normal((1, cfg.frontend_tokens, cfg.d_model),
                                      4))
    fwd, _ = m.forward(p, {"tokens": toks, "frames": frames}, remat=False)
    cache = m.init_cache(1, 8, device="cpu")
    memory = encdec.encode(p, cfg, frames, remat=False)
    cache["cross_k"], cache["cross_v"] = encdec.prefill_cross(p, cfg, memory)
    for t in range(8):
        logits, cache = m.decode_step(p, cache, toks[:, t], t)
        assert float((logits - fwd[:, t]).abs().max()) < 1e-4 * float(
            fwd.abs().max())
        assert torch.equal(logits.argmax(-1), fwd[:, t].argmax(-1))


def test_pixtral_forward_loss_and_grads_match_jax():
    """The vision frontend: the stub patches projected and put in front of
    the token embeddings (positions over all P + S), the logits over the
    whole sequence, the loss over the text positions only, and every
    gradient leaf (the projector's too)."""
    jcfg = _f32("pixtral-12b")
    jm = jreg.build_model(jcfg)
    pj = jax.jit(jm.init)(KEY)
    assert "projector" in pj
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    patches = _normal((2, jcfg.frontend_tokens, jcfg.frontend_dim), 6)
    batch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    want = jax.jit(lambda p, t, f: jtransformer.lm_forward(
        p, jcfg, t, frontend_embeds=f))(pj, batch["tokens"],
                                        batch["patches"])
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        pj, batch)
    m = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    p = _t(pj, requires_grad=True)
    tb = {"tokens": torch.from_numpy(tokens),
          "patches": torch.from_numpy(patches)}
    logits, _ = m.forward(p, tb)
    assert tuple(logits.shape) == (2, jcfg.frontend_tokens + 16,
                                   jcfg.vocab_size)
    _close(logits, want, LOGIT_TOL)
    l, _ = m.loss(p, tb)
    _close(l, loss)
    l.backward()
    for g, w in zip(tree_leaves(p), jax.tree_util.tree_leaves(grads)):
        _close(g.grad, w, GRAD_TOL)


def test_stacked_init_fills_in_place_with_tree_stacks_tensors():
    """Reduced granite-8b's init fills its stacked leaves a layer at a
    time: the tensors equal the per-layer inits stacked by
    ``tree_stack``, as before the repair, bit for bit."""
    cfg = reg.get_config("granite-8b").reduced()
    p = transformer.init_params(7, cfg, device="cpu")
    _, kl, _ = rng.split(7, 3)
    want = tree_stack([transformer.init_block(rng.fold_in(kl, i), cfg, "cpu")
                       for i in range(cfg.n_layers)])
    got = tree_leaves(p["layers"])
    assert len(got) == len(tree_leaves(want))
    for a, b in zip(got, tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
