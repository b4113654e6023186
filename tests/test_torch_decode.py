"""The port's decode API (``Model.init_cache``/``decode_step``) against the
JAX package's on the reduced granite-8b (dense), falcon-mamba-7b (SSM) and
recurrentgemma-2b (hybrid) in f32, from JAX's parameters: every step's
logits and every cache leaf, token by token; across the rotating window's
wrap (``tests/test_sliding_window_decode.py``'s setting).  Port against
port: decode equals the port's own teacher-forced forward
(``tests/test_models_smoke.py``'s check).  The families the port does not
build still refuse by name."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_replay import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(3)
ARCHS = ("granite-8b", "falcon-mamba-7b", "recurrentgemma-2b")
#: f32 on both sides, one token at a time through every layer
TOL = dict(rtol=1e-4, atol=1e-5)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32")


def _pair(jcfg):
    """JAX's model and parameters, and the port's model on the same
    parameters (CPU)."""
    jm = jreg.build_model(jcfg)
    pj = jm.init(KEY)
    m = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    p = convert.model_params_from_numpy(jax.tree.map(np.asarray, pj),
                                        device="cpu")
    return jm, pj, m, p


def _tokens(cfg, B, n):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (B, n),
                                             dtype=np.int32)


def _decode_both(jcfg, B, n, max_seq):
    """Decode ``n`` tokens with JAX and the port from the same parameters:
    the logits of every step and the final caches."""
    jm, pj, m, p = _pair(jcfg)
    toks = _tokens(jcfg, B, n)
    cj = jm.init_cache(B, max_seq)
    c = m.init_cache(B, max_seq, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(c)] == [
        x.shape for x in jax.tree_util.tree_leaves(cj)]
    assert [x.dtype for x in tree_leaves(c)] == [
        getattr(torch, str(x.dtype)) for x in jax.tree_util.tree_leaves(cj)]
    step = jax.jit(jm.decode_step)
    lj, lt = [], []
    build.reset_launches()
    for t in range(n):
        l, cj = step(pj, cj, jnp.asarray(toks[:, t]), jnp.int32(t))
        lj.append(np.asarray(l))
        l2, c2 = m.decode_step(p, c, torch.from_numpy(toks[:, t]), t)
        assert c2 is c                     # the cache is updated in place
        lt.append(l2.numpy())
    assert not build.launches              # decode launches no kernel
    return dict(lj=np.stack(lj), lt=np.stack(lt), cj=cj, c=c, m=m, p=p,
                toks=toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_token_by_token(arch):
    out = _decode_both(_f32(jreg.get_config(arch).reduced()), 2, 8, 8)
    np.testing.assert_allclose(out["lt"], out["lj"], **TOL)
    for got, want in zip(tree_leaves(out["c"]),
                         jax.tree_util.tree_leaves(out["cj"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _windowed(arch):
    cfg = _f32(jreg.get_config(arch).reduced())
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, attn_window=16), 16
    return dataclasses.replace(cfg, sliding_window=16), 16


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-2b"])
def test_decode_across_the_window_wrap(arch):
    """3 × window tokens through a rotating buffer of ``window`` slots:
    JAX's logits and caches at every step, and the port's own windowed
    forward's argmax at every position past the wrap."""
    cfg, window = _windowed(arch)
    n = 3 * window
    out = _decode_both(cfg, 1, n, n)
    assert out["c"]["k" if cfg.family == "dense" else "super"] is not None
    np.testing.assert_allclose(out["lt"], out["lj"], **TOL)
    for got, want in zip(tree_leaves(out["c"]),
                         jax.tree_util.tree_leaves(out["cj"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fwd, _ = out["m"].forward(out["p"], {"tokens": torch.from_numpy(
        out["toks"])}, remat=False)
    fwd = fwd[0].numpy()
    dec = out["lt"][:, 0]
    assert np.abs(dec - fwd).max() < 1e-4 * np.abs(fwd).max()
    assert (dec.argmax(-1) == fwd.argmax(-1))[window:].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_own_forward(arch):
    """Token-by-token decode logits against the port's teacher-forced
    forward on the same parameters (f32)."""
    cfg = reg.get_config(arch).reduced()
    m = reg.build_model(dataclasses.replace(cfg, param_dtype="float32"))
    p = m.init(0, device="cpu")
    n = 8
    toks = torch.from_numpy(_tokens(cfg, 1, n))
    fwd, _ = m.forward(p, {"tokens": toks}, remat=False)
    cache = m.init_cache(1, n, device="cpu")
    errs = []
    for t in range(n):
        logits, cache = m.decode_step(p, cache, toks[:, t], t)
        errs.append(float((logits - fwd[:, t]).abs().max()))
        assert torch.equal(logits.argmax(-1), fwd[:, t].argmax(-1))
    assert max(errs) < 1e-4 * float(fwd.abs().max()), errs


def test_bf16_cache_dtypes():
    """The caches keep the reference's dtypes: K/V and conv windows in the
    param dtype, the SSM and RG-LRU states in f32."""
    for arch in ARCHS:
        m = reg.get_model(arch, reduced=True)
        c = m.init_cache(2, 8, device="cpu")
        jc = jreg.get_model(arch, reduced=True).init_cache(2, 8)
        assert [x.dtype for x in tree_leaves(c)] == [
            getattr(torch, str(x.dtype)) for x in
            jax.tree_util.tree_leaves(jc)]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b",
                                  "seamless-m4t-medium", "pixtral-12b"])
def test_unbuilt_families_refuse_by_name(arch):
    with pytest.raises(NotImplementedError, match="item 5"):
        reg.get_model(arch, reduced=True).init(0, device="cpu")
