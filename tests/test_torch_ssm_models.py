"""The port's SSM (mamba1, falcon-mamba-7b) and hybrid (Griffin,
recurrentgemma-2b) models against the JAX package's: the blocks
(``_conv1d_causal``, ``_ssm_inputs``, ``ssm.block_fwd``, ``_rglru_coeffs``,
``hybrid.rec_block_fwd``), both ``lm_forward``s, the loss and its grads at
the reduced configs in f32, from JAX's own parameters carried across by
``convert``, on the same numpy inputs; and the hybrid's list-valued
``tail`` in JAX's leaf order.

The JAX side runs its default scan, the associative-scan oracle; the
port's runs B12's plain version (a sequential loop) on the CPU, so these
tests also hold B12's wiring against the reference recurrence."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.packing import build_packspec as jbuild_packspec  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.packing import build_packspec  # noqa: E402
from repro_torch.models import hybrid, ssm  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_llm_models import KEY, _close, _np, _t  # noqa: E402
#: f32 blocks: the same expressions; the scan's products of gates are
#: grouped otherwise (sequential loop against JAX's associative scan)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
#: logits and loss through the layers, f32
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
#: f32 grads through the scans, norms, softmax and the residual stream
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
#: the hybrid's sequence runs past its reduced 64-token attention window
SEQ = {"falcon-mamba-7b": 24, "recurrentgemma-2b": 72}



def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jcfg(name, **kw):
    return dataclasses.replace(jreg.get_config(name).reduced(),
                               param_dtype="float32", **kw)


def _tcfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_conv1d_causal_matches():
    x, w, b = _x((2, 10, 12)), _x((4, 12), 2), _x((12,), 3)
    _close(ssm._conv1d_causal(torch.from_numpy(w), torch.from_numpy(b),
                              torch.from_numpy(x)),
           jssm._conv1d_causal(w, b, x), BLOCK_TOL)
    _close(ssm._conv1d_causal(torch.from_numpy(w), torch.from_numpy(b),
                              torch.from_numpy(x)),
           jhybrid._conv1d_causal(w, b, x), BLOCK_TOL)


@pytest.fixture(scope="module")
def ssm_block():
    jcfg = _jcfg("falcon-mamba-7b")
    p = jssm.block_init(KEY, jcfg)
    # a non-trivial conv bias and norms, so each parameter matters
    p = dict(p, conv_b=jnp.asarray(_x((jcfg.d_inner,), 4, 0.1)),
             b_norm={"scale": jnp.asarray(1.0 + _x((jcfg.ssm_state,), 5,
                                                    0.1))})
    return jcfg, p


def test_ssm_inputs_match(ssm_block):
    jcfg, p = ssm_block
    x = _x((2, 10, jcfg.d_inner), 6)
    got = ssm._ssm_inputs(_t(p), torch.from_numpy(x), _tcfg(jcfg))
    for g, w in zip(got, jssm._ssm_inputs(p, x, jcfg)):
        assert g.dtype == torch.float32
        _close(g, w, BLOCK_TOL)


def test_ssm_block_fwd_matches(ssm_block):
    jcfg, p = ssm_block
    u = _x((2, 20, jcfg.d_model), 7)
    _close(ssm.block_fwd(_t(p), torch.from_numpy(u), _tcfg(jcfg)),
           jssm.block_fwd(p, u, jcfg), BLOCK_TOL)


@pytest.fixture(scope="module")
def rec_block():
    jcfg = _jcfg("recurrentgemma-2b")
    return jcfg, jhybrid.rec_block_init(KEY, jcfg)


def test_rglru_coeffs_match(rec_block):
    jcfg, p = rec_block
    x = _x((2, 10, jcfg.lru_width), 8)
    got = hybrid._rglru_coeffs(_t(p), torch.from_numpy(x))
    for g, w in zip(got, jhybrid._rglru_coeffs(p, x)):
        _close(g, w, BLOCK_TOL)
    # the 1e-12 clamp under the square root: a gate of exactly 1
    one = {**_t(p), "lam": torch.full((jcfg.lru_width,), -200.0)}
    a, b = hybrid._rglru_coeffs(one, torch.from_numpy(x))
    assert torch.equal(a, torch.ones_like(a))
    torch.testing.assert_close(b, 1e-6 * torch.sigmoid(
        torch.from_numpy(x) @ one["gate_x"]["w"] + one["gate_x"]["b"])
        * torch.from_numpy(x), rtol=1e-5, atol=0)


def test_rec_block_fwd_matches(rec_block):
    jcfg, p = rec_block
    u = _x((2, 20, jcfg.d_model), 9)
    _close(hybrid.rec_block_fwd(_t(p), torch.from_numpy(u), _tcfg(jcfg)),
           jhybrid.rec_block_fwd(p, u, jcfg), BLOCK_TOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model_case(request):
    """A reduced model in f32: JAX's params, logits, loss and grads."""
    name = request.param
    jcfg = _jcfg(name)
    jm = jreg.build_model(jcfg)
    params = jm.init(KEY)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               (2, SEQ[name]), dtype=np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, _ = jm.forward(params, batch)
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params,
                                                                  batch)
    return dict(name=name, cfg=jcfg, params=params, tokens=tokens,
                logits=logits, loss=loss, grads=grads)


def test_lm_forward_loss_and_grads_match(model_case):
    c = model_case
    tm = reg.build_model(_tcfg(c["cfg"]))
    p = _t(c["params"], requires_grad=True)
    batch = {"tokens": torch.from_numpy(c["tokens"])}
    logits, aux = tm.forward(p, batch)
    assert float(aux) == 0.0
    _close(logits, c["logits"], FWD_TOL)
    loss, metrics = tm.loss(p, batch)
    _close(loss, c["loss"], FWD_TOL)
    assert metrics["xent"] is loss
    loss.backward()
    got, want = tree_leaves(p), jax.tree_util.tree_leaves(c["grads"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.grad, w, GRAD_TOL)


def test_remat_on_and_off_give_equal_bits(model_case):
    c = model_case
    tm = reg.build_model(_tcfg(c["cfg"]))
    batch = {"tokens": torch.from_numpy(c["tokens"])}
    out = []
    for remat in (True, False):
        p = _t(c["params"], requires_grad=True)
        loss, _ = tm.loss(p, batch, remat=remat)
        loss.backward()
        out.append((loss.detach(), [l.grad for l in tree_leaves(p)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_worker_led_params_give_one_loss_per_worker(model_case):
    c = model_case
    tm = reg.build_model(_tcfg(c["cfg"]))
    p = _t(c["params"])
    pw = tree_map(lambda l: torch.stack([l, l * 0.9]), p)
    tok = torch.from_numpy(c["tokens"])
    losses, _ = tm.loss(pw, {"tokens": torch.stack([tok, tok.flip(1)])})
    assert losses.shape == (2,)
    l0, _ = tm.loss(p, {"tokens": tok})
    torch.testing.assert_close(losses[0], l0, rtol=1e-6, atol=1e-6)


def test_f32_leaves_stay_f32_in_a_bf16_tree():
    """``A_log``, ``D`` and ``lam`` are f32 leaves of the bf16 models, as in
    JAX; the packed dtypes record both."""
    for name, f32_keys in (("falcon-mamba-7b", ("A_log", "D")),
                           ("recurrentgemma-2b", ("lam",))):
        m = reg.get_model(name, reduced=True)
        p = m.init(0, device="cpu")
        jp = jreg.get_model(name, reduced=True).init(KEY)
        spec = build_packspec(p)
        assert [str(t).replace("torch.", "") for t in spec.dtypes] == [
            l.dtype.name for l in jax.tree_util.tree_leaves(jp)]
        assert spec.d == jbuild_packspec(jp).d
        leaves = p["layers"] if name == "falcon-mamba-7b" else \
            p["super"]["b0"]["temporal"]
        for k in f32_keys:
            assert leaves[k].dtype == torch.float32


@pytest.mark.parametrize("n_layers", [3, 5], ids=["no-tail", "tail-of-2"])
def test_hybrid_tree_packs_in_jax_leaf_order(n_layers):
    """The hybrid's ``tail`` is a list (empty at the reduced 3 layers, two
    layers at 5): flattened by index, as ``jax.tree_util`` does, so every
    packed offset, shape and dtype equals JAX's, worker-led too."""
    jcfg = dataclasses.replace(jreg.get_config("recurrentgemma-2b").reduced(),
                               n_layers=n_layers)
    jp = jreg.build_model(jcfg).init(KEY)
    p = model_params_from_numpy(_np(jp), device="cpu")
    assert isinstance(p["tail"], list) and len(p["tail"]) == n_layers - 3
    want = jbuild_packspec(jp)
    got = build_packspec(p)
    assert got.offsets == want.offsets and got.shapes == want.shapes
    assert got.d == want.d
    assert [str(t).replace("torch.", "") for t in got.dtypes] == [
        np.dtype(t).name for t in want.dtypes]
    for g, w in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
        assert torch.equal(g.float(), torch.from_numpy(
            np.array(w, np.float32)))
    pw = tree_map(lambda l: torch.stack([l, l]), p)
    jw = jax.tree.map(lambda l: jnp.stack([l, l]), jp)
    assert build_packspec(pw, batch_dims=1).offsets == jbuild_packspec(
        jw, batch_dims=1).offsets
    # the port's own init has the same structure
    own = reg.build_model(_tcfg(jcfg)).init(0, device="cpu")
    assert build_packspec(own).offsets == want.offsets
    assert reg.build_model(_tcfg(jcfg)).cfg.param_count() == \
        jcfg.param_count()


def test_hybrid_with_a_tail_matches():
    """Five layers: one checkpointed super-block, then the two tail layers
    (rec, rec) unrolled; logits against JAX's."""
    jcfg = _jcfg("recurrentgemma-2b", n_layers=5)
    jm = jreg.build_model(jcfg)
    params = jm.init(KEY)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 20),
                                               dtype=np.int32)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    got, _ = reg.build_model(_tcfg(jcfg)).forward(
        _t(params), {"tokens": torch.from_numpy(tokens)})
    _close(got, want, FWD_TOL)


def test_embedding_scale_rounds_to_the_param_dtype():
    """The gemma scale is cast to the param dtype before the multiply:
    bf16 √2560 is 50.5, not 50.596."""
    cfg = reg.get_config("recurrentgemma-2b")
    assert float(torch.tensor(cfg.d_model ** 0.5,
                              dtype=cfg.dtype)) == 50.5
    m = reg.get_model("recurrentgemma-2b", reduced=True)
    p = m.init(0, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with torch.no_grad():
        x = p["embed"]["table"][tok] * torch.tensor(
            m.cfg.d_model ** 0.5, dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16
    jm = jreg.get_model("recurrentgemma-2b", reduced=True)
    jscale = jnp.asarray(jm.cfg.d_model ** 0.5, jm.cfg.dtype)
    assert float(jscale) == float(torch.tensor(m.cfg.d_model ** 0.5,
                                               dtype=torch.bfloat16))


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_loss_matches_within_bf16_rounding(name):
    """Reduced model in its own bf16: activations round at other places in
    the two frameworks, so the loss is held to 2e-2 relative."""
    jm = jreg.get_model(name, reduced=True)
    params = jm.init(KEY)
    tokens = np.random.default_rng(4).integers(0, jm.cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    want, _ = jm.loss(params, {"tokens": jnp.asarray(tokens)})
    got, _ = reg.get_model(name, reduced=True).loss(
        _t(params), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


def test_decode_is_refused_by_name():
    """Decode runs for both families now (``tests/test_torch_decode.py``
    holds it against JAX's), and for the moe family, once refused."""
    for name in ARCHS:
        m = reg.get_model(name, reduced=True)
        p = m.init(0, device="cpu")
        cache = m.init_cache(1, 8, device="cpu")
        logits, cache2 = m.decode_step(p, cache, torch.zeros(
            1, dtype=torch.long), 0)
        assert tuple(logits.shape) == (1, m.cfg.vocab_size)
        assert cache2 is cache
    # the moe family, refused here once, is built and decodes too
    m = reg.get_model("qwen3-moe-30b-a3b", reduced=True)
    logits, _ = m.decode_step(m.init(0, device="cpu"),
                              m.init_cache(1, 8, device="cpu"),
                              torch.zeros(1, dtype=torch.long), 0)
    assert tuple(logits.shape) == (1, m.cfg.vocab_size)
