"""``REPRO_OPT=chunked_scan`` in the port against the JAX package: the SSM's
fused chunk loop (``models/ssm._scan_chunked_fused``) forward and
gradients, the chunked path against the port's own unchunked one,
``ssm.block_fwd`` and a reduced falcon-mamba-7b's loss and gradients under
the flag, and the scan shim ``gated_linear_scan`` under the flag (the port
runs B12 whole; JAX's chunked ``lax.scan``).  B = 2, S = 80 in chunks of 32,
so the last chunk is ragged; d_inner 8, state 4.

The port's chunks run B12's plain version on the CPU (a sequential loop);
JAX's run its associative-scan oracle, so the tolerance is ROADMAP queue
C's for the sequential scan against the associative one."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optflags as joptflags  # noqa: E402
from repro.kernels import _chunked_linear_scan  # noqa: E402
from repro.kernels import gated_linear_scan as jgated  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch import optflags  # noqa: E402
from repro_torch.kernels.linear_scan import gated_linear_scan  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_llm_models import KEY, _close, _t  # noqa: E402

#: sequential against associative products of gates (ROADMAP queue C)
TOL = dict(rtol=2e-4, atol=2e-5)
#: through the whole model's norms, softmax and residual stream, as
#: tests/test_torch_ssm_models.py holds the unchunked model
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
B, S, CHUNK, DI, N = 2, 80, 32, 8, 4


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _scan_inputs():
    """(dt, B, C, A, x) as ``_ssm_inputs`` gives them: dt > 0, A < 0."""
    dt = np.log1p(np.exp(_x((B, S, DI), 1) - 1.0)).astype(np.float32)
    A = -np.exp(_x((DI, N), 2, 0.5)).astype(np.float32)
    return dt, _x((B, S, N), 3), _x((B, S, N), 4), A, _x((B, S, DI), 5)


@pytest.fixture
def chunked(monkeypatch):
    """The flag and a chunk of 32 on both sides (JAX reads its chunk at
    import), with each side's whole-sequence scan made to fail, so a
    passing test ran the chunked paths."""
    monkeypatch.setenv("REPRO_OPT", "chunked_scan")
    monkeypatch.setenv("REPRO_SCAN_CHUNK", str(CHUNK))
    monkeypatch.setattr(joptflags, "SCAN_CHUNK", CHUNK)

    def unchunked(*a):
        raise AssertionError("the whole-sequence scan ran")

    monkeypatch.setattr(jssm, "_scan_full", unchunked)
    monkeypatch.setattr(ssm, "_scan_full", unchunked)


def test_optflags_read_when_called(monkeypatch):
    monkeypatch.delenv("REPRO_OPT", raising=False)
    monkeypatch.delenv("REPRO_SCAN_CHUNK", raising=False)
    assert not optflags.enabled("chunked_scan")
    assert optflags.SCAN_CHUNK == optflags.ATTN_CHUNK == 512
    monkeypatch.setenv("REPRO_OPT", "chunked_attn,chunked_scan")
    monkeypatch.setenv("REPRO_SCAN_CHUNK", "64")
    assert optflags.enabled("chunked_scan") and optflags.SCAN_CHUNK == 64
    monkeypatch.setenv("REPRO_SCAN_CHUNK", "0")
    with pytest.raises(ValueError, match="REPRO_SCAN_CHUNK"):
        optflags.SCAN_CHUNK
    with pytest.raises(AttributeError):
        optflags.NO_SUCH_KNOB
    # the OTA tiling knobs are functions, read when called
    for var in ("REPRO_OTA_BLOCK_COLS", "REPRO_OTA_WORKER_CHUNK",
                "REPRO_OTA_BLOCK_ROWS"):
        monkeypatch.delenv(var, raising=False)
    assert optflags.ota_block_cols() is None
    assert optflags.ota_worker_chunk() == 0
    assert optflags.ota_block_rows() == 256
    monkeypatch.setenv("REPRO_OTA_BLOCK_COLS", "128")
    monkeypatch.setenv("REPRO_OTA_WORKER_CHUNK", "8")
    monkeypatch.setenv("REPRO_OTA_BLOCK_ROWS", "512")
    assert (optflags.ota_block_cols(), optflags.ota_worker_chunk(),
            optflags.ota_block_rows()) == (128, 8, 512)


def test_scan_chunked_fused_matches_jax_forward_and_grads():
    ins = _scan_inputs()
    want, vjp = jax.vjp(lambda *a: jssm._scan_chunked_fused(*a, CHUNK), *ins)
    cot = _x(want.shape, 6)
    want_grads = vjp(jnp.asarray(cot))
    got_in = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = ssm._scan_chunked_fused(*got_in, CHUNK)
    assert got.shape == (B, S, DI)
    _close(got, want, TOL)
    got.backward(torch.from_numpy(cot))
    for name, g, w in zip("dt B C A x".split(), got_in, want_grads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)


def test_chunked_equals_unchunked_in_the_port():
    """Forward bit for bit (each step rounds as the whole-sequence scan,
    the carry folded in as B12's own step); gradients to f32 summation
    order (dA and the C-side sums add per chunk)."""
    ins = [torch.from_numpy(a) for a in _scan_inputs()]
    outs, grads = [], []
    for fn in (lambda *a: ssm._scan_full(*a),
               lambda *a: ssm._scan_chunked_fused(*a, CHUNK)):
        leaves = [a.clone().requires_grad_() for a in ins]
        y = fn(*leaves)
        torch.sin(y).sum().backward()
        outs.append(y.detach())
        grads.append([a.grad for a in leaves])
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_worker_dims_and_one_chunk():
    """Leading worker dims fold into the scan's batch (the sequence is axis
    −2), and a chunk as long as the sequence is the unchunked scan."""
    dt, Bc, Cc, A, x = (torch.from_numpy(a) for a in _scan_inputs())
    lead = lambda v: torch.stack([v, 0.5 * v])  # noqa: E731
    A2 = torch.stack([A, 2.0 * A])
    y = ssm._scan_chunked_fused(lead(dt), lead(Bc), lead(Cc), A2, lead(x),
                                CHUNK)
    assert torch.equal(y, ssm._scan_full(lead(dt), lead(Bc), lead(Cc), A2,
                                         lead(x)))
    assert torch.equal(ssm._scan_chunked_fused(dt, Bc, Cc, A, x, S),
                       ssm._scan_full(dt, Bc, Cc, A, x))


def _jcfg(**kw):
    return dataclasses.replace(jreg.get_config("falcon-mamba-7b").reduced(),
                               param_dtype="float32", **kw)


def test_block_fwd_under_chunked_scan_matches_jax(chunked):
    jcfg = _jcfg()
    p = jssm.block_init(KEY, jcfg)
    u = _x((B, S, jcfg.d_model), 7)
    want = jssm.block_fwd(p, u, jcfg)
    _close(ssm.block_fwd(_t(p), torch.from_numpy(u),
                         ModelConfig(**dataclasses.asdict(jcfg))), want, TOL)


def test_lm_loss_and_grads_under_chunked_scan_match_jax(chunked):
    jcfg = _jcfg()
    jm = jreg.build_model(jcfg)
    params = jm.init(KEY)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S),
                                               dtype=np.int32)
    (want, _), want_grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(tokens)})
    tm = reg.build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    p = _t(params, requires_grad=True)
    loss, _ = tm.loss(p, {"tokens": torch.from_numpy(tokens)})
    _close(loss, want, MODEL_TOL)
    loss.backward()
    got, want_leaves = tree_leaves(p), jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        _close(g.grad, w, MODEL_TOL)


def test_gated_linear_scan_under_chunked_scan_matches_jax(chunked):
    """JAX's shim takes its chunked ``lax.scan``; the port's runs the
    recurrence whole (on the card, one B12 launch)."""
    rng = np.random.default_rng(8)
    a = (1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, S, DI, N))))
         ).astype(np.float32)
    b = rng.standard_normal((B, S, DI, N)).astype(np.float32)
    want = jgated(a, b)
    np.testing.assert_allclose(
        np.asarray(want),
        np.asarray(_chunked_linear_scan(a.reshape(B, S, -1),
                                        b.reshape(B, S, -1), CHUNK)
                   ).reshape(a.shape), rtol=0, atol=0)
    got = gated_linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want, TOL)
