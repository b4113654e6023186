"""B11's plain versions against the JAX package: the forward ``(o, lse)``
and the backward against the Pallas kernels ``_flash_forward`` /
``_flash_backward`` in interpret mode and against the jnp oracles
``ref.attention`` / ``attention_vjp``, on the same numpy inputs; and the
autograd.Function's CPU wiring.  Causal and non-causal, ragged S, T < S."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import build, flash_attention, ref  # noqa: E402

#: (B, H, S, T, hd, causal, Pallas tile): aligned causal and non-causal, a
#: ragged S = T = 40 (tiles of 16 pad it to 48), T < S
CASES = [(1, 2, 64, 64, 32, True, 32), (1, 2, 64, 64, 32, False, 32),
         (2, 1, 40, 40, 16, True, 16), (1, 2, 48, 32, 16, True, 16)]
IDS = ["causal", "non-causal", "ragged-S40", "T<S"]
#: f32 on both sides; the Pallas kernels sum tile by tile (online softmax),
#: the plain version over the whole row: summation order only
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, H, S, T, hd, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, H, T, hd), (B, H, T, hd),
                          (B, H, S, hd))]


@pytest.fixture(scope="module", params=list(zip(CASES, IDS)),
                ids=lambda p: p[1])
def case(request):
    """The case's inputs and the JAX side's results, traced once."""
    (B, H, S, T, hd, causal, tile), _ = request.param
    q, k, v, do = _inputs(B, H, S, T, hd)
    scale = hd ** -0.5
    o, lse = jflash._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, scale=scale,
                                   block_q=tile, block_k=tile, interpret=True)
    grads = jflash._flash_backward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), o, lse, jnp.asarray(do),
                                   causal=causal, scale=scale, block_q=tile,
                                   block_k=tile, interpret=True)
    jax_out = dict(o=np.asarray(o), lse=np.asarray(lse),
                   grads=[np.asarray(g) for g in grads])
    if S == T:
        jax_out["oracle_o"] = np.asarray(jref.attention(q, k, v, causal))
        jax_out["oracle_grads"] = [np.asarray(g) for g in jref.attention_vjp(
            q, k, v, do, causal)]
    return dict(q=q, k=k, v=v, do=do, causal=causal, jax=jax_out)


def _t(x):
    return torch.from_numpy(x)


def test_forward_matches_pallas_and_oracle(case):
    q, k, v = (_t(case[n]) for n in "qkv")
    o, lse = ref.flash_attention_fwd(q, k, v, case["causal"])
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), case["jax"]["o"], **TOL)
    np.testing.assert_allclose(lse.numpy(), case["jax"]["lse"], **TOL)
    if "oracle_o" in case["jax"]:
        np.testing.assert_allclose(o.numpy(), case["jax"]["oracle_o"], **TOL)


def test_backward_matches_pallas_and_oracle(case):
    q, k, v, do = (_t(case[n]) for n in ("q", "k", "v", "do"))
    o, lse = ref.flash_attention_fwd(q, k, v, case["causal"])
    delta = flash_attention.attention_delta(o, do)
    # the kernels' residual form (p from lse, δ from o), as Pallas takes it
    got = ref.flash_attention_bwd(q, k, v, do, case["causal"], lse=lse,
                                  delta=delta)
    for g, w in zip(got, case["jax"]["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    if "oracle_grads" in case["jax"]:
        plain = ref.flash_attention_bwd(q, k, v, do, case["causal"])
        for g, w in zip(plain, case["jax"]["oracle_grads"]):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_autograd_function_equals_plain_backward(case):
    """On CPU tensors the Function runs the plain forward and the plain
    dq / dk-dv from the saved residuals; no kernel launch is counted."""
    q, k, v, do = (_t(case[n]) for n in ("q", "k", "v", "do"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    build.reset_launches()
    out = flash_attention.flash_attention(*leaves, causal=case["causal"])
    out.backward(do)
    assert not build.launches
    o, lse = ref.flash_attention_fwd(q, k, v, case["causal"])
    assert torch.equal(out.detach(), o)
    want = ref.flash_attention_bwd(q, k, v, do, case["causal"], lse=lse,
                                   delta=flash_attention.attention_delta(o,
                                                                         do))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    for g, w in zip([l.grad for l in leaves], case["jax"]["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_dq_and_dkv_wrappers_take_the_plain_version_on_cpu(case):
    q, k, v, do = (_t(case[n]) for n in ("q", "k", "v", "do"))
    o, lse = flash_attention.flash_attention_fwd(q, k, v, case["causal"])
    delta = flash_attention.attention_delta(o, do)
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta,
                                            case["causal"])
    dk, dv = flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 case["causal"])
    for g, w in zip((dq, dk, dv), case["jax"]["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_bf16_keeps_the_primal_dtypes():
    q, k, v, do = (_t(x).to(torch.bfloat16) for x in _inputs(1, 2, 32, 32,
                                                            16, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention.flash_attention(*leaves)
    out.backward(do)
    assert out.dtype == torch.bfloat16
    assert all(l.grad.dtype == torch.bfloat16 for l in leaves)
    _, lse = ref.flash_attention_fwd(q, k, v)
    assert lse.dtype == torch.float32
