"""The port's gated linear scan (B12's plain versions, ``LinearScan`` and
``gated_linear_scan``) and worker-at-a-time accumulate (B13's plain version,
``transport.ota_accumulate``/``ota_receive_accumulated``) against the JAX
package: the associative-scan oracle and the Pallas kernels in interpret
mode, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402
from repro.kernels import gated_linear_scan as jgated_linear_scan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ota as jota  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core import transport  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels.linear_scan import (LinearScan,  # noqa: E402
                                             gated_linear_scan, linear_scan,
                                             linear_scan_bwd,
                                             linear_scan_carry,
                                             linear_scan_fwd)
from test_transport import KEY, TOL, _problem  # noqa: E402

#: ragged: S not a multiple of the TPU kernel's 256-step tile, D not a
#: multiple of its 128 lanes; and the degenerate one-step, one-channel case
SHAPES = [(1, 1, 1), (2, 37, 19), (2, 300, 130), (1, 257, 129)]
#: the plain loop multiplies gates one step at a time, the JAX oracle's
#: associative scan in a tree: products of up to S gates grouped otherwise,
#: h up to ~1/(1 − a) ≈ 10 (the bound tests/test_kernels.py puts on the
#: Pallas kernel against the same oracle)
SCAN_TOL = dict(rtol=2e-4, atol=2e-5)
#: cotangents sum the same products in reverse
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _inputs(shape, seed):
    """Gates in (0, 1), as exp(dt·A) gives them, and N(0, 1) inputs."""
    r = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-2.0 * r.standard_normal(shape)))).astype(
        np.float32)
    return a, r.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_scan_matches_the_oracle_and_the_pallas_kernel(shape):
    a, b = _inputs(shape, 1)
    got = ref.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, jref.linear_scan(a, b), **SCAN_TOL)
    np.testing.assert_allclose(got, jops.linear_scan(a, b), **SCAN_TOL)
    # h_0 = b_0 exactly, whatever a_0
    np.testing.assert_array_equal(got[:, 0], b[:, 0])


def test_plain_scan_is_the_sequential_recurrence_bit_for_bit():
    """The loop's rounding order is the B12 kernel's: each step rounds a·h,
    then the sum, so the kernel can be held to it exactly."""
    a, b = _inputs((2, 23, 7), 2)
    h = b[:, 0].copy()
    seq = [h]
    for t in range(1, 23):
        h = (a[:, t] * h).astype(np.float32) + b[:, t]
        seq.append(h)
    got = ref.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.stack(seq, axis=1))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_grads_match_the_pallas_custom_vjp(shape):
    """``linear_scan_bwd`` and ``LinearScan``'s grads against jax.grad of
    Σ h⊙c through the Pallas kernel's custom VJP (one reversed launch)."""
    a, b = _inputs(shape, 3)
    cot = np.random.default_rng(4).standard_normal(shape).astype(np.float32)

    def loss(a_, b_):
        return jnp.sum(jops.linear_scan(a_, b_) * cot)

    want_da, want_db = jax.grad(loss, argnums=(0, 1))(a, b)
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    h = linear_scan(at, bt)
    (h * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), want_da, **GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), want_db, **GRAD_TOL)
    da, db = ref.linear_scan_bwd(torch.from_numpy(a), h.detach(),
                                 torch.from_numpy(cot))
    assert torch.equal(da, at.grad) and torch.equal(db, bt.grad)


def test_linear_scan_saves_gates_and_output_and_keeps_dtypes():
    a, b = _inputs((1, 9, 4), 5)
    at = torch.from_numpy(a).double().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    h = linear_scan(at, bt)
    assert h.dtype == torch.float32
    assert isinstance(h.grad_fn, LinearScan._backward_cls)
    saved = h.grad_fn.saved_tensors
    assert len(saved) == 2
    assert torch.equal(saved[0], at.detach().float())
    assert torch.equal(saved[1], h.detach())
    h.sum().backward()
    assert at.grad.dtype == torch.float64 and bt.grad.dtype == torch.float32


def test_cpu_tensors_launch_nothing():
    a, b = _inputs((2, 5, 3), 6)
    build.reset_launches()
    h = linear_scan_fwd(torch.from_numpy(a), torch.from_numpy(b))
    linear_scan_bwd(torch.from_numpy(a), h, torch.ones_like(h))
    assert not build.launches


def test_gated_linear_scan_folds_trailing_dims_like_jax():
    """(B, S, di, n), as the SSM builds it: the trailing dims fold into
    one channel axis; the result and its grads equal JAX's shim."""
    shape = (2, 40, 3, 5)
    a, b = _inputs(shape, 7)
    want = jgated_linear_scan(a, b)
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    got = gated_linear_scan(at, bt)
    assert got.shape == shape
    np.testing.assert_allclose(got.detach().numpy(), want, **SCAN_TOL)
    torch.sin(got).sum().backward()
    jda, jdb = jax.grad(lambda x, y: jnp.sum(jnp.sin(jgated_linear_scan(
        x, y))), argnums=(0, 1))(a, b)
    np.testing.assert_allclose(at.grad.numpy(), jda, **GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), jdb, **GRAD_TOL)


def test_gated_linear_scan_refuses_what_it_cannot_run(monkeypatch):
    """Mismatched planes are refused; ``chunked_scan`` (and a chunk shorter
    than the sequence) leaves the shim's result as it was: the shim runs
    the recurrence whole, the SSM chunks its own scan."""
    a = torch.rand(2, 4, 3)
    with pytest.raises(ValueError, match="one \\(B, S"):
        gated_linear_scan(a, a[:, :3])
    b = torch.randn(2, 4, 3)
    want = gated_linear_scan(a, b)
    monkeypatch.setenv("REPRO_OPT", "chunked_attn,chunked_scan")
    monkeypatch.setenv("REPRO_SCAN_CHUNK", "2")
    assert torch.equal(gated_linear_scan(a, b), want)


@pytest.mark.parametrize("chunk", [1, 7, 16, 40])
def test_linear_scan_carry_chunk_by_chunk_is_the_whole_scan(chunk):
    """Each chunk from the last one's ``h_last``: h, and the gradients of a
    and b through the carries, bit for bit those of one whole scan (the
    carry is folded in and its gradient added as B12 rounds each step)."""
    a, b = (torch.from_numpy(x) for x in _inputs((2, 40, 3, 5), 9))
    cot = torch.from_numpy(_inputs((2, 40, 3, 5), 10)[1])
    whole_a, whole_b = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = gated_linear_scan(whole_a, whole_b)
    (want * cot).sum().backward()
    ca, cb = a.clone().requires_grad_(), b.clone().requires_grad_()
    hs, h = [], torch.zeros(2, 3, 5)
    for ac, bc in zip(ca.split(chunk, dim=1), cb.split(chunk, dim=1)):
        out, h = linear_scan_carry(ac, bc * 1.0, h)
        hs.append(out)
    got = torch.cat(hs, dim=1)
    (got * cot).sum().backward()
    assert torch.equal(got, want) and torch.equal(h, want[:, -1])
    assert torch.equal(ca.grad, whole_a.grad)
    assert torch.equal(cb.grad, whole_b.grad)


def test_linear_scan_carry_takes_over_b_and_refuses_views():
    a, b = (torch.from_numpy(x) for x in _inputs((2, 6, 4), 11))
    h0 = torch.ones(2, 4)
    b_in = b.clone()
    h, h_last = linear_scan_carry(a, b_in, h0)
    torch.testing.assert_close(b_in[:, 0], b[:, 0] + a[:, 0] * h0)
    assert torch.equal(h, ref.linear_scan(a, b_in))
    assert torch.equal(h_last, h[:, -1])
    with pytest.raises(ValueError, match="not a view"):
        linear_scan_carry(a, b.clone()[:, :3], h0)
    with pytest.raises(ValueError, match="float32"):
        linear_scan_carry(a, b.double(), h0)


# ---------------------------------------------------------------------------
# B12's planner: which plan each shape takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,S,D,stages", [
    (2, 4096, 2560, ls.SHORT_STAGES),  # recurrentgemma-2b at full width
    (4, 128, 128, ls.LONG_STAGES),     # the llm_hybrid path
    (3, 1000, 100, ls.LONG_STAGES),    # ragged
])
def test_few_sequences_take_the_staged_plan(rows, S, D, stages):
    t = ls.scan_tiling(rows, S, D)
    assert t == ls.ScanTiling("staged", ls.STAGED_CHANNELS, *stages)
    assert rows * D < ls.STAGED_BELOW_PER_SM * ls.ota_round.SMS


def test_the_ssm_shape_takes_the_thread_plan():
    """falcon-mamba-7b's (W·B, S, d_inner·n): 262,144 sequences fill the
    card one thread each.  The threshold is in sequences an SM."""
    assert ls.scan_tiling(2, 4096, 131_072) == ls.ScanTiling("thread")
    below = ls.STAGED_BELOW_PER_SM * 132
    assert ls.scan_tiling(1, 4096, below).plan == "thread"
    assert ls.scan_tiling(1, 4096, below - 4).plan == "staged"
    assert ls.scan_tiling(1, 4096, below - 4, n_sm=66).plan == "thread"


@pytest.mark.parametrize("rows,D,n_sm,stages", [
    (2, 2044, 132, ls.LONG_STAGES),    # 4,088 sequences: 31 an SM or fewer
    (2, 2048, 132, ls.SHORT_STAGES),
    (2, 2048, 264, ls.LONG_STAGES),    # the same count on twice the SMs
    (1, 65_000, 132, ls.SHORT_STAGES),
])
def test_stage_length_follows_the_sequences_an_sm(rows, D, n_sm, stages):
    assert ls.staged_tiling(rows, D, n_sm) == ls.ScanTiling(
        "staged", ls.STAGED_CHANNELS, *stages)


@pytest.mark.parametrize("D,aligned,why", [
    (2562, True, "not a multiple of 4"),
    (2560, False, "16-byte boundary"),
])
def test_what_tma_cannot_take_keeps_the_thread_plan(D, aligned, why):
    assert ls.scan_tiling(2, 4096, D, aligned=aligned).plan == "thread"
    with pytest.raises(ValueError, match=why):
        ls.resolve_plan("linear_scan_fwd", "staged", 2, 4096, D,
                        aligned=aligned)


def test_a_forced_staged_plan_the_planes_cannot_take_raises():
    """On CPU tensors too: D = 6, and planes 4 bytes off a 16-byte
    boundary."""
    a, b = map(torch.from_numpy, _inputs((2, 5, 6), 8))
    with pytest.raises(ValueError, match="staged plan cannot take"):
        linear_scan_fwd(a, b, plan="staged")
    with pytest.raises(ValueError, match="staged plan cannot take"):
        linear_scan_bwd(a, b, b, plan="staged")
    buf = torch.zeros(2 * 5 * 8 + 1)
    off = buf[1:].view(2, 5, 8)
    assert off.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte boundary"):
        linear_scan_fwd(off, off, plan="staged")
    assert torch.equal(linear_scan_fwd(off, off, plan="thread"),
                       ref.linear_scan(off, off))
    with pytest.raises(ValueError, match="none of"):
        linear_scan_fwd(a, b, plan="chunked")
    with pytest.raises(ValueError, match="none of"):
        with ls.forced_plan("chunked"):
            pass


def test_forced_plan_reaches_both_directions_of_the_autograd_path():
    """The plan forced around the forward is the one its backward runs,
    even after the block: D = 6 cannot be staged, so both refuse."""
    a, b = map(torch.from_numpy, _inputs((2, 5, 6), 9))
    at = a.clone().requires_grad_()
    with pytest.raises(ValueError, match="staged plan cannot take"):
        with ls.forced_plan("staged"):
            linear_scan(at, b)
    a8, b8 = map(torch.from_numpy, _inputs((2, 5, 8), 9))
    at = a8.clone().requires_grad_()
    with ls.forced_plan("staged"):
        h = linear_scan(at, b8)
    assert ls._forced.get() is None
    assert h.grad_fn.plan == "staged"
    h.sum().backward()
    want_da, _ = ref.linear_scan_bwd(a8, ref.linear_scan(a8, b8),
                                     torch.ones_like(b8))
    assert torch.equal(at.grad, want_da)


# ---------------------------------------------------------------------------
# B13: the worker-at-a-time accumulate
# ---------------------------------------------------------------------------

def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("d", [1, 64, 1024 + 11])
def test_plain_accumulate_matches_jnp_and_the_pallas_kernel(d):
    """One step of B13's plain version: bit for bit the jnp path's
    expression; the Pallas kernel adds h_re·s_re before subtracting
    h_im·s_im, one rounding apart."""
    r = np.random.default_rng(d)
    y, p2, sre, sim, hre, him = (r.standard_normal(d).astype(np.float32)
                                 for _ in range(6))
    p2 = np.abs(p2)
    got = ref.ota_accumulate(*map(_t, (y, p2, sre, sim, hre, him)))
    acc = jtransport.ota_accumulate(
        jtransport.OtaAccumulator(jnp.asarray(y), jnp.asarray(p2)),
        jtransport.Complex(sre, sim), jtransport.Complex(hre, him),
        backend="jnp")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(acc.y_re))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(acc.sumh2))
    ky, kp = jota.ota_accumulate(y, p2, sre, sim, hre, him, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), ky, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), kp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [64, 1024 + 11])
def test_accumulated_receive_matches_jax(d):
    """``tests/test_transport.py``'s accumulated receive: five workers
    accumulated one at a time, then one demodulate under JAX's noise plane,
    against JAX's accumulated receive (jnp and Pallas) and its stacked
    receive, to that test's tolerance."""
    W, ia = 5, 0.7
    theta, lam, h = _problem(W, d, seed=d)
    ccfg = JChannelConfig(n_workers=W, noisy=True, snr_db=20.0)
    s = jtransport.modulate(theta, lam, h, 0.5, backend="jnp")
    kn = jax.random.fold_in(KEY, 13)
    want = jtransport.receive(s, h, kn, ccfg, ia, backend="jnp")
    jgot = {}
    for backend in ("jnp", "pallas"):
        def body(acc, xs, backend=backend):
            s_w, h_w = xs
            return jtransport.ota_accumulate(acc, s_w, h_w,
                                             backend=backend), None

        acc, _ = jax.lax.scan(body, jtransport.ota_accumulate_init((d,)),
                              (s, h))
        jgot[backend] = jtransport.ota_receive_accumulated(acc, kn, ccfg, ia,
                                                           backend=backend)
    noise = _t(jtransport.matched_filter_noise_re(kn, (d,), ccfg))
    build.reset_launches()
    acc = transport.ota_accumulate_init((d,), device="cpu")
    for w in range(W):
        acc = transport.ota_accumulate(acc, Complex(_t(s.re[w]), _t(s.im[w])),
                                       Complex(_t(h.re[w]), _t(h.im[w])))
    for inv_alpha in (ia, torch.tensor(ia)):
        got = transport.ota_receive_accumulated(acc, noise, inv_alpha).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, jgot["jnp"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, jgot["pallas"], **TOL)
    assert not build.launches
    assert acc.y_re.shape == (d,) and acc.y_re.dtype == torch.float32


def test_accumulator_keeps_its_shape_and_starts_at_zero():
    acc = transport.ota_accumulate_init((3, 4), device="cpu")
    assert not acc.y_re.any() and not acc.sumh2.any()
    one = Complex(torch.ones(3, 4), torch.full((3, 4), 2.0))
    acc = transport.ota_accumulate(acc, one, one)
    assert acc.y_re.shape == (3, 4)
    assert torch.equal(acc.y_re, torch.full((3, 4), -3.0))
    assert torch.equal(acc.sumh2, torch.full((3, 4), 5.0))
