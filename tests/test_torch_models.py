"""The port's MLP, optimizers, local solvers and data pipeline against the
JAX package's, on the same numpy inputs; the synthetic datasets' statistics
(their bits differ by design)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.cplx import Complex as JComplex  # noqa: E402
from repro.data.federated import make_batch_fn as jbatch_fn  # noqa: E402
from repro.models.mlp import init_mlp_flat as jinit  # noqa: E402
from repro.models.mlp import make_loss_fns as jloss_fns  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim.local_solvers import exact_quadratic_solver as jexact  # noqa: E402
from repro.optim.local_solvers import prox_sgd_solver as jprox_sgd  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import paper_mlp  # noqa: E402
from repro_torch.core.cplx import Complex  # noqa: E402
from repro_torch.data.federated import make_batch_fn, split_iid  # noqa: E402
from repro_torch.data.synthetic import image_dataset, linreg_dataset  # noqa: E402
from repro_torch.models.mlp import init_mlp_flat, make_loss_fns  # noqa: E402
from repro_torch.optim.local_solvers import (exact_quadratic_solver,  # noqa: E402
                                             prox_sgd_solver)
from repro_torch.optim.optimizers import adam, sgd  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = (16, 8, 4)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_mlp_loss_grad_accuracy_match_jax():
    W, B = 3, 7
    flat0, unflatten_j = jinit(jax.random.PRNGKey(0), SIZES)
    d = flat0.shape[0]
    vec = np.asarray(flat0)[None] + 0.1 * _np(1, W, d)
    x = _np(2, W, B, SIZES[0])
    y = np.random.default_rng(3).integers(0, SIZES[-1], (W, B))
    loss_j, grad_j, acc_j = jloss_fns(unflatten_j)
    vec_p, unflatten = convert.mlp_flat_from_numpy(vec, SIZES, device="cpu")
    loss, grad, acc = make_loss_fns(unflatten)
    xp, yp = _t(x), _t(y).long()
    np.testing.assert_allclose(
        loss(vec_p, xp, yp).numpy(),
        np.asarray(jax.vmap(loss_j)(vec, x, y)), **TOL)
    np.testing.assert_allclose(
        grad(vec_p, xp, yp).numpy(),
        np.asarray(jax.vmap(grad_j)(vec, x, y)), **TOL)
    np.testing.assert_allclose(   # XLA's mean multiplies by 1/B
        acc(vec_p, xp, yp).numpy(), np.asarray(jax.vmap(acc_j)(vec, x, y)),
        rtol=1e-6)


def test_flat_layout_is_the_jax_one():
    """Per layer W (in, out) row-major then b: the port's views of a flat
    vector are the JAX unflatten's arrays."""
    flat, unflatten_j = jinit(jax.random.PRNGKey(4), SIZES)
    _, unflatten = convert.mlp_flat_from_numpy(np.asarray(flat), SIZES,
                                               device="cpu")
    ours = unflatten(_t(flat)[None])
    for (w, b), (wj, bj) in zip(ours, unflatten_j(flat)):
        np.testing.assert_array_equal(w[0].numpy(), np.asarray(wj))
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(bj))
    with pytest.raises(ValueError, match="need"):
        convert.mlp_flat_from_numpy(np.zeros(5), SIZES, device="cpu")


def test_init_mlp_flat_paper_size_and_scale():
    flat, unflatten = init_mlp_flat(0, paper_mlp.LAYER_SIZES, device="cpu")
    assert flat.shape == (paper_mlp.MODEL_SIZE_D,) == (109_386,)
    layers = unflatten(flat[None])
    for (w, b), fan_in in zip(layers, paper_mlp.LAYER_SIZES[:-1]):
        assert float(b.abs().max()) == 0.0
        assert float(w.std()) == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.1)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizers_match_jax(name):
    p0, g1, g2 = _np(5, 4, 9), _np(6, 4, 9), _np(7, 4, 9)
    opt_j = jsgd(0.1, momentum=0.9) if name == "sgd" else jadam(0.01)
    opt = sgd(0.1, momentum=0.9) if name == "sgd" else adam(0.01)
    pj, sj = jnp.asarray(p0), opt_j.init(jnp.asarray(p0))
    pp, sp = _t(p0), opt.init(_t(p0))
    for g in (g1, g2, g1):
        pj, sj = opt_j.update(jnp.asarray(g), sj, pj)
        pp, sp = opt.update(_t(g), sp, pp)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), **TOL)
    assert sp.count == int(sj.count) == 3


def _solver_inputs(W=4, d=5, m=12):
    X, y = _np(8, W, m, d), _np(9, W, m)
    theta, Theta = _np(10, W, d), _np(11, d)
    lam = (_np(12, W, d), _np(13, W, d))
    h = (_np(14, W, d), _np(15, W, d))
    return X, y, theta, Theta, lam, h


def test_exact_solver_matches_jax():
    X, y, theta, Theta, lam, h = _solver_inputs()
    want = jexact(X, y, 0.5)(theta, JComplex(*lam), JComplex(*h), Theta)
    got = exact_quadratic_solver(_t(X), _t(y), 0.5)(
        _t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)), _t(Theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="no minibatch"):
        exact_quadratic_solver(_t(X), _t(y), 0.5)(
            _t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)),
            _t(Theta), torch.zeros(1))


def test_prox_sgd_solver_matches_jax():
    X, y, theta, Theta, lam, h = _solver_inputs()

    def grad_j(th):
        r = jnp.einsum("wmd,wd->wm", X, th) - y
        return 2.0 * jnp.einsum("wmd,wm->wd", X, r)

    Xp, yp = _t(X), _t(y)

    def grad_p(th):
        r = torch.einsum("wmd,wd->wm", Xp, th) - yp
        return 2.0 * torch.einsum("wmd,wm->wd", Xp, r)

    want = jprox_sgd(grad_j, jsgd(0.01), 6, 0.5)(
        jnp.asarray(theta), JComplex(*lam), JComplex(*h), jnp.asarray(Theta))
    solver = prox_sgd_solver(grad_p, sgd(0.01), 6, 0.5)
    assert solver.draw_batches(torch.Generator()) is None
    got = solver(_t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)),
                 _t(Theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="batch"):
        solver(_t(theta), Complex(*map(_t, lam)), Complex(*map(_t, h)),
               _t(Theta), torch.zeros((6, 4, 2), dtype=torch.long))


def test_batch_fn_looks_up_the_same_samples_as_jax():
    W, per, B, n = 3, 10, 4, 30
    x = _np(16, n, 5)
    ylab = np.arange(n)
    shards = np.random.default_rng(17).permutation(n).reshape(W, per)
    idx = np.random.default_rng(18).integers(0, per, (W, B))
    bf = make_batch_fn((_t(x), _t(ylab)), _t(shards), B)
    bx, by = bf(_t(idx))
    flat = np.take_along_axis(shards, idx, axis=1)
    np.testing.assert_array_equal(bx.numpy(), x[flat])
    np.testing.assert_array_equal(by.numpy(), ylab[flat])
    # the JAX batch_fn draws its own indices: same shapes and shard ranges
    jx, jy = jbatch_fn((jnp.asarray(x), jnp.asarray(ylab)),
                       jnp.asarray(shards), B)(jax.random.PRNGKey(0), 0)
    assert bx.shape == jx.shape and by.shape == jy.shape
    drawn = bf.draw(torch.Generator().manual_seed(0), n_steps=6)
    assert drawn.shape == (6, W, B)
    assert int(drawn.min()) >= 0 and int(drawn.max()) < per


def test_split_iid_is_an_equal_partition():
    shards = split_iid(3, 103, 10, device="cpu")
    assert shards.shape == (10, 10)
    assert len(set(shards.reshape(-1).tolist())) == 100
    assert torch.equal(shards, split_iid(3, 103, 10, device="cpu"))


def test_linreg_dataset_statistics():
    X, y, theta = linreg_dataset(0, n_samples=4000, d=6, device="cpu")
    assert X.shape == (4000, 6) and y.shape == (4000,) and theta.shape == (6,)
    np.testing.assert_allclose(X.mean(0).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(X.std(0, correction=0).numpy(), 1.0, atol=1e-4)
    resid = y - X @ theta
    assert float(resid.std()) == pytest.approx(0.05, rel=0.1)


def test_image_dataset_shapes_and_ranges():
    xtr, ytr, xte, yte = image_dataset(0, 500, 100, n_classes=10, dim=32,
                                       cluster_std=3.0, device="cpu")
    assert xtr.shape == (500, 32) and xte.shape == (100, 32)
    assert ytr.dtype == torch.int64 and int(ytr.max()) < 10
    assert float(xtr.min()) > 0.0 and float(xtr.max()) < 1.0
    assert len(set(ytr.tolist())) == 10
