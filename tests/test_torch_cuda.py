"""The CUDA kernels on the card, against their plain versions (needs an
NVIDIA GPU and nvcc; skipped elsewhere).  Imports no JAX, so it also runs on
a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import admm_update, build, ota, ref  # noqa: E402

pytestmark = pytest.mark.cuda
SHAPES = [(3, 1000), (5, 1025), (8, 4097), (100, 109_386)]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(dev, W, d, n, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn((W, d), generator=g, device=dev) * math.sqrt(0.5)
            for _ in range(n)]


def _launched(name, fn):
    before = build.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert build.launches[name] == before + 1
    return out


@pytest.mark.parametrize("W,d", SHAPES)
def test_modulate_kernel(dev, W, d):
    args = _planes(dev, W, d, 5, 1)
    got = _launched("ota_modulate", lambda: ota.ota_modulate(*args, 0.5))
    for a, b in zip(got, ref.ota_modulate(*args, 0.5)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("ia", [0.37, 0.0])
def test_receive_kernel(dev, W, d, ia):
    args = _planes(dev, W, d, 4, 2)
    noise = torch.randn(d, device=dev)
    ia_t = torch.tensor(ia, device=dev)
    got = _launched("ota_receive",
                    lambda: ota.ota_receive(*args, noise, ia_t))
    torch.testing.assert_close(got, ref.ota_receive(*args, noise, ia_t),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("W,d", SHAPES)
@pytest.mark.parametrize("with_noise", [False, True])
def test_dual_update_kernel(dev, W, d, with_noise):
    lre, lim, hre, him, th, z = _planes(dev, W, d, 6, 3)
    Th = torch.randn(d, device=dev)
    z = z if with_noise else None
    got = _launched("admm_dual_update", lambda: admm_update.admm_dual_update(
        lre, lim, hre, him, th, Th, 0.5, z))
    want = ref.admm_dual_update(lre, lim, hre, him, th, Th, 0.5, z)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("W,d", SHAPES)
def test_flip_lambda_kernel(dev, W, d):
    g, th, hre, him = _planes(dev, W, d, 4, 4)
    hre[0, :5] = 0.0
    him[0, :5] = 0.0
    Th = torch.randn(d, device=dev)
    got = _launched("admm_flip_lambda", lambda: admm_update.admm_flip_lambda(
        g, th, Th, hre, him, 0.5))
    for a, b in zip(got, ref.admm_flip_lambda(g, th, Th, hre, him, 0.5)):
        torch.testing.assert_close(a, b, **TOL)


def test_wrappers_refuse_bad_operands(dev):
    a, b = _planes(dev, 2, 8, 2, 5)
    with pytest.raises(ValueError, match="not contiguous"):
        ota.ota_modulate(a.t(), a.t(), a.t(), a.t(), a.t(), 0.5)
    with pytest.raises(ValueError, match="float32"):
        ota.ota_modulate(a.double(), a, a, b, b, 0.5)
    with pytest.raises(ValueError, match="shape"):
        ota.ota_modulate(a, a[:, :4].contiguous(), a, b, b, 0.5)
    with pytest.raises(ValueError, match="one-element tensor"):
        ota.ota_receive(a, a, b, b, torch.zeros(8, device=dev), 0.5)
    with pytest.raises(ValueError, match="Theta"):
        admm_update.admm_dual_update(a, a, b, b, a, torch.zeros(7, device=dev),
                                     0.5)
