"""The CUDA kernels against their plain PyTorch twins, on a GPU.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports neither JAX nor the reference, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

B4 is bit-exact; B1/B2 are bit-exact on dyadic activations, where every
float32 partial sum is exact in any summation order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402

MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP", "HALF_DOWN",
         "ROUND_TO_ZERO")
SHAPES = [(1, 784, 64), (8, 64, 64), (13, 98, 10), (5, 64, 10),
          (256, 784, 64)]


@pytest.fixture
def cuda():
    """The GPU, or a skip: kernels have no CPU mode, only plain twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _acts(seed, shape, spread=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * spread).astype(np.float32)
    x.reshape(-1)[:13] = np.arange(-6, 7, dtype=np.float32) * 0.5
    return x


def _weights(seed, k, n, lo=-7, hi=7):
    return np.random.RandomState(seed).randint(lo, hi + 1, (k, n)).astype(
        np.int8)


@pytest.mark.parametrize("mode", MODES)
def test_quant_dequant_kernel_matches_twin(cuda, mode):
    x = torch.from_numpy(_acts(5, (37, 70)))
    s = torch.rand(70) + 0.05
    z = torch.round(torch.randn(70))
    for emit in (False, True):
        for bits, signed, narrow in ((4, True, True), (2, False, False),
                                     (7.5, True, False)):
            kw = dict(bit_width=bits, signed=signed, narrow=narrow,
                      rounding_mode=mode, emit_codes=emit)
            want = tops.quant_dequant(x, s, z, **kw)
            got = tops.quant_dequant(x.to(cuda), s.to(cuda), z.to(cuda), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_matmul_kernel_exact_on_dyadic(cuda, int4, m, k, n):
    rng = np.random.RandomState(k)
    x = torch.from_numpy((rng.randint(-128, 129, (m, k)) / 128.0)
                         .astype(np.float32))
    w = torch.from_numpy(_weights(n, k, n))
    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, n)).astype(np.float32))
    b = torch.from_numpy((rng.randint(-64, 64, n) / 16.0).astype(np.float32))
    if int4:
        w = tops.pack_int4(w)
    fn = tops.quant_matmul_int4 if int4 else tops.quant_matmul
    want = fn(x, w, s, b)
    got = fn(x.to(cuda), w.to(cuda), s.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(8, 3, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        tops.quant_matmul(x.double(), w, 1.0)
    with pytest.raises(ValueError):
        tops.quant_matmul(x, w.float(), 1.0)
    with pytest.raises(ValueError):
        tops.quant_matmul(x, w, torch.ones(5, device=cuda))
    with pytest.raises(ValueError):
        tops.quant_dequant(x.t(), 1.0, 0.0)
