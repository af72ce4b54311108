"""The CUDA kernels against their plain PyTorch twins, on a GPU.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports neither JAX nor the reference, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

B4 and B6 are bit-exact (B6's twin sums its taps in the kernel's order);
B1/B2/B5 are bit-exact on dyadic activations, where every float32 partial
sum is exact in any summation order.
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


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("g,m,kg,ng", [(2, 13, 10, 5), (8, 100, 72, 8),
                                       (3, 65, 18, 33)])
def test_grouped_matmul_kernel_exact_on_dyadic(cuda, int4, g, m, kg, ng):
    rng = np.random.RandomState(g + m)
    xg = torch.from_numpy((rng.randint(-64, 65, (g, m, kg)) / 64.0)
                          .astype(np.float32))
    wg = torch.from_numpy(rng.randint(-7, 8, (g, kg, ng)).astype(np.int8))
    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, g * ng))
                         .astype(np.float32))
    b = torch.from_numpy((rng.randint(-64, 64, g * ng) / 16.0)
                         .astype(np.float32))
    if int4:
        wg = tops.pack_int4_grouped(wg)
    want = tops.quant_grouped_matmul(xg, wg, s, b, packed=int4)
    got = tops.quant_grouped_matmul(xg.to(cuda), wg.to(cuda), s.to(cuda),
                                    b.to(cuda), packed=int4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_grouped_conv2d_on_card_equals_cpu(cuda):
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randint(-64, 65, (2, 8, 9, 9)) / 64.0)
                         .astype(np.float32))
    wg = torch.from_numpy(rng.randint(-7, 8, (4, 18, 3)).astype(np.int8))
    kw = dict(groups=4, kernel_shape=(3, 3), strides=(2, 1),
              pads=(1, 0, 2, 1))
    want = tops.quant_grouped_conv2d(x, wg, 0.25, **kw)
    got = tops.quant_grouped_conv2d(x.to(cuda), wg.to(cuda), 0.25, **kw)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", MODES)
def test_depthwise_kernel_matches_twin(cuda, mode):
    rng = np.random.RandomState(7)
    c = 37
    x = torch.from_numpy(_acts(7, (2, c, 11, 10)))
    taps = torch.from_numpy(rng.randint(-7, 8, (9, c)).astype(np.int8))
    s = torch.from_numpy((rng.rand(c) * 0.1 + 0.01).astype(np.float32))
    b = torch.from_numpy(rng.randn(c).astype(np.float32))
    qs, qz = torch.tensor(0.173), torch.tensor(1.0)
    for geo in (dict(strides=(1, 1), pads=(1, 1, 1, 1), dilations=(1, 1)),
                dict(strides=(2, 2), pads=(2, 0, 1, 1), dilations=(2, 2))):
        for act in (dict(relu=True, act_bits=4, act_signed=False),
                    dict(relu=False, act_bits=None)):
            kw = dict(kernel_shape=(3, 3), act_rounding=mode, **geo, **act)
            want = tops.quant_depthwise_conv2d(x, taps, s, b, qs, qz, **kw)
            got = tops.quant_depthwise_conv2d(
                x.to(cuda), taps.to(cuda), s.to(cuda), b.to(cuda),
                qs.to(cuda), qz.to(cuda), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)


def test_mean_on_card_equals_cpu(cuda):
    """GlobalAveragePool over 7x7 scales by 1/49 the same way on both."""
    from repro_torch.core import GraphBuilder, execute
    b = GraphBuilder("gap")
    x = b.add_input("x", (3, 5, 7, 7))
    (h,) = b.add_node("GlobalAveragePool", [x], 1)
    b.mark_output(h)
    g = b.build()
    xs = (np.random.RandomState(3).randint(-15, 16, (3, 5, 7, 7)) / 8.0) \
        .astype(np.float32)
    want = execute(g, {"x": xs}, device="cpu")[h]
    got = execute(g, {"x": xs})[h]
    assert torch.equal(got.cpu(), want)


def test_conv_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros(1, 4, 5, 5, device=cuda)
    taps = torch.zeros(9, 4, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        tops.quant_depthwise_conv2d(x.permute(0, 1, 3, 2), taps, 1.0,
                                    kernel_shape=(3, 3))
    with pytest.raises(ValueError):
        tops.quant_depthwise_conv2d(x, taps.float(), 1.0, kernel_shape=(3, 3))
    with pytest.raises(ValueError):
        tops.quant_depthwise_conv2d(x, taps, torch.ones(3, device=cuda),
                                    kernel_shape=(3, 3))
    xg = torch.zeros(2, 6, 8, device=cuda)
    wg = torch.zeros(2, 8, 3, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="unit stride"):
        tops.quant_grouped_matmul(
            torch.zeros(2, 8, 6, device=cuda).transpose(1, 2), wg, 1.0)
    with pytest.raises(ValueError):
        tops.quant_grouped_matmul(xg, wg.cpu(), 1.0)
    with pytest.raises(ValueError):
        tops.quant_grouped_matmul(xg.double(), wg, 1.0)
