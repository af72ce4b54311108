"""The CUDA kernels against their plain PyTorch twins, on a GPU.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports neither JAX nor the reference, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

B4 and B6 are bit-exact (B6's twin sums its taps in the kernel's order);
B1/B2/B5 are bit-exact on dyadic activations, where every float32 partial
sum is exact in any summation order, and give the same bits on repeated
calls (B1 / B2 split K over a cluster and reduce in a fixed order).
"""
import functools
import importlib.util
from pathlib import Path

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


@pytest.mark.parametrize("channels_last", [False, True])
def test_executor_conv_on_card_equals_cpu(cuda, channels_last):
    """The oracle's convolutions sum CNV-w2a2's dyadic products exactly on
    the card too, in either layout (cuDNN's algorithms round some of
    those sums, which moves codes off their ties)."""
    from repro_torch.core import execute, transforms
    from repro_torch.models import zoo
    g = zoo.ZOO["CNV-w2a2"]()
    x = np.random.RandomState(0).randn(1, 3, 32, 32).astype(np.float32)
    want = execute(g, {"x": x}, device="cpu")[g.output_names[0]]
    if channels_last:
        g, x = transforms.to_channels_last(transforms.cleanup(g)), x.transpose(0, 2, 3, 1)
    got = execute(g, {g.input_names[0]: x})[g.output_names[0]]
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


# --------------------------------------------- the integer bodies (B3)

def _chip_smoke():
    """chip_smoke.py, whose phase 2 runs the same integer cases."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# None (the int32 body with the float32 epilogue), B3 without an act Quant
# (ReLU off and on), and B3 with one in every rounding mode at act_shift
# -3, 0 and 5, zero points, ReLU and signed / unsigned / narrow bounds
# varying
INT_SPECS = _chip_smoke().int_specs()
IN_SCALE = 3 * 2.0 ** -5


def _int_case(rng, spec, shape, n, per_channel):
    """(x, scale or multipliers, body keyword arguments) of one case: x is
    q * IN_SCALE on the B3 body, which divides it back, and q itself on
    the int32 body with the float32 epilogue."""
    q = rng.randint(-8, 9, shape).astype(np.float32)
    k = n if per_channel else 1
    if spec is None:
        s = (2.0 ** -rng.randint(2, 6, k)).astype(np.float32)
        return torch.from_numpy(q), torch.from_numpy(s), \
            dict(acc_dtype=torch.int32)
    mult = (2 * rng.randint(0, 5, k) + 1).astype(np.int32)
    return torch.from_numpy(q * np.float32(IN_SCALE)), torch.from_numpy(mult), \
        dict(acc_dtype=torch.int32, requant=spec, in_scale=IN_SCALE)


def _on(dev, *ts):
    return [None if t is None else t.to(dev) for t in ts]


@pytest.mark.parametrize("spec", range(len(INT_SPECS)))
@pytest.mark.parametrize("int4", [False, True])
def test_matmul_integer_body_matches_twin(cuda, int4, spec):
    rng = np.random.RandomState(spec)
    fn = tops.quant_matmul_int4 if int4 else tops.quant_matmul
    for m, k, n in ((37, 130, 70), (256, 784, 64), (5, 64, 10)):
        x, s, kw = _int_case(rng, INT_SPECS[spec], (m, k), n, spec % 2 == 1)
        w = torch.from_numpy(_weights(spec, k, n, -8 if int4 else -127,
                                      7 if int4 else 127))
        if int4:
            w = tops.pack_int4(w)
        b = torch.randn(n) if spec % 5 == 0 else None
        want = fn(x, w, s, b, **kw)
        got = fn(*_on(cuda, x, w, s, b), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("spec", range(0, len(INT_SPECS), 4))
@pytest.mark.parametrize("int4", [False, True])
def test_grouped_matmul_integer_body_matches_twin(cuda, int4, spec):
    rng = np.random.RandomState(100 + spec)
    for g, m, kg, ng in ((8, 100, 72, 8), (3, 65, 18, 33)):
        x, s, kw = _int_case(rng, INT_SPECS[spec], (g, m, kg), g * ng,
                             spec % 2 == 0)
        w = torch.from_numpy(rng.randint(-7, 8, (g, kg, ng)).astype(np.int8))
        if int4:
            w = tops.pack_int4_grouped(w)
        want = tops.quant_grouped_matmul(x, w, s, packed=int4, **kw)
        got = tops.quant_grouped_matmul(*_on(cuda, x, w, s), packed=int4,
                                        **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("spec", range(len(INT_SPECS)))
def test_depthwise_integer_body_matches_twin(cuda, spec):
    rng = np.random.RandomState(200 + spec)
    c = 37
    x, s, kw = _int_case(rng, INT_SPECS[spec], (2, c, 11, 10), c,
                         spec % 2 == 1)
    taps = torch.from_numpy(rng.randint(-7, 8, (9, c)).astype(np.int8))
    args = [x, taps, s]
    if INT_SPECS[spec] is None:          # the fused float32 epilogue
        args += [None, torch.tensor(0.25), torch.tensor(1.0)]
        kw.update(relu=True, act_bits=4, act_signed=False)
    for geo in (dict(strides=(1, 1), pads=(1, 1, 1, 1), dilations=(1, 1)),
                dict(strides=(2, 2), pads=(2, 0, 1, 1), dilations=(2, 2))):
        want = tops.quant_depthwise_conv2d(*args, kernel_shape=(3, 3), **geo,
                                           **kw)
        got = tops.quant_depthwise_conv2d(*_on(cuda, *args),
                                          kernel_shape=(3, 3), **geo, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def test_integer_accumulators_at_the_limit(cuda):
    """Sums just below 2**24, the lowering's exactness bound."""
    k = 1040
    for int4, wmax in ((False, 127), (True, 7)):
        qmax = (2 ** 24 - 1) // (k * wmax)
        w = torch.full((k, 8), wmax, dtype=torch.int8)
        q = torch.full((2, k), float(qmax))
        q[1] = -qmax
        wk = tops.pack_int4(w) if int4 else w
        fn = tops.quant_matmul_int4 if int4 else tops.quant_matmul
        for spec in INT_SPECS[:3]:
            x = q if spec is None else q * IN_SCALE
            kw = dict(acc_dtype=torch.int32) if spec is None else \
                dict(acc_dtype=torch.int32, requant=spec, in_scale=IN_SCALE)
            s = torch.ones(1, dtype=torch.float32 if spec is None
                           else torch.int32)
            want = fn(x, wk, s, **kw)
            got = fn(*_on(cuda, x, wk, s), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)
            assert float(want.abs().max()) > 2 ** 23 * 2.0 ** -9


# ------------------------- B5 / B6 redesigned: geometries and stagings

CS = _chip_smoke()
# (in_scale, x off its grid): the reciprocal, the exact-quotient check, its
# division fallback, and the division throughout (TINY_SCALE)
STAGINGS = CS.STAGINGS + ((CS.TINY_SCALE, False),)


def _staged(rng, shape, in_scale, off_grid):
    x = rng.randint(-8, 9, shape).astype(np.float32) * np.float32(in_scale)
    if off_grid:
        x.reshape(-1)[::7] += np.float32(in_scale / 3)
    return torch.from_numpy(x)


def _dw_all_bodies(cuda, rng, x, taps, geo, modes, specs, on_card_twin):
    """B6 in the float32 body (every mode in ``modes``, at a power-of-two
    act scale and another) and in the integer bodies at every staging,
    each torch.equal to its twin (on the card where ``on_card_twin``, else
    on the CPU, whose division keeps TINY_SCALE's subnormals)."""
    c = x.shape[1]
    s = torch.from_numpy((rng.rand(c) * 0.1 + 0.01).astype(np.float32))
    b = torch.from_numpy(rng.randn(c).astype(np.float32))
    for i, mode in enumerate(modes):
        qs, qz = torch.tensor(0.125 if i % 2 else 0.173), torch.tensor(1.0)
        kw = dict(geo, relu=True, act_bits=4, act_signed=False,
                  act_rounding=mode)
        args = (x, taps, s, b if i % 3 else None, qs, qz)
        dev_args = _on(cuda, *args)
        want = tops.quant_depthwise_conv2d_plain(
            *(dev_args if on_card_twin else args), **kw)
        got = tops.quant_depthwise_conv2d(*dev_args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), (mode, geo)
    for k, (in_scale, off_grid) in enumerate(STAGINGS):
        for spec in specs[k]:
            xi = _staged(rng, tuple(x.shape), in_scale, off_grid)
            si = s if spec is None else \
                torch.from_numpy((2 * rng.randint(0, 5, c) + 1).astype(np.int32))
            kw = dict(geo, acc_dtype=torch.int32, in_scale=in_scale)
            if spec is not None:
                kw["requant"] = spec
            card = on_card_twin and in_scale != CS.TINY_SCALE
            dev_args = _on(cuda, xi, taps, si)
            want = tops.quant_depthwise_conv2d_plain(
                *(dev_args if card else (xi, taps, si)), **kw)
            got = tops.quant_depthwise_conv2d(*dev_args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want.cpu()), (in_scale, off_grid, spec, geo)


@pytest.mark.parametrize("geo", range(len(CS.DW_GEOMETRIES)))
def test_depthwise_redesign_geometries_match_twin(cuda, geo):
    """Planes of 1x1, 7x7 and 13x13, C off the planes per block, N = 1, odd
    H at stride 2, asymmetric pads, dilation 2, 5x5 and 1x3 kernels, tiles
    off 16 bytes: every rounding mode, every staging."""
    n, c, h, w, ks, st, dil, pads = CS.DW_GEOMETRIES[geo]
    rng = np.random.RandomState(300 + geo)
    taps = torch.from_numpy(rng.randint(-7, 8, (ks[0] * ks[1], c)).astype(np.int8))
    x = torch.from_numpy((rng.randn(n, c, h, w) * 3).astype(np.float32))
    specs = [(None, INT_SPECS[3 + (geo + k) % 24]) for k in range(len(STAGINGS))]
    _dw_all_bodies(cuda, rng, x, taps, dict(kernel_shape=ks, strides=st,
                                            dilations=dil, pads=pads),
                   MODES, specs, on_card_twin=False)


@pytest.mark.parametrize("layer", range(13))
def test_depthwise_mobilenet_224_layer_all_bodies(cuda, layer):
    """One MobileNet-224 depthwise layer at 8 rows: the float32 body in
    every rounding mode, the integer bodies at every staging."""
    dw = [(cin, st, h) for kind, cin, _, st, h in CS._mobilenet_layers()
          if kind == "dw"]
    cin, st, h = dw[layer]
    rng = np.random.RandomState(400 + layer)
    taps = torch.from_numpy(rng.randint(-8, 8, (9, cin)).astype(np.int8))
    x = torch.randn(CS.SLOT, cin, h, h,
                    generator=torch.Generator().manual_seed(layer))
    specs = [(INT_SPECS[3 + layer],)] * 3 + [(INT_SPECS[1],)]
    _dw_all_bodies(cuda, rng, x, taps, dict(kernel_shape=(3, 3),
                                            strides=(st, st), pads=(1, 1, 1, 1)),
                   MODES, specs, on_card_twin=True)


def test_depthwise_x_off_16_bytes_matches_twin(cuda):
    """x starting 4 bytes past 16: the plans take their scalar staging (no
    16-byte copies) in tile and flat mode alike."""
    rng = np.random.RandomState(600)
    for n, c, h in ((1, 3, 40), (2, 16, 14)):
        buf = torch.randn(n * c * h * h + 1, generator=torch.Generator().manual_seed(h))
        x = buf[1:].view(n, c, h, h)
        taps = torch.from_numpy(rng.randint(-7, 8, (9, c)).astype(np.int8))
        xd = buf.to(cuda)[1:].view(n, c, h, h)
        assert xd.data_ptr() % 16 != 0
        plan = tops.dw_launch_plan(n, c, h, h, h, h, 3, 3, (1, 1), (1, 1),
                                   (1, 1, 1, 1), False)
        assert plan.vec == 0
        geo = dict(kernel_shape=(3, 3), pads=(1, 1, 1, 1))
        want = tops.quant_depthwise_conv2d(x, taps, 0.125, **geo)
        got = tops.quant_depthwise_conv2d(xd, taps.to(cuda), 0.125, **geo)
        xi = _staged(rng, (n, c, h, h), IN_SCALE, False)
        bi = torch.cat([torch.zeros(1), xi.reshape(-1)])
        kw = dict(geo, acc_dtype=torch.int32, in_scale=IN_SCALE)
        want_i = tops.quant_depthwise_conv2d(xi, taps, 0.125, **kw)
        got_i = tops.quant_depthwise_conv2d(bi.to(cuda)[1:].view(n, c, h, h),
                                            taps.to(cuda), 0.125, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want) and torch.equal(got_i.cpu(), want_i)


GQ_CASES = [(i, int4) for i, (_, _, kg, _) in enumerate(CS.GQ_SHAPES)
            for int4 in (False, True) if kg % 2 == 0 or not int4]


@pytest.mark.parametrize("case", GQ_CASES)
def test_grouped_matmul_redesign_shapes_match_twin(cuda, case):
    """Ng 1, 8, 12, 16 and 40, Kg off 4 and above the staged slice, int8 and
    int4: the float32 body exact on dyadic x, the integer bodies at every
    staging torch.equal."""
    i, int4 = case
    g, m, kg, ng = CS.GQ_SHAPES[i]
    rng = np.random.RandomState(500 + i)
    w = torch.from_numpy(rng.randint(-7, 8, (g, kg, ng)).astype(np.int8))
    wk = tops.pack_int4_grouped(w) if int4 else w
    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, g * ng)).astype(np.float32))
    x = torch.from_numpy((rng.randint(-64, 65, (g, m, kg)) / 64.0).astype(np.float32))
    want = tops.quant_grouped_matmul(x, wk, s, packed=int4)
    got = tops.quant_grouped_matmul(*_on(cuda, x, wk, s), packed=int4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for k, (in_scale, off_grid) in enumerate(STAGINGS):
        for spec in (None, INT_SPECS[3 + (i + k) % 24]):
            xi = _staged(rng, (g, m, kg), in_scale, off_grid)
            si = s if spec is None else \
                torch.from_numpy((2 * rng.randint(0, 5, g * ng) + 1).astype(np.int32))
            kw = dict(acc_dtype=torch.int32, in_scale=in_scale, packed=int4)
            if spec is not None:
                kw["requant"] = spec
            want = tops.quant_grouped_matmul(xi, wk, si, **kw)
            got = tops.quant_grouped_matmul(*_on(cuda, xi, wk, si), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (in_scale, off_grid, spec)


def test_staging_counts_follow_the_scale(cuda):
    """Each integer launch of B5 / B6 is counted under the staging its
    scale picks; float32 launches are not counted."""
    x = torch.ones(1, 4, 6, 6, device=cuda) * 0.125
    taps = torch.ones(9, 4, dtype=torch.int8, device=cuda)
    xg = torch.ones(2, 5, 8, device=cuda) * 0.125
    wg = torch.ones(2, 8, 3, dtype=torch.int8, device=cuda)
    before = tops.staging_counts()
    for in_scale in (0.125, IN_SCALE, CS.TINY_SCALE):
        kw = dict(acc_dtype=torch.int32, in_scale=in_scale)
        tops.quant_depthwise_conv2d(x, taps, torch.ones(4, device=cuda),
                                    kernel_shape=(3, 3), **kw)
        tops.quant_grouped_matmul(xg, wg, torch.ones(6, device=cuda), **kw)
    tops.quant_depthwise_conv2d(x, taps, 1.0, kernel_shape=(3, 3))
    tops.quant_grouped_matmul(xg, wg, 1.0)
    after = tops.staging_counts()
    for name in ("quant_depthwise_conv2d", "quant_grouped_matmul"):
        assert {k: after[name][k] - before[name][k] for k in after[name]} == \
            {"reciprocal": 1, "quotient": 1, "division": 1}


# ------------------------- B4 / B1 redesigned: plans, edges and clusters

def _qdq_pair(cuda, x, s, z, **kw):
    """The kernel on the card and the twin on the CPU, same inputs."""
    want = tops.quant_dequant(x, s, z, **kw)
    s, z = torch.as_tensor(s), torch.as_tensor(z)
    got = tops.quant_dequant(*_on(cuda, x, s, z), **kw)
    torch.cuda.synchronize()
    return got.cpu(), want


@pytest.mark.parametrize("mode", MODES)
def test_quant_dequant_edge_values_at_every_scale_kind(cuda, mode):
    """±0, ±inf, NaN, subnormals, ties and clip-bound neighbours at scales
    whose reciprocal multiplies (powers of two) or whose division stays
    (subnormal or overflowing reciprocal, no power of two): equal to the
    twin, NaN as NaN; codes on the finite values."""
    from repro_torch.kernels.quant_dequant import static_bounds
    for scale in CS.QDQ_SCALES:
        x = torch.from_numpy(CS.qdq_edge_x(np, scale if abs(scale) > 2.0 ** -120 else 1.0)
                             .reshape(3, -1))
        for bits, signed, narrow, zp in CS.QDQ_WIDTHS:
            kw = dict(bit_width=bits, signed=signed, narrow=narrow, rounding_mode=mode)
            got, want = _qdq_pair(cuda, x, scale, zp, **kw)
            assert CS.equal_nan(torch, got, want), (scale, kw)
            if static_bounds(signed, narrow, bits)[1] <= 127:
                xc = torch.where(torch.isfinite(x), x, 0.0)
                got, want = _qdq_pair(cuda, xc, scale, zp, emit_codes=True, **kw)
                assert torch.equal(got, want), (scale, kw)


@pytest.mark.parametrize("mode", MODES)
def test_quant_dequant_mixed_per_channel_row(cuda, mode):
    s = torch.tensor(CS.QDQ_MIXED)
    z = torch.tensor([0, 1, -2, 0, 3, 0, 0, -1, 2, 0, 1], dtype=torch.float32)
    x = torch.from_numpy(np.concatenate([CS.qdq_edge_x(np, v) for v in (1.0, 0.125, 0.37)])
                         [:11 * 27].reshape(27, 11))
    x[4] = x[4] * s
    for codes in (False, True):
        xx = torch.where(torch.isfinite(x), x, 0.0) if codes else x
        got, want = _qdq_pair(cuda, xx, s, z, bit_width=4, rounding_mode=mode,
                              emit_codes=codes)
        assert CS.equal_nan(torch, got, want)


@pytest.mark.parametrize("off", [1, 2, 3])
def test_quant_dequant_views_off_16_bytes(cuda, off):
    """Storage offsets of 1-3 elements and numel 1, 3, 5: the scalar head
    and tail; the output keeps x's phase, so the body stores vectors."""
    rng = np.random.RandomState(off)
    for rows, cols in ((1, 1), (1, 3), (1, 5), (7, 13), (33, 130)):
        buf = torch.randn(rows * cols + off, generator=torch.Generator().manual_seed(cols))
        x = buf[off:].view(rows, cols)
        xd = buf.to(cuda)[off:].view(rows, cols)
        s = torch.from_numpy((2.0 ** -rng.randint(1, 5, cols)).astype(np.float32))
        s[::3] = 0.37
        for sc, z in ((0.125, 1.0), (s, torch.from_numpy(rng.randint(-2, 3, cols)
                                                         .astype(np.float32)))):
            for codes in (False, True):
                kw = dict(bit_width=4, rounding_mode="HALF_UP", emit_codes=codes)
                want = tops.quant_dequant(x, sc, z, **kw)
                got = tops.quant_dequant(xd, *_on(cuda, torch.as_tensor(sc),
                                                  torch.as_tensor(z)), **kw)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want)
                if got.numel() > 1:
                    phase = got.data_ptr() // got.element_size() % 4
                    assert phase == xd.data_ptr() // 4 % 4


def test_quant_dequant_beyond_one_grid_sweep(cuda):
    from repro_torch.kernels import quant_dequant as qd
    x = torch.randn(5003, 3501, generator=torch.Generator().manual_seed(2)) * 4
    assert x.numel() > 4 * qd.QDQ_MAX_BLOCKS * qd.QDQ_THREADS * qd.QDQ_UMAX
    s = torch.from_numpy((2.0 ** -np.random.RandomState(0).randint(1, 5, 3501))
                         .astype(np.float32))
    s[1::7] = 0.37
    for sc in (0.125, s):
        got, want = _qdq_pair(cuda, x, sc, 0.0, bit_width=4, emit_codes=True)
        assert torch.equal(got, want)


def _qmm_all_bodies(cuda, m, k, n, int4, x_off=0, seed=0):
    """B1 / B2 (CUDA cores) against the CPU twins: the float32 body exact
    on dyadic x and the same bits on two calls on randn x (within the
    order bound of the twin), the integer bodies torch.equal with B3 in
    every staging of x and with the float32 epilogue.  ``x_off``: x a
    view that many elements off 16 bytes."""
    rng = np.random.RandomState(seed + m + k + n)
    lo, hi = (-8, 7) if int4 else (-127, 127)
    w = torch.from_numpy(rng.randint(lo, hi + 1, (k, n)).astype(np.int8))
    wk = tops.pack_int4(w) if int4 else w
    fn = tops.quant_matmul_int4 if int4 else tops.quant_matmul
    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, n)).astype(np.float32))
    b = torch.from_numpy((rng.randint(-64, 64, n) / 16.0).astype(np.float32))

    def dev_x(x):
        buf = torch.zeros(x.numel() + x_off, device=cuda)
        buf[x_off:] = x.reshape(-1).to(cuda)
        return buf[x_off:].view(x.shape)
    xd = torch.from_numpy((rng.randint(-128, 129, (m, k)) / 128.0).astype(np.float32))
    got = fn(dev_x(xd), *_on(cuda, wk, s, b))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), fn(xd, wk, s, b))
    xr = torch.randn(m, k, generator=torch.Generator().manual_seed(seed))
    xrd = dev_x(xr)
    got, again = fn(xrd, *_on(cuda, wk, s, b)), fn(xrd, *_on(cuda, wk, s, b))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = fn(xr, wk, s, b)
    bound = 2 * k * 2.0 ** -24 * (xr.abs() @ w.float().abs()) * s + 2.0 ** -23 * want.abs()
    assert bool(((got.cpu() - want).abs() <= bound).all())
    for j, (in_scale, off_grid) in enumerate(STAGINGS):
        spec = INT_SPECS[3 + (j + k) % 24]
        mult = torch.from_numpy((2 * rng.randint(0, 5, n) + 1).astype(np.int32))
        xi = _staged(rng, (m, k), in_scale, off_grid)
        kw = dict(acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
        got = fn(dev_x(xi), *_on(cuda, wk, mult), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), fn(xi, wk, mult, **kw)), (in_scale, off_grid, spec)
    xi = _staged(rng, (m, k), 1.0, False)
    got = fn(dev_x(xi), *_on(cuda, wk, s, b), acc_dtype=torch.int32)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), fn(xi, wk, s, b, acc_dtype=torch.int32))


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("split", range(1, 9))
def test_qmm_every_cluster_size(cuda, split, int4):
    from repro_torch.kernels import quant_matmul as qm
    assert qm.qmm_launch_plan(16, 64 * split, 33, int4, 0).split == split
    _qmm_all_bodies(cuda, 16, 64 * split, 33, int4)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,k,n,tile", [(4300, 98, 65, "wide"), (8500, 28, 31, "tall"),
                                        (7200, 26, 64, "wide"), (256, 784, 64, "small")])
def test_qmm_each_tile(cuda, m, k, n, tile, int4):
    from repro_torch.kernels import quant_matmul as qm
    assert qm.QMM_TILE_NAMES[qm.qmm_launch_plan(m, k, n, int4, 0).tile] == tile
    _qmm_all_bodies(cuda, m, k, n, int4)


@pytest.mark.parametrize("m,k,n", CS.QMM_RAGGED)
def test_qmm_ragged_k_and_odd_n(cuda, m, k, n):
    for int4 in (False, True) if k % 2 == 0 else (False,):
        _qmm_all_bodies(cuda, m, k, n, int4)


@pytest.mark.parametrize("off", [1, 3])
@pytest.mark.parametrize("m,k,n", [(256, 784, 64), (16, 27, 33), (100, 130, 9)])
def test_qmm_x_off_16_bytes(cuda, m, k, n, off):
    """x a view off 16 bytes takes the element-wise staging; on randn it
    gives the aligned call's bits (the same sums in the same order)."""
    _qmm_all_bodies(cuda, m, k, n, False, x_off=off)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(off))
    w = torch.from_numpy(np.random.RandomState(off).randint(-127, 128, (k, n))
                         .astype(np.int8)).to(cuda)
    buf = torch.zeros(m * k + off, device=cuda)
    buf[off:] = x.reshape(-1).to(cuda)
    a = tops.quant_matmul(x.to(cuda), w, 0.5)
    b = tops.quant_matmul(buf[off:].view(m, k), w, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_qmm_launch_refuses_a_plan_it_cannot_run(cuda):
    """A geometry the kernel does not take (a cluster of 9, a shared size
    off the kernel's, the gather's x staging without a conv's geometry)
    comes back as a CUDA error, which the wrapper's check raises."""
    import dataclasses
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_matmul as qm
    x = torch.randn(16, 576, device=cuda)
    w = torch.zeros(576, 33, dtype=torch.int8, device=cuda)
    s = torch.ones(1, device=cuda)
    out = torch.empty(16, 33, device=cuda)
    plan = qm.qmm_launch_plan(16, 576, 33, False, 0)
    for bad in (dataclasses.replace(plan, split=9, kc=64),
                dataclasses.replace(plan, smem=plan.smem + 16),
                dataclasses.replace(plan, xmode=qm.QMM_XMODES.index("gather"))):
        err = _build.load().qmm_launch(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), None, out.data_ptr(), bad.ints, 0,
            0, 0, 1.0, 1.0, 0, None, 0.0, None, torch.cuda.current_stream().cuda_stream)
        assert err != 0
        with pytest.raises(RuntimeError):
            _build.check(err, "qmm_launch")


# ------------------------------------------- B2 on the int8 tensor cores

TC_IN_SCALES = {"pow2": 2.0 ** -3, "dyadic": IN_SCALE}


def _tc_case(rng, spec, m, k, n, in_scale, lo=-127, hi=127):
    """x of codes over all of int8, times in_scale; the float32 epilogue's
    scales (spec None) or B3's odd multipliers; keyword arguments."""
    x = torch.from_numpy((rng.randint(lo, hi + 1, (m, k)) * in_scale)
                         .astype(np.float32))
    if spec is None:
        s = torch.from_numpy((2.0 ** -rng.randint(2, 6, n)).astype(np.float32))
        return x, s, dict(acc_dtype=torch.int32, in_scale=in_scale)
    s = torch.from_numpy((2 * rng.randint(0, 5, n) + 1).astype(np.int32))
    return x, s, dict(acc_dtype=torch.int32, requant=spec, in_scale=in_scale)


def _tc_against_twin_and_imad(cuda, x, w, s, b, kw):
    from repro_torch.kernels import quant_matmul as qm
    want = tops.quant_matmul_int4(x, w, s, b, int8_codes=True, **kw)
    before = dict(qm.body_launches)
    xd, wd, sd, bd = _on(cuda, x, w, s, b)
    got = tops.quant_matmul_int4(xd, wd, sd, bd, int8_codes=True, **kw)
    imad = tops.quant_matmul_int4(xd, wd, sd, bd, **kw)
    torch.cuda.synchronize()
    assert qm.body_launches["int8_mma"] == before["int8_mma"] + 1
    assert qm.body_launches["imad"] == before["imad"] + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(imad.cpu(), want)
    return want


@pytest.mark.parametrize("n", [10, 64, 1024])
@pytest.mark.parametrize("k", [32, 784, 1024])
@pytest.mark.parametrize("m", [1, 17, 392])
def test_b2_int8_body_equals_twin_and_imad_body(cuda, m, k, n):
    """Ragged M, N and K, both epilogues (the float32 one and B3 with an
    act Quant), both scale kinds (a power of two: the reciprocal multiply;
    3·2^-5: the division), with and without a bias: torch.equal."""
    rng = np.random.RandomState(m + 3 * k + 7 * n)
    w = tops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (k, n))
                                        .astype(np.int8)))
    for kind, in_scale in TC_IN_SCALES.items():
        for spec in (None, INT_SPECS[5]):
            x, s, kw = _tc_case(rng, spec, m, k, n, in_scale)
            b = torch.randn(n) if kind == "pow2" else None
            _tc_against_twin_and_imad(cuda, x, w, s, b, kw)


@pytest.mark.parametrize("spec", range(len(INT_SPECS)))
def test_b2_int8_body_every_epilogue_and_unaligned_x(cuda, spec):
    """Every integer spec at K = 98 (no 16-byte rows: the element-wise x
    loads) with x starting 4 bytes past an allocation, at K = 32 (the
    body's 32-wide K step) and at the MobileNet pointwise shape 392 x 512
    x 1024."""
    rng = np.random.RandomState(300 + spec)
    for m, k, n in ((37, 98, 70), (45, 32, 64), (392, 512, 1024)):
        x, s, kw = _tc_case(rng, INT_SPECS[spec], m, k, n,
                            TC_IN_SCALES["pow2" if spec % 2 else "dyadic"])
        w = tops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (k, n))
                                            .astype(np.int8)))
        b = torch.randn(n) if spec % 5 == 0 else None
        if k % 4 == 0:
            _tc_against_twin_and_imad(cuda, x, w, s, b, kw)
            continue
        from repro_torch.kernels import quant_matmul as qm
        xd = torch.zeros(m * k + 1, device=cuda)[1:].view(m, k)
        xd.copy_(x)
        assert xd.data_ptr() % 16
        before = qm.body_launches["int8_mma"]
        got = tops.quant_matmul_int4(xd, *_on(cuda, w, s, b), int8_codes=True,
                                     **kw)
        torch.cuda.synchronize()
        assert qm.body_launches["int8_mma"] == before + 1
        assert torch.equal(got.cpu(), tops.quant_matmul_int4(
            x, w, s, b, int8_codes=True, **kw))


@pytest.mark.parametrize("spec", [0, 5, 17])
def test_b2_int8_body_off_grid_x_takes_the_division(cuda, spec):
    """x that is no multiple of the scale (the integer path never stages
    one): random values and exact halves of it, where the exact-quotient
    shortcut does not hold and the body divides; equal to the twin and
    the IMAD body."""
    rng = np.random.RandomState(400 + spec)
    m, k, n = 70, 130, 40
    q = rng.uniform(-120, 120, (m, k))
    q[::3] = np.round(q[::3]) + 0.5
    for in_scale in TC_IN_SCALES.values():
        x = torch.from_numpy((q * in_scale).astype(np.float32))
        _, s, kw = _tc_case(rng, INT_SPECS[spec], m, k, n, in_scale)
        w = tops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (k, n))
                                            .astype(np.int8)))
        _tc_against_twin_and_imad(cuda, x, w, s, None, kw)


def test_b2_int8_body_accumulators_at_the_limit(cuda):
    """Codes -127 / 127 against weights -8 over K = 16510 (ragged in 32):
    sums of +-16,774,160, just below 2**24."""
    k = 16510
    w = torch.from_numpy(np.random.RandomState(9).randint(-8, 8, (k, 5))
                         .astype(np.int8))
    w[:, 0] = -8
    q = torch.from_numpy(np.random.RandomState(10).randint(-127, 128, (3, k))
                         .astype(np.float32))
    q[0], q[1] = -127.0, 127.0
    wk = tops.pack_int4(w)
    for spec in INT_SPECS[:3]:
        kw = dict(acc_dtype=torch.int32, in_scale=IN_SCALE)
        if spec is not None:
            kw["requant"] = spec
        s = torch.ones(1, dtype=torch.float32 if spec is None
                       else torch.int32)
        want = _tc_against_twin_and_imad(cuda, q * IN_SCALE, wk, s, None, kw)
        assert float(want.abs().max()) >= 16774160 * 2.0 ** -9


# ------------------------------------------------------- B7 flash attention

FA_TOL = 2e-5          # float32: the reference's own test bound


def _bf16_ulps(a, b):
    """Distance in bf16 steps between two bf16 tensors (same sign order)."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def assert_attention_close(got, want):
    """float32: within FA_TOL (abs + rel).  bf16: within one bf16 step of
    the twin's result, or within FA_TOL where the two float32 sums (taken
    in other orders) straddle more than one step near zero."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=FA_TOL, rtol=FA_TOL)
        return
    near = (got.float() - want.float()).abs() <= FA_TOL
    assert bool(((_bf16_ulps(got, want) <= 1) | near).all())


def _qkv(seed, B, H, KV, Sq, Sk, hd, dtype, layout="bhsd"):
    g = torch.Generator().manual_seed(seed)
    if layout == "bshd":        # the model's (B, S, H, hd), viewed transposed
        q = torch.randn(B, Sq, H, hd, generator=g).transpose(1, 2)
        k = torch.randn(B, Sk, KV, hd, generator=g).transpose(1, 2)
        v = torch.randn(B, Sk, KV, hd, generator=g).transpose(1, 2)
    else:
        q = torch.randn(B, H, Sq, hd, generator=g)
        k = torch.randn(B, KV, Sk, hd, generator=g)
        v = torch.randn(B, KV, Sk, hd, generator=g)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4)])
def test_flash_attention_kernel_matches_twin(cuda, dtype, hd, causal, H, KV):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    for S in (1, 17, 64, 130):
        q, k, v = _qkv(S, 2, H, KV, S, S, hd, dtype)
        want = fa.flash_attention_plain(*_on(cuda, q, k, v), causal=causal)
        before = fa.launches
        got = fa.flash_attention(*_on(cuda, q, k, v), causal=causal)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert_attention_close(got, want)
        assert_attention_close(want, fa.flash_attention_plain(q, k, v, causal=causal)
                               .to(cuda))


# (H, KV, hd) of the families' prefills: llava-next-34b (G = 7),
# deepseek-moe-16b (G = 1) and whisper-base's decoder (hd 64), at
# llava's S_total = 2880 patches + 128 tokens and one row off it
FAMILY_HEADS = {"llava": (56, 8, 128), "deepseek": (16, 16, 128), "whisper": (8, 8, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [2880 + 128, 2880 + 127])
@pytest.mark.parametrize("model", sorted(FAMILY_HEADS))
def test_flash_attention_family_geometries_match_twin(cuda, model, S, dtype):
    """The models' layout (transposed (B, S, H, hd) views), causal."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    H, KV, hd = FAMILY_HEADS[model]
    q, k, v = _on(cuda, *_qkv(S, 1, H, KV, S, S, hd, dtype, layout="bshd"))
    before = fa.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert_attention_close(got, fa.flash_attention_plain(q, k, v))


def test_flash_attention_kernel_strided_and_ragged(cuda):
    """Transposed (B, S, H, hd) views, a cache slice as k/v, Sq != Sk."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(7, 3, 12, 2, 75, 75, 128, dtype, layout="bshd")
        q, k, v = _on(cuda, q, k, v)
        got = fa.flash_attention(q, k, v)
        assert got.stride() == q.stride()          # written in q's layout
        assert_attention_close(got, fa.flash_attention_plain(q, k, v))
        cache = torch.zeros(3, 90, 2, 128, dtype=dtype, device=cuda)
        cache[:, :75] = k.transpose(1, 2)
        kc = cache[:, :75].transpose(1, 2)         # a strided cache slice
        assert_attention_close(fa.flash_attention(q, kc, v),
                               fa.flash_attention_plain(q, kc, v))
        q2, k2, v2 = _qkv(8, 1, 4, 2, 33, 100, 64, dtype)
        for causal in (False, True):
            assert_attention_close(
                fa.flash_attention(*_on(cuda, q2, k2, v2), causal=causal),
                fa.flash_attention_plain(*_on(cuda, q2, k2, v2), causal=causal))
    torch.cuda.synchronize()


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q, k, v = _on(cuda, *_qkv(0, 1, 4, 2, 8, 8, 48, torch.float32))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _on(cuda, *_qkv(0, 1, 4, 2, 8, 8, 64, torch.float16))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, k, v)
    q, k, v = _on(cuda, *_qkv(0, 1, 4, 2, 8, 8, 64, torch.float32))
    wide = torch.randn(1, 4, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(wide[..., ::2], k, v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :3], k, v)


def test_flash_attention_bf16_rejects_rows_off_16_bytes(cuda):
    """The bf16 body's 16-byte copies: a row stride of 132 elements (264
    bytes) or a base 2 bytes off raises; float32 takes any stride."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q, k, v = _on(cuda, *_qkv(0, 1, 4, 2, 8, 8, 128, torch.bfloat16))
    wide = torch.randn(1, 4, 8, 132, device=cuda).to(torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention(wide, k, v)
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention(q, wide[:, :2], v)
    flat = torch.randn(4 * 8 * 128 + 1, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention(flat[1:].view(1, 4, 8, 128), k, v)
    qf, kf, vf = (t.float() for t in (q, k, v))
    wide32 = torch.randn(1, 4, 8, 130, device=cuda)[..., :128]
    assert_attention_close(fa.flash_attention(wide32, kf, vf),
                           fa.flash_attention_plain(wide32, kf, vf))


# ------------------------------------------- the captured plan (CUDA graph)

def test_captured_plan_replays_distinct_slots_like_the_eager_plan(cuda):
    """TFC-w2a2's plan at one slot shape: one capture, then replays; three
    distinct slots replayed back to back before one sync each equal the
    eager plan's rows (a replay's outputs are copied out before the next
    replay overwrites them)."""
    from repro_torch.core import compile_graph
    from repro_torch.models import zoo
    plan = compile_graph(zoo.build_tfc(2, 2), device=cuda)
    xs = [torch.from_numpy(_acts(s, (16, 784))) for s in range(3)]
    name = plan.graph.output_names[0]
    want = [plan({"x": x}, jit=False)[name] for x in xs]
    t0 = plan.trace_count
    got = [plan({"x": x})[name] for x in xs]
    torch.cuda.synchronize()
    assert plan.trace_count == t0 + 1 and plan.replay_count == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], got[1])


def test_capture_failure_names_the_segment_and_never_falls_back(cuda):
    """A segment that synchronizes cannot be captured: the call raises,
    naming the segment and its ops, and the next call raises again rather
    than running eagerly."""
    from repro_torch.core import compile_graph
    from repro_torch.models import zoo
    plan = compile_graph(zoo.build_tfc(2, 2), device=cuda)
    seg = plan.segments[1]
    run = seg.run

    def syncing(consts, env):
        run(consts, env)
        torch.cuda.synchronize()
    seg.run = syncing
    x = torch.from_numpy(_acts(0, (4, 784)))
    for _ in range(2):
        with pytest.raises(RuntimeError, match=f"segment 1 \\({seg.kind}"):
            plan({"x": x})
    assert plan.replay_count == 0
    seg.run = run
    plan({"x": x}, jit=False)                # the device is still usable
    torch.cuda.synchronize()


def test_flash_attention_refuses_autograd(cuda):
    """B7 has no backward: a call that autograd would differentiate
    raises, and the same call under no_grad (or on inputs that take no
    gradient) launches."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q = torch.randn(1, 2, 16, 16, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        fa.flash_attention(q, k, k)
    with torch.no_grad():
        out = fa.flash_attention(q, k, k)
    assert out.shape == q.shape and not out.requires_grad
    fa.flash_attention(q.detach(), k, k)


def test_train_step_launches_no_b7_while_prefill_does(cuda):
    """A train step (its attention differentiated) runs chunked_attention
    and never launches B7; a prefill of the same model launches it once a
    layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from repro_torch.train import loop
    cfg = get_smoke_config("qwen2-1.5b")
    hyper = loop.TrainHyper()
    state = loop.init_train_state(0, cfg, hyper, cuda)
    batch = api.make_batch(torch.Generator().manual_seed(0), cfg, 2, 16, cuda)
    tops.reset_launch_counts()
    state, m = loop.make_train_step(cfg, hyper)(state, batch)
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == 0
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
    api.prefill(state["params"], batch, cfg, 16)
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == cfg.n_layers


# ------------------------------------ A15: every geometry the search times

# signatures at the zoo's shapes, one per family and body (the tuner's
# rows bucket, exact K / N, B6's geometry)
TUNE_SIGS = [
    dict(family="matmul", rows=256, n=64, k=784, bits=4, requant="int32",
         body="imad"),
    dict(family="matmul", rows=1, n=10, k=64, bits=4, requant="fp32",
         body="f32"),
    dict(family="matmul", rows=256, n=64, k=784, bits=8, requant="fp32",
         body="f32"),
    dict(family="matmul", rows=12544, n=32, k=27, bits=8, requant="int32",
         body="imad"),
    dict(family="matmul", rows=196, n=1024, k=512, bits=4, requant="int32",
         body="int8_mma"),
    dict(family="grouped", rows=196, n=16, k=72, groups=4, bits=8,
         requant="int32"),
    dict(family="grouped", rows=1000, n=40, k=300, groups=8, bits=4,
         requant="fp32"),
    dict(family="depthwise", rows=12544, n=32, k=9, requant="int32",
         geometry=(112, 112, 112, 112, 3, 3, 1, 1, 1, 1, 1, 1, 1, 1)),
    dict(family="depthwise", rows=49, n=1024, k=9, requant="int32",
         geometry=(7, 7, 7, 7, 3, 3, 1, 1, 1, 1, 1, 1, 1, 1)),
    dict(family="depthwise", rows=3136, n=64, k=9, requant="fp32",
         geometry=(112, 112, 56, 56, 3, 3, 2, 2, 1, 1, 1, 1, 1, 1)),
    dict(family="qdq", rows=672, n=224, k=0),
    dict(family="qdq", rows=100352, n=64, k=0),
]


@pytest.mark.parametrize("i", range(len(TUNE_SIGS)))
def test_every_tuning_candidate_equals_the_twin(cuda, tmp_path, i):
    """The heuristic and every candidate the search would time at a zoo
    shape, through the real wrapper with the candidate as its plan's
    override, on integer-valued (dyadic) inputs: torch.equal to the twin."""
    from repro_torch.kernels.requant import IntRequant
    from repro_torch.tune import Autotuner, TuneCache
    tuner = Autotuner(TuneCache(str(tmp_path), persist_executables=False),
                      device=cuda)
    d = dict(TUNE_SIGS[i])
    sig = tuner.sig(d.pop("family"), **d)
    cands = [tuner.heuristic(sig)] + [c for c in tuner.candidates(sig)
                                      if c != tuner.heuristic(sig)]
    assert all(tuner.valid(sig, c) for c in cands)
    rng = np.random.RandomState(i)
    int_path = sig.requant == "int32"
    int_acc = int_path or sig.body in ("imad", "int8_mma")
    in_scale = 0.125 if int_acc else None
    body = dict(acc_dtype=torch.int32 if int_acc else torch.float32,
                requant=IntRequant(shift=6, relu=True, has_act=True,
                                   act_shift=4, act_lo=0, act_hi=15,
                                   act_out_shift=2) if int_path else None,
                in_scale=in_scale)

    def acts(*shape):
        return torch.from_numpy(rng.randint(-8, 8, shape).astype(np.float32)
                                * np.float32(0.125))

    def scale(n):
        if int_path:
            return torch.from_numpy((2 * rng.randint(0, 5, n) + 1).astype(np.int32))
        return torch.from_numpy((2.0 ** -rng.randint(2, 6, n)).astype(np.float32))
    m, n, k = sig.m, sig.n, sig.k
    if sig.family == "matmul":
        x, s = acts(m, k), scale(n)
        w = torch.from_numpy(rng.randint(-7, 8, (k, n)).astype(np.int8))
        if sig.bits == 4:
            w = tops.pack_int4(w)
            fn = functools.partial(tops.quant_matmul_int4,
                                   int8_codes=sig.body == "int8_mma")
        else:
            fn = tops.quant_matmul
        args = (x, w, s)
    elif sig.family == "grouped":
        x = acts(m, sig.groups * k).view(m, sig.groups, k).permute(1, 0, 2)
        w = torch.from_numpy(rng.randint(-7, 8, (sig.groups, k, n)).astype(np.int8))
        packed = sig.bits == 4
        fn = functools.partial(tops.quant_grouped_matmul, packed=packed)
        args = (x, tops.pack_int4_grouped(w) if packed else w,
                scale(sig.groups * n))
    elif sig.family == "depthwise":
        H, W, OH, OW, kh, kw, sh, sw, dh, dw, *pads = sig.geometry
        x = acts(max(1, m // (OH * OW)), n, H, W)
        taps = torch.from_numpy(rng.randint(-7, 8, (kh * kw, n)).astype(np.int8))
        fn = functools.partial(tops.quant_depthwise_conv2d, kernel_shape=(kh, kw),
                               strides=(sh, sw), dilations=(dh, dw), pads=pads)
        args = (x, taps, scale(n))
    else:
        x = torch.from_numpy(_acts(i, (m, n)))
        fn = functools.partial(tops.quant_dequant, bit_width=4)
        args, body = (x, torch.tensor(0.25), torch.tensor(0.0)), {}
    want = fn(*args, **body)
    dev_args = _on(cuda, *args)
    for c in cands:
        got = fn(*dev_args, blocks=c, **body)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (sig, c)
