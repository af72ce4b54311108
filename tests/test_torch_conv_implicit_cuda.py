"""The implicit-GEMM conv on a GPU: ``quant_conv2d`` on the card (B1 / B2
gathering the patches by address and writing NCHW) against B1 / B2 on the
materialised patch matrix (``extract_patches``), reshaped to NCHW, under
``torch.equal``, on every body, eagerly and inside a CUDA-graph replay; and
the conv operand's per-path launch counts of a CNV and a MobileNet plan.
Every test skips without a CUDA device; the file imports neither JAX nor
the reference:

    PYTHONPATH=src python -m pytest -q tests/test_torch_conv_implicit_cuda.py
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compile import compile_graph  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.requant import IntRequant  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402


@pytest.fixture
def cuda():
    """The GPU, or a skip: the kernels have no CPU mode, only plain twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


# (images, C, H, W, O, kernel, strides, pads [t, l, b, r], dilations)
def _cnv(b):
    return [(b, 3, 32, 32, 64, (3, 3), (1, 1), (0, 0, 0, 0), (1, 1)),
            (b, 64, 30, 30, 64, (3, 3), (1, 1), (0, 0, 0, 0), (1, 1)),
            (b, 64, 12, 12, 128, (3, 3), (1, 1), (0, 0, 0, 0), (1, 1)),
            (b, 128, 10, 10, 128, (3, 3), (1, 1), (0, 0, 0, 0), (1, 1)),
            (b, 128, 5, 5, 256, (3, 3), (1, 1), (0, 0, 0, 0), (1, 1)),
            (b, 256, 3, 3, 256, (3, 3), (1, 1), (0, 0, 0, 0), (1, 1))]


CONVS = {
    **{f"cnv{i + 1}_b{b}": c for b in (1, 8, 256) for i, c in enumerate(_cnv(b))},
    **{f"mobilenet1_b{b}": (b, 3, 224, 224, 32, (3, 3), (2, 2), (1, 1, 1, 1), (1, 1))
       for b in (1, 8, 256)},
    "k1_padded": (2, 16, 9, 8, 24, (1, 1), (1, 1), (1, 1, 1, 1), (1, 1)),
    "k5_ragged": (3, 5, 11, 13, 17, (5, 5), (1, 1), (2, 2, 2, 2), (1, 1)),
    "k5_even": (2, 6, 9, 9, 40, (5, 5), (1, 1), (2, 2, 2, 2), (1, 1)),
    "stride2": (2, 8, 15, 15, 40, (3, 3), (2, 2), (1, 1, 1, 1), (1, 1)),
    "dilation2": (2, 8, 12, 12, 24, (3, 3), (1, 1), (2, 2, 2, 2), (2, 2)),
    "asym_pads": (3, 6, 10, 9, 20, (3, 3), (1, 2), (2, 0, 1, 1), (1, 1)),
    "ragged_mnk": (5, 7, 13, 11, 70, (2, 3), (1, 1), (0, 1, 1, 0), (1, 1)),
    "deep_k_split": (1, 130, 6, 6, 33, (3, 3), (1, 1), (1, 1, 1, 1), (1, 1)),
}

# (packed weights, body): B1 (int8 weights) and B2 (int4 packing) on the
# float32 body, the IMAD body (int32 dot, float32 epilogue or B3) and B2's
# int8 tensor-core body; the quotient staging where in_scale is no power of 2
BODIES = {
    "b1_f32": (False, dict(acc_dtype=torch.float32)),
    "b1_imad": (False, dict(acc_dtype=torch.int32, in_scale=0.25)),
    "b1_b3": (False, dict(acc_dtype=torch.int32, in_scale=0.3, requant=True)),
    "b2_f32": (True, dict(acc_dtype=torch.float32)),
    "b2_imad_b3": (True, dict(acc_dtype=torch.int32, in_scale=0.25, requant=True)),
    "int8_mma": (True, dict(acc_dtype=torch.int32, in_scale=0.3, int8_codes=True)),
    "int8_mma_b3": (True, dict(acc_dtype=torch.int32, in_scale=0.25, requant=True,
                               int8_codes=True)),
}

CASES = [(c, b) for c in CONVS for b in BODIES
         if not BODIES[b][0] or CONVS[c][1] * CONVS[c][5][0] * CONVS[c][5][1] % 2 == 0]


def _operands(case, body, device):
    n, c, h, w, o, ks, st, pads, dil = CONVS[case]
    packed, kw = BODIES[body]
    kw = dict(kw)
    rng = np.random.RandomState(zlib.crc32(f"{case}-{body}".encode()))
    k = c * ks[0] * ks[1]
    if kw["acc_dtype"] == torch.int32:
        # integer multiples of in_scale, codes in int8
        x = rng.randint(-8, 8, (n, c, h, w)).astype(np.float32) * np.float32(kw["in_scale"])
        s = rng.randint(1, 9, o).astype(np.int32 if kw.get("requant") else np.float32)
    else:
        x = rng.randn(n, c, h, w).astype(np.float32)
        s = (rng.rand(o) + 0.5).astype(np.float32)
    if kw.get("requant"):
        kw["requant"] = IntRequant(shift=8, relu=True, has_act=True, act_shift=4,
                                   act_lo=0, act_hi=15, act_out_shift=2)
    wi = torch.from_numpy(rng.randint(-7, 8, (k, o)).astype(np.int8))
    wt = tops.pack_int4(wi) if packed else wi
    bias = torch.from_numpy(rng.randn(o).astype(np.float32))
    geo = dict(kernel_shape=ks, strides=st, pads=pads, dilations=dil)
    return (torch.from_numpy(x).to(device), wt.to(device), torch.from_numpy(s).to(device),
            bias.to(device), packed, kw, geo)


def _materialised(x, wt, s, bias, packed, kw, geo):
    patches, (oh, ow) = tops.extract_patches(x, **geo)
    mm = tops.quant_matmul_int4 if packed else tops.quant_matmul
    y = mm(patches, wt, s, bias, **kw)
    return y.reshape(x.shape[0], oh, ow, -1).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("case,body", CASES, ids=[f"{c}-{b}" for c, b in CASES])
def test_implicit_conv_equals_the_patch_matrix_path(cuda, case, body):
    x, wt, s, bias, packed, kw, geo = _operands(case, body, cuda)
    assert tops.conv_operand(geo["kernel_shape"], geo["pads"], cuda) == "implicit"
    tops.reset_launch_counts()
    got = tops.quant_conv2d(x, wt, s, bias, packed=packed, **kw, **geo)
    assert tops.conv_operand_counts() == {"implicit": 1, "materialised": 0}
    assert tops.b2_body_counts()["int8_mma"] == int(bool(kw.get("int8_codes")))
    want = _materialised(x, wt, s, bias, packed, kw, geo)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(tops.quant_conv2d(x, wt, s, bias, packed=packed, **kw, **geo), got)

    # the same launch inside a CUDA graph, replayed on another input
    static_x = x.clone()
    tops.quant_conv2d(static_x, wt, s, bias, packed=packed, **kw, **geo)     # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_y = tops.quant_conv2d(static_x, wt, s, bias, packed=packed, **kw, **geo)
    x2 = torch.flip(x, dims=(2,)).contiguous()
    static_x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_y, _materialised(x2, wt, s, bias, packed, kw, geo))


@pytest.mark.parametrize("key,implicit,materialised", [("CNV-w2a2", 6, 0),
                                                       ("MobileNet-w4a4", 1, 13)])
def test_plan_conv_operand_counts(cuda, key, implicit, materialised):
    """An eager plan call counts each conv once by its operand's path: all
    six of CNV's 3x3 convs gather, MobileNet's first conv gathers and its
    13 unpadded pointwise convs keep the patch matrix (its depthwise convs
    run B6); the segments' meta says the same.  The card's outputs are the
    CPU plan's: bit for bit on CNV (integer sums), and within float32
    rounding on MobileNet, whose average pool and float32 MatMul sum in
    another order on the card."""
    g = tzoo.ZOO[key]()
    if key.startswith("MobileNet"):
        tzoo.rescale_conv_gains(g)
    plan = compile_graph(g, device=cuda)
    ops = [s.meta["conv_operand"] for s in plan.segments if "conv_operand" in s.meta]
    assert (ops.count("implicit"), ops.count("materialised")) == (implicit, materialised)
    shape = (2,) + tuple(g.get_shape(g.input_names[0])[1:])
    x = torch.from_numpy(np.random.RandomState(5).randn(*shape).astype(np.float32))
    tops.reset_launch_counts()
    (name,) = g.output_names
    got = plan({g.input_names[0]: x.to(cuda)}, jit=False)[name]
    assert tops.conv_operand_counts() == {"implicit": implicit,
                                          "materialised": materialised}
    cpu = compile_graph(g, device="cpu")({g.input_names[0]: x})[name]
    if key.startswith("CNV"):
        assert torch.equal(got.cpu(), cpu)
    else:
        assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * float(cpu.abs().max())
