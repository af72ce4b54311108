"""The port's im2col conv tier against the reference, on the CPU.

Kernel level: the im2col glue (``im2col_weights``, ``extract_patches``)
is bit-exact, and ``quant_conv2d`` (the plain twins of B1 / B2 behind it)
is bit-exact against the reference's ``quant_conv2d`` (its Pallas kernels
in interpret mode) on dyadic inputs, where every float32 partial sum is
exact whatever the summation order.

Zoo level: CNV-w1a1 and CNV-w2a2 compiled with both ``use_int4`` values
have the reference's segment census and are bit-exact against the
reference plan and both oracles (the zoo's scales are powers of two).
Each reference plan is compiled once per module.

Also the GlobalAveragePool / ReduceMean oracle ops, bit-exact against the
reference's ``jnp.mean`` (which XLA computes as the sum times the float32
reciprocal of the count) on a 7x7 map, where the count 49 is not a power
of two.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import GraphBuilder as RBuilder  # noqa: E402
from repro.core import execute as r_execute  # noqa: E402
from repro.core import transforms as rtr  # noqa: E402
from repro.core.compile import compile_graph as r_compile  # noqa: E402
from repro.kernels import quant_conv as rconv  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import GraphBuilder as TBuilder  # noqa: E402
from repro_torch.core import execute as t_execute  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.core.compile import compile_graph  # noqa: E402
from repro_torch.core.lowering import rules_for  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_conv as tconv  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

# the fp32-epilogue tier these tests hold, with float32 boundaries; the
# analysis-driven integer default of compile_graph is held by
# tests/test_torch_requant.py, fusion (the default) by
# tests/test_torch_fusion.py
t_compile = functools.partial(compile_graph, use_analysis=False,
                              use_fusion=False)

# the reference's census of its use_analysis=False, use_fusion=False plans
CNV_CENSUS = {
    ("CNV-w1a1", True): {"quant_dequant": 1, "quant_conv": 1,
                         "quant_conv_int4": 5, "quant_matmul_int4": 3,
                         "interp": 8},
    ("CNV-w1a1", False): {"quant_dequant": 1, "quant_conv": 6,
                          "quant_matmul": 3, "interp": 8},
    ("CNV-w2a2", True): {"quant_dequant": 3, "quant_conv": 1,
                         "quant_conv_int4": 5, "quant_matmul_int4": 3,
                         "interp": 5},
    ("CNV-w2a2", False): {"quant_dequant": 3, "quant_conv": 6,
                          "quant_matmul": 3, "interp": 5},
}
CNV_INTERP = {
    "CNV-w1a1": {"BipolarQuant": 8, "MaxPool": 2, "Flatten": 1, "Relu": 2},
    "CNV-w2a2": {"MaxPool": 2, "Flatten": 1, "Relu": 2},
}

# (kernel, stride, ONNX pads [t, l, b, r], dilation)
GEOMETRIES = [
    ((3, 3), (1, 1), (0, 0, 0, 0), (1, 1)),
    ((3, 3), (2, 2), (1, 1, 1, 1), (1, 1)),
    ((3, 3), (1, 2), (2, 0, 1, 1), (1, 1)),        # asymmetric pads
    ((3, 3), (1, 1), (1, 1, 1, 1), (2, 2)),        # dilated
    ((1, 1), (1, 1), (0, 0, 0, 0), (1, 1)),        # pointwise
    ((1, 1), (2, 2), (0, 0, 0, 0), (1, 1)),        # strided pointwise
    ((2, 3), (1, 1), (0, 1, 1, 0), (1, 1)),
]
GEOM_IDS = ["k3", "k3_s2_p1", "k3_asym", "k3_d2", "pw", "pw_s2", "k23"]


def _dyadic(rng, shape, step=1 / 8, lim=64):
    return (rng.randint(-lim, lim + 1, shape) * step).astype(np.float32)


def _out(result, g):
    v = result[g.output_names[0]]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------- glue

@pytest.mark.parametrize("groups", [1, 2, 3])
def test_im2col_weights_bit_exact(groups):
    w = np.random.RandomState(groups).randint(
        -7, 8, (6, 12 // groups, 3, 2)).astype(np.int8)
    got = tconv.im2col_weights(w, groups)
    want = rconv.im2col_weights(w, groups)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ks,st,pads,dil", GEOMETRIES, ids=GEOM_IDS)
def test_extract_patches_bit_exact(ks, st, pads, dil):
    x = np.random.RandomState(1).randn(2, 3, 9, 8).astype(np.float32)
    want, want_hw = rconv.extract_patches(jnp.asarray(x), ks, st, pads, dil)
    got, got_hw = tconv.extract_patches(torch.from_numpy(x), ks, st, pads,
                                        dil)
    assert got_hw == tuple(want_hw) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ks,st,pads,dil", GEOMETRIES, ids=GEOM_IDS)
@pytest.mark.parametrize("int4", [False, True])
def test_quant_conv2d_bit_exact_on_dyadic(ks, st, pads, dil, int4):
    rng = np.random.RandomState(sum(ks) + st[1] + sum(pads))
    cin, cout = 4, 6
    x = _dyadic(rng, (2, cin, 9, 8))
    w = rng.randint(-7, 8, (cout, cin) + ks).astype(np.int8)
    s = (2.0 ** -rng.randint(2, 6, cout)).astype(np.float32)
    b = (rng.randint(-32, 32, cout) / 16.0).astype(np.float32)
    w2 = tconv.im2col_weights(w)              # K = 4·kH·kW, even
    kw = dict(kernel_shape=ks, strides=st, pads=pads, dilations=dil,
              packed=int4)
    wt = tops.pack_int4(torch.from_numpy(w2)) if int4 else \
        torch.from_numpy(w2)
    want = rconv.quant_conv2d(jnp.asarray(x), jnp.asarray(wt.numpy()),
                              jnp.asarray(s), jnp.asarray(b), **kw)
    got = tconv.quant_conv2d(torch.from_numpy(x), wt, torch.from_numpy(s),
                             torch.from_numpy(b), **kw)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ks,st,pads,dil", GEOMETRIES, ids=GEOM_IDS)
def test_gather_geometry_reproduces_extract_patches(ks, st, pads, dil):
    """The implicit GEMM's host geometry (row bases, tap offsets, bounds),
    applied by a torch gather, is the patch matrix bit for bit, padding
    taps exact zeros; the kernels' walk of the columns by carries is the
    direct (c, kh, kw) decomposition."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 9, 8)
                         .astype(np.float32))
    want, hw = tconv.extract_patches(x, ks, st, pads, dil)
    geo = tconv.conv_gather(tuple(x.shape), ks, st, pads, dil)
    assert (geo.OH, geo.OW) == hw and (geo.M, geo.K) == tuple(want.shape)
    got = tconv.gather_patches(x, geo)
    assert torch.equal(got, want)
    assert not torch.signbit(got[got == 0]).any()
    off, dy, dx = tconv.gather_taps(geo)
    k = torch.arange(geo.K)
    c, t = k // (geo.kh * geo.kw), k % (geo.kh * geo.kw)
    assert torch.equal(dy, t // geo.kw * geo.dh)
    assert torch.equal(dx, t % geo.kw * geo.dw)
    assert torch.equal(off, c * geo.H * geo.W + dy * geo.W + dx)
    implicit = ks[0] * ks[1] > 1 or any(pads)
    assert tconv.conv_operand(ks, pads, "cuda") == \
        ("implicit" if implicit else "materialised")
    assert tconv.conv_operand(ks, pads, "cpu") == "materialised"


def test_quant_conv2d_twin_makes_no_launch():
    tops.reset_launch_counts()
    w2 = torch.ones(9, 2, dtype=torch.int8)
    tconv.quant_conv2d(torch.ones(1, 1, 5, 5), w2, 0.5, kernel_shape=(3, 3))
    assert set(tops.launch_counts().values()) == {0}
    assert set(tops.conv_operand_counts().values()) == {0}


def test_conv_rules_in_priority_order():
    assert [r.name for r in rules_for("Conv")] == ["quant_grouped_conv",
                                                   "quant_conv"]


# ------------------------------------------------------------- CNV zoo

@pytest.fixture(scope="module")
def cnv_reference():
    """One reference plan and one oracle run per (graph, use_int4)."""
    x = np.random.RandomState(11).randn(2, 3, 32, 32).astype(np.float32)
    out = {}
    for key, int4 in CNV_CENSUS:
        g = rzoo.ZOO[key]()
        plan = r_compile(g, use_analysis=False, use_fusion=False,
                         use_int4=int4)
        out[(key, int4)] = (plan.fused_counts, plan.interp_op_counts(),
                            plan.n_fused_nodes, _out(plan({"x": x}), g))
        out[key] = _out(r_execute(rtr.cleanup(g), {"x": x}), g)
    return x, out


@pytest.mark.parametrize("key,int4", list(CNV_CENSUS),
                         ids=[f"{k}-int4={i}" for k, i in CNV_CENSUS])
def test_cnv_plan_bit_exact_against_reference(cnv_reference, key, int4):
    x, ref = cnv_reference
    counts, interp, n_fused, r_out = ref[(key, int4)]
    g = tzoo.ZOO[key]()
    plan = t_compile(g, device="cpu", use_int4=int4)
    assert plan.fused_counts == counts == CNV_CENSUS[(key, int4)]
    assert plan.interp_op_counts() == interp == CNV_INTERP[key]
    assert plan.n_fused_nodes == n_fused
    assert plan.grouped_conv_stats() == {
        "grouped_segments": 0, "block_diagonal_grouped": 0,
        "reclaimed_macs": 0, "carrier_bytes_saved": 0}
    assert {s.meta["conv_operand"] for s in plan.segments
            if s.kind.startswith("quant_conv")} == {"materialised"}
    got = _out(plan({"x": x}), g)
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got, r_out)
    np.testing.assert_array_equal(got, ref[key])
    np.testing.assert_array_equal(
        got, _out(t_execute(ttr.cleanup(g), {"x": x}, device="cpu"), g))


# ------------------------------------------------ pools in the oracle

def _pool_graph(builder, op, attrs):
    b = builder("pool")
    x = b.add_input("x", (3, 5, 7, 7))
    (h,) = b.add_node(op, [x], 1, attrs)
    b.mark_output(h)
    return b.build()


@pytest.mark.parametrize("op,attrs", [
    ("GlobalAveragePool", {}),
    ("ReduceMean", {"axes": [2, 3], "keepdims": 1}),
    ("ReduceMean", {"axes": [-1], "keepdims": 0}),
    ("ReduceMean", {}),
], ids=["gap", "reduce_hw", "reduce_last", "reduce_all"])
def test_mean_ops_bit_exact_on_dyadic(op, attrs):
    """A 7x7 mean scales by 1/49, which is not dyadic: dividing by 49
    (as ``torch.mean`` does on the CPU) is 1 ulp off the reference's
    multiply by float32(1/49) on about half of these entries."""
    x = _dyadic(np.random.RandomState(3), (3, 5, 7, 7), 1 / 8, 15)
    want = _out(r_execute(_pool_graph(RBuilder, op, attrs), {"x": x}),
                _pool_graph(RBuilder, op, attrs))
    g = _pool_graph(TBuilder, op, attrs)
    got = _out(t_execute(g, {"x": x}, device="cpu"), g)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
