"""The port's compiled plan against the reference's compiled plan and both
oracles, on the CPU (where every kernel runs its plain twin).

TFC is held **bit-exact**: the zoo's scales are powers of two, so every
activation is a small multiple of a dyadic step and every weight a small
integer; each float32 partial sum of a layer is then exactly
representable (|sum| < 2**24 grid steps), whatever order the reference's
dot or the port's sums it in.  The reference plan is compiled as
``compile_graph(use_analysis=False, use_fusion=False)``, the fp32-epilogue
tier the first slice ported; the port's plans here pass
``use_analysis=False, use_fusion=False`` too (fusion, the default, is held
by tests/test_torch_fusion.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GraphBuilder as RBuilder  # noqa: E402
from repro.core import execute as r_execute  # noqa: E402
from repro.core import transforms as rtr  # noqa: E402
from repro.core.compile import compile_graph as r_compile  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import GraphBuilder as TBuilder  # noqa: E402
from repro_torch.core import execute as t_execute  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.core.compile import compile_graph  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

# the fp32-epilogue tier these tests hold; the analysis-driven integer
# default of compile_graph is held by tests/test_torch_requant.py
t_compile = functools.partial(compile_graph, use_analysis=False,
                              use_fusion=False)

TFC = ["TFC-w1a1", "TFC-w1a2", "TFC-w2a2"]


def _out(result, g):
    v = result[g.output_names[0]]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("use_int4", [True, False])
@pytest.mark.parametrize("key", TFC)
def test_tfc_plan_bit_exact_against_reference(key, use_int4):
    x = np.random.RandomState(4).randn(7, 784).astype(np.float32)
    g_ref, g_port = rzoo.ZOO[key](), tzoo.ZOO[key]()
    r_plan = r_compile(g_ref, use_analysis=False, use_fusion=False,
                       use_int4=use_int4)
    t_plan = t_compile(g_port, device="cpu", use_int4=use_int4)
    assert t_plan.fused_counts == r_plan.fused_counts
    assert t_plan.interp_op_counts() == r_plan.interp_op_counts()
    assert t_plan.n_fused_nodes == r_plan.n_fused_nodes
    got = _out(t_plan({"x": x}), g_port)
    np.testing.assert_array_equal(got, _out(r_plan({"x": x}), g_ref))
    np.testing.assert_array_equal(
        got, _out(r_execute(rtr.cleanup(g_ref), {"x": x}), g_ref))
    np.testing.assert_array_equal(
        got, _out(t_execute(ttr.cleanup(g_port), {"x": x}, device="cpu"),
                  g_port))


def test_tfc_fused_counts_match_the_slice_census():
    want = {("TFC-w2a2", True): {"quant_dequant": 4, "quant_matmul_int4": 4,
                                 "interp": 3},
            ("TFC-w1a1", True): {"quant_dequant": 1, "quant_matmul_int4": 4,
                                 "interp": 3},
            ("TFC-w1a1", False): {"quant_dequant": 1, "quant_matmul": 4,
                                  "interp": 3}}
    for (key, int4), counts in want.items():
        plan = t_compile(tzoo.ZOO[key](), device="cpu", use_int4=int4)
        assert plan.fused_counts == counts


def test_cpu_plan_makes_no_kernel_launch():
    tops.reset_launch_counts()
    plan = t_compile(tzoo.build_tfc(2, 2), device="cpu")
    plan({"x": np.zeros((2, 784), np.float32)})
    assert set(tops.launch_counts().values()) == {0}


def _affine_tail_graph(builder, gemm=False):
    """Quant(w) -> MatMul/Gemm -> Mul(descale) -> Add(bias), tie-free."""
    rng = np.random.RandomState(5)
    b = builder("affine")
    x = b.add_input("x", (3, 8))
    h = b.quant(x, 0.25, 0.0, 4)
    w = b.add_initializer("w", rng.randn(8, 6).astype(np.float32))
    qw = b.quant(w, 0.125, 0.0, 4, narrow=True)
    (h,) = b.add_node("Gemm" if gemm else "MatMul", [h, qw], 1)
    d = b.add_initializer("d", (2.0 ** -rng.randint(0, 3, 6))
                          .astype(np.float32))
    (h,) = b.add_node("Mul", [h, d], 1)
    c = b.add_initializer("c", (rng.randint(-8, 8, 6) / 4.0)
                          .astype(np.float32))
    (h,) = b.add_node("Add", [h, c], 1)
    b.mark_output(h)
    return b.build()


def _qcdq_graph(builder):
    """QCDQ weights and a QuantizeLinear -> Clip -> DequantizeLinear
    activation chain."""
    rng = np.random.RandomState(6)
    b = builder("qcdq")
    x = b.add_input("x", (4, 10))
    s = b.add_initializer("s", np.asarray(0.25, np.float32))
    zp = b.add_initializer("zp", np.asarray(0, np.int8))
    (q,) = b.add_node("QuantizeLinear", [x, s, zp], 1)
    lo = b.add_initializer("lo", np.asarray(-8, np.int8))
    hi = b.add_initializer("hi", np.asarray(7, np.int8))
    (c,) = b.add_node("Clip", [q, lo, hi], 1)
    (a,) = b.add_node("DequantizeLinear", [c, s, zp], 1)
    w = b.add_initializer("w", rng.randn(10, 5).astype(np.float32))
    ws = b.add_initializer("ws", np.asarray(0.5, np.float32))
    (wq,) = b.add_node("QuantizeLinear", [w, ws, zp], 1)
    (wc,) = b.add_node("Clip", [wq, lo, hi], 1)
    (wd,) = b.add_node("DequantizeLinear", [wc, ws, zp], 1)
    (y,) = b.add_node("MatMul", [a, wd], 1)
    b.mark_output(y)
    return b.build()


@pytest.mark.parametrize("build", [
    _affine_tail_graph, lambda B: _affine_tail_graph(B, gemm=True),
    _qcdq_graph], ids=["matmul_mul_add", "gemm_mul_add", "qcdq"])
@pytest.mark.parametrize("use_int4", [True, False])
def test_rule_coverage_matches_reference(build, use_int4):
    x = np.random.RandomState(8).randn(*build(TBuilder).inputs[0].shape) \
        .astype(np.float32) * 2
    g_ref, g_port = build(RBuilder), build(TBuilder)
    r_plan = r_compile(g_ref, use_analysis=False, use_fusion=False,
                       use_int4=use_int4)
    t_plan = t_compile(g_port, device="cpu", use_int4=use_int4)
    assert t_plan.fused_counts == r_plan.fused_counts
    assert t_plan.n_fused_nodes == r_plan.n_fused_nodes
    np.testing.assert_array_equal(_out(t_plan({"x": x}), g_port),
                                  _out(r_plan({"x": x}), g_ref))


def test_use_kernels_false_is_all_interpreted():
    plan = t_compile(tzoo.build_tfc(2, 2), device="cpu", use_kernels=False)
    assert set(plan.fused_counts) == {"interp"}
    x = np.random.RandomState(9).randn(3, 784).astype(np.float32)
    ref = t_compile(tzoo.build_tfc(2, 2), device="cpu")({"x": x})
    np.testing.assert_array_equal(_out(plan({"x": x}), plan.graph),
                                  _out(ref, plan.graph))


@pytest.mark.parametrize("kw,exc,item", [
    # tune= is ported (tests/test_torch_tune.py): a bad mode is refused,
    # and a good one masks no raise
    ({"tune": "aggressive"}, ValueError, "tune"),
    # mesh= is ported (tests/test_torch_mesh_serve.py): it excludes
    # device=, and anything but a Mesh or "auto" is refused
    ({"tune": "cached", "mesh": "auto"}, ValueError, "mesh= / device="),
    ({"mesh": object()}, TypeError, "Mesh"),
    ({"interpret": True}, ValueError, "interpret"),
])
def test_unported_flags_raise(kw, exc, item):
    with pytest.raises(exc, match=item):
        t_compile(tzoo.build_tfc(1, 1), device="cpu", **kw)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert t_compile(tzoo.build_tfc(1, 1)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_compile(tzoo.build_tfc(1, 1))
