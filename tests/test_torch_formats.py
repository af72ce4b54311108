"""The paper's formats and the rest of ``core`` in the port, against the
reference, on the CPU.

  * ``qonnx_to_qcdq``, ``qcdq_to_qonnx`` (the round trip) and
    ``qonnx_to_quantized_op`` write the reference's graphs: the same nodes,
    attributes and initializers (dtypes and values), compared as
    ``core/serialize.py`` JSON;
  * ``streamline`` (``propagate_dequant``, ``_fold_adjacent_muls``,
    ``quant_to_multithreshold``), ``to_channels_last`` and ``export_mlp``
    likewise, and the graphs they write compute what the reference's do;
  * every name of the port's ``PIPELINES`` runs, with the reference's
    result (or the reference's error) on the same graphs;
  * the port's compiled QCDQ and QOp plans against its oracle, as
    tests/test_compile.py holds the reference's.

Both packages start from the same graph: the reference's builders' graph
through one JSON round trip (which turns 0-d initializers 1-d in both).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GraphBuilder as RBuilder  # noqa: E402
from repro.core import execute as r_execute  # noqa: E402
from repro.core import formats as rfmt  # noqa: E402
from repro.core import serialize as rser  # noqa: E402
from repro.core import streamline as rstr  # noqa: E402
from repro.core import transforms as rtr  # noqa: E402
from repro.core.export import export_mlp as r_export  # noqa: E402
from repro.core.passes import PIPELINES as R_PIPELINES  # noqa: E402
from repro.core.passes import run_pipeline as r_run  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro.quantize.config import QuantRecipe as RRecipe  # noqa: E402
from repro_torch.core import compile_graph as t_compile  # noqa: E402
from repro_torch.core import execute as t_execute  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core import passes as tpasses  # noqa: E402
from repro_torch.core import serialize as tser  # noqa: E402
from repro_torch.core import streamline as tstr  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.core.export import export_mlp as t_export  # noqa: E402
from repro_torch.quantize.config import QuantRecipe as TRecipe  # noqa: E402
from test_graph import make_mlp_graph  # noqa: E402
from test_streamline import make_qcdq_mlp  # noqa: E402
from test_transforms import make_cnv_block  # noqa: E402


def _pair(g):
    """The same graph in both packages (one JSON round trip each)."""
    d = rser.graph_to_json(g)
    return rser.graph_from_json(d), tser.graph_from_json(d)


def _same(t_graph, r_graph):
    assert tser.graph_to_json(t_graph) == rser.graph_to_json(r_graph)


def _r_run(g, x):
    return np.asarray(r_execute(g, {g.input_names[0]: x})[g.output_names[0]])


def _t_run(g, x):
    return t_execute(g, {g.input_names[0]: x},
                     device="cpu")[g.output_names[0]].numpy()


GRAPHS = {
    "TFC-w2a2": lambda: rzoo.build_tfc(2, 2),
    "TFC-w1a1": lambda: rzoo.build_tfc(1, 1),
    "CNV-w2a2": lambda: rzoo.build_cnv(2, 2),
    "mlp": make_mlp_graph,
    "cnv_block": make_cnv_block,
    "qcdq_mlp": lambda: rfmt.qonnx_to_qcdq(make_qcdq_mlp()),
}


def test_feature_matrix_is_the_references():
    assert tfmt.FEATURE_MATRIX.keys() == rfmt.FEATURE_MATRIX.keys()
    for k, v in rfmt.FEATURE_MATRIX.items():
        assert tfmt.FEATURE_MATRIX[k].__dict__ == v.__dict__, k


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 7, 8])
def test_integer_bounds_are_the_references(bits, narrow, signed):
    """Eqs. 2-3 as Python numbers equal the reference's ``quant_ops``."""
    from repro.core import quant_ops as rq
    assert tfmt.min_int(signed, narrow, bits) == \
        float(rq.min_int(signed, narrow, bits))
    assert tfmt.max_int(signed, narrow, bits) == \
        float(rq.max_int(signed, narrow, bits))
    for lo, hi in ((tfmt.min_int(signed, narrow, bits),
                    tfmt.max_int(signed, narrow, bits)), (-3.0, 5.0)):
        assert tfmt.bitwidth_from_bounds(lo, hi, signed) == \
            rfmt.bitwidth_from_bounds(lo, hi, signed)


@pytest.mark.parametrize("key", ["TFC-w2a2", "CNV-w2a2", "mlp", "cnv_block"])
def test_qcdq_round_trip_matches_reference(key):
    """QONNX -> QCDQ -> QONNX on the compile-prep graph: both directions
    write the reference's graph, and the QCDQ graph computes the QONNX
    graph's values on the port's oracle."""
    r_g, t_g = _pair(GRAPHS[key]())
    r_g, t_g = r_run(r_g, "compile_prep"), tpasses.run_pipeline(
        t_g, "compile_prep")
    r_q, t_q = rfmt.qonnx_to_qcdq(r_g), tfmt.qonnx_to_qcdq(t_g)
    _same(t_q, r_q)
    assert any(n.op_type == "Clip" for n in t_q.nodes)
    _same(tfmt.qcdq_to_qonnx(t_q), rfmt.qcdq_to_qonnx(r_q))
    shape = tuple(d or 1 for d in t_g.inputs[0].shape)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(_t_run(t_q, x), _t_run(t_g, x))


@pytest.mark.parametrize("key", ["TFC-w2a2", "mlp"])
def test_quantized_op_matches_reference(key):
    r_g, t_g = _pair(GRAPHS[key]())
    r_g, t_g = r_run(r_g, "compile_prep"), tpasses.run_pipeline(
        t_g, "compile_prep")
    r_o, t_o = rfmt.qonnx_to_quantized_op(r_g), tfmt.qonnx_to_quantized_op(t_g)
    _same(t_o, r_o)
    assert any(n.op_type == "MatMulInteger" for n in t_o.nodes)
    shape = tuple(d or 1 for d in t_g.inputs[0].shape)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(_t_run(t_o, x), _r_run(r_o, x))


def test_formats_raise_the_references_errors():
    """The Table I envelope: the same graphs are refused with the same
    messages."""
    GraphBuilder = RBuilder
    cases = []
    b = GraphBuilder("wide")
    x = b.add_input("x", (2, 4))
    b.mark_output(b.quant(x, 0.1, 0.0, 12))
    cases.append((b.build(), "qonnx_to_qcdq"))
    b = GraphBuilder("rmode")
    x = b.add_input("x", (2, 4))
    b.mark_output(b.quant(x, 0.1, 0.0, 4, rounding_mode="FLOOR"))
    cases.append((b.build(), "qonnx_to_qcdq"))
    b = GraphBuilder("bipolar")
    x = b.add_input("x", (2, 4))
    b.mark_output(b.bipolar_quant(x, 1.0))
    cases.append((b.build(), "qonnx_to_qcdq"))
    b = GraphBuilder("weights_only")
    x = b.add_input("x", (2, 4))
    w = b.quant(b.add_initializer("w", np.ones((4, 3), np.float32)), 0.1,
                0.0, 4)
    (y,) = b.add_node("MatMul", [x, w], 1)
    b.mark_output(y)
    cases.append((b.build(), "qonnx_to_quantized_op"))
    for g, fn in cases:
        r_g, t_g = _pair(g)
        with pytest.raises(rfmt.UnsupportedLowering) as want:
            getattr(rfmt, fn)(r_g)
        with pytest.raises(tfmt.UnsupportedLowering, match="") as got:
            getattr(tfmt, fn)(t_g)
        assert str(got.value) == str(want.value)


def test_streamline_matches_reference():
    # hls4ml: DQ below the MatMul, scale Muls folded
    r_q, t_q = _pair(rfmt.qonnx_to_qcdq(make_qcdq_mlp()))
    r_p, t_p = rstr.propagate_dequant(r_q), tstr.propagate_dequant(t_q)
    _same(t_p, r_p)
    assert any(n.op_type == "Mul" for n in t_p.nodes)
    x = np.random.RandomState(3).randn(2, 6).astype(np.float32)
    np.testing.assert_array_equal(_t_run(t_p, x), _r_run(r_p, x))
    # FINN: activation Quants -> MultiThreshold on the cleaned TFC
    r_g, t_g = _pair(rzoo.build_tfc(2, 2))
    r_g, t_g = rtr.cleanup(r_g), ttr.cleanup(t_g)
    r_m, t_m = rstr.quant_to_multithreshold(r_g), \
        tstr.quant_to_multithreshold(t_g)
    _same(t_m, r_m)
    assert sum(n.op_type == "MultiThreshold" for n in t_m.nodes) >= 3
    x = np.random.RandomState(4).randn(1, 784).astype(np.float32)
    np.testing.assert_array_equal(_t_run(t_m, x), _r_run(r_m, x))


def test_fold_adjacent_muls_matches_reference():
    b = RBuilder("muls")
    x = b.add_input("x", (2, 3))
    a = b.add_initializer("a", np.asarray([0.5, 2.0, 0.25], np.float32))
    c = b.add_initializer("c", np.asarray(3.0, np.float32))
    (h,) = b.add_node("Mul", [x, a], 1)
    (h,) = b.add_node("Mul", [h, c], 1)
    b.mark_output(h)
    r_g, t_g = _pair(b.build())
    _same(tstr._fold_adjacent_muls(t_g.copy()),
          rstr._fold_adjacent_muls(r_g.copy()))


@pytest.mark.parametrize("key", ["cnv_block", "CNV-w2a2"])
def test_channels_last_matches_reference(key):
    """Fig. 3: the port writes the reference's NHWC graph, and both
    compute the NCHW graph's values."""
    r_g, t_g = _pair(GRAPHS[key]())
    r_g, t_g = rtr.cleanup(r_g), ttr.cleanup(t_g)
    r_l, t_l = rtr.to_channels_last(r_g), ttr.to_channels_last(t_g)
    _same(t_l, r_l)
    assert any(n.attrs.get("data_layout") == "NHWC" for n in t_l.nodes)
    shape = tuple(d or 1 for d in t_g.inputs[0].shape)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    xl = x.transpose(0, 2, 3, 1) if len(t_l.inputs[0].shape) == 4 and \
        tuple(t_l.inputs[0].shape)[-1] == shape[1] else x
    got = _t_run(t_l, xl)
    # the two oracles' float32 convs and means sum in other orders
    np.testing.assert_allclose(got, _r_run(r_l, xl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.reshape(-1), _t_run(t_g, x).reshape(-1),
                               atol=1e-4)


@pytest.mark.parametrize("recipe", ["w4a8", "w2a2", "fp"])
def test_export_mlp_matches_reference(recipe):
    rng = np.random.RandomState(0)
    weights = [(rng.randn(8, 16) * 0.3).astype(np.float32),
               (rng.randn(16, 4) * 0.3).astype(np.float32)]
    biases = [(rng.randn(16) * 0.1).astype(np.float32), None]
    make = {"w4a8": lambda R: R.w_a(4, 8), "w2a2": lambda R: R.w_a(2, 2),
            "fp": lambda R: R(enabled=False)}[recipe]
    args = (weights, biases)
    kw = dict(act_scales=[0.05, 0.02], in_shape=(3, 8))
    r_g = r_export(*args, make(RRecipe), **kw)
    t_g = t_export(*args, make(TRecipe), **kw)
    _same(t_g, r_g)
    x = rng.randn(3, 8).astype(np.float32)
    # non-dyadic scales: the two oracles' float32 matmuls sum in other orders
    np.testing.assert_allclose(_t_run(t_g, x), _r_run(r_g, x), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------- pipelines

def _outcome(run, g):
    try:
        return "ok", run(g)
    except Exception as e:           # the reference's error is the pin
        return type(e).__name__, str(e)


@pytest.mark.parametrize("graph", ["TFC-w2a2", "CNV-w2a2", "mlp",
                                   "cnv_block", "qcdq_mlp"])
@pytest.mark.parametrize("pipeline", sorted(R_PIPELINES))
def test_every_pipeline_runs_as_the_reference(pipeline, graph):
    """Every pipeline name resolves in the port (no unknown pass) and
    gives the reference's graph on the same input, or the reference's
    error where the reference refuses that graph."""
    assert set(tpasses.PIPELINES) == set(R_PIPELINES)
    r_g, t_g = _pair(GRAPHS[graph]())
    want = _outcome(lambda g: r_run(g, pipeline), r_g)
    got = _outcome(lambda g: tpasses.run_pipeline(g, pipeline), t_g)
    assert got[0] == want[0], (got, want)
    if want[0] == "ok":
        _same(got[1], want[1])
    else:
        assert got[1].replace("repro_torch", "repro") == want[1]


def test_every_pipeline_runs_somewhere():
    """Each pipeline succeeds on at least one of the graphs above."""
    for pipeline in tpasses.PIPELINES:
        ok = 0
        for key in ("TFC-w2a2", "mlp", "qcdq_mlp", "cnv_block"):
            _, t_g = _pair(GRAPHS[key]())
            ok += _outcome(lambda g: tpasses.run_pipeline(g, pipeline),
                           t_g)[0] == "ok"
        assert ok, pipeline


# ------------------------------------------------ compiled formats

def _plan_out(plan, g, x):
    return plan({g.input_names[0]: x})[g.output_names[0]].numpy()


@pytest.mark.parametrize("use_analysis", [True, False], ids=["int", "f32"])
def test_compiled_qcdq_tfc_matches_oracle(use_analysis):
    """tests/test_compile.py's QCDQ case on the port: the weight chains
    lower onto B1 / B2 and the plan equals the port's oracle."""
    t_g = tpasses.run_pipeline(_pair(rzoo.build_tfc(2, 2))[1], "compile_prep")
    q = tfmt.qonnx_to_qcdq(t_g)
    plan = t_compile(q, device="cpu", use_analysis=use_analysis)
    assert plan.fused_counts.get("quant_matmul", 0) + \
        plan.fused_counts.get("quant_matmul_int4", 0) == 4
    x = np.random.RandomState(7).randn(3, 784).astype(np.float32)
    np.testing.assert_array_equal(_plan_out(plan, q, x), _t_run(q, x))


def test_compiled_qcdq_cnv_convs_fuse_and_match():
    """CNV in QCDQ: every conv lowers onto a kernel (none interpreted)
    and the plan equals the port's oracle."""
    t_g = tpasses.run_pipeline(_pair(rzoo.build_cnv(2, 2))[1], "compile_prep")
    q = tfmt.qonnx_to_qcdq(t_g)
    plan = t_compile(q, device="cpu")
    n_convs = sum(1 for n in q.nodes if n.op_type == "Conv")
    assert sum(v for k, v in plan.fused_counts.items()
               if k.startswith("quant_conv")) == n_convs
    assert plan.interp_op_counts().get("Conv", 0) == 0
    x = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_array_equal(_plan_out(plan, q, x), _t_run(q, x))


def test_compiled_quantized_op_matches_oracle():
    t_g = tpasses.run_pipeline(_pair(rzoo.build_tfc(2, 2))[1], "compile_prep")
    qo = tfmt.qonnx_to_quantized_op(t_g)
    plan = t_compile(qo, device="cpu")
    x = np.random.RandomState(7).randn(3, 784).astype(np.float32)
    np.testing.assert_array_equal(_plan_out(plan, qo, x), _t_run(qo, x))
