"""The port's analysis tier (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

Each zoo graph is built by both packages' zoos (the same seeded graph)
and run through both ``compile_prep`` pipelines, then analyzed by both
packages.  Held exactly, tensor by tensor: the ``RangeInfo`` (lo, hi,
integer, grid scale / zero point / integer bounds), the datatype and
dyadic maps, every MatMul / Conv accumulator bound and
``kernel_accumulator`` answer, and the ``CostReport`` with its Table III
check.  The zoo uses no bit width >= 13, where the two packages'
``min_int`` / ``max_int`` differ (the reference's float32 exp2 on the CPU
is inexact there, ROADMAP.md C4).  Analyses are computed once per module.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import analysis as ranalysis  # noqa: E402
from repro.analysis import cost as rcost  # noqa: E402
from repro.analysis import report as rreport  # noqa: E402
from repro.core import GraphBuilder as RBuilder  # noqa: E402
from repro.core import transforms as rtr  # noqa: E402
from repro.core.compile import compile_graph as r_compile  # noqa: E402
from repro.core.passes import run_pipeline as r_run  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch import analysis as tanalysis  # noqa: E402
from repro_torch.analysis import cost as tcost  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.core import GraphBuilder as TBuilder  # noqa: E402
from repro_torch.core import compile_graph as t_compile  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.core.passes import run_pipeline as t_run  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

ZOO = list(rzoo.ZOO)
KERNEL_OPS = ("MatMul", "Gemm", "Conv")


@functools.lru_cache(maxsize=None)
def _analyzed(key):
    """(reference graph, its analysis, port graph, its analysis), both
    after the compile_prep pipeline, as compile_graph analyzes them."""
    rg = r_run(rzoo.ZOO[key](), "compile_prep")
    tg = t_run(tzoo.ZOO[key](), "compile_prep")
    return rg, ranalysis.analyze(rg), tg, tanalysis.analyze(tg)


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b)


def _same_range(r, t):
    if (r.lo, r.hi, r.integer) != (t.lo, t.hi, t.integer):
        return False
    if (r.grid is None) != (t.grid is None):
        return False
    if r.grid is None:
        return True
    return (_same_array(r.grid.scale, t.grid.scale) and
            _same_array(r.grid.zero_point, t.grid.zero_point) and
            (r.grid.int_lo, r.grid.int_hi) == (t.grid.int_lo, t.grid.int_hi))


@pytest.mark.parametrize("key", ZOO)
def test_ranges_match_reference(key):
    rg, rga, tg, tga = _analyzed(key)
    assert [n.name for n in tg.nodes] == [n.name for n in rg.nodes]
    assert set(tga.ranges) == set(rga.ranges)
    bad = [name for name, r in rga.ranges.items()
           if not _same_range(r, tga.ranges[name])]
    assert bad == []
    assert set(tga.const_values) == set(rga.const_values)
    for name, v in rga.const_values.items():
        np.testing.assert_array_equal(tga.const_values[name], np.asarray(v))
    # the analysis proves something: every quantizer output has a grid
    assert sum(r.grid is not None for r in tga.ranges.values()) >= 4


@pytest.mark.parametrize("key", ZOO)
def test_accumulator_bounds_match_reference(key):
    rg, rga, tg, tga = _analyzed(key)
    nodes = [(r, t) for r, t in zip(rg.nodes, tg.nodes)
             if r.op_type in KERNEL_OPS]
    assert nodes
    for rn, tn in nodes:
        rs, ts = rga.accumulator_spec(rn), tga.accumulator_spec(tn)
        assert (rs is None) == (ts is None)
        if rs is not None:
            assert (ts.int_lo, ts.int_hi, ts.bits) == \
                (rs.int_lo, rs.int_hi, rs.bits)
        # the compile tier's hook, on the integer weight values
        w = np.asarray(rga.constant(rn.inputs[1]), np.float64)
        grid = rga.range(rn.inputs[1]).grid
        if grid is not None:
            w = np.round(w / np.asarray(grid.scale, np.float64) +
                         np.asarray(grid.zero_point, np.float64))
        assert tga.kernel_accumulator(tn, w) == rga.kernel_accumulator(rn, w)


@pytest.mark.parametrize("key", ZOO)
def test_datatype_and_dyadic_maps_match_reference(key):
    rg, rga, tg, tga = _analyzed(key)
    rdt, rbits = ranalysis.infer_datatype_map(rg, rga)
    tdt, tbits = tanalysis.infer_datatype_map(tg, tga)
    assert {k: str(v) for k, v in tdt.items()} == \
        {k: str(v) for k, v in rdt.items()}
    assert tbits == rbits
    rdy = ranalysis.infer_dyadic_map(rg, rga)
    tdy = tanalysis.infer_dyadic_map(tg, tga)
    assert set(tdy) == set(rdy) and rdy
    for name, (m, t) in rdy.items():
        assert _same_array(tdy[name][0], m) and tdy[name][1] == t


@pytest.mark.parametrize("scale", [
    0.125, 0.1, 3 * 2.0 ** -7, 2.0 ** -140, 1.0, 65535 * 2.0 ** -20,
    65537 * 2.0 ** -20, [0.5, 0.75, 0.125], [[0.25], [1.5]], 0.0, -0.5,
    float("inf"), [0.5, 0.0]], ids=lambda v: repr(v)[:24])
def test_dyadic_decompose_matches_reference(scale):
    s = np.asarray(scale, np.float32)
    r, t = ranalysis.dyadic_decompose(s), tanalysis.dyadic_decompose(s)
    assert (r is None) == (t is None)
    if r is not None:
        assert _same_array(t[0], r[0]) and t[1] == r[1]
    assert tanalysis.is_power_of_two(s) == ranalysis.is_power_of_two(s)


def _layer_fields(rep):
    return [(l.name, l.op_type, l.macs, l.bops, l.weights, l.weight_bits,
             l.w_dtype, l.a_dtype, l.b_w, l.b_a, l.acc_bits, l.mem_bytes,
             l.groups, l.requant, l.fp32_ops_eliminated) for l in rep.layers]


@pytest.mark.parametrize("key", ZOO)
def test_infer_cost_and_table3_match_reference(key):
    rg, rga, tg, tga = _analyzed(key)
    rep_r = rcost.infer_cost(rtr.infer_shapes(rg), ga=rga)
    rep_t = tcost.infer_cost(ttr.infer_shapes(tg), ga=tga)
    assert _layer_fields(rep_t) == _layer_fields(rep_r)
    assert rep_t.table() == rep_r.table()
    assert rep_t.csv() == rep_r.csv()
    conv_net = "CNV" in key or "MobileNet" in key
    kw = dict(skip_first_conv=conv_net,
              skip_first_conv_weights="MobileNet" in key)
    text = tcost.compare_table3(rep_t, tzoo.TABLE3[key], **kw)
    assert text == rcost.compare_table3(rep_r, rzoo.TABLE3[key], **kw)
    assert text.count("OK ") == 3, text            # Table III reproduced


@pytest.mark.parametrize("key", ["TFC-w1a1", "TFC-w2a2", "CNV-w1a1"])
def test_infer_cost_with_a_plan_matches_reference(key):
    """With a compiled plan each kernel layer reports its requant path."""
    r_plan = r_compile(rzoo.ZOO[key](), use_fusion=False)
    t_plan = t_compile(tzoo.ZOO[key](), device="cpu", use_fusion=False)
    rep_r = rcost.infer_cost(rtr.infer_shapes(r_plan.graph), plan=r_plan)
    rep_t = tcost.infer_cost(ttr.infer_shapes(t_plan.graph), plan=t_plan)
    assert _layer_fields(rep_t) == _layer_fields(rep_r)
    assert rep_t.integer_segment_fraction == 1.0
    assert rep_t.fp32_ops_eliminated == rep_r.fp32_ops_eliminated > 0
    assert rep_t.table() == rep_r.table()


def _bad_graph(builder):
    """One node per validation rule the checker knows."""
    b = builder("bad")
    x = b.add_input("x", (2, 8))
    h = b.quant(x, -0.5, 0.0, 4)                        # nonpositive scale
    h = b.quant(h, 0.5, 0.5, 4)                         # fractional zp
    h = b.quant(h, 0.5, 20.0, 4)                        # zp out of range
    h = b.quant(h, 0.5, 0.0, 1, signed=False, narrow=True)  # empty range
    s = b.add_initializer("s", np.asarray(0.5, np.float32))
    z = b.add_initializer("z", np.asarray(0.0, np.float32))
    ib = b.add_initializer("ib", np.asarray(4.0, np.float32))
    ob = b.add_initializer("ob", np.asarray(6.0, np.float32))
    (h,) = b.add_node("Trunc", [h, s, z, ib, ob], 1)    # trunc widens
    lo = b.add_initializer("lo", np.asarray(3.0, np.float32))
    hi = b.add_initializer("hi", np.asarray(1.0, np.float32))
    (h,) = b.add_node("Clip", [h, lo, hi], 1)           # inverted clip
    b.mark_output(h)
    return b.build()


def test_validate_quantization_matches_reference():
    r_issues = ranalysis.validate_quantization(_bad_graph(RBuilder))
    t_issues = tanalysis.validate_quantization(_bad_graph(TBuilder))
    assert [(i.node, i.code) for i in t_issues] == \
        [(i.node, i.code) for i in r_issues]
    assert {i.code for i in t_issues} >= {
        "nonpositive_scale", "fractional_zero_point",
        "zero_point_out_of_range", "empty_quant_range",
        "trunc_bits_increase", "clip_bounds_inverted"}
    with pytest.raises(tanalysis.QuantValidationError, match="6 issues"):
        tanalysis.check_graph(_bad_graph(TBuilder))
    assert tanalysis.validate_quantization(tzoo.build_cnv(2, 2)) == []


@pytest.mark.parametrize("lo,hi,signed", [
    (-8.0, 7.0, True), (-7.0, 7.0, True), (0.0, 15.0, False),
    (0.0, 14.0, False), (-5.0, 9.0, True), (0.0, 254.0, False),
    (-128.0, 127.0, True), (0.0, 1.0, False)])
def test_bitwidth_from_bounds_matches_reference(lo, hi, signed):
    from repro.core.formats import bitwidth_from_bounds as r_bits
    from repro_torch.analysis.validate import bitwidth_from_bounds as t_bits
    assert t_bits(lo, hi, signed) == r_bits(lo, hi, signed)


@pytest.mark.parametrize("key", ["TFC-w1a2", "CNV-w2a2"])
def test_analyze_pipeline_annotates_like_reference(key):
    rg = r_run(rzoo.ZOO[key](), "analyze")
    tg = t_run(tzoo.ZOO[key](), "analyze")
    r_ann = {k: v.qdtype for k, v in rg.value_info.items()}
    t_ann = {k: v.qdtype for k, v in tg.value_info.items()}
    assert t_ann == r_ann
    assert "UINT2" in t_ann.values() or "BIPOLAR" in t_ann.values()


def test_report_cli_on_the_cpu(capsys):
    """``python -m repro_torch.analysis.report --quick --device cpu``: the
    per-layer rows of the reference's report over the same plans."""
    assert treport.main(["--quick", "--device", "cpu", "--json"]) == 0
    payloads = json.loads(capsys.readouterr().out)
    assert [p["model"] for p in payloads] == list(treport.QUICK_MODELS)
    for p in payloads:
        g = rzoo.ZOO[p["model"]]()
        r_plan = r_compile(g, use_fusion=False)
        rep = rcost.infer_cost(rtr.infer_shapes(g), plan=r_plan)
        assert p["layers"] == rreport._layer_rows(rep)
        assert p["integer_path"]["coverage"] == 1.0
        assert p["integer_path"] == {
            "integer_segment_fraction": rep.integer_segment_fraction,
            "fp32_ops_eliminated": rep.fp32_ops_eliminated,
            **r_plan.requant_stats()}
    assert treport.main(["--model", "TFC-w2a2", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Table III check:" in text and "!!" not in text


def test_report_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default compiles on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treport.main(["--model", "TFC-w1a1"])
