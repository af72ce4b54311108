"""The port's IR, serialization, zoo and compile-prep passes against the
reference.  Graphs cross from ``repro`` to ``repro_torch`` as
``core/serialize.py`` JSON.  The pass-pipeline checks build each graph
with both packages' builders instead, because the JSON round trip turns a
0-d initializer into a 1-d one (both packages' serializers do), which
changes what a Gather on it returns."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GraphBuilder as RBuilder  # noqa: E402
from repro.core import serialize as rser  # noqa: E402
from repro.core.passes import run_pipeline as r_run  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import GraphBuilder as TBuilder  # noqa: E402
from repro_torch.core import passes as tpasses  # noqa: E402
from repro_torch.core import serialize as tser  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402


def _port(d):
    return tser.graph_from_json(d)


@pytest.mark.parametrize("key", list(rzoo.ZOO))
def test_zoo_json_round_trips_byte_identical(key):
    d = rser.graph_to_json(rzoo.ZOO[key]())
    assert json.dumps(tser.graph_to_json(_port(d))) == json.dumps(d)


@pytest.mark.parametrize("key", [k for k in rzoo.ZOO
                                 if not k.startswith("MobileNet")])
def test_port_zoo_builds_the_reference_graph(key):
    assert json.dumps(tser.graph_to_json(tzoo.ZOO[key]())) == \
        json.dumps(rser.graph_to_json(rzoo.ZOO[key]()))
    assert tzoo.TABLE3[key] == rzoo.TABLE3[key]


def _same_after(pipeline, build):
    """``build(GraphBuilder)`` with each package's builder; the two graphs
    and their post-pipeline forms must serialize identically."""
    g_ref, g_port = build(RBuilder), build(TBuilder)
    assert tser.graph_to_json(g_port) == rser.graph_to_json(g_ref)
    want = rser.graph_to_json(r_run(g_ref, pipeline))
    got = tser.graph_to_json(tpasses.run_pipeline(g_port, pipeline))
    assert got == want


def _zoo_builder(key):
    return lambda B: (rzoo if B is RBuilder else tzoo).ZOO[key]()


@pytest.mark.parametrize("key", [k for k in rzoo.ZOO
                                 if not k.startswith("MobileNet")])
def test_compile_prep_matches_reference(key):
    _same_after("compile_prep", _zoo_builder(key))


def _reshape_chain_graph(builder=RBuilder):
    """Fig. 1: a Shape/Gather/Unsqueeze/Concat chain feeding a Reshape."""
    b = builder("rechain")
    x = b.add_input("x", (2, 4, 3))
    (sh,) = b.add_node("Shape", [x], 1)
    zero = b.add_initializer("zero", np.asarray(0, np.int64))
    (d0,) = b.add_node("Gather", [sh, zero], 1, {"axis": 0})
    (d0u,) = b.add_node("Unsqueeze", [d0], 1, {"axes": [0]})
    minus1 = b.add_initializer("m1", np.asarray([-1], np.int64))
    (tgt,) = b.add_node("Concat", [d0u, minus1], 1, {"axis": 0})
    (y,) = b.add_node("Reshape", [x, tgt], 1)
    (r,) = b.add_node("Relu", [y], 1)
    (i,) = b.add_node("Identity", [r], 1)
    b.mark_output(i)
    return b.build()


def _mlp_with_folds(builder=RBuilder):
    """Weight Quants (foldable), a Constant, a Cast and an activation Quant."""
    rng = np.random.RandomState(0)
    b = builder("mlp")
    x = b.add_input("x", (None, 6))
    h = b.quant(x, 0.1, 0.0, 4)
    w = b.add_initializer("w", rng.randn(6, 5).astype(np.float32))
    qw = b.quant(w, 0.05, 0.0, 3, narrow=True)
    (h,) = b.add_node("MatMul", [h, qw], 1)
    (c,) = b.add_node("Constant", [], 1,
                      {"value": np.arange(5, dtype=np.float64)})
    (h,) = b.add_node("Add", [h, c], 1)
    (h,) = b.add_node("Cast", [h], 1, {"to": "float32"})
    b.mark_output(h)
    return b.build()


@pytest.mark.parametrize("pipeline", ["cleanup", "compile_prep"])
@pytest.mark.parametrize("build", [_reshape_chain_graph, _mlp_with_folds])
def test_cleanup_pipelines_match_reference(pipeline, build):
    _same_after(pipeline, build)


def test_infer_shapes_falls_back_to_concrete_values():
    """A Pad whose value is a float constant needs that value; on the meta
    device it has none, so the pass reruns on concrete zeros."""
    def build(builder):
        b = builder("padv")
        x = b.add_input("x", (2, 3))
        pads = b.add_initializer("pads", np.asarray([0, 1, 0, 2], np.int64))
        val = b.add_initializer("val", np.asarray(1.5, np.float32))
        (y,) = b.add_node("Pad", [x, pads, val], 1)
        b.mark_output(y)
        return b.build()
    got = ttr.infer_shapes(build(TBuilder))
    assert got.value_info[got.output_names[0]].shape == (2, 6)
    _same_after("cleanup", build)


def test_unported_passes_raise_the_unknown_pass_error():
    g = _port(rser.graph_to_json(_mlp_with_folds()))
    with pytest.raises(KeyError, match="unknown pass 'quant_to_multithreshold'"):
        tpasses.run_pipeline(g, "streamline_for_finn")
    assert set(tpasses.PIPELINES) >= {"cleanup", "compile_prep"}
    assert "fold_constants_keep_quant" in tpasses.available_passes()


def test_pass_manager_records_stats():
    g = _reshape_chain_graph(TBuilder)
    pm = tpasses.PassManager.from_names(["cleanup"])
    out = pm(g)
    assert [s.name for s in pm.stats] == tpasses.PIPELINES["cleanup"]
    assert [n.op_type for n in out.nodes] == ["Reshape", "Relu"]
    assert "fold_constants" in pm.summary()
