"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU: quickstart and export_zoo.  The reference
examples are loaded from their files and run as they are.

The two ``main`` s' stdout line for line.  The one line allowed to
differ is quickstart's executor output, a float32 MatMul whose sums the
two packages order differently: it is held to ``2·K·2^-24·(|x|@|w|)``
plus one float32 rounding of the output.  export_zoo's counts, node
counts, match flags, file size and exactness are also compared against
the reference's own functions.  Every example defaults to CUDA and
raises without it.

Each gate is a function that raises, and a planted-fault test shows
that it catches the fault its docstring names.
"""
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import transforms as ref_transforms  # noqa: E402
from repro.models import zoo as ref_zoo  # noqa: E402
from torch_examples import CPU, load, stdout_of  # noqa: E402

from repro_torch.core import trunc  # noqa: E402


@pytest.fixture(scope="module")
def quickstart_runs():
    ref_lines, _ = stdout_of(load("examples/quickstart.py").main)
    return ref_lines, stdout_of(load("examples_torch/quickstart.py").main, CPU)


@pytest.fixture(scope="module")
def export_runs():
    ref_lines, _ = stdout_of(load("examples/export_zoo.py").main)
    return ref_lines, stdout_of(load("examples_torch/export_zoo.py").main, CPU)


# ------------------------------------------------------------- quickstart

EXEC = "executor output"


def _numbers(line: str) -> np.ndarray:
    return np.asarray(re.findall(r"-?\d+\.?\d*(?:e[-+]\d+)?", line.split(":", 1)[1]),
                      np.float32)


def quickstart_order_bound() -> np.ndarray:
    """On the MatMul's operands as quickstart quantizes them (the 8-bit
    activation, the 4-bit narrow weights): ``2·K·2^-24·(|x|@|w|)`` plus
    one float32 rounding of the largest output."""
    qs = load("examples_torch/quickstart.py")
    x, w = qs.matmul_operands(*qs.graph_inputs())
    mag = np.abs(x) @ np.abs(w)
    return 2 * 8 * 2.0 ** -24 * mag + np.spacing(np.float32(mag.max()))


def assert_quickstart(ref_lines, port_lines):
    """Every line equal but the executor output, held to the order bound."""
    assert len(port_lines) == len(ref_lines), (port_lines, ref_lines)
    for r, p in zip(ref_lines, port_lines):
        if r.startswith(EXEC):
            assert p.startswith(EXEC)
            got, want = _numbers(p), _numbers(r)
            assert got.shape == want.shape == (4,)
            assert (np.abs(got - want) <= quickstart_order_bound().ravel()).all(), (p, r)
        else:
            assert p == r


def test_quickstart_stdout_matches_reference(quickstart_runs):
    ref_lines, (port_lines, got) = quickstart_runs
    assert_quickstart(ref_lines, port_lines)
    assert len(ref_lines) == 14 and any(r.startswith(EXEC) for r in ref_lines)
    assert got["qcdq_match"] is True and got["nodes"] == ["Quant", "Quant", "MatMul", "Relu"]
    assert got["out"].dtype == np.float32 and got["out"].shape == (1, 4)


def test_quickstart_gate_catches_trunc_rounding(quickstart_runs, monkeypatch):
    """Planted fault: Trunc rounds half to even where its default is
    FLOOR."""
    ref_lines, _ = quickstart_runs
    qs = load("examples_torch/quickstart.py")
    monkeypatch.setattr(qs, "trunc", lambda *a: trunc(*a, rounding_mode="ROUND"))
    faulty, _ = stdout_of(qs.main, CPU)
    with pytest.raises(AssertionError):
        assert_quickstart(ref_lines, faulty)


# ------------------------------------------------------------- export_zoo

def reference_export_facts() -> dict:
    """The reference's counts through its own functions on its own graph."""
    from repro.core import bops, serialize
    g = ref_zoo.ZOO["CNV-w2a2"]()
    c = bops.graph_cost(ref_transforms.infer_shapes(g))
    first = next(layer for layer in c.layers if "Conv" in layer.name)
    gc = ref_transforms.cleanup(g)
    with tempfile.TemporaryDirectory() as d:
        serialize.save(gc, Path(d) / "cnv_w2a2.qonnx.json")
        size = (Path(d) / "cnv_w2a2.qonnx.json").stat().st_size
    return {"raw_nodes": len(g.nodes), "macs": c.macs - first.macs, "weights": c.weights,
            "weight_bits": int(c.total_weight_bits), "bops": c.bops,
            "clean_nodes": len(gc.nodes), "bytes": size}


def assert_export(ref_lines, port_lines, got, facts):
    assert port_lines == ref_lines
    for k, v in facts.items():
        assert got[k] == v, (k, got[k], v)
    assert got["channels_last"]["match"] and got["qcdq_match"] and got["exact"]


def test_export_zoo_matches_reference(export_runs):
    ref_lines, (port_lines, got) = export_runs
    assert len(ref_lines) == 6
    assert_export(ref_lines, port_lines, got, reference_export_facts())
    assert got["out"].shape == (1, 10) and np.isfinite(got["out"]).all()


def test_export_zoo_gate_catches_cost_after_cleanup(export_runs, monkeypatch):
    """Planted fault: the cost accounting runs after cleanup, where the
    folded weight Quants no longer mark the weights' bit widths."""
    from repro_torch.core import transforms
    ref_lines, _ = export_runs
    ez = load("examples_torch/export_zoo.py")
    table = ez.table_iii
    monkeypatch.setattr(ez, "table_iii", lambda g: table(transforms.cleanup(g)))
    faulty, got = stdout_of(ez.main, CPU)
    with pytest.raises(AssertionError):
        assert_export(ref_lines, faulty, got, reference_export_facts())



def test_examples_refuse_cuda_without_a_card(monkeypatch):
    """``--device`` defaults to CUDA; without it each example raises,
    naming ``--device cpu``, and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart", "export_zoo", "serve_quantized", "train_qat_lm"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            load(f"examples_torch/{name}.py").main([])
