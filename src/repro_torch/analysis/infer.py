"""Datatype inference: annotate every tensor with its QONNX datatype.

Counterpart of ``repro.analysis.infer`` (numpy only).

The QONNX convention (paper §V "datatype inference"): a fake-quantized
float tensor carries the *integer datatype annotation* of its underlying
quantized representation —

  * a ``Quant`` output is INT<bw>/UINT<bw> from the node's declared
    ``bit_width``/``signed`` (fractional widths round up to the container,
    but the exact declared width is kept separately for cost accounting);
  * ``BipolarQuant`` outputs are BIPOLAR;
  * ``Trunc`` outputs are INT<out_bits>;
  * QuantizeLinear carriers are INT8/UINT8, narrowed by a following Clip
    (bit width recovered via the range analysis grid);
  * annotations propagate through monotone / element-shuffle ops
    (Relu, MaxPool, Reshape, Flatten, Transpose, ...);
  * any other tensor that the range analysis proves integer-valued gets
    the minimal datatype of its range; everything else is FLOAT32.

``infer_datatypes`` is the registered graph pass: it writes the annotation
into ``value_info[t].qdtype`` (serialized with the graph) and returns the
annotated copy.  ``infer_datatype_map`` returns the raw dicts for
programmatic consumers (the compiled executor, the cost reporter).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.graph import QonnxGraph, TensorInfo

from .datatypes import BIPOLAR, FLOAT32, DataType
from .ranges import GraphAnalysis, analyze

# ops through which the quantization annotation passes unchanged: element
# shuffles plus max-like monotone ops that only ever *select* grid values
_PRESERVING = {"Reshape", "Flatten", "Transpose", "Squeeze", "Unsqueeze",
               "Identity", "Relu", "MaxPool", "GlobalMaxPool", "Pad"}


def infer_datatype_map(graph: QonnxGraph,
                       ga: Optional[GraphAnalysis] = None
                       ) -> tuple[dict[str, DataType], dict[str, float]]:
    """Returns ({tensor: DataType}, {tensor: declared_bit_width}).

    The second dict keeps the *exact* (possibly fractional) declared bit
    width of quantizer outputs for cost accounting (Eq. 5 / Table III);
    the DataType names the integer container (ceil of the width).
    """
    ga = ga or analyze(graph)
    dtypes: dict[str, DataType] = {}
    qbits: dict[str, float] = {}

    def declared(node) -> Optional[tuple[DataType, float]]:
        if node.op_type == "Quant":
            bw = ga.constant(node.inputs[3])
            if bw is None:
                return None
            nb = float(np.max(np.asarray(bw)))
            return (DataType.int(nb, signed=bool(node.attrs.get("signed", 1))),
                    nb)
        if node.op_type == "BipolarQuant":
            return BIPOLAR, 1.0
        if node.op_type == "Trunc":
            ob = ga.constant(node.inputs[4])
            if ob is None:
                return None
            nb = float(np.max(np.asarray(ob)))
            return (DataType.int(nb, signed=bool(node.attrs.get("signed", 1))),
                    nb)
        return None

    for node in graph.toposort():
        out = node.outputs[0] if node.outputs else None
        if out is None:
            continue
        d = declared(node)
        if d is not None:
            dtypes[out], qbits[out] = d
            continue
        if node.op_type in _PRESERVING and node.inputs and \
                node.inputs[0] in dtypes:
            src = node.inputs[0]
            dtypes[out] = dtypes[src]
            if src in qbits:
                qbits[out] = qbits[src]
            continue
        r = ga.range(out)
        if r.grid is not None and r.integer and \
                r.lo == r.grid.int_lo and r.hi == r.grid.int_hi:
            # integer carrier (QuantizeLinear [+ Clip]): container from the
            # grid's integer domain
            dt = DataType.from_bounds(r.grid.int_lo, r.grid.int_hi)
            dtypes[out] = dt
            qbits[out] = float(dt.bits)
        elif node.op_type == "DequantizeLinear" and r.grid is not None:
            # dequantized carrier: annotation is the carrier's datatype
            dt = DataType.from_bounds(r.grid.int_lo, r.grid.int_hi)
            dtypes[out] = dt
            qbits[out] = float(dt.bits)
        else:
            dtypes[out] = r.dtype()
    # graph inputs / initializers without producers
    for t in graph.inputs:
        dtypes.setdefault(t.name, FLOAT32)
    for name in graph.initializers:
        dtypes.setdefault(name, ga.value_dtype(name))
    return dtypes, qbits


def infer_dyadic_map(graph: QonnxGraph,
                     ga: Optional[GraphAnalysis] = None
                     ) -> dict[str, tuple[np.ndarray, int]]:
    """{tensor: (multiplier, shift)} for every tensor on a dyadic grid.

    A tensor qualifies when the range analysis knows its quantization grid
    and the grid's scale decomposes exactly as ``mult * 2**-shift``
    (``QuantGrid.dyadic``, odd multipliers bounded by ``DYADIC_MAX_MULT``)
    — per-tensor scales give a scalar-shaped multiplier, per-channel
    scales a multiplier in the scale's shape with one common shift.
    These are exactly the tensors eligible (on their input side) for the
    compiled tier's integer-only requantization path; the lowering's
    ``select_requant`` layers its accumulation-headroom proof on top.
    """
    ga = ga or analyze(graph)
    out: dict[str, tuple[np.ndarray, int]] = {}
    seen = set()
    for node in graph.nodes:
        for t in node.outputs:
            if not t or t in seen:
                continue
            seen.add(t)
            grid = ga.range(t).grid
            if grid is None:
                continue
            d = grid.dyadic()
            if d is not None:
                out[t] = d
    return out


def infer_datatypes(graph: QonnxGraph) -> QonnxGraph:
    """Registered pass: annotate ``value_info[t].qdtype`` on a graph copy."""
    g = graph.copy()
    dtypes, _ = infer_datatype_map(g)
    for name, dt in dtypes.items():
        vi = g.value_info.get(name)
        if vi is None:
            shape = g.get_shape(name)
            vi = TensorInfo(name, tuple(shape) if shape is not None else None)
            g.value_info[name] = vi
        vi.qdtype = str(dt)
    for t in list(g.inputs) + list(g.outputs):
        if t.name in dtypes:
            t.qdtype = str(dtypes[t.name])
    return g
