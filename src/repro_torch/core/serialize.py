"""JSON (de)serialization of QonnxGraph (a copy of ``repro.core.serialize``).

``graph_from_json`` is how graphs and their weights cross from the JAX
package to the port: ``repro.core.serialize.graph_to_json(g)`` on one side,
``repro_torch.core.serialize.graph_from_json(d)`` on the other.

Stands in for ONNX protobuf files (the ``onnx`` package is unavailable
offline).  Initializer tensors are stored as base64-encoded raw bytes with
shape/dtype, keeping files compact and round-trip exact.
"""
from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

from .graph import Node, QonnxGraph, TensorInfo

FORMAT_VERSION = 1


def _tensor_to_json(v: np.ndarray):
    v = np.ascontiguousarray(v)
    return {"shape": list(v.shape), "dtype": str(v.dtype),
            "data": base64.b64encode(v.tobytes()).decode("ascii")}


def _tensor_from_json(d) -> np.ndarray:
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def graph_to_json(graph: QonnxGraph) -> dict:
    return {
        "format_version": FORMAT_VERSION,
        "name": graph.name,
        "opset": graph.opset,
        "nodes": [n.to_json() for n in graph.nodes],
        "inputs": [t.to_json() for t in graph.inputs],
        "outputs": [t.to_json() for t in graph.outputs],
        "initializers": {k: _tensor_to_json(v) for k, v in graph.initializers.items()},
        "value_info": {k: v.to_json() for k, v in graph.value_info.items()},
    }


def graph_from_json(d: dict) -> QonnxGraph:
    if d.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported format_version {d.get('format_version')}")
    return QonnxGraph(
        nodes=[Node.from_json(n) for n in d["nodes"]],
        inputs=[TensorInfo.from_json(t) for t in d["inputs"]],
        outputs=[TensorInfo.from_json(t) for t in d["outputs"]],
        initializers={k: _tensor_from_json(v) for k, v in d["initializers"].items()},
        value_info={k: TensorInfo.from_json(v) for k, v in d.get("value_info", {}).items()},
        name=d.get("name", "qonnx_graph"),
        opset=d.get("opset", 16),
    )


def save(graph: QonnxGraph, path) -> None:
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(graph_to_json(graph)))
    tmp.rename(path)  # atomic on POSIX


def load(path) -> QonnxGraph:
    return graph_from_json(json.loads(Path(path).read_text()))
