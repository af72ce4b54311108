"""QonnxGraph: an in-memory ONNX-style graph IR (a copy of
``repro.core.graph``, numpy only, so the port never imports ``repro``).

The ``onnx`` python package is not available in this environment, so we carry
our own IR that mirrors ONNX GraphProto/NodeProto semantics closely enough
that every transformation in the paper (cleanup, constant folding, shape
inference, channels-last, format lowering) is expressible:

  * ``Node``        — op_type, named inputs/outputs, attribute dict, domain
                      ("" for standard ONNX ops, "qonnx" for Quant /
                      BipolarQuant / Trunc, "finn" for MultiThreshold).
  * ``QonnxGraph``  — node list, graph inputs/outputs, initializers (constant
                      tensors), value_info (known shapes/dtypes), opset.

Graphs serialize to/from JSON (``serialize.py``) and execute node-by-node via
``executor.py`` (the FINN-style "slow but verifiable" engine of paper §V).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

import numpy as np

QONNX_DOMAIN = "qonnx.custom_op.general"
FINN_DOMAIN = "finn.custom_op.general"


@dataclass
class TensorInfo:
    name: str
    shape: Optional[tuple] = None     # None = unknown; entries may be ints
                                      # (a None entry = symbolic, e.g. batch)
    dtype: str = "float32"
    qdtype: Optional[str] = None      # QONNX datatype annotation ("INT4",
                                      # "UINT8", "BIPOLAR", ...) attached by
                                      # analysis.infer_datatypes

    def to_json(self):
        d = {"name": self.name,
             "shape": list(self.shape) if self.shape is not None else None,
             "dtype": self.dtype}
        if self.qdtype is not None:
            d["qdtype"] = self.qdtype
        return d

    @staticmethod
    def from_json(d):
        sh = tuple(d["shape"]) if d.get("shape") is not None else None
        return TensorInfo(d["name"], sh, d.get("dtype", "float32"),
                          d.get("qdtype"))


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any] = field(default_factory=dict)
    name: str = ""
    domain: str = ""

    def to_json(self):
        return {"op_type": self.op_type, "inputs": list(self.inputs),
                "outputs": list(self.outputs), "attrs": _attrs_to_json(self.attrs),
                "name": self.name, "domain": self.domain}

    @staticmethod
    def from_json(d):
        return Node(d["op_type"], list(d["inputs"]), list(d["outputs"]),
                    _attrs_from_json(d.get("attrs", {})), d.get("name", ""),
                    d.get("domain", ""))


def _attrs_to_json(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _attrs_from_json(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


@dataclass
class QonnxGraph:
    nodes: list[Node] = field(default_factory=list)
    inputs: list[TensorInfo] = field(default_factory=list)
    outputs: list[TensorInfo] = field(default_factory=list)
    initializers: dict[str, np.ndarray] = field(default_factory=dict)
    value_info: dict[str, TensorInfo] = field(default_factory=dict)
    name: str = "qonnx_graph"
    opset: int = 16

    # ------------------------------------------------------------------ util
    def copy(self) -> "QonnxGraph":
        return QonnxGraph(
            nodes=[dataclasses.replace(n, inputs=list(n.inputs),
                                       outputs=list(n.outputs),
                                       attrs=dict(n.attrs)) for n in self.nodes],
            inputs=[dataclasses.replace(t) for t in self.inputs],
            outputs=[dataclasses.replace(t) for t in self.outputs],
            initializers=dict(self.initializers),
            value_info={k: dataclasses.replace(v) for k, v in self.value_info.items()},
            name=self.name, opset=self.opset,
        )

    @property
    def input_names(self) -> list[str]:
        return [t.name for t in self.inputs]

    @property
    def output_names(self) -> list[str]:
        return [t.name for t in self.outputs]

    def producer(self, tensor: str) -> Optional[Node]:
        for n in self.nodes:
            if tensor in n.outputs:
                return n
        return None

    def consumers(self, tensor: str) -> list[Node]:
        return [n for n in self.nodes if tensor in n.inputs]

    def fresh_name(self, base: str) -> str:
        taken = set(self.initializers) | set(self.value_info) | \
            set(self.input_names) | set(self.output_names)
        for n in self.nodes:
            taken.update(n.inputs)
            taken.update(n.outputs)
            taken.add(n.name)
        if base not in taken:
            return base
        i = 0
        while f"{base}_{i}" in taken:
            i += 1
        return f"{base}_{i}"

    def toposort(self) -> list[Node]:
        """Topologically order nodes; raises on cycles / dangling inputs."""
        available = set(self.initializers) | set(self.input_names)
        # constants produced by Constant nodes have no data dependencies
        pending = list(self.nodes)
        ordered: list[Node] = []
        while pending:
            progressed = False
            remaining = []
            for n in pending:
                if all(i == "" or i in available for i in n.inputs):
                    ordered.append(n)
                    available.update(n.outputs)
                    progressed = True
                else:
                    remaining.append(n)
            if not progressed:
                missing = {i for n in remaining for i in n.inputs
                           if i and i not in available}
                raise ValueError(
                    f"graph is not a DAG or has dangling inputs: {sorted(missing)}")
            pending = remaining
        return ordered

    def remove_node(self, node: Node) -> None:
        self.nodes.remove(node)

    def replace_tensor(self, old: str, new: str) -> None:
        """Rewire every consumer (and graph outputs) of ``old`` to ``new``."""
        for n in self.nodes:
            n.inputs = [new if i == old else i for i in n.inputs]
        for t in self.outputs:
            if t.name == old:
                t.name = new

    def set_shape(self, tensor: str, shape, dtype: str = "float32") -> None:
        self.value_info[tensor] = TensorInfo(tensor, tuple(shape), dtype)

    def get_shape(self, tensor: str):
        if tensor in self.initializers:
            return self.initializers[tensor].shape
        vi = self.value_info.get(tensor)
        if vi is not None and vi.shape is not None:
            return vi.shape
        for t in list(self.inputs) + list(self.outputs):
            if t.name == tensor:
                return t.shape
        return None

    def validate(self) -> None:
        """Structural well-formedness: SSA outputs, resolvable toposort."""
        seen = set(self.initializers) | set(self.input_names)
        for n in self.nodes:
            for o in n.outputs:
                if o in seen:
                    raise ValueError(f"tensor {o!r} defined more than once (SSA violation)")
                seen.add(o)
        self.toposort()
        for o in self.output_names:
            if o not in seen:
                raise ValueError(f"graph output {o!r} is never produced")


class GraphBuilder:
    """Small convenience layer for constructing QonnxGraphs in code.

    Used by the model zoo (TFC / CNV / MobileNet) and by ``trace_module``.
    """

    def __init__(self, name: str = "qonnx_graph"):
        self.graph = QonnxGraph(name=name)
        self._ctr = 0

    def _tname(self, hint: str) -> str:
        self._ctr += 1
        return f"{hint}_{self._ctr}"

    def add_input(self, name: str, shape, dtype: str = "float32") -> str:
        self.graph.inputs.append(TensorInfo(name, tuple(shape), dtype))
        return name

    def add_initializer(self, name_hint: str, value: np.ndarray) -> str:
        name = self.graph.fresh_name(name_hint)
        self.graph.initializers[name] = np.asarray(value)
        return name

    def add_node(self, op_type: str, inputs: Iterable[str], n_out: int = 1,
                 attrs: Optional[dict] = None, domain: str = "",
                 out_hint: Optional[str] = None) -> list[str]:
        hint = out_hint or op_type.lower()
        outs = [self.graph.fresh_name(self._tname(hint)) for _ in range(n_out)]
        self.graph.nodes.append(
            Node(op_type, list(inputs), outs, dict(attrs or {}),
                 name=self.graph.fresh_name(f"{op_type}_{self._ctr}"),
                 domain=domain))
        return outs

    def quant(self, x: str, scale, zero_point, bit_width, *, signed=True,
              narrow=False, rounding_mode="ROUND") -> str:
        s = self.add_initializer("scale", np.asarray(scale, np.float32))
        z = self.add_initializer("zero_point", np.asarray(zero_point, np.float32))
        b = self.add_initializer("bit_width", np.asarray(bit_width, np.float32))
        (y,) = self.add_node(
            "Quant", [x, s, z, b], 1,
            {"signed": int(signed), "narrow": int(narrow),
             "rounding_mode": rounding_mode},
            domain=QONNX_DOMAIN, out_hint="quant")
        return y

    def bipolar_quant(self, x: str, scale) -> str:
        s = self.add_initializer("scale", np.asarray(scale, np.float32))
        (y,) = self.add_node("BipolarQuant", [x, s], 1, {},
                             domain=QONNX_DOMAIN, out_hint="bipolar")
        return y

    def trunc(self, x: str, scale, zero_point, in_bits, out_bits,
              rounding_mode="FLOOR") -> str:
        s = self.add_initializer("scale", np.asarray(scale, np.float32))
        z = self.add_initializer("zero_point", np.asarray(zero_point, np.float32))
        bi = self.add_initializer("in_bits", np.asarray(in_bits, np.float32))
        bo = self.add_initializer("out_bits", np.asarray(out_bits, np.float32))
        (y,) = self.add_node("Trunc", [x, s, z, bi, bo], 1,
                             {"rounding_mode": rounding_mode},
                             domain=QONNX_DOMAIN, out_hint="trunc")
        return y

    def mark_output(self, tensor: str, shape=None, dtype: str = "float32"):
        self.graph.outputs.append(TensorInfo(tensor, tuple(shape) if shape else None, dtype))

    def build(self) -> QonnxGraph:
        self.graph.validate()
        return self.graph
