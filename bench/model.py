"""The graph the program serves, built through its public ``GraphBuilder``
from a configuration's layer table and the drawn arrays, as a user hands
the port an exported model: explicit ``Quant`` / ``BipolarQuant`` nodes on
the weights and activations, in the QONNX zoo's node order.

The table is read by ``bench/table.py``, whose docstring gives its
grammar: a chain, or a graph whose layers name their outputs (``as``),
read a named tensor (``in``) and join two (``add``, an ONNX ``Add`` the
port lowers to its ``eltwise_add`` with the ``relu`` / ``quant`` that
follow).  A padded ``maxpool`` gets ONNX ``pads``.
"""
from __future__ import annotations

from bench import table


def build_graph(cfg: dict, params: list):
    from repro_torch.core.graph import GraphBuilder

    b = GraphBuilder(cfg["name"])
    env = {table.INPUT: b.add_input("x", (1, *cfg["image_shape"]))}
    weights = iter(params)
    for step in table.walk(cfg["layers"], cfg["image_shape"]):
        layer = step.layer
        if step.src is not None:
            h = env[step.src]
        op = layer["op"]
        if op == "quant":
            h = b.quant(h, layer["scale"], 0.0, layer["bits"],
                        signed=layer["signed"])
        elif op == "bipolar":
            h = b.bipolar_quant(h, layer["scale"])
        elif op in ("conv", "matmul"):
            p = next(weights)
            name = b.add_initializer("w", p["w"])
            if layer["w_bits"] == 1:
                qw = b.bipolar_quant(name, p["scale"])
            else:
                qw = b.quant(name, p["scale"], 0.0, layer["w_bits"],
                             narrow=True)
            if op == "matmul":
                (h,) = b.add_node("MatMul", [h, qw], 1)
            else:
                k, pad = layer["k"], layer["pad"]
                attrs = {"strides": [layer["stride"]] * 2,
                         "pads": [pad] * 4, "kernel_shape": [k, k]}
                if layer["group"] != 1:
                    attrs["group"] = layer["group"]
                (h,) = b.add_node("Conv", [h, qw], 1, attrs)
        elif op == "relu":
            (h,) = b.add_node("Relu", [h], 1)
        elif op == "maxpool":
            attrs = {"kernel_shape": [layer["k"]] * 2,
                     "strides": [layer["stride"]] * 2}
            if layer.get("pad"):
                attrs["pads"] = [layer["pad"]] * 4
            (h,) = b.add_node("MaxPool", [h], 1, attrs)
        elif op == "gap":
            (h,) = b.add_node("GlobalAveragePool", [h], 1)
        elif op == "flatten":
            (h,) = b.add_node("Flatten", [h], 1, {"axis": 1})
        elif op == "add":
            (h,) = b.add_node("Add", [h, env[step.other]], 1)
        else:
            raise ValueError(f"unknown layer op {op!r}")
        if step.out is not None:
            env[step.out] = h
    b.mark_output(h)
    return b.build()
