"""QAT-frontend export: quantized modules -> QONNX graphs (paper §VI-A/B).

Counterpart of ``repro.core.export`` over the port's recipes
(``quantize/config.py``), numpy only.

The paper's frontends (QKeras via tf2onnx handlers, Brevitas via symbolic
trace) emit Quant nodes per quantized layer.  We reproduce the *handler*
mechanism: each repro layer kind has an export handler that emits the
equivalent ONNX ops + Quant nodes with the recipe's attributes and the same
dynamically-derived scales the in-framework forward uses.  The weight
scale is the reference's eager ``_dynamic_scale``: the float32 max-abs
per output channel, floored at 1e-8, over ``max_int`` by a true division.
"""
from __future__ import annotations

import numpy as np

from ..quantize.config import QuantRecipe, TensorQuant
from .formats import max_int
from .graph import GraphBuilder, QonnxGraph

ACT_OPS = {"relu": "Relu", "gelu": "Erf", "sigmoid": "Sigmoid",
           "tanh": "Tanh", None: None}


def _weight_scale(w: np.ndarray, tq: TensorQuant) -> np.ndarray:
    """max-abs symmetric float32 scale, per output channel (the last axis)
    when the recipe asks for it."""
    if tq.channelwise:
        amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    else:
        amax = np.max(np.abs(w))
    bound = np.float32(max_int(tq.signed, tq.narrow, tq.bit_width))
    return np.asarray(np.maximum(amax.astype(np.float32), np.float32(1e-8))
                      / bound, np.float32)


def _emit_weight_quant(b: GraphBuilder, w: np.ndarray, tq: TensorQuant):
    """Handler for a quantized weight: Quant node with the dynamic
    channel-wise scale frozen at export time (Brevitas-style partial
    evaluation of scale into constants, §VI-B)."""
    w = np.asarray(w, np.float32)
    w_name = b.add_initializer("w", w)
    scale = _weight_scale(w, tq)
    s = b.add_initializer("w_scale", scale)
    z = b.add_initializer("w_zp", np.zeros_like(scale))
    bw = b.add_initializer("w_bits", np.asarray(tq.bit_width, np.float32))
    (qw,) = b.add_node("Quant", [w_name, s, z, bw], 1,
                       {"signed": int(tq.signed), "narrow": int(tq.narrow),
                        "rounding_mode": tq.rounding_mode},
                       domain="qonnx.custom_op.general", out_hint="w_quant")
    return qw


def _emit_act_quant(b: GraphBuilder, x: str, tq: TensorQuant, scale: float):
    s = b.add_initializer("a_scale", np.asarray(scale, np.float32))
    z = b.add_initializer("a_zp", np.asarray(0.0, np.float32))
    bw = b.add_initializer("a_bits", np.asarray(tq.bit_width, np.float32))
    (qx,) = b.add_node("Quant", [x, s, z, bw], 1,
                       {"signed": int(tq.signed), "narrow": int(tq.narrow),
                        "rounding_mode": tq.rounding_mode},
                       domain="qonnx.custom_op.general", out_hint="a_quant")
    return qx


def export_mlp(weights: list, biases: list, recipe: QuantRecipe,
               act_scales: list, in_shape, activation: str = "relu",
               name: str = "exported_mlp") -> QonnxGraph:
    """Export a quantized MLP (list of (K,N) weights) to QONNX.

    ``act_scales``: per-layer input-activation scales (from calibration or
    the dynamic scales observed at export, one per quantized activation).
    """
    b = GraphBuilder(name)
    h = b.add_input("x", tuple(in_shape))
    n = len(weights)
    for i, w in enumerate(weights):
        if recipe.enabled:
            h = _emit_act_quant(b, h, recipe.acts, act_scales[i])
            qw = _emit_weight_quant(b, np.asarray(w), recipe.weights)
        else:
            qw = b.add_initializer("w", np.asarray(w, np.float32))
        (h,) = b.add_node("MatMul", [h, qw], 1)
        if biases[i] is not None:
            bias = b.add_initializer("b", np.asarray(biases[i], np.float32))
            (h,) = b.add_node("Add", [h, bias], 1)
        if i < n - 1 and activation:
            (h,) = b.add_node(ACT_OPS[activation] or "Relu", [h], 1)
    b.mark_output(h)
    return b.build()
