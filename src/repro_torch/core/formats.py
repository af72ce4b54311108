"""Format lowerings between ONNX-based QNN representations (paper §III-§V).

Counterpart of ``repro.core.formats``: numpy over the port's
``QonnxGraph``, with the integer bounds of Eqs. 2-3 as plain Python
numbers, so the graphs it writes hold the reference's initializers (int8
or uint8 zero points and clip bounds, float32 scales) value for value.

Implemented conversions:

  * ``qonnx_to_qcdq``   — lower high-level ``Quant`` nodes to
                          QuantizeLinear -> Clip -> DequantizeLinear
                          (the paper's QCDQ format, §IV).  The Clip carries
                          the sub-8-bit integer boundaries of Eqs. 2-3 so
                          that *existing 8-bit backends execute <8-bit models
                          correctly* (backward compatibility).
  * ``qcdq_to_qonnx``   — fuse Q(C)DQ triples back into a single Quant
                          (the "ingestion" direction used by FINN/hls4ml).
  * ``qonnx_to_quantized_op`` — lower Quant(weights) + MatMul into the
                          quantized-operator-with-clipping style:
                          MatMulInteger over int8 tensors + Clip + output
                          scale multiply (integer-operator format extended
                          with clipping, §IV).
  * ``feature_matrix``  — Table I, enforced as code + tested.

Restrictions are faithful to the paper: QCDQ requires bit_width <= 8, static
scale/zero_point/bit_width, scalar (per-tensor) bit_width for the Clip, and
integer zero points.  ``qonnx_to_qcdq`` raises ``UnsupportedLowering`` for
graphs outside that envelope — exactly the expressiveness gap Table I shows.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import quant_ops
from .graph import Node, QonnxGraph

QONNX_DOMAIN = "qonnx.custom_op.general"


class UnsupportedLowering(ValueError):
    pass


def min_int(signed: bool, narrow: bool, bit_width) -> float:
    """Eq. 2 with ``narrow``, as a Python number (the tensor form is in
    ``quant_ops``)."""
    b = float(bit_width)
    if signed:
        return -(2.0 ** (b - 1.0)) + (1.0 if narrow else 0.0)
    return 0.0


def max_int(signed: bool, narrow: bool, bit_width) -> float:
    """Eq. 3 with ``narrow``, as a Python number."""
    b = float(bit_width)
    if signed:
        return 2.0 ** (b - 1.0) - 1.0
    return 2.0 ** b - 1.0 - (1.0 if narrow else 0.0)


# --------------------------------------------------------------- Table I

@dataclass(frozen=True)
class FormatFeatures:
    arbitrary_precision: bool
    rounding_variants: bool
    below_8bit: bool
    weights_only_quant: bool
    avoids_op_duplication: bool
    high_precision_output: bool


FEATURE_MATRIX: dict[str, FormatFeatures] = {
    # this work
    "qonnx": FormatFeatures(True, True, True, True, True, True),
    "qcdq": FormatFeatures(False, False, True, True, True, True),
    "quantized_op_clip": FormatFeatures(False, False, True, False, False, False),
    # pre-existing ONNX formats
    "qdq": FormatFeatures(False, False, False, True, True, True),
    "integer_op": FormatFeatures(False, False, False, False, False, True),
    "quantized_op": FormatFeatures(False, False, False, False, False, False),
}


# --------------------------------------------------------- QONNX -> QCDQ

def _static_quant_params(g: QonnxGraph, node: Node):
    names = node.inputs[1:4]
    if not all(n in g.initializers for n in names):
        raise UnsupportedLowering(
            f"{node.name}: dynamic scale/zero_point/bit_width cannot be "
            "lowered to QCDQ (QONNX-only feature)")
    scale = g.initializers[names[0]].astype(np.float32)
    zp = g.initializers[names[1]].astype(np.float32)
    bw = g.initializers[names[2]].astype(np.float32)
    return scale, zp, bw


def qonnx_to_qcdq(graph: QonnxGraph) -> QonnxGraph:
    """Lower every Quant node to QuantizeLinear -> Clip -> DequantizeLinear."""
    g = graph.copy()
    for node in list(g.nodes):
        if node.op_type != "Quant":
            continue
        scale, zp, bw = _static_quant_params(g, node)
        signed = bool(node.attrs.get("signed", 1))
        narrow = bool(node.attrs.get("narrow", 0))
        rmode = node.attrs.get("rounding_mode", "ROUND")
        if rmode.upper() != "ROUND":
            raise UnsupportedLowering(
                f"{node.name}: QCDQ (QuantizeLinear) only supports "
                "round-half-to-even; rounding variants are QONNX-only")
        if bw.size != 1:
            raise UnsupportedLowering(
                f"{node.name}: Clip has scalar boundaries, channel-wise "
                "bit_width cannot be lowered to QCDQ")
        nb = float(bw.reshape(()))
        if nb > 8:
            raise UnsupportedLowering(
                f"{node.name}: QuantizeLinear outputs 8-bit integers only "
                f"(requested {nb} bits)")
        if not np.all(zp == np.round(zp)):
            raise UnsupportedLowering(f"{node.name}: non-integer zero point")

        lo = min_int(signed, narrow, nb)
        hi = max_int(signed, narrow, nb)
        # carrier is int8/uint8; narrow/sub-8-bit handled by the Clip
        lo_c = int(np.ceil(max(lo, -128 if signed else 0)))
        hi_c = int(np.floor(min(hi, 127 if signed else 255)))

        x = node.inputs[0]
        y = node.outputs[0]
        s_name, z_name = node.inputs[1], node.inputs[2]
        zp_int = g.fresh_name(f"{node.name}_zp_int")
        g.initializers[zp_int] = g.initializers[z_name].astype(
            np.int8 if signed else np.uint8)
        q_out = g.fresh_name(f"{node.name}_q")
        c_out = g.fresh_name(f"{node.name}_c")
        lo_name = g.fresh_name(f"{node.name}_clip_lo")
        hi_name = g.fresh_name(f"{node.name}_clip_hi")
        g.initializers[lo_name] = np.asarray(lo_c, np.int8 if signed else np.uint8)
        g.initializers[hi_name] = np.asarray(hi_c, np.int8 if signed else np.uint8)

        idx = g.nodes.index(node)
        g.remove_node(node)
        new_nodes = [
            Node("QuantizeLinear", [x, s_name, zp_int], [q_out],
                 name=g.fresh_name(f"{node.name}_quantize")),
            Node("Clip", [q_out, lo_name, hi_name], [c_out],
                 name=g.fresh_name(f"{node.name}_clip")),
            Node("DequantizeLinear", [c_out, s_name, zp_int], [y],
                 name=g.fresh_name(f"{node.name}_dequantize")),
        ]
        for k, n in enumerate(new_nodes):
            g.nodes.insert(idx + k, n)
    for node in g.nodes:
        if node.op_type in ("BipolarQuant", "Trunc"):
            raise UnsupportedLowering(
                f"{node.op_type} has no QCDQ equivalent (QONNX-only)")
    g.validate()
    return g


# --------------------------------------------------------- QCDQ -> QONNX

def bitwidth_from_bounds(lo: float, hi: float, signed: bool):
    """Invert Eqs. 2-3: integer clip bounds -> (bit_width, narrow), or None
    when the bounds match no integer bit width.  Shared by the QCDQ
    ingestion fuse and the compiled-executor segment matcher."""
    if signed:
        nb = np.log2(hi + 1) + 1
        narrow = bool(lo == -(2 ** (nb - 1)) + 1)
    else:
        narrow = False
        nb = np.log2(hi + 1)
        if hi == 2 ** np.ceil(np.log2(hi + 2)) - 2:          # 2^n - 2 pattern
            nb2 = np.log2(hi + 2)
            if float(nb2).is_integer() and not float(nb).is_integer():
                nb, narrow = nb2, True
    if not float(nb).is_integer():
        return None
    nb = int(nb)
    lo_chk = min_int(signed, narrow, nb)
    hi_chk = max_int(signed, narrow, nb)
    if lo_chk != lo or hi_chk != hi:
        return None
    return nb, narrow


def qcdq_to_qonnx(graph: QonnxGraph) -> QonnxGraph:
    """Fuse QuantizeLinear [-> Clip] -> DequantizeLinear into one Quant.

    This is the ingestion direction: an 8-bit QDQ model (or sub-8-bit QCDQ
    model) becomes a compact QONNX graph.  The integer bit width is recovered
    from the Clip boundaries when present, else from the carrier dtype.
    """
    g = graph.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op_type != "QuantizeLinear":
                continue
            seq = [node]
            cur = node
            # optional Clip
            cons = g.consumers(cur.outputs[0])
            if len(cons) == 1 and cons[0].op_type == "Clip":
                seq.append(cons[0])
                cur = cons[0]
                cons = g.consumers(cur.outputs[0])
            if len(cons) != 1 or cons[0].op_type != "DequantizeLinear":
                continue
            dq = cons[0]
            seq.append(dq)
            # scale/zp must match between Q and DQ ends
            if node.inputs[1] != dq.inputs[1]:
                continue
            zp_name = node.inputs[2] if len(node.inputs) > 2 else None
            # a missing zero point means a uint8 carrier, matching the
            # executor's QuantizeLinear semantics
            signed = False
            if zp_name is not None and zp_name in g.initializers:
                signed = np.issubdtype(g.initializers[zp_name].dtype, np.signedinteger)
            lo, hi = (-128.0, 127.0) if signed else (0.0, 255.0)
            if len(seq) == 3:  # with Clip
                clip = seq[1]
                lo = float(np.asarray(g.initializers[clip.inputs[1]]))
                hi = float(np.asarray(g.initializers[clip.inputs[2]]))
            recovered = bitwidth_from_bounds(lo, hi, signed)
            if recovered is None:
                continue
            nb, narrow = recovered
            x = node.inputs[0]
            y = dq.outputs[0]
            s_name = node.inputs[1]
            z_f = g.fresh_name("zp_f")
            zp_val = g.initializers.get(zp_name, np.asarray(0)) if zp_name else np.asarray(0)
            g.initializers[z_f] = np.asarray(zp_val, np.float32)
            b_name = g.fresh_name("bit_width")
            g.initializers[b_name] = np.asarray(nb, np.float32)
            idx = g.nodes.index(node)
            for n in seq:
                g.remove_node(n)
            g.nodes.insert(idx, Node(
                "Quant", [x, s_name, z_f, b_name], [y],
                {"signed": int(signed), "narrow": int(narrow),
                 "rounding_mode": "ROUND"},
                name=g.fresh_name("fused_quant"), domain=QONNX_DOMAIN))
            changed = True
    g.validate()
    return g


# ------------------------------------------- quantized op with clipping

def qonnx_to_quantized_op(graph: QonnxGraph) -> QonnxGraph:
    """Lower Quant(w) -> MatMul patterns into the integer-operator style with
    clipping: int8 weights + MatMulInteger + output scale Mul (+ Clip for
    sub-8-bit activations).  Activation Quant nodes feeding the MatMul are
    absorbed as the input quantization step (QuantizeLinear + Clip).

    Faithful to the §IV limitations: weights-only graphs cannot be expressed
    (both operands must be quantized) and high-precision outputs are exposed
    only as the int32 accumulator before the scale Mul.
    """
    g = graph.copy()
    for node in list(g.nodes):
        if node.op_type != "MatMul":
            continue
        a_prod = g.producer(node.inputs[0])
        w_prod = g.producer(node.inputs[1])
        if not (a_prod and w_prod and a_prod.op_type == "Quant"
                and w_prod.op_type == "Quant"):
            raise UnsupportedLowering(
                "quantized-operator format cannot represent weights-only or "
                "activations-only quantization (Table I)")
        sa, za, ba = _static_quant_params(g, a_prod)
        sw, zw, bw = _static_quant_params(g, w_prod)
        if float(ba.max()) > 8 or float(bw.max()) > 8:
            raise UnsupportedLowering(">8 bit operands in quantized-op format")
        if w_prod.inputs[0] not in g.initializers:
            raise UnsupportedLowering("weight operand must be a constant")
        wq = quant_ops.int_repr(
            torch.from_numpy(np.asarray(g.initializers[w_prod.inputs[0]],
                                        np.float32)),
            torch.as_tensor(sw), torch.as_tensor(zw), torch.as_tensor(bw),
            signed=bool(w_prod.attrs.get("signed", 1)),
            narrow=bool(w_prod.attrs.get("narrow", 0)))
        w_int = g.fresh_name("w_int8")
        g.initializers[w_int] = np.asarray(wq.numpy(), np.int8)

        x = a_prod.inputs[0]
        sa_sc = float(np.asarray(sa).reshape(-1)[0]) if np.asarray(sa).size == 1 else None
        if sa_sc is None:
            raise UnsupportedLowering(
                "quantized ops restrict input quantization to per-tensor "
                "scale (paper §III idiosyncrasies)")
        idx = g.nodes.index(node)
        a_int = g.fresh_name("a_int8")
        a_clip = g.fresh_name("a_int8_clipped")
        acc = g.fresh_name("acc_int32")
        accf = g.fresh_name("acc_f32")
        y = node.outputs[0]
        za_i = g.fresh_name("a_zp_int")
        g.initializers[za_i] = np.asarray(za, np.int8).reshape(np.asarray(za).shape)
        lo = g.fresh_name("a_lo")
        hi = g.fresh_name("a_hi")
        signed_a = bool(a_prod.attrs.get("signed", 1))
        narrow_a = bool(a_prod.attrs.get("narrow", 0))
        nba = float(np.asarray(ba).reshape(-1)[0])
        g.initializers[lo] = np.asarray(
            int(np.ceil(min_int(signed_a, narrow_a, nba))), np.int8)
        g.initializers[hi] = np.asarray(
            int(np.floor(max_int(signed_a, narrow_a, nba))), np.int8)
        out_scale = g.fresh_name("out_scale")
        g.initializers[out_scale] = (np.asarray(sa, np.float32) *
                                     np.asarray(sw, np.float32).reshape(-1))
        zw_i = g.fresh_name("w_zp_int")
        g.initializers[zw_i] = np.asarray(zw, np.int8).reshape(np.asarray(zw).shape)

        g.remove_node(node)
        new_nodes = [
            Node("QuantizeLinear", [x, a_prod.inputs[1], za_i], [a_int],
                 name=g.fresh_name("q_in")),
            Node("Clip", [a_int, lo, hi], [a_clip], name=g.fresh_name("clip_in")),
            Node("MatMulInteger", [a_clip, w_int, za_i, zw_i], [acc],
                 name=g.fresh_name("mmi")),
            Node("Cast", [acc], [accf], {"to": "float32"}, name=g.fresh_name("cast")),
            Node("Mul", [accf, out_scale], [y], name=g.fresh_name("descale")),
        ]
        for k, n in enumerate(new_nodes):
            g.nodes.insert(idx + k, n)
    # drop orphaned Quant nodes
    from .transforms import eliminate_dead_code
    g = eliminate_dead_code(g)
    g.validate()
    return g
