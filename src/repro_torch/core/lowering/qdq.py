"""Lowering rules: activation quantizers -> the fused QDQ kernel (B4).

Counterpart of ``repro.core.lowering.qdq``.  Two patterns, both producing
the same segment:

  * ``quant_qdq``   — a high-level activation ``Quant`` with static params;
  * ``qcdq_chain``  — ``QuantizeLinear [-> Clip] -> DequantizeLinear`` with
    the bit width recovered from the Clip bounds.

Both lower onto ``kernels.quant_dequant``, which fuses quantize + clamp +
dequantize into one pass over the tensor.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import quant_ops
from ..executor import to_tensor
from ..graph import Node, QonnxGraph
from .base import (LoweringContext, LoweringRule, Match, Segment,
                   register_rule, scalar, sole_consumer, static_value)


def bitwidth_from_bounds(lo: float, hi: float, signed: bool):
    """Invert Eqs. 2-3: integer clip bounds -> (bit_width, narrow), or None
    when the bounds match no integer bit width (the reference keeps this in
    ``repro.core.formats``, whose port is still queued)."""
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
    lo_chk = float(quant_ops.min_int(signed, narrow, nb))
    hi_chk = float(quant_ops.max_int(signed, narrow, nb))
    if lo_chk != lo or hi_chk != hi:
        return None
    return nb, narrow


def static_act_quant_params(g: QonnxGraph, node: Node):
    """Static params of an activation ``Quant`` the QDQ kernel can realize:
    ``(s, z, nb, signed, narrow, rounding_mode)`` or None (non-static
    params, channelwise bit width, unknown rounding mode)."""
    s, z, bw = (static_value(g, i) for i in node.inputs[1:4])
    if s is None or z is None or bw is None:
        return None
    nb = scalar(bw)
    if nb is None:
        return None
    rmode = str(node.attrs.get("rounding_mode", "ROUND")).upper()
    if rmode not in quant_ops.ROUNDING_MODES:
        return None       # mode the QDQ kernel can't realize: keep interp
    return (s, z, nb, bool(node.attrs.get("signed", 1)),
            bool(node.attrs.get("narrow", 0)), rmode)


@dataclass
class QDQMatch(Match):
    x: str
    out: str
    scale: np.ndarray            # () or (C,) last-dim channelwise
    zero_point: np.ndarray
    bit_width: float
    signed: bool
    narrow: bool
    rounding_mode: str


def stage_qdq_epilogue(idx: int, consts: dict, ctx: LoweringContext, *,
                       scale, zero_point, bit_width, signed, narrow,
                       rounding_mode):
    """Stage one activation Quant's constants and build its kernel closure.

    The one place a Quant's realization on ``kernels.quant_dequant`` (B4)
    is staged: the QDQ rules and the conv rules' epilogue absorption both
    call it, so a Quant stages identical constants (``__seg{idx}_qs`` /
    ``__seg{idx}_qz``) and parameters whichever segment absorbs it; the
    depthwise kernel (B6) reads the same constants in its fused epilogue.

    Returns ``(kernel_fn, (s_key, z_key))``."""
    from repro_torch.kernels.ops import quant_dequant

    s_key, z_key = f"__seg{idx}_qs", f"__seg{idx}_qz"
    consts[s_key] = to_tensor(np.asarray(scale, np.float32), ctx.device)
    consts[z_key] = to_tensor(np.asarray(zero_point, np.float32), ctx.device)
    kernel = functools.partial(quant_dequant, bit_width=bit_width,
                               signed=signed, narrow=narrow,
                               rounding_mode=rounding_mode)
    return kernel, (s_key, z_key)


def make_qdq_segment(idx: int, m: QDQMatch, consts: dict,
                     ctx: LoweringContext) -> Segment:
    kernel, (s_key, z_key) = stage_qdq_epilogue(
        idx, consts, ctx, scale=m.scale, zero_point=m.zero_point,
        bit_width=m.bit_width, signed=m.signed, narrow=m.narrow,
        rounding_mode=m.rounding_mode)
    x_name, out_name = m.x, m.out

    def run(consts, env):
        x = env.get(x_name, consts.get(x_name))
        x2 = x.reshape(1, -1) if x.ndim < 2 else x
        y = kernel(x2.contiguous(), consts[s_key], consts[z_key])
        env[out_name] = y.reshape(x.shape)

    return Segment("quant_dequant", m.nodes, [x_name], [out_name], run,
                   (s_key, z_key))


def _channel_params_ok(g: QonnxGraph, x: str, *params) -> bool:
    """The kernel takes per-tensor or last-dim (N,) params only."""
    sh = g.get_shape(x)
    lastdim = sh[-1] if sh else None
    return all(p.size == 1 or (lastdim is not None and p.size == lastdim)
               for p in params)


@register_rule
class ActivationQuantRule(LoweringRule):
    """A high-level activation Quant with static params -> fused QDQ kernel."""

    name = "quant_qdq"
    anchor_ops = ("Quant",)
    priority = 30

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[QDQMatch]:
        if node.inputs[0] in g.initializers:
            return None                   # weight quantizer, not activation
        params = static_act_quant_params(g, node)
        if params is None:
            return None
        s, z, nb, signed, narrow, rmode = params
        if not _channel_params_ok(g, node.inputs[0], s, z):
            return None
        return QDQMatch(
            [node], node.inputs[0], node.outputs[0],
            np.asarray(s, np.float32).reshape(-1),
            np.asarray(z, np.float32).reshape(-1), nb, signed, narrow, rmode)

    def emit(self, idx: int, match: QDQMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        return make_qdq_segment(idx, match, consts, ctx)


@register_rule
class QCDQChainRule(LoweringRule):
    """QuantizeLinear [-> Clip] -> DequantizeLinear -> fused QDQ kernel."""

    name = "qcdq_chain"
    anchor_ops = ("QuantizeLinear",)
    priority = 40

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[QDQMatch]:
        if node.inputs[0] in g.initializers:
            return None                   # weight chain (matmul rule)
        seq = [node]
        cur = sole_consumer(g, node.outputs[0])
        if cur is not None and cur.op_type == "Clip":
            seq.append(cur)
            cur = sole_consumer(g, cur.outputs[0])
        if cur is None or cur.op_type != "DequantizeLinear":
            return None
        dq = cur
        seq.append(dq)
        if node.inputs[1] != dq.inputs[1]:
            return None
        s = static_value(g, node.inputs[1])
        zp_name = node.inputs[2] if len(node.inputs) > 2 else None
        z = static_value(g, zp_name) if zp_name else np.zeros(1, np.float32)
        if s is None or z is None or np.any(z != np.round(z)):
            return None
        # no zero-point input means a uint8 carrier (executor._quantize_linear)
        signed = bool(np.issubdtype(z.dtype, np.signedinteger)) \
            if zp_name else False
        lo, hi = (-128.0, 127.0) if signed else (0.0, 255.0)
        if len(seq) == 3:
            clip = seq[1]
            clo = static_value(g, clip.inputs[1])
            chi = static_value(g, clip.inputs[2])
            if clo is None or chi is None:
                return None
            lo, hi = float(clo), float(chi)
        recovered = bitwidth_from_bounds(lo, hi, signed)
        if recovered is None:
            return None
        nb, narrow = recovered
        if not _channel_params_ok(g, node.inputs[0], s, z):
            return None
        return QDQMatch(
            seq, node.inputs[0], dq.outputs[0],
            np.asarray(s, np.float32).reshape(-1),
            np.asarray(z, np.float32).reshape(-1), float(nb), signed, narrow,
            "ROUND")

    def emit(self, idx: int, match: QDQMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        return make_qdq_segment(idx, match, consts, ctx)
