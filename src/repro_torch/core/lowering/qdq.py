"""Lowering rules: activation quantizers -> the fused QDQ kernel (B4).

Counterpart of ``repro.core.lowering.qdq``.  Two patterns, both producing
the same segment:

  * ``quant_qdq``   — a high-level activation ``Quant`` with static params;
  * ``qcdq_chain``  — ``QuantizeLinear [-> Clip] -> DequantizeLinear`` with
    the bit width recovered from the Clip bounds
    (``formats.bitwidth_from_bounds``).

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
from ..formats import bitwidth_from_bounds
from ..graph import Node, QonnxGraph
from .base import (LoweringContext, LoweringRule, Match, Segment,
                   blocks_at, register_rule, scalar, sole_consumer,
                   static_value, tensor_batch, tensor_rows)


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
    rows: Optional[int] = None   # flattened leading dims (tuner bucketing)
    cols: Optional[int] = None   # last dim
    batch: int = 1               # x's declared leading dim
    carrier_accepts: tuple = ()  # inputs acceptable as integer carriers
    carrier_out: Optional[object] = None   # fusion.Carrier offer for out


def stage_qdq_epilogue(idx: int, consts: dict, ctx: LoweringContext, *,
                       scale, zero_point, bit_width, signed, narrow,
                       rounding_mode, shape=None, emit_codes=False):
    """Stage one activation Quant's constants and build its kernel closure.

    The one place a Quant's realization on ``kernels.quant_dequant`` (B4)
    is staged: the QDQ rules, the conv rules' epilogue absorption and the
    residual-add rule all call it, so a Quant stages identical constants
    (``__seg{idx}_qs`` / ``__seg{idx}_qz``) and parameters whichever
    segment absorbs it; the depthwise kernel (B6) reads the same constants
    in its fused epilogue.

    ``emit_codes=True`` makes the kernel return the int8 codes instead of
    the dequantized values: the codes it clips and rounds either way, so a
    carried boundary holds the same integers the float32 one encodes.

    ``shape`` is the kernel's flattened ``(rows, cols)`` view when known:
    with a tuner on the context it selects the launch geometry (the QDQ
    segments pass it, as the reference's do, and pass the tuned blocks to
    the kernel per call through ``base.blocks_at``).

    Returns ``(kernel_fn, (s_key, z_key), block_cfg_or_None)``."""
    from repro_torch.kernels.ops import quant_dequant

    s_key, z_key = f"__seg{idx}_qs", f"__seg{idx}_qz"
    consts[s_key] = to_tensor(np.asarray(scale, np.float32), ctx.device)
    consts[z_key] = to_tensor(np.asarray(zero_point, np.float32), ctx.device)
    cfg = None
    tuner = ctx.tuner
    if tuner is not None and shape is not None and \
            shape[0] is not None and shape[1] is not None:
        cfg = tuner.blocks_for(tuner.sig(
            "qdq", rows=shape[0], n=shape[1], k=0, bits=int(bit_width)))
    kernel = functools.partial(
        quant_dequant, bit_width=bit_width, signed=signed, narrow=narrow,
        rounding_mode=rounding_mode, emit_codes=emit_codes)
    return kernel, (s_key, z_key), cfg


def make_qdq_segment(idx: int, m: QDQMatch, consts: dict,
                     ctx: LoweringContext) -> Segment:
    from . import fusion

    cin, cout = fusion.fusion_carriers(ctx, m.x, m.out)
    kernel, (s_key, z_key), cfg = stage_qdq_epilogue(
        idx, consts, ctx, scale=m.scale, zero_point=m.zero_point,
        bit_width=m.bit_width, signed=m.signed, narrow=m.narrow,
        rounding_mode=m.rounding_mode, shape=(m.rows, m.cols),
        emit_codes=cout is not None)
    x_name, out_name = m.x, m.out
    at = blocks_at(cfg, m.rows, m.batch)

    def run(consts, env):
        x = env.get(x_name, consts.get(x_name))
        if cin is not None:
            x = fusion.boundary_values(x, cin)
        x2 = x.reshape(1, -1) if x.ndim < 2 else x
        y = kernel(x2.contiguous(), consts[s_key], consts[z_key],
                   blocks=at(x2))
        y = y.reshape(x.shape)
        env[out_name] = y if cout is None else fusion.boundary_out(y, cout)

    meta = {} if cfg is None else {"blocks": list(cfg.blocks),
                                   "tuned": cfg.source}
    if cin or cout:
        meta = fusion._carrier_meta(meta, cin, cout)
    return Segment("quant_dequant", m.nodes, [x_name], [out_name], run,
                   (s_key, z_key), meta)


def _offer_carriers(m: QDQMatch, ctx: LoweringContext, s, z) -> QDQMatch:
    """With fusion on, a QDQ segment accepts a carried input and offers
    its own grid as the output's carrier."""
    if ctx.use_fusion:
        from . import fusion
        m.carrier_accepts = (m.x,)
        m.carrier_out = fusion.carrier_from_params(
            s, z, m.bit_width, m.signed, m.narrow)
    return m


def _last_dim(g: QonnxGraph, x: str) -> Optional[int]:
    sh = g.get_shape(x)
    return sh[-1] if sh else None


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
        return _offer_carriers(QDQMatch(
            [node], node.inputs[0], node.outputs[0],
            np.asarray(s, np.float32).reshape(-1),
            np.asarray(z, np.float32).reshape(-1), nb, signed, narrow, rmode,
            rows=tensor_rows(g, node.inputs[0]),
            cols=_last_dim(g, node.inputs[0]),
            batch=tensor_batch(g, node.inputs[0])), ctx, s, z)

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
        return _offer_carriers(QDQMatch(
            seq, node.inputs[0], dq.outputs[0],
            np.asarray(s, np.float32).reshape(-1),
            np.asarray(z, np.float32).reshape(-1), float(nb), signed, narrow,
            "ROUND", rows=tensor_rows(g, node.inputs[0]),
            cols=_last_dim(g, node.inputs[0]),
            batch=tensor_batch(g, node.inputs[0])), ctx, s, z)

    def emit(self, idx: int, match: QDQMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        return make_qdq_segment(idx, match, consts, ctx)
