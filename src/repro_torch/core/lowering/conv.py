"""Lowering rule: quantized Conv -> the integer matmul kernels (im2col).

Counterpart of ``repro.core.lowering.conv``.  Pattern (anchored at the
Conv):

    Quant|BipolarQuant|QCDQ(w) -> Conv [-> Relu] [-> Quant(act)]

  * the integer conv weights (O, I/g, kH, kW) are reshaped once, at compile
    time, into a (C·kH·kW, O) matmul operand (``kernels.im2col_weights``),
    block-diagonal for ``group > 1``;
  * at run time ``kernels.quant_conv2d`` runs the conv through B1 / B2
    as a matmul over the activation's im2col patches; stride, padding,
    dilation and the 1x1 pointwise case all reduce to how the patches are
    taken.  On the card B1 / B2 read them straight from the activation by
    address (implicit GEMM) for every conv with kH·kW > 1 or any padding;
    the CPU's twins and the unpadded pointwise conv take a materialised
    patch matrix.  The segment meta's ``conv_operand`` names the path
    (``kernels.quant_conv.conv_operand``);
  * a trailing Relu fuses as max(0, ·), and a trailing per-tensor
    activation Quant as a B4 call on the conv output, staged by the QDQ
    rule's own ``stage_qdq_epilogue``: the zoo's Conv -> Relu -> Quant
    block becomes one segment.

Grouped and depthwise convs lower through ``lowering/grouped_conv.py``
(priority 15, tried first); this rule's block-diagonal carrier is the
fallback for the group counts that rule declines, correct for any
``group`` at O(groups) extra MACs and carrier bytes.

``match_conv_common`` is the half of the pattern both rules share: the
attribute gates, the weight-chain resolution (``lowering/weights.py``),
the scale granularity, the bias and the epilogue absorption.

With the analysis tier the accumulator comes from the zero-padding-aware
conv dot-product bound (``GraphAnalysis.kernel_accumulator`` on the
conv-shaped weights) and, when ``select_requant`` proves it exact, the
Relu and the act Quant fold into the kernel's integer epilogue (B3).
With fusion on (``lowering/fusion.py``) a conv segment accepts an
integer-carried input, dequantized on entry, and offers its absorbed act
Quant's grid as its output's carrier: B4 emits the codes on the float32
epilogue, and on the integer path they are recovered exactly from the
power-of-two act grid.  Unsupported shapes (NHWC, auto_pad,
per-input-channel scales, non-constant weights or bias, 1-D / 3-D convs)
do not match and stay interpreted.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph import Node, QonnxGraph
from .base import (LoweringContext, LoweringRule, Segment, conv_channel_scale,
                   conv_out_rows, register_rule, select_accumulator,
                   sole_consumer, static_value, tensor_batch)
from .qdq import stage_qdq_epilogue, static_act_quant_params
from .requant import select_requant
from .weights import (KernelMatch, QuantWeight, chain_absorbable,
                      resolve_quant_weight, stage_kernel_carriers)


@dataclass
class ActQuantParams:
    """Static per-tensor activation-Quant params fused as an epilogue."""
    scale: np.ndarray
    zero_point: np.ndarray
    bit_width: float
    signed: bool
    narrow: bool
    rounding_mode: str


@dataclass
class ConvNeighbourhood:
    """What ``match_conv_common`` resolves: the weight chain, the
    normalized attributes and the absorbed epilogue — all a conv rule
    needs except its carrier layout."""
    qw: QuantWeight
    nodes: list[Node]            # covered nodes (chain? + conv + epilogue)
    out: str                     # tensor the fused segment produces
    scale: np.ndarray            # () or per-output-channel (O,)
    bias: Optional[np.ndarray]
    kernel_shape: tuple
    strides: tuple
    pads: tuple
    dilations: tuple
    group: int
    relu: bool
    act: Optional[ActQuantParams]


def _act_quant_params(g: QonnxGraph, node: Node) -> Optional[ActQuantParams]:
    """The QDQ rule's static-param gate, narrowed to a per-tensor scale and
    zero point (a channelwise one would sit on NCHW's non-minor channel
    axis; such a Quant stays on its own segment)."""
    params = static_act_quant_params(g, node)
    if params is None:
        return None
    s, z, nb, signed, narrow, rmode = params
    if s.size != 1 or z.size != 1:
        return None
    return ActQuantParams(
        np.asarray(s, np.float32).reshape(-1),
        np.asarray(z, np.float32).reshape(-1), nb, signed, narrow, rmode)


def match_conv_common(g: QonnxGraph, node: Node,
                      ctx: LoweringContext) -> Optional[ConvNeighbourhood]:
    """The carrier-agnostic half of the quantized-Conv pattern, or None
    when the Conv lowers onto no integer-carrier kernel."""
    if node.attrs.get("data_layout", "NCHW") != "NCHW":
        return None
    if node.attrs.get("auto_pad", "NOTSET") != "NOTSET":
        return None
    qw = resolve_quant_weight(g, node.inputs[1], ctx.analysis)
    if qw is None or qw.w_int.ndim != 4:
        return None                           # 2-D convs only
    o, ipg, kh, kw = qw.w_int.shape
    group = int(node.attrs.get("group", 1))
    if group < 1 or o % group:
        return None
    ks = tuple(int(v) for v in node.attrs.get("kernel_shape", (kh, kw)))
    if ks != (kh, kw):
        return None
    strides = tuple(int(v) for v in node.attrs.get("strides", (1, 1)))
    pads = tuple(int(v) for v in node.attrs.get("pads", (0, 0, 0, 0)))
    dilations = tuple(int(v) for v in node.attrs.get("dilations", (1, 1)))
    if len(strides) != 2 or len(pads) != 4 or len(dilations) != 2:
        return None
    scale = conv_channel_scale(qw.scale, qw.w_int.shape)
    if scale is None:
        return None
    bias = None
    if len(node.inputs) > 2 and node.inputs[2]:
        b = static_value(g, node.inputs[2])
        if b is None or b.size != o:
            return None
        bias = np.asarray(b, np.float32).reshape(-1)

    nodes = list(qw.chain) + [node] if chain_absorbable(g, qw.chain, node) \
        else [node]

    # epilogue absorption: [-> Relu] [-> Quant(act)]
    out = node.outputs[0]
    relu = False
    act = None
    nxt = sole_consumer(g, out)
    if nxt is not None and nxt.op_type == "Relu":
        relu = True
        nodes.append(nxt)
        out = nxt.outputs[0]
        nxt = sole_consumer(g, out)
    if nxt is not None and nxt.op_type == "Quant":
        act = _act_quant_params(g, nxt)
        if act is not None:
            nodes.append(nxt)
            out = nxt.outputs[0]

    return ConvNeighbourhood(
        qw, nodes, out, np.asarray(scale, np.float32), bias,
        ks, strides, pads, dilations, group, relu, act)


def select_conv_paths(ctx: LoweringContext, g: QonnxGraph, node: Node,
                      m: KernelMatch, nb: ConvNeighbourhood) -> None:
    """Both conv rules' analysis hooks: the accumulator bound on the
    conv-shaped weights (it contracts the true I/g·kH·kW field, zero-padding
    aware, whatever carrier layout the rule stages), then the integer
    requant with the absorbed Relu / act Quant.  The per-channel |w| sums
    in natural O order are the group-major order of the (O,) scale."""
    select_accumulator(ctx, node, m, w_int=nb.qw.w_int)
    select_requant(ctx, g, node, m,
                   w_absum=np.abs(nb.qw.w_int.astype(np.int64))
                   .sum(axis=(1, 2, 3)),
                   relu=nb.relu, act=nb.act)


def offer_conv_carriers(ctx: LoweringContext, m: KernelMatch,
                        codes_out: bool = True) -> None:
    """With fusion on, a conv segment accepts a carried input and, where it
    absorbed an act Quant and can produce its codes (``codes_out``),
    offers that grid as its output's carrier."""
    if not ctx.use_fusion:
        return
    from . import fusion
    m.carrier_accepts = (m.x,)
    if m.act is not None and codes_out:
        m.carrier_out = fusion.carrier_from_act(m.act)


def stage_act_epilogue(idx: int, m: KernelMatch, consts: dict,
                       ctx: LoweringContext, emit_codes: bool = False):
    """Stage a conv segment's absorbed activation Quant exactly as the QDQ
    rule would, unless there is none or the integer path folds it into the
    kernel's IntRequant.  Returns ``(kernel_fn_or_None, const keys)``."""
    act = m.act
    if act is None or m.requant is not None:
        return None, ()
    qdq, keys, _ = stage_qdq_epilogue(
        idx, consts, ctx, scale=act.scale, zero_point=act.zero_point,
        bit_width=act.bit_width, signed=act.signed, narrow=act.narrow,
        rounding_mode=act.rounding_mode, emit_codes=emit_codes)
    return qdq, keys


def conv_epilogue(y: torch.Tensor, relu: bool, qdq, consts: dict,
                  act_keys: tuple) -> torch.Tensor:
    """The unfused half of a conv segment's epilogue: Relu, then the act
    Quant as one B4 launch on the (N, C·H·W) view."""
    if relu:
        y = torch.relu(y)
    if qdq is not None:
        y = qdq(y.reshape(y.shape[0], -1), consts[act_keys[0]],
                consts[act_keys[1]]).reshape(y.shape)
    return y


@dataclass
class QuantConvMatch(KernelMatch):
    kernel_shape: tuple = (1, 1)
    strides: tuple = (1, 1)
    pads: tuple = (0, 0, 0, 0)
    dilations: tuple = (1, 1)
    group: int = 1
    relu: bool = False
    act: Optional[ActQuantParams] = None


@register_rule
class QuantConvRule(LoweringRule):
    name = "quant_conv"
    anchor_ops = ("Conv",)
    priority = 20

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[QuantConvMatch]:
        from repro_torch.kernels.quant_conv import im2col_weights

        nb = match_conv_common(g, node, ctx)
        if nb is None:
            return None
        w2 = im2col_weights(nb.qw.w_int, nb.group)     # (C·kH·kW, O) int8
        m = QuantConvMatch(
            nb.nodes, node.inputs[0], nb.out, w2, nb.scale, nb.bias,
            nb.qw.int4_values and w2.shape[0] % 2 == 0,
            rows=conv_out_rows(g, node), batch=tensor_batch(g, node.inputs[0]),
            kernel_shape=nb.kernel_shape, strides=nb.strides, pads=nb.pads,
            dilations=nb.dilations, group=nb.group, relu=nb.relu, act=nb.act)
        select_conv_paths(ctx, g, node, m, nb)
        offer_conv_carriers(ctx, m)
        return m

    def emit(self, idx: int, m: QuantConvMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        from repro_torch.kernels import ops as kernel_ops

        from . import fusion

        cin, cout = fusion.fusion_carriers(ctx, m.x, m.out)
        kind, use_int4, w_key, s_key, b_key, meta, blocks_at = \
            stage_kernel_carriers(idx, m, consts, ctx,
                                  ("quant_conv", "quant_conv_int4"))
        conv = functools.partial(
            kernel_ops.quant_conv2d, kernel_shape=m.kernel_shape,
            strides=m.strides, pads=m.pads, dilations=m.dilations,
            packed=use_int4, **m.body())
        qdq, act_keys = stage_act_epilogue(idx, m, consts, ctx,
                                           emit_codes=cout is not None)
        # integer path: Relu and the act Quant live in the IntRequant
        x_name, out_name = m.x, m.out
        relu = m.relu and m.requant is None
        code = fusion.code_recovery(m.requant, cout)

        def run(consts, env):
            x = env.get(x_name, consts.get(x_name))
            if cin is not None:
                x = fusion.boundary_values(x, cin)
            y = conv(x, consts[w_key], consts[s_key],
                     consts[b_key] if b_key else None, blocks=blocks_at(x))
            y = conv_epilogue(y, relu, qdq, consts, act_keys)
            env[out_name] = fusion.carried_output(y, cout, code)

        meta["conv_operand"] = kernel_ops.conv_operand(
            m.kernel_shape, m.pads, ctx.device)
        if m.group > 1:
            meta["group"] = m.group
        if cin is not None or cout is not None:
            fusion._carrier_meta(meta, cin, cout)
        keys = (w_key, s_key) + ((b_key,) if b_key else ()) + act_keys
        return Segment(kind, m.nodes, [x_name], [out_name], run, keys, meta)
