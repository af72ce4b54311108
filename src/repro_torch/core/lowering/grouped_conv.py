"""Lowering rule: grouped / depthwise quantized Conv onto B5 and B6.

Counterpart of ``repro.core.lowering.grouped_conv``.  The dense conv
rule's pattern (``lowering/conv.py``):

    Quant|BipolarQuant|QCDQ(w) -> Conv [-> Relu] [-> Quant(act)]

anchored before it (priority 15 < 20), claiming the ``group > 1`` convs
the dense rule would lower through a block-diagonal carrier at O(groups)
wasted MACs and carrier bytes.  Two kernel targets:

  * ``group == C`` with multiplier 1 (MobileNet's depthwise layers) —
    ``kernels.quant_depthwise_conv2d`` (B6), with the dequant -> bias ->
    ReLU -> requant epilogue fused in the kernel; the trailing Quant's
    constants are staged by the QDQ rule's ``stage_qdq_epilogue``, so the
    requant is the one B4 would apply;
  * moderate group counts (2 .. ``MAX_BLOCKED_GROUPS``) —
    ``kernels.quant_grouped_conv2d`` (B5), each group's patch slice
    contracting only its own (I/g·kH·kW, O/g) weight block, int4 packing
    per group.

Group counts neither kernel takes (``group > MAX_BLOCKED_GROUPS`` with a
channel multiplier) decline and keep the dense block-diagonal fallback.
Each segment records the MACs and carrier bytes it saves against that
fallback (``reclaimed_macs`` / ``carrier_bytes_saved`` in its meta), which
``CompiledPlan.grouped_conv_stats`` sums.  The accumulator and the
integer requant path are selected as the dense rule selects them
(``conv.select_conv_paths``): the bound already contracts per output
channel over the true I/g·kH·kW field, so it is group-exact.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from ..graph import Node, QonnxGraph
from .base import (LoweringContext, LoweringRule, Segment, conv_out_rows,
                   register_rule)
from .conv import (QuantConvMatch, conv_epilogue, match_conv_common,
                   select_conv_paths, stage_act_epilogue)
from .weights import stage_kernel_carriers

# beyond this the per-group kernel's tiles get small and its grid G times
# longer than one dense block-diagonal matmul's; such convs keep the dense
# fallback, except depthwise, whose kernel is O(C) at any channel count
MAX_BLOCKED_GROUPS = 64


@dataclass
class GroupedConvMatch(QuantConvMatch):
    """Dense conv match plus the grouped-carrier bookkeeping.  ``w_int``
    holds the per-group carrier (G, Kg, Ng), or the depthwise tap matrix
    (kH·kW, C) when ``depthwise``."""
    depthwise: bool = False
    reclaimed_macs: int = 0          # vs the block-diagonal dense carrier
    dense_int4_ok: bool = False      # would the dense fallback have packed?


def _out_spatial(g: QonnxGraph, node: Node) -> int:
    """Output positions of one sample (OH·OW), 0 when shapes are unknown."""
    shape = g.get_shape(node.outputs[0])
    if shape is None or len(shape) < 3:
        return 0
    n = 1
    for d in shape[2:]:
        if d is None:
            return 0
        n *= int(d)
    return n


@register_rule
class GroupedConvRule(LoweringRule):
    name = "quant_grouped_conv"
    anchor_ops = ("Conv",)
    priority = 15                    # tried before the dense conv rule

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[GroupedConvMatch]:
        from repro_torch.kernels.quant_grouped_conv import (depthwise_weights,
                                                            grouped_weights)

        nb = match_conv_common(g, node, ctx)
        if nb is None or nb.group <= 1:
            return None              # dense rule's territory
        o, ipg, kh, kw = nb.qw.w_int.shape
        depthwise = ipg == 1 and o == nb.group
        if not depthwise and nb.group > MAX_BLOCKED_GROUPS:
            return None              # block-diagonal dense fallback

        if depthwise:
            w_carrier = depthwise_weights(nb.qw.w_int)     # (kH·kW, C)
            int4_ok = False          # kH·kW taps: nothing worth packing
        else:
            w_carrier = grouped_weights(nb.qw.w_int, nb.group)  # (G, Kg, Ng)
            int4_ok = nb.qw.int4_values and (ipg * kh * kw) % 2 == 0

        # what the dense fallback spends extra: each of the g-1 foreign
        # groups adds ipg·kH·kW zero rows per output channel, both carrier
        # entries and (per output position) MACs; its carrier bytes are
        # priced at its own int4 eligibility (dense K = C·kH·kW evenness)
        saved_entries = (nb.group - 1) * ipg * kh * kw * o
        m = GroupedConvMatch(
            nb.nodes, node.inputs[0], nb.out, w_carrier, nb.scale, nb.bias,
            int4_ok, rows=conv_out_rows(g, node),
            kernel_shape=nb.kernel_shape, strides=nb.strides,
            pads=nb.pads, dilations=nb.dilations, group=nb.group,
            relu=nb.relu, act=nb.act, depthwise=depthwise,
            reclaimed_macs=saved_entries * _out_spatial(g, node),
            dense_int4_ok=nb.qw.int4_values and
            (ipg * nb.group * kh * kw) % 2 == 0)
        select_conv_paths(ctx, g, node, m, nb)
        return m

    def emit(self, idx: int, m: GroupedConvMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        from repro_torch.kernels import ops as kernel_ops

        kinds = ("quant_conv_dw",) * 2 if m.depthwise else \
            ("quant_conv_grouped", "quant_conv_grouped_int4")
        kind, use_int4, w_key, s_key, b_key, meta = stage_kernel_carriers(
            idx, m, consts, ctx, kinds, pack=kernel_ops.pack_int4_grouped)
        qdq, act_keys = stage_act_epilogue(idx, m, consts, ctx)
        # integer path: Relu and the act Quant live in the IntRequant
        x_name, out_name = m.x, m.out
        relu = m.relu and m.requant is None
        act = m.act if m.requant is None else None

        if m.depthwise:
            # the fp32 path's act Quant runs inside B6, on the constants
            # staged above
            conv = functools.partial(
                kernel_ops.quant_depthwise_conv2d,
                kernel_shape=m.kernel_shape, strides=m.strides, pads=m.pads,
                dilations=m.dilations, relu=relu,
                act_bits=None if act is None else act.bit_width,
                act_signed=act.signed if act else True,
                act_narrow=act.narrow if act else False,
                act_rounding=act.rounding_mode if act else "ROUND",
                **m.body())

            def run(consts, env):
                x = env.get(x_name, consts.get(x_name))
                env[out_name] = conv(
                    x.to(torch.float32).contiguous(), consts[w_key],
                    consts[s_key], consts[b_key] if b_key else None,
                    *(consts[k] for k in act_keys))
        else:
            conv = functools.partial(
                kernel_ops.quant_grouped_conv2d, groups=m.group,
                kernel_shape=m.kernel_shape, strides=m.strides, pads=m.pads,
                dilations=m.dilations, packed=use_int4, **m.body())

            def run(consts, env):
                x = env.get(x_name, consts.get(x_name))
                y = conv(x, consts[w_key], consts[s_key],
                         consts[b_key] if b_key else None)
                env[out_name] = conv_epilogue(y, relu, qdq, consts, act_keys)

        meta["group"] = m.group
        meta["reclaimed_macs"] = m.reclaimed_macs
        # dense fallback's carrier (g× our entries, at its int4
        # eligibility) minus this segment's, at the staged width
        own_entries = m.w_int.size
        meta["carrier_bytes_saved"] = int(
            own_entries * m.group * (0.5 if m.dense_int4_ok else 1.0) -
            own_entries * (0.5 if use_int4 else 1.0))
        keys = (w_key, s_key) + ((b_key,) if b_key else ()) + act_keys
        return Segment(kind, m.nodes, [x_name], [out_name], run, keys, meta)
