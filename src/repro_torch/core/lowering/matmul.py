"""Lowering rule: quantized weights into MatMul/Gemm -> integer matmul kernel.

Counterpart of ``repro.core.lowering.matmul``.  Pattern (anchored at the
MatMul/Gemm):

    Quant|BipolarQuant|QCDQ(w) -> MatMul/Gemm [-> Mul(descale)] [-> Add(bias)]

The weight chain is evaluated offline into an int8 (or packed int4)
carrier; a constant per-column Mul below the matmul folds into the
dequant scale and a constant per-column Add into the bias, so the whole
affine tail runs inside one ``kernels.quant_matmul[_int4]`` launch.  With
the analysis tier the accumulator (``select_accumulator``) and the integer
requant path (``select_requant``) are chosen per match.  With fusion on,
the rule accepts an integer-carried activation and dequantizes it on entry
(``fusion.boundary_values``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph import Node, QonnxGraph
from .base import (LoweringContext, LoweringRule, Segment, col_scale,
                   register_rule, select_accumulator, sole_consumer,
                   static_value, tensor_batch, tensor_rows)
from .requant import select_requant
from .weights import (KernelMatch, chain_absorbable, resolve_quant_weight,
                      stage_kernel_carriers)

_MATMUL_OPS = ("MatMul", "Gemm")


@dataclass
class QuantMatMulMatch(KernelMatch):
    pass


def make_matmul_segment(idx: int, m: KernelMatch, consts: dict,
                        ctx: LoweringContext, *,
                        kinds=("quant_matmul", "quant_matmul_int4")) -> Segment:
    """Stage carriers into ``consts`` and build the fused matmul segment
    over the flattened-leading-dims activation."""
    from repro_torch.kernels import ops as kernel_ops

    from . import fusion

    (cin,) = fusion.fusion_carriers(ctx, m.x)
    kind, use_int4, w_key, s_key, b_key, meta, blocks_at = \
        stage_kernel_carriers(idx, m, consts, ctx, kinds)
    # integer path: the kernel is fed grid indices (q - z).  It divides x
    # by s_x as it stages the tile, an IEEE division whose true quotient is
    # a representable integer (select_requant proved it), so it is exact.
    kernel = functools.partial(
        kernel_ops.quant_matmul_int4 if use_int4 else kernel_ops.quant_matmul,
        **m.body())
    x_name, out_name = m.x, m.out

    def run(consts, env):
        x = env.get(x_name, consts.get(x_name))
        if cin is not None:
            x = fusion.boundary_values(x, cin)
        lead = tuple(x.shape[:-1])
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
        y = kernel(x2, consts[w_key], consts[s_key],
                   consts[b_key] if b_key else None, blocks=blocks_at(x))
        env[out_name] = y.reshape(lead + (y.shape[-1],))

    keys = (w_key, s_key, b_key) if b_key else (w_key, s_key)
    if cin is not None:
        fusion._carrier_meta(meta, cin, None)
    return Segment(kind, m.nodes, [x_name], [out_name], run, keys, meta)


@register_rule
class QuantMatMulRule(LoweringRule):
    name = "quant_matmul"
    anchor_ops = _MATMUL_OPS
    priority = 10

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[QuantMatMulMatch]:
        if node.op_type == "Gemm":
            a = node.attrs
            if a.get("alpha", 1.0) != 1.0 or a.get("beta", 1.0) != 1.0 or \
                    a.get("transA", 0) or a.get("transB", 0):
                return None
        qw = resolve_quant_weight(g, node.inputs[1], ctx.analysis)
        if qw is None or qw.w_int.ndim != 2:
            return None
        kdim, n = qw.w_int.shape
        scale = col_scale(qw.scale, n)
        if scale is None:
            return None
        int4_ok = qw.int4_values and kdim % 2 == 0
        nodes = [node]
        # only absorb the weight chain when this matmul is its sole reader
        if chain_absorbable(g, qw.chain, node):
            nodes = qw.chain + nodes
        m = _finish_match(g, node, nodes, n, qw.w_int, scale, int4_ok)
        if m is not None:
            select_accumulator(ctx, node, m)
            select_requant(ctx, g, node, m,
                           w_absum=np.abs(m.w_int.astype(np.int64))
                           .sum(axis=0))
            if ctx.use_fusion:
                # accept only: the matmul dequantizes a carried activation
                # on entry; it offers no codes (its epilogue stays as is)
                m.carrier_accepts = (m.x,)
        return m

    def emit(self, idx: int, match: QuantMatMulMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        return make_matmul_segment(idx, match, consts, ctx)


def _finish_match(g: QonnxGraph, node: Node, nodes: list[Node], n: int,
                  w_int: np.ndarray, scale, int4_ok: bool
                  ) -> Optional[QuantMatMulMatch]:
    """Shared tail: Gemm bias operand, then optional constant descale Mul
    and bias Add below the matmul."""
    bias = None
    if node.op_type == "Gemm" and len(node.inputs) > 2 and node.inputs[2]:
        bias = static_value(g, node.inputs[2])
        if bias is None:
            return None

    out = node.outputs[0]
    mul = sole_consumer(g, out)
    if mul is not None and mul.op_type == "Mul" and bias is None:
        d = static_value(g, mul.inputs[1] if mul.inputs[0] == out
                         else mul.inputs[0])
        d = None if d is None else col_scale(d, n)
        if d is not None:
            scale = (scale * d).astype(np.float32)
            nodes.append(mul)
            out = mul.outputs[0]
    add = sole_consumer(g, out)
    if add is not None and add.op_type == "Add":
        b = static_value(g, add.inputs[1] if add.inputs[0] == out
                         else add.inputs[0])
        # only a scalar or a last-axis (N,)-broadcast constant is a fusable
        # bias — an (N, 1) column constant broadcasts over rows and would
        # change the output shape
        if b is not None and (b.size == 1 or
                              (b.ndim >= 1 and b.shape[-1] == b.size == n)):
            bias = (np.zeros(n, np.float32) if bias is None else bias) + \
                np.asarray(b, np.float32).reshape(-1 if b.size == n else 1)
            nodes.append(add)
            out = add.outputs[0]

    return QuantMatMulMatch(nodes, node.inputs[0], out, w_int,
                            np.asarray(scale, np.float32), bias, int4_ok,
                            rows=tensor_rows(g, node.inputs[0]),
                            batch=tensor_batch(g, node.inputs[0]))
