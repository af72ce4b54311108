"""Cross-segment fusion: integer carriers across fused-segment boundaries.

Counterpart of ``repro.core.lowering.fusion``.  Without this pass every
segment boundary of the compiled tier is a float32 tensor and every
non-kernel op between segments (residual ``Add``, ``MaxPool`` /
``AveragePool``, ``Concat``, activation ``BipolarQuant``) runs on the
interpreter.  This module adds both halves of the fix:

  1. **fused boundary segments** — four lowering rules (priority 50+, tried
     after the kernel rules) lower pooling, residual ``Add [-> Relu]
     [-> Quant]`` tails, ``Concat`` and activation ``BipolarQuant`` into
     plan segments that compute the oracle's own expressions;

  2. **integer inter-segment carriers** — a negotiation pass between the
     partitioner's match and emit passes decides, per boundary tensor,
     whether it travels as int8 quantization codes (nibble-packed two a
     byte along the last axis when it has at most 4 bits, 3 unsigned)
     instead of float32.

Carrier protocol (duck-typed fields on a rule's ``Match``):

  ``carrier_accepts`` — input tensor names whose values the emitter can
      rebuild from codes (every rule here, and the matmul / conv / QDQ
      kernel rules for their activation input);
  ``carrier_out``     — a static ``Carrier`` the emitter can produce for
      ``match.out`` (rules that absorb a per-tensor activation ``Quant`` or
      ``BipolarQuant`` know the output grid at compile time);
  ``carrier_pass``    — an input tensor name whose carrier passes through
      unchanged (MaxPool: dequantization is monotone).

``negotiate_carriers`` walks the matched anchors in topo order and carries
a tensor iff its producer offers, it is not a graph output, and **every**
consumer's covering match accepts it.  The decisions land on
``LoweringContext.fusion``, where the emit closures read them; a declined
boundary keeps the float32 tensor it had without this pass.

Exactness: a consumer rebuilds values as ``(codes - z) * s``, the float32
expression the oracle's own dequantization evaluates on the same integers
(two operations, each rounded once: a cast and a subtraction that are
exact, then one product), so dequantize-on-entry is bit-same for any scale
family; the code-domain shortcuts (max pooling, the integer average-pool
sum) are gated on the proofs at their emit sites.  On a CUDA plan every
op here runs on the card; an op with no CUDA implementation raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..graph import Node, QonnxGraph
from .base import (LoweringContext, LoweringRule, Match, Segment,
                   register_rule, scalar, sole_consumer, static_value)
from .conv import ActQuantParams, _act_quant_params
from .qdq import stage_qdq_epilogue

# float32 integer-exactness bound (see lowering/requant.py)
_EXACT = float(1 << 24)


# ---------------------------------------------------------------- carriers

@dataclass(frozen=True)
class Carrier:
    """Integer boundary representation of one inter-segment tensor.

    The tensor travels as int8 quantization codes ``q`` with
    ``value = (q - zero_point) * scale``; when ``packed`` the codes are
    int4 nibbles, two a byte along the last axis (uint8)."""
    scale: float
    zero_point: float            # integral, stored as float
    bits: int                    # logical width (1..8)
    signed: bool = True
    packed: bool = False

    @property
    def bytes_per_elem(self) -> float:
        return 0.5 if self.packed else 1.0


@dataclass
class FusionPlan:
    """Negotiated carrier decisions and the stats ``fusion_stats`` shows."""
    carriers: dict = field(default_factory=dict)    # tensor -> Carrier
    offered: int = 0             # boundary tensors some producer offered
    declined: int = 0            # offers a consumer / graph output vetoed
    bytes_saved: int = 0         # boundary bytes avoided vs float32, a call

    def carrier(self, tensor: str) -> Optional[Carrier]:
        return self.carriers.get(tensor)


def carrier_from_params(scale, zero_point, bit_width, signed,
                        narrow) -> Optional[Carrier]:
    """The ``Carrier`` a per-tensor integer quantizer can offer, or None
    when its grid does not fit the int8 code transport (non-scalar params,
    fractional widths or zero points, unsigned 8-bit's 0..255)."""
    from repro_torch.kernels.quant_dequant import static_bounds

    s = np.asarray(scale, np.float64).reshape(-1)
    z = np.asarray(zero_point, np.float64).reshape(-1)
    if s.size != 1 or z.size != 1:
        return None
    sv, zv = float(s[0]), float(z[0])
    if not np.isfinite(sv) or sv <= 0 or zv != round(zv):
        return None
    nb = float(bit_width)
    if nb != round(nb) or not 1 <= nb <= 8:
        return None
    lo, hi = static_bounds(signed, narrow, nb)
    if lo < -128 or hi > 127:
        return None
    return Carrier(float(np.float32(sv)), zv, int(nb), bool(signed))


def carrier_from_act(act: ActQuantParams) -> Optional[Carrier]:
    """Offer for an absorbed activation-Quant epilogue (conv / add rules)."""
    return carrier_from_params(act.scale, act.zero_point, act.bit_width,
                               act.signed, act.narrow)


def _nibble_ok(c: Carrier) -> bool:
    """The codes fit the signed nibble [-8, 7] the boundary packer moves."""
    return c.bits <= (4 if c.signed else 3)


def negotiate_carriers(g: QonnxGraph, anchor_match: dict) -> FusionPlan:
    """One topo pass assigning a ``Carrier`` to every boundary tensor whose
    producer offers codes and whose consumers all accept them.

    ``anchor_match`` is the partitioner's pass-1 result
    (``id(anchor_node) -> (rule, match)``); ``g.nodes`` must be topo-sorted
    so a passthrough offer (MaxPool) sees its input's decision."""
    plan = FusionPlan()
    node_to_match: dict[int, Match] = {}
    for _rule, m in anchor_match.values():
        for n in m.nodes:
            node_to_match[id(n)] = m
    out_names = set(g.output_names)

    for node in g.nodes:
        ent = anchor_match.get(id(node))
        if ent is None:
            continue
        m = ent[1]
        out = getattr(m, "out", None)
        offer = getattr(m, "carrier_out", None)
        if offer is None:
            pt = getattr(m, "carrier_pass", None)
            src = plan.carriers.get(pt) if pt else None
            if src is not None:
                # passthrough keeps the grid; packing is decided again
                # below for the new output shape
                offer = dataclasses.replace(src, packed=False)
        if out is None or offer is None:
            continue
        plan.offered += 1
        consumers = g.consumers(out)
        ok = bool(consumers) and out not in out_names
        for cons in consumers:
            cm = node_to_match.get(id(cons))
            if cm is None or out not in getattr(cm, "carrier_accepts", ()):
                ok = False
                break
        if not ok:
            plan.declined += 1
            continue
        carrier = offer
        sh = g.get_shape(out)
        last = sh[-1] if sh else None
        # packing is along the last axis only, from the static shape
        if _nibble_ok(offer) and last is not None and int(last) % 2 == 0:
            carrier = dataclasses.replace(offer, packed=True)
        plan.carriers[out] = carrier
        elems = 1                  # symbolic dims priced as 1 (stats only)
        for d in (sh or ()):
            elems *= 1 if d is None else int(d)
        plan.bytes_saved += int(elems * (4.0 - carrier.bytes_per_elem))
    return plan


def fusion_carriers(ctx: LoweringContext, *tensors):
    """The emit-side read: the negotiated ``Carrier`` (or None) per tensor."""
    plan = getattr(ctx, "fusion", None)
    if plan is None:
        return tuple(None for _ in tensors)
    return tuple(plan.carrier(t) for t in tensors)


# ------------------------------------------------------- boundary codecs

def boundary_out(codes: torch.Tensor, carrier: Carrier) -> torch.Tensor:
    """int8 codes -> the boundary's stored form."""
    from repro_torch.kernels.quant_pool import pack_codes_int4
    return pack_codes_int4(codes) if carrier.packed else codes


def boundary_codes(v: torch.Tensor, carrier: Carrier) -> torch.Tensor:
    """Stored boundary -> int8 codes (unpacks nibble carriers)."""
    from repro_torch.kernels.quant_pool import unpack_codes_int4
    return unpack_codes_int4(v) if carrier.packed else v


def dequant_codes(c: torch.Tensor, zero_point: float,
                  scale: float) -> torch.Tensor:
    """int8 codes -> the oracle's float32 values: ``(c - z) * s``, a cast,
    a subtraction and a product with ``z`` and ``s`` float32 scalars (no
    fused multiply-add, no integer subtraction)."""
    return (c.to(torch.float32) - float(np.float32(zero_point))) * \
        float(np.float32(scale))


def boundary_values(v: torch.Tensor, carrier: Carrier) -> torch.Tensor:
    """Stored boundary -> the oracle's float32 values, bit-same for every
    scale family (the oracle's dequantization on the same integers)."""
    return dequant_codes(boundary_codes(v, carrier), carrier.zero_point,
                         carrier.scale)


def code_recovery(requant, cout: Optional[Carrier]):
    """``(2**T_a, z_a)`` for an integer-path segment whose output is
    carried, else None: its kernel emitted ``s_a*(q - z_a)`` with a proven
    power-of-two ``s_a = 2**-T_a``, so the codes are exactly
    ``round(y * 2**T_a + z_a)``."""
    if cout is None or requant is None:
        return None
    return (float(np.float32(2.0 ** requant.spec.act_out_shift)),
            float(np.float32(requant.spec.act_zp)))


def carried_output(y: torch.Tensor, cout: Optional[Carrier],
                   code) -> torch.Tensor:
    """A kernel segment's output in its boundary's form: as is when not
    carried; else the int8 codes (B4's on the float32 epilogue, recovered
    by ``code_recovery``'s pair on the integer path, where ``torch.round``
    rounds half to even as ``jnp.round`` does), packed when negotiated."""
    if cout is None:
        return y
    if code is not None:
        y = torch.round(y * code[0] + code[1]).to(torch.int8)
    return boundary_out(y, cout)


def _carrier_meta(meta: dict, cin, cout) -> dict:
    meta["fused_boundary"] = True
    if cin is not None:
        meta["carrier_in"] = "int4x2" if cin.packed else "int8"
    if cout is not None:
        meta["carrier_out"] = "int4x2" if cout.packed else "int8"
    return meta


def _read(env: dict, consts: dict, name: str):
    return env.get(name, consts.get(name))


# ------------------------------------------------------------ rule: bipolar

@dataclass
class BipolarActMatch(Match):
    x: str = ""
    out: str = ""
    scale: float = 1.0
    carrier_accepts: tuple = ()
    carrier_out: Optional[Carrier] = None


@register_rule
class BipolarActRule(LoweringRule):
    """Activation ``BipolarQuant`` -> one fused sign segment.  Its +-1 codes
    go straight into a 1-bit carrier (``value = codes * scale``), so CNV's
    conv -> bipolar -> conv / pool chain keeps no float32 between
    segments."""

    name = "bipolar_act"
    anchor_ops = ("BipolarQuant",)
    priority = 50

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[BipolarActMatch]:
        if not ctx.use_fusion:
            return None
        if node.inputs[0] in g.initializers:
            return None                  # weight quantizer (kernel rules)
        sv = scalar(static_value(g, node.inputs[1]))
        if sv is None or not np.isfinite(sv) or sv <= 0:
            return None
        m = BipolarActMatch([node], node.inputs[0], node.outputs[0],
                            float(np.float32(sv)))
        m.carrier_accepts = (m.x,)
        m.carrier_out = Carrier(m.scale, 0.0, 1, True)
        return m

    def emit(self, idx: int, m: BipolarActMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        cin, cout = fusion_carriers(ctx, m.x, m.out)
        x_name, out_name = m.x, m.out
        s = m.scale

        def run(consts, env):
            x = _read(env, consts, x_name)
            if cin is not None:
                x = boundary_values(x, cin)
            if cout is not None:
                codes = (x >= 0).to(torch.int8) * 2 - 1
                env[out_name] = boundary_out(codes, cout)
            else:
                # the oracle's bipolar_quant expression
                one = torch.ones((), dtype=x.dtype, device=x.device)
                env[out_name] = s * torch.where(x >= 0, one, -one)

        return Segment("bipolar_act", m.nodes, [x_name], [out_name], run,
                       (), _carrier_meta({}, cin, cout))


# -------------------------------------------------------------- rule: pool

@dataclass
class PoolMatch(Match):
    x: str = ""
    out: str = ""
    op: str = "MaxPool"
    kernel_shape: tuple = (1, 1)
    strides: Optional[tuple] = None
    pads: tuple = (0, 0, 0, 0)
    count_include_pad: int = 0
    carrier_accepts: tuple = ()
    carrier_pass: Optional[str] = None


@register_rule
class QuantPoolRule(LoweringRule):
    """``MaxPool`` / ``AveragePool`` (NCHW, 2-D) -> a fused pool segment.

    On an integer boundary MaxPool reduces the codes (monotone dequant)
    and passes the carrier through; AveragePool takes the int32 code-sum
    path where the carrier's scale is dyadic with every window sum
    provably exact in float32, else it dequantizes on entry.  Both follow
    the oracle's ONNX ``count_include_pad`` divisor."""

    name = "quant_pool"
    anchor_ops = ("MaxPool", "AveragePool")
    priority = 50

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[PoolMatch]:
        if not ctx.use_fusion:
            return None
        if node.attrs.get("data_layout", "NCHW") != "NCHW":
            return None
        sh = g.get_shape(node.inputs[0])
        if sh is None or len(sh) != 4:
            return None
        k = tuple(int(v) for v in node.attrs.get("kernel_shape", (1, 1)))
        strides = tuple(int(v) for v in node.attrs.get("strides", k))
        pads = tuple(int(v) for v in node.attrs.get("pads", (0, 0, 0, 0)))
        if len(k) != 2 or len(strides) != 2 or len(pads) != 4:
            return None
        m = PoolMatch([node], node.inputs[0], node.outputs[0], node.op_type,
                      k, strides, pads,
                      int(node.attrs.get("count_include_pad", 0)))
        if node.op_type == "MaxPool":
            # the codes path needs every window to cover a real element,
            # or the -128 padding identity could win an all-pad window
            if pads[0] < k[0] and pads[2] < k[0] and \
                    pads[1] < k[1] and pads[3] < k[1]:
                m.carrier_accepts = (m.x,)
                m.carrier_pass = m.x
        else:
            m.carrier_accepts = (m.x,)     # avg: code sums or dequant entry
        return m

    def emit(self, idx: int, m: PoolMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        from repro_torch.analysis.ranges import dyadic_decompose
        from repro_torch.kernels import quant_pool as qp
        from repro_torch.kernels.quant_dequant import static_bounds

        cin, cout = fusion_carriers(ctx, m.x, m.out)
        kw = dict(kernel_shape=m.kernel_shape, strides=m.strides, pads=m.pads)
        x_name, out_name = m.x, m.out
        avg = m.op == "AveragePool"
        cip = m.count_include_pad
        meta = _carrier_meta({"pool": m.op.lower()}, cin, cout)

        int_sum = False
        if avg and cin is not None:
            # dyadic exactness gate of the int32 code-sum path: every
            # float32 partial sum of the oracle is s * integer with
            # |M * partial| <= M * n * amax < 2**24, so both sides compute
            # the same exact value
            d = dyadic_decompose(np.float32(cin.scale))
            if d is not None:
                lo, hi = static_bounds(cin.signed, False, cin.bits)
                amax = max(abs(lo - cin.zero_point),
                           abs(hi - cin.zero_point))
                mult = int(np.asarray(d[0]).reshape(()))
                if mult * float(np.prod(m.kernel_shape)) * amax < _EXACT:
                    int_sum = True
        if avg:
            meta["avg_path"] = "int32" if int_sum else "fp32"

        def run(consts, env):
            x = _read(env, consts, x_name)
            if avg:
                if cin is not None and int_sum:
                    y = qp.avgpool2d_codes(
                        boundary_codes(x, cin), cin.scale, cin.zero_point,
                        count_include_pad=cip, **kw)
                else:
                    if cin is not None:
                        x = boundary_values(x, cin)
                    y = qp.avgpool2d(x, count_include_pad=cip, **kw)
                env[out_name] = y
            elif cin is not None:
                q = qp.maxpool2d_codes(boundary_codes(x, cin), **kw)
                # the max over codes dequantizes to the oracle's max
                env[out_name] = boundary_out(q, cout) if cout is not None \
                    else dequant_codes(q, cin.zero_point, cin.scale)
            else:
                env[out_name] = qp.maxpool2d(x, **kw)

        return Segment("quant_pool", m.nodes, [x_name], [out_name], run,
                       (), meta)


# ------------------------------------------------------- rule: eltwise add

@dataclass
class EltwiseAddMatch(Match):
    a: str = ""
    b: str = ""
    out: str = ""
    relu: bool = False
    act: Optional[ActQuantParams] = None
    carrier_accepts: tuple = ()
    carrier_out: Optional[Carrier] = None


@register_rule
class EltwiseAddRule(LoweringRule):
    """Residual ``Add [-> Relu] [-> Quant]`` -> one fused segment.

    Only *dynamic* + *dynamic* Adds match: a constant operand is a matmul
    bias (absorbed upstream by the matmul rule) or a broadcast constant the
    interpreter keeps."""

    name = "eltwise_add"
    anchor_ops = ("Add",)
    priority = 55

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[EltwiseAddMatch]:
        if not ctx.use_fusion:
            return None
        a, b = node.inputs[0], node.inputs[1]
        if a in g.initializers or b in g.initializers:
            return None
        nodes = [node]
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
        m = EltwiseAddMatch(nodes, a, b, out, relu, act)
        m.carrier_accepts = (a, b)
        if act is not None:
            m.carrier_out = carrier_from_act(act)
        return m

    def emit(self, idx: int, m: EltwiseAddMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        ca, cb = fusion_carriers(ctx, m.a, m.b)
        (cout,) = fusion_carriers(ctx, m.out)
        qdq = None
        keys: tuple = ()
        if m.act is not None:
            qdq, keys, _ = stage_qdq_epilogue(
                idx, consts, ctx, scale=m.act.scale,
                zero_point=m.act.zero_point, bit_width=m.act.bit_width,
                signed=m.act.signed, narrow=m.act.narrow,
                rounding_mode=m.act.rounding_mode,
                emit_codes=cout is not None)
        a_name, b_name, out_name = m.a, m.b, m.out
        relu = m.relu

        def run(consts, env):
            a = _read(env, consts, a_name)
            b = _read(env, consts, b_name)
            if ca is not None:
                a = boundary_values(a, ca)
            if cb is not None:
                b = boundary_values(b, cb)
            y = torch.add(a, b)
            if relu:
                y = torch.relu(y)
            if qdq is not None:
                y2 = y.reshape(1, -1) if y.ndim < 2 else \
                    y.reshape(y.shape[0], -1)
                y = qdq(y2.contiguous(), consts[keys[0]],
                        consts[keys[1]]).reshape(y.shape)
            if cout is not None:
                y = boundary_out(y, cout)
            env[out_name] = y

        ins = [a_name] if a_name == b_name else [a_name, b_name]
        meta = _carrier_meta({}, ca or cb, cout)
        return Segment("eltwise_add", m.nodes, ins, [out_name], run, keys,
                       meta)


# ------------------------------------------------------------ rule: concat

@dataclass
class ConcatMatch(Match):
    xs: tuple = ()
    out: str = ""
    axis: int = 0
    carrier_accepts: tuple = ()


@register_rule
class QuantConcatRule(LoweringRule):
    """``Concat`` over at least one dynamic input -> a fused segment that
    dequantizes any integer-carried operand on entry (bit-same for every
    scale family) and concatenates as the oracle does."""

    name = "quant_concat"
    anchor_ops = ("Concat",)
    priority = 55

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[ConcatMatch]:
        if not ctx.use_fusion:
            return None
        if not node.inputs or any(not i for i in node.inputs):
            return None
        dyn = tuple(i for i in node.inputs if i not in g.initializers)
        if not dyn:
            return None               # all static: constant folding's
        m = ConcatMatch([node], tuple(node.inputs), node.outputs[0],
                        int(node.attrs.get("axis", 0)))
        m.carrier_accepts = dyn
        return m

    def emit(self, idx: int, m: ConcatMatch, consts: dict,
             ctx: LoweringContext) -> Segment:
        from ..executor import lookup_op

        cs = fusion_carriers(ctx, *m.xs)
        xs, out_name = m.xs, m.out
        node = m.nodes[0]
        concat = lookup_op(node)          # the oracle's Concat

        def run(consts, env):
            vals = []
            for name, c in zip(xs, cs):
                v = _read(env, consts, name)
                vals.append(v if c is None else boundary_values(v, c))
            env[out_name] = concat(node, *vals)

        ins = list(dict.fromkeys(xs))
        meta = _carrier_meta({}, next((c for c in cs if c), None), None)
        return Segment("quant_concat", m.nodes, ins, [out_name], run, (),
                       meta)
