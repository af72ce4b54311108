"""Shared quantized-weight resolution for kernel-backed lowering rules.

Counterpart of ``repro.core.lowering.weights``.  Three weight producers
turn into an integer carrier + dequant scale:

  * ``Quant``          — QONNX high-level weight quantizer (symmetric only:
                         any nonzero zero point keeps the node interpreted);
  * ``BipolarQuant``   — 1-bit {-1, +1} weights, exact in int8;
  * ``QuantizeLinear [-> Clip] -> DequantizeLinear`` — QCDQ-format weight
    chains, evaluated offline with the registered ops so the packed
    carrier is bit-identical to what the oracle would produce.

Carrier selection is analysis-driven when a ``GraphAnalysis`` is supplied:
the *actual* integer values decide the int8 / int4 fit, so declared-wide
weights that happen to be narrow still lower.  Without analysis the
declared bit-width bounds decide.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import quant_ops
from ..executor import op_output, to_tensor
from ..graph import Node, QonnxGraph
from .base import Match, blocks_at, scalar, sole_consumer, static_value


@dataclass
class KernelMatch(Match):
    """Shared payload of matches that lower onto the integer matmul kernels."""
    x: str                       # activation tensor
    out: str                     # tensor the fused segment produces
    w_int: np.ndarray            # integer weight carrier, kernel layout
    scale: np.ndarray            # () or per-output-column dequant scale
    bias: Optional[np.ndarray]   # per-output-column bias or None
    int4_ok: bool                # packed-int4 dispatch is sound
    acc_dtype: torch.dtype = torch.float32   # analysis-selected accumulator
    acc_bits: Optional[int] = None    # minimal accumulator width (if proven)
    requant: Optional[object] = None  # proven RequantPlan (integer path)
    rows: Optional[int] = None   # the kernel's M rows per declared batch
    batch: int = 1               # x's declared leading dim
    geometry: tuple = ()         # plan inputs beyond the carrier's dims
                                 # (depthwise: the conv's; tuner signature)
    carrier_accepts: tuple = ()  # inputs the emitter can take as integer
                                 # boundary carriers (lowering/fusion.py)
    carrier_out: Optional[object] = None   # fusion.Carrier offer for ``out``

    def body(self) -> dict:
        """The kernel body this match selected, as keyword arguments of the
        kernel wrappers: the accumulator, the IntRequant spec, the
        activation scale the integer path divides x by, and whether its
        staged codes are proven to fit int8 (B2's tensor-core body)."""
        rq = self.requant
        return dict(acc_dtype=self.acc_dtype,
                    requant=None if rq is None else rq.spec,
                    in_scale=None if rq is None else float(rq.in_scale),
                    int8_codes=rq is not None and rq.int8_codes)


def stage_kernel_carriers(idx: int, m: KernelMatch, consts: dict, ctx,
                          kinds: tuple[str, str], pack=None):
    """Stage a KernelMatch's constants into the plan's consts dict.

    Packs the int4 carrier when the context allows it (on the host, once),
    then moves the carrier, the dequant scale (on the integer path the
    int32 ``M_x * M_w`` multipliers instead) and the optional bias to the
    plan's device under the segment's ``__seg{idx}_*`` keys.  ``pack``
    replaces the (K, N) int4 packer for carriers of another layout (the
    grouped rule packs along each group's Kg).  The segment meta records
    the accumulator, the requant path, B2's body (``b2_body``) when the
    segment runs B2 (the (K, N) int4 carrier) and, when the shapes are
    known, the kernel's rows (``m.rows``).

    When the context carries a tuner, the segment's workload signature
    (family x rows bucket x carrier dims x bits x requant path x body x
    geometry) is built from the pre-packing carrier shape and resolved to a
    ``BlockConfig``: the chosen blocks land in ``meta["blocks"]`` with their
    provenance in ``meta["tuned"]``, as in the reference.

    Returns ``(kind, use_int4, w_key, s_key, b_key_or_None, meta,
    blocks_at)`` where ``kinds`` is the (int8, int4) segment-kind pair and
    ``blocks_at(x)`` the ``blocks`` the rule passes to its kernel for input
    ``x`` (``base.blocks_at``: the tuned blocks at the bucket they were
    tuned at, else None for the heuristic plan).
    """
    from repro_torch.kernels.ops import pack_int4

    use_int4 = ctx.use_int4 and m.int4_ok
    kind = kinds[1] if use_int4 else kinds[0]
    w_key, s_key, b_key = f"__seg{idx}_w", f"__seg{idx}_s", f"__seg{idx}_b"
    w = torch.from_numpy(np.ascontiguousarray(m.w_int, np.int8))
    consts[w_key] = ((pack or pack_int4)(w) if use_int4 else w).to(ctx.device)
    if m.requant is not None:
        # integer path: the scale slot carries the int32 M_x*M_w multipliers
        consts[s_key] = to_tensor(np.asarray(m.requant.mult, np.int32),
                                  ctx.device)
    else:
        consts[s_key] = to_tensor(np.asarray(m.scale, np.float32), ctx.device)
    if m.bias is not None:
        consts[b_key] = to_tensor(np.asarray(m.bias, np.float32), ctx.device)
    meta = {"acc": str(m.acc_dtype).replace("torch.", ""),
            "requant_path": "int32" if m.requant is not None else "fp32"}
    if m.acc_bits is not None:
        meta["acc_bits"] = m.acc_bits
    if m.requant is not None:
        meta["fp32_ops_eliminated"] = m.requant.fp32_ops_eliminated
    if use_int4 and pack is None:
        from repro_torch.kernels.quant_matmul import b2_body
        meta["b2_body"] = b2_body(m.acc_dtype, m.body()["int8_codes"])
    if m.rows is not None:
        meta["rows"] = m.rows
    cfg = None
    if ctx.tuner is not None:
        cfg = ctx.tuner.blocks_for(_carrier_sig(ctx.tuner, kinds[0], m,
                                                use_int4, meta))
        meta["blocks"] = list(cfg.blocks)
        meta["tuned"] = cfg.source
    return (kind, use_int4, w_key, s_key,
            b_key if m.bias is not None else None, meta,
            blocks_at(cfg, m.rows, m.batch))


def _carrier_sig(tuner, base_kind: str, m: KernelMatch, use_int4: bool,
                 meta: dict):
    """Map a staged carrier to its autotuner ``KernelSig``.

    The dims come from the pre-packing carrier: (K, N) for the dense
    matmul / im2col kinds, (G, Kg, Ng) grouped, (kH·kW, C) depthwise; the
    matmul family also names B1 / B2's body, the depthwise one the conv's
    geometry."""
    from repro_torch.kernels.quant_matmul import b2_body
    w = np.asarray(m.w_int)
    bits = 4 if use_int4 else 8
    requant = meta["requant_path"]
    if base_kind == "quant_conv_dw":
        taps, c = w.shape
        return tuner.sig("depthwise", rows=m.rows, n=c, k=taps, bits=bits,
                         requant=requant, geometry=m.geometry)
    if base_kind == "quant_conv_grouped":
        g, kg, ng = w.shape
        return tuner.sig("grouped", rows=m.rows, n=ng, k=kg, groups=g,
                         bits=bits, requant=requant)
    k, n = w.shape
    body = b2_body(m.acc_dtype, use_int4 and m.body()["int8_codes"])
    return tuner.sig("matmul", rows=m.rows, n=n, k=k, bits=bits,
                     requant=requant, body=body)


@dataclass
class QuantWeight:
    """A weight tensor resolved to its integer carrier, pre-shape-checks."""
    chain: list[Node]            # producer chain, topo order (last feeds use)
    w_int: np.ndarray            # int8 carrier in the *original* weight shape
    scale: np.ndarray            # raw scale array (granularity rule-checked)
    int4_values: bool            # value range fits the int4 carrier


def _broadcasts_over(w_shape: tuple, *params: np.ndarray) -> bool:
    """True iff every quant param broadcasts onto the weight shape without
    changing it — the precondition for evaluating the chain offline."""
    try:
        return np.broadcast_shapes(
            w_shape, *(np.asarray(p).shape for p in params)) == tuple(w_shape)
    except ValueError:
        return False


def resolve_quant_weight(g: QonnxGraph, w_name: str,
                         ga=None) -> Optional[QuantWeight]:
    """Resolve ``w_name``'s producer into a ``QuantWeight`` or None; with a
    ``GraphAnalysis`` the actual integer values choose the carrier."""
    wq = g.producer(w_name)
    if wq is None:
        return None
    if wq.op_type == "DequantizeLinear":
        return _resolve_qcdq_chain(g, wq)
    if wq.op_type == "BipolarQuant":
        w = static_value(g, wq.inputs[0])
        s = static_value(g, wq.inputs[1])
        if w is None or s is None:
            return None
        # w_q = s * (+1 if w >= 0 else -1)  — exact in int8
        w_int = np.where(w >= 0, 1, -1).astype(np.int8)
        return QuantWeight([wq], w_int, np.asarray(s, np.float32), True)
    if wq.op_type != "Quant":
        return None
    w = static_value(g, wq.inputs[0])
    if w is None:
        return None
    s, z, bw = (static_value(g, i) for i in wq.inputs[1:4])
    if s is None or z is None or bw is None:
        return None
    if np.any(z != 0):
        return None                       # asymmetric weights: keep interp
    nb = scalar(bw)
    if nb is None:
        return None
    signed = bool(wq.attrs.get("signed", 1))
    narrow = bool(wq.attrs.get("narrow", 0))
    rmode = str(wq.attrs.get("rounding_mode", "ROUND")).upper()
    if rmode not in quant_ops.ROUNDING_MODES:
        return None                       # unknown mode: keep interp
    if not _broadcasts_over(w.shape, s, z):
        return None    # params the oracle can't broadcast: decline, not raise
    w_q = quant_ops.quantize_int(
        to_tensor(np.asarray(w, np.float32)), to_tensor(s), to_tensor(z),
        to_tensor(bw), signed=signed, narrow=narrow,
        rounding_mode=rmode).numpy()
    if ga is not None:
        # analysis-driven carrier selection: the *actual* value range
        # decides, so declared-wide weights that happen to fit a narrower
        # carrier still lower (and may take the packed int4 path)
        w_lo, w_hi = (float(w_q.min()), float(w_q.max())) if w_q.size \
            else (0.0, 0.0)
    else:
        # syntactic fallback: declared bit-width bounds
        w_hi = float(quant_ops.max_int(signed, narrow, nb))
        w_lo = float(quant_ops.min_int(signed, narrow, nb))
    if w_lo < -128 or w_hi > 127:
        return None                       # must fit the int8 carrier
    return QuantWeight([wq], w_q.astype(np.int8), np.asarray(s, np.float32),
                       -8.0 <= w_lo and w_hi <= 7.0)


def _resolve_qcdq_chain(g: QonnxGraph, dq: Node) -> Optional[QuantWeight]:
    """QCDQ-format weights: QuantizeLinear(w) [-> Clip] -> DequantizeLinear.
    The integer weights are computed offline by evaluating the Q(C) chain on
    the constant with the registered ops."""
    chain = [dq]
    cur = g.producer(dq.inputs[0])
    if cur is not None and cur.op_type == "Clip":
        chain.insert(0, cur)
        cur = g.producer(cur.inputs[0])
    if cur is None or cur.op_type != "QuantizeLinear":
        return None
    ql = cur
    chain.insert(0, ql)
    w = static_value(g, ql.inputs[0])
    if w is None:
        return None
    if ql.inputs[1] != dq.inputs[1]:
        return None
    s = static_value(g, ql.inputs[1])
    zp = static_value(g, ql.inputs[2]) if len(ql.inputs) > 2 else None
    if s is None or (zp is not None and np.any(zp != 0)):
        return None
    if not _broadcasts_over(w.shape, s,
                            *(() if zp is None else (zp,))):
        return None    # params the oracle can't broadcast: decline, not raise
    # evaluate QL [+ Clip] on the constant weight, offline
    val = to_tensor(np.asarray(w, np.float32))
    for cn in chain[:-1]:
        args = [val] + [to_tensor(g.initializers[i])
                        for i in cn.inputs[1:] if i]
        (val,) = op_output(cn, args)
    w_int = val.numpy()
    if w_int.min() < -128 or w_int.max() > 127:
        return None
    return QuantWeight(chain, w_int.astype(np.int8),
                       np.asarray(s, np.float32),
                       bool(w_int.min() >= -8 and w_int.max() <= 7))


def chain_absorbable(g: QonnxGraph, chain: list[Node], consumer: Node) -> bool:
    """May ``chain`` be covered by ``consumer``'s segment?  Only when the
    consumer is the chain tail's sole reader and every interior link is
    sole-consumed (otherwise another node still needs the chain's output,
    so it must stay in the graph and the segment reads its result)."""
    if sole_consumer(g, chain[-1].outputs[0]) is not consumer:
        return False
    return all(sole_consumer(g, c.outputs[0]) is not None
               for c in chain[:-1])
