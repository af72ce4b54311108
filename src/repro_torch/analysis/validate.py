"""Quantization-consistency validation over QonnxGraph.

Counterpart of ``repro.analysis.validate``; the Clip-bound check uses
``core.formats.bitwidth_from_bounds``.

Structural well-formedness (SSA, DAG) lives in ``QonnxGraph.validate``;
this module checks *quantization semantics* — the class of inconsistencies
a frontend exporter or a hand-edited graph can introduce that execute
without error but silently compute the wrong thing on a real backend:

  * Quant/QuantizeLinear scale must be strictly positive;
  * zero points must sit on the integer grid (paper §II: required so
    zero-padding commutes with quantization);
  * declared bit widths must be finite and >= 1;
  * Trunc may only remove bits (out_bits <= in_bits);
  * QCDQ chains: Clip bounds must be consistent — non-inverted, inside the
    int8/uint8 carrier range, matching some integer bit width (Eqs. 2-3),
    and sign-compatible with the carrier (an unsigned carrier cannot
    produce the negatives a signed Clip lower bound implies);
  * QuantizeLinear/DequantizeLinear pairs must agree on scale values.

``validate_quantization`` returns the full issue list; ``check_graph``
raises ``QuantValidationError`` with every issue spelled out (actionable
errors, not just the first).  The raising form is registered as the
``validate_quantization`` pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import quant_ops
from ..core.formats import bitwidth_from_bounds
from ..core.graph import Node, QonnxGraph


class QuantValidationError(ValueError):
    """Raised by check_graph; carries the full list of issues."""

    def __init__(self, issues: list["ValidationIssue"]):
        self.issues = issues
        lines = [f"graph failed quantization validation "
                 f"({len(issues)} issue{'s' if len(issues) != 1 else ''}):"]
        lines += [f"  [{i.code}] {i.node}: {i.message}" for i in issues]
        super().__init__("\n".join(lines))


@dataclass(frozen=True)
class ValidationIssue:
    node: str          # node name (or tensor name for graph-level issues)
    code: str          # stable machine-readable code
    message: str       # human-actionable description

    def __str__(self):
        return f"[{self.code}] {self.node}: {self.message}"


def _const(g: QonnxGraph, name: str):
    if name and name in g.initializers:
        return np.asarray(g.initializers[name])
    return None


def _name(n: Node) -> str:
    return n.name or f"{n.op_type}({', '.join(n.outputs)})"


def validate_quantization(graph: QonnxGraph) -> list[ValidationIssue]:
    """Collect every quantization-consistency issue in the graph."""
    issues: list[ValidationIssue] = []
    add = issues.append

    for node in graph.nodes:
        if node.op_type == "Quant":
            _check_quant(graph, node, add)
        elif node.op_type == "BipolarQuant":
            s = _const(graph, node.inputs[1])
            if s is not None and np.any(s <= 0):
                add(ValidationIssue(_name(node), "nonpositive_scale",
                                    f"BipolarQuant scale must be > 0, got "
                                    f"min {float(np.min(s))}"))
        elif node.op_type == "Trunc":
            _check_trunc(graph, node, add)
        elif node.op_type == "QuantizeLinear":
            _check_qcdq_chain(graph, node, add)
        elif node.op_type == "Clip":
            lo = _const(graph, node.inputs[1]) if len(node.inputs) > 1 else None
            hi = _const(graph, node.inputs[2]) if len(node.inputs) > 2 else None
            if lo is not None and hi is not None and \
                    float(np.max(lo)) > float(np.min(hi)):
                add(ValidationIssue(_name(node), "clip_bounds_inverted",
                                    f"Clip lower bound {float(np.max(lo))} "
                                    f"exceeds upper bound {float(np.min(hi))}"))
    return issues


def _check_quant(g: QonnxGraph, node: Node, add) -> None:
    s = _const(g, node.inputs[1])
    z = _const(g, node.inputs[2])
    bw = _const(g, node.inputs[3])
    if s is not None and np.any(s <= 0):
        add(ValidationIssue(
            _name(node), "nonpositive_scale",
            f"Quant scale must be strictly positive, got min "
            f"{float(np.min(s))}; a non-positive scale makes Eq. 1 "
            "non-invertible"))
    if z is not None and not np.all(z == np.round(z)):
        add(ValidationIssue(
            _name(node), "fractional_zero_point",
            f"Quant zero_point must be an integer (paper §II: zero-padding "
            f"must map onto a grid point), got {np.asarray(z).reshape(-1)[:4]}"))
    if bw is not None:
        nb = np.asarray(bw, np.float64)
        if not np.all(np.isfinite(nb)) or np.any(nb < 1):
            add(ValidationIssue(
                _name(node), "invalid_bitwidth",
                f"Quant bit_width must be finite and >= 1, got "
                f"{nb.reshape(-1)[:4]}"))
        elif bool(node.attrs.get("narrow", 0)) and \
                not bool(node.attrs.get("signed", 1)) and np.any(nb < 2):
            add(ValidationIssue(
                _name(node), "empty_quant_range",
                "unsigned narrow-range Quant with bit_width < 2 has the "
                "empty integer interval [0, 2^1 - 2] = [0, 0] only; "
                "widen bit_width or drop narrow"))
    if z is not None and bw is not None and s is not None and \
            np.all(np.isfinite(np.asarray(bw, np.float64))):
        # zero point must be representable inside the target interval
        signed = bool(node.attrs.get("signed", 1))
        narrow = bool(node.attrs.get("narrow", 0))
        nb = float(np.max(np.asarray(bw)))
        if nb >= 1:
            lo = float(quant_ops.min_int(signed, narrow, nb))
            hi = float(quant_ops.max_int(signed, narrow, nb))
            if np.any(z < lo) or np.any(z > hi):
                add(ValidationIssue(
                    _name(node), "zero_point_out_of_range",
                    f"zero_point {np.asarray(z).reshape(-1)[:4]} lies outside "
                    f"the {'signed' if signed else 'unsigned'} {nb}-bit "
                    f"interval [{lo}, {hi}]: real zero is not representable"))


def _check_trunc(g: QonnxGraph, node: Node, add) -> None:
    in_bw = _const(g, node.inputs[3])
    out_bw = _const(g, node.inputs[4])
    if in_bw is not None and out_bw is not None and \
            float(np.max(out_bw)) > float(np.max(in_bw)):
        add(ValidationIssue(
            _name(node), "trunc_bits_increase",
            f"Trunc out_bit_width {float(np.max(out_bw))} exceeds "
            f"in_bit_width {float(np.max(in_bw))}: truncation can only "
            "remove LSBs"))
    s = _const(g, node.inputs[1])
    if s is not None and np.any(s <= 0):
        add(ValidationIssue(_name(node), "nonpositive_scale",
                            "Trunc scale must be strictly positive"))


def _check_qcdq_chain(g: QonnxGraph, node: Node, add) -> None:
    """QuantizeLinear [-> Clip] [-> DequantizeLinear] consistency."""
    s = _const(g, node.inputs[1])
    zp_name = node.inputs[2] if len(node.inputs) > 2 else None
    zp = _const(g, zp_name) if zp_name else None
    if s is not None and np.any(s <= 0):
        add(ValidationIssue(_name(node), "nonpositive_scale",
                            "QuantizeLinear scale must be strictly positive"))
    if zp is not None and not np.all(zp == np.round(zp)):
        add(ValidationIssue(_name(node), "fractional_zero_point",
                            "QuantizeLinear zero_point must be an integer"))
    signed = zp is not None and np.issubdtype(zp.dtype, np.signedinteger)
    c_lo, c_hi = (-128.0, 127.0) if signed else (0.0, 255.0)
    carrier = "int8" if signed else "uint8"

    # follow the optional Clip
    cons = g.consumers(node.outputs[0])
    clip = cons[0] if len(cons) == 1 and cons[0].op_type == "Clip" else None
    if clip is not None:
        lo = _const(g, clip.inputs[1]) if len(clip.inputs) > 1 else None
        hi = _const(g, clip.inputs[2]) if len(clip.inputs) > 2 else None
        if lo is not None and hi is not None:
            lo_f, hi_f = float(np.min(lo)), float(np.max(hi))
            if lo_f > hi_f:
                return  # reported by the generic Clip check
            if not signed and lo_f < 0:
                add(ValidationIssue(
                    _name(clip), "signedness_conflict",
                    f"Clip lower bound {lo_f} requires negative integers but "
                    f"the QuantizeLinear carrier is unsigned ({carrier}); "
                    "use an int8 zero_point or raise the bound to 0"))
            elif lo_f < c_lo or hi_f > c_hi:
                add(ValidationIssue(
                    _name(clip), "clip_exceeds_carrier",
                    f"Clip bounds [{lo_f}, {hi_f}] exceed the {carrier} "
                    f"carrier range [{c_lo}, {c_hi}] implied by the "
                    f"QuantizeLinear zero-point dtype"))
            elif bitwidth_from_bounds(lo_f, hi_f, signed) is None:
                add(ValidationIssue(
                    _name(clip), "clip_bitwidth_mismatch",
                    f"Clip bounds [{lo_f}, {hi_f}] match no integer bit "
                    f"width (Eqs. 2-3) for a {carrier} carrier; expected "
                    "e.g. [-2^(n-1), 2^(n-1)-1] or [0, 2^n - 1]"))
        tail = g.consumers(clip.outputs[0])
    else:
        tail = cons
    # DequantizeLinear scale agreement
    dq = tail[0] if len(tail) == 1 and \
        tail[0].op_type == "DequantizeLinear" else None
    if dq is not None:
        s_dq = _const(g, dq.inputs[1])
        if s is not None and s_dq is not None and \
                (s.shape != s_dq.shape or not np.allclose(s, s_dq)):
            add(ValidationIssue(
                _name(dq), "qdq_scale_mismatch",
                "DequantizeLinear scale differs from the QuantizeLinear "
                "scale of the same chain: the fake-quant round trip is not "
                "value-preserving"))


def check_graph(graph: QonnxGraph) -> QonnxGraph:
    """Raise QuantValidationError when any issue is found (pass form)."""
    issues = validate_quantization(graph)
    if issues:
        raise QuantValidationError(issues)
    return graph
