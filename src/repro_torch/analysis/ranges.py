"""Static integer range analysis over QonnxGraph (compiler tier 0).

Counterpart of ``repro.analysis.ranges``: numpy over the graph, the same
transfer functions and the same bounds.  Constant subgraphs are evaluated
by the port's oracle on the CPU (see ``analyze``), and ``min_int`` /
``max_int`` are the port's (``repro_torch.core.quant_ops``), which differ
from the reference's for bit widths >= 13 (ROADMAP.md C4).

Forward abstract interpretation in topological order.  Every tensor gets a
``RangeInfo``:

  * ``lo/hi``     — elementwise real-valued bounds (interval arithmetic;
                    tight per-output-channel bounds for MatMul/Gemm/Conv
                    with constant weights, the Jain-et-al. / NEMO
                    accumulator bound);
  * ``integer``   — every element is provably integer-valued;
  * ``grid``      — when the tensor sits on a known uniform quantization
                    grid ``x = s * (q - z)``: the (scale, zero_point) pair
                    and the *integer-domain* bounds of q.  Quant /
                    BipolarQuant / QuantizeLinear(+Clip)+DequantizeLinear
                    establish grids; Relu / MaxPool / reshape-like ops
                    preserve them; everything else drops them.

Constant subgraphs (weight quantization chains etc.) are evaluated exactly
with the interpreted op registry, so weight-dependent bounds are computed
from the *actual* integer weight values rather than declared bit widths —
this is what lets the compiled executor prove, e.g., that a declared-8-bit
weight tensor really fits an int4 carrier, and size accumulators minimally.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import torch

from ..core import quant_ops
from ..core.executor import op_output, to_tensor
from ..core.graph import Node, QonnxGraph

from .datatypes import FLOAT32, DataType

_UNBOUNDED = (-np.inf, np.inf)

# ops through which both the value range and the quantization grid pass
# untouched (element shuffles / identity)
_SHUFFLE_OPS = {"Reshape", "Flatten", "Transpose", "Squeeze", "Unsqueeze",
                "Identity"}


# A scale only counts as dyadic when its odd multiplier fits this many
# values.  Technically *every* float32 is m/2**t for some integer m, so an
# unbounded decomposition would label near-dyadic floats like 0.1
# (13421773/2**27) dyadic too; bounding the multiplier is what makes the
# annotation mean "usefully dyadic" — small-m scales whose integer
# requantization can also satisfy the kernel tier's 2**24 exactness bounds.
DYADIC_MAX_MULT = 1 << 16


def dyadic_decompose(scale, max_mult: int = DYADIC_MAX_MULT
                     ) -> Optional[tuple[np.ndarray, int]]:
    """Exact ``(multiplier, shift)`` decomposition of a dyadic scale array.

    Returns ``(m, t)`` with ``scale == m * 2.0**-t`` elementwise and
    *bit-exactly* in float32 (the reconstruction is verified — that is the
    exactness proof the integer requant path builds on), where ``m`` is a
    positive int64 array of ``scale``'s shape and ``t`` a single shared
    shift (per-channel scales are aligned to a common shift so one rounding
    right-shift serves every channel).  None when any element is
    non-positive/non-finite, any aligned multiplier exceeds ``max_mult``,
    or the reconstruction is not bit-exact.
    """
    a = np.asarray(scale, np.float64)
    if a.size == 0 or not np.all(np.isfinite(a)) or np.any(a <= 0):
        return None
    mults, shifts = [], []
    for v in a.reshape(-1):
        num, den = float(v).as_integer_ratio()   # den is a power of two
        t_i = den.bit_length() - 1
        while num % 2 == 0:                      # odd-normalize
            num //= 2
            t_i -= 1
        mults.append(num)
        shifts.append(t_i)
    t = max(shifts)
    m = [num << (t - t_i) for num, t_i in zip(mults, shifts)]
    if max(m) > max_mult:
        return None
    mult = np.asarray(m, np.int64).reshape(a.shape)
    if not np.array_equal(np.asarray(mult * 2.0 ** -t, np.float32),
                          np.asarray(scale, np.float32)):
        return None                              # exactness proof failed
    return mult, t


def is_power_of_two(scale) -> bool:
    """True iff every element of ``scale`` is exactly ``2**-t`` (m == 1)."""
    return dyadic_decompose(scale, max_mult=1) is not None


@dataclass(frozen=True)
class QuantGrid:
    """A uniform grid x = scale * (q - zero_point), q in [int_lo, int_hi].

    ``scale``/``zero_point`` keep their original (possibly channel-wise)
    shapes; the integer bounds are scalars over the whole tensor.
    """
    scale: np.ndarray
    zero_point: np.ndarray
    int_lo: float
    int_hi: float

    @property
    def int_bits(self) -> int:
        """Bits of the minimal signed/unsigned container of [int_lo, int_hi]."""
        return DataType.from_bounds(self.int_lo, self.int_hi).bits

    def dyadic(self) -> Optional[tuple[np.ndarray, int]]:
        """``(multiplier, shift)`` of a dyadic scale, else None.

        The annotation the integer-requant lowering consumes: when every
        scale feeding a fused segment decomposes, the fp32 epilogue can be
        replaced by an int32 multiply + rounding right shift
        (``quant_ops.round_shift``) with a machine-checked exactness proof.
        """
        return dyadic_decompose(self.scale)

    @property
    def is_dyadic(self) -> bool:
        return self.dyadic() is not None

    @property
    def is_power_of_two(self) -> bool:
        return is_power_of_two(self.scale)


@dataclass(frozen=True)
class RangeInfo:
    lo: float = -np.inf
    hi: float = np.inf
    integer: bool = False
    grid: Optional[QuantGrid] = None

    def is_bounded(self) -> bool:
        return np.isfinite(self.lo) and np.isfinite(self.hi)

    def dtype(self) -> DataType:
        """Minimal datatype of the *values* (not the grid annotation)."""
        if not self.integer or not self.is_bounded():
            return FLOAT32
        return DataType.from_bounds(self.lo, self.hi)


@dataclass
class AccumulatorSpec:
    """Worst-case integer-domain dot-product bound for one MatMul/Gemm/Conv.

    ``int_lo/int_hi`` bound sum_k q_a[k] * q_w[k] over any output element,
    where q_a is the input's integer-domain range and q_w the exact integer
    weight values.  ``bits`` is the minimal signed container.
    """
    int_lo: float
    int_hi: float

    @property
    def bits(self) -> int:
        return DataType.from_bounds(min(self.int_lo, -1.0),
                                    max(self.int_hi, 0.0)).bits


def _minmax(a: np.ndarray) -> tuple[float, float]:
    return float(np.min(a)), float(np.max(a))


def _is_integral(a: np.ndarray) -> bool:
    return bool(np.all(np.isfinite(a)) and np.all(a == np.round(a)))


@dataclass
class GraphAnalysis:
    """Result bundle: per-tensor ranges plus accumulator bound queries."""
    graph: QonnxGraph
    ranges: dict[str, RangeInfo] = field(default_factory=dict)
    const_values: dict[str, np.ndarray] = field(default_factory=dict)

    def range(self, tensor: str) -> RangeInfo:
        return self.ranges.get(tensor, RangeInfo())

    def value_dtype(self, tensor: str) -> DataType:
        """Minimal datatype of the tensor's values (FLOAT32 if unproven)."""
        return self.range(tensor).dtype()

    def constant(self, tensor: str) -> Optional[np.ndarray]:
        return self.const_values.get(tensor)

    # -------------------------------------------------------- accumulator
    def accumulator_spec(self, node: Node) -> Optional[AccumulatorSpec]:
        """Worst-case integer accumulator range of a MatMul/Gemm/Conv node.

        Needs (a) the activation input on a known quantization grid, and
        (b) a statically-known weight operand that is itself on a grid (or
        exactly integer-valued).  Returns None when either is unproven.
        """
        if node.op_type not in ("MatMul", "Gemm", "Conv"):
            return None
        if node.op_type == "Gemm" and _gemm_nondefault(node):
            return None
        a_info = self.range(node.inputs[0])
        w_val = self.constant(node.inputs[1])
        if w_val is None:
            return None
        w_info = self.range(node.inputs[1])
        # integer-domain activation bounds
        if a_info.grid is not None:
            a_lo, a_hi = a_info.grid.int_lo, a_info.grid.int_hi
        elif a_info.integer and a_info.is_bounded():
            a_lo, a_hi = a_info.lo, a_info.hi
        else:
            return None
        # integer-domain weight values
        if w_info.grid is not None:
            g = w_info.grid
            w_int = np.round(np.asarray(w_val, np.float64) /
                             np.asarray(g.scale, np.float64) +
                             np.asarray(g.zero_point, np.float64))
        elif _is_integral(np.asarray(w_val)):
            w_int = np.asarray(w_val, np.float64)
        else:
            return None
        return _dot_bound(node, w_int, a_lo, a_hi)

    def accumulator_bits(self, node: Node) -> Optional[int]:
        spec = self.accumulator_spec(node)
        return None if spec is None else spec.bits

    def kernel_accumulator_spec(self, node: Node,
                                w_int) -> Optional[AccumulatorSpec]:
        """Bound of ``x @ w_int`` over the activation input's *value* range.

        This is what a fused kernel with integer weight carriers actually
        accumulates (activation values, not grid indices); the compile
        tier uses it to pick the accumulator dtype.
        """
        a = self.range(node.inputs[0])
        if not a.is_bounded():
            return None
        return _dot_bound(node, np.asarray(w_int, np.float64), a.lo, a.hi)

    def kernel_accumulator(self, node: Node,
                           w_int) -> Optional[tuple[int, bool]]:
        """Per-rule accumulator-selection hook for the compiled executor.

        ``w_int`` is the integer weight carrier in the *node's operand
        shape* — (K, N) for MatMul/Gemm, (O, I/g, kH, kW) for Conv (the
        conv lowering stages an im2col matrix but the bound is computed on
        the real receptive field, zero-padding-aware via ``_dot_bound``).

        Returns ``(min_acc_bits, exact_int32_ok)``: the minimal signed
        accumulator width for ``x @ w_int`` over the activation's proven
        value range, and whether exact int32 accumulation is sound (the
        activations are provably integer-valued and the bound fits a
        signed 31-bit accumulator).  None when the range is unproven.
        """
        spec = self.kernel_accumulator_spec(node, w_int)
        if spec is None:
            return None
        exact = bool(self.range(node.inputs[0]).integer and spec.bits <= 31)
        return spec.bits, exact


def _dot_bound(node: Node, w: np.ndarray, a_lo: float, a_hi: float
               ) -> AccumulatorSpec:
    """Interval bound of sum_k a_k * w_k per output element.

    Each product a*w_k is bounded by [min, max] over {w_k*a_lo, w_k*a_hi};
    summing the per-element minima/maxima along the contraction axes gives
    the per-output-channel bound; the spec takes the worst channel.  For a
    zero-padded Conv, border windows replace some taps with exactly 0, so
    each tap's interval is widened to include 0.
    """
    w = np.asarray(w, np.float64)
    p_lo = np.minimum(w * a_lo, w * a_hi)
    p_hi = np.maximum(w * a_lo, w * a_hi)
    if node.op_type in ("MatMul", "Gemm"):
        # (K, N): contract axis 0
        axes = tuple(range(w.ndim - 1))
    else:
        # Conv weight (O, I/g, kH, kW): contract everything but the
        # output-channel axis
        axes = tuple(range(1, w.ndim))
        if any(int(p) != 0 for p in node.attrs.get("pads", ())):
            p_lo = np.minimum(p_lo, 0.0)
            p_hi = np.maximum(p_hi, 0.0)
    lo = np.sum(p_lo, axis=axes)
    hi = np.sum(p_hi, axis=axes)
    return AccumulatorSpec(float(np.min(lo)), float(np.max(hi)))


# --------------------------------------------------------------- analysis

def analyze(graph: QonnxGraph, input_ranges: Optional[dict] = None,
            evaluate_constants: bool = True) -> GraphAnalysis:
    """Run the forward range analysis.

    input_ranges — optional {tensor_name: (lo, hi)} priors for graph inputs
                   (e.g. image data known to be in [0, 1]); inputs default
                   to unbounded FLOAT32.
    evaluate_constants — evaluate all-static subgraphs with the interpreted
                   ops so their exact values (and thus exact ranges) are
                   known.  Disable only for very large graphs.
    """
    ga = GraphAnalysis(graph)
    ranges = ga.ranges
    consts = ga.const_values

    for name, v in graph.initializers.items():
        v = np.asarray(v)
        consts[name] = v
        lo, hi = _minmax(v) if v.size else (0.0, 0.0)
        ranges[name] = RangeInfo(lo, hi, _is_integral(v))
    for t in graph.inputs:
        prior = (input_ranges or {}).get(t.name, _UNBOUNDED)
        ranges[t.name] = RangeInfo(float(prior[0]), float(prior[1]), False)

    for node in graph.toposort():
        abstract = _transfer(node, ranges, consts)
        if evaluate_constants and \
                all((not i) or i in consts for i in node.inputs):
            try:
                # static analysis over initializers at compile time: like
                # the reference, it runs on the host, so the port's oracle
                # evaluates the node on the CPU and the values come back as
                # numpy; the plan this analysis selects runs on the card
                out = op_output(node, [to_tensor(consts[i]) if i else None
                                       for i in node.inputs])
                for name, val in zip(node.outputs, out):
                    v = val.numpy() if isinstance(val, torch.Tensor) \
                        else np.asarray(val)
                    consts[name] = v
                    lo, hi = _minmax(v) if v.size else (0.0, 0.0)
                    # exact values beat the abstract bounds; the grid
                    # annotation (scale / integer domain) is kept
                    grid = abstract.get(name, RangeInfo()).grid
                    ranges[name] = RangeInfo(lo, hi, _is_integral(v), grid)
                continue
            except Exception:
                pass  # un-executable static node: keep the abstract result
        ranges.update(abstract)
    return ga


def _transfer(node: Node, ranges: dict, consts: dict) -> dict[str, RangeInfo]:
    """Abstract transfer function: node -> {output: RangeInfo}."""
    fn = _TRANSFER.get(node.op_type, _t_unknown)
    try:
        return fn(node, ranges, consts)
    except Exception:
        return {o: RangeInfo() for o in node.outputs}


def _in(ranges, name) -> RangeInfo:
    return ranges.get(name, RangeInfo())


def _t_unknown(node, ranges, consts):
    return {o: RangeInfo() for o in node.outputs}


def _t_shuffle(node, ranges, consts):
    return {node.outputs[0]: _in(ranges, node.inputs[0])}


def _t_relu(node, ranges, consts):
    r = _in(ranges, node.inputs[0])
    lo, hi = max(r.lo, 0.0), max(r.hi, 0.0)
    grid = None
    if r.grid is not None and np.all(np.asarray(r.grid.zero_point) == 0) and \
            np.all(np.asarray(r.grid.scale) > 0):
        # relu(s*q) = s*max(q, 0): still on the same grid
        grid = QuantGrid(r.grid.scale, r.grid.zero_point,
                         max(r.grid.int_lo, 0.0), max(r.grid.int_hi, 0.0))
    return {node.outputs[0]: RangeInfo(lo, hi, r.integer, grid)}


def _t_maxpool(node, ranges, consts):
    r = _in(ranges, node.inputs[0])
    return {node.outputs[0]: RangeInfo(r.lo, r.hi, r.integer, r.grid)}


def _t_avgpool(node, ranges, consts):
    r = _in(ranges, node.inputs[0])
    # mean stays within the bounds but leaves the integer grid
    return {node.outputs[0]: RangeInfo(r.lo, r.hi, False, None)}


def _intlike(v: float) -> bool:
    return not np.isfinite(v) or float(v) == np.round(v)


def _t_clip(node, ranges, consts):
    r = _in(ranges, node.inputs[0])
    lo = float(node.attrs.get("min", -np.inf))
    hi = float(node.attrs.get("max", np.inf))
    if len(node.inputs) > 1 and node.inputs[1] and node.inputs[1] in consts:
        lo = float(np.asarray(consts[node.inputs[1]]))
    if len(node.inputs) > 2 and node.inputs[2] and node.inputs[2] in consts:
        hi = float(np.asarray(consts[node.inputs[2]]))
    out_lo, out_hi = max(r.lo, lo), min(r.hi, hi)
    integer = r.integer and _intlike(lo) and _intlike(hi)
    grid = None
    # the grid survives only when the tensor *is* its own integer domain
    # (a QuantizeLinear carrier: value == q), so real-domain clip bounds
    # and grid-domain bounds coincide
    if r.grid is not None and integer and \
            r.lo == r.grid.int_lo and r.hi == r.grid.int_hi:
        grid = QuantGrid(r.grid.scale, r.grid.zero_point,
                         max(r.grid.int_lo, lo), min(r.grid.int_hi, hi))
    return {node.outputs[0]: RangeInfo(out_lo, out_hi, integer, grid)}


def _t_add(node, ranges, consts):
    a, b = _in(ranges, node.inputs[0]), _in(ranges, node.inputs[1])
    return {node.outputs[0]: RangeInfo(a.lo + b.lo, a.hi + b.hi,
                                       a.integer and b.integer)}


def _t_sub(node, ranges, consts):
    a, b = _in(ranges, node.inputs[0]), _in(ranges, node.inputs[1])
    return {node.outputs[0]: RangeInfo(a.lo - b.hi, a.hi - b.lo,
                                       a.integer and b.integer)}


def _t_mul(node, ranges, consts):
    a, b = _in(ranges, node.inputs[0]), _in(ranges, node.inputs[1])
    if not (a.is_bounded() and b.is_bounded()):
        return {node.outputs[0]: RangeInfo(integer=a.integer and b.integer)}
    prods = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    return {node.outputs[0]: RangeInfo(min(prods), max(prods),
                                       a.integer and b.integer)}


def _gemm_nondefault(node: Node) -> bool:
    """Gemm attributes the bound math does not model."""
    a = node.attrs
    return bool(a.get("alpha", 1.0) != 1.0 or a.get("beta", 1.0) != 1.0 or
                a.get("transA", 0) or a.get("transB", 0))


def _t_matmul(node, ranges, consts):
    a = _in(ranges, node.inputs[0])
    w = consts.get(node.inputs[1])
    if w is None or not a.is_bounded() or \
            (node.op_type == "Gemm" and _gemm_nondefault(node)):
        return {node.outputs[0]: RangeInfo()}
    spec = _dot_bound(node, np.asarray(w, np.float64), a.lo, a.hi)
    lo, hi = spec.int_lo, spec.int_hi
    integer = a.integer and _is_integral(np.asarray(w))
    if len(node.inputs) > 2 and node.inputs[2]:       # Gemm / Conv bias
        c = consts.get(node.inputs[2])
        if c is None:
            return {node.outputs[0]: RangeInfo()}
        lo, hi = lo + float(np.min(c)), hi + float(np.max(c))
        integer = integer and _is_integral(np.asarray(c))
    return {node.outputs[0]: RangeInfo(lo, hi, integer)}


def _t_quant(node, ranges, consts):
    s = consts.get(node.inputs[1])
    z = consts.get(node.inputs[2])
    bw = consts.get(node.inputs[3])
    if s is None or z is None or bw is None or np.any(np.asarray(s) <= 0):
        return {node.outputs[0]: RangeInfo()}
    signed = bool(node.attrs.get("signed", 1))
    narrow = bool(node.attrs.get("narrow", 0))
    nb = float(np.max(np.asarray(bw)))
    q_lo = float(quant_ops.min_int(signed, narrow, nb))
    q_hi = float(quant_ops.max_int(signed, narrow, nb))
    # intersect with what the input range can reach on the grid
    r = _in(ranges, node.inputs[0])
    if r.is_bounded():
        s_a, z_a = np.asarray(s, np.float64), np.asarray(z, np.float64)
        reach_lo = math.floor(float(np.min(r.lo / s_a + z_a)))
        reach_hi = math.ceil(float(np.max(r.hi / s_a + z_a)))
        new_lo, new_hi = max(q_lo, reach_lo), min(q_hi, reach_hi)
        if new_lo > new_hi:                  # clamp saturates to one edge
            new_lo = new_hi = q_hi if reach_lo > q_hi else q_lo
        q_lo, q_hi = new_lo, new_hi
    grid = QuantGrid(np.asarray(s, np.float32), np.asarray(z, np.float32),
                     q_lo, q_hi)
    s_b, z_b = np.broadcast_arrays(np.asarray(s, np.float64),
                                   np.asarray(z, np.float64))
    lo = float(np.min(s_b * (q_lo - z_b)))
    hi = float(np.max(s_b * (q_hi - z_b)))
    integer = _is_integral(np.asarray(s)) and _is_integral(np.asarray(z))
    return {node.outputs[0]: RangeInfo(lo, hi, integer, grid)}


def _t_bipolar(node, ranges, consts):
    s = consts.get(node.inputs[1])
    if s is None:
        return {node.outputs[0]: RangeInfo()}
    amax = float(np.max(np.abs(s)))
    grid = QuantGrid(np.asarray(s, np.float32),
                     np.zeros_like(np.asarray(s, np.float32)), -1.0, 1.0)
    return {node.outputs[0]: RangeInfo(-amax, amax,
                                       _is_integral(np.asarray(s)), grid)}


def _t_trunc(node, ranges, consts):
    s = consts.get(node.inputs[1])
    z = consts.get(node.inputs[2])
    in_bw = consts.get(node.inputs[3])
    out_bw = consts.get(node.inputs[4])
    if any(v is None for v in (s, z, in_bw, out_bw)):
        return {node.outputs[0]: RangeInfo()}
    signed = bool(node.attrs.get("signed", 1))
    nb = float(np.max(np.asarray(out_bw)))
    q_lo = float(quant_ops.min_int(signed, False, nb))
    q_hi = float(quant_ops.max_int(signed, False, nb))
    shift = 2.0 ** (float(np.max(np.asarray(in_bw))) - nb)
    s_b, z_b = np.broadcast_arrays(np.asarray(s, np.float64) * shift,
                                   np.asarray(z, np.float64))
    lo = float(np.min(s_b * (q_lo - z_b)))
    hi = float(np.max(s_b * (q_hi - z_b)))
    grid = QuantGrid(np.asarray(s_b, np.float32),
                     np.asarray(z, np.float32), q_lo, q_hi)
    return {node.outputs[0]: RangeInfo(lo, hi, False, grid)}


def _t_quantize_linear(node, ranges, consts):
    s = consts.get(node.inputs[1])
    zp = consts.get(node.inputs[2]) if len(node.inputs) > 2 and \
        node.inputs[2] else None
    if s is None:
        return {node.outputs[0]: RangeInfo()}
    signed = zp is not None and np.issubdtype(np.asarray(zp).dtype,
                                              np.signedinteger)
    q_lo, q_hi = (-128.0, 127.0) if signed else (0.0, 255.0)
    r = _in(ranges, node.inputs[0])
    if r.is_bounded() and np.all(np.asarray(s) > 0):
        s_a = np.asarray(s, np.float64)
        z_a = np.asarray(0 if zp is None else zp, np.float64)
        q_lo = max(q_lo, math.floor(float(np.min(r.lo / s_a + z_a))))
        q_hi = min(q_hi, math.ceil(float(np.max(r.hi / s_a + z_a))))
    grid = QuantGrid(np.asarray(s, np.float32),
                     np.asarray(0 if zp is None else zp, np.float32),
                     q_lo, q_hi)
    return {node.outputs[0]: RangeInfo(q_lo, q_hi, True, grid)}


def _t_dequantize_linear(node, ranges, consts):
    r = _in(ranges, node.inputs[0])
    s = consts.get(node.inputs[1])
    zp = consts.get(node.inputs[2]) if len(node.inputs) > 2 and \
        node.inputs[2] else np.zeros(1)
    if s is None or zp is None or not r.is_bounded():
        return {node.outputs[0]: RangeInfo()}
    s_b, z_b = np.broadcast_arrays(np.asarray(s, np.float64),
                                   np.asarray(zp, np.float64))
    dq = np.stack([s_b * (r.lo - z_b), s_b * (r.hi - z_b)])
    grid = None
    if r.integer:
        grid = QuantGrid(np.asarray(s, np.float32),
                         np.asarray(zp, np.float32), r.lo, r.hi)
    integer = _is_integral(np.asarray(s)) and _is_integral(np.asarray(zp)) \
        and r.integer
    return {node.outputs[0]: RangeInfo(float(np.min(dq)), float(np.max(dq)),
                                       integer, grid)}


def _t_concat(node, ranges, consts):
    rs = [_in(ranges, i) for i in node.inputs if i]
    return {node.outputs[0]: RangeInfo(min(r.lo for r in rs),
                                       max(r.hi for r in rs),
                                       all(r.integer for r in rs))}


def _t_pad(node, ranges, consts):
    r = _in(ranges, node.inputs[0])
    v = 0.0
    if len(node.inputs) > 2 and node.inputs[2] and node.inputs[2] in consts:
        v = float(np.asarray(consts[node.inputs[2]]))
    return {node.outputs[0]: RangeInfo(min(r.lo, v), max(r.hi, v),
                                       r.integer and v == round(v))}


def _t_cast(node, ranges, consts):
    r = _in(ranges, node.inputs[0])
    to = np.dtype(node.attrs.get("to", "float32"))
    integer = r.integer or np.issubdtype(to, np.integer)
    return {node.outputs[0]: RangeInfo(r.lo, r.hi, integer, r.grid)}


def _t_matmul_integer(node, ranges, consts):
    a = _in(ranges, node.inputs[0])
    w = consts.get(node.inputs[1])
    if w is None or not a.is_bounded():
        return {node.outputs[0]: RangeInfo(integer=True)}
    a_zp = 0.0
    if len(node.inputs) > 2 and node.inputs[2] and node.inputs[2] in consts:
        a_zp = float(np.max(np.abs(consts[node.inputs[2]])))
    w_eff = np.asarray(w, np.float64)
    if len(node.inputs) > 3 and node.inputs[3] and node.inputs[3] in consts:
        w_eff = w_eff - np.asarray(consts[node.inputs[3]], np.float64)
    spec = _dot_bound(node, w_eff, a.lo - a_zp, a.hi + a_zp)
    return {node.outputs[0]: RangeInfo(spec.int_lo, spec.int_hi, True)}


_TRANSFER = {
    "Quant": _t_quant,
    "BipolarQuant": _t_bipolar,
    "Trunc": _t_trunc,
    "QuantizeLinear": _t_quantize_linear,
    "DequantizeLinear": _t_dequantize_linear,
    "MatMul": _t_matmul,
    "Gemm": _t_matmul,
    "Conv": _t_matmul,
    "MatMulInteger": _t_matmul_integer,
    "Add": _t_add,
    "Sub": _t_sub,
    "Mul": _t_mul,
    "Relu": _t_relu,
    "Clip": _t_clip,
    "MaxPool": _t_maxpool,
    "GlobalMaxPool": _t_maxpool,
    "AveragePool": _t_avgpool,
    "GlobalAveragePool": _t_avgpool,
    "ReduceMean": _t_avgpool,
    "Concat": _t_concat,
    "Pad": _t_pad,
    "Cast": _t_cast,
    "BatchNormalization": _t_unknown,
}
_TRANSFER.update({op: _t_shuffle for op in _SHUFFLE_OPS})
