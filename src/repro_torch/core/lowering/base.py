"""Lowering-rule registry: the declarative pattern layer of the compiler.

Counterpart of ``repro.core.lowering.base``.  Each fused pattern is a
registered ``LoweringRule``:

  * ``anchor_ops`` — the op_types at which the partitioner attempts the
    rule (the MatMul for weight-quant segments, the Quant/QuantizeLinear
    for activation-QDQ segments);
  * ``match(graph, node, ctx)`` — inspect the neighbourhood, return a
    ``Match`` naming every covered node plus whatever the emitter needs,
    or None;
  * ``emit(idx, match, consts, ctx)`` — stage constants (packed weight
    carriers, scales) as device tensors into the plan's consts dict and
    return the ``Segment`` that runs at the anchor's position.

``compile_graph`` iterates ``rules_for(node.op_type)`` in priority order
(ties broken by name) and takes the first match whose covered nodes don't
overlap an earlier match.

Rules (imported by ``lowering/__init__``):

  priority 10  quant_matmul        Quant/BipolarQuant/QCDQ(w) -> MatMul/Gemm
                                   [-> Mul][-> Add]   (lowering/matmul.py)
  priority 15  quant_grouped_conv  ... -> Conv(1 < group) [-> Relu]
                                   [-> Quant]   (lowering/grouped_conv.py)
  priority 20  quant_conv          ... -> Conv [-> Relu] [-> Quant]
                                   (im2col, lowering/conv.py)
  priority 30  quant_qdq           activation Quant   (lowering/qdq.py)
  priority 40  qcdq_chain          QuantizeLinear [-> Clip] ->
                                   DequantizeLinear
  priority 50  bipolar_act         activation BipolarQuant  (lowering/fusion.py)
  priority 50  quant_pool          MaxPool / AveragePool
  priority 55  eltwise_add         Add [-> Relu] [-> Quant]
  priority 55  quant_concat        Concat
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..graph import Node, QonnxGraph


# ------------------------------------------------------------ segment IR

@dataclass
class Segment:
    """One fused unit of the compiled plan.

    kind      — "quant_matmul[_int4]" | "quant_conv[_int4]"
                | "quant_conv_grouped[_int4]" | "quant_conv_dw"
                | "quant_dequant" | "interp"
    nodes     — graph nodes this segment covers (for stats / debugging)
    inputs    — env tensor names read;  outputs — env names written
    run       — fn(consts: dict, env: dict) -> None (writes env)
    meta      — annotations (accumulator dtype, epilogue path)
    """
    kind: str
    nodes: list[Node]
    inputs: list[str]
    outputs: list[str]
    run: Callable[[dict, dict], None]
    const_keys: tuple = ()         # consts-dict keys this segment reads
    meta: dict = field(default_factory=dict)

    def describe(self) -> str:
        ops = "+".join(n.op_type for n in self.nodes)
        extra = ""
        if self.meta:
            extra = " {" + ", ".join(f"{k}={v}"
                                     for k, v in sorted(self.meta.items())) + "}"
        return f"[{self.kind}] {ops} -> {', '.join(self.outputs)}{extra}"


# --------------------------------------------------------- rule protocol

@dataclass
class LoweringContext:
    """Per-compilation knobs every rule sees (compile_graph's arguments)."""
    analysis: Optional[object] = None      # GraphAnalysis or None
    use_int4: bool = True
    use_int_requant: bool = True   # dyadic integer-epilogue selection
                                   # (lowering/requant.py; needs analysis)
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    use_fusion: bool = True        # cross-segment fusion rules + integer
                                   # boundary carriers (lowering/fusion.py)
    fusion: Optional[object] = None  # fusion.FusionPlan once negotiated:
                                     # emitters read boundary carriers here
    tuner: Optional[object] = None   # tune.Autotuner: per-segment launch
                                     # geometry (compile_graph's tune=)


@dataclass
class Match:
    """Base match payload: the covered nodes.  Rules subclass this."""
    nodes: list[Node]


class LoweringRule:
    """One declarative fused-lowering pattern (see module docstring)."""

    name: str = ""
    anchor_ops: tuple[str, ...] = ()
    priority: int = 100

    def match(self, g: QonnxGraph, node: Node,
              ctx: LoweringContext) -> Optional[Match]:
        raise NotImplementedError

    def emit(self, idx: int, match: Match, consts: dict,
             ctx: LoweringContext) -> Segment:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<LoweringRule {self.name!r} anchors={self.anchor_ops} "
                f"priority={self.priority}>")


# -------------------------------------------------------------- registry

_RULES: dict[str, LoweringRule] = {}


def register_rule(rule):
    """Register a ``LoweringRule`` (instance or class; usable as decorator).

    Raises on a duplicate name — replacing a rule must be explicit
    (``unregister_rule`` first)."""
    inst = rule() if isinstance(rule, type) else rule
    if not inst.name:
        raise ValueError(f"lowering rule {inst!r} has no name")
    if not inst.anchor_ops:
        raise ValueError(f"lowering rule {inst.name!r} declares no anchor ops")
    if inst.name in _RULES:
        raise ValueError(f"lowering rule {inst.name!r} already registered")
    _RULES[inst.name] = inst
    return rule


def unregister_rule(name: str) -> None:
    _RULES.pop(name, None)


def get_rule(name: str) -> LoweringRule:
    return _RULES[name]


def iter_rules() -> list[LoweringRule]:
    """All rules, priority order (ascending), ties broken by name."""
    return sorted(_RULES.values(), key=lambda r: (r.priority, r.name))


def rules_for(op_type: str) -> list[LoweringRule]:
    """Rules anchored at ``op_type``, priority order."""
    return [r for r in iter_rules() if op_type in r.anchor_ops]


# ------------------------------------------------------- shared helpers

def static_value(g: QonnxGraph, name: str) -> Optional[np.ndarray]:
    v = g.initializers.get(name)
    return None if v is None else np.asarray(v)


def scalar(a: Optional[np.ndarray]) -> Optional[float]:
    if a is None or a.size != 1:
        return None
    return float(a.reshape(()))


def col_scale(a: np.ndarray, n: int) -> Optional[np.ndarray]:
    """Normalize a scale to scalar () or per-output-column (N,); None if it
    has any other (non-commuting) granularity.  Only the *last* axis may be
    non-degenerate — a per-row (K, 1) scale on the contraction dim must not
    be silently transposed into a column scale."""
    a = np.asarray(a, np.float32)
    if a.size == 1:
        return a.reshape(())
    if a.ndim >= 1 and a.shape[-1] == a.size == n:
        return a.reshape(-1)
    return None


def conv_channel_scale(a: np.ndarray,
                       w_shape: tuple) -> Optional[np.ndarray]:
    """Conv-weight dequant-scale granularities the im2col lowering commutes
    with: broadcast against the (O, I/g, kH, kW) weight (the right-aligned
    broadcasting the oracle's Quant applies), the scale must be constant
    within each output channel, since output channels become matmul
    columns.  Returns () or (O,); None otherwise.

    A bare 1-D (O,) array broadcasts along *kW* in the oracle, not along
    O: only an (O, 1, 1, 1)-shaped scale is per output channel, so the
    check is on broadcast behaviour, not on which axis holds the values."""
    a = np.asarray(a, np.float32)
    if a.size == 1:
        return a.reshape(())
    try:
        sb = np.broadcast_to(a, w_shape).reshape(w_shape[0], -1)
    except ValueError:
        return None
    if not np.all(sb == sb[:, :1]):
        return None                  # varies within an output channel
    return np.ascontiguousarray(sb[:, 0])


def tensor_rows(g: QonnxGraph, name: str) -> Optional[int]:
    """Leading (batch·spatial) row count of a 2-D-viewable tensor, the M
    dim of its kernel; None when the shape is unknown or below rank 2.
    None dims (symbolic batch) count as 1."""
    sh = g.get_shape(name)
    if not sh or len(sh) < 2:
        return None
    rows = 1
    for d in sh[:-1]:
        rows *= 1 if d is None else int(d)
    return rows


def tensor_batch(g: QonnxGraph, name: str) -> int:
    """The declared leading (batch) dim of a tensor; 1 when it is symbolic
    or the shape is unknown."""
    sh = g.get_shape(name)
    return int(sh[0]) if sh and sh[0] is not None else 1


def blocks_at(cfg, rows: Optional[int], batch: int):
    """The ``blocks`` a tuned segment's kernel call passes, as a function of
    the call's input ``x``: ``cfg``'s blocks where the call's rows (``rows``
    at the declared ``batch``, scaled by x's leading dim) fall in the
    bucket they were tuned at (``tune.bucket_rows``), else None.  A
    geometry measured at one bucket says nothing of another, where the
    heuristic plan runs at the call's own shape; an untuned segment always
    runs the heuristic."""
    if cfg is None or not cfg.tuned or not rows:
        return lambda x: None
    from repro_torch.tune import bucket_rows
    blocks, bucket, batch = tuple(cfg.blocks), bucket_rows(rows), max(1, batch)
    return lambda x: blocks if bucket_rows(
        rows * x.shape[0] // batch) == bucket else None


def conv_out_rows(g: QonnxGraph, node: Node) -> Optional[int]:
    """im2col matmul rows (N·OH·OW) of a Conv from its output shape."""
    sh = g.get_shape(node.outputs[0])
    if not sh or len(sh) < 3:
        return None
    rows = 1
    for ax, d in enumerate(sh):
        if ax == 1:                 # NCHW channel axis -> matmul columns
            continue
        rows *= 1 if d is None else int(d)
    return rows


def sole_consumer(g: QonnxGraph, tensor: str) -> Optional[Node]:
    cons = g.consumers(tensor)
    if len(cons) == 1 and tensor not in g.output_names:
        return cons[0]
    return None


def select_accumulator(ctx: LoweringContext, node: Node, match,
                       w_int: Optional[np.ndarray] = None) -> None:
    """Per-rule accumulator selection (the analysis tier's hook).

    The fused kernel computes ``x @ w_int`` (activation *values* against
    integer weight carriers); ``GraphAnalysis.kernel_accumulator`` bounds
    that dot product from the proven activation range (zero-padding-aware
    for Conv) and says whether exact int32 accumulation is sound.  Rules
    whose staged carrier layout differs from the node's operand (the conv
    rules stage an im2col matrix or per-group carriers) pass the
    operand-shaped ``w_int``.

    Mutates ``match.acc_dtype`` / ``match.acc_bits`` in place; a None
    analysis (use_analysis=False) leaves the float32 default.
    """
    ga = ctx.analysis
    if ga is None:
        return
    choice = ga.kernel_accumulator(
        node, match.w_int if w_int is None else w_int)
    if choice is None:
        return
    bits, exact_int32 = choice
    match.acc_bits = bits
    if exact_int32:
        match.acc_dtype = torch.int32
