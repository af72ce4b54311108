"""Inference-cost reporting from the analyzed graph (paper Eq. 5, Table III).

Counterpart of ``repro.analysis.cost`` (the same code over the port's
graph and plan).

Where ``core/bops.py`` holds the Eq. 5 *formulas*, this module computes the
per-layer inputs to those formulas — weight/activation bit widths, MAC and
weight counts, accumulator widths, memory traffic — from the **analysis
subsystem** (datatype inference + range analysis) instead of ad-hoc
producer pattern matching.  ``core.bops.graph_cost`` now delegates here, so
the Table III reproduction in tests/test_zoo.py exercises this path.

Per layer (MatMul / Gemm / Conv):

  * macs, weights        — from inferred shapes;
  * weight_bits          — weights x declared weight bit width (exact
                           fractional widths honored);
  * bops (Eq. 5)         — b_w/b_a from the datatype annotations;
  * acc_bits             — minimal accumulator width from the worst-case
                           dot-product bound (None when the input grid is
                           unknown);
  * mem_bytes            — weight bits/8 + input/output activation traffic
                           at their annotated widths (FLOAT32 = 32 bit).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core import bops as bops_mod
from ..core.graph import QonnxGraph

from .infer import infer_datatype_map
from .ranges import GraphAnalysis, analyze


@dataclass
class LayerReport:
    name: str
    op_type: str
    macs: int                   # true contraction: I/g·kH·kW per output
    bops: float
    weights: int
    weight_bits: float          # total bits of this layer's weights
    w_dtype: str = "FLOAT32"
    a_dtype: str = "FLOAT32"
    b_w: float = 32.0           # per-weight bit width used in Eq. 5
    b_a: float = 32.0
    acc_bits: Optional[int] = None
    mem_bytes: float = 0.0
    groups: int = 1             # Conv group attribute (1 for FC layers)
    requant: Optional[str] = None     # "int32"/"fp32" when a plan is given
    fp32_ops_eliminated: int = 0      # per-inference, from the segment meta


@dataclass
class CostReport:
    """Duck-type-compatible with core.bops.ModelCost (layers + totals)."""
    graph_name: str = ""
    layers: list[LayerReport] = field(default_factory=list)
    # cross-segment fusion telemetry (populated from plan.fusion_stats()
    # when a compiled plan is supplied to infer_cost)
    fused_boundary_segments: int = 0
    integer_boundaries: int = 0
    packed_boundaries: int = 0
    boundary_bytes_saved: int = 0

    @property
    def macs(self):
        return sum(l.macs for l in self.layers)

    @property
    def bops(self):
        return sum(l.bops for l in self.layers)

    @property
    def weights(self):
        return sum(l.weights for l in self.layers)

    @property
    def total_weight_bits(self):
        return sum(l.weight_bits for l in self.layers)

    @property
    def total_mem_bytes(self):
        return sum(l.mem_bytes for l in self.layers)

    @property
    def dense_equiv_macs(self):
        """MACs if every grouped conv ran as a dense (block-diagonal
        im2col) matmul: each grouped layer inflates by its group count.
        This is what the kernel tier actually executed before the dedicated
        grouped/depthwise kernels existed; ``macs`` is the true
        I/g·kH·kW-contraction count."""
        return sum(l.macs * l.groups for l in self.layers)

    @property
    def grouped_macs_reclaimed(self):
        """MACs the grouped/depthwise kernels reclaim vs the dense
        block-diagonal carrier (0 when the model has no grouped convs)."""
        return self.dense_equiv_macs - self.macs

    @property
    def integer_segment_fraction(self) -> Optional[float]:
        """Fraction of kernel-lowered layers whose requantization runs on
        the integer (multiplier, shift) path; None when the report was
        built without a compiled plan (no requant annotations)."""
        annotated = [l for l in self.layers if l.requant is not None]
        if not annotated:
            return None
        return sum(1 for l in annotated if l.requant == "int32") / \
            len(annotated)

    @property
    def fp32_ops_eliminated(self) -> int:
        """fp32 epilogue ops per inference removed by the integer path."""
        return sum(l.fp32_ops_eliminated for l in self.layers)

    def table(self) -> str:
        rq = any(l.requant is not None for l in self.layers)
        head = (f"{'layer':24s} {'op':8s} {'MACs':>12s} {'wbits':>5s} "
                f"{'abits':>5s} {'acc':>4s} {'BOPs':>12s} {'KiB':>9s}")
        if rq:
            head += f" {'requant':>7s} {'fp32-elim':>10s}"
        lines = [head, "-" * len(head)]
        for l in self.layers:
            line = (
                f"{l.name[:24]:24s} {l.op_type:8s} {l.macs:12,d} "
                f"{l.b_w:5.3g} {l.b_a:5.3g} "
                f"{l.acc_bits if l.acc_bits is not None else '-':>4} "
                f"{l.bops:12.4g} {l.mem_bytes / 1024:9.1f}")
            if rq:
                line += (f" {l.requant or '-':>7s} "
                         f"{l.fp32_ops_eliminated:10,d}")
            lines.append(line)
        lines.append("-" * len(head))
        lines.append(
            f"{self.graph_name[:24]:24s} {'TOTAL':8s} {self.macs:12,d} "
            f"{'':5s} {'':5s} {'':>4s} {self.bops:12.4g} "
            f"{self.total_mem_bytes / 1024:9.1f}")
        lines.append(
            f"weights={self.weights:,}  total_weight_bits="
            f"{int(self.total_weight_bits):,}")
        reclaimed = self.grouped_macs_reclaimed
        if reclaimed:
            n_grouped = sum(1 for l in self.layers if l.groups > 1)
            lines.append(
                f"grouped: {n_grouped} layers, {reclaimed:,} MACs reclaimed "
                f"by the grouped/depthwise kernels vs a dense block-diagonal "
                f"carrier ({self.dense_equiv_macs:,} dense-equivalent)")
        frac = self.integer_segment_fraction
        if frac is not None:
            n_ann = sum(1 for l in self.layers if l.requant is not None)
            n_int = sum(1 for l in self.layers if l.requant == "int32")
            lines.append(
                f"integer requant: {n_int}/{n_ann} kernel layers "
                f"({frac:.0%} integer-only), fp32 epilogue ops eliminated "
                f"per inference: {self.fp32_ops_eliminated:,}")
        if self.integer_boundaries or self.boundary_bytes_saved:
            lines.append(
                f"cross-segment fusion: {self.integer_boundaries} integer "
                f"boundaries ({self.packed_boundaries} packed int4), "
                f"{self.fused_boundary_segments} fused boundary segments, "
                f"{self.boundary_bytes_saved:,} boundary bytes saved per "
                f"call vs fp32")
        return "\n".join(lines)

    def csv(self) -> str:
        rows = ["layer,op,macs,weights,b_w,b_a,acc_bits,bops,mem_bytes,"
                "groups,requant,fp32_ops_eliminated"]
        for l in self.layers:
            rows.append(f"{l.name},{l.op_type},{l.macs},{l.weights},"
                        f"{l.b_w:g},{l.b_a:g},"
                        f"{l.acc_bits if l.acc_bits is not None else ''},"
                        f"{l.bops:.6g},{l.mem_bytes:.1f},{l.groups},"
                        f"{l.requant or ''},{l.fp32_ops_eliminated}")
        return "\n".join(rows)


def _bits_for(dtypes, qbits, tensor, default: float) -> tuple[float, str]:
    dt = dtypes.get(tensor)
    if dt is None or not dt.is_integer():
        return default, "FLOAT32" if dt is None else str(dt)
    return qbits.get(tensor, float(dt.bits)), str(dt)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d) if d is not None else 1
    return n


def infer_cost(graph: QonnxGraph, act_bits: float = 8.0,
               default_weight_bits: float = 8.0,
               ga: Optional[GraphAnalysis] = None,
               plan=None) -> CostReport:
    """Analysis-driven inference cost of every MatMul/Gemm/Conv layer.

    Shapes must be known (run ``infer_shapes`` / the cleanup pipeline
    first); unknown-shape layers are skipped, matching the historical
    ``bops.graph_cost`` behaviour.  ``act_bits``/``default_weight_bits``
    are the fallbacks for tensors whose datatype inference says FLOAT32.

    ``plan`` (an optional ``CompiledPlan`` over the same graph) annotates
    each kernel-lowered layer with its requantization path
    (``requant_path`` segment meta: ``"int32"`` for the exact dyadic
    multiplier+shift epilogue, ``"fp32"`` for the float
    dequant->round->requant chain) and the per-inference fp32 epilogue ops
    the integer path eliminates; the report then exposes
    ``integer_segment_fraction`` / ``fp32_ops_eliminated`` and grows the
    matching table/CSV columns.  A plan also contributes its cross-segment
    fusion stats (integer boundary carriers, boundary bytes saved — the
    optimization target of lowering/fusion.py), summarized at the foot of
    ``table()``.
    """
    ga = ga or analyze(graph)
    dtypes, qbits = infer_datatype_map(graph, ga)
    requant_by_node: dict = {}
    if plan is not None:
        for seg in getattr(plan, "segments", ()):
            path = seg.meta.get("requant_path")
            if path is None:
                continue
            elim = int(seg.meta.get("fp32_ops_eliminated", 0))
            for n in seg.nodes:
                requant_by_node[n.name] = (path, elim)
    report = CostReport(graph.name)
    if plan is not None and hasattr(plan, "fusion_stats"):
        fs = plan.fusion_stats()
        report.fused_boundary_segments = fs["fused_boundary_segments"]
        report.integer_boundaries = fs["integer_boundaries"]
        report.packed_boundaries = fs["packed_boundaries"]
        report.boundary_bytes_saved = fs["boundary_bytes_saved"]

    for node in graph.nodes:
        if node.op_type not in ("MatMul", "Gemm", "Conv"):
            continue
        w_name = node.inputs[1]
        w_shape = graph.get_shape(w_name)
        b_w, w_dt = _bits_for(dtypes, qbits, w_name, default_weight_bits)
        b_a, a_dt = _bits_for(dtypes, qbits, node.inputs[0], act_bits)
        if node.op_type in ("MatMul", "Gemm"):
            if w_shape is None or len(w_shape) != 2:
                continue
            n_in, m_out = int(w_shape[0]), int(w_shape[1])
            if node.op_type == "Gemm" and node.attrs.get("transB", 0):
                m_out, n_in = n_in, m_out
            base = bops_mod.fc_cost(node.name, n_in, m_out, b_w, b_a)
        else:
            y_shape = graph.get_shape(node.outputs[0])
            if w_shape is None or y_shape is None:
                continue
            m_out, cin_g, k = int(w_shape[0]), int(w_shape[1]), int(w_shape[2])
            layout = node.attrs.get("data_layout", "NCHW")
            sp = y_shape[2:] if layout == "NCHW" else y_shape[1:-1]
            out_hw = _numel(sp)
            base = bops_mod.conv_cost(node.name, cin_g, m_out, k, out_hw,
                                      b_w, b_a)

        spec = ga.accumulator_spec(node)
        in_shape = graph.get_shape(node.inputs[0])
        out_shape = graph.get_shape(node.outputs[0])
        mem = base.weight_bits / 8.0
        if in_shape is not None:
            mem += _numel(in_shape) * b_a / 8.0
        if out_shape is not None:
            mem += _numel(out_shape) * 32.0 / 8.0    # fp32 accumulator out
        groups = int(node.attrs.get("group", 1)) if node.op_type == "Conv" \
            else 1
        rq_path, rq_elim = requant_by_node.get(node.name, (None, 0))
        report.layers.append(LayerReport(
            base.name, node.op_type, base.macs, base.bops, base.weights,
            base.weight_bits, w_dt, a_dt, b_w, b_a,
            None if spec is None else spec.bits, mem, groups,
            rq_path, rq_elim))
    return report


def compare_table3(report: CostReport, ref: tuple,
                   skip_first_conv: bool = False,
                   skip_first_conv_weights: bool = False) -> str:
    """Format a comparison against a (macs, weights, weight_bits) Table III
    row, applying the paper's counting conventions (first conv excluded
    from MACs for conv nets; from weights for MobileNet)."""
    first_conv = next((l for l in report.layers if l.op_type == "Conv"), None)
    macs = report.macs - (first_conv.macs if skip_first_conv and first_conv
                          else 0)
    weights = report.weights - (
        first_conv.weights if skip_first_conv_weights and first_conv else 0)
    ref_macs, ref_w, ref_bits = ref
    rows = []
    for label, got, want in (("MACs", macs, ref_macs),
                             ("weights", weights, ref_w),
                             ("weight_bits", int(report.total_weight_bits),
                              ref_bits)):
        rel = abs(got - want) / max(want, 1)
        mark = "OK " if rel < 2e-3 else "!! "
        rows.append(f"  {mark}{label:12s} {got:>14,} (Table III: {want:,})")
    return "\n".join(rows)
