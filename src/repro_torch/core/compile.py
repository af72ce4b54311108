"""Compiled QonnxGraph executor: fused segments over the Hopper kernels.

Counterpart of ``repro.core.compile``.  ``executor.execute`` is the §V
oracle; this module is the performance tier above it:

  1. **Partition** a cleaned graph into fused segments by iterating the
     declarative lowering-rule registry (``core/lowering``) in priority
     order.  The rules ported so far cover

     * ``Quant|BipolarQuant|QCDQ(w) -> MatMul/Gemm [-> Mul] [-> Add]`` —
       onto ``kernels.quant_matmul`` (int8, B1) / ``quant_matmul_int4``
       (packed int4, B2) with offline integer weight packing;
     * ``Quant|BipolarQuant|QCDQ(w) -> Conv [-> Relu] [-> Quant]`` with
       ``1 < group`` — depthwise onto ``kernels.quant_depthwise_conv2d``
       (B6, epilogue fused), up to ``MAX_BLOCKED_GROUPS`` groups onto
       ``kernels.quant_grouped_conv2d`` (B5);
     * every other such Conv — onto B1 / B2 through compile-time im2col
       weights and run-time patch extraction (``kernels.quant_conv2d``),
       block-diagonal for the groups the grouped rule declines;
     * activation ``Quant`` nodes and ``QuantizeLinear -> Clip ->
       DequantizeLinear`` chains — onto ``kernels.quant_dequant`` (B4);
     * everything else runs on the interpreted op registry.

  2. **Fold** the static subgraphs no rule covers once, at compile time,
     and prune the constants to what the plan reads.

  3. **Emit** a ``CompiledPlan`` whose constants (packed carriers, scales)
     live on the plan's device and whose segments run eagerly there, in
     topological order; a call enqueues its kernels on the current CUDA
     stream and returns without synchronizing.

Kernel selection is **analysis-driven** by default, as in the reference
(``repro_torch.analysis``): the range analysis proves the actual weight
values and activation ranges, so a weight tensor whose values fit int4
takes the packed path whatever its declared width, each fused matmul /
conv gets an int32 accumulator where the activations are provably
integer-valued and the dot-product bound fits 31 bits, and a segment
whose scales are dyadic runs the exact integer epilogue B3
(``lowering/requant.py``).  ``use_analysis=False`` restores the
declared-bit-width fp32-epilogue tier.  Cross-segment fusion
(``use_fusion``), tuning and meshes are not ported; their flags raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..obs.metrics import default_registry
from . import lowering
from .executor import op_output, resolve_device, to_tensor
from .graph import Node, QonnxGraph
from .lowering import LoweringContext, LoweringRule, Segment

# operand positions whose *values* the op reads on the host (shapes, axes,
# pads): such initializers stay numpy constants instead of device tensors,
# so an interpreted Reshape never waits on the device for its target
_STATIC_OPERANDS = {"Reshape": (1,), "Pad": (1, 2), "Squeeze": (1,),
                    "Unsqueeze": (1,)}


@dataclass
class CompiledPlan:
    """A partitioned QonnxGraph execution plan on one device."""
    graph: QonnxGraph
    segments: list[Segment]
    consts: dict
    device: torch.device
    analysis: Optional[object] = None      # GraphAnalysis used for selection

    def __call__(self, inputs: dict) -> dict:
        """Run the plan.  Inputs (numpy arrays or tensors) are moved to the
        plan's device; results are device tensors returned **without a
        synchronize** — on CUDA their kernels may still be in flight, which
        is what lets the serving tier enqueue every slot before one
        trailing sync."""
        env = {k: to_tensor(v, self.device) for k, v in inputs.items()}
        for t in self.graph.inputs:
            if t.name not in env:
                raise ValueError(f"missing graph input {t.name!r}")
        for seg in self.segments:
            seg.run(self.consts, env)
        # graph outputs may be compile-time constants (folded subgraphs)
        return {name: env.get(name, self.consts.get(name))
                for name in self.graph.output_names}

    # ------------------------------------------------------------- stats
    @property
    def fused_counts(self) -> dict:
        out: dict[str, int] = {}
        for s in self.segments:
            out[s.kind] = out.get(s.kind, 0) + 1
        return out

    @property
    def n_fused_nodes(self) -> int:
        return sum(len(s.nodes) for s in self.segments if s.kind != "interp")

    def interp_op_counts(self) -> dict:
        """op_type -> count over nodes left on the interpreted fallback."""
        out: dict[str, int] = {}
        for s in self.segments:
            if s.kind != "interp":
                continue
            for n in s.nodes:
                out[n.op_type] = out.get(n.op_type, 0) + 1
        return out

    def requant_stats(self) -> dict:
        """Integer-requant path telemetry over the kernel segments.

        Only matmul / conv segments count: a ``quant_dequant`` segment
        quantizes from the unbounded fp32 input domain and has no requant
        path to pick.  ``coverage`` is the integer-path fraction (1.0 when
        there are no kernel segments); ``fp32_ops_eliminated`` sums each
        int32 segment's per-call count of fp32 epilogue ops replaced by
        integer arithmetic."""
        out = {"kernel_segments": 0, "int32_segments": 0, "fp32_segments": 0,
               "fp32_ops_eliminated": 0}
        for s in self.segments:
            path = s.meta.get("requant_path")
            if path is None:
                continue
            out["kernel_segments"] += 1
            if path == "int32":
                out["int32_segments"] += 1
                out["fp32_ops_eliminated"] += s.meta.get(
                    "fp32_ops_eliminated", 0)
            else:
                out["fp32_segments"] += 1
        out["coverage"] = (out["int32_segments"] / out["kernel_segments"]
                           if out["kernel_segments"] else 1.0)
        return out

    def grouped_conv_stats(self) -> dict:
        """Grouped / depthwise lowering, summed over the segments.

        ``reclaimed_macs`` / ``carrier_bytes_saved`` — what B5 / B6 save
        against the dense block-diagonal im2col fallback (per sample);
        ``grouped_segments`` — segments on those kernels;
        ``block_diagonal_grouped`` — group > 1 convs still on the dense
        carrier (the fallback)."""
        out = {"grouped_segments": 0, "block_diagonal_grouped": 0,
               "reclaimed_macs": 0, "carrier_bytes_saved": 0}
        for s in self.segments:
            if s.kind in ("quant_conv", "quant_conv_int4") and \
                    s.meta.get("group", 1) > 1:
                out["block_diagonal_grouped"] += 1
            if s.kind.startswith(("quant_conv_grouped", "quant_conv_dw")):
                out["grouped_segments"] += 1
                out["reclaimed_macs"] += s.meta.get("reclaimed_macs", 0)
                out["carrier_bytes_saved"] += s.meta.get(
                    "carrier_bytes_saved", 0)
        return out

    def describe(self) -> str:
        head = (f"CompiledPlan({self.graph.name}) on {self.device}: "
                f"{len(self.segments)} segments over {len(self.graph.nodes)} "
                f"nodes {self.fused_counts}")
        return "\n".join([head] + ["  " + s.describe() for s in self.segments])


# --------------------------------------------------- interpreted fallback

def _make_interp_segment(nodes: list[Node], static_consts: dict) -> Segment:
    ins = sorted({i for n in nodes for i in n.inputs if i})
    outs = [o for n in nodes for o in n.outputs]

    def run(consts, env):
        for node in nodes:
            static_pos = _STATIC_OPERANDS.get(node.op_type, ())
            args = []
            for pos, i in enumerate(node.inputs):
                if not i:
                    args.append(None)
                elif pos in static_pos and i in static_consts:
                    args.append(static_consts[i])     # host value
                else:
                    args.append(env.get(i, consts.get(i)))
            for name, val in zip(node.outputs, op_output(node, args)):
                env[name] = val

    return Segment("interp", nodes, ins, outs, run)


def _unported(use_fusion, tune, mesh, interpret) -> None:
    if use_fusion:
        raise NotImplementedError(
            "use_fusion=True is not ported yet: ROADMAP.md A11 (fusion)")
    if tune != "off":
        raise NotImplementedError(
            f"tune={tune!r} is not ported yet: ROADMAP.md A15 (tuning)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: ROADMAP.md A16 (multi-device)")
    if interpret is not None:
        raise ValueError(
            "the port has no interpret mode: kernels launch on CUDA tensors "
            "and their plain twins run on CPU tensors; pass device='cpu'")


# ------------------------------------------------------------- compiler

def compile_graph(graph: QonnxGraph, *, run_cleanup: bool = True,
                  use_kernels: bool = True, use_int4: bool = True,
                  use_analysis: bool = True,
                  interpret: Optional[bool] = None,
                  use_integer_requant: bool = True, tune: str = "off",
                  tune_cache_dir: Optional[str] = None,
                  tune_repeats: int = 3,
                  use_fusion: bool = False,
                  mesh=None, device=None) -> CompiledPlan:
    """Partition ``graph`` into fused segments and emit a plan on ``device``.

    run_cleanup  — run the declarative "compile_prep" pipeline first
                   (cleanup that keeps weight-quant nodes unfolded; shape
                   inference is what lets the channelwise matchers fire)
    use_kernels  — False disables fusion entirely (pure interpreter plan)
    use_int4     — pack <=4-bit signed weights two per byte and dispatch
                   the in-kernel-unpack variant (B2)
    use_analysis — consult ``repro_torch.analysis`` (range and datatype
                   inference, on the host) for the weight carriers and the
                   accumulator dtype, from the actual value ranges; False
                   is the declared-bit-width fp32-epilogue tier
    use_integer_requant — allow the dyadic integer epilogue (B3) on the
                   segments whose exactness proof holds; False pins every
                   segment to the fp32 epilogue
    device       — where the plan runs: None means CUDA (raising without a
                   GPU); "cpu" runs every kernel's plain twin
    use_fusion   — must stay False: cross-segment fusion and its integer
                   boundary carriers are not ported (ROADMAP.md A11), so
                   the default is False here where the reference's is True
    tune (with tune_cache_dir / tune_repeats), mesh — the reference's later
                   tiers; anything but their defaults raises
                   NotImplementedError
    interpret    — must stay None (see ``_unported``)

    Every compile records its wall time and plan-shape gauges (segments
    per kind, fused nodes, integer-requant coverage and segments) in the
    process-wide ``repro_torch.obs`` default registry under
    ``model=graph.name``.
    """
    t_compile0 = time.perf_counter()
    del tune_cache_dir, tune_repeats           # meaningful only with tune
    _unported(use_fusion, tune, mesh, interpret)
    dev = resolve_device(device)
    if run_cleanup:
        from . import passes
        graph = passes.run_pipeline(graph, "compile_prep")
    g = graph.copy()
    g.nodes = g.toposort()

    ga = None
    if use_kernels and use_analysis:
        from repro_torch.analysis import analyze
        ga = analyze(g)
    ctx = LoweringContext(analysis=ga, use_int4=use_int4,
                          use_int_requant=use_integer_requant, device=dev)

    # constants start on the host: folding happens there once, and only
    # what the plan reads moves to the device
    consts: dict = {k: to_tensor(v) for k, v in g.initializers.items()}

    # pass 1 — match the registered lowering rules at their anchor nodes;
    # covered satellites (weight chains above, epilogues below) are
    # recorded so pass 2 skips them
    anchor_match: dict[int, tuple[LoweringRule, lowering.Match]] = {}
    covered: set[int] = set()
    rules_by_op: dict[str, list[LoweringRule]] = {}
    if use_kernels:
        for node in g.nodes:
            if id(node) in covered:
                continue
            if node.op_type not in rules_by_op:
                rules_by_op[node.op_type] = lowering.rules_for(node.op_type)
            for rule in rules_by_op[node.op_type]:
                m = rule.match(g, node, ctx)
                if m is None:
                    continue
                if any(id(n) in covered or id(n) in anchor_match
                       for n in m.nodes):
                    continue               # overlaps an earlier match
                anchor_match[id(node)] = (rule, m)
                covered.update(id(n) for n in m.nodes)
                break

    # pass 1.5 — compile-time folding of the *unmatched* static subgraphs
    folded: set[int] = set()
    changed = True
    while changed:
        changed = False
        for node in g.nodes:
            if id(node) in covered or id(node) in folded:
                continue
            if not all((not i) or i in consts for i in node.inputs):
                continue
            out = op_output(node, [consts[i] if i else None
                                   for i in node.inputs])
            for name, val in zip(node.outputs, out):
                consts[name] = to_tensor(val)
            folded.add(id(node))
            changed = True

    # pass 2 — emit segments in topo order; a fused segment runs at its
    # anchor's position, consecutive unfused nodes coalesce into one
    # interpreted segment
    static_consts = {
        i: consts[i].numpy()
        for node in g.nodes if node.op_type in _STATIC_OPERANDS
        for pos in _STATIC_OPERANDS[node.op_type]
        if pos < len(node.inputs) and (i := node.inputs[pos]) in consts}

    segments: list[Segment] = []
    pending_interp: list[Node] = []
    staged: dict = {}                      # kernel constants, on the device

    def flush_interp():
        if pending_interp:
            segments.append(
                _make_interp_segment(list(pending_interp), static_consts))
            pending_interp.clear()

    for node in g.nodes:
        if id(node) in anchor_match:
            flush_interp()
            rule, m = anchor_match[id(node)]
            segments.append(rule.emit(len(segments), m, staged, ctx))
        elif id(node) in covered or id(node) in folded:
            continue                  # satellite of a fused segment / folded
        else:
            pending_interp.append(node)
    flush_interp()

    # prune consts to what the plan reads: float weights whose int8/int4
    # carriers were packed offline (and fold intermediates) stay behind
    used: set[str] = set(g.output_names)
    for seg in segments:
        if seg.kind == "interp":
            for node in seg.nodes:
                static_pos = _STATIC_OPERANDS.get(node.op_type, ())
                used.update(i for pos, i in enumerate(node.inputs)
                            if i and pos not in static_pos)
        else:
            used.update(seg.inputs)
    consts = {k: v.to(dev) for k, v in consts.items() if k in used}
    consts.update(staged)

    plan = CompiledPlan(g, segments, consts, dev, analysis=ga)
    _record_compile_metrics(plan, time.perf_counter() - t_compile0)
    return plan


def _record_compile_metrics(plan: CompiledPlan, wall_s: float) -> None:
    """Compile-tier telemetry into the process-wide default registry (the
    reference's metric names)."""
    reg = default_registry()
    model = {"model": plan.graph.name}
    reg.histogram(
        "compile_wall_ms", unit="ms",
        help="compile_graph wall time (partition + analysis + plan emit)",
        window=64, labels=model).observe(wall_s * 1e3)
    reg.gauge("compile_segments",
              help="fused segments in the emitted plan, per kind",
              labels={**model, "kind": "total"}).set(len(plan.segments))
    for kind, n in plan.fused_counts.items():
        reg.gauge("compile_segments", labels={**model, "kind": kind}).set(n)
    reg.gauge("compile_fused_nodes",
              help="graph nodes absorbed into kernel segments",
              labels=model).set(plan.n_fused_nodes)
    rq = plan.requant_stats()
    reg.gauge("compile_integer_requant_coverage",
              help="fraction of kernel segments on the integer-epilogue "
                   "fast path", labels=model).set(rq["coverage"])
    reg.gauge("compile_integer_requant_segments",
              help="kernel segments proven exact on the dyadic integer "
                   "epilogue", labels=model).set(rq["int32_segments"])


__all__ = ["CompiledPlan", "compile_graph"]
