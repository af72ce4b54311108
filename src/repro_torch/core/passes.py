"""Unified pass pipeline over QonnxGraph (counterpart of ``repro.core.passes``).

Every graph-to-graph transformation is registered here as a named
``Pass``; pipelines are declarative pass lists executed by a
``PassManager`` that validates the graph after every step and records
before/after node-count stats.  A pipeline name used inside another
pipeline expands in place.

``PIPELINES`` lists every pipeline the reference has, and the registry
holds every pass they name: the cleanup and compile-prep passes, the
channels-last conversion, the FINN / hls4ml streamlining, the format
lowerings and the analysis passes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

from .graph import QonnxGraph

GraphFn = Callable[[QonnxGraph], QonnxGraph]

_PASS_REGISTRY: dict[str, "Pass"] = {}


@dataclass(frozen=True)
class Pass:
    """A named graph-to-graph rewrite with an invariant check."""
    name: str
    fn: GraphFn
    description: str = ""
    validate: bool = True      # run graph.validate() on this pass's output

    def __call__(self, graph: QonnxGraph) -> QonnxGraph:
        out = self.fn(graph)
        if self.validate:
            out.validate()
        return out


def register_pass(name: str, fn: GraphFn = None, *, description: str = "",
                  validate: bool = True):
    """Register ``fn`` under ``name``; usable directly or as a decorator."""
    def _register(f: GraphFn) -> GraphFn:
        if name in _PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        _PASS_REGISTRY[name] = Pass(
            name, f, description or (f.__doc__ or "").strip().split("\n")[0],
            validate)
        return f
    if fn is not None:
        return _register(fn)
    return _register


def get_pass(name: str) -> Pass:
    _ensure_registered()
    if name not in _PASS_REGISTRY:
        known = sorted(set(_PASS_REGISTRY) | set(PIPELINES))
        raise KeyError(f"unknown pass {name!r}; known: {known}")
    return _PASS_REGISTRY[name]


def available_passes() -> list[str]:
    _ensure_registered()
    return sorted(_PASS_REGISTRY)


@dataclass
class PassStats:
    name: str
    nodes_before: int
    nodes_after: int
    wall_ms: float


@dataclass
class PassManager:
    """Runs an ordered list of passes, validating and recording stats."""
    passes: Sequence[Pass]
    stats: list[PassStats] = field(default_factory=list)

    @staticmethod
    def from_names(names: Sequence[str]) -> "PassManager":
        """Resolve names (pass names or pipeline names, which expand
        recursively) into a concrete PassManager."""
        _ensure_registered()
        return PassManager([get_pass(n) for n in _expand(names)])

    def __call__(self, graph: QonnxGraph) -> QonnxGraph:
        self.stats = []
        g = graph
        for p in self.passes:
            n_before = len(g.nodes)
            t0 = time.perf_counter()
            g = p(g)
            self.stats.append(PassStats(
                p.name, n_before, len(g.nodes),
                (time.perf_counter() - t0) * 1e3))
        return g

    def summary(self) -> str:
        lines = [f"{s.name:28s} {s.nodes_before:5d} -> {s.nodes_after:5d} "
                 f"nodes  {s.wall_ms:8.2f} ms" for s in self.stats]
        return "\n".join(lines)


def _expand(names: Sequence[str]) -> list[str]:
    out: list[str] = []
    for n in names:
        if n in PIPELINES and n not in _PASS_REGISTRY:
            out.extend(_expand(PIPELINES[n]))
        else:
            out.append(n)
    return out


# ------------------------------------------------------------- pipelines

PIPELINES: dict[str, list[str]] = {
    "cleanup": ["fold_constants", "remove_identity",
                "collapse_reshape_chains", "infer_shapes"],
    # like cleanup but keeps weight-quantization nodes unfolded so the
    # compiled executor can lower Quant(w) -> MatMul onto integer kernels
    "compile_prep": ["fold_constants_keep_quant", "remove_identity",
                     "collapse_reshape_chains", "infer_shapes"],
    "streamline_for_finn": ["cleanup", "quant_to_multithreshold"],
    "streamline_for_hls4ml": ["cleanup", "qonnx_to_qcdq",
                              "propagate_dequant"],
    "lower_to_qcdq": ["cleanup", "qonnx_to_qcdq"],
    "lower_to_quantized_op": ["cleanup", "qonnx_to_quantized_op"],
    "ingest_qcdq": ["qcdq_to_qonnx", "cleanup"],
    "channels_last": ["cleanup", "to_channels_last"],
    "analyze": ["validate_quantization", "infer_shapes", "infer_datatypes"],
}


def run_pipeline(graph: QonnxGraph, name: str) -> QonnxGraph:
    """Run a named pipeline (or a single named pass) over ``graph``."""
    _ensure_registered()
    if name in PIPELINES:
        return PassManager.from_names(PIPELINES[name])(graph)
    return get_pass(name)(graph)


# convenience entry points (the reference's names for the hand-chained
# call sites)
def cleanup(graph: QonnxGraph) -> QonnxGraph:
    return run_pipeline(graph, "cleanup")


def streamline_for_finn(graph: QonnxGraph) -> QonnxGraph:
    return run_pipeline(graph, "streamline_for_finn")


def streamline_for_hls4ml(graph: QonnxGraph) -> QonnxGraph:
    return run_pipeline(graph, "streamline_for_hls4ml")


def lower_to_qcdq(graph: QonnxGraph) -> QonnxGraph:
    return run_pipeline(graph, "lower_to_qcdq")


def lower_to_quantized_op(graph: QonnxGraph) -> QonnxGraph:
    return run_pipeline(graph, "lower_to_quantized_op")


# ---------------------------------------------------------- registration

_REGISTERED = False


def _ensure_registered() -> None:
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    from . import formats, streamline, transforms

    register_pass("infer_shapes", transforms.infer_shapes,
                  description="attach shapes/dtypes to every tensor")
    register_pass("fold_constants", transforms.fold_constants,
                  description="evaluate all-static nodes into initializers")
    register_pass(
        "fold_constants_keep_quant",
        lambda g: transforms.fold_constants(g, keep_quant=True),
        description="constant folding that preserves quantization nodes")
    register_pass("remove_identity", transforms.remove_identity,
                  description="drop Identity / no-op Cast nodes")
    register_pass("collapse_reshape_chains", transforms.collapse_reshape_chains,
                  description="Fig. 2: static-shape Reshape cleanup")
    register_pass("eliminate_dead_code", transforms.eliminate_dead_code,
                  description="drop nodes/initializers not reaching outputs")
    register_pass("to_channels_last", transforms.to_channels_last,
                  description="Fig. 3: NCHW -> NHWC with wrapper attributes")
    register_pass("propagate_dequant", streamline.propagate_dequant,
                  description="hls4ml §VI-C: push DQ below linear ops")
    register_pass("quant_to_multithreshold", streamline.quant_to_multithreshold,
                  description="FINN §VI-D: activation Quant -> MultiThreshold")
    register_pass("qonnx_to_qcdq", formats.qonnx_to_qcdq,
                  description="lower Quant to QuantizeLinear/Clip/Dequantize")
    register_pass("qcdq_to_qonnx", formats.qcdq_to_qonnx,
                  description="fuse Q(C)DQ triples back into Quant (ingest)")
    register_pass("qonnx_to_quantized_op", formats.qonnx_to_quantized_op,
                  description="lower to MatMulInteger quantized-op style")

    # analysis-tier passes, imported lazily: analysis depends on core,
    # never the other way at module level
    from repro_torch.analysis import check_graph, infer_datatypes

    register_pass("infer_datatypes", infer_datatypes,
                  description="annotate tensors with QONNX datatypes "
                              "(INT<N>/UINT<N>/BIPOLAR/FLOAT32)")
    register_pass("validate_quantization", check_graph,
                  description="reject quantization-inconsistent graphs "
                              "with actionable errors")
