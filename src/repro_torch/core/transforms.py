"""Graph transformations behind the ``cleanup`` / ``compile_prep`` pipelines.

Counterpart of the matching part of ``repro.core.transforms``:

  * ``infer_shapes``      — shape inference for intermediate tensors
  * ``fold_constants``    — constant folding (static subgraphs -> initializers)
  * ``remove_identity``   — drop Identity / no-op Cast nodes
  * ``collapse_reshape_chains`` — the Fig. 2 cleanup: Shape/Gather/Unsqueeze/
                            Concat feeding a Reshape collapses to a static
                            Reshape once shapes are known
  * ``eliminate_dead_code``
  * ``cleanup``           — the standard pipeline (shapes + folding + tidy)

The channels-last conversion is not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from .executor import dtype_name, op_output, run_nodes, to_tensor
from .graph import QonnxGraph, TensorInfo


# ---------------------------------------------------------------- shapes

def _concrete_shape(shape):
    """Symbolic dims (None / strings, e.g. a batch axis) trace as 1."""
    return tuple(1 if d is None or isinstance(d, str) else int(d)
                 for d in shape)


def _meta_env(g: QonnxGraph) -> dict:
    """Inputs and floating-point initializers as ``meta`` tensors (shape
    and dtype, no data); integer initializers stay concrete on the host,
    because they feed shape computations (Reshape targets, Gather
    indices) whose values the ops read."""
    env = {}
    for k, v in g.initializers.items():
        t = to_tensor(v)
        env[k] = t.to("meta") if t.is_floating_point() else t
    for t in g.inputs:
        env[t.name] = torch.empty(_concrete_shape(t.shape),
                                  dtype=to_tensor(np.zeros(0, t.dtype)).dtype,
                                  device="meta")
    return env


def infer_shapes(graph: QonnxGraph) -> QonnxGraph:
    """Attach shapes/dtypes to every intermediate tensor.

    Runs the node-level executor on the ``meta`` device, so every op's
    shape logic is inherited from its PyTorch implementation.  Where an op
    needs the values of a tensor that has none there (a data-dependent
    reshape, Fig. 1, or a value read from a float constant), the pass
    falls back to running the graph on concrete zero inputs on the CPU, as
    the reference falls back from ``jax.eval_shape``.  Graph inputs may
    carry a symbolic leading (batch) dimension, traced as 1: the recorded
    value_info shapes are batch-1-concrete while the declared input keeps
    its symbolic entry.
    """
    g = graph.copy()
    try:
        env = run_nodes(g, _meta_env(g), return_all=True)
    except (RuntimeError, NotImplementedError, TypeError, ValueError):
        env = {k: to_tensor(v) for k, v in g.initializers.items()}
        env.update({t.name: torch.zeros(
            _concrete_shape(t.shape),
            dtype=to_tensor(np.zeros(0, t.dtype)).dtype) for t in g.inputs})
        env = run_nodes(g, env, return_all=True)
    for name, val in env.items():
        g.value_info[name] = TensorInfo(name, tuple(val.shape),
                                        dtype_name(val))
    for t in g.outputs:
        if t.name in g.value_info:
            t.shape = g.value_info[t.name].shape
            t.dtype = g.value_info[t.name].dtype
    return g


# ---------------------------------------------------------------- folding

def fold_constants(graph: QonnxGraph, keep_quant: bool = False) -> QonnxGraph:
    """Evaluate nodes whose inputs are all initializers; store results.

    ``keep_quant=True`` leaves Quant/BipolarQuant/Trunc nodes (and QCDQ
    links) in the graph even when foldable — the compiled executor needs
    the weight-quantization structure intact to lower ``Quant(w) ->
    MatMul`` segments onto the integer-weight kernels."""
    g = graph.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            # Shape of a tensor with statically-known shape folds regardless
            # of whether the data itself is constant
            if node.op_type == "Shape" and node.inputs[0] not in g.initializers:
                sh = g.get_shape(node.inputs[0])
                if sh is not None:
                    g.initializers[node.outputs[0]] = np.asarray(sh, np.int64)
                    g.remove_node(node)
                    changed = True
                continue
            static = all((i == "" or i in g.initializers) for i in node.inputs)
            if not static:
                continue
            if node.op_type in ("Quant", "BipolarQuant", "Trunc") and \
                    (keep_quant or node.inputs[0] not in g.initializers):
                continue
            if keep_quant and node.op_type in ("QuantizeLinear",
                                               "DequantizeLinear", "Clip"):
                continue
            out = op_output(node, [to_tensor(g.initializers[i]) if i else None
                                   for i in node.inputs])
            for name, val in zip(node.outputs, out):
                g.initializers[name] = val.numpy()
            g.remove_node(node)
            changed = True
    return g


def remove_identity(graph: QonnxGraph) -> QonnxGraph:
    g = graph.copy()
    for node in list(g.nodes):
        is_id = node.op_type == "Identity"
        if node.op_type == "Cast":
            src = g.value_info.get(node.inputs[0])
            if src is not None and src.dtype == str(np.dtype(node.attrs.get("to", "float32"))):
                is_id = True
        if not is_id:
            continue
        src, dst = node.inputs[0], node.outputs[0]
        if dst in g.output_names and src in g.input_names:
            continue  # degenerate passthrough graph; keep the node
        g.remove_node(node)
        if dst in g.output_names and src in g.initializers:
            # a graph output produced directly by an initializer is not
            # valid; re-add the Identity in this corner case
            g.nodes.append(node)
            continue
        g.replace_tensor(dst, src)
    return g


def collapse_reshape_chains(graph: QonnxGraph) -> QonnxGraph:
    """Fig. 2 cleanup: once shapes are known, a Reshape whose target-shape
    operand is computed by a Shape/Gather/Unsqueeze/Concat subgraph collapses
    to a Reshape with a constant shape initializer."""
    g = infer_shapes(graph)
    for node in list(g.nodes):
        if node.op_type != "Reshape" or len(node.inputs) < 2:
            continue
        if node.inputs[1] in g.initializers:
            continue
        out_shape = g.get_shape(node.outputs[0])
        if out_shape is None:
            continue
        shape_name = g.fresh_name(f"{node.name}_static_shape")
        g.initializers[shape_name] = np.asarray(out_shape, np.int64)
        node.inputs[1] = shape_name
    # dead-code-eliminate the now-unused shape-computation chain
    return eliminate_dead_code(g)


def eliminate_dead_code(graph: QonnxGraph) -> QonnxGraph:
    g = graph.copy()
    # 1. propagate liveness to fixpoint (graph outputs are the roots)
    live = set(g.output_names)
    changed = True
    while changed:
        changed = False
        for node in g.nodes:
            if any(o in live for o in node.outputs):
                new = {i for i in node.inputs if i} - live
                if new:
                    live |= new
                    changed = True
    # 2. drop dead nodes and initializers
    g.nodes = [n for n in g.nodes if any(o in live for o in n.outputs)]
    g.initializers = {k: v for k, v in g.initializers.items() if k in live}
    return g


def cleanup(graph: QonnxGraph) -> QonnxGraph:
    """The standard pipeline run "before any more involved transformations"
    (paper §V): shape inference + constant folding + tidying — the
    "cleanup" pass list of ``passes.PIPELINES``."""
    from . import passes
    return passes.run_pipeline(graph, "cleanup")
