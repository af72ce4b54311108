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
  * ``to_channels_last``  — NCHW -> NHWC conversion (Fig. 3), setting
                            ``data_layout`` wrapper attributes on
                            shape-dependent ops so the executor stays correct
"""
from __future__ import annotations

import numpy as np
import torch

from .executor import dtype_name, op_output, run_nodes, to_tensor
from .graph import Node, QonnxGraph, TensorInfo

_LAYOUT_OPS = {"Conv", "BatchNormalization", "MaxPool", "AveragePool",
               "GlobalAveragePool", "MultiThreshold"}
# elementwise ops are layout-agnostic as long as their non-x inputs broadcast
_ELEMENTWISE = {"Add", "Sub", "Mul", "Div", "Relu", "Sigmoid", "Tanh", "Erf",
                "Clip", "Identity", "Quant", "BipolarQuant", "Trunc",
                "QuantizeLinear", "DequantizeLinear", "Cast", "Pow"}


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


# ---------------------------------------------------------------- layout

def _nchw_to_nhwc_perm(ndim: int):
    return (0,) + tuple(range(2, ndim)) + (1,)


def _nhwc_to_nchw_perm(ndim: int):
    return (0, ndim - 1) + tuple(range(1, ndim - 1))


def to_channels_last(graph: QonnxGraph) -> QonnxGraph:
    """Convert a (shape-inferred) NCHW graph to channels-last execution.

    Strategy (mirrors qonnx's ChannelsLast transform): insert Transpose pairs
    around every layout-sensitive op, tag it with ``data_layout = NHWC``, then
    cancel adjacent inverse Transposes and sink transposes through
    elementwise ops.  4D graph inputs are converted to NHWC directly.
    """
    g = infer_shapes(graph)

    # 1. wrap every layout op: x -> [ToNHWC] -> op(NHWC) -> [ToNCHW] -> y
    for node in list(g.nodes):
        if node.op_type not in _LAYOUT_OPS:
            continue
        x_name = node.inputs[0]
        x_shape = g.get_shape(x_name)
        if x_shape is None or len(x_shape) < 3:
            continue
        nd = len(x_shape)
        pre = g.fresh_name(f"{node.name}_nhwc_in")
        post = g.fresh_name(f"{node.name}_nchw_out")
        y_name = node.outputs[0]
        g.nodes.insert(
            g.nodes.index(node),
            Node("Transpose", [x_name], [pre],
                 {"perm": list(_nchw_to_nhwc_perm(nd))}, name=g.fresh_name("t_in")))
        node.inputs[0] = pre
        node.attrs["data_layout"] = "NHWC"
        node.outputs[0] = post
        g.nodes.insert(
            g.nodes.index(node) + 1,
            Node("Transpose", [post], [y_name],
                 {"perm": list(_nhwc_to_nchw_perm(nd))}, name=g.fresh_name("t_out")))

    # 2. cancel Transpose pairs, sink ToNCHW transposes down and hoist ToNHWC
    #    transposes up through elementwise ops, until fixpoint
    changed = True
    while changed:
        changed = (_cancel_transpose_pairs(g) or
                   _sink_transpose_elementwise(g) or
                   _hoist_transpose_elementwise(g))

    # 3. convert graph inputs that are consumed *only* by a ToNHWC transpose
    for t in g.inputs:
        if t.shape is None or len(t.shape) < 3:
            continue
        cons = g.consumers(t.name)
        nd = len(t.shape)
        if cons and all(c.op_type == "Transpose" and
                        tuple(c.attrs.get("perm", ())) == _nchw_to_nhwc_perm(nd)
                        for c in cons):
            t.shape = tuple(np.asarray(t.shape)[list(_nchw_to_nhwc_perm(nd))])
            for c in cons:
                out = c.outputs[0]
                g.remove_node(c)
                g.replace_tensor(out, t.name)
            changed = True
    g = eliminate_dead_code(g)
    return infer_shapes(g)


def _cancel_transpose_pairs(g: QonnxGraph) -> bool:
    changed = False
    for node in list(g.nodes):
        if node.op_type != "Transpose":
            continue
        nxt = g.consumers(node.outputs[0])
        if len(nxt) != 1 or nxt[0].op_type != "Transpose":
            continue
        a = node.attrs.get("perm")
        b = nxt[0].attrs.get("perm")
        if a is None or b is None:
            continue
        composed = [a[i] for i in b]
        if composed == list(range(len(composed))) and \
                node.outputs[0] not in g.output_names:
            dst = nxt[0].outputs[0]
            src = node.inputs[0]
            g.remove_node(node)
            g.remove_node(nxt[0])
            g.replace_tensor(dst, src)
            changed = True
    return changed


def _hoist_transpose_elementwise(g: QonnxGraph) -> bool:
    """Move a Transpose above a preceding elementwise op: T(ew(x, c)) ->
    ew(T(x), c') — used to float ToNHWC transposes up to the graph input."""
    changed = False
    for t_node in list(g.nodes):
        if t_node.op_type != "Transpose":
            continue
        ew = g.producer(t_node.inputs[0])
        if ew is None or ew.op_type not in _ELEMENTWISE:
            continue
        if len(g.consumers(ew.outputs[0])) != 1:
            continue  # ew output used elsewhere; hoisting would duplicate work
        if ew.outputs[0] in g.output_names:
            continue
        perm = t_node.attrs.get("perm")
        # only hoist ToNHWC transposes (toward the graph input)
        if perm is None or tuple(perm) != _nchw_to_nhwc_perm(len(perm)):
            continue
        ok = True
        for extra in ew.inputs[1:]:
            if extra and extra not in g.initializers:
                ok = False
                break
            if extra:
                v = g.initializers[extra]
                if v.ndim > 1 and v.size != 1 and v.ndim != len(perm):
                    ok = False
                    break
        if not ok:
            continue
        for k, extra in enumerate(ew.inputs[1:], start=1):
            if extra:
                v = g.initializers[extra]
                if v.ndim == len(perm) and v.size != 1:
                    name = g.fresh_name(extra + "_perm")
                    g.initializers[name] = np.transpose(v, perm)
                    ew.inputs[k] = name
        # rewire: x -> T -> ew -> (old consumers of T's output)
        x_src = ew.inputs[0]
        t_out = t_node.outputs[0]
        t_node.inputs[0] = x_src
        new_t_out = g.fresh_name(f"{t_node.name}_hoisted")
        t_node.outputs[0] = new_t_out
        ew.inputs[0] = new_t_out
        ew_old_out = ew.outputs[0]
        ew.outputs[0] = t_out
        g.value_info.pop(ew_old_out, None)
        g.value_info.pop(t_out, None)
        if "data_layout" in ew.attrs:
            ew.attrs["data_layout"] = "NHWC"
        # keep node list in topological-friendly order
        g.nodes.remove(t_node)
        g.nodes.insert(g.nodes.index(ew), t_node)
        changed = True
    return changed


def _sink_transpose_elementwise(g: QonnxGraph) -> bool:
    """Move ToNCHW transposes below elementwise ops: T(x) op c -> T(x op c')."""
    changed = False
    for node in list(g.nodes):
        if node.op_type != "Transpose":
            continue
        cons = g.consumers(node.outputs[0])
        if len(cons) != 1 or cons[0].op_type not in _ELEMENTWISE:
            continue
        ew = cons[0]
        if ew.inputs[0] != node.outputs[0]:
            continue
        perm = node.attrs.get("perm")
        # only sink ToNCHW transposes (toward the graph output)
        if perm is None or tuple(perm) != _nhwc_to_nchw_perm(len(perm)):
            continue
        # other inputs must be initializers broadcastable after permuting
        ok = True
        for extra in ew.inputs[1:]:
            if extra and extra not in g.initializers:
                ok = False
                break
            if extra:
                v = g.initializers[extra]
                if v.ndim > 1 and v.size != 1 and v.ndim != len(perm):
                    ok = False
                    break
        if not ok:
            continue
        inv = np.argsort(perm).tolist()
        for k, extra in enumerate(ew.inputs[1:], start=1):
            if extra:
                v = g.initializers[extra]
                if v.ndim == len(perm) and v.size != 1:
                    name = g.fresh_name(extra + "_perm")
                    g.initializers[name] = np.transpose(v, inv)
                    ew.inputs[k] = name
        # rewire: x -> ew' -> transpose -> old consumers of ew
        x_src = node.inputs[0]
        t_out = node.outputs[0]
        ew_out = ew.outputs[0]
        ew.inputs[0] = x_src
        node.inputs[0] = ew_out
        # transpose now produces what ew used to produce
        new_mid = g.fresh_name(f"{ew.name}_pre_t")
        # ew_out keeps its name as ew's output; transpose output becomes the
        # tensor old consumers read.  Swap names carefully:
        node.outputs[0] = g.fresh_name(f"{node.name}_sunk")
        for c in g.consumers(ew_out):
            if c is not node:
                c.inputs = [node.outputs[0] if i == ew_out else i for i in c.inputs]
        for t in g.outputs:
            if t.name == ew_out:
                t.name = node.outputs[0]
        del new_mid, t_out
        # reorder node list so toposort-stability of .nodes is preserved
        g.nodes.remove(node)
        g.nodes.insert(g.nodes.index(ew) + 1, node)
        if "data_layout" in ew.attrs:
            ew.attrs["data_layout"] = "NHWC"
        changed = True
    return changed
