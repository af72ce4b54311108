"""Backend streamlining passes (paper §VI-C/D).

Counterpart of ``repro.core.streamline`` (numpy over the port's
``QonnxGraph``; the integer bounds come from ``formats`` as Python
numbers).

hls4ml (§VI-C): "the dequantization nodes need to be propagated down across
linear operators, like matrix multiplications and convolutions, so that they
can then be done efficiently using quantized values.  The dequantization
nodes can be combined with other scalings and shifts, but they may not pass
nonlinear activations or quantized nodes."

FINN (§VI-D): "all Quant nodes in the activation path are converted to
MultiThreshold nodes", expressing an arbitrarily-quantized monotone
activation as a multistep function.

Implemented here:

  * ``propagate_dequant``  — hoist DequantizeLinear below MatMul/Conv/Add/
                             Mul so the linear op consumes integer values;
                             adjacent scale Muls fold together.
                             Numerics caveat: (a @ w) * s and (a * s) @ w
                             differ in the last float ulp, which can flip a
                             downstream round() at exact .5 ties — the same
                             measure-zero boundary FINN/hls4ml accept when
                             they re-order scales (§VI-C).
  * ``quant_to_multithreshold`` — replace [Relu ->] Quant activations with
                             a FINN-style MultiThreshold node (exact for
                             monotone activations; identity and ReLU
                             supported, per FINN's restriction).
"""
from __future__ import annotations

import numpy as np

from .formats import max_int, min_int
from .graph import FINN_DOMAIN, Node, QonnxGraph


# ------------------------------------------------------- dequant propagation

def propagate_dequant(graph: QonnxGraph) -> QonnxGraph:
    """Push DequantizeLinear through MatMul so the matmul runs on integers.

    Pattern:  DQ(x_int, s, zp=0) -> MatMul(., W)   becomes
              MatMul(x_int, W) -> Mul(., s)
    (zero-point must be 0 — symmetric — and s per-tensor or per-row-
    broadcastable; the paper's weights convention guarantees this.)
    """
    g = graph.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op_type != "MatMul":
                continue
            prod = g.producer(node.inputs[0])
            if prod is None or prod.op_type != "DequantizeLinear":
                continue
            s_name = prod.inputs[1]
            zp_name = prod.inputs[2] if len(prod.inputs) > 2 else None
            if s_name not in g.initializers:
                continue
            s = g.initializers[s_name]
            if zp_name is not None and zp_name in g.initializers and \
                    np.any(g.initializers[zp_name] != 0):
                continue            # asymmetric: cannot commute through dot
            if s.size != 1:
                continue            # per-channel on the contraction dim: no
            if len(g.consumers(prod.outputs[0])) != 1:
                continue
            # rewire: matmul reads the integer tensor; scale moves below
            x_int = prod.inputs[0]
            mm_out = node.outputs[0]
            node.inputs[0] = x_int
            new_out = g.fresh_name(f"{node.name}_int_out")
            node.outputs[0] = new_out
            scale_f = g.fresh_name(s_name + "_f")
            g.initializers[scale_f] = np.asarray(s, np.float32)
            g.nodes.insert(g.nodes.index(node) + 1,
                           Node("Mul", [new_out, scale_f], [mm_out],
                                name=g.fresh_name(f"{node.name}_descale")))
            g.remove_node(prod)
            changed = True
    g = _fold_adjacent_muls(g)
    g.validate()
    return g


def _fold_adjacent_muls(g: QonnxGraph) -> QonnxGraph:
    """Mul(Mul(x, a), b) -> Mul(x, a*b) for constant a, b."""
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op_type != "Mul" or node.inputs[1] not in g.initializers:
                continue
            nxt = g.consumers(node.outputs[0])
            if len(nxt) != 1 or nxt[0].op_type != "Mul":
                continue
            if nxt[0].inputs[1] not in g.initializers:
                continue
            if node.outputs[0] in g.output_names:
                continue
            a = g.initializers[node.inputs[1]]
            b = g.initializers[nxt[0].inputs[1]]
            name = g.fresh_name("fused_scale")
            g.initializers[name] = np.asarray(a * b, np.float32)
            nxt[0].inputs = [node.inputs[0], name]
            g.remove_node(node)
            changed = True
    return g


# ------------------------------------------------- Quant -> MultiThreshold

_SUPPORTED_ACTS = ("Relu", None)    # identity or ReLU (FINN §VI-D list)


def quant_to_multithreshold(graph: QonnxGraph) -> QonnxGraph:
    """Convert activation-path [Relu ->] Quant into a MultiThreshold node.

    For a monotone activation f and uniform quantization q(.) with scale s,
    zero-point 0, levels [lo, hi]:  q(f(x)) == s * (lo + sum_i [x >= T_i])
    with thresholds T_i = f^{-1}(s * (lo + i - 0.5)) for i = 1..(hi - lo).
    Raises on unsupported (non-monotone) activations — mirroring FINN:
    "if an incompatible network architecture is discovered during ingestion
    an error will be raised".
    """
    g = graph.copy()
    for node in list(g.nodes):
        if node.op_type != "Quant":
            continue
        x_name = node.inputs[0]
        if x_name in g.initializers:
            continue                # weight quant — not the activation path
        prod = g.producer(x_name)
        act = None
        if prod is not None and prod.op_type not in ("MatMul", "Conv", "Add",
                                                     "Mul", "Gemm"):
            if prod.op_type not in ("Relu",):
                raise ValueError(
                    f"FINN ingestion: unsupported activation "
                    f"{prod.op_type!r} before Quant (only ReLU/hardtanh/"
                    f"identity are supported, paper §VI-D)")
            act = prod
        sc = g.initializers.get(node.inputs[1])
        zp = g.initializers.get(node.inputs[2])
        bw = g.initializers.get(node.inputs[3])
        if sc is None or zp is None or bw is None or sc.size != 1 or \
                np.any(zp != 0):
            continue                # dynamic/asymmetric: leave as Quant
        s = float(np.asarray(sc).reshape(()))
        nb = float(np.asarray(bw).reshape(()))
        signed = bool(node.attrs.get("signed", 1))
        narrow = bool(node.attrs.get("narrow", 0))
        lo = int(np.ceil(float(min_int(signed, narrow, nb))))
        hi = int(np.floor(float(max_int(signed, narrow, nb))))
        if act is not None and lo < 0:
            lo = 0                  # ReLU clamps the negative levels anyway
        n_steps = hi - lo
        if n_steps <= 0 or n_steps > 4096:
            continue
        # Thresholds where round(x/s) crosses each integer level.  The
        # executor realizes a level with ``x >= T`` (half-up at the
        # boundary), but Quant's default ROUND mode is half-even: at an
        # exact tie x == s*(k + 0.5) the value stays at k when k+1 is odd.
        # With power-of-two / dyadic scales those ties are hit exactly, so
        # encode the strict ``>`` needed for odd target levels by nudging
        # the threshold up one float32 ulp — exact for every representable
        # input.  Non-ROUND modes keep the plain half-up thresholds (they
        # only ever disagree on the same measure-zero boundary).
        mode = node.attrs.get("rounding_mode", "ROUND")
        thr = np.empty((1, n_steps), np.float32)
        for i in range(n_steps):
            t = np.float32(s * (lo + i + 0.5))
            if mode == "ROUND" and (lo + i + 1) % 2 != 0:
                t = np.nextafter(t, np.float32(np.inf), dtype=np.float32)
            thr[0, i] = t
        t_name = g.fresh_name(f"{node.name}_thresholds")
        g.initializers[t_name] = thr
        src = act.inputs[0] if act is not None else x_name
        mt = Node("MultiThreshold", [src, t_name], [node.outputs[0]],
                  {"out_scale": s, "out_bias": float(lo) * s},
                  name=g.fresh_name(f"{node.name}_mt"), domain=FINN_DOMAIN)
        idx = g.nodes.index(node)
        g.remove_node(node)
        g.nodes.insert(idx, mt)
        if act is not None and not g.consumers(act.outputs[0]):
            g.remove_node(act)
    g.validate()
    return g
