"""Quickstart: the QONNX dialect in five minutes, on the PyTorch port.

  1. the Quant / BipolarQuant / Trunc operators (Eqs. 1-4)
  2. building a quantized graph, running the node-level executor
  3. the §V cleanup transforms
  4. lowering to QCDQ / quantized-op (Table I) and back

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Every tensor lives on ``--device`` (CUDA by default; without CUDA the
example raises rather than falling back to the CPU).  No step reaches a
kernel: the operators and the executor are plain PyTorch.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (GraphBuilder, bipolar_quant, execute, quant,
                              transforms, trunc)
from repro_torch.core.executor import resolve_device
from repro_torch.core.formats import qcdq_to_qonnx, qonnx_to_qcdq


X_QUANT = (0.05, 0.0, 8)        # step 2's activation Quant: scale, zero point, bits
W_QUANT = (0.02, 0.0, 4)        # its weight Quant (narrow)


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def operators(x: torch.Tensor) -> dict:
    """Step 1 on a float32 vector ``x``: each operator's output on the host."""
    q8 = quant(x, 0.1, 0.0, 8)
    xm = torch.ones((2, 3), device=x.device) * torch.tensor([1.0, 2.0, 4.0], device=x.device)
    s = torch.tensor([0.5, 1.0, 2.0], device=x.device)
    return {
        "Quant 4b s=0.25      :": host(quant(x, 0.25, 0.0, 4)),
        "Quant 3b FLOOR       :": host(quant(x, 0.25, 0.0, 3, rounding_mode="FLOOR")),
        "Quant fractional 2.5b:": host(quant(x, 0.25, 0.0, 2.5)),
        "BipolarQuant         :": host(bipolar_quant(x, 1.0)),
        "Trunc 8b->5b         :": host(trunc(q8, 0.1, 0.0, 8, 5)),
        # channel-wise via broadcasting (§V: no explicit granularity attribute)
        "channel-wise          :": host(quant(xm, s, 0.0, 8))[0],
    }


def graph_inputs():
    """Step 2's weights (8, 4) and input (1, 8), from the reference's
    numpy seeds."""
    return (np.random.RandomState(0).randn(8, 4).astype(np.float32),
            np.random.RandomState(1).randn(1, 8).astype(np.float32))


def matmul_operands(w: np.ndarray, xv: np.ndarray):
    """The MatMul's operands as step 2's graph quantizes them, on the
    host: the 8-bit activation and the 4-bit narrow weights."""
    return (host(quant(torch.from_numpy(xv), *X_QUANT)),
            host(quant(torch.from_numpy(w), *W_QUANT, narrow=True)))


def demo_graph(w: np.ndarray):
    """Step 2's graph: an 8-bit activation Quant and 4-bit weights ``w``
    (8, 4) into a MatMul and a Relu."""
    b = GraphBuilder("demo")
    xi = b.add_input("x", (1, 8))
    h = b.quant(xi, *X_QUANT)                          # activation quant
    qw = b.quant(b.add_initializer("w", w), *W_QUANT, narrow=True)   # 4-bit weights
    (h,) = b.add_node("MatMul", [h, qw], 1)
    (h,) = b.add_node("Relu", [h], 1)
    b.mark_output(h)
    return b.build()


def run(g, xv: np.ndarray, device) -> np.ndarray:
    return host(execute(g, {"x": xv}, device=device)[g.output_names[0]])


def lowering(g, xv: np.ndarray, out: np.ndarray, device) -> dict:
    """Steps 3-4: cleanup, the QCDQ lowering checked by execution, and its
    re-ingestion."""
    qcdq = qonnx_to_qcdq(g)
    return {"cleanup": [n.op_type for n in transforms.cleanup(g).nodes],
            "qcdq": [n.op_type for n in qcdq.nodes],
            "qcdq_match": bool(np.allclose(out, run(qcdq, xv, device), atol=1e-5)),
            "reingested": [n.op_type for n in qcdq_to_qonnx(qcdq).nodes]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="examples_torch/quickstart.py")
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # -- 1. operators ------------------------------------------------------
    ops = operators(torch.linspace(-2, 2, 9, dtype=torch.float32, device=dev))
    for label, v in ops.items():
        print(label, v)

    # -- 2. a quantized graph ---------------------------------------------
    w, xv = graph_inputs()
    g = demo_graph(w)
    out = run(g, xv, dev)
    nodes = [n.op_type for n in g.nodes]
    print("\ngraph nodes          :", nodes)
    print("executor output      :", out)

    # -- 3. cleanup (Fig. 2) / 4. format lowering (Table I / §IV) ----------
    low = lowering(g, xv, out, dev)
    print("after cleanup        :", low["cleanup"], "(weight Quant folded)")
    print("QCDQ nodes           :", low["qcdq"])
    print("QCDQ == QONNX        :", low["qcdq_match"])
    print("re-ingested          :", low["reingested"])
    return {"operators": ops, "nodes": nodes, "out": out,
            "operands": matmul_operands(w, xv), **low}


if __name__ == "__main__":
    main()
