"""Zoo + toolchain example (paper §V/§VI end-to-end), on the PyTorch port:

  build CNV-w2a2 -> cleanup -> channels-last -> QCDQ lowering -> save/load,
  printing Table-III cost accounting and verifying every stage by execution.

Run:  PYTHONPATH=src python examples_torch/export_zoo.py [--device cpu]

The graph executes on ``--device`` (CUDA by default; without CUDA the
example raises rather than falling back to the CPU).  The zoo's weights
are numpy ``RandomState`` draws, the reference's, so both packages build
the same graph.  No step reaches a kernel: the executor is plain PyTorch.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.core import bops, execute, serialize, transforms
from repro_torch.core.executor import resolve_device
from repro_torch.core.formats import qonnx_to_qcdq
from repro_torch.models import zoo


def run(g, x: np.ndarray, device) -> np.ndarray:
    """The graph's one output on the host."""
    out = execute(g, {g.input_names[0]: x}, device=device)[g.output_names[0]]
    return out.detach().cpu().numpy()


def table_iii(g) -> dict:
    """Cost accounting of the raw graph.  It runs BEFORE cleanup: folding
    bakes weight Quants into the initializers, erasing the bit-width
    markers ``graph_cost`` reads.  The MACs leave out the first conv, as
    Table III does."""
    c = bops.graph_cost(transforms.infer_shapes(g))
    first_conv = next(layer for layer in c.layers if "Conv" in layer.name)
    return {"macs": c.macs - first_conv.macs, "weights": c.weights,
            "weight_bits": int(c.total_weight_bits), "bops": c.bops}


def channels_last(g, x: np.ndarray, ref: np.ndarray, device) -> dict:
    gl = transforms.to_channels_last(g)
    out = run(gl, x.transpose(0, 2, 3, 1), device)
    return {"input": gl.inputs[0].shape, "match": bool(np.allclose(ref, out, atol=1e-3))}


def qcdq(g, x: np.ndarray, ref: np.ndarray, device) -> bool:
    """The QCDQ lowering (2-bit on an 8-bit backend) agrees by execution."""
    return bool(np.allclose(ref, run(qonnx_to_qcdq(g), x, device), atol=1e-4))


def round_trip(g, x: np.ndarray, device, directory) -> dict:
    """``serialize.save`` / ``load`` under ``directory``: the file's size
    and whether the reloaded graph's output is bit-identical."""
    p = Path(directory) / "cnv_w2a2.qonnx.json"
    serialize.save(g, p)
    exact = np.array_equal(run(g, x, device), run(serialize.load(p), x, device))
    return {"bytes": p.stat().st_size, "exact": bool(exact)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="examples_torch/export_zoo.py")
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    g = zoo.ZOO["CNV-w2a2"]()
    x = np.random.RandomState(0).randn(1, 3, 32, 32).astype(np.float32)
    ref = run(g, x, dev)
    raw_nodes = len(g.nodes)
    print(f"CNV-w2a2 raw: {raw_nodes} nodes")

    cost = table_iii(g)
    print(f"Table III: MACs={cost['macs']:,} weights={cost['weights']:,} "
          f"weight-bits={cost['weight_bits']:,} BOPs(Eq.5)={cost['bops']:.3g}")

    g = transforms.cleanup(g)
    print(f"after cleanup: {len(g.nodes)} nodes (Fig. 2)")

    cl = channels_last(g, x, ref, dev)
    print(f"channels-last (Fig. 3): input {cl['input']}, match={cl['match']}")

    q_match = qcdq(g, x, ref, dev)
    print(f"QCDQ (§IV, 2-bit on an 8-bit backend): match={q_match}")

    with tempfile.TemporaryDirectory() as d:
        rt = round_trip(g, x, dev, d)
    print(f"serialize round-trip: {rt['bytes'] / 1e6:.1f} MB, exact={rt['exact']}")
    return {"raw_nodes": raw_nodes, **cost, "clean_nodes": len(g.nodes),
            "channels_last": cl, "qcdq_match": q_match, **rt, "out": ref}


if __name__ == "__main__":
    main()
