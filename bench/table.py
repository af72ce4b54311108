"""The grammar of a configuration's layer table, read in one place.

A table (``"layers"`` of ``bench/configs/<name>.json``) is a list of
layers run in order; each reads one tensor and writes one.  Without the
keys below it is a chain: every layer reads the previous layer's output
and the first reads the image.  The keys that make it a graph:

- ``"as": "<name>"`` on any layer keeps its output under that name;
- ``"in": "<name>"`` on any layer makes it read that tensor instead of
  the previous layer's output; the image is ``"input"``;
- ``{"op": "add", "with": "<name>"}`` is an ONNX ``Add`` of the tensor it
  reads and the named one, both computed, of equal shape;
- ``maxpool`` takes an optional symmetric ``"pad"`` (ONNX ``pads``,
  padded with -inf), as ``conv`` takes its ``"pad"``.

A name is defined before it is read, once, and is never ``"input"``.  The
table's result is its last layer's output.  The other ops and their keys:
``quant`` (``bits``, ``scale``, ``signed``), ``bipolar`` (``scale``),
``conv`` (``cin``, ``cout``, ``k``, ``stride``, ``pad``, ``group``,
``w_bits``, ``w_std``), ``matmul`` (``cin``, ``cout``, ``w_bits``,
``w_std``), ``relu``, ``maxpool`` (``k``, ``stride``), ``gap``,
``flatten``.  A ``conv`` or ``matmul`` with ``w_bits`` 1 has
``BipolarQuant`` weights.

``walk`` checks a table against an image shape and gives each layer the
tensors it reads and the shapes of one image, (C, H, W) or (K,), so the
graph the program serves (``bench/model.py``), the reference's forward
pass (``bench/reference/``) and the counts (``bench/counts.py``) read the
table alike.  It imports neither torch nor anything of the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

INPUT = "input"
OPS = ("quant", "bipolar", "conv", "matmul", "relu", "maxpool", "gap",
       "flatten", "add")


@dataclass(frozen=True)
class Step:
    """One layer of a walked table: it reads the tensor named ``src``, or
    the previous layer's output where ``src`` is None, and for ``add`` also
    ``other``; it keeps its output under ``out`` where that is a name.
    Shapes are of one image."""
    layer: dict
    src: Optional[str]
    other: Optional[str]
    shape_in: tuple
    shape_out: tuple
    out: Optional[str]


def _fail(i: int, layer: dict, why: str):
    raise ValueError(f"layer {i} ({layer.get('op')!r}): {why}")


def _out_shape(i: int, layer: dict, shape: tuple) -> tuple:
    op = layer["op"]
    if op in ("conv", "maxpool"):
        if len(shape) != 3:
            _fail(i, layer, f"reads shape {shape}, not (C, H, W)")
        c, h, w = shape
        if op == "conv" and c != layer["cin"]:
            _fail(i, layer, f"cin {layer['cin']} but reads {c} channels")
        k, s = layer["k"], layer["stride"]
        p = layer.get("pad", 0)
        c = layer["cout"] if op == "conv" else c
        return (c, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1)
    if op == "gap":
        return (shape[0], 1, 1)
    if op == "flatten":
        return (math.prod(shape),)
    if op == "matmul":
        if shape != (layer["cin"],):
            _fail(i, layer, f"cin {layer['cin']} but reads shape {shape}")
        return (layer["cout"],)
    return shape


def walk(layers: list, image_shape) -> list:
    """The table's ``Step``s in order; raises ``ValueError`` naming the
    layer for an unknown op, a name read before it is defined or defined
    twice, an ``add`` of unequal shapes, or a width that does not match
    the tensor read."""
    shapes = {INPUT: tuple(image_shape)}
    prev_shape, steps = shapes[INPUT], []
    for i, layer in enumerate(layers):
        if layer.get("op") not in OPS:
            _fail(i, layer, "unknown op")
        for key in ("in", "as", "with"):
            if key in layer and not isinstance(layer[key], str):
                _fail(i, layer, f"{key!r} is not a name")
        src = layer.get("in", None if steps else INPUT)
        if src is not None and src not in shapes:
            _fail(i, layer, f"reads {src!r}, which no earlier layer defines")
        shape_in = prev_shape if src is None else shapes[src]
        other = layer.get("with") if layer["op"] == "add" else None
        if layer["op"] == "add":
            if other not in shapes:
                _fail(i, layer, f"adds {other!r}, which no earlier layer "
                      "defines")
            if shapes[other] != shape_in:
                _fail(i, layer, f"adds shape {shapes[other]} to {shape_in}")
        out = layer.get("as")
        if out in shapes:
            _fail(i, layer, f"defines {out!r} again")
        prev_shape = _out_shape(i, layer, shape_in)
        steps.append(Step(layer, src, other, shape_in, prev_shape, out))
        if out is not None:
            shapes[out] = prev_shape
    return steps
