"""A configuration's forward pass, run layer by layer from its layer table.

``forward(layers, params, x)`` takes the table of a configuration file
(``bench/configs/*.json``), the float weights and weight scales the
benchmark drew for it (one entry per weighted layer, in order) and float32
images, and returns the logits.  It quantizes the weights itself and
computes in ``dtype``: float64 for the reference, bfloat16 for its control.
The table is a chain or a graph (named tensors, ``add``), read by
``bench/table.py`` and run in table order.

A configuration names its reference file (its ``"reference"`` key); a
file under ``bench/reference/`` with these two functions' signatures.
"""
from __future__ import annotations

import torch

from . import ops
from .. import table


def _weight(layer: dict, p: dict, dtype, device) -> torch.Tensor:
    w = torch.as_tensor(p["w"]).to(device=device, dtype=dtype)
    if layer["w_bits"] == 1:
        return ops.bipolar_quant(w, p["scale"])
    return ops.quant(w, p["scale"], 0.0, layer["w_bits"], signed=True,
                     narrow=True)


def forward(layers: list, params: list, x, *, dtype=torch.float64,
            device=None) -> torch.Tensor:
    """Logits of the images ``x`` (B, C, H, W); ``params`` holds one
    ``{"w", "scale"}`` per ``conv`` / ``matmul`` layer, in table order."""
    x = torch.as_tensor(x)
    device = x.device if device is None else torch.device(device)
    env = {table.INPUT: x.to(device=device, dtype=dtype)}
    weights = iter(params)
    for step in table.walk(layers, tuple(x.shape[1:])):
        layer = step.layer
        if step.src is not None:
            h = env[step.src]
        op = layer["op"]
        if op == "quant":
            h = ops.quant(h, layer["scale"], 0.0, layer["bits"],
                          signed=layer["signed"], narrow=False)
        elif op == "bipolar":
            h = ops.bipolar_quant(h, layer["scale"])
        elif op == "conv":
            w = _weight(layer, next(weights), dtype, device)
            h = ops.conv2d(h, w, stride=layer["stride"], pad=layer["pad"],
                           group=layer["group"])
        elif op == "matmul":
            h = ops.matmul(h, _weight(layer, next(weights), dtype, device))
        elif op == "relu":
            h = ops.relu(h)
        elif op == "maxpool":
            h = ops.max_pool(h, layer["k"], layer["stride"],
                             layer.get("pad", 0))
        elif op == "gap":
            h = ops.global_average_pool(h)
        elif op == "flatten":
            h = ops.flatten(h)
        elif op == "add":
            h = ops.add(h, env[step.other])
        else:
            raise ValueError(f"unknown layer op {op!r}")
        if step.out is not None:
            env[step.out] = h
    return h


def last_codes(layers: list, params: list, x, *, device=None) -> torch.Tensor:
    """The integer codes of the last activation ``quant`` of the table
    (float64): the comparison is of zeros if these are all 0.  The table
    cut after that layer is a table too: every name is defined before it
    is read."""
    cut = max(i for i, l in enumerate(layers) if l["op"] == "quant")
    n_weighted = sum(1 for l in layers[:cut] if l["op"] in ("conv", "matmul"))
    y = forward(layers[:cut + 1], params[:n_weighted], x, device=device)
    return y / layers[cut]["scale"]
