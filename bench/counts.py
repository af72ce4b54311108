"""The benchmark's own count of a configuration's work, and the card's peaks.

Counted from the configuration's layer table alone, so it is the model's
work whatever kernels the program picks for it; a branch is counted at the
shape of the tensor it reads, an ``add`` as no MACs.  ``macs`` counts every
conv and matmul (the first conv too); QONNX's Table III leaves the first
conv out, which ``macs(cfg, skip_first_conv=True)`` reproduces.
"""
from __future__ import annotations

import math

from bench import table

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_INT8_OPS = 1979e12          # int8 tensor-core operations per second
HBM_BYTES_PER_S = 3.35e12


def output_shape(cfg: dict) -> tuple:
    return table.walk(cfg["layers"], cfg["image_shape"])[-1].shape_out


def layer_macs(cfg: dict) -> list:
    """MACs an image, one entry per conv / matmul."""
    out = []
    for step in table.walk(cfg["layers"], cfg["image_shape"]):
        layer = step.layer
        if layer["op"] == "conv":
            out.append(math.prod(step.shape_out)
                       * (layer["cin"] // layer["group"])
                       * layer["k"] ** 2)
        elif layer["op"] == "matmul":
            out.append(layer["cin"] * layer["cout"])
    return out


def macs(cfg: dict, *, skip_first_conv: bool = False) -> int:
    per = layer_macs(cfg)
    return sum(per[1:] if skip_first_conv else per)


def weight_counts(cfg: dict) -> list:
    """(number of weights, declared bits) per conv / matmul."""
    out = []
    for layer in cfg["layers"]:
        if layer["op"] == "conv":
            n = (layer["cout"] * (layer["cin"] // layer["group"])
                 * layer["k"] ** 2)
        elif layer["op"] == "matmul":
            n = layer["cin"] * layer["cout"]
        else:
            continue
        out.append((n, layer["w_bits"]))
    return out


def weight_bits(cfg: dict) -> int:
    return sum(n * b for n, b in weight_counts(cfg))


def compulsory_bytes(cfg: dict, rows: int) -> float:
    """Bytes a slot of ``rows`` images has to move at the least: its
    float32 input, the weights at their declared widths and its float32
    output, each once.  Activations in between are left out: at these slot
    sizes they fit in the card's 50 MB L2."""
    x = rows * math.prod(cfg["image_shape"]) * 4
    y = rows * math.prod(output_shape(cfg)) * 4
    return x + weight_bits(cfg) / 8 + y


def least_seconds(cfg: dict, rows: int) -> float:
    """The least time a slot of ``rows`` images needs on the card: the
    larger of its operations at the int8 peak and its compulsory bytes at
    the HBM bandwidth."""
    return max(2 * macs(cfg) * rows / PEAK_INT8_OPS,
               compulsory_bytes(cfg, rows) / HBM_BYTES_PER_S)
