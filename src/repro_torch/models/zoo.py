"""QONNX model zoo (paper §VI-E, Table III): TFC, CNV, MobileNet-V1.

A copy of ``repro.models.zoo`` (numpy only): the same seeds give the same
weights, so a graph built here equals the reference's bit for bit.

Each builder emits a QonnxGraph with explicit Quant/BipolarQuant nodes —
the same graphs a Brevitas export would produce (Fig. 1 family), usable by
every transform/lowering in repro_torch.core.  Weight tensors are randomly
initialized (the zoo reproduces *structure and cost accounting*; the paper's
accuracies require the original training data, see DESIGN.md §8).

Cost accounting matches Table III:
  * MACs  — all layers except the first (8-bit input) conv for CNV/MobileNet
            (this reproduces the paper's 57,906,176 for CNV exactly)
  * weights / total weight bits — all layers; first conv kept at 8 bit for
            MobileNet (reproduces 16,839,808 = 1728*8 + 4,206,496*4)
"""
from __future__ import annotations

import numpy as np

from ..core.graph import GraphBuilder, QonnxGraph

RNG = lambda seed: np.random.RandomState(seed)


def _quant_weight(b: GraphBuilder, w: np.ndarray, bits: float,
                  seed_scale=0.125):
    """Quant (or BipolarQuant for 1 bit) node over a weight initializer.

    The seed scale is deliberately an exact power of two (0.125 = 2**-3),
    matching how deployment-trained QNNs pick scales (the NEMO dyadic
    formulation): every zoo weight scale is then ``2**-t``, the compiled
    tier's integer-requant exactness proof holds, and the fp32 constant
    survives serialization and QCDQ round trips bit-exactly.
    """
    name = b.add_initializer("w", w.astype(np.float32))
    if bits == 1:
        return b.bipolar_quant(name, seed_scale)
    return b.quant(name, seed_scale / (2 ** (bits - 1)), 0.0, bits,
                   narrow=True)


def _quant_act(b: GraphBuilder, x: str, bits: float, signed=False):
    if bits == 1:
        return b.bipolar_quant(x, 1.0)
    return b.quant(x, 1.0 / (2 ** (bits - 1)), 0.0, bits, signed=signed)


# -------------------------------------------------------------------- TFC

def build_tfc(w_bits=1, a_bits=1, seed=0, batch=1) -> QonnxGraph:
    """Tiny FC: 784 -> 3x64 -> 10 on MNIST (Table III: 59,008 MACs).

    ``batch`` sets the declared leading dim; pass None for a symbolic
    batch axis (execution is batch-polymorphic either way)."""
    rng = RNG(seed)
    b = GraphBuilder(f"TFC-w{w_bits}a{a_bits}")
    x = b.add_input("x", (batch, 784))
    h = b.quant(x, 1.0 / 128, 0.0, 8)          # 8-bit input (Table III)
    dims = [784, 64, 64, 64, 10]
    for i in range(4):
        w = rng.randn(dims[i], dims[i + 1]) * 0.1
        qw = _quant_weight(b, w, w_bits)
        (h,) = b.add_node("MatMul", [h, qw], 1)
        if i < 3:
            (h,) = b.add_node("Relu", [h], 1)
            h = _quant_act(b, h, a_bits)
    b.mark_output(h)
    return b.build()


# -------------------------------------------------------------------- CNV

CNV_CONVS = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
             (128, 256), (256, 256)]
CNV_FCS = [(256, 512), (512, 512), (512, 10)]


def build_cnv(w_bits=1, a_bits=1, seed=0, batch=1) -> QonnxGraph:
    """VGG-like CIFAR-10 model from FINN (Table III: 57,906,176 MACs
    counted beyond the first conv; 1,542,848 weights)."""
    rng = RNG(seed)
    b = GraphBuilder(f"CNV-w{w_bits}a{a_bits}")
    x = b.add_input("x", (batch, 3, 32, 32))
    h = b.quant(x, 1.0 / 128, 0.0, 8)
    first = True
    for spec in CNV_CONVS:
        if spec == "M":
            (h,) = b.add_node("MaxPool", [h], 1,
                              {"kernel_shape": [2, 2], "strides": [2, 2]})
            continue
        cin, cout = spec
        w = rng.randn(cout, cin, 3, 3) * 0.1
        qw = _quant_weight(b, w, w_bits)
        (h,) = b.add_node("Conv", [h, qw], 1,
                          {"strides": [1, 1], "pads": [0, 0, 0, 0],
                           "kernel_shape": [3, 3]})
        (h,) = b.add_node("Relu", [h], 1)
        h = _quant_act(b, h, a_bits)
        first = False
    (h,) = b.add_node("Flatten", [h], 1, {"axis": 1})
    for i, (cin, cout) in enumerate(CNV_FCS):
        w = rng.randn(cin, cout) * 0.1
        qw = _quant_weight(b, w, w_bits)
        (h,) = b.add_node("MatMul", [h, qw], 1)
        if i < len(CNV_FCS) - 1:
            (h,) = b.add_node("Relu", [h], 1)
            h = _quant_act(b, h, a_bits)
    b.mark_output(h)
    return b.build()


# -------------------------------------------------------------- MobileNet

MOBILENET_V1 = [
    # (type, cin, cout, stride)
    ("conv", 3, 32, 2),
    ("dw", 32, 32, 1), ("pw", 32, 64, 1),
    ("dw", 64, 64, 2), ("pw", 64, 128, 1),
    ("dw", 128, 128, 1), ("pw", 128, 128, 1),
    ("dw", 128, 128, 2), ("pw", 128, 256, 1),
    ("dw", 256, 256, 1), ("pw", 256, 256, 1),
    ("dw", 256, 256, 2), ("pw", 256, 512, 1),
] + [("dw", 512, 512, 1), ("pw", 512, 512, 1)] * 5 + [
    ("dw", 512, 512, 2), ("pw", 512, 1024, 1),
    ("dw", 1024, 1024, 1), ("pw", 1024, 1024, 1),
]


def build_mobilenet(w_bits=4, a_bits=4, seed=0, img=224, batch=1) -> QonnxGraph:
    """MobileNet-V1-ish w4a4 (Table III: 4,208,224 weights; first conv 8b)."""
    rng = RNG(seed)
    b = GraphBuilder(f"MobileNet-w{w_bits}a{a_bits}")
    x = b.add_input("x", (batch, 3, img, img))
    h = b.quant(x, 1.0 / 128, 0.0, 8)
    for i, (kind, cin, cout, stride) in enumerate(MOBILENET_V1):
        wb = 8.0 if i == 0 else w_bits          # first conv kept at 8 bit
        if kind == "conv":
            w = rng.randn(cout, cin, 3, 3) * 0.1
            attrs = {"strides": [stride, stride], "pads": [1, 1, 1, 1],
                     "kernel_shape": [3, 3]}
        elif kind == "dw":
            w = rng.randn(cout, 1, 3, 3) * 0.1
            attrs = {"strides": [stride, stride], "pads": [1, 1, 1, 1],
                     "kernel_shape": [3, 3], "group": cin}
        else:                                   # pointwise
            w = rng.randn(cout, cin, 1, 1) * 0.1
            attrs = {"strides": [1, 1], "pads": [0, 0, 0, 0],
                     "kernel_shape": [1, 1]}
        qw = _quant_weight(b, w, wb)
        (h,) = b.add_node("Conv", [h, qw], 1, attrs)
        (h,) = b.add_node("Relu", [h], 1)
        h = _quant_act(b, h, a_bits)
    (h,) = b.add_node("GlobalAveragePool", [h], 1)
    (h,) = b.add_node("Flatten", [h], 1, {"axis": 1})
    w = rng.randn(1024, 1000) * 0.05
    qw = _quant_weight(b, w, w_bits)
    (h,) = b.add_node("MatMul", [h, qw], 1)
    b.mark_output(h)
    return b.build()


def rescale_conv_gains(g: QonnxGraph) -> QonnxGraph:
    """Give every ``Quant``-weighted Conv a gain of about 2, in place.

    With the seeded random weights above, MobileNet's activations die out:
    every activation after its fourth conv layer quantizes to 0, at any
    ``img``, so whole-graph comparisons past that point compare zeros.
    This multiplies each such Conv's float weight and its weight-Quant
    scale by one power of two ``k`` chosen from the fan-in
    (``k ≈ 2 / (0.07·sqrt(fan_in))``, 0.07 being the zoo's dequantized
    weight spread).  The integer weights are unchanged and every scale
    stays dyadic; the layer's output is exactly k times the original's, and
    the activations stay live (about half nonzero) through all 27 convs.
    Not part of the Table III models; it works on the reference's graphs
    too (it touches only ``nodes``, ``producer`` and ``initializers``)."""
    for node in g.toposort():
        if node.op_type != "Conv":
            continue
        q = g.producer(node.inputs[1])
        if q is None or q.op_type != "Quant":
            continue
        w = np.asarray(g.initializers[q.inputs[0]])
        fan_in = int(np.prod(w.shape[1:]))
        k = 2.0 ** round(float(np.log2(2.0 / (0.07 * np.sqrt(fan_in)))))
        g.initializers[q.inputs[0]] = (w * k).astype(np.float32)
        g.initializers[q.inputs[1]] = (
            np.asarray(g.initializers[q.inputs[1]]) * k).astype(np.float32)
    return g


ZOO = {
    "TFC-w1a1": lambda: build_tfc(1, 1),
    "TFC-w1a2": lambda: build_tfc(1, 2),
    "TFC-w2a2": lambda: build_tfc(2, 2),
    "CNV-w1a1": lambda: build_cnv(1, 1),
    "CNV-w1a2": lambda: build_cnv(1, 2),
    "CNV-w2a2": lambda: build_cnv(2, 2),
    "MobileNet-w4a4": lambda: build_mobilenet(4, 4),
}

# Table III reference values: (MACs, weights, total weight bits)
TABLE3 = {
    "TFC-w1a1": (59_008, 59_008, 59_008),
    "TFC-w1a2": (59_008, 59_008, 59_008),
    "TFC-w2a2": (59_008, 59_008, 118_016),
    "CNV-w1a1": (57_906_176, 1_542_848, 1_542_848),
    "CNV-w1a2": (57_906_176, 1_542_848, 1_542_848),
    "CNV-w2a2": (57_906_176, 1_542_848, 3_085_696),
    "MobileNet-w4a4": (557_381_408, 4_208_224, 16_839_808),
}
