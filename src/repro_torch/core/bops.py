"""BOPs / MACs accounting (paper Eq. 5, Table III).

A copy of ``repro.core.bops``.

BOPs of one conv layer with b_w-bit weights, b_a-bit activations, n input
channels, m output channels, k x k filters over an H x W output map:

    BOPs ~= m * n * k^2 * (b_a*b_w + b_a + b_w + log2(n*k^2))   per output px

The paper's Table III counts are per-inference totals; for fully connected
layers k = 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class LayerCost:
    name: str
    macs: int
    bops: float
    weights: int
    weight_bits: float


@dataclass
class ModelCost:
    layers: list[LayerCost] = field(default_factory=list)

    @property
    def macs(self):
        return sum(l.macs for l in self.layers)

    @property
    def bops(self):
        return sum(l.bops for l in self.layers)

    @property
    def weights(self):
        return sum(l.weights for l in self.layers)

    @property
    def total_weight_bits(self):
        return sum(l.weight_bits for l in self.layers)


def conv_bops(n_in: int, m_out: int, k: int, out_hw: int, b_w: float,
              b_a: float) -> float:
    """Eq. 5 for a conv layer evaluated over ``out_hw`` output pixels."""
    per_px = m_out * n_in * k * k * (b_a * b_w + b_a + b_w + math.log2(n_in * k * k))
    return per_px * out_hw


def conv_cost(name: str, n_in: int, m_out: int, k: int, out_hw: int,
              b_w: float, b_a: float) -> LayerCost:
    macs = m_out * n_in * k * k * out_hw
    weights = m_out * n_in * k * k
    return LayerCost(name, macs, conv_bops(n_in, m_out, k, out_hw, b_w, b_a),
                     weights, weights * b_w)


def fc_cost(name: str, n_in: int, m_out: int, b_w: float, b_a: float) -> LayerCost:
    """Fully connected layer: k = 1, single output position."""
    return conv_cost(name, n_in, m_out, 1, 1, b_w, b_a)


def graph_cost(graph, act_bits: float = 8.0, default_weight_bits: float = 8.0):
    """BOPs/MACs of a QonnxGraph's MatMul/Gemm/Conv layers (Table III).

    Delegates to the analysis subsystem: bit widths come from datatype
    inference (Quant/BipolarQuant/Trunc annotations propagated through the
    graph) rather than syntactic producer matching, with ``act_bits`` /
    ``default_weight_bits`` as the FLOAT32 fallbacks.  Returns an
    ``analysis.cost.CostReport``, duck-type-compatible with ``ModelCost``
    (``.layers`` plus the same total properties).  Graph must be
    shape-inferred.
    """
    from repro_torch.analysis.cost import infer_cost
    return infer_cost(graph, act_bits=act_bits,
                      default_weight_bits=default_weight_bits)
