"""Quantization recipes: how the paper's §II conventions apply to a model.

A copy of ``repro.quantize.config`` (stdlib dataclasses only), so that the
port and the reference name the same recipes.

A ``TensorQuant`` mirrors the attribute set of the QONNX Quant operator
(bit_width / signed / narrow / rounding_mode) plus granularity; a
``QuantRecipe`` bundles the per-tensor-kind choices the paper describes:

  * weights     — symmetric, narrow, channel-wise (avoid runtime extra term)
  * activations — asymmetric allowed, tensor-wise, integer zero point
  * bias        — s_bias = s_w * s_in (inherited, never independent)
  * kv cache    — symmetric per-head (serving extension)

Recipes are frozen dataclasses: hashable, comparable, safe to share.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class TensorQuant:
    bit_width: float = 8.0
    signed: bool = True
    narrow: bool = False
    symmetric: bool = True
    channelwise: bool = False      # scale per output channel (weights)
    rounding_mode: str = "ROUND"

    def describe(self) -> str:
        g = "chan" if self.channelwise else "tensor"
        s = "sym" if self.symmetric else "asym"
        return f"{self.bit_width}b/{s}/{g}/{'n' if self.narrow else 'w'}"


@dataclass(frozen=True)
class QuantRecipe:
    """Paper-§II-conventional QAT recipe.  ``enabled=False`` => pure float."""
    enabled: bool = False
    weights: TensorQuant = field(default_factory=lambda: TensorQuant(
        bit_width=8, symmetric=True, narrow=True, channelwise=True))
    acts: TensorQuant = field(default_factory=lambda: TensorQuant(
        bit_width=8, symmetric=True, narrow=False, channelwise=False))
    kv_cache_bits: Optional[float] = None     # None = float cache
    quantize_embeddings: bool = False

    @staticmethod
    def w_a(w_bits: float, a_bits: float, **kw) -> "QuantRecipe":
        """Convenience: the paper's CNV-wXaY notation."""
        return QuantRecipe(
            enabled=True,
            weights=TensorQuant(bit_width=w_bits, symmetric=True, narrow=True,
                                channelwise=True),
            acts=TensorQuant(bit_width=a_bits, symmetric=True, narrow=False,
                             channelwise=False),
            **kw)

    def tag(self) -> str:
        if not self.enabled:
            return "fp"
        return (f"w{self.weights.bit_width:g}a{self.acts.bit_width:g}"
                + (f"kv{self.kv_cache_bits:g}" if self.kv_cache_bits else ""))


FP32 = QuantRecipe(enabled=False)
W8A8 = QuantRecipe.w_a(8, 8)
W4A8 = QuantRecipe.w_a(4, 8)
W4A4 = QuantRecipe.w_a(4, 4)
W2A2 = QuantRecipe.w_a(2, 2)
