"""Fake-quant building blocks used inside the LM models (counterpart of
``repro.quantize.layers``).

Dynamic quantization per paper §V, "scale as a function of x": scales are
computed at run time from the tensor being quantized (weights re-derive
their channel scale on every call, activations their tensor scale), so
the parameters are the same for float and quantized runs.

Every function follows the reference's operation order and its dtype
casts: the scale is computed in float32 and then cast to the operand's
dtype, so for a bf16 activation ``x / s``, the rounding, the clip and the
dequantization all run in bf16, as they do in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant_ops import max_int
from repro_torch.core.ste import quant_ste

from .config import QuantRecipe, TensorQuant


def _dynamic_scale(x: torch.Tensor, tq: TensorQuant, bit_width: torch.Tensor, *,
                   channel_axis=None):
    """max-abs symmetric scale (float32); per-channel when requested.

    The reference writes ``amax / max_int``; under ``jit`` (every model
    path) the bound is a compile-time constant, and XLA computes a
    division by a constant as a product with its float32 reciprocal, as
    it does for ``jnp.mean`` (ROADMAP C5, C7).  The port computes that
    product."""
    if tq.channelwise and channel_axis is not None:
        keep = channel_axis % x.ndim
        axes = tuple(i for i in range(x.ndim) if i != keep)
        amax = torch.amax(torch.abs(x), dim=axes, keepdim=True)
    else:
        amax = torch.amax(torch.abs(x))
    bound = max_int(tq.signed, tq.narrow, bit_width)
    eps = torch.full((), 1e-8, dtype=torch.float32, device=x.device)
    return torch.maximum(amax.to(torch.float32), eps) * torch.reciprocal(bound)


def _fake_quant(x: torch.Tensor, tq: TensorQuant, *, channel_axis=None) -> torch.Tensor:
    """The dynamic Quant: a scale from ``x``, cast to x's dtype, then the
    Quant forward.  The bit width is a 0-d float32 tensor filled on x's
    device, so the clip bounds are computed there: a bound made on the
    host would cost a host-to-device copy per call, and a copy from
    pageable memory holds the host until the device has caught up."""
    bw = torch.full((), float(tq.bit_width), dtype=torch.float32, device=x.device)
    s = _dynamic_scale(x, tq, bw, channel_axis=channel_axis)
    return quant_ste(x, s.to(x.dtype), torch.zeros((), dtype=x.dtype, device=x.device),
                     bw, tq.signed, tq.narrow, tq.rounding_mode)


def quant_weight(w: torch.Tensor, tq: TensorQuant) -> torch.Tensor:
    """Fake-quant a weight (..., out_features): channel-wise on last axis."""
    return _fake_quant(w, tq, channel_axis=-1)


def quant_act(x: torch.Tensor, tq: TensorQuant) -> torch.Tensor:
    """Fake-quant an activation tensor (tensor-wise dynamic scale)."""
    return _fake_quant(x, tq)


def qlinear(x: torch.Tensor, w: torch.Tensor, b=None,
            recipe: QuantRecipe | None = None) -> torch.Tensor:
    """Linear layer with QONNX fake-quant at both operands.

    x: (..., K); w: (K, N); b: (N,).  The bias is not quantized on its
    own: per paper §II it inherits s_bias = s_w * s_in.
    """
    if recipe is not None and recipe.enabled:
        w = quant_weight(w, recipe.weights)
        x = quant_act(x, recipe.acts)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def qeinsum(spec: str, x, w, recipe: QuantRecipe | None = None):
    """Einsum variant of qlinear."""
    if recipe is not None and recipe.enabled:
        w = quant_weight(w, recipe.weights)
        x = quant_act(x, recipe.acts)
    return torch.einsum(spec, x, w.to(x.dtype))


def quant_kv(k: torch.Tensor, v: torch.Tensor, bits):
    """Fake-quant KV-cache entries symmetrically (signed, not narrow,
    ROUND).  As in the reference's code (its docstring says per head-dim
    vector), each of ``k`` and ``v`` takes one tensor-wide scale per call:
    one per prefill, one per decode step."""
    if bits is None:
        return k, v
    tq = TensorQuant(bit_width=bits, symmetric=True, narrow=False)
    return _fake_quant(k, tq), _fake_quant(v, tq)
