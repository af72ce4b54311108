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

Gradients flow through the STE (``core/ste.py``) and through the dynamic
scale: ``torch.amax`` spreads the max's gradient evenly over tied maxima,
as JAX's ``reduce_max`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant_ops import max_int
from repro_torch.core.ste import quant_ste
from repro_torch.dist.sharding import reduce_partial

from .config import QuantRecipe, TensorQuant


def _dynamic_scale(x: torch.Tensor, tq: TensorQuant, bit_width: torch.Tensor, *,
                   channel_axis=None, expert_axis=None):
    """max-abs symmetric scale (float32); per-channel when requested, and
    one per index of ``expert_axis`` when given.

    The reference writes ``amax / max_int``; under ``jit`` (every model
    path) the bound is a compile-time constant, and XLA computes a
    division by a constant as a product with its float32 reciprocal, as
    it does for ``jnp.mean`` (ROADMAP C5, C7).  The port computes that
    product."""
    keep = set()
    if tq.channelwise and channel_axis is not None:
        keep.add(channel_axis % x.ndim)
    if expert_axis is not None:
        keep.add(expert_axis % x.ndim)
    if keep:
        axes = tuple(i for i in range(x.ndim) if i not in keep)
        amax = torch.amax(torch.abs(x), dim=axes, keepdim=True)
    else:
        # every dim named: DTensor's backward of a reduction over no named
        # dim counts the tied maxima on the local shard only (0 / 0 where
        # the shard holds none)
        amax = torch.amax(torch.abs(x), dim=tuple(range(x.ndim)))
    bound = max_int(tq.signed, tq.narrow, bit_width)
    eps = torch.full((), 1e-8, dtype=torch.float32, device=x.device)
    return torch.maximum(amax.to(torch.float32), eps) * torch.reciprocal(bound)


def _fake_quant(x: torch.Tensor, tq: TensorQuant, *, channel_axis=None,
                expert_axis=None) -> torch.Tensor:
    """The dynamic Quant: a scale from ``x``, cast to x's dtype, then the
    Quant forward.  The bit width is a 0-d float32 tensor filled on x's
    device, so the clip bounds are computed there: a bound made on the
    host would cost a host-to-device copy per call, and a copy from
    pageable memory holds the host until the device has caught up."""
    bw = torch.full((), float(tq.bit_width), dtype=torch.float32, device=x.device)
    s = _dynamic_scale(x, tq, bw, channel_axis=channel_axis, expert_axis=expert_axis)
    return quant_ste(x, s.to(x.dtype), torch.zeros((), dtype=x.dtype, device=x.device),
                     bw, tq.signed, tq.narrow, tq.rounding_mode)


def quant_weight(w: torch.Tensor, tq: TensorQuant) -> torch.Tensor:
    """Fake-quant a weight (..., out_features): channel-wise on last axis."""
    return _fake_quant(w, tq, channel_axis=-1)


def quant_act(x: torch.Tensor, tq: TensorQuant) -> torch.Tensor:
    """Fake-quant an activation tensor (tensor-wise dynamic scale)."""
    return _fake_quant(x, tq)


def quant_weight_experts(w: torch.Tensor, tq: TensorQuant) -> torch.Tensor:
    """Fake-quant stacked expert weights (E, ..., out_features): each
    expert's own channel-wise scale, as ``quant_weight`` under the
    reference's ``vmap`` over experts computes it (``quant_weight`` on the
    stack would reduce over E as well)."""
    return _fake_quant(w, tq, channel_axis=-1, expert_axis=0)


def quant_act_experts(x: torch.Tensor, tq: TensorQuant) -> torch.Tensor:
    """Fake-quant stacked per-expert activations (E, ...): one tensor-wise
    scale per expert, the amax of its whole slice."""
    return _fake_quant(x, tq, expert_axis=0)


def qlinear_experts(x: torch.Tensor, w: torch.Tensor,
                    recipe: QuantRecipe | None = None) -> torch.Tensor:
    """``qlinear`` per expert, batched: x (E, M, K), w (E, K, N) ->
    (E, M, N), each expert's operands fake-quantized with its own scales
    (the reference maps ``qlinear`` over E with ``vmap``)."""
    if recipe is not None and recipe.enabled:
        w = quant_weight_experts(w, recipe.weights)
        x = quant_act_experts(x, recipe.acts)
    return reduce_partial(torch.matmul(x, w.to(x.dtype)))


def qlinear(x: torch.Tensor, w: torch.Tensor, b=None,
            recipe: QuantRecipe | None = None) -> torch.Tensor:
    """Linear layer with QONNX fake-quant at both operands.

    x: (..., K); w: (K, N); b: (N,).  The bias is not quantized on its
    own: per paper §II it inherits s_bias = s_w * s_in.  A row-parallel
    product's partial sums over DTensors are reduced at once
    (``reduce_partial``).
    """
    if recipe is not None and recipe.enabled:
        w = quant_weight(w, recipe.weights)
        x = quant_act(x, recipe.acts)
    y = reduce_partial(torch.matmul(x, w.to(x.dtype)))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def qeinsum(spec: str, x, w, recipe: QuantRecipe | None = None):
    """Einsum variant of qlinear."""
    if recipe is not None and recipe.enabled:
        w = quant_weight(w, recipe.weights)
        x = quant_act(x, recipe.acts)
    return reduce_partial(torch.einsum(spec, x, w.to(x.dtype)))


def quant_kv(k: torch.Tensor, v: torch.Tensor, bits):
    """Fake-quant KV-cache entries symmetrically (signed, not narrow,
    ROUND).  As in the reference's code (its docstring says per head-dim
    vector), each of ``k`` and ``v`` takes one tensor-wide scale per call:
    one per prefill, one per decode step."""
    if bits is None:
        return k, v
    tq = TensorQuant(bit_width=bits, symmetric=True, narrow=False)
    return _fake_quant(k, tq), _fake_quant(v, tq)
