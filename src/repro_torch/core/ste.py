"""Straight-through estimators for QONNX operators, QAT support
(counterpart of ``repro.core.ste``).

The paper's QAT frontends (Brevitas, QKeras) train with fake-quant forward
passes and straight-through gradients.  The reference writes them with
``jax.custom_vjp``; here they are ``torch.autograd.Function``s with the
same gradients:

  * ``quant_ste``         — Quant with identity-in-range gradient w.r.t. x
                            (zero outside the clip interval, per Brevitas)
                            and LSQ-style gradients w.r.t. scale (Esser et
                            al. 2020), which make scales learnable.
  * ``bipolar_quant_ste`` — BipolarQuant with the hardtanh-window STE
                            (BinaryConnect, Courbariaux et al. 2015).

``bit_width`` takes no gradient (a structural hyperparameter; dynamic bit
widths flow through the forward pass only).

The forward is ``quant`` / ``bipolar_quant`` itself, bit for bit.  The
backward saves only ``x`` and the scale (not the reference's ``pre`` and
``q``, two more copies of every weight) and recomputes ``x / s + z`` and
its rounding from them: the same operations on the same values, so the
same bits.  On DTensors (``models/common.py``) the backward runs as
DTensor ops: ``sum_to_size`` sums the scale's gradient over the shards
into a partial sum, reduced over the mesh where it is used.
"""
from __future__ import annotations

import torch

from .quant_ops import _as, bipolar_quant, max_int, min_int, quant, round_with_mode


class _QuantSTE(torch.autograd.Function):
    """Quant with the reference's STE / LSQ gradients; scale and zero point
    arrive in x's dtype, the bit width as a float32 tensor."""

    @staticmethod
    def forward(ctx, x, scale, zero_point, bit_width, signed, narrow, rounding_mode):
        ctx.save_for_backward(x, scale, zero_point, bit_width)
        ctx.mode = (signed, narrow, rounding_mode)
        return quant(x, scale, zero_point, bit_width, signed=signed, narrow=narrow,
                     rounding_mode=rounding_mode)

    @staticmethod
    def backward(ctx, g):
        x, scale, zp, bw = ctx.saved_tensors
        signed, narrow, rounding_mode = ctx.mode
        pre = x / scale + zp
        lo = min_int(signed, narrow, bw).to(x.dtype)
        hi = max_int(signed, narrow, bw).to(x.dtype)
        in_range = (pre >= lo) & (pre <= hi)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        # d y / d x: straight through inside the clip window, 0 outside
        gx = torch.where(in_range, g, zero) if ctx.needs_input_grad[0] else None
        gs = gz = None
        if ctx.needs_input_grad[1]:
            # LSQ: q - z - x/s inside the window, lo - z or hi - z when clipped
            q = torch.clamp(round_with_mode(pre, rounding_mode), lo, hi)
            elem = torch.where(in_range, (q - zp) - (x / scale),
                               torch.where(pre < lo, lo - zp, hi - zp))
            gs = (g * elem).sum_to_size(scale.shape)
        if ctx.needs_input_grad[2]:
            # in the window +z and -z cancel; clipped, d/dz s*(const - z) = -s
            gz = (g * torch.where(in_range, zero, -scale)).sum_to_size(zp.shape)
        return gx, gs, gz, None, None, None, None


class _BipolarSTE(torch.autograd.Function):
    """BipolarQuant with the hardtanh-window STE; scale in x's dtype."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return bipolar_quant(x, scale)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        gx = torch.where(torch.abs(x) <= 1.0, g, zero) if ctx.needs_input_grad[0] else None
        gs = None
        if ctx.needs_input_grad[1]:
            gs = (g * torch.where(x >= 0, one, -one)).sum_to_size(scale.shape)
        return gx, gs


def quant_ste(x: torch.Tensor, scale, zero_point, bit_width, signed=True,
              narrow=False, rounding_mode="ROUND") -> torch.Tensor:
    """Quant (fake-quant QDQ) with straight-through gradients.  As in the
    reference, scale and zero point are cast to x's dtype (the cast is
    part of the graph, so their gradients return in their own dtype)."""
    return _QuantSTE.apply(x, _as(scale, x), _as(zero_point, x),
                           _as(bit_width, x, torch.float32), signed, narrow,
                           rounding_mode)


def bipolar_quant_ste(x: torch.Tensor, scale) -> torch.Tensor:
    """BipolarQuant, y = scale * (+1 if x >= 0 else -1), with the
    hardtanh-window STE: the gradient passes where |x| <= 1."""
    return _BipolarSTE.apply(x, _as(scale, x))


def fake_quant(x, scale, zero_point=0.0, bit_width=8, *, signed=True,
               narrow=False, rounding_mode="ROUND", ste=True):
    """Convenience dispatcher used by the quantize/ layer."""
    if ste:
        return quant_ste(x, scale, zero_point, bit_width, signed, narrow,
                         rounding_mode)
    return quant(x, scale, zero_point, bit_width, signed=signed,
                 narrow=narrow, rounding_mode=rounding_mode)
