"""Straight-through Quant for QONNX operators, forward only (counterpart of
``repro.core.ste``).

The reference wraps the Quant op in ``jax.custom_vjp`` so that QAT trains
through it with straight-through gradients.  Its forward is the Quant op
itself, and that is what the LM serving path needs; the backward (an
``autograd.Function`` with the reference's STE and LSQ gradients) comes
with the training slice (ROADMAP A17).  Until then a call that autograd
would differentiate raises, rather than handing back the zero gradient
of ``torch.round``.
"""
from __future__ import annotations

import torch

from .quant_ops import quant


def quant_ste(x: torch.Tensor, scale, zero_point, bit_width, signed=True,
              narrow=False, rounding_mode="ROUND") -> torch.Tensor:
    """Quant (fake-quant QDQ), the forward of the reference's STE."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "quant_ste's straight-through backward is not ported yet "
            "(ROADMAP A17); run it under torch.no_grad()")
    return quant(x, scale, zero_point, bit_width, signed=signed,
                 narrow=narrow, rounding_mode=rounding_mode)


def fake_quant(x, scale, zero_point=0.0, bit_width=8, *, signed=True,
               narrow=False, rounding_mode="ROUND"):
    """Convenience dispatcher used by the quantize/ layer."""
    return quant_ste(x, scale, zero_point, bit_width, signed, narrow,
                     rounding_mode)
