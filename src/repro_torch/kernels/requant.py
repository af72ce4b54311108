"""B3: the integer-only requantization epilogue of B1, B2, B5 and B6.

Replaces ``repro/kernels/requant.py`` · ``int_epilogue``, which has no
``pallas_call`` of its own: the reference inlines it at the last K step of
``_qmm_kernel`` / ``_qmm4_kernel`` and in ``_gqmm_kernel`` / ``_dw_kernel``.
On the card it is the ``__device__`` helper ``csrc/int_epilogue.cuh``,
included by ``quant_matmul.cu`` and ``quant_grouped_conv.cu``; this module
holds its static parameters (``IntRequant``) and its plain twin.

When every scale of a fused segment is dyadic (``m / 2**t``), the fp32
dequant -> round -> requant chain is exact in integers:

    P  = acc * mult                      # mult = M_x * M_w per channel
    q  = round_shift(P + z_a * 2**s, s)  # s = (T_x + T_w) - T_a
    y  = float(clip(q, lo, hi) - z_a) * 2**-T_a

The lowering (``core/lowering/requant.py``) selects it only after proving
the oracle's own fp32 chain exact (every intermediate below 2**24), so the
result equals the oracle bit for bit.  The zero point folds in before the
shift, because ties depend on the shifted value.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.quant_ops import round_shift


@dataclass(frozen=True)
class IntRequant:
    """Static parameters of one integer requantization epilogue (the
    reference's fields and defaults).

    shift         — total dequant shift T = T_x + T_w (output scale
                    2**-shift) when no activation Quant is fused
    relu          — max(P, 0); valid because every scale is positive
    has_act       — a trailing per-tensor activation Quant is fused
    act_shift     — s = (T_x + T_w) - T_a; negative means a left shift
    act_zp        — integral activation zero point
    act_lo/act_hi — static integer clamp bounds (Eqs. 2-3 with narrow)
    act_out_shift — T_a: output y = float(q - act_zp) * 2**-T_a
    rounding_mode — any quant_ops.ROUNDING_MODES member
    """
    shift: int
    relu: bool = False
    has_act: bool = False
    act_shift: int = 0
    act_zp: int = 0
    act_lo: int = 0
    act_hi: int = 0
    act_out_shift: int = 0
    rounding_mode: str = "ROUND"

    def out_mul(self) -> float:
        """The float32 output scale 2**-T, as the reference rounds it."""
        t = self.act_out_shift if self.has_act else self.shift
        return float(np.float32(2.0 ** -t))


def int_epilogue_plain(acc: torch.Tensor, mult: torch.Tensor,
                       rq: IntRequant) -> torch.Tensor:
    """Plain twin of B3: one ``IntRequant`` over an integer accumulator.

    ``acc`` holds int32 values (any integer dtype); ``mult`` the int32
    multipliers, broadcastable against it.  The product is an int32 as in
    the reference; the zero point, the shift and the clip run in int64, so
    no step overflows.  Returns float32."""
    p = (acc.to(torch.int64) * mult.to(torch.int64)).to(torch.int32)
    if rq.relu:
        p = torch.clamp_min(p, 0)
    p = p.to(torch.int64)
    if not rq.has_act:
        return p.to(torch.float32) * rq.out_mul()
    s = rq.act_shift
    if s >= 0:
        q = round_shift(p + rq.act_zp * (1 << s), s, rq.rounding_mode)
    else:
        # a left shift: the quotient is integral, every mode is the identity
        q = p * (1 << -s) + rq.act_zp
    q = torch.clamp(q, rq.act_lo, rq.act_hi)
    return (q - rq.act_zp).to(torch.float32) * rq.out_mul()
