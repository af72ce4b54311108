"""Integer-requant path selection: the exactness proof of the dyadic fast path.

Counterpart of ``repro.core.lowering.requant``, with the same five proof
obligations.  ``select_requant`` decides, per kernel-backed match, whether
the fused segment's epilogue may run as an int32 multiply + rounding right
shift (B3, ``kernels/requant.py``) instead of the fp32
dequant -> round -> requant chain.  The integer path is taken only when
the *interpreted oracle's own fp32 computation* is provably exact, so the
compiled segment equals the oracle bit for bit.

The proof obligations (all static, checked on the analysis tier's ranges):

  1. the activation input sits on a per-tensor dyadic grid
     ``x = s_x * (q - z)`` with ``s_x = M_x * 2**-T_x`` and integral scalar
     ``z``, and the proven value range *is* the grid range (guards against
     QuantizeLinear-style tensors whose values are the raw ``q``);
  2. the (descale-folded) weight scale is dyadic per output channel with a
     common shift: ``s_w[c] = M_w[c] * 2**-T_w``;
  3. every fp32 intermediate of the oracle stays below 2**24 so it is
     exactly representable: ``M_x * amax``, ``M_w[c] * sum_k |w_int[c]|``
     and the master product bound
     ``B = max_c M_x * M_w[c] * amax * sum_k |w_int[c]| < 2**24`` where
     ``amax = max(|int_lo - z|, |int_hi - z|)``; zero-padded conv taps are
     covered because a padded position is ``q - z = 0``;
  4. a fused activation Quant must have a *power-of-two* per-tensor scale
     ``2**-T_a``, integral scalar zero point, integral static clamp
     bounds, and headroom for the shifted zero point — with a doubled
     margin for HALF_UP/HALF_DOWN, whose oracle realization computes
     ``|x| + 0.5`` in fp32;
  5. no bias and no folded descale Mul.

On success the match's ``requant`` field carries a ``RequantPlan``: the
exact input scale the kernel divides x by (``x / s_x`` is an exact fp32
division because the true quotient ``q - z`` is a representable integer),
the int32 ``M_x * M_w`` multipliers that ride the kernels' scale slot, and
the static ``IntRequant``.  The accumulator is forced to int32: the kernel
accumulates ``q - z`` units, whose bound ``amax * sum|w|`` is below 2**24
by obligation 3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph import Node, QonnxGraph
from .base import LoweringContext

_EXACT = float(1 << 24)        # fp32 integer-exactness bound


@dataclass
class RequantPlan:
    """One proven integer-requant epilogue, ready for staging.

    in_scale — the activation grid scale the kernel divides x by
    mult     — int32 ``M_x * M_w`` multipliers, () or per-channel (O,)
    spec     — static ``IntRequant`` (kernels/requant.py) for the epilogue
    acc_bits — minimal signed accumulator width of the ``q - z`` domain dot
    int8_codes — every staged code ``q - z`` lies in [-127, 127]
               (``amax <= 127``), so B2 may take its int8 tensor-core body
    fp32_ops_eliminated — per-call fp32 epilogue ops the path removes: the
               dequant multiply, the fused relu max, and the 6-op requant
               chain (div, add-zp, round, clamp, sub-zp, mul), one per
               output element
    """
    in_scale: np.float32
    mult: np.ndarray
    spec: object
    acc_bits: int
    fp32_ops_eliminated: int
    int8_codes: bool = False


def _scalar_int(a) -> Optional[int]:
    """Exact scalar integer value of an array, else None."""
    a = np.asarray(a, np.float64)
    if a.size != 1:
        return None
    v = float(a.reshape(()))
    if not np.isfinite(v) or v != round(v):
        return None
    return int(v)


def _out_elements(g: QonnxGraph, tensor: str) -> int:
    shape = g.get_shape(tensor)
    if not shape:
        return 1
    n = 1
    for d in shape:
        n *= int(d) if d else 1
    return n


def select_requant(ctx: LoweringContext, g: QonnxGraph, node: Node, match,
                   *, w_absum, relu: bool = False, act=None) -> None:
    """Attach a ``RequantPlan`` to ``match`` when the proof obligations hold.

    ``w_absum`` — per-output-channel ``sum_k |w_int[c]|`` in the *scale's*
    channel order (conv rules pass the conv-shaped reduction, the grouped
    rule's group-major order matches its group-major scale).  ``relu`` /
    ``act`` mirror the conv neighbourhood's absorbed epilogue.  Mutates
    ``match.requant`` / ``match.acc_dtype`` / ``match.acc_bits`` in place;
    leaves the fp32 path untouched on any failed obligation.
    """
    from repro_torch.analysis.ranges import dyadic_decompose
    from repro_torch.kernels.quant_dequant import static_bounds
    from repro_torch.kernels.requant import IntRequant

    if not ctx.use_int_requant or ctx.analysis is None:
        return
    if match.bias is not None:
        return                                     # obligation 5
    if any(n.op_type in ("Mul", "Add") for n in match.nodes):
        return                                     # folded descale/bias tail

    # ---- obligation 1: per-tensor dyadic input grid, values == grid values
    r = ctx.analysis.range(match.x)
    grid = r.grid
    if grid is None or not r.is_bounded():
        return
    s_x = np.asarray(grid.scale)
    if s_x.size != 1:
        return
    dx = dyadic_decompose(s_x)
    if dx is None:
        return
    m_x, t_x = int(dx[0].reshape(())), int(dx[1])
    z = _scalar_int(grid.zero_point)
    if z is None:
        return
    if not (np.isfinite(grid.int_lo) and np.isfinite(grid.int_hi)):
        return
    sx64 = float(np.asarray(s_x, np.float64).reshape(()))
    if r.lo != sx64 * (grid.int_lo - z) or r.hi != sx64 * (grid.int_hi - z):
        return          # grid annotation does not describe the values
    amax = max(abs(grid.int_lo - z), abs(grid.int_hi - z))
    if m_x * amax >= _EXACT:
        return                                     # x = s_x*(q-z) inexact

    # ---- obligation 2: dyadic weight scale, common shift
    dw = dyadic_decompose(match.scale)
    if dw is None:
        return
    m_w, t_w = dw
    m_w = np.asarray(m_w, np.float64).reshape(-1)

    # ---- obligation 3: master fp32-exactness bound
    absum = np.asarray(w_absum, np.float64).reshape(-1)
    if m_w.size not in (1, absum.size):
        return
    if np.max(m_w * (absum if m_w.size == absum.size
                     else np.max(absum))) >= _EXACT:
        return                                     # s_w*w products inexact
    b = float(np.max(m_x * m_w * amax * absum))
    if b >= _EXACT:
        return                                     # oracle dot sums inexact

    shift = t_x + int(t_w)
    spec_kwargs = dict(shift=shift, relu=bool(relu))

    # ---- obligation 4: power-of-two fused activation Quant
    if act is not None:
        da = dyadic_decompose(act.scale, max_mult=1)
        if da is None:
            return                                 # not a power of two
        t_a = int(da[1])
        z_a = _scalar_int(act.zero_point)
        if z_a is None:
            return
        lo, hi = static_bounds(act.signed, act.narrow, act.bit_width)
        if lo != round(lo) or hi != round(hi):
            return                                 # fractional-bit clamp
        if max(abs(lo - z_a), abs(hi - z_a)) >= _EXACT:
            return                                 # output dequant inexact
        s_req = shift - t_a
        half_mode = act.rounding_mode in ("HALF_UP", "HALF_DOWN")
        if s_req >= 0:
            need = b + abs(z_a) * 2.0 ** s_req
            ok = (2.0 * need + 2.0 ** s_req < _EXACT) if half_mode \
                else (need < _EXACT)
        else:
            need = b * 2.0 ** (-s_req) + abs(z_a)
            ok = need < (_EXACT / 2 if half_mode else _EXACT)
        if not ok:
            return
        spec_kwargs.update(
            has_act=True, act_shift=s_req, act_zp=z_a, act_lo=int(lo),
            act_hi=int(hi), act_out_shift=t_a,
            rounding_mode=act.rounding_mode)

    mult = np.asarray(m_x * np.asarray(dw[0]).reshape(match.scale.shape),
                      np.int64)
    if mult.size and int(np.max(mult)) >= (1 << 31):
        return                                     # multiplier overflows i32

    acc_bound = float(np.max(amax * absum))        # q-z domain accumulator
    acc_bits = max(1, int(np.ceil(acc_bound)).bit_length()) + 1

    n_elems = _out_elements(g, match.out)
    eliminated = (1 + (1 if relu else 0) + (6 if act is not None else 0)) \
        * n_elems

    match.requant = RequantPlan(
        in_scale=np.float32(np.asarray(s_x, np.float32).reshape(())),
        mult=mult.astype(np.int32), spec=IntRequant(**spec_kwargs),
        acc_bits=acc_bits, fp32_ops_eliminated=eliminated,
        int8_codes=bool(amax <= 127))
    match.acc_dtype = torch.int32
    match.acc_bits = acc_bits
