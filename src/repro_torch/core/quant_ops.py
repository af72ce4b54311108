"""QONNX quantization operators in PyTorch (counterpart of ``repro.core.quant_ops``).

Implements the three operators of the QONNX standard (Pappalardo et al., 2022,
Table II) plus the uniform-quantization math of Eqs. 1-4:

    quantize(x)   = clamp(round(x / s + z), y_min, y_max)          (Eq. 1)
    y_min         = -2^(n_b - 1)  if signed else 0                 (Eq. 2)
    y_max         =  2^(n_b - 1) - 1 if signed else 2^n_b - 1      (Eq. 3)
    dequantize(y) = s * (y - z)                                    (Eq. 4)

Every function takes tensors (or Python scalars, which become tensors of
``x``'s dtype on ``x``'s device) and follows the reference's arithmetic
step for step, so results are bit-identical on normal floats: the interval
bounds come from a float32 ``exp2`` (fractional bit widths narrow the clamp
interval), and each rounding mode uses the same sign/floor/ceil form.

One known difference: the reference's float32 ``exp2`` on the CPU is
computed as ``exp(x * ln 2)`` and lands up to 16 ulp off, even at integer
bit widths of 13 and more; ``torch.exp2`` is exact there.  The bounds agree
for integer widths up to 12 (ROADMAP.md C4).
"""
from __future__ import annotations

from typing import Union

import torch

Tensor = torch.Tensor
TensorLike = Union[Tensor, float, int]

# The full QONNX ``Quant`` rounding-mode set ("ROUND" = round-half-to-even):
# UP/DOWN round away from / toward zero, HALF_UP/HALF_DOWN break ties away
# from / toward zero (sign-symmetric: HALF_UP(-1.5) = -2), plus the legacy
# ROUND_TO_ZERO alias of DOWN.
ROUNDING_MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP",
                  "HALF_DOWN", "ROUND_TO_ZERO")


def _as(v: TensorLike, like: Tensor, dtype=None) -> Tensor:
    """``v`` as a tensor on ``like``'s device (dtype defaults to ``like``'s)."""
    return torch.as_tensor(v, dtype=dtype or like.dtype, device=like.device)


def round_with_mode(x: Tensor, rounding_mode: str) -> Tensor:
    """Apply one of the QONNX rounding modes elementwise."""
    m = rounding_mode.upper()
    if m == "ROUND":                     # half to even
        return torch.round(x)
    if m in ("DOWN", "ROUND_TO_ZERO"):   # toward zero
        return torch.trunc(x)
    if m == "UP":                        # away from zero
        return torch.sign(x) * torch.ceil(torch.abs(x))
    if m == "CEIL":
        return torch.ceil(x)
    if m == "FLOOR":
        return torch.floor(x)
    if m == "HALF_UP":                   # ties away from zero
        return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
    if m == "HALF_DOWN":                 # ties toward zero
        return torch.sign(x) * torch.ceil(torch.abs(x) - 0.5)
    raise ValueError(f"unknown rounding_mode {rounding_mode!r}; expected one of {ROUNDING_MODES}")


def round_shift(p: Tensor, shift: int, rounding_mode: str = "ROUND") -> Tensor:
    """Integer rounding right shift: ``round(p / 2**shift)`` in pure integer
    arithmetic, under any QONNX rounding mode.

    ``p`` is an integer tensor, ``shift`` a Python int >= 0 (0 is the
    identity).  Every mode is realized from the floor decomposition
    ``p = (p >> s) * 2**s + r`` with ``0 <= r < 2**s``.  The decomposition
    runs in int64, so no step can overflow, INT32_MIN and INT32_MAX
    included; the result has ``p``'s dtype (a rounded quotient of an int32
    by ``2**s``, ``s >= 1``, always fits int32).
    """
    s = int(shift)
    if s < 0:
        raise ValueError(f"round_shift needs shift >= 0, got {shift}")
    if s == 0:
        return p
    m = rounding_mode.upper()
    if m not in ROUNDING_MODES:
        raise ValueError(
            f"unknown rounding_mode {rounding_mode!r}; expected one of "
            f"{ROUNDING_MODES}")
    p64 = p.to(torch.int64)
    q = p64 >> s                          # floor(p / 2**s), arithmetic shift
    r = p64 - (q << s)                    # remainder in [0, 2**s)
    half = 1 << (s - 1)
    if m == "FLOOR":
        up = torch.zeros_like(r, dtype=torch.bool)
    elif m == "CEIL":
        up = r != 0
    elif m in ("DOWN", "ROUND_TO_ZERO"):  # toward zero
        up = (r != 0) & (p64 < 0)
    elif m == "UP":                       # away from zero
        up = (r != 0) & (p64 > 0)
    elif m == "ROUND":                    # ties to even
        up = (r > half) | ((r == half) & ((q & 1) == 1))
    elif m == "HALF_UP":                  # ties away from zero
        up = torch.where(p64 >= 0, r >= half, r > half)
    else:                                 # HALF_DOWN: ties toward zero
        up = torch.where(p64 >= 0, r > half, r >= half)
    return (q + up.to(torch.int64)).to(p.dtype)


def min_int(signed: bool, narrow: bool, bit_width: TensorLike) -> Tensor:
    """Minimum integer of the target interval (Eq. 2, extended with ``narrow``).

    signed, narrow      -> -(2^(n-1)) + 1     e.g. 8b: -127
    signed, not narrow  -> -(2^(n-1))         e.g. 8b: -128
    unsigned            -> 0
    """
    bw = torch.as_tensor(bit_width, dtype=torch.float32)
    if signed:
        lo = -torch.exp2(bw - 1.0)
        if narrow:
            lo = lo + 1.0
        return lo
    return torch.zeros_like(bw)


def max_int(signed: bool, narrow: bool, bit_width: TensorLike) -> Tensor:
    """Maximum integer of the target interval (Eq. 3, extended with ``narrow``).

    signed                 -> 2^(n-1) - 1      e.g. 8b: 127
    unsigned, narrow       -> 2^n - 2          e.g. 8b: 254
    unsigned, not narrow   -> 2^n - 1          e.g. 8b: 255
    """
    bw = torch.as_tensor(bit_width, dtype=torch.float32)
    if signed:
        return torch.exp2(bw - 1.0) - 1.0
    hi = torch.exp2(bw) - 1.0
    if narrow:
        hi = hi - 1.0
    return hi


def quantize_int(x: Tensor, scale: TensorLike, zero_point: TensorLike,
                 bit_width: TensorLike, *, signed: bool = True,
                 narrow: bool = False, rounding_mode: str = "ROUND") -> Tensor:
    """Eq. 1: float tensor -> integer-valued float tensor (quantized domain)."""
    scale = _as(scale, x)
    zero_point = _as(zero_point, x)
    y = round_with_mode(x / scale + zero_point, rounding_mode)
    lo = min_int(signed, narrow, _as(bit_width, x, torch.float32))
    hi = max_int(signed, narrow, _as(bit_width, x, torch.float32))
    return torch.clamp(y, lo.to(x.dtype), hi.to(x.dtype))


def dequantize_int(y: Tensor, scale: TensorLike, zero_point: TensorLike) -> Tensor:
    """Eq. 4."""
    return _as(scale, y) * (y - _as(zero_point, y))


def quant(x: Tensor, scale: TensorLike, zero_point: TensorLike = 0.0,
          bit_width: TensorLike = 8, *, signed: bool = True,
          narrow: bool = False, rounding_mode: str = "ROUND") -> Tensor:
    """The QONNX ``Quant`` operator: fused quantize->dequantize (fake quant)."""
    q = quantize_int(x, scale, zero_point, bit_width, signed=signed,
                     narrow=narrow, rounding_mode=rounding_mode)
    return dequantize_int(q, scale, zero_point)


def bipolar_quant(x: Tensor, scale: TensorLike) -> Tensor:
    """The QONNX ``BipolarQuant`` operator: y = scale * (+1 if x >= 0 else -1)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return _as(scale, x) * torch.where(x >= 0, one, -one)


def trunc(x: Tensor, scale: TensorLike, zero_point: TensorLike,
          in_bit_width: TensorLike, out_bit_width: TensorLike, *,
          rounding_mode: str = "FLOOR", signed: bool = True) -> Tensor:
    """The QONNX ``Trunc`` operator: drop ``in - out`` LSBs of an
    already-quantized value; the output is dequantized with
    ``scale * 2^(in-out)`` and clamped to the ``out_bit_width`` range."""
    scale = _as(scale, x)
    zero_point = _as(zero_point, x)
    in_bw = _as(in_bit_width, x, torch.float32)
    out_bw = _as(out_bit_width, x, torch.float32)
    shift = torch.exp2(in_bw - out_bw).to(x.dtype)
    # the input lies on the (scale, zero_point) grid, so round() snaps the
    # float division back to the exact integer before truncating
    y_int = torch.round(x / scale + zero_point)
    y_trunc = round_with_mode(y_int / shift, rounding_mode)
    lo = min_int(signed, False, out_bw).to(x.dtype)
    hi = max_int(signed, False, out_bw).to(x.dtype)
    y_trunc = torch.clamp(y_trunc, lo, hi)
    return (scale * shift) * (y_trunc - zero_point)


def scale_from_minmax(x_min: Tensor, x_max: Tensor, bit_width: TensorLike, *,
                      signed: bool = True, narrow: bool = False,
                      symmetric: bool = True, eps: float = 1e-8) -> tuple[Tensor, Tensor]:
    """Derive (scale, zero_point) covering [x_min, x_max] (float32 tensors
    on x_min's device; used by PTQ calibration).

    Symmetric (z = 0): scale = max(|min|, |max|) / max_int.
    Asymmetric: scale = (max - min) / (max_int - min_int), integer zero
    point (restricted to the integer grid per paper §II for zero-padding
    compatibility).
    """
    x_min = torch.as_tensor(x_min, dtype=torch.float32)
    x_max = torch.as_tensor(x_max, dtype=torch.float32, device=x_min.device)
    bw = torch.as_tensor(bit_width, dtype=torch.float32, device=x_min.device)
    lo_i = min_int(signed, narrow, bw)
    hi_i = max_int(signed, narrow, bw)
    floor = torch.full((), eps, dtype=torch.float32, device=x_min.device)
    if symmetric:
        amax = torch.maximum(torch.abs(x_min), torch.abs(x_max))
        bound = torch.maximum(torch.abs(lo_i), torch.abs(hi_i))
        scale = torch.maximum(amax / bound, floor)
        return scale, torch.zeros_like(scale)
    x_min = torch.clamp_max(x_min, 0.0)
    x_max = torch.clamp_min(x_max, 0.0)
    scale = torch.maximum((x_max - x_min) / (hi_i - lo_i), floor)
    zp = torch.clamp(torch.round(lo_i - x_min / scale), lo_i, hi_i)
    return scale, zp


def int_repr(x: Tensor, scale: TensorLike, zero_point: TensorLike,
             bit_width: TensorLike, *, signed: bool = True,
             narrow: bool = False, rounding_mode: str = "ROUND",
             dtype: torch.dtype = torch.int8) -> Tensor:
    """Integer representation of a quantized tensor in a ``dtype`` carrier
    (valid when ``bit_width`` fits the carrier)."""
    return quantize_int(x, scale, zero_point, bit_width, signed=signed,
                        narrow=narrow, rounding_mode=rounding_mode).to(dtype)
