"""Pooling on fused-segment boundaries, float32 and integer-carrier variants.

Counterpart of ``repro/kernels/quant_pool.py``, which has no
``pallas_call``: there these are ``lax`` / ``jnp`` ops inside the one
jitted plan, here plain PyTorch ops that run wherever their input lies
(the CPU or the card, the same expression on both).  The cross-segment
fusion pass (``core/lowering/fusion.py``) lowers ``MaxPool`` /
``AveragePool`` nodes onto them.  Two families:

  * float32 variants — the same expression as the oracle's own pool
    (``core/executor.py`` · ``_pool``, kept separate so that it checks
    these): a max over a ``-inf``-padded input, or window sums followed by
    a true division by a tensor (a count per window, or ``kH·kW``);
  * integer-carrier variants — the boundary arrives as int8 codes ``q``
    with ``v = (q - z) * s``:

      - max pooling commutes with dequantization (``s > 0``), so
        ``maxpool2d_codes`` reduces the codes with an int8 ``-128``
        identity and the result dequantizes to the oracle's float32 max;
      - average pooling sums the codes in int32 and rebuilds the value sum
        as ``s * (S_q - n_real * z)``: a padded position adds code 0, which
        stands for value ``-s*z``, hence the ``n_real * z`` correction.  The
        divisor follows the oracle's ONNX rule: the real element count per
        window when pads are present and ``count_include_pad=0``, else
        ``kH*kW``.  It equals the oracle when the caller proves the dyadic
        bound (``fusion.py`` gates on ``M * n * amax < 2**24``).

Both code-domain pools are one window view — ``F.pad`` with the identity,
then ``unfold`` over H and W, then ``amax`` or ``sum(dtype=torch.int32)``
— because ``F.max_pool2d`` / ``F.avg_pool2d`` take no integer input on
every device.

``pack_codes_int4`` / ``unpack_codes_int4`` are the boundary nibble
packers: codes in [-8, 7] travel two a byte along the **last** axis (the
weights of B2 pack along K instead, ``ops.pack_int4``), bit-compatible
with the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["maxpool2d", "maxpool2d_codes", "avgpool2d", "avgpool2d_codes",
           "pack_codes_int4", "unpack_codes_int4"]

INT8_MIN = -128          # identity for the int8 code-domain max reduction


def _window(kernel_shape, strides, pads):
    """NCHW 2-D pool attributes -> (k, strides, F.pad's list, padded):
    strides default to the kernel, ONNX pads are [top, left, bottom,
    right]."""
    k = tuple(int(v) for v in kernel_shape)
    s = k if strides is None else tuple(int(v) for v in strides)
    p = tuple(int(v) for v in pads)
    tp = [p[1], p[3], p[0], p[2]]            # F.pad: last dim first
    return k, s, tp, any(p)


def true_div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` as an IEEE division.  The divisor is a tensor on ``x``'s
    device: divided by a Python number, a CUDA tensor is multiplied by the
    reciprocal, which can be 1 ulp off.  (The reference derives its
    divisors from the runtime input only to stop XLA from folding the
    division into a reciprocal product; eager PyTorch folds nothing.)"""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _counts(x, k, s, tp):
    """Real elements per window of ``x``'s plane, float32 (1, 1, OH, OW)."""
    ones = F.pad(torch.ones_like(x[:1, :1], dtype=torch.float32), tp)
    return F.avg_pool2d(ones, k, s, divisor_override=1)


def _code_windows(codes, k, s, tp, value):
    """(N, C, OH, OW, kH, kW) window view of an integer NCHW tensor,
    padded with ``value``."""
    xp = F.pad(codes, tp, value=value) if any(tp) else codes
    return xp.unfold(2, k[0], s[0]).unfold(3, k[1], s[1])


def maxpool2d(x, *, kernel_shape, strides=None, pads=(0, 0, 0, 0)):
    """float32 NCHW max pool: the oracle's expression."""
    k, s, tp, padded = _window(kernel_shape, strides, pads)
    xp = F.pad(x, tp, value=-float("inf")) if padded else x
    return F.max_pool2d(xp, k, s)


def maxpool2d_codes(codes, *, kernel_shape, strides=None, pads=(0, 0, 0, 0)):
    """Max pool directly on int8 quantization codes.

    Equal to dequantize-then-pool for any positive scale, provided every
    window covers at least one real element: the fusion rule accepts a
    carrier only where ``pads < kernel``, so the ``-128`` padding can never
    win a window."""
    k, s, tp, _ = _window(kernel_shape, strides, pads)
    return _code_windows(codes, k, s, tp, INT8_MIN).amax(dim=(-2, -1))


def avgpool2d(x, *, kernel_shape, strides=None, pads=(0, 0, 0, 0),
              count_include_pad=0):
    """float32 NCHW average pool: the oracle's expression, with the ONNX
    ``count_include_pad=0`` real-element divisor on padded edges."""
    k, s, tp, padded = _window(kernel_shape, strides, pads)
    y = F.avg_pool2d(F.pad(x, tp) if padded else x, k, s, divisor_override=1)
    if padded and not bool(count_include_pad):
        return y / _counts(x, k, s, tp)
    return true_div(y, float(np.prod(k)))


def avgpool2d_codes(codes, scale, zero_point, *, kernel_shape, strides=None,
                    pads=(0, 0, 0, 0), count_include_pad=0):
    """Average pool taken directly from int8 codes, int32 window sums.

    With ``v = s * (q - z)`` the window's value sum is
    ``s * (S_q - n_real * z)``; the divisor is ``n_real`` when pads are
    present and ``count_include_pad=0``, else ``kH*kW``.  Equal to the
    oracle when the caller proves the dyadic bound ``M * kH*kW * amax <
    2**24`` (fusion.py's gate); returns float32 values."""
    k, s, tp, padded = _window(kernel_shape, strides, pads)
    s_q = _code_windows(codes.to(torch.int32), k, s, tp, 0).sum(
        dim=(-2, -1), dtype=torch.int32)
    z = int(round(float(np.asarray(zero_point).reshape(()))))
    counts = _counts(codes, k, s, tp) \
        if padded and (z != 0 or not bool(count_include_pad)) else None
    if z == 0:
        num = s_q
    elif counts is not None:
        num = s_q - z * counts.to(torch.int32)
    else:
        num = s_q - z * int(np.prod(k))
    val = float(np.float32(scale)) * num.to(torch.float32)
    if padded and not bool(count_include_pad):
        return val / counts
    return true_div(val, float(np.prod(k)))


def pack_codes_int4(codes):
    """Nibble-pack int8 codes in [-8, 7] two a byte along the last axis:
    ``(..., N) -> (..., N//2)`` uint8, element 2i in the low nibble."""
    c = codes.to(torch.int32)
    return ((c[..., 0::2] & 0xF) | ((c[..., 1::2] & 0xF) << 4)).to(torch.uint8)


def unpack_codes_int4(packed):
    """Inverse of ``pack_codes_int4``: ``(..., N//2)`` uint8 ->
    ``(..., N)`` int8 codes, each nibble sign-extended by ``(n ^ 8) - 8``."""
    b = packed.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)
