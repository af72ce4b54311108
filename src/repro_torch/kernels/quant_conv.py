"""Quantized 2-D convolution on the B1 / B2 matmul kernels (im2col).

Counterpart of ``repro/kernels/quant_conv.py``, which has no
``pallas_call`` of its own: it is glue that turns a conv into a matmul
whose contraction axis is the flattened receptive field, then reuses the
integer weight-carrier kernels.

  * **compile time** (``im2col_weights``): the integer conv weights
    (O, I/g, kH, kW) are reshaped once into a (C·kH·kW, O) matmul operand,
    block-diagonal over the groups for ``group > 1`` (the dense fallback
    of the grouped rule; ``quant_grouped_conv`` holds the dedicated
    kernels).
  * **run time** (``extract_patches``): the activation is unfolded into a
    contiguous (N·OH·OW, C·kH·kW) patch matrix, feature axis ordered
    (c, kh, kw) with c slowest, the order ``im2col_weights`` emits.
    ONNX pads are [top, left, bottom, right] and may be asymmetric, so the
    input is zero-padded first and unfolded without padding.
  * the patch matrix then rides ``quant_matmul`` / ``quant_matmul_int4``
    unchanged; the per-output-channel scale applies after the K loop.

``quant_conv2d`` takes NCHW and returns a contiguous NCHW tensor, so the
segment slots into the graph where the Conv node was.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .quant_matmul import quant_matmul, quant_matmul_int4


def im2col_weights(w, groups: int = 1) -> np.ndarray:
    """Conv weights (O, I/g, kH, kW) -> matmul operand (I·kH·kW, O).

    Row order is (c, kh, kw) with the input channel varying slowest.  For
    grouped convolution the result is block-diagonal: group ``gi``'s rows
    connect only to its own output columns, every other entry is exactly
    0 (dtype-preserving, so int8 carriers stay int8)."""
    w = np.asarray(w)
    o, ipg, kh, kw = w.shape
    if o % groups:
        raise ValueError(f"output channels {o} not divisible by groups {groups}")
    wm = w.reshape(o, ipg * kh * kw)
    if groups == 1:
        return np.ascontiguousarray(wm.T)
    opg, kg = o // groups, ipg * kh * kw
    out = np.zeros((ipg * groups * kh * kw, o), w.dtype)
    for gi in range(groups):
        out[gi * kg:(gi + 1) * kg, gi * opg:(gi + 1) * opg] = \
            wm[gi * opg:(gi + 1) * opg].T
    return out


def _ints(v) -> tuple:
    return tuple(int(a) for a in v)


def conv_out_hw(h: int, w: int, kernel_shape, strides, pads,
                dilations) -> tuple[int, int]:
    """(OH, OW) of a conv over an (H, W) map with ONNX [t, l, b, r] pads."""
    kh, kw = _ints(kernel_shape)
    sh, sw = _ints(strides)
    dh, dw = _ints(dilations)
    pt, pl, pb, pr = _ints(pads)
    return ((h + pt + pb - (dh * (kh - 1) + 1)) // sh + 1,
            (w + pl + pr - (dw * (kw - 1) + 1)) // sw + 1)


def conv_tap_slices(x: torch.Tensor, kernel_shape, strides=(1, 1),
                    pads=(0, 0, 0, 0), dilations=(1, 1)):
    """Zero-pad NCHW ``x`` and take its kH·kW strided / dilated tap slices.

    Returns ``(taps, (OH, OW))``: a list of kH·kW views, each
    (N, C, OH, OW), in (kh, kw) row-major order.  Padded positions are
    exactly 0."""
    kh, kw = _ints(kernel_shape)
    sh, sw = _ints(strides)
    dh, dw = _ints(dilations)
    pt, pl, pb, pr = _ints(pads)
    oh, ow = conv_out_hw(x.shape[2], x.shape[3], kernel_shape, strides, pads,
                         dilations)
    xp = F.pad(x, (pl, pr, pt, pb))
    taps = [xp[:, :, i * dh: i * dh + sh * (oh - 1) + 1: sh,
               j * dw: j * dw + sw * (ow - 1) + 1: sw]
            for i in range(kh) for j in range(kw)]
    return taps, (oh, ow)


def extract_patches(x: torch.Tensor, kernel_shape, strides=(1, 1),
                    pads=(0, 0, 0, 0), dilations=(1, 1)):
    """Unfold NCHW ``x`` into a contiguous im2col patch matrix.

    Returns ``(patches, (OH, OW))`` with patches (N·OH·OW, C·kH·kW), the
    feature axis ordered (c, kh, kw) with c slowest."""
    n, c = x.shape[:2]
    kh, kw = _ints(kernel_shape)
    sh, sw = _ints(strides)
    pt, pl, pb, pr = _ints(pads)
    if kh == kw == 1 and (pt, pl, pb, pr) == (0, 0, 0, 0):
        # pointwise: no unfold, only the stride's subsampling
        xs = x[:, :, ::sh, ::sw]
        oh, ow = xs.shape[2], xs.shape[3]
        return (xs.permute(0, 2, 3, 1).reshape(n * oh * ow, c).contiguous(),
                (oh, ow))
    oh, ow = conv_out_hw(x.shape[2], x.shape[3], kernel_shape, strides, pads,
                         dilations)
    # F.unfold pads symmetrically only: pad first, unfold with padding 0
    xp = F.pad(x, (pl, pr, pt, pb))
    cols = F.unfold(xp, (kh, kw), dilation=_ints(dilations), padding=0,
                    stride=(sh, sw))                  # (N, C·kH·kW, OH·OW)
    return (cols.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)
            .contiguous(), (oh, ow))


def quant_conv2d(x: torch.Tensor, w2: torch.Tensor, w_scale,
                 bias: Optional[torch.Tensor] = None, *, kernel_shape,
                 strides=(1, 1), pads=(0, 0, 0, 0), dilations=(1, 1),
                 packed: bool = False, acc_dtype=torch.float32, requant=None,
                 in_scale=None, int8_codes: bool = False) -> torch.Tensor:
    """Fused quantized conv: im2col patches through B1 / B2.

    x        — (N, C, H, W) activations (cast to float32)
    w2       — im2col'd integer weights (C·kH·kW, O) int8, or their int4
               packing (C·kH·kW // 2, O) when ``packed``
    w_scale  — dequant scale, scalar or per output channel (O,); the int32
               multipliers with ``requant``
    bias     — optional (O,) float32
    acc_dtype / requant / in_scale / int8_codes — the kernel's body
               (``quant_matmul``); the zero padding divides to 0 on the
               integer path too
    Returns (N, O, OH, OW) float32, contiguous."""
    x = x.to(torch.float32)
    patches, (oh, ow) = extract_patches(x, kernel_shape, strides, pads,
                                        dilations)
    mm = quant_matmul_int4 if packed else quant_matmul
    y = mm(patches, w2, w_scale, bias, acc_dtype=acc_dtype, requant=requant,
           in_scale=in_scale, int8_codes=int8_codes)
    return y.reshape(x.shape[0], oh, ow, y.shape[-1]).permute(0, 3, 1, 2) \
        .contiguous()
