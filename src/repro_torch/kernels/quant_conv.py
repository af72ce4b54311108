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
  * **the operand**: row m = (n, oh, ow) and column k = (c, kh, kw) of the
    (N·OH·OW, C·kH·kW) patch matrix, c slowest, the order
    ``im2col_weights`` emits.  ONNX pads are [top, left, bottom, right]
    and may be asymmetric; a padding tap is an exact 0.
  * **on the card** (``conv_operand`` "implicit": every conv with
    kH·kW > 1 or any padding) no patch matrix is built: B1 and B2 read
    the operand straight from the NCHW activation by address (implicit
    GEMM; ``csrc/conv_taps.cuh``, geometry ``ConvGather``) and write the
    (N, O, OH, OW) output directly.  The bits are those of the
    materialised path: the same float32 values are staged, the float32
    body sums in the same K order under the same launch plan.
  * **materialised** (``extract_patches``): the activation is unfolded
    into a contiguous patch matrix (the input zero-padded first and
    unfolded without padding), which rides ``quant_matmul`` /
    ``quant_matmul_int4`` unchanged; the output is permuted to NCHW.  The
    plain twins on the CPU take this path, and so does the unpadded 1×1
    pointwise conv on the card (its "patches" are the NHWC permute of
    the strided input).  ``gather_patches`` is the host half of the
    implicit path: the kernel's row bases, tap offsets and bounds applied
    by a torch gather, which the CPU tests hold against
    ``extract_patches``.

``conv_operand_launches`` counts the card's conv launches per path, at
the call (so at a warm-up and a capture, never at a replay), as
``quant_matmul.body_launches`` counts B2's bodies.  ``quant_conv2d``
takes NCHW and returns a contiguous NCHW tensor, so the segment slots
into the graph where the Conv node was.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .quant_matmul import _launch, quant_matmul, quant_matmul_int4

# the card's conv launches per path of the A operand: gathered by address
# in the kernel, or unfolded into a patch matrix first
conv_operand_launches = {"implicit": 0, "materialised": 0}


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


# the kernels' conv geometry (csrc/conv_taps.cuh · taps::Conv), in order
CONV_GEO_FIELDS = ("N", "C", "H", "W", "OH", "OW", "kh", "kw", "sh", "sw",
                   "dh", "dw", "pt", "pl")


@dataclass(frozen=True)
class ConvGather:
    """The implicit GEMM's geometry of one conv (``CONV_GEO_FIELDS``): an
    (N, C, H, W) input, (OH, OW) outputs, a kh x kw kernel, strides
    (sh, sw), dilations (dh, dw) and the top / left pads (pt, pl); the
    bottom and right pads only set OH and OW."""
    N: int
    C: int
    H: int
    W: int
    OH: int
    OW: int
    kh: int
    kw: int
    sh: int
    sw: int
    dh: int
    dw: int
    pt: int
    pl: int

    @property
    def M(self) -> int:
        return self.N * self.OH * self.OW

    @property
    def K(self) -> int:
        return self.C * self.kh * self.kw

    @property
    def in_shape(self) -> tuple:
        return (self.N, self.C, self.H, self.W)

    def out_shape(self, o: int) -> tuple:
        return (self.N, o, self.OH, self.OW)

    @functools.cached_property
    def ints(self):
        """The C interface's geometry array (built once per geometry)."""
        return (ctypes.c_int * len(CONV_GEO_FIELDS))(
            *(getattr(self, f) for f in CONV_GEO_FIELDS))


@functools.lru_cache(maxsize=256)
def conv_gather(shape: tuple, kernel_shape, strides, pads,
                dilations) -> ConvGather:
    """The ``ConvGather`` of a conv over an NCHW input of ``shape``.  Raises
    ``ValueError`` where the kernels' 32-bit column offsets cannot address
    it (an input of 2^31 elements or more)."""
    n, c, h, w = (int(v) for v in shape)
    oh, ow = conv_out_hw(h, w, kernel_shape, strides, pads, dilations)
    pt, pl, _, _ = _ints(pads)
    if n * c * h * w >= 2 ** 31:
        raise ValueError(f"quant_conv2d: an input of {n * c * h * w} elements "
                         "is beyond the gather's 32-bit offsets")
    return ConvGather(n, c, h, w, oh, ow, *_ints(kernel_shape), *_ints(strides),
                      *_ints(dilations), pt, pl)


def gather_taps(g: ConvGather):
    """Every column's offset and tap, ``(off, dy, dx)``, int64, as the
    kernels walk them (``taps::next``: kw, then kh, then c, by carries
    from column 0)."""
    off, dy, dx = [], [], []
    o = y = x = 0
    for _ in range(g.K):
        off.append(o)
        dy.append(y)
        dx.append(x)
        x += g.dw
        o += g.dw
        if x == g.kw * g.dw:
            x, y, o = 0, y + g.dh, o + g.dh * g.W - g.kw * g.dw
            if y == g.kh * g.dh:
                y, o = 0, o + g.H * g.W - g.kh * g.dh * g.W
    return tuple(torch.tensor(v, dtype=torch.int64) for v in (off, dy, dx))


def gather_patches(x: torch.Tensor, g: ConvGather) -> torch.Tensor:
    """The host half of ``csrc/conv_taps.cuh``: the (M, K) operand the
    kernels gather from NCHW ``x``.  Row m's base is n·C·H·W + ih·W + iw,
    (ih, iw) tap (0, 0)'s input position (either may lie outside the map);
    column k's offset and tap come from ``gather_taps``; the element is
    base + off where 0 <= ih + dy < H and 0 <= iw + dx < W, else an exact
    0."""
    m = torch.arange(g.M, dtype=torch.int64)
    n, p = m // (g.OH * g.OW), m % (g.OH * g.OW)
    ih = p // g.OW * g.sh - g.pt
    iw = p % g.OW * g.sw - g.pl
    base = n * g.C * g.H * g.W + ih * g.W + iw
    off, dy, dx = gather_taps(g)
    inside = ((ih[:, None] + dy >= 0) & (ih[:, None] + dy < g.H) &
              (iw[:, None] + dx >= 0) & (iw[:, None] + dx < g.W))
    idx = torch.where(inside, base[:, None] + off, 0)
    flat = x.reshape(-1)
    return torch.where(inside, flat[idx], torch.zeros((), dtype=x.dtype))


def conv_operand(kernel_shape, pads, device) -> str:
    """How ``quant_conv2d`` takes the conv's A operand on ``device``:
    ``"implicit"`` (gathered by address inside B1 / B2) on the card for
    every conv with kH·kW > 1 or any padding, else ``"materialised"`` (the
    patch matrix of ``extract_patches``: the CPU's twins, and the unpadded
    pointwise conv's NHWC permute)."""
    kh, kw = _ints(kernel_shape)
    if torch.device(device).type == "cuda" and \
            (kh * kw > 1 or any(_ints(pads))):
        return "implicit"
    return "materialised"


def quant_conv2d(x: torch.Tensor, w2: torch.Tensor, w_scale,
                 bias: Optional[torch.Tensor] = None, *, kernel_shape,
                 strides=(1, 1), pads=(0, 0, 0, 0), dilations=(1, 1),
                 packed: bool = False, acc_dtype=torch.float32, requant=None,
                 in_scale=None, int8_codes: bool = False,
                 blocks=None) -> torch.Tensor:
    """Fused quantized conv through B1 / B2 (the operand as
    ``conv_operand`` says).

    x        — (N, C, H, W) activations (cast to float32)
    w2       — im2col'd integer weights (C·kH·kW, O) int8, or their int4
               packing (C·kH·kW // 2, O) when ``packed``
    w_scale  — dequant scale, scalar or per output channel (O,); the int32
               multipliers with ``requant``
    bias     — optional (O,) float32
    acc_dtype / requant / in_scale / int8_codes — the kernel's body
               (``quant_matmul``); the zero padding divides to 0 on the
               integer path too
    blocks   — the matmul's launch-plan override (``quant_matmul``)
    Returns (N, O, OH, OW) float32, contiguous."""
    x = x.to(torch.float32)
    operand = conv_operand(kernel_shape, pads, x.device)
    if x.device.type == "cuda":
        conv_operand_launches[operand] += 1
    if operand == "implicit":
        k = 2 * w2.shape[0] if packed else w2.shape[0]
        if packed and int8_codes and acc_dtype != torch.int32:
            raise ValueError("quant_conv2d: int8_codes=True needs "
                             "acc_dtype=torch.int32")
        return _launch("quant_matmul_int4" if packed else "quant_matmul",
                       x.contiguous(), w2, w_scale, bias, k, packed, acc_dtype,
                       requant, in_scale, int8_codes=packed and int8_codes,
                       blocks=blocks,
                       conv=conv_gather(tuple(x.shape), _ints(kernel_shape),
                                        _ints(strides), _ints(pads),
                                        _ints(dilations)))
    patches, (oh, ow) = extract_patches(x, kernel_shape, strides, pads,
                                        dilations)
    mm = quant_matmul_int4 if packed else quant_matmul
    y = mm(patches, w2, w_scale, bias, acc_dtype=acc_dtype, requant=requant,
           in_scale=in_scale, int8_codes=int8_codes, blocks=blocks)
    return y.reshape(x.shape[0], oh, ow, y.shape[-1]).permute(0, 3, 1, 2) \
        .contiguous()
