"""B5 / B6: grouped and depthwise quantized convolution as CUDA kernels.

Replaces ``repro/kernels/quant_grouped_conv.py`` · ``quant_grouped_matmul``
(Pallas body ``_gqmm_kernel``, B5) and ``quant_depthwise_conv2d``
(``_dw_kernel``, B6).  CUDA source: ``csrc/quant_grouped_conv.cu``.

The dense im2col path (``quant_conv``) lowers a ``group = g`` conv through
a block-diagonal carrier that pays g× the true I/g·kH·kW contraction.
These kernels do the true contraction:

  * **B5** ``quant_grouped_matmul`` — out[g] = (xg[g] @ wg[g]) · s[g]
    [+ b[g]] for moderate group counts, int8 or per-group packed int4
    weights.  ``quant_grouped_conv2d`` feeds it the im2col matrix as a
    (G, M, Kg) view (channel is the slowest feature, so group g's columns
    are one contiguous slice) and receives the (M, G·Ng) output matrix
    directly: neither of the reference's transposes is materialized.
  * **B6** ``quant_depthwise_conv2d`` — the ``group == C`` case: a
    per-channel kH·kW tap sum, then dequant, bias, ReLU and the activation
    requant fused (the requant is B4's rounding, shared through
    ``csrc/qdq_round.cuh``).  The kernel stages the NCHW input into shared
    memory tile by tile; only the plain twin builds the reference's
    (T, M, C) tap tensor.

Both have B1's three bodies (``quant_matmul``): the float32 dot, the
int32 dot with the float32 epilogue (``acc_dtype=torch.int32``), and the
int32 dot with the integer epilogue B3 (``requant=IntRequant``, the scale
slot carrying int32 multipliers); on the integer bodies x is staged as
``x / in_scale`` rounded, with the IEEE division's bits, by B2's staging
(``quant_matmul.staging``: a reciprocal multiply at a power-of-two scale,
else an exact-quotient check, else the division); ``staging_launches``
counts the integer launches per kernel and staging mode.  On B6's B3 body
the IntRequant replaces the whole fused epilogue, as in the reference's
``_dw_kernel``: bias, ``relu`` and ``act_*`` must then be left unset.

Both are bound by bytes on the card (2–4 operations per byte), so their
geometry is planned on the host from the shapes alone: ``dw_launch_plan``
(B6's tiles, planes per block, staged window, shared-memory pitches and
grid) and ``gqmm_launch_plan`` (B5's column tile, K slice and pitch).
The CUDA launches take their geometry from these plans and nothing else,
so the CPU tests can hold it (coverage, halo reads, limits).

Layouts and signatures are the reference's: NCHW in and out, (G, M, Kg) /
(G, Kg[/2], Ng) for B5, taps (kH·kW, C) for B6.  On CPU tensors the
wrappers run the plain twins (``*_plain``); on CUDA tensors they launch
the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ._build import SMEM_MAX, SMS, check, load
from .quant_conv import conv_tap_slices, conv_out_hw, extract_patches
from .quant_dequant import ROUNDING_MODE_IDS, quant_dequant_plain, static_bounds
from .quant_matmul import (STAGING_MODES, check_epilogue, epilogue_args,
                           int_values, pack_int4, plain_epilogue, staging,
                           unpack_int4)

launches = {"quant_grouped_matmul": 0, "quant_depthwise_conv2d": 0}
# the integer-body launches of each kernel per staging mode of x
staging_launches = {k: dict.fromkeys(STAGING_MODES, 0) for k in launches}



# --------------------------------------------------- weight-layout helpers

def grouped_weights(w, groups: int) -> np.ndarray:
    """Conv weights (O, I/g, kH, kW) -> per-group carrier (G, Kg, Ng).

    Group ``gi``'s slice is the (I/g·kH·kW, O/g) operand of that group
    alone; rows are (c, kh, kw) with the channel slowest, as
    ``extract_patches`` orders its features."""
    w = np.asarray(w)
    o, ipg, kh, kw = w.shape
    if o % groups:
        raise ValueError(f"output channels {o} not divisible by groups {groups}")
    wm = w.reshape(groups, o // groups, ipg * kh * kw)
    return np.ascontiguousarray(np.transpose(wm, (0, 2, 1)))


def depthwise_weights(w) -> np.ndarray:
    """Depthwise conv weights (C, 1, kH, kW) -> tap matrix (kH·kW, C),
    taps in (kh, kw) row-major order."""
    w = np.asarray(w)
    c, one, kh, kw = w.shape
    if one != 1:
        raise ValueError(f"depthwise weights need I/g == 1, got {one}")
    return np.ascontiguousarray(w.reshape(c, kh * kw).T)


def pack_int4_grouped(wg: torch.Tensor) -> torch.Tensor:
    """(G, Kg, Ng) int4-valued int8 -> (G, Kg//2, Ng) int8 carriers: packed
    row r of each group holds its rows 2r (low nibble) and 2r+1 (high)."""
    wg = torch.as_tensor(wg)
    g, kg, ng = wg.shape
    if kg % 2:
        raise ValueError("per-group K must be even for int4 packing")
    # with Kg even no nibble pair straddles two groups
    return pack_int4(wg.reshape(g * kg, ng)).reshape(g, kg // 2, ng)


def unpack_int4_grouped(wg_packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4_grouped``: (G, Kg//2, Ng) -> (G, Kg, Ng)."""
    g, k2, ng = wg_packed.shape
    return unpack_int4(wg_packed.reshape(g * k2, ng)).reshape(g, 2 * k2, ng)


def extract_depthwise_taps(x: torch.Tensor, kernel_shape, strides=(1, 1),
                           pads=(0, 0, 0, 0), dilations=(1, 1)):
    """Unfold NCHW ``x`` into per-tap channel-minor slices: returns
    ``(taps, (OH, OW))`` with taps (kH·kW, N·OH·OW, C).  Used by the plain
    twin only; the kernel reads its taps from ``x`` itself."""
    n, c = x.shape[:2]
    taps, (oh, ow) = conv_tap_slices(x, kernel_shape, strides, pads,
                                     dilations)
    p = torch.stack(taps, dim=0).permute(0, 1, 3, 4, 2)    # (T, N, OH, OW, C)
    return p.reshape(len(taps), n * oh * ow, c), (oh, ow)


def _check_device(name: str, x: torch.Tensor, *others) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: every operand must lie on {x.device}")


def _channel_vec(p, n: int, device, name: str, what: str) -> torch.Tensor:
    """A scale as a contiguous float32 (1,) or (n,) vector."""
    v = torch.as_tensor(p, dtype=torch.float32, device=device).reshape(-1)
    if v.numel() not in (1, n):
        raise ValueError(f"{name}: {what} must be a scalar or ({n},)")
    return v.contiguous()


def _bias_vec(bias, n: int, name: str) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    b = bias.reshape(-1)
    if b.dtype != torch.float32 or b.numel() != n or not b.is_contiguous():
        raise ValueError(f"{name}: bias must be a contiguous float32 ({n},)")
    return b


# ------------------------------------------------- B5: per-group matmul

def quant_grouped_matmul_plain(xg, wg, w_scale, bias=None, *,
                               packed=False, acc_dtype=torch.float32,
                               requant=None, in_scale=None) -> torch.Tensor:
    """Plain twin of B5: the per-group float32 product (or the exact
    integer one), then the epilogue, then the bias."""
    check_epilogue("quant_grouped_matmul", acc_dtype, requant, in_scale)
    g, ng = wg.shape[0], wg.shape[2]
    w = unpack_int4_grouped(wg) if packed else wg
    if acc_dtype == torch.int32:
        acc = torch.matmul(int_values(xg, in_scale), w.to(torch.float64))
    else:
        acc = torch.matmul(xg.to(torch.float32), w.to(torch.float32))
    return plain_epilogue(acc, w_scale, bias, acc_dtype, requant, (g, 1, ng))


GQ_BM = 128                    # B5's rows per block, one per thread
GQ_KS_MAX = 128                # B5's largest K slice staged at once
GQ_GEO_FIELDS = ("G", "M", "Kg", "Ng", "BN", "KS", "pitch", "vec", "ovec",
                 "col_tiles", "smem_bytes")


@dataclass(frozen=True)
class GqPlan:
    """B5's launch geometry, in the order of the kernel's ``GqGeo``: block
    columns ``BN`` (8, 16 or 32; ``col_tiles`` of them cover Ng), the K
    slice ``KS`` staged at once (a multiple of 4, zero-filled past Kg), the
    shared row pitch, whether x rows go by 16-byte copies (``vec``) and
    outputs by 16-byte stores (``ovec``), and the dynamic shared bytes;
    ``grid`` = (M / GQ_BM blocks, col_tiles, G), GQ_BM threads each."""
    G: int
    M: int
    Kg: int
    Ng: int
    BN: int
    KS: int
    pitch: int
    vec: int
    ovec: int
    col_tiles: int
    smem_bytes: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return (-(-self.M // GQ_BM), self.col_tiles, self.G)

    @functools.cached_property
    def ints(self):
        """The C interface's geometry array (built once per plan)."""
        return (ctypes.c_int * len(GQ_GEO_FIELDS))(
            *(getattr(self, f) for f in GQ_GEO_FIELDS))


GQ_BNS = (8, 16, 32)           # B5's block columns (template instances)


@functools.lru_cache(maxsize=1024)
def gqmm_launch_plan(G: int, M: int, Kg: int, Ng: int, x_vec: bool = True,
                     o_vec: bool = True, override=None) -> GqPlan:
    """B5's geometry for a (G, M, Kg) x (G, Kg, Ng) product.  ``x_vec``:
    Kg % 4 == 0 and x's pointer, group and row strides on 16 bytes (the
    caller checks the strides); ``o_vec`` likewise for the output.

    ``override``: ``(BN, KS)`` (``gqmm_blocks``) in place of the
    heuristic's (the smallest BN that holds Ng, the whole of Kg up to
    GQ_KS_MAX), as the autotuner gives them; BN outside ``GQ_BNS`` or a
    slice that is not a multiple of 4 in 4 .. min(GQ_KS_MAX, Kg rounded up
    to 4) raises ``ValueError``."""
    ks_most = min(max(4, -(-Kg // 4) * 4), GQ_KS_MAX)
    if override is None:
        bn = 8 if Ng <= 8 else (16 if Ng <= 16 else 32)
        ks = ks_most
    else:
        bn, ks = (int(v) for v in override)
        if bn not in GQ_BNS or ks % 4 or not 4 <= ks <= ks_most:
            raise ValueError(f"quant_grouped_matmul: override {tuple(override)} is "
                             f"not (BN of {GQ_BNS}, a K slice of 4 .. {ks_most} "
                             "in steps of 4)")
    # a pitch of 4·odd words keeps eight lanes' 16-byte row reads on
    # distinct banks
    pitch = ks + (4 if (ks // 4) % 2 == 0 else 8)
    plan = GqPlan(G, M, Kg, Ng, bn, ks, pitch, int(x_vec and Kg % 4 == 0),
                  int(o_vec), -(-Ng // bn), 4 * (GQ_BM * pitch + ks * bn))
    gx, gy, gz = plan.grid
    if gx >= 2 ** 31 or gy > 65535 or gz > 65535:
        raise ValueError(f"quant_grouped_matmul: grid {plan.grid} beyond the "
                         "launch limits")
    if plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"quant_grouped_matmul: {plan.smem_bytes} bytes of shared "
                         f"memory (at most {SMEM_MAX})")
    return plan


def gqmm_blocks(plan: GqPlan) -> tuple[int, int]:
    """The choices of a plan, as ``gqmm_launch_plan``'s ``override`` takes
    them: ``(BN, KS)``."""
    return (plan.BN, plan.KS)


def _vec_ok(t: torch.Tensor, *strides) -> bool:
    return t.data_ptr() % 16 == 0 and all(int(v) % 4 == 0 for v in strides)


def _counted(name: str, epi: int, mode: int) -> None:
    """One launch of ``name`` done: its count and, on an integer body, its
    staging mode's."""
    launches[name] += 1
    if epi != 0:
        staging_launches[name][STAGING_MODES[mode]] += 1


def quant_grouped_matmul(xg: torch.Tensor, wg: torch.Tensor, w_scale,
                         bias: Optional[torch.Tensor] = None, *,
                         packed: bool = False, acc_dtype=torch.float32,
                         requant=None, in_scale=None,
                         int8_codes: bool = False,
                         blocks=None) -> torch.Tensor:
    """Per-group integer matmul: out[g] = (xg[g] @ wg[g]) · s[g] [+ b[g]].

    xg: (G, M, Kg) float32, any group / row strides with unit stride along
        Kg (a view of an im2col matrix is taken as it is);
    wg: (G, Kg, Ng) int8, or its per-group int4 packing (G, Kg//2, Ng)
        when ``packed``;
    w_scale: scalar or (G·Ng,) group-major per-output-channel scale;
    bias: optional (G·Ng,) float32, added after the epilogue;
    acc_dtype / requant / in_scale: the body, as ``quant_matmul``'s;
    int8_codes is accepted (the lowering passes it to every body) and B5
        keeps its body on the CUDA cores: at 3–4 operations per byte of x
        it is bound by bytes, where the int8 tensor cores gain nothing;
    blocks: the launch plan's override (``gqmm_blocks``), None for the
        heuristic; the twin ignores it.
    Returns (G, M, Ng) float32.  On CUDA its memory is laid out (M, G, Ng),
    so ``out.permute(1, 0, 2).reshape(M, G·Ng)`` is a view."""
    name = "quant_grouped_matmul"
    if xg.ndim != 3 or wg.ndim != 3 or xg.shape[0] != wg.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(xg.shape)} and "
                         f"{tuple(wg.shape)} are not (G, M, Kg), (G, Kg, Ng)")
    g, m, kg = xg.shape
    ng = wg.shape[2]
    if kg != (2 * wg.shape[1] if packed else wg.shape[1]):
        raise ValueError(f"{name}: Kg mismatch {tuple(xg.shape)} @ "
                         f"{'packed ' if packed else ''}{tuple(wg.shape)}")
    kw = dict(acc_dtype=acc_dtype, requant=requant, in_scale=in_scale)
    if xg.device.type == "cpu":
        return quant_grouped_matmul_plain(xg, wg, w_scale, bias,
                                          packed=packed, **kw)
    _check_device(name, xg, wg, bias)
    if xg.dtype != torch.float32 or (kg > 1 and xg.stride(2) != 1):
        raise ValueError(f"{name}: xg must be float32 with unit stride "
                         "along Kg")
    if wg.dtype != torch.int8 or not wg.is_contiguous():
        raise ValueError(f"{name}: weights must be a contiguous int8 tensor")
    epi, s, _, rq, out_mul = epilogue_args(name, w_scale=w_scale,
                                           n=g * ng, device=xg.device, **kw)
    b = _bias_vec(bias, g * ng, name)
    out = torch.empty((m, g, ng), dtype=torch.float32,
                      device=xg.device).permute(1, 0, 2)
    plan = gqmm_launch_plan(g, m, kg, ng,
                            _vec_ok(xg, xg.stride(0), xg.stride(1)),
                            _vec_ok(out, out.stride(0), out.stride(1)),
                            None if blocks is None else tuple(blocks))
    mode, div, mul = staging(in_scale)
    err = load().gqmm_launch(
        xg.data_ptr(), wg.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), plan.ints,
        xg.stride(0), xg.stride(1), out.stride(0), out.stride(1),
        int(s.numel() > 1), int(packed), epi, div, mul, mode, rq, out_mul,
        torch.cuda.current_stream(xg.device).cuda_stream)
    check(err, "gqmm_launch")
    _counted(name, epi, mode)
    return out


def quant_grouped_conv2d(x: torch.Tensor, wg: torch.Tensor, w_scale,
                         bias: Optional[torch.Tensor] = None, *, groups: int,
                         kernel_shape, strides=(1, 1), pads=(0, 0, 0, 0),
                         dilations=(1, 1), packed: bool = False,
                         acc_dtype=torch.float32, requant=None,
                         in_scale=None, int8_codes: bool = False,
                         blocks=None) -> torch.Tensor:
    """Fused grouped quantized conv: per-group im2col onto B5.

    x      — (N, C, H, W) activations (cast to float32)
    wg     — (G, Kg, Ng) int8 with Kg = (C/G)·kH·kW and Ng = O/G, or the
             per-group int4 packing (G, Kg//2, Ng) when ``packed``
    w_scale — scalar or group-major per-output-channel (O,)
    bias   — optional (O,) float32
    acc_dtype / requant / in_scale / int8_codes — B5's body
             (``quant_grouped_matmul``)
    blocks — B5's launch-plan override (``quant_grouped_matmul``)
    Returns (N, O, OH, OW) float32, contiguous."""
    x = x.to(torch.float32)
    patches, (oh, ow) = extract_patches(x, kernel_shape, strides, pads,
                                        dilations)
    m, feat = patches.shape
    kg = feat // groups
    # channel is the slowest feature, so group gi's columns are the slice
    # [gi·Kg, (gi+1)·Kg): a strided view, no copy
    xg = patches.view(m, groups, kg).permute(1, 0, 2)
    y = quant_grouped_matmul(xg, wg, w_scale, bias, packed=packed,
                             acc_dtype=acc_dtype, requant=requant,
                             in_scale=in_scale, blocks=blocks)
    o = groups * y.shape[-1]
    y = y.permute(1, 0, 2).reshape(m, o)
    return y.reshape(x.shape[0], oh, ow, o).permute(0, 3, 1, 2).contiguous()


# ------------------------------------------------ B6: depthwise tap-reduce

def quant_depthwise_conv2d_plain(x, w_taps, w_scale, bias=None,
                                 act_scale=None, act_zero_point=None, *,
                                 kernel_shape, strides=(1, 1),
                                 pads=(0, 0, 0, 0), dilations=(1, 1),
                                 relu=False, act_bits=None, act_signed=True,
                                 act_narrow=False, act_rounding="ROUND",
                                 acc_dtype=torch.float32, requant=None,
                                 in_scale=None) -> torch.Tensor:
    """Plain twin of B6: the kernel's arithmetic in the kernel's order (taps
    summed one by one in (kh, kw) order, products rounded apart), so the
    two agree bit for bit on any input; the integer sums are exact in
    float64, in any order."""
    _check_dw_epilogue(bias, relu, act_bits, acc_dtype, requant, in_scale)
    x = x.to(torch.float32)
    taps, (oh, ow) = extract_depthwise_taps(x, kernel_shape, strides, pads,
                                            dilations)
    c = taps.shape[2]
    if acc_dtype == torch.int32:
        acc = (int_values(taps, in_scale)
               * w_taps.to(torch.float64)[:, None, :]).sum(0)
    else:
        w = w_taps.to(torch.float32)
        acc = torch.zeros(taps.shape[1:], dtype=torch.float32,
                          device=x.device)
        for t in range(taps.shape[0]):
            acc = acc + taps[t] * w[t]
    y = plain_epilogue(acc, w_scale, bias, acc_dtype, requant, (-1,))
    if relu:
        y = torch.relu(y)
    if act_bits is not None:
        y = quant_dequant_plain(y, act_scale, act_zero_point,
                                bit_width=act_bits, signed=act_signed,
                                narrow=act_narrow, rounding_mode=act_rounding)
    return y.reshape(x.shape[0], oh, ow, c).permute(0, 3, 1, 2).contiguous()


def _check_dw_epilogue(bias, relu, act_bits, acc_dtype, requant,
                       in_scale) -> None:
    name = "quant_depthwise_conv2d"
    check_epilogue(name, acc_dtype, requant, in_scale)
    if requant is not None and (bias is not None or relu or
                                act_bits is not None):
        raise ValueError(f"{name}: with requant= the IntRequant carries the "
                         "epilogue; bias, relu and act_* must be unset")


DW_ROWS_PER_THREAD = (4, 7)    # outputs down a column per thread (templates)
DW_MAX_THREADS = 256            # the kernel's launch bound (DW_MAX_THREADS, 4)
DW_FLAT_MAX = 1024             # whole planes per block up to this many outputs
DW_GEO_FIELDS = ("N", "C", "H", "W", "OH", "OW", "kh", "kw", "sh", "sw",
                 "pt", "pl", "dh", "dw", "planes", "tile_h", "tile_w",
                 "rows_per_thread", "row_groups", "tiles_h", "tiles_w",
                 "rows", "cols", "pitch", "plane_pitch", "vec", "flat",
                 "buffer", "threads", "blocks", "smem_bytes", "fast")


@dataclass(frozen=True)
class DwPlan:
    """B6's launch geometry, in the order of the kernel's ``DwGeo``.

    A block owns ``planes`` consecutive (n, c) planes (``flat``: whole
    planes, copied as one contiguous span and read as they lie, pitch W and
    plane pitch H·W, the padding read as zeros by predicate) or a
    ``tile_h`` x ``tile_w`` output tile of one plane (``tiles_h`` x
    ``tiles_w`` tiles a plane), whose staged input window of ``rows`` x
    ``cols`` holds its zero padding at pitch ``pitch`` (elements); with
    ``vec`` the window's first column is floored to 16 bytes and rows go
    by 16-byte copies.  In either mode staged (r, c) is input row r0 + r,
    column c0 + c of the block (``window_origin``).  Shared memory holds
    ``buffer`` elements.  ``threads`` = planes x ``row_groups`` x tile_w
    (rounded up to a warp) each compute ``rows_per_thread`` outputs down
    one column; ``fast`` 1 / 2 marks a 3x3 kernel at row stride 1 / 2
    (row dilation 1), 0 any other.  The grid is ``blocks`` x 1 x 1.
    """
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
    pt: int
    pl: int
    dh: int
    dw: int
    planes: int
    tile_h: int
    tile_w: int
    rows_per_thread: int
    row_groups: int
    tiles_h: int
    tiles_w: int
    rows: int
    cols: int
    pitch: int
    plane_pitch: int
    vec: int
    flat: int
    buffer: int
    threads: int
    blocks: int
    smem_bytes: int
    fast: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.blocks, 1, 1)

    @functools.cached_property
    def ints(self):
        """The C interface's geometry array (built once per plan)."""
        return (ctypes.c_int * len(DW_GEO_FIELDS))(
            *(getattr(self, f) for f in DW_GEO_FIELDS))

    def block_origin(self, b: int) -> tuple[int, int, int, int]:
        """(first plane, planes, first output row, first output column) of
        block ``b``, as the kernel derives them."""
        nc = self.N * self.C
        if self.flat:
            return b * self.planes, min(self.planes, nc - b * self.planes), 0, 0
        tiles = self.tiles_h * self.tiles_w
        t = b % tiles
        return (b // tiles, 1, t // self.tiles_w * self.tile_h,
                t % self.tiles_w * self.tile_w)

    def window_origin(self, oh0: int, ow0: int) -> tuple[int, int, int]:
        """(input row, input column) of window element (0, 0) and the window
        column of the tile's first tap column (the 16-byte floor)."""
        r0 = oh0 * self.sh - self.pt
        c0 = ow0 * self.sw - self.pl
        off = c0 & 3 if self.vec and not self.flat else 0
        return r0, c0 - off, off


def _bank_ways(addr: np.ndarray) -> int:
    """Shared-memory wavefronts of one 4-byte read by every warp: per warp,
    the most distinct words that fall on one of the 32 banks."""
    a = np.concatenate([addr, np.full((-len(addr)) % 32, addr[-1])])
    a = np.sort(a.reshape(-1, 32), axis=1)
    distinct = np.ones(a.shape, bool)
    distinct[:, 1:] = a[:, 1:] != a[:, :-1]
    banks = a % 32 + 32 * np.arange(a.shape[0])[:, None]
    per_bank = np.bincount(banks[distinct], minlength=a.size).reshape(-1, 32)
    return int(per_bank.max(axis=1).sum())


def _dw_pitches(RG, TW, R, sh, sw, cols, step) -> int:
    """The tile pitch (a multiple of ``step``) that spreads a warp's first
    tap read over the banks (ties: the smallest)."""
    t = np.arange(RG * TW)
    rg, col = t // TW, t % TW
    base = -(-cols // step) * step
    ways = {pitch: _bank_ways(rg * R * sh * pitch + col * sw)
            for pitch in range(base, base + 32, step)}
    return min(ways, key=lambda pitch: (ways[pitch], pitch))


def _dw_cost(blocks, staged, slots, vec) -> float:
    """A relative time: each block's fixed cost, its staged elements (half
    price by 16-byte copies) and computed output slots, with a penalty
    when the grid gives an SM fewer than eight blocks."""
    per = 256 + staged * (0.5 if vec else 1.0) + slots
    return blocks * per * max(1.0, 8 * SMS / blocks)


def _dw_candidates(N, C, H, W, OH, OW, kh, kw, sh, sw, dh, dw, aligned,
                   any_batch=False):
    """Every geometry ``dw_launch_plan`` weighs, in its order, as ``(cost,
    fields)``: whole planes, several per block, where a plane has at most
    DW_FLAT_MAX outputs, OW <= 32 and the plane fits shared memory
    (MobileNet's 28x28, 14x14 and 7x7 maps); else 2-D tiles whose width
    divides OW into nearly equal parts (or 8 / 16 / 32); each with 4 or 7
    rows per thread.  ``any_batch``: planes per block up to the threads'
    limit, not also up to N·C (a block may then hold fewer planes than its
    share: the kernel clamps), so that the set does not depend on N."""
    nc = N * C
    span = (kh - 1) * dh + 1
    flat_ok = OW <= 32 and OH * OW <= DW_FLAT_MAX and 4 * (H * W + 3) <= SMEM_MAX
    for R in DW_ROWS_PER_THREAD:
        if flat_ok:
            RG = -(-OH // R)
            rows = (RG * R - 1) * sh + span
            cols = (OW - 1) * sw + (kw - 1) * dw + 1
            most = DW_MAX_THREADS // (RG * OW)
            for P in range(1, (most if any_batch else min(nc, most)) + 1):
                if 4 * (P * H * W + 3) > SMEM_MAX:
                    break
                blocks = -(-nc // P)
                vec = int(aligned and (P * H * W) % 4 == 0)
                yield (_dw_cost(blocks, P * H * W, P * RG * OW * R, vec),
                       dict(planes=P, tile_h=OH, tile_w=OW, rows_per_thread=R,
                            row_groups=RG, tiles_h=1, tiles_w=1, rows=rows,
                            cols=cols, flat=1, blocks=blocks, vec=vec))
            continue
        vec = int(aligned and W % 4 == 0)
        widths = {-(-OW // k) for k in range(1, OW + 1)}
        widths = sorted(w_ for w_ in widths | {8, 16, 32}
                        if 8 <= w_ <= 32 or w_ == OW <= 32)
        for TW in widths:
            cols = (TW - 1) * sw + (kw - 1) * dw + 1
            if vec:
                cols = -(-(cols + 3) // 4) * 4
            tiles_w = -(-OW // TW)
            for RG in range(1, DW_MAX_THREADS // TW + 1):
                TH = RG * R
                if TH > -(-OH // R) * R:
                    break
                rows = (TH - 1) * sh + span
                if 4 * rows * (cols + 32) > SMEM_MAX:
                    break
                tiles_h = -(-OH // TH)
                blocks = nc * tiles_h * tiles_w
                yield (_dw_cost(blocks, rows * cols, TH * TW, vec),
                       dict(planes=1, tile_h=TH, tile_w=TW, rows_per_thread=R,
                            row_groups=RG, tiles_h=tiles_h, tiles_w=tiles_w,
                            rows=rows, cols=cols, flat=0, blocks=blocks,
                            vec=vec))


def _dw_key(g: dict) -> tuple[int, int, int, int]:
    """A candidate's choices: ``(flat, planes or tile width, rows per
    thread, row groups)``."""
    return (g["flat"], g["planes"] if g["flat"] else g["tile_w"],
            g["rows_per_thread"], g["row_groups"])


def _dw_args(strides, dilations, pads):
    (sh, sw), (dh, dw) = ((int(a), int(b)) for a, b in (strides, dilations))
    return sh, sw, dh, dw, int(pads[0]), int(pads[1])


def dw_block_candidates(N: int, C: int, H: int, W: int, OH: int, OW: int,
                        kh: int, kw: int, strides=(1, 1), dilations=(1, 1),
                        pads=(0, 0, 0, 0), aligned: bool = True) -> list:
    """``(cost, blocks)`` for every geometry B6's plan weighs at this shape,
    cheapest first by the plan's ``_dw_cost`` (``blocks`` as
    ``dw_launch_plan``'s ``override`` takes them).  Each is legal at any
    batch."""
    sh, sw, dh, dw, _, _ = _dw_args(strides, dilations, pads)
    out = [(cost, _dw_key(g)) for cost, g in _dw_candidates(
        N, C, H, W, OH, OW, kh, kw, sh, sw, dh, dw, aligned, any_batch=True)]
    return sorted(out, key=lambda t: t[0])


@functools.lru_cache(maxsize=1024)
def dw_launch_plan(N: int, C: int, H: int, W: int, OH: int, OW: int, kh: int,
                   kw: int, strides=(1, 1), dilations=(1, 1),
                   pads=(0, 0, 0, 0), aligned: bool = True,
                   override=None) -> DwPlan:
    """B6's geometry for an (N, C, H, W) -> (N, C, OH, OW) depthwise conv
    with ONNX [t, l, b, r] ``pads``; ``aligned``: x's pointer is on 16
    bytes.  Of the candidates ``_dw_candidates`` gives, the cheapest by
    ``_dw_cost`` wins; a tile's pitch then comes from ``_dw_pitches``.

    ``override``: ``(flat, planes or tile width, rows per thread, row
    groups)`` (``dw_blocks``, ``dw_block_candidates``), as the autotuner
    gives them, in place of the cheapest; one that is no candidate of this
    shape at any batch raises ``ValueError``."""
    sh, sw, dh, dw, pt, pl = _dw_args(strides, dilations, pads)
    nc = N * C
    if nc <= 0 or OH <= 0 or OW <= 0:
        raise ValueError("quant_depthwise_conv2d: empty launch")
    fast = sh if (kh, kw, dh) == (3, 3, 1) and sh in (1, 2) else 0
    cands = _dw_candidates(N, C, H, W, OH, OW, kh, kw, sh, sw, dh, dw, aligned,
                           any_batch=override is not None)
    if override is None:
        best = min(cands, key=lambda t: t[0], default=None)
        if best is None:
            raise ValueError(f"quant_depthwise_conv2d: no tile of a {H}x{W} plane "
                             f"fits {SMEM_MAX} bytes of shared memory")
        g = best[1]
    else:
        want = tuple(int(v) for v in override)
        g = next((g for _, g in cands if _dw_key(g) == want), None)
        if g is None:
            raise ValueError(f"quant_depthwise_conv2d: override {want} is no "
                             f"candidate of a {H}x{W} -> {OH}x{OW} plane")
    P, RG, TW, R = g["planes"], g["row_groups"], g["tile_w"], g["rows_per_thread"]
    if g["flat"]:
        pitch, plane_pitch = W, H * W
    else:
        pitch = _dw_pitches(RG, TW, R, sh, sw, g["cols"], 4 if g["vec"] else 1)
        plane_pitch = g["rows"] * pitch
    buffer = -(-(P * plane_pitch) // 4) * 4
    smem = 4 * buffer
    if smem > SMEM_MAX:
        raise ValueError(f"quant_depthwise_conv2d: a {H}x{W} plane needs "
                         f"{smem} bytes of shared memory (at most {SMEM_MAX})")
    if g["blocks"] >= 2 ** 31:
        raise ValueError("quant_depthwise_conv2d: too many blocks")
    threads = -(-(P * RG * TW) // 32) * 32
    return DwPlan(N, C, H, W, OH, OW, kh, kw, sh, sw, pt, pl, dh, dw,
                  threads=threads, pitch=pitch, plane_pitch=plane_pitch,
                  buffer=buffer, smem_bytes=smem, fast=fast, **g)


def dw_blocks(plan: DwPlan) -> tuple[int, int, int, int]:
    """The choices of a plan, as ``dw_launch_plan``'s ``override`` takes
    them: ``(flat, planes or tile width, rows per thread, row groups)``."""
    return (plan.flat, plan.planes if plan.flat else plan.tile_w,
            plan.rows_per_thread, plan.row_groups)


def quant_depthwise_conv2d(x: torch.Tensor, w_taps: torch.Tensor, w_scale,
                           bias: Optional[torch.Tensor] = None,
                           act_scale=None, act_zero_point=None, *,
                           kernel_shape, strides=(1, 1), pads=(0, 0, 0, 0),
                           dilations=(1, 1), relu: bool = False,
                           act_bits=None, act_signed: bool = True,
                           act_narrow: bool = False,
                           act_rounding: str = "ROUND",
                           acc_dtype=torch.float32, requant=None,
                           in_scale=None, int8_codes: bool = False,
                           blocks=None) -> torch.Tensor:
    """Fused depthwise quantized conv (``group == C``, multiplier 1).

    x          — (N, C, H, W) activations (float32; contiguous on CUDA)
    w_taps     — (kH·kW, C) int8 tap matrix (``depthwise_weights``)
    w_scale    — per-channel dequant scale, scalar or (C,)
    bias       — optional (C,) float32
    relu       — max(0, ·) between dequant and requant
    act_*      — optional per-tensor activation requant (the trailing Quant
                 of Conv -> Relu -> Quant): ``act_bits`` None disables it;
                 ``act_scale`` / ``act_zero_point`` are one-element tensors
                 or scalars; rounding and bounds are B4's.
    acc_dtype / requant / in_scale — the body, as ``quant_matmul``'s; with
                 ``requant`` the IntRequant is the whole epilogue.
    int8_codes — accepted (the lowering passes it to every body); B6
                 keeps its body on the CUDA cores: at ~2 operations per
                 byte it is bound by bytes, where the int8 tensor cores
                 gain nothing.
    blocks     — the launch plan's override (``dw_blocks``), None for the
                 heuristic; the twin ignores it.
    Returns (N, C, OH, OW) float32."""
    name = "quant_depthwise_conv2d"
    mode = act_rounding.upper()
    if mode not in ROUNDING_MODE_IDS:
        raise ValueError(f"unknown rounding_mode {act_rounding!r}")
    if x.ndim != 4 or w_taps.ndim != 2 or w_taps.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and taps "
                         f"{tuple(w_taps.shape)} are not (N, C, H, W), "
                         "(kH·kW, C)")
    kh, kw = (int(v) for v in kernel_shape)
    if w_taps.shape[0] != kh * kw:
        raise ValueError(f"{name}: {w_taps.shape[0]} taps for a {kh}x{kw} "
                         "kernel")
    body = dict(acc_dtype=acc_dtype, requant=requant, in_scale=in_scale)
    kw_args = dict(kernel_shape=kernel_shape, strides=strides, pads=pads,
                   dilations=dilations, relu=relu, act_bits=act_bits,
                   act_signed=act_signed, act_narrow=act_narrow,
                   act_rounding=mode, **body)
    if x.device.type == "cpu":
        return quant_depthwise_conv2d_plain(x, w_taps, w_scale, bias,
                                            act_scale, act_zero_point,
                                            **kw_args)
    _check_device(name, x, w_taps, bias)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32 tensor")
    if w_taps.dtype != torch.int8 or not w_taps.is_contiguous():
        raise ValueError(f"{name}: taps must be a contiguous int8 tensor")
    _check_dw_epilogue(bias, relu, act_bits, **body)
    n, c, h, w = x.shape
    oh, ow = conv_out_hw(h, w, kernel_shape, strides, pads, dilations)
    epi, s, _, rq, out_mul = epilogue_args(name, w_scale=w_scale, n=c,
                                           device=x.device, **body)
    b = _bias_vec(bias, c, name)
    qs = qz = None
    lo = hi = 0.0
    if act_bits is not None:
        qs = _channel_vec(act_scale, 1, x.device, name, "act_scale")
        qz = _channel_vec(act_zero_point, 1, x.device, name, "act_zero_point")
        lo, hi = static_bounds(act_signed, act_narrow, act_bits)
    out = torch.empty((n, c, max(oh, 0), max(ow, 0)), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    plan = dw_launch_plan(n, c, h, w, oh, ow, kh, kw,
                          *(tuple(int(v) for v in t)
                            for t in (strides, dilations, pads)),
                          x.data_ptr() % 16 == 0,
                          None if blocks is None else tuple(blocks))
    mode_s, div, mul = staging(in_scale)
    err = load().dw_launch(
        x.data_ptr(), w_taps.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(),
        None if qs is None else qs.data_ptr(),
        None if qz is None else qz.data_ptr(), out.data_ptr(), plan.ints,
        int(s.numel() > 1), int(relu), int(act_bits is not None), lo, hi,
        ROUNDING_MODE_IDS[mode], epi, div, mul, mode_s, rq, out_mul,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "dw_launch")
    _counted(name, epi, mode_s)
    return out
