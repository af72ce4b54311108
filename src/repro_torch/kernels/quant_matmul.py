"""B1 / B2: weight-quantized matmuls as CUDA kernels.

Replaces ``repro/kernels/quant_matmul.py`` · ``quant_matmul`` (Pallas body
``_qmm_kernel``, B1: int8 weights (K, N)) and ``quant_matmul_int4``
(``_qmm4_kernel``, B2: int4 weights packed two per byte along K, (K/2, N),
row 2r in the low nibble and 2r+1 in the high nibble).  CUDA source:
``csrc/quant_matmul.cu``.

    out = (x @ w_int) * w_scale  [+ bias]

x (M, K) float32; w_scale a scalar or (N,); bias (N,) or None.  The
accumulator is float32 and the dot a true float32 one (no TF32), the
scale is applied once after the K loop, and the bias is added to the
rounded product, as in the reference.

Bound on the card: at the TFC shapes (M <= 256, (K, N) in {(784, 64),
(64, 64), (64, 10)}) the 784-wide layer is bound by the float32 FMA rate
(2·M·K·N operations at 67 TFLOP/s) and the narrow layers by the bytes of
x and the output.  Design: each block owns a 32x32 output tile and loops
over K itself; the weight tile is staged in shared memory, and B2 unpacks
the nibbles while staging, so device memory serves only the packed
bytes.  Ragged edges are masked, with no padding copies.

On CPU tensors the wrappers run the plain twins (``*_plain``); on CUDA
tensors they launch the kernel or raise.  The int32 accumulator and the
integer requant epilogue (``acc_dtype=torch.int32``, ``requant=``) arrive
with the analysis tier (ROADMAP.md, A7/A8 and B3).
"""
from __future__ import annotations

from typing import Optional

import torch

from ._build import check, load

launches = {"quant_matmul": 0, "quant_matmul_int4": 0}


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued int8 -> (K//2, N) int8 carriers: packed row r
    holds rows 2r (low nibble) and 2r+1 (high nibble)."""
    if w_int.shape[0] % 2:
        raise ValueError("K must be even for int4 packing")
    lo = w_int[0::2].to(torch.int32) & 0xF
    hi = w_int[1::2].to(torch.int32) & 0xF
    byte = (hi << 4) | lo                               # 0 .. 255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed int8 -> (K, N) sign-extended int4 values in int8."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(w_packed, 4), 4)
    hi = torch.bitwise_right_shift(w_packed, 4)
    return torch.stack([lo, hi], dim=1).reshape(-1, w_packed.shape[1])


def quant_matmul_plain(x, w_int, w_scale, bias=None) -> torch.Tensor:
    """Plain twin of B1: float32 product, then scale, then bias."""
    acc = torch.matmul(x.to(torch.float32), w_int.to(torch.float32))
    out = acc * torch.as_tensor(w_scale, dtype=torch.float32,
                                device=x.device).reshape(-1)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out


def quant_matmul_int4_plain(x, w_packed, w_scale, bias=None) -> torch.Tensor:
    """Plain twin of B2: unpack the nibbles, then the B1 twin."""
    return quant_matmul_plain(x, unpack_int4(w_packed), w_scale, bias)


def _unported(acc_dtype, requant) -> None:
    if acc_dtype != torch.float32:
        raise NotImplementedError(
            "acc_dtype other than float32 (the int32 accumulator) arrives with "
            "the analysis tier: ROADMAP.md A7")
    if requant is not None:
        raise NotImplementedError(
            "requant= (the integer epilogue, kernel B3) arrives with "
            "ROADMAP.md A8")


def _launch(name, x, w, w_scale, bias, k, packed) -> torch.Tensor:
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D float32 tensor")
    if w.dtype != torch.int8 or w.ndim != 2 or not w.is_contiguous():
        raise ValueError(f"{name}: weights must be a contiguous 2-D int8 tensor")
    m, n = x.shape[0], w.shape[1]
    s = torch.as_tensor(w_scale, dtype=torch.float32, device=x.device)
    s = s.reshape(-1).contiguous()
    if s.numel() not in (1, n):
        raise ValueError(f"{name}: w_scale must be a scalar or (N,)={n}")
    b = None
    if bias is not None:
        b = bias.reshape(-1)
        if b.dtype != torch.float32 or b.numel() != n or not b.is_contiguous():
            raise ValueError(f"{name}: bias must be a contiguous float32 (N,)")
    for t in (w, s) + (() if b is None else (b,)):
        if t.device != x.device:
            raise ValueError(f"{name}: every operand must lie on {x.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = load().qmm_launch(
        x.data_ptr(), w.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), m, k, n,
        int(s.numel() > 1), int(packed),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "qmm_launch")
    launches[name] += 1
    return out


def quant_matmul(x: torch.Tensor, w_int: torch.Tensor, w_scale,
                 bias: Optional[torch.Tensor] = None, *,
                 acc_dtype=torch.float32, requant=None) -> torch.Tensor:
    """out = (x @ w_int) * w_scale [+ bias]; x (M, K) f32, w_int (K, N) int8."""
    _unported(acc_dtype, requant)
    if x.shape[-1] != w_int.shape[0]:
        raise ValueError(f"quant_matmul: K mismatch {tuple(x.shape)} @ "
                         f"{tuple(w_int.shape)}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_int, w_scale, bias)
    return _launch("quant_matmul", x, w_int, w_scale, bias, w_int.shape[0],
                   packed=False)


def quant_matmul_int4(x: torch.Tensor, w_packed: torch.Tensor, w_scale,
                      bias: Optional[torch.Tensor] = None, *,
                      acc_dtype=torch.float32, requant=None) -> torch.Tensor:
    """out = (x @ unpack(w_packed)) * w_scale [+ bias]; w_packed (K/2, N)."""
    _unported(acc_dtype, requant)
    if x.shape[-1] != 2 * w_packed.shape[0]:
        raise ValueError(f"quant_matmul_int4: K mismatch {tuple(x.shape)} @ "
                         f"packed {tuple(w_packed.shape)}")
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, w_packed, w_scale, bias)
    return _launch("quant_matmul_int4", x, w_packed, w_scale, bias,
                   x.shape[-1], packed=True)
