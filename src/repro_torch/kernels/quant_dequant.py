"""B4: fused quantize-dequantize — the QONNX ``Quant`` op as one CUDA kernel.

Replaces ``repro/kernels/quant_dequant.py`` · ``quant_dequant`` (Pallas body
``_qdq_kernel``).  CUDA source: ``csrc/quant_dequant.cu``.

    q   = clip(round_mode(x / s + z), lo, hi)
    out = (q - z) * s           or the int8 codes q when ``emit_codes``

``s`` and ``z`` are per tensor or per last-dim channel; the bit width,
signedness, ``narrow`` and rounding mode are static, and the clip bounds
come from Python doubles as in the reference (``_static_bounds``), rounded
once to float32.

Bound on the card: bytes.  One float32 read and one float32 (or int8)
write per element, at 3.35 TB/s on an H100; the arithmetic is a handful
of float ops per element.  Design: one thread per element in a
grid-stride loop, the rounding mode and the output kind as template
parameters (see the source for the rounding details).

On a CPU tensor the wrapper runs ``quant_dequant_plain``, the same
arithmetic in PyTorch; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ._build import check, load

ROUNDING_MODE_IDS = {"ROUND": 0, "CEIL": 1, "FLOOR": 2, "UP": 3, "DOWN": 4,
                     "ROUND_TO_ZERO": 4, "HALF_UP": 5, "HALF_DOWN": 6}

launches = 0        # kernel launches (the plain twin does not count)


def static_bounds(signed: bool, narrow: bool, bit_width: float) -> tuple[float, float]:
    """Eqs. 2-3 with ``narrow``, computed in Python doubles."""
    b = float(bit_width)
    if signed:
        lo = -(2.0 ** (b - 1)) + (1.0 if narrow else 0.0)
        hi = 2.0 ** (b - 1) - 1.0
    else:
        lo = 0.0
        hi = 2.0 ** b - 1.0 - (1.0 if narrow else 0.0)
    return lo, hi


def _round(v: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "ROUND":
        return torch.round(v)
    if mode in ("DOWN", "ROUND_TO_ZERO"):
        return torch.trunc(v)
    if mode == "UP":
        return torch.sign(v) * torch.ceil(torch.abs(v))
    if mode == "CEIL":
        return torch.ceil(v)
    if mode == "FLOOR":
        return torch.floor(v)
    if mode == "HALF_UP":
        return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)
    return torch.sign(v) * torch.ceil(torch.abs(v) - 0.5)      # HALF_DOWN


def _row(p: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A scale / zero point as a float32 (1,) or (N,) vector."""
    p = p.reshape(-1).to(torch.float32)
    if p.numel() not in (1, n):
        raise ValueError(f"{name} must be a scalar or have {n} entries, "
                         f"got {p.numel()}")
    return p


def quant_dequant_plain(x, scale, zero_point, *, bit_width=8, signed=True,
                        narrow=False, rounding_mode="ROUND",
                        emit_codes=False) -> torch.Tensor:
    """The plain PyTorch twin of the kernel (same arithmetic, same order)."""
    n = x.shape[-1]
    s = _row(torch.as_tensor(scale, device=x.device), n, "scale")
    z = _row(torch.as_tensor(zero_point, device=x.device), n, "zero_point")
    lo, hi = static_bounds(signed, narrow, bit_width)
    q = _round(x.to(torch.float32) / s + z, rounding_mode.upper())
    q = torch.clamp(q, lo, hi)
    if emit_codes:
        return q.to(torch.int8)
    return ((q - z) * s).to(x.dtype)


def quant_dequant(x: torch.Tensor, scale, zero_point, *, bit_width=8,
                  signed=True, narrow=False, rounding_mode="ROUND",
                  emit_codes=False) -> torch.Tensor:
    """Fused QDQ over a (..., N) float32 tensor; scale / zero_point are
    scalars or (N,) tensors.  Returns float32 values of ``x``'s shape, or
    int8 codes when ``emit_codes`` (widths must fit int8)."""
    global launches
    mode = rounding_mode.upper()
    if mode not in ROUNDING_MODE_IDS:
        raise ValueError(f"unknown rounding_mode {rounding_mode!r}")
    if x.device.type == "cpu":
        return quant_dequant_plain(x, scale, zero_point, bit_width=bit_width,
                                   signed=signed, narrow=narrow,
                                   rounding_mode=mode, emit_codes=emit_codes)
    if x.device.type != "cuda":
        raise ValueError(f"quant_dequant runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("quant_dequant takes a contiguous float32 tensor, "
                         f"got {x.dtype} contiguous={x.is_contiguous()}")
    if x.ndim == 0:
        raise ValueError("quant_dequant needs at least one dimension")
    n = x.shape[-1]
    s = _row(torch.as_tensor(scale, device=x.device), n, "scale").contiguous()
    z = _row(torch.as_tensor(zero_point, device=x.device), n,
             "zero_point").contiguous()
    if s.device != x.device or z.device != x.device:
        raise ValueError("scale and zero_point must lie on x's device")
    lo, hi = static_bounds(signed, narrow, bit_width)
    out = torch.empty(x.shape, dtype=torch.int8 if emit_codes else x.dtype,
                      device=x.device)
    lib = load()
    err = lib.qdq_launch(
        x.data_ptr(), s.data_ptr(), z.data_ptr(), out.data_ptr(), x.numel(),
        max(n, 1), int(s.numel() > 1), int(z.numel() > 1), lo, hi,
        ROUNDING_MODE_IDS[mode], int(emit_codes),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "qdq_launch")
    launches += 1
    return out
