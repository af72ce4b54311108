"""Public kernel entry points, offline int4 packing, and launch counts.

Weight packing is an offline operation (done once at compile time), so it
is plain PyTorch here; the in-kernel unpack lives in
``quant_matmul_int4``.  Row 2r of a (K, N) int4-valued weight goes to the
low nibble and row 2r+1 to the high nibble of packed row r
(``repro/kernels/ref.py`` · ``pack_int4_ref``), both sign-extended on
unpack.
"""
from __future__ import annotations

import torch

from . import quant_dequant as _qdq
from . import quant_matmul as _qmm
from .quant_dequant import quant_dequant, quant_dequant_plain  # noqa: F401
from .quant_matmul import (  # noqa: F401
    quant_matmul, quant_matmul_int4, quant_matmul_int4_plain,
    quant_matmul_plain, unpack_int4)


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued int8 -> (K//2, N) int8 carriers."""
    if w_int.shape[0] % 2:
        raise ValueError("K must be even for int4 packing")
    lo = w_int[0::2].to(torch.int32) & 0xF
    hi = w_int[1::2].to(torch.int32) & 0xF
    byte = (hi << 4) | lo                               # 0 .. 255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def launch_counts() -> dict:
    """Kernel launches so far, per kernel (plain-twin calls do not count)."""
    return {"quant_dequant": _qdq.launches, **_qmm.launches}


def reset_launch_counts() -> None:
    _qdq.launches = 0
    for k in _qmm.launches:
        _qmm.launches[k] = 0
