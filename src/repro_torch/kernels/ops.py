"""Public kernel entry points, offline int4 packing, and launch counts.

Weight packing is an offline operation (done once at compile time), so it
is plain PyTorch here; the in-kernel unpacks live in ``quant_matmul_int4``
and ``quant_grouped_matmul``.  Row 2r of a (K, N) int4-valued weight goes
to the low nibble and row 2r+1 to the high nibble of packed row r
(``repro/kernels/ref.py`` · ``pack_int4_ref``), both sign-extended on
unpack; ``pack_int4_grouped`` does the same along each group's Kg.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import quant_dequant as _qdq
from . import quant_grouped_conv as _gconv
from . import quant_matmul as _qmm
from .flash_attention import flash_attention, flash_attention_plain  # noqa: F401
from .quant_conv import (  # noqa: F401
    extract_patches, im2col_weights, quant_conv2d)
from .quant_dequant import quant_dequant, quant_dequant_plain  # noqa: F401
from .quant_grouped_conv import (  # noqa: F401
    depthwise_weights, dw_launch_plan, extract_depthwise_taps, gqmm_launch_plan,
    grouped_weights,
    pack_int4_grouped, quant_depthwise_conv2d, quant_depthwise_conv2d_plain,
    quant_grouped_conv2d, quant_grouped_matmul, quant_grouped_matmul_plain,
    unpack_int4_grouped)
from .quant_matmul import (  # noqa: F401
    exact_reciprocal, pack_int4, staged_values, staging, quant_matmul, quant_matmul_int4,
    quant_matmul_int4_plain, quant_matmul_plain, unpack_int4)


def launch_counts() -> dict:
    """Kernel launches so far, per kernel (plain-twin calls do not count)."""
    return {"quant_dequant": _qdq.launches, **_qmm.launches,
            **_gconv.launches, "flash_attention": _fa.launches}


def b2_body_counts() -> dict:
    """B2's launches so far per body: ``f32``, ``imad`` (int32 on the CUDA
    cores) and ``int8_mma`` (int32 on the int8 tensor cores)."""
    return dict(_qmm.body_launches)


def staging_counts() -> dict:
    """B5's and B6's integer-body launches so far per staging mode of x
    (``reciprocal``, ``quotient``, ``division``), per kernel."""
    return {k: dict(v) for k, v in _gconv.staging_launches.items()}


def reset_launch_counts() -> None:
    """Zero every launch count, B2's per-body counts and B5's / B6's
    per-staging counts included."""
    _qdq.launches = 0
    _fa.launches = 0
    for counts in (_qmm.launches, _qmm.body_launches, _gconv.launches,
                   *_gconv.staging_launches.values()):
        for k in counts:
            counts[k] = 0
