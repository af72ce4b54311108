"""Public kernel entry points, offline int4 packing, and launch counts.

Weight packing is an offline operation (done once at compile time), so it
is plain PyTorch here; the in-kernel unpacks live in ``quant_matmul_int4``
and ``quant_grouped_matmul``.  Row 2r of a (K, N) int4-valued weight goes
to the low nibble and row 2r+1 to the high nibble of packed row r
(``repro/kernels/ref.py`` · ``pack_int4_ref``), both sign-extended on
unpack; ``pack_int4_grouped`` does the same along each group's Kg.
"""
from __future__ import annotations

import importlib

import torch

from . import quant_conv as _conv
from . import quant_dequant as _qdq
from . import quant_grouped_conv as _gconv
from . import quant_matmul as _qmm
from .flash_attention import flash_attention, flash_attention_plain  # noqa: F401
from .quant_conv import (  # noqa: F401
    conv_operand, extract_patches, im2col_weights, quant_conv2d)
from .quant_dequant import (  # noqa: F401
    qdq_launch_plan, quant_dequant, quant_dequant_plain)
from .quant_grouped_conv import (  # noqa: F401
    depthwise_weights, dw_launch_plan, extract_depthwise_taps, gqmm_launch_plan,
    grouped_weights,
    pack_int4_grouped, quant_depthwise_conv2d, quant_depthwise_conv2d_plain,
    quant_grouped_conv2d, quant_grouped_matmul, quant_grouped_matmul_plain,
    unpack_int4_grouped)
from .quant_matmul import (  # noqa: F401
    exact_reciprocal, pack_int4, qmm_launch_plan, staged_values, staging, quant_matmul,
    quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_plain, unpack_int4)

# B7's module (its launch count), not the function the package binds to
# the name ``flash_attention``
_fa = importlib.import_module(".flash_attention", __package__)



def quantize_weights_int8(w: torch.Tensor, *, narrow: bool = True):
    """Symmetric per-output-channel int8 quantization of a (K, N) weight:
    ``(w_int8, scale[N])`` with ``w ~= scale * w_int8`` (the paper's §II
    convention).  The reference runs this outside ``jit``, and its
    ``amax / 127.0`` is a true division there, not the product with the
    reciprocal that ``jit`` makes of it (ROADMAP C7): both divisions here
    are IEEE float32 divisions, so the codes and scales are its bits."""
    w = torch.as_tensor(w, dtype=torch.float32)
    amax = torch.amax(torch.abs(w), dim=0)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / scale), -127 if narrow else -128, 127)
    return q.to(torch.int8), scale


def quantize_weights_int4(w: torch.Tensor):
    """Symmetric per-channel int4 quantization, then packing:
    ``(w_packed[K//2, N], scale[N])``; the divisions as in
    ``quantize_weights_int8``."""
    w = torch.as_tensor(w, dtype=torch.float32)
    amax = torch.amax(torch.abs(w), dim=0)
    scale = torch.clamp_min(amax / 7.0, 1e-8)
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int8)
    return pack_int4(q), scale

def launch_counts() -> dict:
    """Kernel launches so far, per kernel (plain-twin calls do not count)."""
    return {"quant_dequant": _qdq.launches, **_qmm.launches,
            **_gconv.launches, "flash_attention": _fa.launches}


def b2_body_counts() -> dict:
    """B2's launches so far per body: ``f32``, ``imad`` (int32 on the CUDA
    cores) and ``int8_mma`` (int32 on the int8 tensor cores)."""
    return dict(_qmm.body_launches)


def conv_operand_counts() -> dict:
    """``quant_conv2d``'s launches so far on the card per path of the A
    operand: ``implicit`` (gathered inside B1 / B2) and ``materialised``
    (a patch matrix first)."""
    return dict(_conv.conv_operand_launches)


def staging_counts() -> dict:
    """B5's and B6's integer-body launches so far per staging mode of x
    (``reciprocal``, ``quotient``, ``division``), per kernel."""
    return {k: dict(v) for k, v in _gconv.staging_launches.items()}


def reset_launch_counts() -> None:
    """Zero every launch count, B2's per-body counts, the conv operand's
    per-path counts and B5's / B6's per-staging counts included."""
    _qdq.launches = 0
    _fa.launches = 0
    for counts in (_qmm.launches, _qmm.body_launches, _conv.conv_operand_launches,
                   _gconv.launches, *_gconv.staging_launches.values()):
        for k in counts:
            counts[k] = 0
