"""Plain PyTorch versions of the QONNX operators the benchmark's models use.

Written from the QONNX operator definitions (arXiv:2206.07527, §III) and
ONNX's, not from the program: no kernel, no packing, no plan.  Every
function works in the dtype of its input, so the same code is the
reference (float64) and its lower-precision control (bfloat16).  In float64
every sum of the benchmark's dyadic products is exact, in any order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def quant(x: torch.Tensor, scale: float, zero_point: float, bits: int, *,
          signed: bool, narrow: bool) -> torch.Tensor:
    """QONNX ``Quant`` with ``rounding_mode=ROUND`` (half to even):
    ``(clip(round(x / s + z), lo, hi) - z) * s``."""
    if signed:
        lo = -(2.0 ** (bits - 1)) + (1.0 if narrow else 0.0)
        hi = 2.0 ** (bits - 1) - 1.0
    else:
        lo = 0.0
        hi = 2.0 ** bits - (2.0 if narrow else 1.0)
    q = torch.clamp(torch.round(x / scale + zero_point), lo, hi)
    return (q - zero_point) * scale


def bipolar_quant(x: torch.Tensor, scale: float) -> torch.Tensor:
    """QONNX ``BipolarQuant``: ``s`` where ``x >= 0``, else ``-s``."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype) * scale


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int, pad: int,
           group: int) -> torch.Tensor:
    """ONNX ``Conv`` (NCHW, square kernel, symmetric padding, no bias) as
    patches times weights, group by group: ``x`` (B, C, H, W), ``w``
    (Cout, C / group, k, k)."""
    b, c, h, wd = x.shape
    cout, cg, k, _ = w.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    cols = F.unfold(x, k, padding=pad, stride=stride)       # (B, C*k*k, L)
    cols = cols.reshape(b, group, cg * k * k, ho * wo)
    wg = w.reshape(group, cout // group, cg * k * k)
    y = torch.einsum("bgkl,gok->bgol", cols, wg)
    return y.reshape(b, cout, ho, wo)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def max_pool(x: torch.Tensor, k: int, stride: int, pad: int = 0
             ) -> torch.Tensor:
    """ONNX ``MaxPool`` with symmetric ``pad``: padded positions read -inf,
    so they never win a window."""
    return F.max_pool2d(x, k, stride, padding=pad)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ONNX ``Add`` of two tensors of one shape."""
    return x + y


def global_average_pool(x: torch.Tensor) -> torch.Tensor:
    """ONNX ``GlobalAveragePool``: (B, C, H, W) -> (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """ONNX ``Flatten`` with ``axis=1``."""
    return x.reshape(x.shape[0], -1)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w
