"""PTQ calibration: static (scale, zero_point) from sample batches
(counterpart of ``repro.quantize.calibrate``).

Three estimators (min-max, percentile, MSE-grid) feeding
``core.quant_ops.scale_from_minmax``.  Samples are tensors; the results
are float32 tensors on the samples' device.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant_ops import quant, scale_from_minmax

from .config import TensorQuant


def minmax_stats(samples):
    """Running min/max over a list of tensors (float32)."""
    lo = hi = None
    for s in samples:
        smin, smax = s.min().float(), s.max().float()
        lo = smin if lo is None else torch.minimum(lo, smin)
        hi = smax if hi is None else torch.maximum(hi, smax)
    return lo, hi


def _percentile(sorted_x: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile``'s default (numpy's linear interpolation between
    the two nearest order statistics), step for step in float32.
    ``jnp.percentile`` is jitted: XLA folds its ``pct / 100 * (n - 1)``
    into ``pct * (float32(1/100) * (n - 1))`` (ROADMAP C7).
    ``torch.quantile`` refuses inputs above 2^24 elements, so the rule is
    spelled out on a sort."""
    f32 = dict(dtype=torch.float32, device=sorted_x.device)
    last = sorted_x.numel() - 1
    pos = torch.tensor(pct, **f32) * (torch.tensor(0.01, **f32) * torch.tensor(last, **f32))
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    at = lambda i: sorted_x[torch.clamp(i, 0, last).long()]
    return at(low) * (1.0 - hw) + at(high) * hw


def percentile_stats(samples, pct=99.9):
    flat, _ = torch.sort(torch.cat([s.reshape(-1).float() for s in samples]))
    return _percentile(flat, 100 - pct), _percentile(flat, pct)


def calibrate_minmax(samples, tq: TensorQuant):
    lo, hi = minmax_stats(samples)
    return scale_from_minmax(lo, hi, tq.bit_width, signed=tq.signed,
                             narrow=tq.narrow, symmetric=tq.symmetric)


def calibrate_percentile(samples, tq: TensorQuant, pct=99.9):
    lo, hi = percentile_stats(samples, pct)
    return scale_from_minmax(lo, hi, tq.bit_width, signed=tq.signed,
                             narrow=tq.narrow, symmetric=tq.symmetric)


def calibrate_mse(samples, tq: TensorQuant, n_grid=40):
    """Search the clipping range minimizing quantization MSE."""
    flat = torch.cat([s.reshape(-1).float() for s in samples])
    amax = torch.amax(torch.abs(flat))
    best, best_err = None, float("inf")
    for frac in torch.linspace(0.3, 1.0, n_grid, device=flat.device):
        s, z = scale_from_minmax(-amax * frac, amax * frac, tq.bit_width,
                                 signed=tq.signed, narrow=tq.narrow,
                                 symmetric=tq.symmetric)
        err = float(torch.mean((quant(flat, s, z, tq.bit_width, signed=tq.signed,
                                      narrow=tq.narrow) - flat) ** 2))
        if err < best_err:
            best, best_err = (s, z), err
    return best
