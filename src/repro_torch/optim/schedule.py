"""LR schedules, pure functions of the step (counterpart of
``repro.optim.schedule``).

Computed as float32 tensors on the step's device, as the reference's jnp
is, so that a train step reads its learning rate without a host sync.
The reference runs them under ``jit``, where XLA computes a division by a
constant as a product with its float32 reciprocal (ROADMAP C7); the port
computes those products.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the step's device, not a copy from the host: a step that
    # runs on device tensors only can be captured in a CUDA graph
    return torch.full((), v, dtype=torch.float32, device=like.device)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    step = _f32(step)
    inv = _const(1.0 / max(warmup_steps, 1), step)
    return peak * torch.clamp_max((step + 1.0) * inv, 1.0)


def cosine_schedule(step, *, peak: float, warmup_steps: int,
                    total_steps: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``floor * peak``."""
    step = _f32(step)
    warm = linear_warmup(step, warmup_steps, peak)
    inv = _const(1.0 / max(total_steps - warmup_steps, 1), step)
    frac = torch.clamp((step - warmup_steps) * inv, 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, peak * cos)
