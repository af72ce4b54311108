"""Error-feedback int8 gradient compression, the paper's Quant op on
gradients (counterpart of ``repro.optim.compress``).

On a cluster this wraps the data-parallel all-reduce
(``dist.collectives.quantized_psum``).  On one device it is
applied to the gradient before the optimizer: the same error-feedback
math (``dist.collectives.ef_compress``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist.collectives import ef_compress


class CompressState(NamedTuple):
    residual: dict


def compress_init(params: dict) -> CompressState:
    return CompressState(residual={k: torch.zeros_like(p, dtype=torch.float32)
                                   for k, p in params.items()})


def compressed_grads(grads: dict, state: CompressState):
    """Returns (grads to apply, new state)."""
    compressed, residual = ef_compress({k: g.float() for k, g in grads.items()},
                                       state.residual)
    return compressed, CompressState(residual=residual)
