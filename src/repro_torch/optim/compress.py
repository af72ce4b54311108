"""Error-feedback int8 gradient compression, the paper's Quant op on
gradients (counterpart of ``repro.optim.compress``).

As in the reference, the compression acts on the *reduced* gradient,
before the optimizer: on one device the gradient itself, over a process
group the DTensor gradient whose reduction over the data axes the
DTensors did (FSDP's reduce-scatter), with each leaf's scale its whole
amax (``dist.collectives.ef_compress``).  No compressed collective runs
on the train step; ``dist.collectives.quantized_psum`` is the separate
int8 all-reduce.
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
