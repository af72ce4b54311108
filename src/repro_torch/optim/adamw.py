"""AdamW with decoupled weight decay (counterpart of ``repro.optim.adamw``).

The state and the gradients are dicts keyed like the parameters (the
dotted names of ``Module.named_parameters()``), as the reference maps its
pytrees.  The reference's formulas, not ``torch.optim.AdamW``'s (which
places eps and applies the decay otherwise):

    m  = b1·m + (1 - b1)·g            v = b2·v + (1 - b2)·g·g    (float32)
    Δ  = (m / bc1) / (sqrt(v / bc2) + eps)  [+ wd·p where p.ndim >= 2]
    p  = p - lr·Δ                     bc_i = 1 - b_i^t in float32

The decay is added to the update, and only on matrices (no decay on norms,
biases and other vectors), unless the caller names the decayed leaves
(``decay``): the train step names those the reference decays (ROADMAP
C11).  Every quantity that changes from step to step
(the step count, lr, the clip factor, the bias corrections) is a device
tensor, and the update runs as ``torch._foreach_*`` ops over all leaves,
so a step neither syncs with the host nor branches on a device value.
On DTensor leaves (tensor-parallel or FSDP shards) the foreach ops run on
each rank's shards, and each leaf's norm is reduced over the mesh before
the global norm stacks them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32, 0-d
    mu: dict
    nu: dict


def adamw_init(params: dict) -> AdamWState:
    """Zero moments (float32) beside each parameter, step 0 on their device."""
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()})


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d)."""
    leaves = [g.float() for g in grads.values()]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every leaf by min(1, max_norm / max(norm, 1e-12)); returns
    (clipped grads, the global norm before clipping)."""
    gn = global_norm(grads)
    factor = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    clipped = torch._foreach_mul(list(grads.values()), factor)
    return {k: c.to(g.dtype) for (k, g), c in zip(grads.items(), clipped)}, gn


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, max_grad_norm=1.0,
                 decay=None):
    """One AdamW step.  Updates ``params`` and the moments of ``state`` in
    place; returns (params, new state, metrics).  ``decay``: the names of
    the leaves that take weight decay (default: those with ndim >= 2)."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    names = list(params)
    p = [params[k] for k in names]
    g = [grads[k].float() for k in names]
    m = [state.mu[k] for k in names]
    v = [state.nu[k] for k in names]
    step = state.step + 1
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    bc1 = one - torch.pow(torch.full_like(one, b1), t)
    bc2 = one - torch.pow(torch.full_like(one, b2), t)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, gg)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    delta = torch._foreach_div(m, bc1)
    torch._foreach_div_(delta, den)
    if decay is None:
        decay = {k for k in names if params[k].ndim >= 2}   # no decay on vectors
    mats = [i for i, k in enumerate(names) if k in decay]
    if weight_decay and mats:
        torch._foreach_add_([delta[i] for i in mats],
                            torch._foreach_mul([p[i].float() for i in mats], weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p, delta)        # in float32, stored in p's dtype
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
