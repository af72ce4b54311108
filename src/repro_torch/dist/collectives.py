"""Quantized collectives: error-feedback int8 compression of gradients
(counterpart of ``repro.dist.collectives``).

``ef_compress`` is the core (see ``optim/compress.py``): each leaf is
quantized to int8 with a per-leaf symmetric scale after adding the
carried residual, and the quantization error becomes the next residual,
so the accumulated applied updates track the accumulated true gradients
to within one quantization step.

The reference divides the leaf's max-abs by 127 under ``jit``, where XLA
multiplies by the float32 reciprocal instead (ROADMAP C7), and fuses
``e - q * scale`` into one rounding; the port computes both the same way.

``quantized_psum`` compresses locally and all-reduces the compressed
leaves over a process group (a mesh axis's, or one given).  The train
step does not call it: as in the reference, the gradient reduction is
the DTensors' own and the compression acts on the reduced gradient
(``optim/compress.py``).
"""
from __future__ import annotations

import torch

_LEVELS = 127.0          # symmetric int8


def _compress_leaf(e: torch.Tensor):
    """e -> (quantized e, residual): quantize-dequantize with a per-leaf
    symmetric scale; the residual is the exact rounding error.  On a
    DTensor (a sharded gradient) the scale is the whole leaf's: its amax
    is reduced over the mesh, and the constant is a replicated DTensor;
    every other step acts on each rank's shard alone."""
    from repro_torch.models.common import is_dtensor
    e = e.to(torch.float32)
    inv = torch.full((), 1.0 / _LEVELS, dtype=torch.float32, device=e.device)
    if is_dtensor(e):
        from torch.distributed.tensor import DTensor, Replicate
        inv = DTensor.from_local(inv, e.device_mesh, [Replicate()] * e.device_mesh.ndim,
                                 run_check=False)
    scale = torch.clamp_min(torch.amax(torch.abs(e)), 1e-12) * inv
    q = torch.clamp(torch.round(e / scale), -_LEVELS, _LEVELS)
    # the residual of the exact product, rounded once, as the reference's
    # fused multiply-subtract gives it (a product of a 7-bit code and a
    # float32 scale and its difference from e are exact in float64)
    res = (e.double() - q.double() * scale.double()).float()
    return q * scale, res


def ef_compress(grads: dict, residual: dict):
    """Error-feedback compression over a dict of gradients.

    Returns ``(compressed, new_residual)`` with, per leaf,
    ``compressed + new_residual == grad + residual`` within one float32
    rounding of the sum."""
    from repro_torch.models.common import is_dtensor
    out_g, out_r = {}, {}
    for k, g in grads.items():
        r = residual[k]
        if is_dtensor(g) and is_dtensor(r) and tuple(g.placements) != tuple(r.placements):
            # a gradient that arrives in another layout (a pending sum):
            # the residual's, so the new residual keeps its parameter's
            g = g.redistribute(r.device_mesh, list(r.placements))
        out_g[k], out_r[k] = _compress_leaf(g.to(torch.float32) + r)
    return out_g, out_r


def quantized_psum(x, axis_name=None, residual=None, *, group=None):
    """int8-compressed all-reduce: compress the local contribution (with
    the optional carried residual) by ``ef_compress``, then sum each
    compressed leaf over the ranks with ``torch.distributed.all_reduce``.

    ``x`` is a dict of tensors (or one tensor).  The ranks are ``group``,
    or the process group of mesh axis ``axis_name`` of the ambient
    ``Mesh`` (``with mesh:``; its ``device_mesh()``).  Returns ``(summed,
    new_residual)``, the residual this rank's own, as the reference's."""
    import torch.distributed as dist

    from .sharding import current_mesh
    if group is None:
        mesh = current_mesh()
        if mesh is None or axis_name is None:
            raise ValueError("quantized_psum needs group= or an axis_name of "
                             "the ambient mesh (with mesh: ...)")
        group = mesh.device_mesh().get_group(axis_name)
    single = isinstance(x, torch.Tensor)
    if single:
        x = {"x": x}
        residual = None if residual is None else {"x": residual}
    if residual is None:
        residual = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in x.items()}
    summed, new_residual = ef_compress(x, residual)
    for v in summed.values():
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
    if single:
        return summed["x"], new_residual["x"]
    return summed, new_residual
