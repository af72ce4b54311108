"""Production and host meshes (counterpart of ``repro.launch.mesh``),
and the process group of a launch under torchrun.

Functions, never module-level constants, so importing this module
touches no device state.

The port runs one process per device: ``torchrun --nproc-per-node N -m
repro_torch.launch.train ...`` starts N ranks, each launcher enters
``torchrun_group``, and ``dist.fault.elastic_mesh`` then derives the
mesh from the group (one entry per rank).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 devices per pod ("data", "model"); two pods = 512
    ("pod", "data", "model").  ``devices`` defaults to the CUDA devices
    present; the first 256 (512) are used, and fewer raise ValueError."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = _cuda_devices() if devices is None else list(devices)
    need = int(np.prod(shape))
    if len(devices) < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} production mesh needs "
                         f"{need} devices; {len(devices)} given or present")
    return Mesh(np.array(devices[:need], dtype=object).reshape(shape), axes)


def make_host_mesh(device=None) -> Mesh:
    """(n, 1) ("data", "model") over the CUDA devices present, or (1, 1)
    over the named ``device``."""
    if device is not None:
        devices = [torch.device(device)]
    else:
        devices = _cuda_devices()
        if not devices:
            raise RuntimeError("CUDA is not available; pass device='cpu'")
    return Mesh(np.array(devices, dtype=object).reshape(len(devices), 1),
                ("data", "model"))


def make_virtual_mesh(n: int, device=None) -> Mesh:
    """(n, 1) ("data", "model") whose entries cycle over the CUDA devices
    present (on one GPU: n entries of ``cuda:0``), or are all the named
    ``device``: the counterpart of XLA's forced host device count
    (``launch.serve --devices N``).  A compiled plan runs one batch shard
    per entry."""
    if n < 1:
        raise ValueError(f"a mesh of {n} entries")
    if device is not None:
        devices = [torch.device(device)]
    else:
        devices = _cuda_devices()
        if not devices:
            raise RuntimeError("CUDA is not available; pass device='cpu'")
    entries = [devices[i % len(devices)] for i in range(n)]
    return Mesh(np.array(entries, dtype=object).reshape(n, 1), ("data", "model"))


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device=None, *, rank: int = None, world_size: int = None,
                     store=None) -> torch.device:
    """Start the process group and return this rank's device: NCCL on
    ``cuda:LOCAL_RANK`` (made the current device), or gloo on the CPU
    where ``device`` names it.  ``rank`` / ``world_size`` default to
    torchrun's ``RANK`` / ``WORLD_SIZE``, and the rendezvous to its
    ``env://``; a test passes a ``store`` (a ``FileStore``).  A group that
    fails to start raises."""
    import torch.distributed as dist
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    kw = dict(init_method=None if store is not None else "env://", store=store,
              rank=rank, world_size=world_size)
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo", **kw)
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for gloo ranks")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", device_id=dev, **kw)
    return dev


@contextlib.contextmanager
def torchrun_group(device=None):
    """The process group of a launch under torchrun for the block: started
    by ``init_distributed(device)`` from torchrun's environment when that
    is set and no group is initialised yet, and then destroyed after the
    block.  Yields this process's rank (0 without torchrun)."""
    import torch.distributed as dist
    started = (not dist.is_initialized()
               and all(k in os.environ for k in _TORCHRUN_ENV))
    if started:
        init_distributed(device)
    try:
        yield dist.get_rank() if started else 0
    finally:
        if started:
            dist.destroy_process_group()


def mesh_rank(mesh) -> int:
    """This process's entry of ``mesh``: its rank in the process group
    when the mesh spans several entries (the group must have one rank per
    entry: else the mesh needs torchrun), else 0."""
    import torch.distributed as dist
    if mesh.size == 1:
        return 0
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        have = dist.get_world_size() if dist.is_initialized() else 1
        raise RuntimeError(
            f"a mesh of {mesh.size} entries {mesh.shape} needs one process per entry "
            f"(have {have}): run the launcher under torchrun (torchrun "
            f"--nproc-per-node {mesh.size} -m ...), or pass --device to run on one")
    return dist.get_rank()


__all__ = ["init_distributed", "make_host_mesh", "make_production_mesh",
           "make_virtual_mesh", "mesh_rank", "torchrun_group"]
