"""Production and host meshes (counterpart of ``repro.launch.mesh``).

Functions, never module-level constants, so importing this module
touches no device state.
"""
from __future__ import annotations

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


__all__ = ["make_host_mesh", "make_production_mesh", "make_virtual_mesh"]
