"""Checkpoint manager: atomic writes, resume, retention, async save
(counterpart of ``repro.ckpt.manager``).

Layout:  <dir>/step_<N>/arrays.npz + manifest.json, plus <dir>/LATEST.
Atomicity: write into ``step_<N>.tmp`` then ``os.rename`` (POSIX-atomic);
LATEST is written last, so a crash mid-save never corrupts the resume path.
Leaves are saved as host numpy arrays, keyed by their path in the state
with "/" between levels: a module's parameters by their dotted names
(``params/layers.0.attn.wq``), a NamedTuple's fields by name
(``opt/mu/...``, ``opt/step``).  A bfloat16 leaf is saved widened to
float32 (numpy has no bfloat16) and narrowed back, exactly, on restore.

Under a process group (the launchers under torchrun) a leaf may be a
DTensor.  ``save`` gathers each such leaf whole (``full_tensor()``, a
collective every rank issues) in the calling thread, before any writer
thread starts, so no collective of the writer interleaves with the train
step's; rank 0 alone writes, and ``wait`` ends in a barrier of every
rank, so no rank reads ``latest_step`` before the write is done.
``restore`` reads the global arrays and copies into each DTensor its own
shard.  A checkpoint is therefore the same file at any world size, as
the reference's host arrays are: one written by two ranks restores in
one process, and the other way round.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import is_dtensor


def _flatten(tree, prefix: str = "") -> dict:
    """{path: tensor} of every leaf of a state: dicts, NamedTuples and
    modules (their parameters) nest; tensors are leaves."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _group():
    """(rank, world size) of the initialised process group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective of every rank), else ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()    # a copy: the state changes in place


def _shard_of(saved: np.ndarray, t: torch.Tensor) -> np.ndarray:
    """This rank's part of the global array ``saved`` for the DTensor
    ``t``, by its placement (the whole array for a plain tensor)."""
    if not is_dtensor(t) or t.ndim == 0:
        return saved
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        tuple(t.shape), t.device_mesh, list(t.placements))
    return saved[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    # ----------------------------------------------------------- saving

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """state: nested dicts / NamedTuples / modules of tensors.  The
        device-to-host copy happens here, before return (the train step
        updates the state in place); the write blocks unless async_save,
        and a second save waits for the previous one (back-pressure
        instead of unbounded memory growth).  Under a process group every
        rank calls it at the same step: each DTensor leaf is gathered
        here, and rank 0 writes (``extra`` is rank 0's)."""
        rank, _ = _group()
        host = {}
        for k, v in _flatten(state).items():
            whole = _whole(v)               # one leaf gathered at a time
            if rank == 0:
                host[k] = _host(whole)
        self.wait()
        if rank != 0:
            return
        if self.async_save:
            self._pending = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._pending.start()
        else:
            self._write(step, host, extra or {})

    def wait(self):
        """Wait for the write in flight; under a process group of several
        ranks, every rank then passes a barrier (so every rank calls it
        at the same point)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        _, world = _group()
        if world > 1:
            import torch.distributed as dist
            dist.barrier()

    def _write(self, step: int, flat: dict, extra: dict):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "process_index": 0,
            "n_leaves": len(flat),
            "extra": extra,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic
        (self.dir / "LATEST.tmp").write_text(str(step))
        os.rename(self.dir / "LATEST.tmp", self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------------------------------------------------- loading

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if latest.exists():
            s = int(latest.read_text())
            if (self.dir / f"step_{s:010d}" / "manifest.json").exists():
                return s
        steps = self.all_steps()                   # LATEST lost: scan
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, target: Any):
        """Restore into ``target``'s tensors in place (each keeps its
        device and dtype; a DTensor takes its own shard of the saved
        array) and return it.  Raises if the checkpoint lacks a leaf of
        ``target`` or holds one of another (global) shape."""
        d = self.dir / f"step_{step:010d}"
        flat = _flatten(target)
        with np.load(d / "arrays.npz") as z:
            missing = set(flat) - set(z.files)
            if missing:
                raise ValueError(f"checkpoint step {step} missing leaves: "
                                 f"{sorted(missing)[:5]}...")
            for k, t in flat.items():
                saved = z[k]              # one leaf at a time on the host
                if tuple(saved.shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint step {step}: leaf {k} has shape "
                                     f"{saved.shape}, the target {tuple(t.shape)}")
                local = t.to_local() if is_dtensor(t) else t
                part = _shard_of(saved, t)
                if not part.flags.c_contiguous:
                    part = np.ascontiguousarray(part)
                local.copy_(torch.from_numpy(part))
        return target

    def manifest(self, step: int) -> dict:
        d = self.dir / f"step_{step:010d}"
        return json.loads((d / "manifest.json").read_text())
