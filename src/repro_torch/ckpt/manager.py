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
One process writes: the port trains in one process on one device
(multi-process training is ROADMAP A16b).
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


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()    # a copy: the state changes in place


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
        instead of unbounded memory growth)."""
        host = {k: _host(v) for k, v in _flatten(state).items()}
        if self.async_save:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._pending.start()
        else:
            self._write(step, host, extra or {})

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

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
        device and dtype) and return it.  Raises if the checkpoint lacks a
        leaf of ``target`` or holds one of another shape."""
        d = self.dir / f"step_{step:010d}"
        with np.load(d / "arrays.npz") as z:
            saved = {k: z[k] for k in z.files}
        flat = _flatten(target)
        missing = set(flat) - set(saved)
        if missing:
            raise ValueError(f"checkpoint step {step} missing leaves: "
                             f"{sorted(missing)[:5]}...")
        for k, t in flat.items():
            if tuple(saved[k].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint step {step}: leaf {k} has shape "
                                 f"{saved[k].shape}, the target {tuple(t.shape)}")
            t.copy_(torch.from_numpy(saved[k]))
        return target

    def manifest(self, step: int) -> dict:
        d = self.dir / f"step_{step:010d}"
        return json.loads((d / "manifest.json").read_text())
