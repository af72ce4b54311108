"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``; a copy of its numpy stream, the same batches bit
for bit, plus ``to_device``, which hands a batch to the device, and
``place_host_batch``, which lays a data rank's rows into the global batch
of a mesh).

Requirements it satisfies for the fault-tolerance story:
  * fully deterministic given (seed, step)     -> restart reproduces the
    exact token stream, no data loss or duplication on checkpoint resume
  * per-host sharding by process_index         -> each host materializes
    only its rows of the global batch
  * state is one integer (the step)            -> checkpointable for free
  * background prefetch (double-buffered thread) to overlap host data
    generation with device compute

Token distribution: a skewed Zipf-like categorical (more realistic than
uniform for embedding-gradient sparsity patterns), with next-token labels
derived by a fixed permutation so the LM task is *learnable* — loss can
decrease in the end-to-end example, which validates QAT mechanically.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class StreamState:
    step: int = 0


class SyntheticLMStream:
    def __init__(self, *, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, n_hosts: int = 1, host_index: int = 0,
                 extra_specs: Optional[dict] = None, prefetch: int = 2,
                 learnable: bool = True):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.global_batch = global_batch
        self.host_batch = global_batch // n_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_index = host_index
        self.extra_specs = extra_specs or {}
        self.state = StreamState()
        self.learnable = learnable
        # fixed permutation: label(t) = perm[token(t)] — a learnable map
        self._perm = np.random.default_rng(seed ^ 0xBEEF).permutation(vocab)
        # Zipf-ish unnormalized weights over a capped support for speed
        support = min(vocab, 4096)
        w = 1.0 / np.arange(1, support + 1) ** 0.8
        self._support = support
        self._probs = w / w.sum()
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- core

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (host's shard only)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 7919 + self.host_index)
        toks = rng.choice(self._support, size=(self.host_batch, self.seq_len),
                          p=self._probs).astype(np.int32)
        if self.learnable:
            # label_t = perm[token_t]: a fixed token-wise map the model can
            # learn -> loss decreases, validating QAT mechanically
            labels = self._perm[toks].astype(np.int32)
        else:
            labels = rng.integers(0, self.vocab,
                                  (self.host_batch, self.seq_len), np.int32)
        out = {"tokens": toks, "labels": labels}
        for name, (shape, dtype) in self.extra_specs.items():
            out[name] = rng.standard_normal(
                (self.host_batch,) + tuple(shape)).astype(dtype)
        return out

    def next(self) -> dict:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self):
        while True:
            yield self.next()

    # ------------------------------------------------------ prefetching

    def start_prefetch(self):
        def worker():
            while not self._stop.is_set():
                b = self.batch_at(self.state.step)
                self.state.step += 1
                self._q.put(b)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> dict:
        if self._thread is None:
            return self.next()
        return self._q.get()

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------- state mgmt

    def state_dict(self) -> dict:
        return {"step": self.state.step, "seed": self.seed}

    def load_state_dict(self, d: dict):
        assert d["seed"] == self.seed, "resuming with a different data seed"
        self.state.step = int(d["step"])


def global_batch_at(step: int, n_hosts: int, **stream_kw) -> dict:
    """The global batch that ``n_hosts`` host streams (``stream_kw``: the
    ``SyntheticLMStream`` arguments but ``n_hosts`` / ``host_index``) draw
    at ``step``: each host's rows, concatenated in host (data) order.  A
    run over a mesh with that many data ranks trains on exactly these
    rows, so one process fed them computes the same step."""
    parts = [SyntheticLMStream(n_hosts=n_hosts, host_index=i, **stream_kw).batch_at(step)
             for i in range(n_hosts)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def place_host_batch(batch: dict, mesh) -> dict:
    """A data rank's rows (tensors on its device) as its part of the
    global batch over ``mesh``: DTensors of ``data_axis_size(mesh)`` times
    the rows, laid out by ``batch_pspecs`` (the rows of data coordinate i
    are block i; the "model" axis replicates them), built without
    communication.  On a one-entry mesh the batch as it is."""
    if mesh.size == 1:
        return batch
    from repro_torch.dist.sharding import batch_pspecs, data_axis_size, placed, to_shardings
    n = data_axis_size(mesh)
    shapes = {k: (v.shape[0] * n,) + tuple(v.shape[1:]) for k, v in batch.items()}
    shardings = to_shardings(batch_pspecs(shapes, mesh), mesh)
    return {k: placed(v, shardings[k], shapes[k]) for k, v in batch.items()}


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``.  To a CUDA
    device each array goes through pinned memory and a copy that does not
    hold the host, so the next batch can be drawn while the device works."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out
