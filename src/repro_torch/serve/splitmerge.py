"""Split-merge serving front: shard a request wave, merge deterministically
(counterpart of ``repro.serve.splitmerge``).

``SplitMergeFront`` takes a *wave* of requests (a list of samples destined
for the same model), splits it into contiguous shards — one per worker —
dispatches every shard concurrently, and merges the results back **in
submission order**: result *i* is always the answer to sample *i*, no
matter which worker (or which retry) computed it, and no matter in what
order the shards finished.

A ``Worker`` wraps one serving backend: a ``CompiledGraphEngine`` (pinned to
one device via ``device_workers``, a device carrying one or several
workers, or mesh-sharded: ``CompiledGraphEngine(graph, mesh=...)``) or an
engine plus its ``ServeScheduler`` when a background flush loop owns the
queue.

**Fault tolerance.**  Shard execution runs under
``repro_torch.dist.fault.run_with_restarts``: when a worker dies mid-shard
(``WorkerFailed``), the whole shard is re-dispatched to the next healthy
worker — requests are never lost, they are re-run (the compiled tier is
pure, so a re-run is answer-identical).  The failed worker is marked and
skipped for the rest of the wave.  ``Worker.inject_fault()`` arms a
test/chaos hook that makes the next shard raise after submission, which is
exactly the mid-flight crash tests/test_torch_serve_tier.py and
``chip_smoke.py`` exercise.

Per-worker telemetry lands in the shared ``repro_torch.obs`` registry:
``splitmerge_dispatch_total`` / ``splitmerge_requests_total`` /
``splitmerge_redispatch_total`` counters and a ``splitmerge_shard_fill``
occupancy histogram, all labelled ``{"worker": name}``.
"""
from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.dist.fault import RestartPolicy, run_with_restarts
from repro_torch.obs import MetricsRegistry

log = logging.getLogger("repro_torch.serve")

__all__ = ["Worker", "SplitMergeFront", "Wave", "WorkerFailed",
           "device_workers"]


class WorkerFailed(RuntimeError):
    """A worker died while running a shard (subclass of ``RuntimeError``
    so the default ``RestartPolicy.restartable`` covers it)."""


@dataclass
class Worker:
    """One serving backend behind the split-merge front.

    ``engine`` is a ``CompiledGraphEngine``; when ``scheduler`` is set the
    shard's requests go through it (its background loop flushes them),
    otherwise the worker flushes the engine itself with ``run_pending``.
    """
    name: str
    engine: object
    scheduler: object = None
    failed: bool = False
    _fault_arm: int = field(default=-1, repr=False)   # shards until injected
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def inject_fault(self, after_shards: int = 0) -> None:
        """Arm a chaos hook: the worker raises ``WorkerFailed`` while
        running its ``after_shards``-th next shard (0 = the very next one).
        The failure fires *after* submission — the mid-flight crash case —
        so recovery must re-dispatch, not just re-route."""
        with self._lock:
            self._fault_arm = after_shards

    def _check_fault(self) -> None:
        with self._lock:
            if self._fault_arm == 0:
                self._fault_arm = -1
                self.failed = True
                raise WorkerFailed(f"worker {self.name}: injected fault")
            if self._fault_arm > 0:
                self._fault_arm -= 1

    def run_shard(self, xs: list, *, deadline_ms: Optional[float] = None,
                  timeout: Optional[float] = 60.0) -> list:
        """Run every sample in ``xs`` on this worker; returns their results
        in order.  Raises ``WorkerFailed`` when the backend (or the armed
        fault hook) dies — the front re-dispatches the whole shard."""
        if self.failed:
            raise WorkerFailed(f"worker {self.name} is marked failed")
        sub = self.scheduler if self.scheduler is not None else self.engine
        try:
            reqs = [sub.submit(x, deadline_ms=deadline_ms) for x in xs]
            self._check_fault()
            if self.scheduler is None:
                self.engine.run_pending()
            return [r.wait(timeout=timeout) for r in reqs]
        except WorkerFailed:
            raise
        except Exception as e:
            self.failed = True
            raise WorkerFailed(f"worker {self.name} died: {e!r}") from e


@dataclass
class _Shard:
    """One contiguous span of the wave: results land at [lo, hi)."""
    lo: int
    hi: int
    future: object


class Wave:
    """Futures for one ``submit_wave`` call; ``wait()`` merges in
    submission order (index *i* of the returned list is sample *i*)."""

    def __init__(self, n: int, shards: list):
        self.n = n
        self._shards = shards

    def wait(self, timeout: Optional[float] = None) -> list:
        """Block for every shard; returns the merged results.  Shard
        completion order is irrelevant: each shard scatters into its own
        [lo, hi) span, so the merge is deterministic by construction."""
        out: list = [None] * self.n
        for sh in self._shards:
            rows = sh.future.result(timeout=timeout)
            if len(rows) != sh.hi - sh.lo:
                raise RuntimeError(
                    f"shard [{sh.lo}:{sh.hi}) returned {len(rows)} rows")
            out[sh.lo:sh.hi] = rows
        return out

    def done(self) -> bool:
        return all(sh.future.done() for sh in self._shards)


class SplitMergeFront:
    """Shard request waves across workers; merge deterministically; survive
    worker failures by re-dispatching the dead worker's shard.

    ``policy`` bounds the re-dispatch budget per shard (default: up to
    ``len(workers) - 1`` immediate retries — every other worker gets one
    chance, no backoff sleeps on the serving path).
    """

    def __init__(self, workers: list, *,
                 policy: Optional[RestartPolicy] = None,
                 metrics_registry: Optional[MetricsRegistry] = None):
        if not workers:
            raise ValueError("SplitMergeFront needs at least one worker")
        names = [w.name for w in workers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names: {names}")
        self.workers = list(workers)
        self._policy = policy
        self.metrics = metrics_registry or MetricsRegistry()
        self._pool = ThreadPoolExecutor(
            max_workers=len(workers), thread_name_prefix="splitmerge")
        self._lock = threading.Lock()
        self.n_waves = 0
        self.n_redispatched = 0
        self._m = {}
        for w in self.workers:
            lbl = {"worker": w.name}
            self._m[w.name] = dict(
                dispatch=self.metrics.counter(
                    "splitmerge_dispatch_total",
                    help="shards dispatched to this worker", labels=lbl),
                requests=self.metrics.counter(
                    "splitmerge_requests_total",
                    help="requests answered by this worker", labels=lbl),
                redispatch=self.metrics.counter(
                    "splitmerge_redispatch_total",
                    help="shards re-dispatched after this worker failed",
                    labels=lbl),
                fill=self.metrics.histogram(
                    "splitmerge_shard_fill",
                    help="shard size / balanced shard size",
                    buckets=(0.25, 0.5, 0.75, 1.0, 1.5, 2.0), window=512,
                    labels=lbl))

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "SplitMergeFront":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- serving

    def healthy(self) -> list:
        return [w for w in self.workers if not w.failed]

    def _spans(self, n: int, k: int) -> list:
        """Split [0, n) into k contiguous spans whose sizes differ by <= 1
        (leading spans take the remainder); empty spans are dropped."""
        base, rem = divmod(n, k)
        spans, lo = [], 0
        for i in range(k):
            hi = lo + base + (1 if i < rem else 0)
            if hi > lo:
                spans.append((lo, hi))
            lo = hi
        return spans

    def submit_wave(self, xs: list, *, deadline_ms: Optional[float] = None,
                    timeout: Optional[float] = 60.0) -> Wave:
        """Shard ``xs`` across the healthy workers and dispatch every shard
        concurrently.  Returns a ``Wave``; ``wave.wait()`` yields result
        *i* for sample *i* regardless of shard completion order."""
        workers = self.healthy()
        if not workers:
            raise RuntimeError("no healthy workers left")
        with self._lock:
            self.n_waves += 1
        spans = self._spans(len(xs), len(workers))
        balanced = max(1, len(xs) / max(1, len(workers)))
        shards = []
        for (lo, hi), w in zip(spans, workers):
            shard_xs = xs[lo:hi]
            self._m[w.name]["fill"].observe(len(shard_xs) / balanced)
            fut = self._pool.submit(
                self._run_shard_ft, w, shard_xs,
                deadline_ms=deadline_ms, timeout=timeout)
            shards.append(_Shard(lo, hi, fut))
        return Wave(len(xs), shards)

    def _run_shard_ft(self, worker, xs: list, *, deadline_ms, timeout):
        """Run one shard fault-tolerantly: a dead worker's shard is re-run
        on the next healthy worker (bounded by the restart policy), so an
        injected mid-shard failure loses zero requests."""
        tried: set = set()
        current = {"w": worker}

        def make_state():
            w = current["w"]
            if w is None or w.failed or w.name in tried:
                healthy = [c for c in self.healthy() if c.name not in tried]
                if not healthy:
                    raise RuntimeError(
                        f"shard of {len(xs)} request(s) has no healthy "
                        f"worker left (tried {sorted(tried)})")
                w = healthy[0]
                with self._lock:
                    self.n_redispatched += 1
                self._m[w.name]["redispatch"].inc()
                log.warning("splitmerge: re-dispatching %d request(s) to "
                            "worker %s (tried %s)",
                            len(xs), w.name, sorted(tried))
            tried.add(w.name)
            current["w"] = w
            self._m[w.name]["dispatch"].inc()
            return w

        def run(w):
            rows = w.run_shard(xs, deadline_ms=deadline_ms, timeout=timeout)
            self._m[w.name]["requests"].inc(len(rows))
            return rows

        policy = self._policy or RestartPolicy(
            max_restarts=max(0, len(self.workers) - 1), backoff_s=0.0)
        return run_with_restarts(make_state, run, policy)

    def __call__(self, xs: list, *, deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = 60.0) -> np.ndarray:
        """Synchronous convenience: submit a wave, wait, stack the rows."""
        rows = self.submit_wave(
            xs, deadline_ms=deadline_ms, timeout=timeout).wait(
            timeout=timeout)
        return np.stack([np.asarray(r) for r in rows])

    def stats(self) -> dict:
        with self._lock:
            waves, redisp = self.n_waves, self.n_redispatched
        return {"workers": len(self.workers),
                "healthy": len(self.healthy()),
                "failed": [w.name for w in self.workers if w.failed],
                "waves": waves, "redispatched_shards": redisp}


def device_workers(graph_factory, *, devices=None, scheduler: bool = False,
                   metrics_registry: Optional[MetricsRegistry] = None,
                   window_ms: float = 2.0, **engine_kw) -> list:
    """One single-device ``Worker`` per entry of ``devices``.

    ``devices=None`` means every CUDA device present (raising without
    one); an explicit list of torch devices may repeat a device, e.g. two
    workers on ``"cuda:0"``, or ``["cpu", "cpu"]``.  ``graph_factory`` is
    called once per worker (each engine owns its graph and plan, whose
    constants land on that worker's device).  ``scheduler=True``
    additionally starts a ``ServeScheduler`` flush loop per worker;
    callers must then stop the schedulers (``worker.scheduler.stop()``)
    when done.
    """
    import torch

    from .engine import CompiledGraphEngine
    from .scheduler import ServeScheduler

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu', ...] to serve "
                "on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    workers = []
    for i, d in enumerate(devices):
        name = f"dev{i}"
        kw = dict(engine_kw)
        kw.setdefault("metrics_labels", {"worker": name})
        if metrics_registry is not None:
            kw.setdefault("metrics_registry", metrics_registry)
        eng = CompiledGraphEngine(graph_factory(), device=d, **kw)
        sched = (ServeScheduler(eng, window_ms=window_ms).start()
                 if scheduler else None)
        workers.append(Worker(name=name, engine=eng, scheduler=sched))
    return workers
