"""Compiled-QONNX-graph serving engine: slot-batched, pipelined dispatch.

Counterpart of ``repro.serve.engine``.  ``CompiledGraphEngine`` serves
QonnxGraph inference on the compiled tier (``core/compile.py``): the graph
is partitioned onto the kernels once at load, requests are batched into
fixed-size slots (padding to ``max_batch`` keeps every kernel launch at
one shape), and per-node Python dispatch never appears on the request
path.

Dispatch is **pipelined**: a multi-slot flush (or a multi-chunk
``__call__``) enqueues every slot's host-to-device copy and kernels on the
current CUDA stream before any host sync, and synchronizes once at the
end.  ``pipeline=False`` synchronizes after each chunk instead (the
baseline the pipelined path is measured against).  On CUDA each slot is
staged in pinned host memory so its copy to the device is asynchronous.

Thread safety: ``submit`` / ``run_pending`` / ``reload`` / ``__call__``
coordinate through one engine lock.  ``reload`` compiles the new plan
outside the lock, then atomically swaps it in and flushes the
still-queued old-model requests through the old plan.

Every interval timestamp is ``time.monotonic()``; the metric names are the
reference's.  ``report_cost=True`` (the default, as in the reference) logs
the analysis tier's inference cost of the served model at each load.
Request tracing (``tracer=``) needs ``obs/trace.py``, which is not ported
yet, and raises ``NotImplementedError``.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry

log = logging.getLogger("repro_torch.serve")

# slot occupancy is a fraction of max_batch — linear buckets
_OCCUPANCY_BUCKETS = tuple(i / 8 for i in range(1, 9))


@dataclass
class GraphRequest:
    """One in-flight inference request — a lightweight future.

    ``submit`` returns it immediately; a flush fills ``result`` and fires
    the completion event.  ``wait()`` blocks for the result (re-raising a
    flush-side error).  ``submitted`` / ``started`` / ``completed`` /
    ``deadline`` are ``time.monotonic()`` stamps.
    """
    x: Optional[torch.Tensor]            # one sample, graph input minus batch
    submitted: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None     # absolute monotonic time it's due
    started: Optional[float] = None      # when the slot was dispatched
    completed: Optional[float] = None
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False, compare=False)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request completes; returns the result row."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request not completed within {timeout}s "
                f"(was run_pending called?)")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def latency_ms(self) -> Optional[float]:
        """submit -> result, ms; None while in flight."""
        if self.completed is None:
            return None
        return (self.completed - self.submitted) * 1e3

    @property
    def queued_ms(self) -> Optional[float]:
        """submit -> slot dispatch, ms; None while queued."""
        if self.started is None:
            return None
        return (self.started - self.submitted) * 1e3

    def _finish(self, result=None, error: Optional[BaseException] = None):
        self.completed = time.monotonic()
        self.result = result
        self.error = error
        self.x = None          # a held future must not pin its input
        self._event.set()


class CompiledGraphEngine:
    """Slot-batched, pipelined inference over a compiled QonnxGraph on one
    device (``device=None`` means CUDA, and raises without a GPU)."""

    def __init__(self, graph, *, max_batch: int = 8, use_int4: bool = True,
                 pipeline: bool = True, telemetry_window: int = 2048,
                 tracer=None, report_cost: bool = True,
                 use_analysis: bool = True, device=None):
        """``use_analysis`` (the port's own knob, forwarded to
        ``compile_graph``) False serves the declared-bit-width
        fp32-epilogue plans instead of the analysis-driven integer ones."""
        if tracer is not None:
            raise NotImplementedError(
                "tracer= needs obs/trace.py: ROADMAP.md A14")
        from repro_torch.core.executor import resolve_device
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.queue: list[GraphRequest] = []
        self._lock = threading.RLock()
        self.pipeline = pipeline
        self._compile_kw = dict(use_int4=use_int4, use_analysis=use_analysis,
                                device=self.device)
        self._report_cost = report_cost
        self.cost_report = None
        self.n_completed = 0
        self.n_flushes = 0
        self.n_deadline_misses = 0
        # a private registry per engine, so its counters start at zero
        self.metrics = MetricsRegistry()
        self._metric_labels = {"model": getattr(graph, "name", "graph")}
        self.telemetry_window = telemetry_window
        m, lbl = self.metrics, self._metric_labels
        self._m_submitted = m.counter(
            "serve_requests_submitted_total",
            help="requests admitted by submit()", labels=lbl)
        self._m_completed = m.counter(
            "serve_requests_completed_total",
            help="requests completed (result or error)", labels=lbl)
        self._m_flushes = m.counter(
            "serve_flushes_total", help="run_pending flushes", labels=lbl)
        self._m_misses = m.counter(
            "serve_deadline_misses_total",
            help="requests completed after their deadline", labels=lbl)
        self._m_lat = m.histogram(
            "serve_request_latency_ms", unit="ms",
            help="submit -> result latency", window=telemetry_window,
            labels=lbl)
        self._m_queued = m.histogram(
            "serve_request_queued_ms", unit="ms",
            help="submit -> slot dispatch wait", window=telemetry_window,
            labels=lbl)
        self._m_qdepth = m.gauge(
            "serve_queue_depth", help="requests waiting for a flush",
            labels=lbl)
        self._m_occupancy = m.histogram(
            "serve_slot_occupancy",
            help="real requests per dispatched slot / max_batch",
            buckets=_OCCUPANCY_BUCKETS, window=telemetry_window, labels=lbl)
        self._reload_lock = threading.Lock()
        self.plan = None
        self.reload(graph)

    # ------------------------------------------------------------- loading

    def reload(self, graph) -> None:
        """(Re)compile ``graph`` and atomically swap it in as the served plan.

        The compile runs outside the engine lock, so requests keep being
        submitted to — and flushed through — the old plan meanwhile.  Under
        the lock the still-queued requests (submitted for the old model)
        are popped with a snapshot of the old serving state and the plan is
        replaced; the popped requests then drain through the *old* plan.
        Whole reloads serialize on a dedicated mutex."""
        from repro_torch.core.compile import compile_graph
        with self._reload_lock:
            new_plan = compile_graph(graph, **self._compile_kw)
            g = new_plan.graph
            if len(g.inputs) != 1:
                raise ValueError(
                    "CompiledGraphEngine serves single-input graphs")
            with self._lock:
                pending, self.queue = self.queue, []
                old_state = (self._serving_state()
                             if self.plan is not None else None)
                self.plan = new_plan
                self.input_name = g.input_names[0]
                self.output_name = g.output_names[0]
                self.sample_shape = tuple(g.inputs[0].shape[1:])
            if pending and old_state is not None:
                self._run_requests(pending, old_state)
            # cost telemetry stays inside the reload mutex, so racing
            # reloads cannot leave cost_report describing a retired model
            self.cost_report = None
            if self._report_cost:
                self._log_cost(g, new_plan)

    def _log_cost(self, g, plan) -> None:
        """The analysis tier's inference cost of the served model, logged
        once at load; it reuses the plan's GraphAnalysis.  Cost is
        telemetry, not a gate: a failure is logged, not raised."""
        try:
            from repro_torch.analysis import infer_cost
            self.cost_report = infer_cost(g, ga=plan.analysis)
            gstats = plan.grouped_conv_stats()
            rq = plan.requant_stats()
            log.info(
                "loaded %s: %d layers, %s MACs, %.3g BOPs, %s weight bits, "
                "%.1f KiB traffic/inference, fused=%s (%d conv segments on "
                "kernels, %d grouped/depthwise reclaiming %s MACs + %s "
                "carrier bytes vs block-diagonal, integer requant %d/%d, "
                "interp=%s)",
                g.name, len(self.cost_report.layers),
                f"{self.cost_report.macs:,}", self.cost_report.bops,
                f"{int(self.cost_report.total_weight_bits):,}",
                self.cost_report.total_mem_bytes / 1024,
                plan.fused_counts, self.conv_segments_fused,
                gstats["grouped_segments"], f"{gstats['reclaimed_macs']:,}",
                f"{gstats['carrier_bytes_saved']:,}", rq["int32_segments"],
                rq["kernel_segments"], plan.interp_op_counts())
        except Exception:
            log.exception("cost analysis failed for %s", g.name)

    def _serving_state(self) -> tuple:
        """Consistent (plan, names, shape) snapshot, taken under the lock."""
        return (self.plan, self.input_name, self.output_name,
                self.sample_shape)

    # read through to the current plan, so a reload() shows at once
    @property
    def fused_counts(self) -> dict:
        return dict(self.plan.fused_counts)

    @property
    def conv_segments_fused(self) -> int:
        return sum(v for k, v in self.plan.fused_counts.items()
                   if k.startswith("quant_conv"))

    @property
    def grouped_conv_stats(self) -> dict:
        return self.plan.grouped_conv_stats()

    # ------------------------------------------------------------ requests

    def submit(self, x, *, deadline_ms: Optional[float] = None
               ) -> GraphRequest:
        """Queue one sample; returns its ``GraphRequest`` future.
        ``deadline_ms`` (relative to now) marks when the result is due; the
        engine counts misses in ``latency_stats()``."""
        x = torch.as_tensor(np.asarray(x, np.float32)) \
            if not isinstance(x, torch.Tensor) else x.to(torch.float32)
        with self._lock:
            if tuple(x.shape) == (1,) + self.sample_shape:  # pre-batched row
                x = x[0]
            if tuple(x.shape) != self.sample_shape:
                raise ValueError(
                    f"sample shape {tuple(x.shape)} != {self.sample_shape}")
            r = GraphRequest(x.cpu())
            if deadline_ms is not None:
                r.deadline = r.submitted + deadline_ms / 1e3
            self.queue.append(r)
            depth = len(self.queue)
        self._m_submitted.inc()
        self._m_qdepth.set(depth)
        return r

    def pending(self) -> int:
        return len(self.queue)

    def _slot(self, rows: torch.Tensor, sample_shape) -> torch.Tensor:
        """Zero-pad a (<= max_batch, ...) host chunk to the one slot shape
        every plan call uses and enqueue its copy to the device (pinned and
        asynchronous on CUDA)."""
        pad = self.max_batch - rows.shape[0]
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad,) + tuple(sample_shape))])
        if self.device.type == "cuda":
            return rows.pin_memory().to(self.device, non_blocking=True)
        return rows.to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def run_pending(self, *, only_full_slots: bool = False) -> int:
        """Flush the queue in max_batch-sized slots; returns #requests run.

        Every slot is enqueued before the single trailing sync.
        ``only_full_slots=True`` leaves the partial tail slot queued."""
        with self._lock:
            n = len(self.queue)
            if only_full_slots:
                n = (n // self.max_batch) * self.max_batch
            if n == 0:
                return 0
            reqs, self.queue = self.queue[:n], self.queue[n:]
            depth = len(self.queue)
            state = self._serving_state()
        self._m_qdepth.set(depth)
        return self._run_requests(reqs, state)

    def _run_requests(self, reqs: list, state: tuple) -> int:
        plan, in_name, out_name, sample_shape = state
        dispatched = []
        try:
            for i in range(0, len(reqs), self.max_batch):
                batch = reqs[i:i + self.max_batch]
                t_dispatch = time.monotonic()
                for r in batch:
                    r.started = t_dispatch
                x = self._slot(torch.stack([r.x for r in batch]), sample_shape)
                out = plan({in_name: x})[out_name]
                dispatched.append((batch, out))
                self._m_occupancy.observe(len(batch) / self.max_batch)
                if not self.pipeline:          # per-slot host sync: baseline
                    self._sync()
            if self.pipeline:                  # single trailing sync
                self._sync()
        except Exception as e:
            for r in reqs:
                if not r.done():
                    r._finish(error=e)
            raise
        for batch, out in dispatched:
            rows = out.cpu().numpy()
            for j, r in enumerate(batch):
                # copy the row so a held future pins one row, not the slot
                r._finish(rows[j].copy())
        self._record(reqs)
        return len(reqs)

    def _record(self, reqs: list) -> None:
        n_miss = sum(1 for r in reqs if r.deadline is not None and
                     r.completed is not None and r.completed > r.deadline)
        with self._lock:
            self.n_deadline_misses += n_miss
            self.n_completed += len(reqs)
            self.n_flushes += 1
        for r in reqs:
            if r.latency_ms is not None:
                self._m_lat.observe(r.latency_ms)
            if r.queued_ms is not None:
                self._m_queued.observe(r.queued_ms)
        self._m_completed.inc(len(reqs))
        self._m_flushes.inc()
        if n_miss:
            self._m_misses.inc(n_miss)
        if log.isEnabledFor(logging.INFO):
            stats = self.latency_stats()
            log.info(
                "flush: %d request(s) (%d total over %d flushes) "
                "latency p50=%.2fms p99=%.2fms, queued p50=%.2fms "
                "p99=%.2fms, %d deadline miss(es)",
                len(reqs), stats["completed"], stats["flushes"],
                stats["latency_p50_ms"], stats["latency_p99_ms"],
                stats["queued_p50_ms"], stats["queued_p99_ms"],
                stats["deadline_misses"])

    def latency_stats(self) -> dict:
        """Aggregate request telemetry: lifetime totals and percentiles over
        the rolling ``telemetry_window``."""
        with self._lock:
            completed, flushes = self.n_completed, self.n_flushes
            misses = self.n_deadline_misses
        lat = self._m_lat.snapshot()
        qd = self._m_queued.snapshot()
        return {
            "completed": completed,
            "flushes": flushes,
            "deadline_misses": misses,
            "completed_total": completed,
            "flushes_total": flushes,
            "deadline_misses_total": misses,
            "telemetry_window": self.telemetry_window,
            "window_observations": len(lat.window),
            "latency_p50_ms": lat.percentile(50),
            "latency_p99_ms": lat.percentile(99),
            "queued_p50_ms": qd.percentile(50),
            "queued_p99_ms": qd.percentile(99),
        }

    # ---------------------------------------------------- synchronous path

    def __call__(self, x) -> np.ndarray:
        """Synchronous convenience path through the same padded slot shape
        as ``run_pending``: the batch is split into max_batch chunks, the
        tail chunk zero-padded; with ``pipeline=True`` every chunk is
        enqueued before one trailing sync."""
        x = torch.as_tensor(np.asarray(x, np.float32)) \
            if not isinstance(x, torch.Tensor) else x.to(torch.float32).cpu()
        with self._lock:
            plan, in_name, out_name, sample_shape = self._serving_state()
        unbatched = tuple(x.shape) == sample_shape
        if unbatched:
            x = x[None]
        if tuple(x.shape[1:]) != sample_shape:
            raise ValueError(
                f"sample shape {tuple(x.shape[1:])} != {sample_shape}")
        if x.shape[0] == 0:
            # empty batch: the output shape / dtype from shape inference
            info = plan.graph.value_info[out_name]
            return np.zeros((0,) + tuple(info.shape[1:]), info.dtype)
        outs = []
        for i in range(0, x.shape[0], self.max_batch):
            chunk = x[i:i + self.max_batch]
            out = plan({in_name: self._slot(chunk, sample_shape)})[out_name]
            outs.append(out[:chunk.shape[0]])
            if not self.pipeline:
                self._sync()                    # per-chunk stall: baseline
        if self.pipeline:
            self._sync()                        # one sync for all chunks
        result = np.concatenate([o.cpu().numpy() for o in outs], axis=0)
        return result[0] if unbatched else result
