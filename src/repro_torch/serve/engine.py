"""Compiled-QONNX-graph serving engine: slot-batched, pipelined dispatch.

Counterpart of ``repro.serve.engine``.  ``CompiledGraphEngine`` serves
QonnxGraph inference on the compiled tier (``core/compile.py``): the graph
is partitioned onto the kernels once at load, requests are batched into
fixed-size slots (padding to ``max_batch`` keeps one input signature, so
on CUDA the plan's one captured graph is replayed for every slot), and
per-node Python dispatch never appears on the request path.

Dispatch is **pipelined**: a multi-slot flush (or a multi-chunk
``__call__``) enqueues every slot's host-to-device copy, graph replay and
output copy on the current CUDA stream before any host sync, and
synchronizes once at the end.  ``pipeline=False`` synchronizes after each
chunk instead (the baseline the pipelined path is measured against).  On
CUDA each slot is staged in pinned host memory and copied by the plan
straight into its captured graph's static input buffer; each replay's
outputs are copied out before the next replay overwrites them.

With a tracer enabled, the last slot of each call or flush replays the
plan's timed variant (``core/compile.py``, ``segment_timing``), and that
slot's device ms per segment go on the call's or flush's root span and
into the default registry's ``plan_segment_device_ms``.

Thread safety: ``submit`` / ``run_pending`` / ``reload`` / ``__call__``
coordinate through one engine lock, so a background flush loop
(``serve.scheduler.ServeScheduler``) and hot model swaps
(``serve.registry.EngineRegistry``) can race callers safely; the plan's
own lock serializes its captures and replays.  ``reload`` compiles the new
plan outside the lock, then atomically swaps it in and flushes the
still-queued old-model requests through the old plan; the old plan's
graphs and memory pool are freed when the last flush holding it returns.

Every interval timestamp is ``time.monotonic()``; the metric and span
names are the reference's.  ``report_cost=True`` (the default, as in the
reference) logs the analysis tier's inference cost of the served model at
each load.  ``tune`` picks the kernels' launch geometry
(``repro_torch.tune``); ``mesh`` serves a plan sharded data-parallel over
a ``dist.sharding.Mesh`` (``core/compile.py``).
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry, nearest_rank

log = logging.getLogger("repro_torch.serve")

# slot occupancy is a fraction of max_batch — linear buckets
_OCCUPANCY_BUCKETS = tuple(i / 8 for i in range(1, 9))


def percentile_ms(values, pct: float) -> float:
    """Nearest-rank percentile over a latency sample (ms); nan when empty.
    The reference's public name for ``obs.nearest_rank``."""
    return nearest_rank(values, pct)


@dataclass
class GraphRequest:
    """One in-flight inference request — a lightweight future.

    ``submit`` returns it immediately; a flush (caller-driven
    ``run_pending`` or the ``ServeScheduler`` loop) fills ``result`` and
    fires the completion event.  ``wait()`` blocks for the result
    (re-raising a flush-side error).  ``submitted`` / ``started`` /
    ``completed`` / ``deadline`` are ``time.monotonic()`` stamps;
    ``submitted_at`` is the one wall-clock stamp, for logs only.
    """
    x: Optional[torch.Tensor]            # one sample, graph input minus batch
    submitted: float = field(default_factory=time.monotonic)
    submitted_at: float = field(default_factory=time.time)  # wall, logs only
    deadline: Optional[float] = None     # absolute monotonic time it's due
    started: Optional[float] = None      # when the slot was dispatched
    completed: Optional[float] = None
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    trace_id: Optional[str] = None       # set at submit when tracing is on:
    queue_depth: Optional[int] = None    # the request's trace context + the
                                         # queue depth it joined behind
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False, compare=False)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request completes; returns the result row."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request not completed within {timeout}s "
                f"(is a scheduler running / was run_pending called?)")
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
    device (``device=None`` means CUDA, and raises without a GPU), or over
    a mesh (``mesh=``).

    Each flush stacks up to ``max_batch`` requests along the leading dim,
    pads to exactly ``max_batch`` so the plan sees one input signature (on
    CUDA: one captured graph, replayed), dispatches every slot, syncs once
    and scatters the rows back to the requests.
    """

    def __init__(self, graph, *, max_batch: int = 8, use_kernels: bool = True,
                 use_int4: bool = True, interpret: Optional[bool] = None,
                 report_cost: bool = True, pipeline: bool = True,
                 donate="auto", telemetry_window: int = 2048,
                 metrics_registry: Optional[MetricsRegistry] = None,
                 metrics_labels: Optional[dict] = None,
                 tracer=None, observability: bool = True,
                 tune: str = "off", tune_cache_dir: Optional[str] = None,
                 mesh=None, device=None, use_analysis: bool = True):
        """``use_analysis`` (the port's own knob, forwarded to
        ``compile_graph``) False serves the declared-bit-width
        fp32-epilogue plans instead of the analysis-driven integer ones.

        ``donate`` is forwarded to every plan call (on CUDA unless False;
        ignored on the CPU, as in the reference).  The engine's slots are
        fresh pinned host buffers that the plan copies straight into its
        captured slot, so no caller memory is ever handed over and no
        defensive copy is needed.  ``tune`` / ``tune_cache_dir`` go to
        ``compile_graph`` at every (re)load (the launch geometry from the
        tune cache, or searched).  ``mesh`` (a ``Mesh``, or ``"auto"`` for
        ``elastic_mesh(prefer_model=1)``; exclusive with ``device``) is
        passed to ``compile_graph`` at every (re)load: each slot is split
        into one shard per data entry, and donation is off, as in the
        reference (the shards are fresh buffers already)."""
        from repro_torch.core.executor import resolve_device
        from repro_torch.dist.sharding import mesh_argument
        self.mesh = mesh_argument(mesh, device)
        self.device = (resolve_device(device) if self.mesh is None
                       else self.mesh.devices.flat[0])
        self.max_batch = max_batch
        self.queue: list[GraphRequest] = []
        self._lock = threading.RLock()
        self.pipeline = pipeline
        self._donate = self.mesh is None and self.device.type == "cuda" and (
            donate == "auto" or bool(donate))
        # an engine that holds a tracer, enabled or not, has its plans
        # capture the timed variant its traced calls replay
        self._compile_kw = dict(use_kernels=use_kernels, use_int4=use_int4,
                                interpret=interpret, use_analysis=use_analysis,
                                tune=tune, tune_cache_dir=tune_cache_dir,
                                segment_timing=tracer is not None)
        if self.mesh is None:
            self._compile_kw["device"] = self.device
        else:
            self._compile_kw["mesh"] = self.mesh
        self._report_cost = report_cost
        self.cost_report = None
        self.n_completed = 0
        self.n_flushes = 0
        self.n_deadline_misses = 0
        self._closed = False
        # --- observability (repro_torch.obs) --------------------------------
        # A private registry per engine by default, so a fresh engine's
        # counters start at zero; a shared ``metrics_registry`` (plus the
        # per-model ``metrics_labels`` EngineRegistry injects) exports a
        # whole fleet from one endpoint.  ``observability=False`` keeps only
        # the plain-int lifetime counters.  ``tracer`` (obs.Tracer) turns
        # the request lifecycle into submit -> queue -> flush -> dispatch ->
        # sync -> complete spans, and ``__call__`` into call -> dispatch
        # -> sync -> gather; None / disabled adds no work.
        self.metrics = metrics_registry or MetricsRegistry()
        self._metric_labels = dict(metrics_labels or
                                   {"model": getattr(graph, "name", "graph")})
        self._tracer = tracer
        self._obs_on = bool(observability)
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
        # serializes whole reload() calls (compile included) so two racing
        # hot-swaps cannot interleave into last-compile-wins
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
        Whole reloads serialize on a dedicated mutex.  The old plan's
        captured graphs and their memory pool go when the last reference
        (this drain, or a flush in flight on another thread) is dropped."""
        from repro_torch.core.compile import compile_graph
        with self._reload_lock:
            new_plan = compile_graph(graph, **self._compile_kw)
            g = new_plan.graph
            if new_plan.tune_mode != "off":
                ts = new_plan.tuning_stats()
                self.metrics.counter(
                    "serve_tune_cache_hits_total",
                    help="segment geometries answered from the tune cache "
                         "at engine load/reload",
                    labels=self._metric_labels).inc(ts.get("hits", 0))
                self.metrics.counter(
                    "serve_tune_cache_misses_total",
                    help="segment geometries that fell back to the "
                         "heuristic at engine load/reload",
                    labels=self._metric_labels).inc(ts.get("misses", 0))
                log.info(
                    "tune[%s] %s: %d/%d segments tuned (cache hits=%d "
                    "misses=%d searched=%d, graph manifest %s)",
                    new_plan.tune_mode, g.name, ts["tuned_segments"],
                    ts["kernel_segments"], ts.get("hits", 0),
                    ts.get("misses", 0), ts.get("searched", 0),
                    "hit" if ts.get("graph_hit") else "miss")
            self.metrics.gauge(
                "serve_plan_devices",
                help="devices the served plan spans (1 = single-device)",
                labels=self._metric_labels).set(new_plan.n_devices)
            if len(g.inputs) != 1:
                raise ValueError(
                    "CompiledGraphEngine serves single-input graphs")
            with self._lock:
                if self._closed:
                    raise RuntimeError(
                        "engine is closed (unregistered); cannot reload")
                pending, self.queue = self.queue, []
                old_state = (self._serving_state()
                             if self.plan is not None else None)
                self.plan = new_plan
                self.input_name = g.input_names[0]
                self.output_name = g.output_names[0]
                self.sample_shape = tuple(g.inputs[0].shape[1:])
            if pending and old_state is not None:
                self._run_requests(pending, old_state)
            del old_state
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
        ``deadline_ms`` (relative to now) marks when the result is due: the
        ``ServeScheduler`` flushes early to honour it and the engine counts
        misses in ``latency_stats()``."""
        x = torch.as_tensor(np.asarray(x, np.float32)) \
            if not isinstance(x, torch.Tensor) else x.to(torch.float32)
        tr = self._tracer
        tracing = tr is not None and tr.enabled
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "engine is closed (unregistered); no new submits")
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
        r.queue_depth = depth
        if tracing:
            r.trace_id = tr.new_trace_id()
        if self._obs_on:
            self._m_submitted.inc()
            self._m_qdepth.set(depth)
        return r

    def pending(self) -> int:
        return len(self.queue)

    def close(self) -> None:
        """Stop admitting requests (already-queued ones can still flush).
        Used by ``EngineRegistry.unregister`` so a racing submit errors
        loudly instead of stranding a request on an orphaned engine."""
        with self._lock:
            self._closed = True

    def flush_signals(self) -> tuple:
        """(pending, oldest_submitted, min_deadline) snapshot under the
        engine lock: the only queue view a flush loop needs."""
        with self._lock:
            q = self.queue
            oldest = q[0].submitted if q else None
            deadline = min((r.deadline for r in q if r.deadline is not None),
                           default=None)
            return len(q), oldest, deadline

    def _pad_to_slot(self, rows, sample_shape=None) -> torch.Tensor:
        """Zero-pad a (<= max_batch, ...) host chunk (or a list of rows,
        stacked first) to the one slot shape every plan call uses, shared
        by run_pending and __call__ so both reach the same captured graph.
        On CUDA the slot is pinned, so the plan's copy into its captured
        slot is asynchronous."""
        if sample_shape is None:
            sample_shape = self.sample_shape
        if isinstance(rows, list):
            rows = torch.stack(rows)
        pad = self.max_batch - rows.shape[0]
        if pad:
            rows = torch.cat(
                [rows, rows.new_zeros((pad,) + tuple(sample_shape))])
        if self.device.type == "cuda":
            return rows.pin_memory()
        return rows.to(self.device)

    def _sync(self) -> None:
        devices = [self.device] if self.mesh is None else \
            self.mesh.distinct_devices()
        for d in devices:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()

    def run_pending(self, *, only_full_slots: bool = False,
                    reason: Optional[str] = None) -> int:
        """Flush the queue in max_batch-sized slots; returns #requests run.

        Every slot is enqueued before the single trailing sync.
        ``only_full_slots=True`` leaves the partial tail slot queued (the
        scheduler's full-slot trigger uses it, so a request submitted a
        millisecond ago keeps batching through its flush window).
        ``reason`` (the scheduler's trigger: full / window / deadline /
        stop) goes on the flush span and, for a flush that runs requests,
        into ``serve_scheduler_flushes_total{reason}``."""
        with self._lock:
            n = len(self.queue)
            if only_full_slots:
                n = (n // self.max_batch) * self.max_batch
            if n == 0:
                return 0
            reqs, self.queue = self.queue[:n], self.queue[n:]
            depth = len(self.queue)
            state = self._serving_state()
        if self._obs_on:
            self._m_qdepth.set(depth)
            if reason is not None:
                self.metrics.counter(
                    "serve_scheduler_flushes_total",
                    help="scheduler flushes that ran requests, by the "
                         "trigger that fired (full / window / deadline / "
                         "stop)",
                    labels={**self._metric_labels, "reason": reason}).inc()
        return self._run_requests(reqs, state, reason)

    def _dispatch_slot(self, plan, in_name: str, rows, sample_shape,
                       tr=None, parent=None, timed: bool = False):
        """Stage one slot (``_pad_to_slot``) and enqueue its plan call; with
        a tracer, as ``stage`` and ``enqueue`` spans under ``parent``."""
        if tr is None:
            x = self._pad_to_slot(rows, sample_shape)
            return plan({in_name: x}, donate=self._donate)
        with tr.span("stage", parent=parent, rows=len(rows),
                     padded_rows=self.max_batch):
            x = self._pad_to_slot(rows, sample_shape)
        with tr.span("enqueue", parent=parent, timed=timed):
            return plan({in_name: x}, donate=self._donate, timed=timed)

    @staticmethod
    def _segment_attrs(plan) -> dict:
        """The timed slot's per-segment device ms, as span attributes."""
        rows = plan.record_segment_times()
        return {"segments": rows} if rows else {}

    def _run_requests(self, reqs: list, state: tuple,
                      reason: Optional[str] = None) -> int:
        plan, in_name, out_name, sample_shape = state
        tr = self._tracer
        if tr is not None and not tr.enabled:
            tr = None
        n_slots = -(-len(reqs) // self.max_batch)
        flush = disp = None
        if tr is not None:
            flush = tr.span(
                "flush", n_requests=len(reqs), n_slots=n_slots,
                slot_occupancy=round(len(reqs) / (n_slots * self.max_batch),
                                     4),
                pipeline=self.pipeline, reason=reason)
            disp = tr.span("dispatch", parent=flush, n_slots=n_slots)
        dispatched = []
        try:
            for i in range(0, len(reqs), self.max_batch):
                batch = reqs[i:i + self.max_batch]
                t_dispatch = time.monotonic()
                for r in batch:
                    r.started = t_dispatch
                out = self._dispatch_slot(
                    plan, in_name, [r.x for r in batch], sample_shape, tr,
                    disp, timed=len(dispatched) == n_slots - 1)[out_name]
                dispatched.append((batch, out))
                if self._obs_on:
                    self._m_occupancy.observe(len(batch) / self.max_batch)
                if not self.pipeline:          # per-slot host sync: baseline
                    self._sync()
            if tr is not None:
                disp.end()
                sync = tr.span("sync", parent=flush)
            if self.pipeline:                  # single trailing sync
                self._sync()
            if tr is not None:
                sync.end()
        except Exception as e:
            # scope the failure: every dispatched slot whose compute
            # succeeded still completes and counts; only requests in
            # failing or never-dispatched slots carry the error
            completed = []
            for batch, out in dispatched:
                try:
                    self._scatter(batch, out)
                    completed.extend(batch)
                except Exception:              # this slot really failed
                    pass
            for r in reqs:
                if not r.done():
                    r._finish(error=e)
            if completed:
                self._record(completed)
            raise
        if tr is not None:
            flush.set(**self._segment_attrs(plan))
            scatter = tr.span("scatter", parent=flush)
        for batch, out in dispatched:
            self._scatter(batch, out)
        if tr is not None:
            scatter.end()
            flush.end()
        self._record(reqs)
        return len(reqs)

    @staticmethod
    def _scatter(batch: list, out) -> None:
        rows = out.cpu().numpy()
        for j, r in enumerate(batch):
            # copy the row so a held future pins one row, not the slot
            r._finish(rows[j].copy())

    def _record(self, reqs: list) -> None:
        n_miss = sum(1 for r in reqs if r.deadline is not None and
                     r.completed is not None and r.completed > r.deadline)
        with self._lock:
            self.n_deadline_misses += n_miss
            self.n_completed += len(reqs)
            self.n_flushes += 1
        if self._obs_on:
            for r in reqs:
                if r.latency_ms is not None:
                    self._m_lat.observe(r.latency_ms)
                if r.queued_ms is not None:
                    self._m_queued.observe(r.queued_ms)
            self._m_completed.inc(len(reqs))
            self._m_flushes.inc()
            if n_miss:
                self._m_misses.inc(n_miss)
        tr = self._tracer
        if tr is not None and tr.enabled:
            for r in reqs:
                if r.trace_id is None or r.completed is None:
                    continue
                missed = (r.deadline is not None and
                          r.completed > r.deadline)
                root = tr.emit(
                    "request", r.submitted, r.completed,
                    trace_id=r.trace_id, queue_depth=r.queue_depth,
                    deadline_missed=missed,
                    error=type(r.error).__name__ if r.error else None)
                if r.started is not None:
                    tr.emit("queued", r.submitted, r.started,
                            trace_id=r.trace_id, parent_id=root)
                    tr.emit("compute", r.started, r.completed,
                            trace_id=r.trace_id, parent_id=root)
        # percentiles and formatting stay off the engine lock, and are
        # skipped when nobody listens at INFO
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
        """Aggregate request telemetry: lifetime totals (``*_total`` and
        the historical unsuffixed names) and percentiles over the rolling
        ``telemetry_window``; nan percentiles with ``observability=False``."""
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
        tail chunk zero-padded, so ad-hoc batch sizes reuse the one
        captured graph; with ``pipeline=True`` every chunk is enqueued
        before one trailing sync.

        With the tracer enabled the call is one trace: ``call`` (rows,
        slots) over ``dispatch`` (a ``stage`` and an ``enqueue`` a slot),
        ``sync`` and ``gather``; the last slot replays the plan's timed
        variant, and its per-segment device ms land on ``call``."""
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
        tr = self._tracer
        if tr is not None and not tr.enabled:
            tr = None
        rows = x.shape[0]
        root = disp = None
        if tr is not None:
            n_slots = -(-rows // self.max_batch)
            root = tr.span("call", rows=rows, slots=n_slots)
            disp = tr.span("dispatch", parent=root, n_slots=n_slots)
        outs = []
        for i in range(0, rows, self.max_batch):
            chunk = x[i:i + self.max_batch]
            out = self._dispatch_slot(
                plan, in_name, chunk, sample_shape, tr, disp,
                timed=i + self.max_batch >= rows)[out_name]
            outs.append(out[:chunk.shape[0]])
            if not self.pipeline:
                self._sync()                    # per-chunk stall: baseline
        if tr is not None:
            disp.end()
            sync = tr.span("sync", parent=root)
        if self.pipeline:
            self._sync()                        # one sync for all chunks
        if tr is not None:
            sync.end()
            root.set(**self._segment_attrs(plan))
            gather = tr.span("gather", parent=root)
        result = np.concatenate([o.cpu().numpy() for o in outs], axis=0)
        if tr is not None:
            gather.end()
            root.end()
        return result[0] if unbatched else result
