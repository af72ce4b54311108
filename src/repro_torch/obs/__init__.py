"""repro_torch.obs — observability: metrics, tracing, plan profiling.

Counterpart of ``repro.obs``, stdlib only but for ``profile``:

  * ``metrics``  — thread-safe ``MetricsRegistry`` of counters, gauges and
                   exponential-bucket histograms with labels; JSON +
                   Prometheus exporters; process-wide default registry.
                   ``python -m repro_torch.obs.report`` renders a snapshot.
  * ``trace``    — ``Span``/``Tracer`` (context-manager or retroactive
                   ``emit``), parent/child links, JSONL sink; wired through
                   the serving request lifecycle (submit -> queue -> flush
                   -> dispatch -> sync -> scatter -> complete) and the
                   offline call (call -> dispatch -> sync -> gather; a
                   stage and an enqueue span a slot).  Disabled tracing
                   adds zero allocations to the submit and call paths.
  * ``profile``  — opt-in per-segment timing of a ``CompiledPlan``
                   (``plan.profile()``): CUDA events around each segment's
                   eager run on the card, ``time.perf_counter`` on the CPU,
                   joined with the analysis cost report.  The segments'
                   device time inside a graph replay comes instead from
                   ``CompiledPlan.record_segment_times`` (histograms
                   ``plan_segment_device_ms`` / ``plan_replay_device_ms``
                   in the default registry), which the serving engine
                   reads for the last slot of each traced call or flush.

``http.start_metrics_server`` serves the Prometheus text format from a
stdlib HTTP server (``python -m repro_torch.launch.serve --metrics-port``).
"""
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    HistogramSnapshot,
    MetricsRegistry,
    default_registry,
    exponential_buckets,
    nearest_rank,
)
from .http import MetricsServer, start_metrics_server  # noqa: F401
from .profile import (  # noqa: F401
    PlanProfile, SegmentProfile, profile_plan, time_fn, time_fns)
from .trace import JsonlSink, ListSink, Span, Tracer  # noqa: F401
from . import http  # noqa: F401

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "JsonlSink",
    "ListSink",
    "MetricsRegistry",
    "MetricsServer",
    "PlanProfile",
    "SegmentProfile",
    "Span",
    "Tracer",
    "default_registry",
    "exponential_buckets",
    "nearest_rank",
    "profile_plan",
    "start_metrics_server",
    "time_fn",
    "time_fns",
]
