"""repro_torch.obs — observability (metrics so far)."""
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, HistogramSnapshot, MetricsRegistry,
    default_registry, exponential_buckets, nearest_rank)
