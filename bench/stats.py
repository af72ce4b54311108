"""Percentiles, copied from the port's ``obs.metrics.nearest_rank`` so that
the yardstick does not move with the program."""
from __future__ import annotations


def nearest_rank(values, pct: float) -> float:
    """Nearest-rank percentile over a raw sample; nan when empty."""
    if not values:
        return float("nan")
    vs = sorted(values)
    k = min(len(vs) - 1, max(0, int(round(pct / 100.0 * (len(vs) - 1)))))
    return float(vs[k])
