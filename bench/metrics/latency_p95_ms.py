"""95th percentile, over every request due in the window, of the time from
when it was due to its result (host clock); a refused or failed request
counts as never completing.  None where the mix times no requests or the
tail is infinite."""
import math

from bench.stats import nearest_rank


def read(run):
    lat = run.record.get("latency_ms")
    if not lat:
        return None
    p95 = nearest_rank(lat, 95)
    return p95 if math.isfinite(p95) else None
