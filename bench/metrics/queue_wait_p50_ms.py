"""Median, over the window's completed requests, of the time from when a
request was due to its slot's dispatch (``GraphRequest.started``)."""
from bench.stats import nearest_rank


def read(run):
    waits = run.record.get("queue_wait_ms")
    return nearest_rank(waits, 50) if waits else None
