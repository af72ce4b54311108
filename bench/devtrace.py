"""A traced slice of a run: ``torch.profiler`` over the card and the host,
reduced to device busy time, kernel time, the device operations that took
most time and the device's idle gaps by what the host was doing.

The trace goes to a temporary directory under ``TMPDIR`` and is deleted
once read.  Idle gaps are labelled with the innermost host range on each
thread at the gap's middle: the benchmark's own ``record_function``
ranges, torch's op and runtime names, and the engine's flush / dispatch /
sync spans (``obs.Tracer``, monotonic clock, placed on the trace's clock
by the slice's own range).
"""
from __future__ import annotations

import bisect
import json
import tempfile
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
ENGINE_SPANS = ("flush", "dispatch", "sync")
SLICE = "bench.trace_slice"
TOP = 10


def traced(run_slice, spans: list) -> tuple:
    """Run ``run_slice()`` under the profiler; returns (its result, the
    trace's summary).  ``spans`` is the engine tracer's sink, filled while
    the slice runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as d:
        with profile(activities=acts) as prof:
            with record_function(SLICE):
                t_mono = time.monotonic()
                result = run_slice()
            torch.cuda.synchronize()
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return result, summarize(events, t_mono, spans)


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(starts: list, evs: list, t: float):
    """Name of the innermost event of one thread (sorted by start) that
    holds ``t``; ranges on one thread nest, so it is the latest-starting
    one that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 4096), -1):
        a, b, name = evs[j]
        if b >= t:
            return name
    return None


def summarize(events: list, t_mono: float, spans: list) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    sl = next(e for e in xs if e.get("name") == SLICE
              and e.get("cat") == "user_annotation")
    s0, s1 = float(sl["ts"]), float(sl["ts"]) + float(sl["dur"])
    dev, per_op, kernel_us = [], defaultdict(float), 0.0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(s0, float(e["ts"]))
        b = min(s1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        dev.append((a, b))
        per_op[e["name"][:200]] += b - a
        if e["cat"] == "kernel":
            kernel_us += b - a
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, at = [], s0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if s1 > at:
        gaps.append((at, s1))

    threads = defaultdict(list)
    for e in xs:
        if e.get("cat") in HOST_CATS and e.get("name") != SLICE:
            a = float(e["ts"])
            threads[e.get("tid")].append((a, a + float(e["dur"]), e["name"]))
    offset = s0 - t_mono * 1e6           # monotonic seconds -> trace us
    for sp in spans:
        if sp["name"] in ENGINE_SPANS:
            threads["engine spans"].append(
                (sp["t0"] * 1e6 + offset, sp["t1"] * 1e6 + offset,
                 f"engine.{sp['name']}"))
    index = {}
    for tid, evs in threads.items():
        evs.sort()
        index[tid] = ([a for a, _, _ in evs], evs)
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        names = {_innermost(st, evs, mid) for st, evs in index.values()}
        names.discard(None)
        idle[" + ".join(sorted(names)) or "no host range"] += b - a

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"window_s": (s1 - s0) / 1e6, "busy_s": busy_us / 1e6,
            "kernel_s": kernel_us / 1e6, "device_ops": top(per_op),
            "idle_gaps": top(idle)}
