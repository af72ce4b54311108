"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line's fields.

``run_cell`` takes the device as an argument: ``run.py`` hands it the card
and refuses to run without one; the CPU tests hand it the CPU at small
sizes to drive everything but the card.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from bench import check, manifest, model, seeded
from bench.loadgen import LOOPS
from bench.stats import nearest_rank


@dataclass
class Run:
    """What a finished run hands the metric readers."""
    cfg: dict
    setup_s: float
    record: dict                 # the measured window (``loadgen``)
    window_s: float
    trace: Optional[dict]        # the traced slice (``devtrace``) or None


def draw(cfg: dict, seed: int) -> tuple:
    """(weights, image pool) of a configuration and seed."""
    import torch
    return (seeded.draw_params(cfg, seed),
            torch.from_numpy(seeded.draw_images(cfg, seed,
                                                cfg["pool_images"])))


def serve(cfg: dict, params: list, device, tracer=None):
    """The program's compiled tier as served: integer path, fusion on, no
    tuning, one engine of ``max_batch`` rows a slot."""
    from repro_torch.serve.engine import CompiledGraphEngine
    return CompiledGraphEngine(
        model.build_graph(cfg, params), max_batch=cfg["max_batch"],
        report_cost=False, tracer=tracer, device=device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             bm: Optional[dict] = None, cfg: Optional[dict] = None,
             traffic: Optional[dict] = None) -> tuple:
    """Returns (result, info lines).  ``t_start`` is the process start on
    the monotonic clock; ``cfg`` and ``traffic`` replace the cell's files
    (the tests' small sizes and rates)."""
    import torch
    from repro_torch.obs.trace import ListSink, Tracer

    t_start = time.monotonic() if t_start is None else t_start
    bm = manifest.load() if bm is None else bm
    cell = manifest.cell(bm, workload)
    cfg = manifest.load_config(bm, cell["config"]) if cfg is None else cfg
    if traffic is None:
        traffic = manifest.load_traffic(cell["traffic"])
    on_card = torch.device(device).type == "cuda"

    spans = ListSink()
    tracer = Tracer(spans, enabled=False)
    phases = [("imports", time.monotonic() - t_start)]
    params, pool = draw(cfg, seed)
    phases.append(("draw", time.monotonic() - t_start))
    engine = serve(cfg, params, device, tracer)
    loop = LOOPS[traffic["loop"]](engine, traffic, pool,
                                  seeded.traffic_rng(seed))
    phases.append(("compile and pool", time.monotonic() - t_start))
    loop.warm()                           # a first run builds the kernels
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    phases.append(("warm-up and capture", setup_s))

    record = loop.run(seconds)
    window_s = record["t1"] - record["t0"]
    summary = None
    if trace:
        from bench.devtrace import traced

        def run_slice():
            tracer.enabled = True
            try:
                return loop.run(traffic["trace_seconds"])
            finally:
                tracer.enabled = False
        sliced, summary = traced(run_slice, spans)
        summary["replays"] = sliced["replays"]
    loop.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    index, served = loop.sample(record, cfg["check"]["rows"],
                                seeded.sample_rng(seed))
    del loop, engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    ref = check.reference_rows(cfg, params, pool, index, device=device)
    err = check.logit_rel_err(served, ref)
    ref_s = time.monotonic() - t_check

    run = Run(cfg, setup_s, record, window_s, summary)
    metrics = {}
    for m in manifest.metrics_for(bm, workload, trace):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limit = cfg["check"]["logit_rel_err_limit"]
    checks = {"logit_rel_err": {"value": err, "limit": limit},
              "lost_requests": {"value": record["lost"], "limit": 0}}
    correct = err <= limit and record["lost"] == 0
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result, _info(workload, seed, run, len(index), phases, ref_s)


def _info(workload: str, seed: int, run: Run, n_checked: int,
          phases: list, ref_s: float) -> list:
    rec = run.record
    lines = [f"cell {workload} seed {seed}: setup {run.setup_s:.3f} s, "
             f"window {run.window_s:.3f} s, {rec['completed']} of "
             f"{rec['attempted']} completed, {rec['replays']} replays, "
             f"{n_checked} rows checked against the reference in "
             f"{ref_s:.3f} s",
             "set-up reached, from the process start: " + ", ".join(
                 f"{name} {t:.3f} s" for name, t in phases)]
    if "latency_ms" in rec:
        lat = rec["latency_ms"]
        late = np.asarray(rec["late_s"]) * 1e3
        lines.append(
            f"latency p50 {nearest_rank(lat, 50):.3f} ms, p95 "
            f"{nearest_rank(lat, 95):.3f} ms over {len(lat)} requests "
            f"({rec['refused']} refused, {rec['lost']} lost); generator "
            f"late p50 {np.median(late):.3f} ms, p99 "
            f"{np.percentile(late, 99):.3f} ms, max {late.max():.3f} ms")
    if run.trace is not None:
        t = run.trace
        lines.append(f"trace: busy {t['busy_s']:.6f} s of {t['window_s']:.6f}"
                     f" s, kernels {t['kernel_s']:.6f} s over {t['replays']}"
                     f" replays")
    return lines
