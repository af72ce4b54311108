"""Per-segment kernel profiling of a ``CompiledPlan``.

Counterpart of ``repro.obs.profile``.  On the card a plan call is one
replay of a captured CUDA graph.  The device time of each segment
*inside* that replay comes from ``CompiledPlan.record_segment_times``
(a plan compiled with ``segment_timing``, called with ``timed=True``);
this module stays the eager per-segment view joined with the cost
report.  ``profile_plan`` re-runs the plan **segment by
segment**, each segment eagerly on its own (the counterpart of the
reference's per-segment ``jax.jit``), timed with CUDA events on the card
and ``time.perf_counter`` on the CPU (best of N after a warm call), and
**joins** the measurements with the analysis tier's cost report
(``repro_torch.analysis.infer_cost``): every row carries measured ms, MACs
and achieved MACs/s, the analysis' minimal memory traffic against the
bytes the segment actually moved, and the requantization path.

``plan_ms`` is the whole plan call (``jit=True``: the graph replay on the
card, the eager call on the CPU).  Each segment's eager time includes its
own launch overhead, so ``sum_segments_ms`` is an upper bound of where the
time goes and the gap to ``plan_ms`` is what one replay saves.

``bw_gbps`` has no default: a caller that wants the roofline column
passes its card's peak (the H100 SXM data sheet's 3,350 GB/s, say) and
states the card's name and power limit beside it.

Usage::

    from repro_torch.obs import profile_plan
    prof = profile_plan(plan, repeats=20)
    print(prof.table())               # or prof.to_json()
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

__all__ = ["SegmentProfile", "PlanProfile", "profile_plan", "time_fn",
           "time_fns", "time_fns_graphed"]


def _sync_result(out) -> None:
    """Wait for every CUDA tensor in ``out`` (a tensor, dict or list)."""
    if isinstance(out, dict):
        out = list(out.values())
    elif isinstance(out, torch.Tensor):
        out = [out]
    for d in {v.device for v in out or ()
              if isinstance(v, torch.Tensor) and v.device.type == "cuda"}:
        torch.cuda.synchronize(d)


def _once_s(fn, device) -> float:
    """Seconds of one ``fn()``: CUDA events on a CUDA ``device``, else the
    host clock around the call and a wait for its CUDA results."""
    if device is not None and torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    _sync_result(fn())
    return time.perf_counter() - t0


def time_fn(fn, repeats: int = 5, *, warmup: int = 1, device=None) -> float:
    """Best-of-``repeats`` seconds of ``fn()``.

    ``device`` a CUDA device: each call is bracketed by CUDA events on
    the current stream (device time from the first launch to the last);
    otherwise the host clock, the call's CUDA results waited for.
    ``warmup`` unmeasured calls absorb first-call costs (a capture, a
    library load).  Best-of because scheduling noise only adds."""
    for _ in range(warmup):
        _sync_result(fn())
    return min((_once_s(fn, device) for _ in range(repeats)),
               default=math.inf)


def time_fns(fns, repeats: int = 5, *, warmup: int = 1,
             device=None) -> list[float]:
    """Best-of-``repeats`` seconds for each fn, measured in alternating
    rounds so drift during the run cannot favour one contestant."""
    for fn in fns:
        for _ in range(warmup):
            _sync_result(fn())
    best = [math.inf] * len(fns)
    for _ in range(repeats):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], _once_s(fn, device))
    return best


def time_fns_graphed(fns, repeats: int = 5, *, reps: int = 10,
                     device=None) -> list[float]:
    """Best-of-``repeats`` device seconds per call for each fn on a CUDA
    ``device``: each fn's ``reps`` back-to-back calls are captured in one
    CUDA graph (after two warm calls on a side stream), and the replays are
    timed with CUDA events in alternating rounds, so the host's launch path
    is out of the measurement.  The graphs and what they allocated are
    freed on return.  Raises on a device that is not CUDA."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"time_fns_graphed times on a CUDA device, not {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        graphs = []
        for fn in fns:
            side = torch.cuda.Stream(dev)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(2):
                    fn()
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    fn()
            graphs.append(graph)
        torch.cuda.synchronize(dev)
        best = [math.inf] * len(graphs)
        for _ in range(repeats):
            for i, graph in enumerate(graphs):
                best[i] = min(best[i], _once_s(graph.replay, dev) / reps)
        del graphs
    return best


@dataclass
class SegmentProfile:
    """One profiled segment joined with its analysis-report layers."""
    index: int
    kind: str
    ops: str                          # "+"-joined op types
    measured_ms: float                # best-of-repeats
    macs: int                         # per sample, from the cost report
    macs_per_s: float                 # measured, batch-scaled
    analysis_bytes: float             # analysis minimal traffic (roofline)
    achieved_bytes: float             # bytes the segment actually moved
    achieved_gbps: float
    requant: Optional[str]            # "int32" / "fp32" / None
    layers: list = field(default_factory=list)   # joined layer names
    roofline_ms: Optional[float] = None          # analysis_bytes / peak BW
    roofline_frac: Optional[float] = None        # roofline_ms / measured_ms

    def to_json(self) -> dict:
        return {
            "segment": self.index, "kind": self.kind, "ops": self.ops,
            "measured_ms": round(self.measured_ms, 4),
            "macs": self.macs,
            "macs_per_s": round(self.macs_per_s, 1),
            "analysis_bytes": round(self.analysis_bytes, 1),
            "achieved_bytes": round(self.achieved_bytes, 1),
            "achieved_gbps": round(self.achieved_gbps, 4),
            "requant": self.requant, "layers": self.layers,
            "roofline_ms": self.roofline_ms,
            "roofline_frac": self.roofline_frac,
        }


@dataclass
class PlanProfile:
    """Whole-plan profile: per-segment rows + aggregate timings."""
    graph_name: str
    batch: int
    repeats: int
    segments: list[SegmentProfile]
    plan_ms: float                    # one plan call (a replay on the card)
    sum_segments_ms: float
    bw_gbps: Optional[float] = None   # peak used for the roofline column
    device: str = "cpu"               # where it was measured (card name)

    @property
    def total_macs(self) -> int:
        return sum(s.macs for s in self.segments)

    @property
    def macs_per_s(self) -> float:
        return (self.total_macs * self.batch / (self.plan_ms / 1e3)
                if self.plan_ms else 0.0)

    def table(self) -> str:
        head = (f"{'seg':>3s} {'kind':22s} {'ops':26s} {'ms':>8s} "
                f"{'MACs':>12s} {'GMAC/s':>8s} {'KiB(min)':>9s} "
                f"{'KiB(act)':>9s} {'GB/s':>7s} {'requant':>7s}")
        if self.bw_gbps:
            head += f" {'roofline':>8s}"
        lines = [head, "-" * len(head)]
        for s in self.segments:
            line = (f"{s.index:3d} {s.kind[:22]:22s} {s.ops[:26]:26s} "
                    f"{s.measured_ms:8.3f} {s.macs:12,d} "
                    f"{s.macs_per_s / 1e9:8.3f} "
                    f"{s.analysis_bytes / 1024:9.1f} "
                    f"{s.achieved_bytes / 1024:9.1f} "
                    f"{s.achieved_gbps:7.2f} {s.requant or '-':>7s}")
            if self.bw_gbps:
                line += (f" {s.roofline_frac:8.1%}"
                         if s.roofline_frac is not None else f" {'-':>8s}")
            lines.append(line)
        lines.append("-" * len(head))
        lines.append(
            f"{self.graph_name} on {self.device}: plan {self.plan_ms:.3f} ms "
            f"(batch {self.batch}, {self.macs_per_s / 1e9:.3f} GMAC/s), "
            f"sum of segments {self.sum_segments_ms:.3f} ms "
            f"({self.sum_segments_ms / self.plan_ms:.2f}x — each segment "
            f"eager, launches included)" if self.plan_ms else
            f"{self.graph_name}: empty plan")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "model": self.graph_name, "batch": self.batch,
            "repeats": self.repeats, "device": self.device,
            "plan_ms": round(self.plan_ms, 4),
            "sum_segments_ms": round(self.sum_segments_ms, 4),
            "total_macs": self.total_macs,
            "macs_per_s": round(self.macs_per_s, 1),
            "bw_gbps": self.bw_gbps,
            "segments": [s.to_json() for s in self.segments],
        }


def _segment_fn(seg, consts, env_in):
    """One eager run of ``seg`` over ``env_in``; returns its outputs."""
    def fn():
        env = dict(env_in)
        seg.run(consts, env)
        return {o: env[o] for o in seg.outputs if o in env}
    return fn


def _nbytes(v) -> int:
    return v.numel() * v.element_size() if isinstance(v, torch.Tensor) else 0


def profile_plan(plan, x=None, *, repeats: int = 20,
                 cost_report=None, bw_gbps: Optional[float] = None,
                 registry=None) -> PlanProfile:
    """Profile every segment of ``plan`` (see module docstring).

    x           — input array (graph's declared shape by default, seeded
                  randn); a dict {input_name: array} is accepted too
    repeats     — timing repeats per segment (best-of, after a warm call)
    cost_report — a precomputed ``infer_cost`` report over ``plan.graph``
                  (one is computed from ``plan.analysis`` otherwise)
    bw_gbps     — optional peak memory bandwidth of the card: adds the
                  roofline column (analysis-minimal bytes / peak BW vs
                  measured ms); no default
    registry    — optional ``MetricsRegistry``: per-segment measured ms
                  land in the ``profile_segment_ms`` gauge family
    """
    from repro_torch.core.executor import to_tensor
    g = plan.graph
    dev = plan.device
    if isinstance(x, dict):
        inputs = {k: to_tensor(v, dev) for k, v in x.items()}
    else:
        if x is None:
            shape = tuple(1 if d is None else int(d)
                          for d in g.inputs[0].shape)
            x = np.random.RandomState(0).randn(*shape).astype(np.float32)
        inputs = {g.input_names[0]: to_tensor(x, dev)}
    batch = int(next(iter(inputs.values())).shape[0])

    if cost_report is None:
        from repro_torch.analysis import infer_cost
        cost_report = infer_cost(g, ga=plan.analysis)
    layers_by_name = {l.name: l for l in cost_report.layers}

    out_names = list(g.output_names)
    plan_s = time_fn(lambda: [plan(inputs)[n] for n in out_names], repeats,
                     device=dev)

    env = dict(inputs)
    rows: list[SegmentProfile] = []
    for idx, seg in enumerate(plan.segments):
        env_in = {name: env[name] for name in seg.inputs if name in env}
        fn = _segment_fn(seg, plan.consts, env_in)
        out = fn()
        seg_s = time_fn(fn, repeats, device=dev)
        joined = [n.name for n in seg.nodes if n.name in layers_by_name]
        macs = sum(layers_by_name[n].macs for n in joined)
        a_bytes = sum(layers_by_name[n].mem_bytes for n in joined) * batch
        # bytes actually moved: activation inputs + outputs at their live
        # dtypes, plus the staged consts (packed carriers, scales)
        moved = sum(_nbytes(v) for v in env_in.values())
        moved += sum(_nbytes(v) for v in out.values())
        moved += sum(_nbytes(plan.consts[k]) for k in seg.const_keys
                     if k in plan.consts)
        if not a_bytes:
            a_bytes = float(moved)     # no joined layer: actual is minimal
        ms = seg_s * 1e3
        row = SegmentProfile(
            index=idx, kind=seg.kind,
            ops="+".join(n.op_type for n in seg.nodes),
            measured_ms=ms,
            macs=int(macs),
            macs_per_s=macs * batch / seg_s if seg_s else 0.0,
            analysis_bytes=float(a_bytes),
            achieved_bytes=float(moved),
            achieved_gbps=moved / seg_s / 1e9 if seg_s else 0.0,
            requant=seg.meta.get("requant_path"),
            layers=joined)
        if bw_gbps:
            row.roofline_ms = row.analysis_bytes / (bw_gbps * 1e9) * 1e3
            row.roofline_frac = (row.roofline_ms / ms) if ms else None
        rows.append(row)
        if registry is not None:
            registry.gauge(
                "profile_segment_ms", unit="ms",
                help="per-segment measured wall time (profile mode)",
                labels={"model": g.name, "segment": str(idx),
                        "kind": seg.kind}).set(ms)
        env.update(out)

    return PlanProfile(
        graph_name=g.name, batch=batch, repeats=repeats, segments=rows,
        plan_ms=plan_s * 1e3,
        sum_segments_ms=sum(r.measured_ms for r in rows),
        bw_gbps=bw_gbps,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else str(dev)))
