"""Compiled QonnxGraph executor: fused segments over the Hopper kernels.

Counterpart of ``repro.core.compile``.  ``executor.execute`` is the §V
oracle; this module is the performance tier above it:

  1. **Partition** a cleaned graph into fused segments by iterating the
     declarative lowering-rule registry (``core/lowering``) in priority
     order.  The rules ported so far cover

     * ``Quant|BipolarQuant|QCDQ(w) -> MatMul/Gemm [-> Mul] [-> Add]`` —
       onto ``kernels.quant_matmul`` (int8, B1) / ``quant_matmul_int4``
       (packed int4, B2) with offline integer weight packing;
     * ``Quant|BipolarQuant|QCDQ(w) -> Conv [-> Relu] [-> Quant]`` with
       ``1 < group`` — depthwise onto ``kernels.quant_depthwise_conv2d``
       (B6, epilogue fused), up to ``MAX_BLOCKED_GROUPS`` groups onto
       ``kernels.quant_grouped_conv2d`` (B5);
     * every other such Conv — onto B1 / B2 through compile-time im2col
       weights and run-time patch extraction (``kernels.quant_conv2d``),
       block-diagonal for the groups the grouped rule declines;
     * activation ``Quant`` nodes and ``QuantizeLinear -> Clip ->
       DequantizeLinear`` chains — onto ``kernels.quant_dequant`` (B4);
     * with fusion on (the default), activation ``BipolarQuant``,
       ``MaxPool`` / ``AveragePool``, residual ``Add [-> Relu] [-> Quant]``
       and ``Concat`` — onto fused boundary segments
       (``lowering/fusion.py``, ``kernels.quant_pool``);
     * everything else runs on the interpreted op registry.

     Between matching and emission, ``negotiate_carriers`` decides which
     boundary tensors travel as int8 codes (two a byte when they have at
     most 4 bits) instead of float32: B4 emits the codes, the integer
     path recovers them from its power-of-two act grid, and each consumer
     dequantizes them on entry with the oracle's own expression.

  2. **Fold** the static subgraphs no rule covers once, at compile time,
     and prune the constants to what the plan reads.

  3. **Emit** a ``CompiledPlan`` whose constants (packed carriers, scales)
     live on the plan's device.  On CUDA the first call at each input
     signature (names, shapes, dtypes) captures every segment in one CUDA
     graph, the counterpart of the reference's ``jax.jit(plan)``; every
     later call at that signature copies its inputs into the graph's
     static buffers and replays it, one launch from the host instead of
     one per kernel.  A call enqueues its work on the current CUDA stream
     and returns without synchronizing.  ``jit=False`` runs the segments
     eagerly, in topological order, as the CPU always does.

     ``segment_timing=True`` also captures, at each signature, a timed
     variant of the graph: the same segments with a timing event before
     the first and after each one.  A call with ``timed=True`` replays it,
     and ``record_segment_times`` reads the device time of each segment
     inside that replay (on the CPU, the host clock around each segment).

Kernel selection is **analysis-driven** by default, as in the reference
(``repro_torch.analysis``): the range analysis proves the actual weight
values and activation ranges, so a weight tensor whose values fit int4
takes the packed path whatever its declared width, each fused matmul /
conv gets an int32 accumulator where the activations are provably
integer-valued and the dot-product bound fits 31 bits, and a segment
whose scales are dyadic runs the exact integer epilogue B3
(``lowering/requant.py``).  ``use_analysis=False`` restores the
declared-bit-width fp32-epilogue tier, ``use_fusion=False`` the plans with
float32 boundaries and interpreted boundary ops.

``tune="cached"|"search"`` picks each kernel segment's launch geometry
through ``repro_torch.tune`` (the plans' ``override``): from the on-disk
tune cache, or by timing the real kernels with each candidate geometry
(``tune.Autotuner``); ``tuning_stats()`` reports it.

``mesh=`` (a ``dist.sharding.Mesh``, or ``"auto"``) runs the plan
data-parallel over the mesh's data axes: the constants are replicated
once per distinct device, and each call zero-pads the batch to a
multiple of the data degree, splits it into contiguous shards
(``batch_pspecs``), runs each shard through the one-device path on its
entry's device (captured per shard signature, replayed, outputs cloned),
and concatenates the shards on the mesh's first device with the padding
sliced off.  The reference returns one array spanning the devices; torch
has none in one process, so the port returns the concatenation
(ROADMAP C22), and ``placement()`` / ``shard_counts`` say where each
shard ran.  Entries may repeat a device (the port's counterpart of XLA's
forced virtual devices): their shards then run one after another.
"""
from __future__ import annotations

import logging
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..obs.metrics import default_registry
from . import lowering
from .executor import op_output, resolve_device, to_tensor
from .graph import Node, QonnxGraph
from .lowering import LoweringContext, LoweringRule, Segment

# operand positions whose *values* the op reads on the host (shapes, axes,
# pads): such initializers stay numpy constants instead of device tensors,
# so an interpreted Reshape never waits on the device for its target
_STATIC_OPERANDS = {"Reshape": (1,), "Pad": (1, 2), "Squeeze": (1,),
                    "Unsqueeze": (1,)}


# one capture at a time in the process: a capture's device-wide
# synchronize must not land inside another thread's capture
_CAPTURE_LOCK = threading.Lock()


@dataclass
class _Timed:
    """The timed variant of a signature's graph: the same segments, with
    ``marks[0]`` recorded before the first and ``marks[i + 1]`` after
    segment ``i``; it reads the plain graph's static inputs and writes
    ``outputs`` of its own."""
    graph: object                        # torch.cuda.CUDAGraph
    outputs: dict
    marks: list                          # torch.cuda.Event, external


@dataclass
class _Captured:
    """One input signature's CUDA graph and its static buffers: a replay
    reads ``inputs`` and overwrites ``outputs``."""
    graph: object                        # torch.cuda.CUDAGraph
    inputs: dict
    outputs: dict
    replays: int = 0
    timed: Optional[_Timed] = None


def _intervals_ms(marks: list) -> tuple:
    """(ms between consecutive marks, ms from the first mark to the last)
    of host-clock stamps or CUDA timing events (waited for)."""
    if isinstance(marks[0], float):
        return ([(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
                (marks[-1] - marks[0]) * 1e3)
    marks[-1].synchronize()
    return ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
            marks[0].elapsed_time(marks[-1]))


def _release_capture_pool(pool) -> None:
    """After a failed capture: stop routing allocations to ``pool``.  An
    invalidated capture makes ``capture_end`` raise before it does this
    itself, and the pool would then refuse the next capture; where it
    already stopped, the allocator says so and there is nothing to do."""
    try:
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), pool)
    except RuntimeError:
        pass


def _end_rng_capture(dev) -> None:
    """After a capture whose end raised: the device's default generator is
    still marked as capturing (its epilogue runs only at a successful
    end), so every later random op on the device would raise.  One empty
    capture runs its prologue and epilogue and clears the mark."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)      # "graph is empty"
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph):
            pass


log = logging.getLogger("repro_torch.compile")


def _signature(inputs: dict) -> tuple:
    return tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))


@dataclass
class CompiledPlan:
    """A partitioned QonnxGraph execution plan on one device, or sharded
    over the data axes of a ``mesh`` (see ``_init_placement``).

    On CUDA a call at a new input signature captures the plan in a CUDA
    graph (its own memory pool, one per plan and device), and later calls
    replay it; see ``__call__``.  ``trace_count`` counts the captures and
    the eager ``jit=False`` calls, as the reference counts its traces.
    ``segment_timing`` adds a timed variant to each capture (the pool is
    shared: every replay's outputs are cloned before the next replay)."""
    graph: QonnxGraph
    segments: list[Segment]
    consts: dict
    device: torch.device
    analysis: Optional[object] = None      # GraphAnalysis used for selection
    fusion: Optional[object] = None        # lowering.FusionPlan (carriers)
    tune_mode: str = "off"                 # "off" | "cached" | "search"
    tune_stats: dict = field(default_factory=dict)   # Autotuner.stats copy
    tune_log: list = field(default_factory=list)     # Autotuner.searches
    mesh: Optional[object] = None          # dist.sharding.Mesh
    segment_timing: bool = False           # capture a timed variant too
    _captured: dict = field(default_factory=dict, repr=False)
    _signatures: set = field(default_factory=set, repr=False)
    _traces: int = field(default=0, repr=False)
    _pools: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _last_marks: Optional[list] = field(default=None, repr=False)

    def __post_init__(self):
        self._m_retrace = default_registry().counter(
            "compile_plan_retraces_total",
            help="plan body traces (once per new input shape under jit)",
            labels={"model": self.graph.name})
        self._init_placement()

    def _init_placement(self) -> None:
        """Stage the mesh-sharded path, if any: one shard per data entry
        (the entry at model index 0), constants replicated once per
        distinct device of those entries, a lock per device."""
        self._dev_consts = {self.device: self.consts}
        self._locks = {self.device: self._lock}
        self.shard_devices: list = []
        self.shard_counts: list = []
        self._data_size = 1
        if self.mesh is None:
            return
        from repro_torch.dist import sharding as dsh
        self._data_size = dsh.data_axis_size(self.mesh)
        if self._data_size <= 1:
            return                      # degenerate mesh: the plain path
        const_outputs = [n for n in self.graph.output_names if n in self.consts]
        if const_outputs:
            # a fully folded (constant) graph output is one tensor for the
            # whole batch; sharding it along the batch dim would be wrong
            log.warning("plan %s has constant graph outputs %s; mesh sharding "
                        "disabled, running single-device", self.graph.name,
                        const_outputs)
            return
        ent = self.mesh.devices
        if "model" in self.mesh.axis_names:
            ent = ent.take(0, axis=self.mesh.axis_names.index("model"))
        self.shard_devices = list(ent.flat)
        self.shard_counts = [0] * len(self.shard_devices)
        for d in dict.fromkeys(self.shard_devices):
            if d not in self._dev_consts:
                self._dev_consts[d] = {k: v.to(d) for k, v in self.consts.items()}
                self._locks[d] = threading.Lock()

    def _trace(self) -> None:
        self._traces += 1
        self._m_retrace.inc()

    def _run(self, env: dict, consts: Optional[dict] = None,
             stamps: Optional[list] = None) -> dict:
        """Run every segment on ``env``; ``stamps`` takes the host clock
        before the first segment and after each one."""
        consts = self.consts if consts is None else consts
        if stamps is not None:
            stamps.append(time.perf_counter())
        for seg in self.segments:
            seg.run(consts, env)
            if stamps is not None:
                stamps.append(time.perf_counter())
        # graph outputs may be compile-time constants (folded subgraphs)
        return {name: env.get(name, consts.get(name))
                for name in self.graph.output_names}

    @property
    def trace_count(self) -> int:
        """Captures (one per new input signature under ``jit=True``; on the
        CPU, where nothing is captured, one per new signature too) plus
        one per ``jit=False`` call: the no-retrace probe of the serving
        tests, as the reference's."""
        return self._traces

    @property
    def replay_count(self) -> int:
        """CUDA graph replays so far, over every captured signature (timed
        replays included)."""
        return sum(c.replays for c in self._captured.values())

    @property
    def graph_count(self) -> int:
        """CUDA graphs held: one a captured signature, two with
        ``segment_timing``."""
        return sum(1 + (c.timed is not None) for c in self._captured.values())

    @property
    def n_devices(self) -> int:
        """Devices a plan call spans: the data degree when mesh-sharded
        (repeated entries count, as XLA's virtual devices do), else 1."""
        return self._data_size if self.shard_devices else 1

    def placement(self) -> dict:
        """Telemetry: where the plan runs."""
        if self.shard_devices:
            return {"kind": "mesh", "devices": self._data_size,
                    "mesh": dict(self.mesh.shape)}
        return {"kind": "device", "devices": 1, "device": str(self.device)}

    def devices(self) -> list:
        """Every distinct device a call runs on, the first device first."""
        return list(dict.fromkeys([self.device] + self.shard_devices))

    def __call__(self, inputs: dict, *, jit: bool = True,
                 donate: bool = False, timed: bool = False) -> dict:
        """Run the plan on ``inputs`` (numpy arrays or tensors, on any
        device).  Results are device tensors returned **without a
        synchronize**, which is what lets the serving tier enqueue every
        slot before one trailing sync.

        On CUDA with ``jit=True`` the first call at a new signature warms
        the plan up on a side stream (lazy initialisation stays out of the
        capture), captures it in a ``torch.cuda.CUDAGraph`` whose static
        input and output buffers live in the plan's memory pool, and
        replays it; later calls copy the inputs into the static buffers,
        replay, and return copies of the static outputs (the next replay
        overwrites them).  Calls are serialized by the plan's lock and
        enqueued on the caller's current stream.  A capture that fails
        raises, naming the segment and its ops: nothing falls back to the
        eager path.  On the CPU ``jit=True`` runs eagerly and records the
        signature; ``jit=False`` is the eager path everywhere.

        ``donate=True`` hands the plan a device input as the slot: at a
        new signature the buffer itself becomes the capture's static input
        (no copy), and a later call passing that buffer again is not
        copied; the caller must not rely on its contents afterwards.
        Ignored on the CPU, as in the reference, and on a mesh-sharded
        plan, whose shards run through the same path one per data entry
        (``_call_sharded``).

        ``timed=True`` times each segment of this call, for
        ``record_segment_times`` to read after the caller's sync: on CUDA
        it replays the signature's timed variant (captured only with
        ``segment_timing``; without it the plain graph replays and nothing
        is timed), and on the CPU it reads the host clock between the
        segments.  Ignored on a mesh-sharded plan and by ``jit=False`` on
        CUDA."""
        for t in self.graph.inputs:
            if t.name not in inputs:
                raise ValueError(f"missing graph input {t.name!r}")
        if self.shard_devices:
            return self._call_sharded(inputs, jit)
        return self._call_on(self.device, inputs, jit, donate, timed)

    def _call_sharded(self, inputs: dict, jit: bool) -> dict:
        """The mesh path: pad the batch to a multiple of the data degree
        (on the host, or on the device the inputs lie on), split it into
        contiguous shards, run shard i on entry i's device, concatenate on
        the first device and slice the padding off.  Each shard holds only
        its own device's lock, so shards on distinct devices overlap."""
        from repro_torch.dist import sharding as dsh
        host = {k: to_tensor(v) for k, v in inputs.items()}
        batch = int(host[self.graph.input_names[0]].shape[0])
        pad = (-batch) % self._data_size
        if pad:
            host = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                    for k, v in host.items()}
        specs = dsh.batch_pspecs(host, self.mesh)
        for k, spec in specs.items():
            if not spec or spec[0] is None:
                raise ValueError(f"input {k!r} of {tuple(host[k].shape)} does not "
                                 f"split over {self._data_size} data entries")
        per = (batch + pad) // self._data_size
        outs = []
        for i, dev in enumerate(self.shard_devices):
            shard = {k: v[i * per:(i + 1) * per] for k, v in host.items()}
            outs.append(self._call_on(dev, shard, jit, False))
            self.shard_counts[i] += 1
        first = self.device
        merged = {}
        for name in self.graph.output_names:
            parts = [o[name].to(first, non_blocking=True) for o in outs]
            y = torch.cat(parts)
            merged[name] = y[:batch] if pad else y
        return merged

    def _call_on(self, dev, inputs: dict, jit: bool, donate: bool,
                 timed: bool = False) -> dict:
        """The one-device path on ``dev`` (the plan's device, or a shard's)."""
        consts = self._dev_consts[dev]
        lock = self._locks[dev]
        if not jit or dev.type != "cuda":
            env = {k: to_tensor(v, dev) for k, v in inputs.items()}
            with lock:
                if not jit:
                    self._trace()
                elif (key := (dev, _signature(env))) not in self._signatures:
                    self._signatures.add(key)
                    self._trace()
            if not timed or dev.type == "cuda":
                return self._run(env, consts)
            stamps: list = []
            out = self._run(env, consts, stamps)
            with lock:
                self._last_marks = stamps
            return out
        host = {k: to_tensor(v) for k, v in inputs.items()}
        sig = _signature(host)
        with lock, torch.cuda.device(dev):
            cap = self._captured.get((dev, sig))
            if cap is None:
                cap = self._capture(dev, sig, host, donate)
            else:
                for k, v in host.items():
                    slot = cap.inputs[k]
                    if v.device != slot.device or v.data_ptr() != slot.data_ptr():
                        slot.copy_(v, non_blocking=True)
            cap.replays += 1
            if timed and cap.timed is not None:
                cap.timed.graph.replay()
                self._last_marks = cap.timed.marks
                return {k: v.clone() for k, v in cap.timed.outputs.items()}
            cap.graph.replay()
            return {k: v.clone() for k, v in cap.outputs.items()}

    def record_segment_times(self) -> list:
        """Per-segment times of the last ``timed=True`` call, once: a list
        in ``segments`` order of ``{"index", "kind", "ms"}``, or ``[]``
        where no timed call is left to read.  Call it after the caller's
        sync (a CUDA timing event is waited for otherwise).

        Each reading lands in the process-wide default registry under
        ``model=graph.name``: histogram ``plan_segment_device_ms{kind}``
        takes one observation a kind, summed over that kind's segments,
        and ``plan_replay_device_ms`` the first mark to the last.  On CUDA
        the times are device times inside the replay (event to event, so
        a segment's share includes the gaps between its kernels); on the
        CPU, the host clock around each segment."""
        with self._lock:
            marks, self._last_marks = self._last_marks, None
        if not marks:
            return []
        seg_ms, total_ms = _intervals_ms(marks)
        per_kind: dict = {}
        rows = []
        for i, (seg, ms) in enumerate(zip(self.segments, seg_ms)):
            per_kind[seg.kind] = per_kind.get(seg.kind, 0.0) + ms
            rows.append({"index": i, "kind": seg.kind, "ms": ms})
        reg, model = default_registry(), self.graph.name
        for kind, ms in per_kind.items():
            reg.histogram(
                "plan_segment_device_ms", unit="ms", window=1024,
                help="device ms a timed replay spends in one segment kind",
                labels={"model": model, "kind": kind}).observe(ms)
        reg.histogram(
            "plan_replay_device_ms", unit="ms", window=1024,
            help="device ms of a timed replay, first segment to last",
            labels={"model": model}).observe(total_ms)
        return rows

    def _capture(self, dev, sig: tuple, host: dict, donate: bool) -> _Captured:
        """Warm up, then capture the plan at ``sig`` on ``dev`` and, with
        ``segment_timing``, its timed variant on the same static inputs
        without a second warm-up (caller holds that device's lock and has
        made it current)."""
        consts = self._dev_consts[dev]
        slots = {}
        for k, v in host.items():
            if donate and v.device == dev and v.is_contiguous():
                slots[k] = v
            else:
                slots[k] = torch.empty(v.shape, dtype=v.dtype, device=dev)
                slots[k].copy_(v)
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._run(dict(slots), consts)
        stream.wait_stream(side)
        graph, outs = self._capture_graph(dev, sig, slots, consts)
        cap = _Captured(graph, slots, outs)
        if self.segment_timing and not self.shard_devices:
            marks = [torch.cuda.Event(enable_timing=True, external=True)
                     for _ in range(len(self.segments) + 1)]
            graph, outs = self._capture_graph(dev, sig, slots, consts, marks)
            cap.timed = _Timed(graph, outs, marks)
        self._captured[(dev, sig)] = cap
        self._trace()
        return cap

    def _capture_graph(self, dev, sig: tuple, slots: dict, consts: dict,
                       marks: Optional[list] = None) -> tuple:
        """Capture every segment on ``slots`` in one graph of the plan's
        pool on ``dev``; returns (graph, static outputs).  ``marks`` (timing
        events) are recorded as graph nodes before the first segment and
        after each one."""
        pool = self._pools.get(dev)
        if pool is None:
            pool = self._pools[dev] = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        failed = ended = None
        # capture_begin / capture_end by hand inside a stream context, so
        # the caller's stream comes back even when capture_end raises
        with _CAPTURE_LOCK, torch.cuda.stream(torch.cuda.Stream(dev)):
            for ev in marks or ():
                ev.record()          # create each event outside the capture
            torch.cuda.synchronize(dev)
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            env = dict(slots)
            try:
                if marks:
                    marks[0].record()
                for i, seg in enumerate(self.segments):
                    try:
                        seg.run(consts, env)
                        if marks:
                            marks[i + 1].record()
                    except Exception as e:       # named below
                        failed = (i, seg, e)
                        break
            finally:
                try:
                    graph.capture_end()
                except RuntimeError as e:        # the capture was invalidated
                    ended = e
        if failed is not None or ended is not None:
            _release_capture_pool(pool)
            del self._pools[dev]                 # the next capture starts afresh
        if ended is not None:
            _end_rng_capture(dev)
        if failed is not None:
            i, seg, e = failed
            ops = "+".join(f"{n.op_type}:{n.name}" for n in seg.nodes)
            raise RuntimeError(
                f"CUDA graph capture of plan {self.graph.name!r} failed in "
                f"segment {i} ({seg.kind}: {ops}): {e}") from e
        if ended is not None:
            raise RuntimeError(
                f"CUDA graph capture of plan {self.graph.name!r} failed at "
                f"signature {sig}: {ended}") from ended
        return graph, {name: env.get(name, consts.get(name))
                       for name in self.graph.output_names}

    def profile(self, x=None, **kw):
        """Per-segment measured profile (see ``repro_torch.obs.profile``):
        each segment timed on its own, joined with the analysis cost
        report.  Returns a ``PlanProfile``."""
        from repro_torch.obs.profile import profile_plan
        return profile_plan(self, x, **kw)

    # ------------------------------------------------------------- stats
    @property
    def fused_counts(self) -> dict:
        out: dict[str, int] = {}
        for s in self.segments:
            out[s.kind] = out.get(s.kind, 0) + 1
        return out

    @property
    def n_fused_nodes(self) -> int:
        return sum(len(s.nodes) for s in self.segments if s.kind != "interp")

    def interp_op_counts(self) -> dict:
        """op_type -> count over nodes left on the interpreted fallback."""
        out: dict[str, int] = {}
        for s in self.segments:
            if s.kind != "interp":
                continue
            for n in s.nodes:
                out[n.op_type] = out.get(n.op_type, 0) + 1
        return out

    def requant_stats(self) -> dict:
        """Integer-requant path telemetry over the kernel segments.

        Only matmul / conv segments count: a ``quant_dequant`` segment
        quantizes from the unbounded fp32 input domain and has no requant
        path to pick.  ``coverage`` is the integer-path fraction (1.0 when
        there are no kernel segments); ``fp32_ops_eliminated`` sums each
        int32 segment's per-call count of fp32 epilogue ops replaced by
        integer arithmetic."""
        out = {"kernel_segments": 0, "int32_segments": 0, "fp32_segments": 0,
               "fp32_ops_eliminated": 0}
        for s in self.segments:
            path = s.meta.get("requant_path")
            if path is None:
                continue
            out["kernel_segments"] += 1
            if path == "int32":
                out["int32_segments"] += 1
                out["fp32_ops_eliminated"] += s.meta.get(
                    "fp32_ops_eliminated", 0)
            else:
                out["fp32_segments"] += 1
        out["coverage"] = (out["int32_segments"] / out["kernel_segments"]
                           if out["kernel_segments"] else 1.0)
        return out

    def grouped_conv_stats(self) -> dict:
        """Grouped / depthwise lowering, summed over the segments.

        ``reclaimed_macs`` / ``carrier_bytes_saved`` — what B5 / B6 save
        against the dense block-diagonal im2col fallback (per sample);
        ``grouped_segments`` — segments on those kernels;
        ``block_diagonal_grouped`` — group > 1 convs still on the dense
        carrier (the fallback)."""
        out = {"grouped_segments": 0, "block_diagonal_grouped": 0,
               "reclaimed_macs": 0, "carrier_bytes_saved": 0}
        for s in self.segments:
            if s.kind in ("quant_conv", "quant_conv_int4") and \
                    s.meta.get("group", 1) > 1:
                out["block_diagonal_grouped"] += 1
            if s.kind.startswith(("quant_conv_grouped", "quant_conv_dw")):
                out["grouped_segments"] += 1
                out["reclaimed_macs"] += s.meta.get("reclaimed_macs", 0)
                out["carrier_bytes_saved"] += s.meta.get(
                    "carrier_bytes_saved", 0)
        return out

    def fusion_stats(self) -> dict:
        """Cross-segment fusion telemetry (``lowering/fusion.py``).

        ``fused_boundary_segments`` counts the segments in a fused boundary
        (the four fusion-rule kinds and the kernel segments that produce or
        consume an integer carrier); ``integer_boundaries`` /
        ``packed_boundaries`` count the boundary tensors carried as int8
        codes / nibble-packed bytes; ``boundary_bytes_saved`` is the
        boundary traffic a call avoids against float32 boundaries;
        ``offers`` / ``declined`` show how negotiation went (a declined
        offer keeps its float32 boundary)."""
        fp = self.fusion
        out = {"enabled": fp is not None,
               "fused_boundary_segments": sum(
                   1 for s in self.segments if s.meta.get("fused_boundary")),
               "integer_boundaries": 0, "packed_boundaries": 0,
               "boundary_bytes_saved": 0, "offers": 0, "declined": 0}
        if fp is not None:
            out["integer_boundaries"] = len(fp.carriers)
            out["packed_boundaries"] = sum(
                1 for c in fp.carriers.values() if c.packed)
            out["boundary_bytes_saved"] = fp.bytes_saved
            out["offers"] = fp.offered
            out["declined"] = fp.declined
        return out

    def tuning_stats(self) -> dict:
        """Tuned-vs-default launch-geometry telemetry over the segments.

        ``kernel_segments`` counts every segment that carries a block
        assignment (``meta["blocks"]``); ``tuned_segments`` are those whose
        blocks came from the cache or a search rather than the heuristic
        plan.  The cache counters (hits / misses / searched / graph_hit /
        graph_miss) are the Autotuner's, snapshotted at compile time:
        ``searched == 0`` with ``graph_hit == 1`` is the warm-cache
        invariant."""
        out = {"mode": self.tune_mode, "kernel_segments": 0,
               "tuned_segments": 0, "default_segments": 0}
        for s in self.segments:
            if "blocks" not in s.meta:
                continue
            out["kernel_segments"] += 1
            if s.meta.get("tuned") in ("cached", "search"):
                out["tuned_segments"] += 1
            else:
                out["default_segments"] += 1
        out.update(self.tune_stats)
        return out

    def describe(self) -> str:
        where = (f"{self.device}" if not self.shard_devices else
                 f"mesh {dict(self.mesh.shape)} from {self.device}")
        head = (f"CompiledPlan({self.graph.name}) on {where}: "
                f"{len(self.segments)} segments over {len(self.graph.nodes)} "
                f"nodes {self.fused_counts}")
        return "\n".join([head] + ["  " + s.describe() for s in self.segments])


# --------------------------------------------------- interpreted fallback

def _make_interp_segment(nodes: list[Node], static_consts: dict) -> Segment:
    ins = sorted({i for n in nodes for i in n.inputs if i})
    outs = [o for n in nodes for o in n.outputs]

    def run(consts, env):
        for node in nodes:
            static_pos = _STATIC_OPERANDS.get(node.op_type, ())
            args = []
            for pos, i in enumerate(node.inputs):
                if not i:
                    args.append(None)
                elif pos in static_pos and i in static_consts:
                    args.append(static_consts[i])     # host value
                else:
                    args.append(env.get(i, consts.get(i)))
            for name, val in zip(node.outputs, op_output(node, args)):
                env[name] = val

    return Segment("interp", nodes, ins, outs, run)


def _unported(interpret) -> None:
    if interpret is not None:
        raise ValueError(
            "the port has no interpret mode: kernels launch on CUDA tensors "
            "and their plain twins run on CPU tensors; pass device='cpu'")


# ------------------------------------------------------------- compiler

def compile_graph(graph: QonnxGraph, *, run_cleanup: bool = True,
                  use_kernels: bool = True, use_int4: bool = True,
                  use_analysis: bool = True,
                  interpret: Optional[bool] = None,
                  use_integer_requant: bool = True, tune: str = "off",
                  tune_cache_dir: Optional[str] = None,
                  tune_repeats: int = 3,
                  use_fusion: bool = True,
                  mesh=None, device=None,
                  segment_timing: bool = False) -> CompiledPlan:
    """Partition ``graph`` into fused segments and emit a plan on ``device``.

    run_cleanup  — run the declarative "compile_prep" pipeline first
                   (cleanup that keeps weight-quant nodes unfolded; shape
                   inference is what lets the channelwise matchers fire)
    use_kernels  — False disables fusion entirely (pure interpreter plan)
    use_int4     — pack <=4-bit signed weights two per byte and dispatch
                   the in-kernel-unpack variant (B2)
    use_analysis — consult ``repro_torch.analysis`` (range and datatype
                   inference, on the host) for the weight carriers and the
                   accumulator dtype, from the actual value ranges; False
                   is the declared-bit-width fp32-epilogue tier
    use_integer_requant — allow the dyadic integer epilogue (B3) on the
                   segments whose exactness proof holds; False pins every
                   segment to the fp32 epilogue
    device       — where the plan runs: None means CUDA (raising without a
                   GPU); "cpu" runs every kernel's plain twin
    use_fusion   — cross-segment fusion (``lowering/fusion.py``): lower
                   residual Add / pool / Concat / bipolar boundary ops into
                   fused segments and negotiate integer (int8 / packed
                   int4) boundary carriers; False gives the plans with
                   float32 boundaries.  On the card the default is the
                   slower of the two for now: the carriers' glue
                   (dequantize on entry, code recovery, packing) runs as
                   eager PyTorch ops between the kernels, so the
                   MobileNet-224 integer plan call of 8 rows takes about
                   twice the wall and 1.8x the device time of
                   use_fusion=False, in 3.6x the launches (``chip_smoke.py``
                   phase 5 on an H100; numbers in PERF.md §6).  Taking the
                   codes straight into the kernels is ROADMAP queue B's
                   first item
    tune         — per-segment launch geometry (``repro_torch.tune``):
                   "off" (the plans' heuristics), "cached" (from the tune
                   cache; the heuristic on a miss, never times) or
                   "search" (cache, else time the real kernels with each
                   candidate geometry on the plan's device and persist the
                   winner); anything else raises ValueError
    tune_cache_dir — tune-cache root (default ``$REPRO_TUNE_CACHE_DIR`` or
                   ``~/.cache/repro-tune``)
    tune_repeats — best-of-N timing rounds per candidate in "search" mode
    mesh         — device placement: a ``dist.sharding.Mesh`` (the plan
                   runs data-parallel over the mesh's data axes, one
                   contiguous batch shard per entry, constants replicated
                   per distinct device; see ``CompiledPlan``), or
                   ``"auto"`` for ``dist.fault.elastic_mesh(prefer_model=1)``
                   (every CUDA device data-parallel; the plain one-device
                   path on a one-GPU host).  Exclusive with ``device``
                   (ValueError); anything else raises TypeError
    segment_timing — on CUDA, capture beside each signature's graph a
                   timed variant that ``plan(..., timed=True)`` replays
                   and ``plan.record_segment_times()`` reads (one more
                   capture a signature; the serving engine asks for it
                   when it holds a tracer)
    interpret    — must stay None (see ``_unported``)

    Every compile records its wall time and plan-shape gauges (segments
    per kind, fused nodes, integer-requant coverage and segments, integer
    boundaries and the boundary bytes they save) in the
    process-wide ``repro_torch.obs`` default registry under
    ``model=graph.name``.
    """
    t_compile0 = time.perf_counter()
    _unported(interpret)
    if tune not in ("off", "cached", "search"):
        raise ValueError(f"tune must be 'off', 'cached' or 'search', "
                         f"got {tune!r}")
    from repro_torch.dist.sharding import mesh_argument
    mesh = mesh_argument(mesh, device)
    dev = resolve_device(device) if mesh is None else mesh.devices.flat[0]
    if run_cleanup:
        from . import passes
        graph = passes.run_pipeline(graph, "compile_prep")
    g = graph.copy()
    g.nodes = g.toposort()

    ga = None
    if use_kernels and use_analysis:
        from repro_torch.analysis import analyze
        ga = analyze(g)
    tuner = None
    if use_kernels and tune != "off":
        from repro_torch.tune import Autotuner, TuneCache, graph_cache_key
        tuner = Autotuner(TuneCache(tune_cache_dir), mode=tune,
                          repeats=tune_repeats, device=dev)
        tuner.begin_graph(graph_cache_key(g, tuner.backend))
    ctx = LoweringContext(analysis=ga, use_int4=use_int4,
                          use_int_requant=use_integer_requant, device=dev,
                          use_fusion=use_fusion, tuner=tuner)

    # constants start on the host: folding happens there once, and only
    # what the plan reads moves to the device
    consts: dict = {k: to_tensor(v) for k, v in g.initializers.items()}

    # pass 1 — match the registered lowering rules at their anchor nodes;
    # covered satellites (weight chains above, epilogues below) are
    # recorded so pass 2 skips them
    anchor_match: dict[int, tuple[LoweringRule, lowering.Match]] = {}
    covered: set[int] = set()
    rules_by_op: dict[str, list[LoweringRule]] = {}
    if use_kernels:
        for node in g.nodes:
            if id(node) in covered:
                continue
            if node.op_type not in rules_by_op:
                rules_by_op[node.op_type] = lowering.rules_for(node.op_type)
            for rule in rules_by_op[node.op_type]:
                m = rule.match(g, node, ctx)
                if m is None:
                    continue
                if any(id(n) in covered or id(n) in anchor_match
                       for n in m.nodes):
                    continue               # overlaps an earlier match
                anchor_match[id(node)] = (rule, m)
                covered.update(id(n) for n in m.nodes)
                break

    # carrier negotiation — after matching (it reads every match's offers
    # and accepts) and before emission (the emitters close over the
    # negotiated boundary forms): one topo walk deciding which boundary
    # tensors travel as integer codes instead of float32
    fusion_plan = None
    if use_kernels and use_fusion:
        from .lowering import fusion as fusion_mod
        fusion_plan = fusion_mod.negotiate_carriers(g, anchor_match)
        ctx.fusion = fusion_plan

    # pass 1.5 — compile-time folding of the *unmatched* static subgraphs
    folded: set[int] = set()
    changed = True
    while changed:
        changed = False
        for node in g.nodes:
            if id(node) in covered or id(node) in folded:
                continue
            if not all((not i) or i in consts for i in node.inputs):
                continue
            out = op_output(node, [consts[i] if i else None
                                   for i in node.inputs])
            for name, val in zip(node.outputs, out):
                consts[name] = to_tensor(val)
            folded.add(id(node))
            changed = True

    # pass 2 — emit segments in topo order; a fused segment runs at its
    # anchor's position, consecutive unfused nodes coalesce into one
    # interpreted segment
    static_consts = {
        i: consts[i].numpy()
        for node in g.nodes if node.op_type in _STATIC_OPERANDS
        for pos in _STATIC_OPERANDS[node.op_type]
        if pos < len(node.inputs) and (i := node.inputs[pos]) in consts}

    segments: list[Segment] = []
    pending_interp: list[Node] = []
    staged: dict = {}                      # kernel constants, on the device

    def flush_interp():
        if pending_interp:
            segments.append(
                _make_interp_segment(list(pending_interp), static_consts))
            pending_interp.clear()

    for node in g.nodes:
        if id(node) in anchor_match:
            flush_interp()
            rule, m = anchor_match[id(node)]
            segments.append(rule.emit(len(segments), m, staged, ctx))
        elif id(node) in covered or id(node) in folded:
            continue                  # satellite of a fused segment / folded
        else:
            pending_interp.append(node)
    flush_interp()

    # prune consts to what the plan reads: float weights whose int8/int4
    # carriers were packed offline (and fold intermediates) stay behind
    used: set[str] = set(g.output_names)
    for seg in segments:
        if seg.kind == "interp":
            for node in seg.nodes:
                static_pos = _STATIC_OPERANDS.get(node.op_type, ())
                used.update(i for pos, i in enumerate(node.inputs)
                            if i and pos not in static_pos)
        else:
            used.update(seg.inputs)
    consts = {k: v.to(dev) for k, v in consts.items() if k in used}
    consts.update(staged)

    if tuner is not None:
        tuner.end_graph()
    plan = CompiledPlan(g, segments, consts, dev, analysis=ga,
                        fusion=fusion_plan,
                        tune_mode=tune if tuner is not None else "off",
                        tune_stats=dict(tuner.stats) if tuner is not None else {},
                        tune_log=list(tuner.searches) if tuner is not None else [],
                        mesh=mesh, segment_timing=segment_timing)
    _record_compile_metrics(plan, time.perf_counter() - t_compile0)
    return plan


def _record_compile_metrics(plan: CompiledPlan, wall_s: float) -> None:
    """Compile-tier telemetry into the process-wide default registry (the
    reference's metric names)."""
    reg = default_registry()
    model = {"model": plan.graph.name}
    reg.histogram(
        "compile_wall_ms", unit="ms",
        help="compile_graph wall time (partition + analysis + plan emit)",
        window=64, labels=model).observe(wall_s * 1e3)
    reg.gauge("compile_segments",
              help="fused segments in the emitted plan, per kind",
              labels={**model, "kind": "total"}).set(len(plan.segments))
    for kind, n in plan.fused_counts.items():
        reg.gauge("compile_segments", labels={**model, "kind": kind}).set(n)
    reg.gauge("compile_fused_nodes",
              help="graph nodes absorbed into kernel segments",
              labels=model).set(plan.n_fused_nodes)
    reg.gauge("compile_plan_devices",
              help="devices a plan call spans (data-parallel degree; 1 "
                   "unless mesh-sharded)", labels=model).set(plan.n_devices)
    rq = plan.requant_stats()
    reg.gauge("compile_integer_requant_coverage",
              help="fraction of kernel segments on the integer-epilogue "
                   "fast path", labels=model).set(rq["coverage"])
    reg.gauge("compile_integer_requant_segments",
              help="kernel segments proven exact on the dyadic integer "
                   "epilogue", labels=model).set(rq["int32_segments"])
    fs = plan.fusion_stats()
    reg.gauge("compile_integer_boundaries",
              help="inter-segment tensors carried as integer codes instead "
                   "of fp32", labels=model).set(fs["integer_boundaries"])
    reg.gauge("compile_boundary_bytes_saved",
              help="per-call boundary HBM bytes avoided vs fp32 boundaries",
              labels=model).set(fs["boundary_bytes_saved"])
    if plan.tune_mode != "off":
        ts = plan.tuning_stats()
        reg.counter("tune_cache_hits_total",
                    help="segment geometries answered from the tune cache",
                    labels=model).inc(ts.get("hits", 0))
        reg.counter("tune_cache_misses_total",
                    help="segment geometries that fell back to the "
                         "heuristic (cached mode, no entry)",
                    labels=model).inc(ts.get("misses", 0))
        reg.counter("tune_searches_total",
                    help="geometry searches run (search mode, unseen "
                         "workloads)", labels=model).inc(ts.get("searched", 0))
        reg.gauge("compile_tuned_segments",
                  help="kernel segments running cache- or search-selected "
                       "geometries", labels=model).set(ts["tuned_segments"])


def execute_compiled(graph: QonnxGraph, inputs: dict, **kw) -> dict:
    """One-shot convenience: compile, then run (``executor.execute``'s
    counterpart on the compiled tier)."""
    return compile_graph(graph, **kw)(inputs)


__all__ = ["CompiledPlan", "compile_graph", "execute_compiled"]
