"""The port's observability (``repro_torch.obs``) on the CPU.

The behaviours ``tests/test_obs.py`` pins for the reference, each with a
counterpart here: metric primitives and histograms, the exporters, the
report CLI, the HTTP endpoint (bound to port 0), spans and the JSONL sink,
the serving tier's telemetry and spans, the disabled tracer's zero
allocations, the compile-tier gauges and the per-segment profiler joined
with the cost report.  Where both packages compute the same thing (the
exporters' text, the rendered table, span records, the cost report's MACs
per segment) the port is held against ``repro`` directly.
"""
import json
import threading
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as r_obs  # noqa: E402
from repro.obs.report import render as r_render  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import GraphBuilder  # noqa: E402
from repro_torch.obs import (Histogram, JsonlSink, ListSink,  # noqa: E402
                             MetricsRegistry, Tracer, exponential_buckets,
                             nearest_rank)
from repro_torch.serve import CompiledGraphEngine, ServeScheduler  # noqa: E402


def _mlp(seed=0, out_dim=6, in_dim=16):
    """Tiny quantized MLP (the reference tests' fixture, built by the port)."""
    rng = np.random.RandomState(seed)
    b = GraphBuilder(f"obs_mlp_s{seed}")
    x = b.add_input("x", (1, in_dim))
    h = b.quant(x, 0.0973, 0.0, 4, signed=True)
    w = b.add_initializer("w", rng.randn(in_dim, out_dim)
                          .astype(np.float32) * 0.4)
    qw = b.quant(w, 0.0517, 0.0, 4, narrow=True)
    (h,) = b.add_node("MatMul", [h, qw], 1)
    b.mark_output(h)
    return b.build()


def _engine(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("report_cost", False)
    return CompiledGraphEngine(_mlp(), device="cpu", **kw)


# ------------------------------------------------------------ primitives

def test_counter_inc_and_negative_rejected():
    c = MetricsRegistry().counter("c_total")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_set_inc_dec():
    g = MetricsRegistry().gauge("g")
    g.set(10)
    g.inc(5)
    g.dec(2)
    assert g.value == 13.0


def test_registry_children_idempotent_and_label_separated():
    reg = MetricsRegistry()
    a = reg.counter("reqs_total", labels={"model": "a"})
    b = reg.counter("reqs_total", labels={"model": "b"})
    assert a is reg.counter("reqs_total", labels={"model": "a"}) and a is not b
    a.inc(3)
    b.inc(1)
    series = reg.snapshot()["reqs_total"]["series"]
    assert {s["labels"]["model"]: s["value"] for s in series} == \
        {"a": 3.0, "b": 1.0}


def test_registry_kind_conflict_rejected():
    reg = MetricsRegistry()
    reg.counter("m")
    with pytest.raises(ValueError):
        reg.gauge("m")


@pytest.mark.parametrize("kw", [{"start": 0}, {"factor": 1.0}])
def test_exponential_buckets_validation(kw):
    assert exponential_buckets(0.5, 2.0, 4) == (0.5, 1.0, 2.0, 4.0)
    with pytest.raises(ValueError):
        exponential_buckets(**kw)


# ------------------------------------------------------------ histograms

def test_histogram_bucket_boundaries_le_semantics():
    h = Histogram({}, buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 5.0):
        h.observe(v)
    s = h.snapshot()
    assert s.counts == (2, 2, 1, 1)        # (<=1, <=2, <=4, +Inf)
    assert s.count == 6 and s.sum == pytest.approx(14.0)
    h.observe(float("nan"))                # nan observations are dropped
    assert h.count == 6


@pytest.mark.parametrize("buckets", [(2.0, 1.0), (1.0, 1.0)])
def test_histogram_rejects_unsorted_buckets(buckets):
    with pytest.raises(ValueError):
        Histogram({}, buckets=buckets)


def test_estimate_percentile_tracks_numpy_within_bucket_resolution():
    values = np.abs(np.random.RandomState(7).lognormal(1.0, 1.2, size=4000))
    h = Histogram({}, buckets=exponential_buckets(0.001, 2.0, 28))
    for v in values:
        h.observe(float(v))
    s = h.snapshot()
    for pct in (50.0, 90.0, 99.0):
        est, true = s.estimate_percentile(pct), float(np.percentile(values, pct))
        assert true / 2.0 <= est <= true * 2.0, (pct, est, true)


def test_windowed_percentile_is_exact_nearest_rank():
    values = [float(v) for v in np.random.RandomState(3).randn(500) ** 2]
    h = Histogram({}, buckets=exponential_buckets(), window=1000)
    h2 = Histogram({}, buckets=exponential_buckets(), window=100)
    for v in values:
        h.observe(v)
        h2.observe(v)
    for pct in (0, 50, 90, 99, 100):
        assert h.percentile(pct) == nearest_rank(values, pct) == \
            r_obs.nearest_rank(values, pct)
    assert h2.percentile(50) == nearest_rank(values[-100:], 50)
    assert h2.count == 500


def test_empty_histogram_percentiles_are_nan():
    h = Histogram({}, buckets=(1.0,), window=8)
    assert np.isnan(h.percentile(50))
    assert np.isnan(h.snapshot().estimate_percentile(99))
    assert np.isnan(h.snapshot().mean())


def test_concurrent_counter_increments_are_exact():
    reg = MetricsRegistry()
    c = reg.counter("hits_total")
    h = reg.histogram("obs_ms", window=64)
    n_threads, per_thread = 8, 5_000

    def worker():
        for _ in range(per_thread):
            c.inc()
            h.observe(1.0)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value == n_threads * per_thread
    assert h.count == n_threads * per_thread


# ------------------------------------------------------------- exporters

def _fill(reg):
    reg.counter("reqs_total", help="requests", labels={"model": "m"}).inc(2)
    reg.histogram("lat_ms", unit="ms", buckets=(1.0, 10.0),
                  labels={"model": "m"}).observe(5.0)
    reg.gauge("depth", labels={"model": "m"}).set(4)
    return reg


def test_snapshot_and_prometheus_text_match_the_reference():
    reg = _fill(MetricsRegistry())
    snap = reg.snapshot()
    assert snap["reqs_total"]["type"] == "counter"
    hs = snap["lat_ms"]["series"][0]
    assert hs["count"] == 1 and hs["buckets"] == [[1.0, 0], [10.0, 1],
                                                  ["+Inf", 0]]
    text = reg.to_prometheus()
    for line in ('# TYPE reqs_total counter', 'reqs_total{model="m"} 2.0',
                 'lat_ms_bucket{model="m",le="1.0"} 0',
                 'lat_ms_bucket{model="m",le="+Inf"} 1',
                 'lat_ms_sum{model="m"} 5.0', 'lat_ms_count{model="m"} 1'):
        assert line in text
    ref = _fill(r_obs.MetricsRegistry())
    assert text == ref.to_prometheus()
    assert json.loads(reg.to_json()) == json.loads(ref.to_json())


def test_report_render_table_matches_the_reference():
    from repro_torch.obs.report import render
    reg = MetricsRegistry()
    reg.counter("reqs_total", labels={"model": "m"}).inc(7)
    reg.histogram("lat_ms", unit="ms", window=16).observe(3.0)
    snap = json.loads(reg.to_json())
    out = render(snap)
    assert "reqs_total" in out and "model=m" in out and "p50=3" in out
    assert out == r_render(snap)
    assert render(reg.snapshot(), "nomatch") == "(no metrics matched)"


def test_report_cli_main(tmp_path, capsys):
    from repro_torch.obs.report import main
    p = tmp_path / "snap.json"
    p.write_text(_fill(MetricsRegistry()).to_json())
    assert main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "depth" in out and "model=m" in out
    with pytest.raises(SystemExit):       # exactly one source required
        main([])


def test_http_endpoint_serves_prometheus_and_json():
    reg = MetricsRegistry()
    reg.counter("up_total").inc()
    with obs.start_metrics_server(reg, port=0, host="127.0.0.1") as srv:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=5).read().decode()
        assert "up_total 1.0" in text
        snap = json.loads(urllib.request.urlopen(
            f"{base}/metrics.json", timeout=5).read().decode())
        assert snap["up_total"]["series"][0]["value"] == 1.0
        assert urllib.request.urlopen(f"{base}/healthz", timeout=5).status == 200
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=5)


# --------------------------------------------------------------- tracing

def test_span_parent_child_links_and_sink_ordering(tmp_path):
    path = tmp_path / "spans.jsonl"
    with JsonlSink(path) as sink:
        tr = Tracer(sink)
        with tr.span("flush", n_requests=3) as root:
            with tr.span("dispatch", parent=root):
                pass
            with tr.span("sync", parent=root):
                pass
    recs = [json.loads(line) for line in path.read_text().strip().splitlines()]
    by_name = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["dispatch", "sync", "flush"]
    assert by_name["dispatch"]["parent"] == by_name["flush"]["span"]
    assert by_name["sync"]["parent"] == by_name["flush"]["span"]
    assert len({r["trace"] for r in recs}) == 1
    assert by_name["flush"]["n_requests"] == 3
    assert all(r["dur_ms"] >= 0 for r in recs)
    assert by_name["flush"]["t0"] <= by_name["dispatch"]["t0"]
    assert by_name["dispatch"]["t1"] <= by_name["flush"]["t1"]


def test_retroactive_emit_matches_the_reference():
    recs = {}
    for name, mod in (("port", obs), ("ref", r_obs)):
        sink = mod.ListSink()
        tr = mod.Tracer(sink)
        root = tr.emit("request", 10.0, 10.5, queue_depth=2)
        tr.emit("queued", 10.0, 10.2, parent_id=root)
        assert len(sink) == 2 and sink[1]["parent"] == root and tr.n_spans == 2
        assert sink[0]["dur_ms"] == pytest.approx(500.0)
        recs[name] = [{k: v for k, v in r.items()
                       if k not in ("trace", "span", "parent")} for r in sink]
    assert recs["port"] == recs["ref"]


def test_disabled_tracer_records_nothing():
    sink = ListSink()
    eng = _engine(tracer=Tracer(sink, enabled=False))
    r = eng.submit(np.zeros(16, np.float32))
    eng.run_pending()
    assert r.trace_id is None and sink == []


def test_jsonl_sink_rejects_writes_after_close(tmp_path):
    sink = JsonlSink(tmp_path / "s.jsonl")
    sink({"name": "a"})
    sink.close()
    with pytest.raises(ValueError):
        sink({"name": "b"})


# --------------------------------------------------- serve-tier wiring

def test_engine_stats_report_totals_and_windowed_percentiles():
    eng = _engine()
    rng = np.random.RandomState(0)
    for _ in range(6):
        eng.submit(rng.randn(16).astype(np.float32))
    eng.run_pending()
    s = eng.latency_stats()
    assert s["completed"] == s["completed_total"] == 6
    assert s["flushes"] == s["flushes_total"] == 1
    assert s["deadline_misses"] == s["deadline_misses_total"] == 0
    assert s["window_observations"] == 6
    assert s["telemetry_window"] == eng.telemetry_window
    assert s["latency_p99_ms"] >= s["latency_p50_ms"] >= 0


def test_engine_metrics_registry_series():
    reg = MetricsRegistry()
    eng = _engine(metrics_registry=reg, metrics_labels={"model": "m1"})
    rng = np.random.RandomState(1)
    for _ in range(5):
        eng.submit(rng.randn(16).astype(np.float32))
    assert reg.get("serve_queue_depth", {"model": "m1"}).value == 5
    eng.run_pending()
    snap = reg.snapshot()
    get = {name: snap[name]["series"][0] for name in snap}
    assert get["serve_requests_submitted_total"]["value"] == 5
    assert get["serve_requests_completed_total"]["value"] == 5
    assert get["serve_flushes_total"]["value"] == 1
    assert get["serve_request_latency_ms"]["count"] == 5
    assert get["serve_queue_depth"]["value"] == 0
    assert get["serve_plan_devices"]["value"] == 1
    occ = reg.get("serve_slot_occupancy", {"model": "m1"}).snapshot()
    assert occ.count == 2 and sorted(occ.window) == [0.25, 1.0]
    assert 'serve_flushes_total{model="m1"} 1.0' in reg.to_prometheus()


def test_observability_off_keeps_stats_but_idles_registry():
    eng = _engine(observability=False)
    rng = np.random.RandomState(2)
    for _ in range(3):
        eng.submit(rng.randn(16).astype(np.float32))
    eng.run_pending()
    s = eng.latency_stats()
    assert s["completed_total"] == 3
    assert np.isnan(s["latency_p50_ms"])
    assert eng.metrics.get("serve_requests_submitted_total",
                           eng._metric_labels).value == 0


def test_engine_emits_request_and_flush_spans():
    sink = ListSink()
    eng = _engine(tracer=Tracer(sink))
    rng = np.random.RandomState(3)
    reqs = [eng.submit(rng.randn(16).astype(np.float32)) for _ in range(5)]
    eng.run_pending()
    by_name = {}
    for r in sink:
        by_name.setdefault(r["name"], []).append(r)
    assert len(by_name["request"]) == 5 and len(by_name["flush"]) == 1
    assert len(by_name["queued"]) == len(by_name["compute"]) == 5
    flush = by_name["flush"][0]
    assert flush["n_requests"] == 5 and flush["n_slots"] == 2
    assert by_name["dispatch"][0]["parent"] == flush["span"]
    assert by_name["sync"][0]["parent"] == flush["span"]
    for req, rec in zip(reqs, by_name["request"]):
        assert rec["trace"] == req.trace_id
        assert rec["queue_depth"] == req.queue_depth
        kids = [r for r in sink if r.get("parent") == rec["span"]]
        assert {k["name"] for k in kids} == {"queued", "compute"}


def test_disabled_tracer_adds_zero_allocations_to_submit():
    import repro_torch.obs.trace as trace_mod
    eng = _engine(tracer=Tracer(ListSink(), enabled=False))
    x = np.zeros(16, np.float32)
    for _ in range(4):                       # warm every lazy path
        eng.submit(x)
    eng.run_pending()
    tracemalloc.start()
    try:
        for _ in range(50):
            eng.submit(x)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    eng.run_pending()
    trace_allocs = snap.filter_traces(
        [tracemalloc.Filter(True, trace_mod.__file__)]).statistics("lineno")
    assert sum(s.size for s in trace_allocs) == 0


def _tree(sink):
    """(records by name, children's names by parent span id)."""
    by_name, kids = {}, {}
    for r in sink:
        by_name.setdefault(r["name"], []).append(r)
        kids.setdefault(r["parent"], []).append(r["name"])
    return by_name, kids


def test_call_emits_a_span_tree_with_a_stage_and_enqueue_per_slot():
    sink = ListSink()
    eng = _engine(tracer=Tracer(sink))
    x = np.random.RandomState(6).randn(10, 16).astype(np.float32)
    np.testing.assert_array_equal(eng(x), _engine()(x))
    by_name, kids = _tree(sink)
    (call,) = by_name["call"]
    (disp,) = by_name["dispatch"]
    assert call["parent"] is None and call["rows"] == 10 and call["slots"] == 3
    assert sorted(kids[call["span"]]) == ["dispatch", "gather", "sync"]
    assert kids[disp["span"]] == ["stage", "enqueue"] * 3
    assert [r["rows"] for r in by_name["stage"]] == [4, 4, 2]
    assert all(r["padded_rows"] == 4 for r in by_name["stage"])
    assert [r["timed"] for r in by_name["enqueue"]] == [False, False, True]
    # the last slot's per-segment times, in the plan's segment order
    kinds = [s.kind for s in eng.plan.segments]
    assert [s["kind"] for s in call["segments"]] == kinds
    assert [s["index"] for s in call["segments"]] == list(range(len(kinds)))
    assert all(s["ms"] >= 0 for s in call["segments"])
    for r in sink:
        if r["parent"] is not None:
            assert r["trace"] == call["trace"]


def test_flush_emits_stage_enqueue_per_slot_scatter_and_its_reason():
    sink = ListSink()
    eng = _engine(tracer=Tracer(sink))
    for _ in range(6):
        eng.submit(np.zeros(16, np.float32))
    assert eng.run_pending(reason="deadline") == 6
    by_name, kids = _tree(sink)
    (flush,) = by_name["flush"]
    (disp,) = by_name["dispatch"]
    assert flush["reason"] == "deadline" and flush["n_slots"] == 2
    assert sorted(kids[flush["span"]]) == ["dispatch", "scatter", "sync"]
    assert kids[disp["span"]] == ["stage", "enqueue"] * 2
    assert [r["rows"] for r in by_name["stage"]] == [4, 2]
    assert [r["timed"] for r in by_name["enqueue"]] == [False, True]
    assert len(flush["segments"]) == len(eng.plan.segments)
    scatter = by_name["scatter"][0]
    assert by_name["sync"][0]["t1"] <= scatter["t0"] <= scatter["t1"] <= \
        flush["t1"]
    counter = eng.metrics.get("serve_scheduler_flushes_total",
                              {**eng._metric_labels, "reason": "deadline"})
    assert counter.value == 1
    assert eng.run_pending(reason="window") == 0        # nothing queued
    assert eng.metrics.get("serve_scheduler_flushes_total",
                           {**eng._metric_labels, "reason": "window"}) is None
    assert eng.metrics.get("serve_flushes_total",
                           eng._metric_labels).value == 1


def test_scheduler_names_the_trigger_of_each_flush():
    eng = _engine()
    labels = eng._metric_labels
    sched = ServeScheduler(eng, window_ms=60_000)
    for _ in range(5):                   # a full slot and one row more
        eng.submit(np.zeros(16, np.float32))
    assert sched._poll()[::2] == ("full", True)
    eng.submit(np.zeros(16, np.float32), deadline_ms=1.0)
    assert sched._poll()[0] == "deadline"
    eng.run_pending()
    window = ServeScheduler(eng, window_ms=0.0)
    eng.submit(np.zeros(16, np.float32))
    assert window._poll() == ("window", 0.0, False)
    with sched:
        r = sched.submit(np.zeros(16, np.float32))
    assert r.done()                      # drained by the final flush
    assert eng.metrics.get("serve_scheduler_flushes_total",
                           {**labels, "reason": "stop"}).value == 1


@pytest.mark.parametrize("tracer", ["disabled", "absent"])
def test_disabled_tracer_adds_zero_allocations_to_call(tracer):
    import repro_torch.obs.trace as trace_mod
    eng = _engine(tracer=Tracer(ListSink(), enabled=False)
                  if tracer == "disabled" else None)
    assert eng.plan.segment_timing is (tracer == "disabled")
    x = np.zeros((10, 16), np.float32)
    eng(x)                                   # warm every lazy path
    tracemalloc.start()
    try:
        for _ in range(20):
            eng(x)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    trace_allocs = snap.filter_traces(
        [tracemalloc.Filter(True, trace_mod.__file__)]).statistics("lineno")
    assert sum(s.size for s in trace_allocs) == 0
    assert eng.plan._last_marks is None      # no slot was timed
    assert eng.plan.record_segment_times() == []


def test_scheduler_stats_totals_and_rejection_counter():
    from repro_torch.serve import QueueFull
    eng = _engine()
    # a window that cannot expire between the submits: the flush loop
    # must not drain the queue before the third submit finds it full
    sched = ServeScheduler(eng, max_queue=2, block=False, window_ms=60_000)
    xs = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    with sched:
        sched.submit(xs[0])
        sched.submit(xs[1])
        with pytest.raises(QueueFull):
            sched.submit(xs[2])
        s = sched.stats()
        assert s["submitted"] == s["submitted_total"] == 2
        assert s["rejected"] == s["rejected_total"] == 1
    assert eng.metrics.get("serve_scheduler_rejected_total",
                           eng._metric_labels).value == 1
    assert "admission_wait_p99_ms" in s


def test_registry_injects_model_labels_and_merges_snapshots():
    from repro_torch.serve import EngineRegistry
    reg = EngineRegistry(max_batch=4, report_cost=False, device="cpu")
    reg.register("a", _mlp(seed=1))
    reg.register("b", _mlp(seed=2))
    reg("a", np.zeros(16, np.float32))
    series = reg.metrics_snapshot()["serve_requests_completed_total"]["series"]
    assert {s["labels"]["model"] for s in series} == {"a", "b"}


# ---------------------------------------------- compile-tier instrumentation

def test_compile_records_wall_time_and_plan_gauges():
    from repro_torch.core.compile import compile_graph
    from repro_torch.obs import default_registry
    reg = default_registry()
    g = _mlp(seed=9)
    before = reg.get("compile_wall_ms", {"model": g.name})
    n0 = before.count if before is not None else 0
    plan = compile_graph(g, device="cpu")
    lbl = {"model": plan.graph.name}
    assert reg.get("compile_wall_ms", lbl).count == n0 + 1
    assert reg.get("compile_segments",
                   {**lbl, "kind": "total"}).value == len(plan.segments)
    assert reg.get("compile_integer_requant_coverage", lbl).value == \
        plan.requant_stats()["coverage"]
    # the retrace counter follows the trace-count probe
    retrace = reg.get("compile_plan_retraces_total", lbl)
    r0, t0 = retrace.value, plan.trace_count
    plan({"x": np.zeros((1, 16), np.float32)})
    plan({"x": np.zeros((1, 16), np.float32)})      # same shape: no retrace
    assert plan.trace_count == t0 + 1 and retrace.value == r0 + 1
    plan({"x": np.zeros((1, 16), np.float32)}, jit=False)   # eager: one each
    assert plan.trace_count == t0 + 2 and retrace.value == r0 + 2


def test_record_segment_times_observes_each_kind_once_a_timed_call():
    """On the CPU a timed call reads the host clock between the segments:
    one observation a kind a timed call, and the segments add up to the
    call."""
    import time

    from repro_torch.core.compile import compile_graph
    from repro_torch.models.zoo import build_mobilenet
    from repro_torch.obs import default_registry
    g = build_mobilenet(4, 4, img=32)
    g.name = "obs_segment_times_mobilenet32"
    plan = compile_graph(g, device="cpu")
    x = {"x": np.random.RandomState(7).randn(2, 3, 32, 32)
         .astype(np.float32)}
    (y,) = plan.graph.output_names
    np.testing.assert_array_equal(plan(x, timed=True)[y], plan(x)[y])
    assert len(plan.record_segment_times()) == len(plan.segments)
    assert plan.record_segment_times() == []            # read once
    plan(x)                                             # not timed
    assert plan.record_segment_times() == []
    reg = default_registry()
    kinds = plan.fused_counts
    assert {"quant_conv_dw", "quant_dequant"} <= set(kinds)

    def counts():
        out = {}
        for k in kinds:
            h = reg.get("plan_segment_device_ms",
                        {"model": g.name, "kind": k})
            out[k] = (h.count, h.sum) if h is not None else (0, 0.0)
        return out
    before = counts()
    replay = reg.get("plan_replay_device_ms", {"model": g.name})
    r0 = (replay.count, replay.sum)
    t0 = time.perf_counter()
    plan(x, timed=True)
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = plan.record_segment_times()
    after = counts()
    assert [r["kind"] for r in rows] == [s.kind for s in plan.segments]
    total = sum(r["ms"] for r in rows)
    for k in kinds:
        assert after[k][0] == before[k][0] + 1
        assert after[k][1] - before[k][1] == pytest.approx(
            sum(r["ms"] for r in rows if r["kind"] == k))
    assert replay.count == r0[0] + 1
    assert replay.sum - r0[1] == pytest.approx(total)
    assert 0.5 * wall_ms <= total <= wall_ms


# ----------------------------------------------------- segment profiler

def _check_profile(prof, plan):
    from repro_torch.analysis import infer_cost
    assert len(prof.segments) == len(plan.segments)
    mac_total = 0
    for row, seg in zip(prof.segments, plan.segments):
        assert row.kind == seg.kind and row.measured_ms > 0
        assert row.achieved_bytes > 0 and row.analysis_bytes > 0
        assert row.requant == seg.meta.get("requant_path")
        if row.macs:
            assert row.macs_per_s > 0 and row.layers
        mac_total += row.macs
    # the cost-report join accounts for every MAC in the model
    assert mac_total == infer_cost(plan.graph, ga=plan.analysis).macs
    assert prof.plan_ms > 0 and prof.device == "cpu"
    assert prof.sum_segments_ms == pytest.approx(
        sum(r.measured_ms for r in prof.segments))
    assert len(prof.table().splitlines()) == len(prof.segments) + 4
    js = prof.to_json()
    assert js["total_macs"] == mac_total and js["device"] == "cpu"
    assert len(js["segments"]) == len(prof.segments)


def test_profile_joins_cost_report_on_conv_models():
    """CNV-w1a1: every kernel segment's MACs equal the reference
    profiler's row for the same segment (the same cost report join)."""
    from repro_torch.core.compile import compile_graph
    from repro_torch.models import zoo
    plan = compile_graph(zoo.ZOO["CNV-w1a1"](), device="cpu")
    # a caller-given peak adds the roofline column; there is no default
    prof = plan.profile(repeats=1, bw_gbps=1000.0)
    _check_profile(prof, plan)
    kernel_rows = [r for r in prof.segments
                   if r.kind.startswith(("quant_conv", "quant_matmul"))]
    assert kernel_rows and all(r.macs > 0 and r.macs_per_s > 0
                               for r in kernel_rows)
    assert all(r.requant == "int32" for r in kernel_rows)
    assert all(r.roofline_ms is not None for r in prof.segments)
    assert plan.profile(repeats=1).bw_gbps is None
    from repro.analysis import infer_cost as r_infer_cost
    from repro.core.passes import run_pipeline as r_run
    from repro.models import zoo as rzoo
    rg = r_run(rzoo.ZOO["CNV-w1a1"](), "compile_prep")
    r_macs = {l.name: l.macs for l in r_infer_cost(rg).layers}
    for row in kernel_rows:
        assert row.macs == sum(r_macs[n] for n in row.layers)


def test_profile_mobilenet_grouped_segments():
    from repro_torch.core.compile import compile_graph
    from repro_torch.models.zoo import build_mobilenet
    plan = compile_graph(build_mobilenet(4, 4, img=32), device="cpu")
    prof = plan.profile(repeats=1)
    _check_profile(prof, plan)
    grouped = [r for r in prof.segments
               if r.kind.startswith(("quant_conv_grouped", "quant_conv_dw"))]
    assert grouped and all(r.measured_ms > 0 and r.macs > 0 for r in grouped)


def test_profile_registry_gauges_and_batch_input():
    from repro_torch.core.compile import compile_graph
    reg = MetricsRegistry()
    plan = compile_graph(_mlp(seed=5), device="cpu")
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    prof = plan.profile({"x": x}, repeats=1, registry=reg)
    assert prof.batch == 4
    gauges = reg.snapshot()["profile_segment_ms"]["series"]
    assert len(gauges) == len(plan.segments)
    assert all(s["value"] > 0 for s in gauges)


@pytest.mark.parametrize("n", [1, 3])
def test_time_fns_alternate_and_time_fn_is_best_of(n):
    from repro_torch.obs import time_fn, time_fns
    calls = []
    fns = [lambda i=i: calls.append(i) for i in range(n)]
    best = time_fns(fns, repeats=2, warmup=1)
    assert len(best) == n and all(b >= 0 for b in best)
    assert calls == list(range(n)) + list(range(n)) * 2   # warm-up, then turns
    assert time_fn(lambda: torch.zeros(3), repeats=3) >= 0
