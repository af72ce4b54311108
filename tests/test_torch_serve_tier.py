"""The port's serving tier on the CPU: scheduler, registry, split-merge
front, the plan's signature cache, fault tolerance and the launcher's
compiled-graph path.

Two kinds of test.  The behaviours ``tests/test_serve.py`` pins for the
reference (futures, pipelined dispatch, the no-retrace probe, reloads
under traffic, scheduler backpressure / deadlines / windows / hooks,
registry routing, monotonic clocks, the split-merge front) and the
single-device cases of ``tests/test_dist_serve.py`` each have a
counterpart here, on the same tiny MLP (built by the port) and with the
reference's tolerance against the port's oracle.  Then the port is held
against ``repro`` on TFC-w2a2 at published width (784 -> 64 -> 64 -> 64 ->
10, the integer path): the rows the port's scheduler, registry,
split-merge front and launcher serve equal the reference engine's rows
on the same numpy inputs, bit for bit.  Every wait and join has a
timeout.
"""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import zoo as rzoo  # noqa: E402
from repro.serve import CompiledGraphEngine as RefEngine  # noqa: E402
from repro_torch.core import GraphBuilder, execute, transforms  # noqa: E402
from repro_torch.dist import fault  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve import (CompiledGraphEngine, EngineRegistry,  # noqa: E402
                               QueueFull, ServeScheduler, SplitMergeFront,
                               Worker, device_workers)

TFC_ROWS = 48


def _mlp(seed=0, out_dim=6, in_dim=16):
    """Tiny tie-free quantized MLP, fast to compile (the reference tests'
    fixture, built by the port)."""
    rng = np.random.RandomState(seed)
    b = GraphBuilder(f"mlp_s{seed}_o{out_dim}")
    x = b.add_input("x", (1, in_dim))
    h = b.quant(x, 0.0973, 0.0, 4, signed=True)
    w = b.add_initializer("w", rng.randn(in_dim, out_dim)
                          .astype(np.float32) * 0.4)
    qw = b.quant(w, 0.0517, 0.0, 4, narrow=True)
    (h,) = b.add_node("MatMul", [h, qw], 1)
    b.mark_output(h)
    return b.build()


def _oracle(g, x):
    gc = transforms.cleanup(g)
    return execute(gc, {"x": x}, device="cpu")[gc.output_names[0]].numpy()


def _engine(g=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("report_cost", False)
    return CompiledGraphEngine(g if g is not None else _mlp(), device="cpu", **kw)


@pytest.fixture(scope="module")
def tfc():
    """TFC-w2a2 inputs (the launcher's: ``default_rng(0)`` normal rows) and
    the reference engine's rows for them, computed once."""
    rng = np.random.default_rng(0)
    x = np.stack([rng.standard_normal((784,), dtype=np.float32)
                  for _ in range(TFC_ROWS)])
    ref = RefEngine(rzoo.build_tfc(2, 2), max_batch=8, report_cost=False)
    return x, np.asarray(ref(x))


# ------------------------------------------------------- request futures

def test_graph_request_future_lifecycle():
    eng = _engine()
    x = np.random.RandomState(0).randn(16).astype(np.float32)
    r = eng.submit(x)
    assert not r.done() and r.latency_ms is None and r.queued_ms is None
    assert eng.run_pending() == 1 and r.done()
    np.testing.assert_allclose(r.wait(timeout=1),
                               _oracle(eng.plan.graph, x[None])[0], atol=1e-5)
    assert r.queued_ms >= 0 and r.latency_ms >= r.queued_ms


def test_wait_times_out_without_a_flush():
    r = _engine().submit(np.zeros(16, np.float32))
    with pytest.raises(TimeoutError):
        r.wait(timeout=0.02)


def test_latency_stats_aggregated_and_logged_at_flush(caplog):
    eng = _engine()
    rng = np.random.RandomState(1)
    for _ in range(6):                       # 2 slots in one flush
        eng.submit(rng.randn(16).astype(np.float32))
    with caplog.at_level("INFO", logger="repro_torch.serve"):
        eng.run_pending()
    assert any("latency p50" in rec.getMessage() for rec in caplog.records)
    s = eng.latency_stats()
    assert s["completed"] == 6 and s["flushes"] == 1
    assert s["latency_p99_ms"] >= s["latency_p50_ms"] >= 0
    assert s["queued_p50_ms"] >= 0 and s["deadline_misses"] == 0


# -------------------------------------------------- pipelined dispatch

def test_pipelined_and_sync_dispatch_agree():
    g = _mlp()
    x = np.random.RandomState(2).randn(11, 16).astype(np.float32)
    eng = _engine(g, pipeline=True)
    out_pipe = eng(x)
    eng.pipeline = False
    np.testing.assert_array_equal(out_pipe, eng(x))
    np.testing.assert_allclose(out_pipe, _oracle(g, x), atol=1e-4)


def test_run_pending_pipelined_multi_slot_matches_oracle():
    g = _mlp()
    eng = _engine(g, max_batch=2)
    rng = np.random.RandomState(3)
    xs = [rng.randn(16).astype(np.float32) for _ in range(7)]  # 4 slots
    reqs = [eng.submit(x) for x in xs]
    assert eng.run_pending() == 7
    ref = _oracle(g, np.stack(xs))
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(r.result, ref[i], atol=1e-4)


@pytest.mark.parametrize("max_batch", [4, 8])
def test_batch_sizes_up_to_three_slots_reach_one_signature(max_batch, tfc):
    """Ad-hoc batch sizes 1 .. 3 x max_batch all route through the padded
    slot: after the first call the plan records no new signature (on the
    card: no new capture), and every row equals the reference engine's."""
    x, ref = tfc
    eng = CompiledGraphEngine(zoo.build_tfc(2, 2), max_batch=max_batch,
                              device="cpu", report_cost=False)
    eng(x[:2])
    traced = eng.plan.trace_count
    for bsz in range(1, 3 * max_batch + 1):
        out = eng(x[:bsz])
        np.testing.assert_array_equal(out, ref[:bsz])
    eng.submit(x[0])                        # flush path too
    eng.run_pending()
    assert eng.plan.trace_count == traced == 1


@pytest.mark.parametrize("donate", [True, False, "auto"])
def test_donate_flag_keeps_results_correct(donate):
    g = _mlp()
    x = np.random.RandomState(5).randn(6, 16).astype(np.float32)
    np.testing.assert_allclose(_engine(g, donate=donate)(x), _oracle(g, x),
                               atol=1e-4)


# ---------------------------------------------------------------- reload

def test_reload_queued_requests_answered_by_old_plan():
    g1, g2 = _mlp(seed=0), _mlp(seed=42)
    eng = _engine(g1)
    rng = np.random.RandomState(6)
    xs = [rng.randn(16).astype(np.float32) for _ in range(3)]
    reqs = [eng.submit(x) for x in xs]
    eng.reload(g2)
    ref_old = _oracle(g1, np.stack(xs))
    for i, r in enumerate(reqs):                      # old model answered
        np.testing.assert_allclose(r.result, ref_old[i], atol=1e-4)
    x_new = rng.randn(16).astype(np.float32)
    r = eng.submit(x_new)
    eng.run_pending()
    np.testing.assert_allclose(r.result, _oracle(g2, x_new[None])[0], atol=1e-4)


def test_empty_batch_output_shape_follows_reload():
    eng = _engine(_mlp(out_dim=6))
    assert eng(np.zeros((0, 16), np.float32)).shape == (0, 6)
    eng.reload(_mlp(out_dim=9))
    assert eng(np.zeros((0, 16), np.float32)).shape == (0, 9)


def test_concurrent_submits_during_reload_answered_consistently():
    """Hot swap under fire: every future completes with one of the two
    models' rows, never a torn mix of old and new state."""
    g1, g2 = _mlp(seed=0), _mlp(seed=42)
    eng = _engine(g1, max_batch=2)
    rng = np.random.RandomState(7)
    xs = [rng.randn(16).astype(np.float32) for _ in range(40)]
    refs = [(_oracle(g1, x[None])[0], _oracle(g2, x[None])[0]) for x in xs]
    reqs = []
    stop = threading.Event()

    def submitter():
        for x in xs:
            reqs.append(eng.submit(x))
            time.sleep(0.002)
        stop.set()

    with ServeScheduler(eng, window_ms=1.0, max_queue=64):
        t = threading.Thread(target=submitter)
        t.start()
        eng.reload(g2)
        eng.reload(g1)
        t.join(timeout=30)
        assert stop.is_set() and not t.is_alive()
        for r in reqs:
            r.wait(timeout=30)
    for r, (ref1, ref2) in zip(reqs, refs):
        assert np.allclose(r.result, ref1, atol=1e-4) or \
            np.allclose(r.result, ref2, atol=1e-4)


def test_reload_frees_the_old_plan_once_drained():
    """The old plan (on the card: its captured graphs and memory pool)
    lives until its queued requests have drained, and no longer."""
    import gc
    import weakref
    eng = _engine()
    old = weakref.ref(eng.plan)
    r = eng.submit(np.zeros(16, np.float32))
    eng.reload(_mlp(seed=3))
    assert r.done()
    gc.collect()
    assert old() is None


# ------------------------------------------------------------- scheduler

def test_scheduler_completes_submitted_requests():
    g = _mlp()
    eng = _engine(g)
    rng = np.random.RandomState(8)
    xs = [rng.randn(16).astype(np.float32) for _ in range(10)]
    with ServeScheduler(eng, window_ms=2.0, max_queue=32) as sched:
        reqs = [sched.submit(x) for x in xs]
        outs = np.stack([r.wait(timeout=60) for r in reqs])
    np.testing.assert_allclose(outs, _oracle(g, np.stack(xs)), atol=1e-4)
    assert sched.stats()["submitted"] == 10 and eng.pending() == 0


def test_scheduler_backpressure_nonblocking_raises():
    eng = _engine()
    sched = ServeScheduler(eng, max_queue=2, block=False)   # not started
    sched.submit(np.zeros(16, np.float32))
    sched.submit(np.zeros(16, np.float32))
    with pytest.raises(QueueFull, match="capacity"):
        sched.submit(np.zeros(16, np.float32))
    assert sched.stats()["rejected"] == 1
    eng.run_pending()


def test_scheduler_backpressure_blocking_times_out_then_recovers():
    eng = _engine()
    sched = ServeScheduler(eng, max_queue=1, block=True)    # not started
    sched.submit(np.zeros(16, np.float32))
    with pytest.raises(QueueFull, match="timed out"):
        sched.submit(np.zeros(16, np.float32), timeout=0.03)
    eng.run_pending()                                       # space frees up
    r = sched.submit(np.zeros(16, np.float32), timeout=1.0)
    eng.run_pending()
    assert r.done()


def test_scheduler_full_slot_flushes_without_waiting_window():
    eng = _engine(max_batch=4)
    with ServeScheduler(eng, window_ms=60_000) as sched:    # huge window
        reqs = [sched.submit(np.zeros(16, np.float32)) for _ in range(4)]
        for r in reqs:
            r.wait(timeout=20)                              # full slot fired


def test_scheduler_deadline_flushes_early():
    eng = _engine()
    with ServeScheduler(eng, window_ms=60_000, flush_margin_ms=20.0) as sched:
        r = sched.submit(np.zeros(16, np.float32), deadline_ms=40.0)
        r.wait(timeout=20)                                  # deadline fired
    assert r.deadline is not None


def test_scheduler_window_flushes_partial_slot():
    eng = _engine(max_batch=8)
    with ServeScheduler(eng, window_ms=30.0) as sched:
        r = sched.submit(np.zeros(16, np.float32))          # 1 of 8 slots
        r.wait(timeout=20)                                  # window fired
    assert r.latency_ms >= 30.0 * 0.5


def test_scheduler_rejects_submit_after_stop():
    eng = _engine()
    sched = ServeScheduler(eng, window_ms=5.0).start()
    r = sched.submit(np.zeros(16, np.float32))
    sched.stop()
    r.wait(timeout=10)                        # final drain covered it
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(np.zeros(16, np.float32))


def test_run_pending_only_full_slots_leaves_tail_batching():
    eng = _engine(max_batch=4)
    for _ in range(6):
        eng.submit(np.zeros(16, np.float32))
    assert eng.run_pending(only_full_slots=True) == 4
    assert eng.pending() == 2
    assert eng.run_pending() == 2


def test_missed_deadline_counted_in_telemetry():
    eng = _engine()
    eng.submit(np.zeros(16, np.float32), deadline_ms=0.0)   # already due
    time.sleep(0.01)
    eng.run_pending()
    assert eng.latency_stats()["deadline_misses"] == 1


def test_scheduler_rows_equal_the_reference_engine(tfc):
    x, ref = tfc
    eng = CompiledGraphEngine(zoo.build_tfc(2, 2), max_batch=8, device="cpu",
                              report_cost=False)
    with ServeScheduler(eng, window_ms=2.0, max_queue=TFC_ROWS) as sched:
        reqs = [sched.submit(r, deadline_ms=50.0) for r in x]
        got = np.stack([r.wait(timeout=60) for r in reqs])
    np.testing.assert_array_equal(got, ref)
    assert eng.plan.trace_count == 1


# -------------------------------------------------------------- registry

def test_registry_routes_by_name():
    reg = EngineRegistry(report_cost=False, max_batch=2, device="cpu")
    reg.register("small", _mlp(out_dim=4))
    reg.register("large", _mlp(out_dim=9))
    x = np.random.RandomState(9).randn(16).astype(np.float32)
    assert reg("small", x).shape == (4,) and reg("large", x).shape == (9,)
    assert reg.names() == ["large", "small"]
    assert "small" in reg and len(reg) == 2


def test_registry_submit_and_run_pending_across_models():
    reg = EngineRegistry(report_cost=False, max_batch=2, device="cpu")
    reg.register("a", _mlp(seed=0))
    reg.register("b", _mlp(seed=1))
    ra = reg.submit("a", np.zeros(16, np.float32))
    rb = reg.submit("b", np.zeros(16, np.float32))
    assert reg.run_pending() == 2 and ra.done() and rb.done()
    stats = reg.stats()
    assert stats["a"]["completed"] == 1 and stats["b"]["completed"] == 1


@pytest.mark.parametrize("case", ["duplicate", "unknown", "neither"])
def test_registry_duplicate_and_unknown_names(case):
    reg = EngineRegistry(report_cost=False, device="cpu")
    reg.register("tfc", _mlp())
    if case == "duplicate":
        with pytest.raises(ValueError, match="already registered"):
            reg.register("tfc", _mlp())
    elif case == "unknown":
        with pytest.raises(KeyError, match="did you mean 'tfc'"):
            reg.get("tfcc")
    else:
        with pytest.raises(ValueError, match="exactly one"):
            reg.register("x")


def test_registry_reload_hot_swaps_model():
    g1, g2 = _mlp(seed=0, out_dim=4), _mlp(seed=1, out_dim=7)
    reg = EngineRegistry(report_cost=False, max_batch=2, device="cpu")
    reg.register("m", g1)
    x = np.random.RandomState(10).randn(16).astype(np.float32)
    assert reg("m", x).shape == (4,)
    reg.reload("m", g2)
    out = reg("m", x)
    assert out.shape == (7,)
    np.testing.assert_allclose(out, _oracle(g2, x[None])[0], atol=1e-4)


def test_registry_unregister_flushes_pending():
    reg = EngineRegistry(report_cost=False, max_batch=2, device="cpu")
    reg.register("m", _mlp())
    r = reg.submit("m", np.zeros(16, np.float32))
    eng = reg.unregister("m")
    assert r.done() and "m" not in reg
    assert eng.latency_stats()["completed"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros(16, np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        eng.reload(_mlp(seed=1))


def test_registry_rows_equal_the_reference_engine(tfc):
    """Two TFC-w2a2 engines behind one registry, traffic split by the
    default least-pending router and by name: every row the reference's."""
    x, ref = tfc
    reg = EngineRegistry(report_cost=False, max_batch=8, device="cpu")
    reg.register("a", zoo.build_tfc(2, 2))
    reg.register("b", zoo.build_tfc(2, 2))
    half = TFC_ROWS // 2
    routed = [reg.route(r) for r in x[:half]]
    named = [reg.submit("b", r) for r in x[half:]]
    assert reg.run_pending() == TFC_ROWS
    got = np.stack([r.wait(timeout=10) for r in routed + named])
    np.testing.assert_array_equal(got, ref)
    series = reg.metrics_snapshot()["serve_routed_total"]["series"]
    assert {s["labels"]["model"]: s["value"] for s in series} == \
        {"a": half / 2, "b": half / 2}


# ------------------------------------------------- clocks (monotonic-only)

def test_interval_math_survives_backwards_wall_clock_jump(monkeypatch):
    eng = _engine()
    r = eng.submit(np.zeros(16, np.float32), deadline_ms=60_000.0)
    monkeypatch.setattr(time, "time", lambda: 1.0)
    eng.run_pending()
    r.wait(timeout=1)
    assert r.latency_ms is not None and r.latency_ms >= 0
    assert r.queued_ms is not None and r.queued_ms >= 0
    assert eng.latency_stats()["deadline_misses"] == 0
    assert r.submitted_at != r.submitted


def test_scheduler_deadline_unmoved_by_wall_clock_jump(monkeypatch):
    eng = _engine()
    sched = ServeScheduler(eng, window_ms=10_000.0)
    eng.submit(np.zeros(16, np.float32), deadline_ms=30_000.0)
    monkeypatch.setattr(time, "time", lambda: time.monotonic() + 3600.0)
    should, delay, _full = sched._poll()
    assert not should and delay is not None and delay > 1.0


def test_no_wall_clock_in_serve_interval_arithmetic():
    import pathlib

    import repro_torch.serve as serve_pkg
    root = pathlib.Path(serve_pkg.__file__).parent
    offenders = [f"{py.name}:{i}: {line.strip()}"
                 for py in root.glob("*.py")
                 for i, line in enumerate(py.read_text().splitlines(), 1)
                 if "time.time" in line and "wall, logs only" not in line]
    assert not offenders, offenders


# -------------------------------------------------- scheduler flush hooks

def test_scheduler_flush_hook_fires_after_flush():
    eng = _engine()
    seen = []
    with ServeScheduler(eng, window_ms=1.0) as sched:
        sched.add_flush_hook(seen.append)
        sched.submit(np.zeros(16, np.float32)).wait(timeout=5)
    assert sum(seen) == 1


def test_scheduler_flush_hook_error_does_not_break_loop():
    eng = _engine()

    def bad_hook(n):
        raise RuntimeError("hook boom")

    with ServeScheduler(eng, window_ms=1.0) as sched:
        sched.add_flush_hook(bad_hook)
        sched.submit(np.zeros(16, np.float32)).wait(timeout=5)
        sched.submit(np.ones(16, np.float32)).wait(timeout=5)


# ----------------------------------------------------- registry routing

def test_registry_route_least_pending_default():
    reg = EngineRegistry(report_cost=False, max_batch=4, device="cpu")
    reg.register("a", _mlp(seed=0))
    reg.register("b", _mlp(seed=1))
    x = np.zeros(16, np.float32)
    reg.route(x)                      # tie -> "a" (name order)
    reg.route(x)                      # "a" busier -> "b"
    assert reg.get("a").pending() == 1 and reg.get("b").pending() == 1
    reg.run_pending()
    routed = {s["labels"]["model"]: s["value"]
              for s in reg.metrics_snapshot()["serve_routed_total"]["series"]}
    assert routed == {"a": 1.0, "b": 1.0}


def test_registry_route_custom_router_and_errors():
    reg = EngineRegistry(report_cost=False, max_batch=4, device="cpu")
    with pytest.raises(KeyError, match="no models"):
        reg.route(np.zeros(16, np.float32))
    reg.register("a", _mlp(seed=0))
    reg.register("b", _mlp(seed=1))
    reg.set_router(lambda engines, x: "b")
    r = reg.route(np.zeros(16, np.float32))
    assert reg.get("b").pending() == 1
    reg.set_router(lambda engines, x: "nope")
    with pytest.raises(KeyError, match="router chose unknown"):
        reg.route(np.zeros(16, np.float32))
    reg.set_router(None)
    reg.route(np.zeros(16, np.float32))
    reg.run_pending()
    r.wait(timeout=5)


# ------------------------------------------------------- split-merge front

def _front(n_workers=3, seed=0, **front_kw):
    g = _mlp(seed=seed)
    workers = [Worker(name=f"w{i}", engine=_engine(_mlp(seed=seed)))
               for i in range(n_workers)]
    return g, workers, SplitMergeFront(workers, **front_kw)


def test_splitmerge_merges_in_submission_order():
    g, _workers, front = _front()
    xs = [r for r in np.random.RandomState(3).randn(10, 16).astype(np.float32)]
    with front:
        out = front(xs, timeout=30)           # 10 requests over 3 workers
    np.testing.assert_allclose(out, _oracle(g, np.stack(xs)), atol=1e-4)


@pytest.mark.parametrize("n", [1, 3, 7])
def test_splitmerge_remainder_and_fewer_requests_than_workers(n):
    g, _workers, front = _front(n_workers=4)
    xs = [r for r in np.random.RandomState(n).randn(n, 16).astype(np.float32)]
    with front:
        out = front(xs, timeout=30)
    assert out.shape[0] == n
    np.testing.assert_allclose(out, _oracle(g, np.stack(xs)), atol=1e-4)


def test_splitmerge_injected_fault_loses_zero_requests():
    g, workers, front = _front()
    xs = [r for r in np.random.RandomState(5).randn(9, 16).astype(np.float32)]
    workers[1].inject_fault()         # dies mid-shard, after submission
    with front:
        out = front(xs, timeout=30)
    np.testing.assert_allclose(out, _oracle(g, np.stack(xs)), atol=1e-4)
    s = front.stats()
    assert s["failed"] == ["w1"] and s["redispatched_shards"] == 1
    assert s["healthy"] == 2
    redisp = {ser["labels"]["worker"]: ser["value"]
              for ser in front.metrics.snapshot()
              ["splitmerge_redispatch_total"]["series"] if ser["value"]}
    assert sum(redisp.values()) == 1 and "w1" not in redisp


def test_splitmerge_failed_worker_skipped_on_next_wave():
    g, workers, front = _front()
    xs = [r for r in np.random.RandomState(6).randn(6, 16).astype(np.float32)]
    workers[0].inject_fault()
    with front:
        front(xs, timeout=30)
        assert front.stats()["failed"] == ["w0"]
        out = front(xs, timeout=30)           # second wave: healthy only
    np.testing.assert_allclose(out, _oracle(g, np.stack(xs)), atol=1e-4)
    disp = {ser["labels"]["worker"]: ser["value"]
            for ser in front.metrics.snapshot()
            ["splitmerge_dispatch_total"]["series"]}
    assert disp["w0"] == 1


def test_splitmerge_all_workers_dead_raises():
    w = Worker(name="only", engine=_engine())
    front = SplitMergeFront([w])
    w.inject_fault()
    with front:
        wave = front.submit_wave([np.zeros(16, np.float32)])
        with pytest.raises(RuntimeError):
            wave.wait(timeout=10)


def test_splitmerge_scheduler_backed_workers():
    g = _mlp(seed=7)
    engines = [_engine(_mlp(seed=7)) for _ in range(2)]
    scheds = [ServeScheduler(e, window_ms=1.0).start() for e in engines]
    workers = [Worker(name=f"s{i}", engine=e, scheduler=s)
               for i, (e, s) in enumerate(zip(engines, scheds))]
    xs = [r for r in np.random.RandomState(8).randn(6, 16).astype(np.float32)]
    try:
        with SplitMergeFront(workers) as front:
            out = front(xs, timeout=30)
        np.testing.assert_allclose(out, _oracle(g, np.stack(xs)), atol=1e-4)
    finally:
        for s in scheds:
            s.stop()


@pytest.mark.parametrize("case", ["empty", "duplicate"])
def test_splitmerge_validates_workers(case):
    if case == "empty":
        with pytest.raises(ValueError, match="at least one"):
            SplitMergeFront([])
    else:
        e = _engine()
        with pytest.raises(ValueError, match="duplicate"):
            SplitMergeFront([Worker(name="x", engine=e),
                             Worker(name="x", engine=e)])


# ---------------------------------------- single-device workers (dist cases)

def test_device_workers_pin_their_plans(tfc):
    """Two workers on one device (a list may repeat a device): each plan
    placed on it and equal to the reference engine's rows."""
    x, ref = tfc
    workers = device_workers(zoo.ZOO["TFC-w2a2"], devices=["cpu", "cpu"],
                             max_batch=8, report_cost=False)
    assert [w.name for w in workers] == ["dev0", "dev1"]
    for w in workers:
        assert w.engine.plan.placement() == {"kind": "device", "devices": 1,
                                             "device": "cpu"}
        assert w.engine.plan.n_devices == 1
        np.testing.assert_array_equal(w.engine(x[:5]), ref[:5])


def test_splitmerge_wave_over_device_workers_survives_fault(tfc):
    x, ref = tfc
    workers = device_workers(zoo.ZOO["TFC-w2a2"], devices=["cpu"] * 3,
                             max_batch=8, report_cost=False)
    workers[1].inject_fault()
    with SplitMergeFront(workers) as front:
        rows = front.submit_wave(list(x)).wait(timeout=60)
        s = front.stats()
    np.testing.assert_array_equal(np.stack(rows), ref)
    assert s["failed"] == ["dev1"] and s["redispatched_shards"] == 1


def test_device_workers_default_to_every_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only host's error")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_workers(zoo.ZOO["TFC-w1a1"])


# ------------------------------------------------------- fault tolerance

def test_run_with_restarts_rebuilds_state_and_bounds_attempts():
    seen = []

    def run(state):
        seen.append(state)
        if len(seen) < 3:
            raise RuntimeError("boom")
        return state * 10

    policy = fault.RestartPolicy(max_restarts=3, backoff_s=0.0)
    assert fault.run_with_restarts(lambda: len(seen), run, policy) == 20
    assert seen == [0, 1, 2] and len(policy.history) == 2
    with pytest.raises(RuntimeError):
        fault.run_with_restarts(lambda: 0, lambda s: 1 / 0 if False else
                                (_ for _ in ()).throw(RuntimeError("x")),
                                fault.RestartPolicy(max_restarts=1, backoff_s=0.0))


def test_restart_policy_backoff_is_capped():
    p = fault.RestartPolicy(backoff_s=1.0, backoff_mult=2.0, max_backoff_s=5.0)
    assert [p.delay_s(a) for a in range(5)] == [1.0, 2.0, 4.0, 5.0, 5.0]


def test_watchdog_flags_stragglers_above_the_floor():
    clock = iter([0.0, 0.1, 1.0, 1.1, 2.0, 2.5]).__next__
    wd = fault.Watchdog(threshold=1.5, floor_s=0.05)
    import repro_torch.dist.fault as fmod
    real = fmod.time.monotonic
    fmod.time.monotonic = clock
    try:
        flags = []
        for step in range(3):
            wd.step_start()
            flags.append(wd.step_end(step))
    finally:
        fmod.time.monotonic = real
    assert flags == [False, False, True] and wd.stragglers == [2]
    assert wd.step_end(9) is False             # no step_start: no sample


def test_elastic_mesh_names_its_roadmap_item():
    # ported: CUDA devices by default (raising without CUDA, as
    # resolve_device does), or the one device named
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fault.elastic_mesh()
    m = fault.elastic_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.axis_names == ("data", "model")


# ------------------------------------------------------------- launcher

def _run(tmp_path, *flags, requests=TFC_ROWS):
    return launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                          "--requests", str(requests), *flags])


def test_launcher_graph_serves_the_reference_rows(tfc):
    x, ref = tfc
    out = launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                         "--requests", str(TFC_ROWS)])
    assert out["graph"] == "TFC-w2a2" and out["requests"] == TFC_ROWS
    np.testing.assert_array_equal(out["results"], ref)
    assert out["stats"]["completed"] == TFC_ROWS     # the warm call is no request
    assert out["requests_per_s"] > 0


@pytest.mark.parametrize("flags", [["--no-pipeline"],
                                   ["--window-ms", "1", "--deadline-ms", "50",
                                    "--max-batch", "16"]])
def test_launcher_dispatch_flags(tfc, flags):
    x, ref = tfc
    out = launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                         "--requests", "20", *flags])
    np.testing.assert_array_equal(out["results"], ref[:20])


def test_launcher_splitmerge_serves_the_reference_rows(tfc):
    x, ref = tfc
    out = launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                         "--requests", str(TFC_ROWS), "--splitmerge"])
    np.testing.assert_array_equal(out["results"], ref)
    assert out["stats"]["workers"] == 1 and out["stats"]["failed"] == []


def test_launcher_trace_jsonl_has_every_request(tmp_path, tfc):
    path = tmp_path / "spans.jsonl"
    launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                   "--requests", "24", "--trace-jsonl", str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    roots = [r for r in recs if r["name"] == "request"]
    assert len(roots) == 24 and len({r["trace"] for r in roots}) == 24
    for r in roots:
        kids = {k["name"] for k in recs if k["parent"] == r["span"]}
        assert kids == {"queued", "compute"} and r["t1"] >= r["t0"]
    assert {r["name"] for r in recs} >= {"flush", "dispatch", "sync"}


def test_launcher_metrics_port_serves_and_renders(capsys, tfc):
    out = launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                         "--requests", "8", "--metrics-port", "0"])
    assert out["metrics_port"] > 0
    printed = capsys.readouterr().out
    assert "serve_requests_completed_total" in printed and "model=TFC-w2a2" in printed


# the multi-device flags are ported: --mesh over the one device named is
# the plain plan, --devices N shards each slot over N entries of it; the
# tune flags (A15) change neither
@pytest.mark.parametrize("flags,n_devices", [
    (["--mesh"], 1), (["--devices", "2"], 2),
    (["--mesh", "--tune", "cached"], 1),
    (["--devices", "2", "--tune-cache-dir", "x"], 2)])
def test_launcher_unported_flags_raise(tfc, flags, n_devices):
    x, ref = tfc
    out = launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                         "--requests", "20", *flags])
    np.testing.assert_array_equal(out["results"], ref[:20])
    assert out["plan_devices"] == n_devices


def test_launcher_graph_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only host's error")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--graph", "TFC-w2a2", "--requests", "1"])
