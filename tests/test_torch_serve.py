"""The port's serving engine on the CPU: futures, padded slots, pipelined
dispatch equal to per-chunk dispatch, reload, telemetry and the options
that are not ported yet."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compile import compile_graph  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve import CompiledGraphEngine  # noqa: E402


def _x(n, seed=0):
    return np.random.RandomState(seed).randn(n, 784).astype(np.float32)


def _engine(**kw):
    kw.setdefault("max_batch", 8)
    return CompiledGraphEngine(zoo.build_tfc(2, 2), device="cpu", **kw)


def _plan_rows(x, w_bits=2, a_bits=2):
    g = zoo.build_tfc(w_bits, a_bits)
    plan = compile_graph(g, device="cpu")
    return plan({"x": x})[plan.graph.output_names[0]].numpy()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        eng = CompiledGraphEngine(zoo.build_tfc(1, 1))
        assert eng.plan.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CompiledGraphEngine(zoo.build_tfc(1, 1))


def test_futures_complete_in_padded_slots():
    eng = _engine()
    x = _x(13)
    reqs = [eng.submit(r) for r in x]
    assert eng.pending() == 13 and not reqs[0].done()
    assert eng.run_pending() == 13
    assert all(r.done() for r in reqs) and eng.pending() == 0
    got = np.stack([r.wait() for r in reqs])
    np.testing.assert_array_equal(got, _plan_rows(x))
    stats = eng.latency_stats()
    assert stats["completed"] == 13 and stats["flushes"] == 1
    assert stats["latency_p50_ms"] >= 0 and reqs[0].queued_ms >= 0
    assert reqs[0].x is None                 # the input is dropped
    snap = eng._m_occupancy.snapshot()
    assert snap.count == 2                   # 8 + 5 of 8: two slots


def test_only_full_slots_keeps_the_tail_queued():
    eng = _engine()
    for r in _x(11):
        eng.submit(r)
    assert eng.run_pending(only_full_slots=True) == 8
    assert eng.pending() == 3
    assert eng.run_pending() == 3 and eng.n_flushes == 2


@pytest.mark.parametrize("n", [0, 1, 8, 21])
def test_pipelined_equals_per_chunk(n):
    x = _x(n, seed=n)
    a = _engine(pipeline=True)(x)
    b = _engine(pipeline=False)(x)
    assert a.shape == (n, 10)
    np.testing.assert_array_equal(a, b)
    if n:
        np.testing.assert_array_equal(a, _plan_rows(x))


def test_call_accepts_one_unbatched_sample():
    eng = _engine()
    x = _x(1)
    np.testing.assert_array_equal(eng(x[0]), eng(x)[0])


def test_reload_drains_queued_requests_through_the_old_plan():
    eng = _engine()
    x = _x(5, seed=3)
    old = [eng.submit(r) for r in x]
    eng.reload(zoo.build_tfc(1, 1))
    assert all(r.done() for r in old)          # drained before the swap
    np.testing.assert_array_equal(np.stack([r.wait() for r in old]),
                                  _plan_rows(x, 2, 2))
    new = eng.submit(x[0])
    eng.run_pending()
    np.testing.assert_array_equal(new.wait(), _plan_rows(x[:1], 1, 1)[0])
    assert eng.fused_counts == {"quant_dequant": 1, "quant_matmul_int4": 4,
                                "interp": 3}


def test_deadlines_and_shapes():
    eng = _engine()
    r = eng.submit(_x(1), deadline_ms=0.0)     # pre-batched row accepted
    eng.run_pending()
    assert eng.latency_stats()["deadline_misses"] == 1 and r.done()
    with pytest.raises(ValueError, match="sample shape"):
        eng.submit(np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="sample shape"):
        eng(np.zeros((2, 5), np.float32))


def test_wait_times_out_and_concurrent_submits():
    eng = _engine()
    r = eng.submit(_x(1)[0])
    with pytest.raises(TimeoutError):
        r.wait(timeout=0.01)
    threads = [threading.Thread(target=lambda i=i: eng.submit(_x(1, i)[0]))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert eng.run_pending() == 7 and eng.n_completed == 7


def test_metric_names_match_the_reference():
    eng = _engine()
    eng.submit(_x(1)[0])
    eng.run_pending()
    names = set(eng.metrics.snapshot())
    assert {"serve_requests_submitted_total",
            "serve_requests_completed_total", "serve_flushes_total",
            "serve_request_latency_ms", "serve_request_queued_ms",
            "serve_queue_depth", "serve_slot_occupancy",
            "serve_deadline_misses_total"} <= names


@pytest.mark.parametrize("kw,item", [({"tracer": object()}, "A14")])
def test_unported_engine_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _engine(**kw)


def test_report_cost_logs_the_cost_at_load(caplog):
    """report_cost=True (the default) logs the analysis tier's cost of the
    served model at load, from the plan's own GraphAnalysis."""
    with caplog.at_level("INFO", logger="repro_torch.serve"):
        eng = _engine()
    rep = eng.cost_report
    assert rep is not None and len(rep.layers) == 4 and rep.macs == 59_008
    assert eng.plan.analysis is not None
    assert any("loaded TFC-w2a2" in r.getMessage() and
               "integer requant 4/4" in r.getMessage()
               for r in caplog.records)
    assert _engine(report_cost=False).cost_report is None


def test_serves_nchw_requests_of_a_conv_graph():
    """MobileNet-w4a4 at img 32: 4-D samples in padded slots, every row
    equal to the oracle's, and the conv-tier telemetry read through."""
    from repro_torch.core import execute, transforms
    g = zoo.build_mobilenet(4, 4, img=32)
    eng = CompiledGraphEngine(g, max_batch=4, device="cpu")
    assert eng.conv_segments_fused == 27
    assert eng.grouped_conv_stats["grouped_segments"] == 13
    x = np.random.RandomState(5).randn(6, 3, 32, 32).astype(np.float32)
    want = execute(transforms.cleanup(g), {"x": x}, device="cpu")[
        g.output_names[0]].numpy()
    reqs = [eng.submit(r) for r in x]
    assert eng.run_pending() == 6
    np.testing.assert_array_equal(np.stack([r.wait() for r in reqs]), want)
    np.testing.assert_array_equal(eng(x[:3]), want[:3])
