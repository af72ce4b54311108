"""The compiled plan's timed replay on a GPU: the variant that times each
segment inside a CUDA-graph replay (``segment_timing``) gives the plain
replay's outputs bit for bit, a plan compiled without it holds one graph
a signature, and its replay time agrees with CUDA events around a plain
replay.  Every test skips without a CUDA device; the file imports neither
JAX nor the reference:

    PYTHONPATH=src python -m pytest -q tests/test_torch_segment_times_cuda.py
"""
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compile import compile_graph  # noqa: E402
from repro_torch.models.zoo import build_mobilenet  # noqa: E402
from repro_torch.obs import default_registry  # noqa: E402


@pytest.fixture
def cuda():
    """The GPU, or a skip: a CUDA graph is captured only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs are captured only there)")
    return torch.device("cuda")


def _plan(cuda, name, segment_timing):
    g = build_mobilenet(4, 4, img=224)
    g.name = name
    return compile_graph(g, device=cuda, segment_timing=segment_timing)


def _input(seed=3, rows=8):
    x = np.random.RandomState(seed).randn(rows, 3, 224, 224)
    return {"x": torch.from_numpy(x.astype(np.float32)).pin_memory()}


def test_timed_replay_equals_the_plain_replay_bit_for_bit(cuda):
    plan = _plan(cuda, "seg_cuda_bits", True)
    (y,) = plan.graph.output_names
    for seed in (3, 4):
        x = _input(seed)
        plain = plan(x)[y]
        timed = plan(x, timed=True)[y]
        torch.cuda.synchronize()
        assert torch.equal(plain, timed)
        rows = plan.record_segment_times()
        assert [r["kind"] for r in rows] == [s.kind for s in plan.segments]
        assert all(r["ms"] >= 0 for r in rows)
    assert plan.graph_count == 2 and plan.trace_count == 1
    assert plan.replay_count == 4


def test_a_plan_without_segment_timing_holds_one_graph_a_signature(cuda):
    plan = _plan(cuda, "seg_cuda_plain", False)
    (y,) = plan.graph.output_names
    x = _input()
    plain = plan(x)[y]
    timed = plan(x, timed=True)[y]       # nothing to time: the plain graph
    torch.cuda.synchronize()
    assert torch.equal(plain, timed)
    assert plan.record_segment_times() == []
    assert plan.graph_count == 1
    plan(_input(rows=4))                 # a second signature
    assert plan.graph_count == 2 and plan.trace_count == 2


def test_replay_device_ms_agrees_with_events_around_a_plain_replay(cuda):
    name = "seg_cuda_agree"
    plan = _plan(cuda, name, True)
    x = {"x": _input()["x"].to(cuda)}    # no host copy inside the events
    for _ in range(3):                   # capture, warm both graphs
        plan(x)
        plan(x, timed=True)
    torch.cuda.synchronize()
    plan.record_segment_times()
    plain, timed = [], []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        plan(x)
        b.record()
        b.synchronize()
        plain.append(a.elapsed_time(b))
        plan(x, timed=True)
        torch.cuda.synchronize()
        rows = plan.record_segment_times()
        timed.append(sum(r["ms"] for r in rows))
    hist = default_registry().get("plan_replay_device_ms", {"model": name})
    window = hist.snapshot().window[-20:]
    assert window == pytest.approx(timed, rel=1e-3)
    ratio = statistics.median(timed) / statistics.median(plain)
    assert 0.75 <= ratio <= 1.25, (statistics.median(timed),
                                   statistics.median(plain))
