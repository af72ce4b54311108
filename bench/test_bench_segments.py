"""The per-class segment readers (``bench/segments.py`` and the four
``bench/metrics/*_segment_ms.py``) on the CPU: each on a registry that
holds its class and on one that lacks it, and end to end on the tiny
configuration, where the program's own timed calls fill the registry."""
import numpy as np
import pytest

from bench import harness, manifest, segments
from bench.test_bench_faults import TINY

CLASSES = ("gemm", "depthwise", "boundary", "interp")
KINDS = {"gemm": ("quant_conv", "quant_conv_int4", "quant_conv_grouped",
                  "quant_conv_grouped_int4", "quant_matmul",
                  "quant_matmul_int4"),
         "depthwise": ("quant_conv_dw",),
         "boundary": segments.BOUNDARY,
         "interp": ("interp",)}


class _Run:
    def __init__(self, name):
        self.cfg = {"name": name}


def _registry(model, classes):
    """A registry with two timed replays of ``model``: kind number i of
    each listed class reads i + 1 and i + 3 ms."""
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    for cls in classes:
        for i, kind in enumerate(KINDS[cls]):
            h = reg.histogram("plan_segment_device_ms",
                              labels={"model": model, "kind": kind})
            h.observe(i + 1.0)
            h.observe(i + 3.0)
    reg.histogram("plan_segment_device_ms",
                  labels={"model": "another", "kind": "interp"}).observe(9.0)
    return reg


def test_the_classes_partition_the_kinds():
    for cls, kinds in KINDS.items():
        assert {segments.segment_class(k) for k in kinds} == {cls}
    assert segments.segment_class("no_such_kind") is None


@pytest.mark.parametrize("cls", CLASSES)
def test_reader_on_a_registry_with_and_without_its_class(cls, monkeypatch):
    import repro_torch.obs as obs
    read = manifest.reader(f"{cls}_segment_ms.offline")
    held = _registry("m", CLASSES)
    n = len(KINDS[cls])
    want = sum(i + 2.0 for i in range(n))        # each kind's mean, summed
    monkeypatch.setattr(obs, "default_registry", lambda: held)
    assert read(_Run("m")) == pytest.approx(want)
    assert read(_Run("unknown")) is None
    lacking = _registry("m", [c for c in CLASSES if c != cls])
    monkeypatch.setattr(obs, "default_registry", lambda: lacking)
    assert read(_Run("m")) is None
    from repro_torch.obs import MetricsRegistry
    monkeypatch.setattr(obs, "default_registry", MetricsRegistry)
    assert read(_Run("m")) is None               # no family at all


def test_readers_on_the_programs_own_timed_calls():
    """The tiny configuration served on the CPU with the tracer on: every
    class it has reads, and the classes add up to the replay."""
    from repro_torch.obs import ListSink, Tracer, default_registry
    cfg = dict(TINY, name="bench_segments_tiny")
    params, pool = harness.draw(cfg, 2**31 + 11)
    engine = harness.serve(cfg, params, "cpu", Tracer(ListSink()))
    classes = {segments.segment_class(k) for k in engine.fused_counts}
    assert None not in classes and {"gemm", "depthwise", "boundary"} <= classes
    for _ in range(3):
        engine(pool[:6].numpy())
    run = _Run(cfg["name"])
    got = {cls: manifest.reader(f"{cls}_segment_ms.offline")(run)
           for cls in CLASSES}
    assert {c for c, v in got.items() if v is not None} == classes
    replay = default_registry().get("plan_replay_device_ms",
                                    {"model": cfg["name"]})
    assert replay.count == 3
    total = sum(v for v in got.values() if v is not None)
    assert total == pytest.approx(replay.sum / replay.count, rel=1e-6)
    assert np.isfinite(total) and total > 0
