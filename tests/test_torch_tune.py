"""The port's launch-geometry autotuner (``repro_torch.tune``) on the CPU.

Three legs:

  * the behaviours of the reference's ``tests/test_tune.py``: bucketing,
    canonical keys, provenance, kernel and manifest round trips,
    invalidation by kernel version (the kernels' Python sources and the
    CUDA build's digest), corrupt and rejected entries read back as
    misses, the env-var root, concurrent writers, the graph hash,
    candidates within the card's shared memory and the built template
    instances, search (the heuristic always timed, the winner persisted),
    the compile modes (search then warm, off, cached on an empty cache, a
    bad mode), parity of tuned plans with the oracle, and the persistent
    cache latch;
  * parity with the reference: ``bucket_rows`` and ``graph_hash`` are the
    reference's, and on the zoo the port asks the tuner for the reference's
    signatures segment by segment (recorded by wrapping
    ``repro.tune.autotuner.Autotuner.blocks_for``), with equal
    ``tuning_stats()`` on all seven ``ZOO`` keys;
  * the plans and wrappers: each launch plan given its own heuristic
    blocks as ``override`` is the heuristic plan, illegal overrides raise,
    the wrappers' twins ignore ``blocks``, and a tuned plan on the CPU
    equals the untuned one; the engine and the launcher take ``--tune``.

On the CPU the twins ignore geometry, so a search keeps the heuristic:
these tests hold the plumbing; the search's timing is held on the card
(``chip_smoke.py`` phase 10, ``tests/test_torch_kernels_cuda.py``).
"""
import functools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import serialize as rser  # noqa: E402
from repro.core.compile import compile_graph as r_compile  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro.tune import autotuner as r_autotuner  # noqa: E402
from repro.tune import cache as r_cache  # noqa: E402
from repro.tune import bucket_rows as r_bucket_rows  # noqa: E402
from repro.tune import graph_hash as r_graph_hash  # noqa: E402
from repro_torch.core import compile_graph, execute  # noqa: E402
from repro_torch.core import serialize as tser  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_dequant as qd  # noqa: E402
from repro_torch.kernels import quant_grouped_conv as gc  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402
from repro_torch.tune import (Autotuner, BlockConfig, KernelSig,  # noqa: E402
                              TuneCache, bucket_rows, graph_cache_key,
                              graph_hash, kernel_version, roofline)
from repro_torch.tune import autotuner as t_autotuner  # noqa: E402
from repro_torch.tune import cache as t_cache  # noqa: E402
from test_tune import _mlp as r_mlp  # noqa: E402

SIG_FIELDS = ("family", "m", "n", "k", "groups", "bits", "requant")


def _port(g):
    return tser.graph_from_json(rser.graph_to_json(g))


def _mlp(**kw):
    """tests/test_tune.py's small tie-free MLP, handed over as JSON."""
    return _port(r_mlp(**kw))


def _cache(tmp_path):
    return TuneCache(str(tmp_path / "tune"), persist_executables=False)


def _tuner(tmp_path, **kw):
    return Autotuner(_cache(tmp_path), device="cpu", **kw)


def _out(plan, g, x):
    return plan({g.input_names[0]: x})[g.output_names[0]]


# ----------------------------------------------------------- key types

def test_bucket_rows_powers_of_two():
    assert bucket_rows(None) == 1
    assert bucket_rows(0) == 1
    assert bucket_rows(1) == 1
    assert bucket_rows(2) == 2
    assert bucket_rows(3) == 4
    assert bucket_rows(64) == 64
    assert bucket_rows(900) == 1024


def test_bucket_rows_is_the_reference():
    rows = [None, 0, *range(1, 4100), 12544, 100352, 2 ** 31 - 1]
    assert [bucket_rows(r) for r in rows] == [r_bucket_rows(r) for r in rows]


def test_kernel_sig_canonical_json_is_deterministic():
    a = KernelSig(family="matmul", m=64, n=32, k=16)
    b = KernelSig(family="matmul", m=64, n=32, k=16)
    assert a == b and a.canonical_json() == b.canonical_json()
    doc = json.loads(a.canonical_json())
    assert doc["family"] == "matmul" and doc["m"] == 64
    assert doc["body"] == "" and doc["geometry"] == []
    for other in (dict(bits=4), dict(body="imad"), dict(backend="cuda:H100"),
                  dict(geometry=(7, 7, 7, 7))):
        assert a.canonical_json() != KernelSig(
            family="matmul", m=64, n=32, k=16, **other).canonical_json()


def test_block_config_provenance():
    assert not BlockConfig(blocks=(0, 7, 3)).tuned
    assert BlockConfig(blocks=(1,), source="cached").tuned
    assert BlockConfig(blocks=(1,), source="search").tuned
    assert BlockConfig(blocks=(1, 2), source="cached").to_json() == \
        {"blocks": [1, 2], "source": "cached"}


def test_sig_names_the_device_and_interpret(tmp_path):
    sig = _tuner(tmp_path).sig("qdq", rows=900, n=16, k=0)
    assert (sig.m, sig.backend, sig.interpret) == (1024, "cpu", True)


# ----------------------------------------------------------- cache core

def test_kernel_entry_roundtrip(tmp_path):
    cache = _cache(tmp_path)
    sig = KernelSig(family="matmul", m=128, n=64, k=64)
    assert cache.lookup_kernel(sig) is None
    cache.store_kernel(sig, (1, 2, 2), best_ms=0.5, n_candidates=3)
    assert cache.lookup_kernel(sig) == BlockConfig(blocks=(1, 2, 2),
                                                   source="cached")
    assert cache.lookup_kernel(
        KernelSig(family="matmul", m=128, n=64, k=64, bits=4)) is None


def test_manifest_roundtrip(tmp_path):
    cache = _cache(tmp_path)
    sig = KernelSig(family="qdq", m=64, n=32, k=0)
    assert cache.load_manifest("g1") is None
    cache.store_manifest("g1", {sig.canonical_json(): (1, 8)})
    assert cache.load_manifest("g1") == {sig.canonical_json(): (1, 8)}


def test_kernel_version_change_invalidates_entries(tmp_path, monkeypatch):
    cache = _cache(tmp_path)
    sig = KernelSig(family="matmul", m=128, n=64, k=64)
    cache.store_kernel(sig, (1, 2, 2))
    assert cache.lookup_kernel(sig) is not None
    monkeypatch.setattr("repro_torch.tune.cache.kernel_version",
                        lambda: "edited-kernels")
    assert cache.lookup_kernel(sig) is None


@pytest.fixture
def fresh_kernel_version():
    t_cache.kernel_version.cache_clear()
    yield
    t_cache.kernel_version.cache_clear()


def test_cuda_source_edit_invalidates_entries(tmp_path, monkeypatch,
                                              fresh_kernel_version):
    """An edited csrc/*.cu changes ``_build._digest``, hence
    ``kernel_version`` and every entry's path."""
    from repro_torch.kernels import _build
    cache = _cache(tmp_path)
    sig = KernelSig(family="matmul", m=128, n=64, k=64)
    cache.store_kernel(sig, (1, 2, 2))
    before = kernel_version()
    monkeypatch.setattr(_build, "_digest", lambda: "edited-csrc")
    t_cache.kernel_version.cache_clear()
    assert kernel_version() != before
    assert cache.lookup_kernel(sig) is None


def test_corrupt_entries_recover_as_misses(tmp_path):
    cache = _cache(tmp_path)
    sig = KernelSig(family="matmul", m=128, n=64, k=64)
    cache.store_kernel(sig, (1, 2, 2))
    path = cache._kernel_path(sig)
    with open(path, "w") as f:
        f.write("{ not json")
    assert cache.lookup_kernel(sig) is None
    assert not os.path.exists(path)
    cache.store_kernel(sig, (1, 2, 2))
    assert cache.lookup_kernel(sig) is not None
    cache.store_manifest("g", {"k": (1, 2)})
    with open(cache._graph_path("g"), "w") as f:
        json.dump({"segments": "nope"}, f)
    assert cache.load_manifest("g") is None


def test_rejected_entries_are_misses_and_unlinked(tmp_path):
    """An entry that decodes but that the launch plan rejects (a tile the
    library has no instance of) is a miss, and its file goes."""
    tuner = _tuner(tmp_path)
    sig = tuner.sig("matmul", rows=64, n=64, k=64, bits=8, body="f32")
    tuner.cache.store_kernel(sig, (7, 1, 2))
    path = tuner.cache._kernel_path(sig)
    cfg = tuner.blocks_for(sig)
    assert cfg.source == "default" and cfg.blocks == tuner.heuristic(sig)
    assert not os.path.exists(path) and tuner.stats["misses"] == 1
    # a manifest entry the plan rejects falls through to the kernel entry
    tuner.cache.store_kernel(sig, (1, 1, 2))
    tuner._manifest[sig.canonical_json()] = (0, 9, 3)
    assert tuner.blocks_for(sig) == BlockConfig((1, 1, 2), "cached")


def test_env_var_overrides_default_root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE_DIR", str(tmp_path / "env-root"))
    assert TuneCache(persist_executables=False).root == str(tmp_path / "env-root")
    cache = TuneCache(str(tmp_path / "arg-root"), persist_executables=False)
    assert cache.root == str(tmp_path / "arg-root")


def test_concurrent_writers_last_wins_whole_file(tmp_path):
    """Two processes hammering the same entry never corrupt it."""
    prog = """
import sys
from repro_torch.tune import TuneCache, KernelSig
cache = TuneCache(sys.argv[1], persist_executables=False)
sig = KernelSig(family="matmul", m=128, n=64, k=64)
for _ in range(100):
    cache.store_kernel(sig, tuple(int(b) for b in sys.argv[2:]))
"""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    root = str(tmp_path / "tune")
    procs = [subprocess.Popen(
        [sys.executable, "-c", prog, root] + [str(b) for b in blocks],
        env=env) for blocks in [(1, 2, 2), (0, 7, 3)]]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = TuneCache(root, persist_executables=False).lookup_kernel(
        KernelSig(family="matmul", m=128, n=64, k=64))
    assert got is not None and got.blocks in ((1, 2, 2), (0, 7, 3))


# ----------------------------------------------------------- graph hashing

def test_graph_hash_invalidates_on_content_changes():
    base = graph_hash(_mlp())
    assert base == graph_hash(_mlp())
    assert base != graph_hash(_mlp(seed=1))
    assert base != graph_hash(_mlp(dims=(2, 12, 14, 6)))
    assert base != graph_hash(_mlp(w_bits=2))
    key = graph_cache_key(_mlp(), "cpu")
    assert key == graph_cache_key(_mlp(), "cpu")
    assert key != graph_cache_key(_mlp(), "cuda:NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("key", ["TFC-w2a2", "CNV-w1a1", "MobileNet-w4a4"])
def test_graph_hash_is_the_reference(key):
    g = rzoo.ZOO[key]()
    assert graph_hash(_port(g)) == r_graph_hash(g)
    assert graph_hash(_mlp()) == r_graph_hash(r_mlp())


# ----------------------------------------------------------- candidates

# signatures at the zoo's shapes, one per family and body
ZOO_SIGS = [
    dict(family="matmul", rows=256, n=64, k=784, bits=4, requant="int32",
         body="imad"),                                        # TFC
    dict(family="matmul", rows=1, n=10, k=64, bits=4, requant="fp32",
         body="f32"),
    dict(family="matmul", rows=12544, n=32, k=27, bits=8, requant="int32",
         body="imad"),                                        # the first conv
    dict(family="matmul", rows=196, n=1024, k=512, bits=4, requant="int32",
         body="int8_mma"),
    dict(family="grouped", rows=196, n=16, k=72, groups=4, bits=8,
         requant="int32"),
    dict(family="depthwise", rows=12544, n=32, k=9, requant="int32",
         geometry=(112, 112, 112, 112, 3, 3, 1, 1, 1, 1, 1, 1, 1, 1)),
    dict(family="depthwise", rows=49, n=1024, k=9, requant="int32",
         geometry=(7, 7, 7, 7, 3, 3, 1, 1, 1, 1, 1, 1, 1, 1)),
    dict(family="depthwise", rows=3136, n=64, k=9, requant="fp32",
         geometry=(112, 112, 56, 56, 3, 3, 2, 2, 1, 1, 1, 1, 1, 1)),
    dict(family="qdq", rows=672, n=224, k=0),
]


def _sig(tuner, d):
    d = dict(d)
    return tuner.sig(d.pop("family"), **d)


@pytest.mark.parametrize("i", range(len(ZOO_SIGS)))
def test_candidates_respect_smem_and_the_instances(tmp_path, i):
    tuner = _tuner(tmp_path)
    sig = _sig(tuner, ZOO_SIGS[i])
    cands = tuner.candidates(sig)
    assert 1 <= len(cands) <= tuner.max_candidates
    assert len(set(cands)) == len(cands)
    for c in cands:
        assert tuner.valid(sig, c)
        if sig.body == "int8_mma":
            assert c == qm.qmm_i8_blocks(sig.k) == (64, 64, 64)
            continue
        plan = tuner._plan(sig, c)
        assert roofline.feasible(getattr(plan, "smem", getattr(
            plan, "smem_bytes", 0)))
        if sig.family == "matmul":
            tile, split, stages = c
            assert tile in qm.QMM_TILES and 1 <= split <= qm.QMM_CLUSTER_MAX
            assert qm.qmm_min_stages(tile, sig.bits == 4, t_autotuner._epi(sig),
                                     sig.k, split) == stages <= qm.QMM_STAGES
        elif sig.family == "grouped":
            assert c[0] in gc.GQ_BNS and c[1] % 4 == 0 and c[1] <= gc.GQ_KS_MAX
        elif sig.family == "depthwise":
            assert c[2] in gc.DW_ROWS_PER_THREAD and plan.threads <= 256
        else:
            assert 1 <= c[0] <= qd.QDQ_UMAX and c[1] >= 1


def test_depthwise_candidates_are_the_plans_cheapest(tmp_path):
    tuner = _tuner(tmp_path, max_candidates=3)
    sig = _sig(tuner, ZOO_SIGS[5])
    ranked = gc.dw_block_candidates(1, 32, 112, 112, 112, 112, 3, 3,
                                    (1, 1), (1, 1), (1, 1, 1, 1))
    assert tuner.candidates(sig) == [b for _, b in ranked[:3]]
    assert [c for c, _ in ranked] == sorted(c for c, _ in ranked)


def test_pareto_prune_any_length():
    cands = ["a", "b", "c", "d"]
    cost = {"a": (1, 1, 0.5), "b": (1, 1, 0.1), "c": (2, 0, 0.9),
            "d": (2, 1, 0.9)}
    assert roofline.pareto_prune(cands, cost.get, 4) == ["b", "c"]
    assert roofline.pareto_prune(cands, cost.get, 1) == ["b"]
    # one block an SM (150 KB of shared memory), then two (100 KB)
    assert roofline.wave_idle(132, 256, 150_000) == 0.0
    assert roofline.wave_idle(133, 256, 150_000) == pytest.approx(1 - 1 / 132)
    assert roofline.wave_idle(16, 256, 100_000) == pytest.approx(1 - 16 / 264)


def test_roofline_holds_no_tpu_constant():
    for name in ("VMEM_BYTES", "ICI_BW", "PEAK_FLOPS"):
        assert not hasattr(roofline, name)
    assert roofline.HBM_BW == 3.35e12 and roofline.SMS == 132
    assert roofline.PEAK_OPS == {"float32": 67e12, "bf16": 989e12,
                                 "int8": 1979e12}
    assert roofline.SMEM_MAX == 232_448


# ----------------------------------------------------------- search

def test_search_times_default_and_persists(tmp_path):
    tuner = _tuner(tmp_path, mode="search", repeats=1)
    sig = tuner.sig("qdq", rows=8, n=16, k=0)
    cfg = tuner.blocks_for(sig)
    assert cfg.source == "search" and tuner.stats["searched"] == 1
    # on the CPU the twins ignore geometry: the heuristic is kept
    assert cfg.blocks == tuner.heuristic(sig) == qd.qdq_blocks(
        qd.qdq_launch_plan(8 * 16, 16, False))
    (rec,) = tuner.searches
    assert rec["default"] == cfg.blocks and rec["candidates"] >= 1
    assert rec["ms"] >= 0 and rec["default_ms"] >= 0
    warm = _tuner(tmp_path)
    got = warm.blocks_for(warm.sig("qdq", rows=8, n=16, k=0))
    assert got.source == "cached" and got.blocks == cfg.blocks
    assert warm.stats == {"graph_hit": 0, "graph_miss": 0, "hits": 1,
                          "misses": 0, "searched": 0}


def test_search_times_the_heuristic_and_every_candidate(tmp_path,
                                                        monkeypatch):
    tuner = _tuner(tmp_path, mode="search", repeats=1)
    sig = _sig(tuner, ZOO_SIGS[0])
    timed = []
    real = tuner._time_candidates

    def spy(s, cands):
        timed.extend(cands)
        return real(s, cands)
    monkeypatch.setattr(tuner, "_time_candidates", spy)
    tuner.blocks_for(sig)
    assert timed[0] == tuner.heuristic(sig)
    assert set(tuner.candidates(sig)) <= set(timed)


def test_a_candidate_that_fails_to_launch_raises(tmp_path, monkeypatch):
    """No silent fallback: a candidate the plan accepted and that then
    fails is a fault, named with its signature and blocks."""
    tuner = _tuner(tmp_path, mode="search", repeats=1)
    sig = _sig(tuner, ZOO_SIGS[0])
    real = tuner._make_fn
    bad = tuner.candidates(sig)[0]

    def make(s, blocks):
        if tuple(blocks) == bad:
            def boom():
                raise RuntimeError("qmm_launch: CUDA error 1 at launch")
            return boom
        return real(s, blocks)
    monkeypatch.setattr(tuner, "_make_fn", make)
    with pytest.raises(RuntimeError, match=r"blocks \(") as e:
        tuner.blocks_for(sig)
    assert "matmul" in str(e.value)


def test_cached_mode_empty_cache_gives_the_heuristic(tmp_path):
    tuner = _tuner(tmp_path)
    sig = tuner.sig("matmul", rows=256, n=64, k=784, bits=4, requant="int32",
                    body="imad")
    cfg = tuner.blocks_for(sig)
    assert cfg.source == "default"
    assert cfg.blocks == qm.qmm_blocks(qm.qmm_launch_plan(256, 784, 64, True, 2))
    assert tuner.stats["misses"] == 1 and tuner.stats["searched"] == 0


def test_bad_tune_mode_rejected(tmp_path):
    with pytest.raises(ValueError):
        Autotuner(_cache(tmp_path), mode="aggressive", device="cpu")
    with pytest.raises(ValueError):
        compile_graph(_mlp(), tune="aggressive", device="cpu",
                      tune_cache_dir=str(tmp_path / "t"))


# ----------------------------------------------------------- compile modes

def test_compile_search_then_cached_warm(tmp_path):
    root = str(tmp_path / "tune")
    plan = compile_graph(_mlp(), tune="search", tune_cache_dir=root,
                         tune_repeats=1, device="cpu")
    st = plan.tuning_stats()
    assert st["mode"] == "search" and st["kernel_segments"] >= 1
    assert st["tuned_segments"] == st["kernel_segments"]
    assert st["graph_miss"] == 1
    assert st["searched"] + st["hits"] >= st["kernel_segments"]
    assert len(plan.tune_log) == st["searched"]
    for s in plan.segments:
        if "blocks" in s.meta:
            assert s.meta["tuned"] in ("cached", "search")
            assert all(isinstance(b, int) for b in s.meta["blocks"])
    warm = compile_graph(_mlp(), tune="cached", tune_cache_dir=root,
                         device="cpu")
    wst = warm.tuning_stats()
    assert wst["mode"] == "cached" and wst["graph_hit"] == 1
    assert wst["searched"] == 0 and wst["misses"] == 0
    assert wst["tuned_segments"] == wst["kernel_segments"] \
        == st["kernel_segments"]
    assert [s.meta.get("blocks") for s in warm.segments] == \
        [s.meta.get("blocks") for s in plan.segments]


def test_compile_tune_off_stamps_nothing():
    plan = compile_graph(_mlp(), tune="off", device="cpu")
    assert plan.tuning_stats() == {"mode": "off", "kernel_segments": 0,
                                   "tuned_segments": 0, "default_segments": 0}
    assert all("blocks" not in s.meta for s in plan.segments)


def test_compile_cached_empty_cache_uses_defaults(tmp_path):
    plan = compile_graph(_mlp(), tune="cached", device="cpu",
                         tune_cache_dir=str(tmp_path / "empty"))
    st = plan.tuning_stats()
    assert st["kernel_segments"] >= 1 and st["tuned_segments"] == 0
    assert st["default_segments"] == st["misses"] == st["kernel_segments"]


def test_compile_tune_metrics(tmp_path):
    from repro_torch.obs.metrics import default_registry
    g = _mlp(seed=7)
    compile_graph(g, tune="cached", device="cpu",
                  tune_cache_dir=str(tmp_path / "empty"))
    snap = json.dumps(default_registry().snapshot())
    assert "tune_cache_misses_total" in snap and "compile_tuned_segments" in snap


def test_tuned_plan_exact_vs_oracle(tmp_path):
    g = _mlp()
    x = np.random.RandomState(3).randn(2, 12).astype(np.float32)
    ref = execute(g, {"x": x}, device="cpu")[g.output_names[0]]
    plan = compile_graph(g, tune="search", tune_repeats=1, device="cpu",
                         tune_cache_dir=str(tmp_path / "tune"))
    torch.testing.assert_close(_out(plan, g, x), ref, rtol=0, atol=1e-5)


def test_tuned_zoo_plan_matches_oracle_and_traces_once(tmp_path):
    """TFC-w1a1 end to end: search, warm cached, then the oracle's bits and
    one trace; the tuned plan equals the untuned one."""
    root = str(tmp_path / "tune")
    g = _port(rzoo.ZOO["TFC-w1a1"]())
    compile_graph(g, tune="search", tune_cache_dir=root, tune_repeats=1,
                  device="cpu")
    plan = compile_graph(g, tune="cached", tune_cache_dir=root, device="cpu")
    st = plan.tuning_stats()
    assert st["graph_hit"] == 1 and st["searched"] == 0
    assert st["tuned_segments"] == st["kernel_segments"] == 5
    x = np.random.RandomState(0).randn(4, 784).astype(np.float32)
    from repro_torch.core.passes import run_pipeline
    gc_ = run_pipeline(g, "compile_prep")
    ref = execute(gc_, {gc_.input_names[0]: x}, device="cpu")[
        gc_.output_names[0]]
    out = _out(plan, g, x)
    assert torch.equal(out, ref)
    assert torch.equal(_out(plan, g, x), out) and plan.trace_count == 1
    assert torch.equal(out, _out(compile_graph(g, device="cpu"), g, x))


# ----------------------------------------------------------- vs the reference

@functools.lru_cache(maxsize=None)
def _reference(key):
    """The reference's tuning_stats and per-segment signatures of one zoo
    key, compiled with tune="cached" on an empty cache."""
    sigs = []
    orig = r_autotuner.Autotuner.blocks_for

    def rec(self, sig):
        sigs.append(tuple(getattr(sig, f) for f in SIG_FIELDS))
        return orig(self, sig)
    mp = pytest.MonkeyPatch()
    mp.setattr(r_autotuner.Autotuner, "blocks_for", rec)
    # the reference's TuneCache would point JAX's persistent compilation
    # cache at the temporary root for the rest of the process
    mp.setattr(r_cache, "configure_jax_persistent_cache", lambda *a: None)
    try:
        with tempfile.TemporaryDirectory() as root:
            st = r_compile(rzoo.ZOO[key](), tune="cached",
                           tune_cache_dir=root).tuning_stats()
    finally:
        mp.undo()
    return st, sigs


@functools.lru_cache(maxsize=None)
def _port_tuned(key):
    """The port's plan and per-segment signatures of one zoo key (handed
    over as JSON), compiled with tune="cached" on an empty cache."""
    sigs = []
    orig = t_autotuner.Autotuner.blocks_for

    def rec(self, sig):
        sigs.append(sig)
        return orig(self, sig)
    mp = pytest.MonkeyPatch()
    mp.setattr(t_autotuner.Autotuner, "blocks_for", rec)
    try:
        with tempfile.TemporaryDirectory() as root:
            plan = compile_graph(_port(rzoo.ZOO[key]()), tune="cached",
                                 device="cpu", tune_cache_dir=root)
    finally:
        mp.undo()
    return plan, sigs


@pytest.mark.parametrize("key", list(rzoo.ZOO))
def test_tuning_stats_equal_the_references(key):
    plan, _ = _port_tuned(key)
    want = {"TFC-w1a1": 5, "TFC-w1a2": 8, "TFC-w2a2": 8, "CNV-w1a1": 10,
            "CNV-w1a2": 12, "CNV-w2a2": 12, "MobileNet-w4a4": 29}[key]
    st = plan.tuning_stats()
    assert st == _reference(key)[0]
    assert st["kernel_segments"] == st["misses"] == want
    assert st["graph_miss"] == 1


@pytest.mark.parametrize("key", ["TFC-w2a2", "CNV-w1a1", "MobileNet-w4a4"])
def test_signatures_equal_the_references(key):
    _, sigs = _port_tuned(key)
    assert [tuple(getattr(s, f) for f in SIG_FIELDS) for s in sigs] == \
        _reference(key)[1]
    for s in sigs:
        assert s.body == ("" if s.family != "matmul" else s.body)
        assert bool(s.geometry) == (s.family == "depthwise")
    if key == "MobileNet-w4a4":
        assert len(set(sigs)) == 21
        assert sigs[0].family == "qdq" and (sigs[0].m, sigs[0].n) == (1024, 224)
        bodies = {s.body for s in sigs if s.family == "matmul"}
        assert bodies == {"imad", "int8_mma", "f32"}


# ----------------------------------------------------------- plans

def _zoo_sigs():
    sigs = set()
    for key in ("TFC-w2a2", "CNV-w1a1", "MobileNet-w4a4"):
        sigs |= set(_port_tuned(key)[1])
    return sorted(sigs, key=lambda s: s.canonical_json())


def test_plans_take_their_own_blocks_at_the_zoo_shapes(tmp_path):
    tuner = _tuner(tmp_path)
    for sig in _zoo_sigs():
        blocks = tuner.heuristic(sig)
        assert blocks, sig
        if sig.body == "int8_mma":
            continue
        assert tuner._plan(sig, blocks) == tuner._plan(sig), sig


@pytest.mark.parametrize("m,k,n,packed,epi", [
    (1, 784, 64, True, 0), (256, 784, 64, True, 2), (64, 64, 10, True, 1),
    (12544, 27, 32, False, 2), (8500, 28, 31, False, 0), (16, 576, 33, False, 0),
    (4300, 98, 65, True, 2), (0, 0, 5, False, 0)])
def test_qmm_plan_override_roundtrip(m, k, n, packed, epi):
    plan = qm.qmm_launch_plan(m, k, n, packed, epi)
    again = qm.qmm_launch_plan(m, k, n, packed, epi,
                               override=qm.qmm_blocks(plan))
    assert again == plan
    for x_vec in (False, True):      # the alignment modes stay per call
        assert qm.qmm_launch_plan(m, k, n, packed, epi, x_vec, False, False,
                                  override=qm.qmm_blocks(plan)) == \
            qm.qmm_launch_plan(m, k, n, packed, epi, x_vec, False, False)


def test_other_plans_override_roundtrip():
    for args in [(100_352, 224, False), (1_000_000, 1000, True, 1, 1),
                 (5, 5, False)]:
        plan = qd.qdq_launch_plan(*args)
        assert qd.qdq_launch_plan(*args, override=qd.qdq_blocks(plan)) == plan
    for args in [(4, 196, 72, 16), (2, 13, 10, 5), (8, 1000, 300, 40)]:
        plan = gc.gqmm_launch_plan(*args)
        assert gc.gqmm_launch_plan(*args, override=gc.gqmm_blocks(plan)) == plan
    for args in [(8, 32, 112, 112, 112, 112, 3, 3, (1, 1), (1, 1), (1, 1, 1, 1)),
                 (8, 1024, 7, 7, 7, 7, 3, 3, (1, 1), (1, 1), (1, 1, 1, 1)),
                 (1, 64, 112, 112, 56, 56, 3, 3, (2, 2), (1, 1), (1, 1, 1, 1)),
                 (2, 5, 30, 40, 26, 36, 5, 5, (1, 1), (1, 1), (0, 0, 0, 0))]:
        plan = gc.dw_launch_plan(*args)
        assert gc.dw_launch_plan(*args, override=gc.dw_blocks(plan)) == plan


def test_dw_override_is_legal_at_every_batch():
    """An override found at one batch runs at any other: flat planes per
    block beyond N·C are clamped by the kernel, never refused."""
    shape = (1024, 7, 7, 7, 7, 3, 3, (1, 1), (1, 1), (1, 1, 1, 1))
    for _, blocks in gc.dw_block_candidates(1, *shape):
        for n in (1, 3, 8, 64):
            plan = gc.dw_launch_plan(n, *shape, override=blocks)
            assert gc.dw_blocks(plan) == blocks and plan.threads <= 256


@pytest.mark.parametrize("fn,args,override", [
    (qm.qmm_launch_plan, (64, 64, 64, False, 0), (3, 1, 2)),     # no tile 3
    (qm.qmm_launch_plan, (64, 576, 64, False, 0), (0, 9, 3)),    # cluster of 9
    (qm.qmm_launch_plan, (64, 64, 64, False, 0), (0, 3, 1)),     # beyond 2 steps
    (qm.qmm_launch_plan, (64, 784, 64, False, 0), (0, 7, 2)),    # too few stages
    (qm.qmm_launch_plan, (64, 784, 64, False, 0), (0, 1, 4)),    # too many
    (qm.qmm_launch_plan, (64, 64, 64, False, 0), (1, 2, 1)),     # partials
    (qd.qdq_launch_plan, (1000, 10, False), (5, 100)),
    (qd.qdq_launch_plan, (1000, 10, False), (2, 0)),
    (gc.gqmm_launch_plan, (2, 13, 10, 5), (12, 4)),
    (gc.gqmm_launch_plan, (2, 13, 10, 5), (8, 6)),
    (gc.gqmm_launch_plan, (2, 13, 10, 5), (8, 16)),              # beyond Kg
    (gc.dw_launch_plan, (1, 8, 7, 7, 7, 7, 3, 3), (0, 8, 4, 1)), # flat shape
    (gc.dw_launch_plan, (1, 8, 7, 7, 7, 7, 3, 3), (1, 1, 5, 1)), # no R of 5
])
def test_illegal_overrides_raise(fn, args, override):
    with pytest.raises(ValueError):
        fn(*args, override=override)


def test_int8_body_has_one_point():
    x = torch.zeros(4, 64)
    w = torch.zeros(32, 8, dtype=torch.int8)
    kw = dict(acc_dtype=torch.int32, int8_codes=True)
    # the twin ignores blocks on the CPU
    assert torch.equal(ops.quant_matmul_int4(x, w, 1.0, blocks=(1, 2), **kw),
                       ops.quant_matmul_int4(x, w, 1.0, **kw))
    assert qm.qmm_i8_blocks(27) == (64, 64, 32)
    assert qm.qmm_i8_blocks(512) == (64, 64, 64)


def test_twins_ignore_blocks():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(9, 64).astype(np.float32))
    w = torch.from_numpy(rng.randint(-7, 8, (64, 5)).astype(np.int8))
    assert torch.equal(ops.quant_matmul(x, w, 0.5, blocks=(2, 1, 2)),
                       ops.quant_matmul(x, w, 0.5))
    assert torch.equal(ops.quant_dequant(x, 0.1, 0.0, blocks=(4, 3)),
                       ops.quant_dequant(x, 0.1, 0.0))
    xg = x[:, :60].reshape(9, 3, 20).permute(1, 0, 2)
    wg = torch.from_numpy(rng.randint(-7, 8, (3, 20, 4)).astype(np.int8))
    assert torch.equal(ops.quant_grouped_matmul(xg, wg, 1.0, blocks=(8, 8)),
                       ops.quant_grouped_matmul(xg, wg, 1.0))
    xd = torch.from_numpy(rng.randn(1, 5, 9, 9).astype(np.float32))
    taps = torch.from_numpy(rng.randint(-7, 8, (9, 5)).astype(np.int8))
    kw = dict(kernel_shape=(3, 3), pads=(1, 1, 1, 1))
    assert torch.equal(ops.quant_depthwise_conv2d(xd, taps, 1.0, blocks=(1, 1, 4, 3), **kw),
                       ops.quant_depthwise_conv2d(xd, taps, 1.0, **kw))


def test_tuned_plan_equals_untuned_on_the_cpu(tmp_path):
    g = _port(rzoo.ZOO["CNV-w1a1"]())
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    tuned = compile_graph(g, tune="search", tune_repeats=1, device="cpu",
                          tune_cache_dir=str(tmp_path / "tune"))
    assert tuned.tuning_stats()["tuned_segments"] == 10
    assert torch.equal(_out(tuned, g, x),
                       _out(compile_graph(g, device="cpu"), g, x))


def test_blocks_apply_in_the_bucket_they_were_tuned_at():
    """A tuned geometry reaches the kernel only at calls whose rows fall in
    the bucket it was measured at; elsewhere, and untuned, the heuristic
    plan runs at the call's own shape."""
    from repro_torch.core.lowering.base import blocks_at
    x1, x2, x3 = torch.zeros(1, 3), torch.zeros(2, 3), torch.zeros(3, 3)
    at = blocks_at(BlockConfig((1, 2, 3), "cached"), 49, 1)
    assert at(x1) == (1, 2, 3) and at(x2) is None
    at = blocks_at(BlockConfig((1, 2, 3), "search"), 3 * 40, 3)
    assert at(x3) == (1, 2, 3) and at(x2) == (1, 2, 3) and at(x1) is None
    assert blocks_at(BlockConfig((1, 2, 3)), 49, 1)(x1) is None
    assert blocks_at(None, 49, 1)(x1) is None
    assert blocks_at(BlockConfig((1,), "cached"), None, 1)(x1) is None


def test_tuned_segments_pass_their_blocks_per_call(tmp_path, monkeypatch):
    """TFC-w2a2 declared at 8 rows and tuned: its matmuls and QDQs get the
    tuned blocks at 5-8 rows (the bucket of 8), the heuristic (None) at 64."""
    from repro_torch.models import zoo
    seen = []
    for name in ("quant_matmul_int4", "quant_dequant"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append((_name, a[0].shape[0], k.get("blocks")))
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    g = zoo.build_tfc(2, 2, batch=8)
    plan = compile_graph(g, tune="search", tune_repeats=1, device="cpu",
                         tune_cache_dir=str(tmp_path / "tune"))
    assert plan.tuning_stats()["tuned_segments"] == 8
    rng = np.random.RandomState(0)
    for rows in (8, 5, 64):
        seen.clear()
        _out(plan, g, rng.randn(rows, 784).astype(np.float32))
        assert len(seen) == 8
        for name, m, blocks in seen:
            assert m == rows
            assert (blocks is not None) == (rows <= 8), (name, rows, blocks)


# ----------------------------------------------------------- serving

def test_engine_serves_from_the_cache(tmp_path):
    from repro_torch.serve import CompiledGraphEngine
    root = str(tmp_path / "tune")
    g = _port(rzoo.ZOO["TFC-w2a2"]())
    compile_graph(g, tune="search", tune_cache_dir=root, tune_repeats=1,
                  device="cpu")
    eng = CompiledGraphEngine(g, max_batch=4, device="cpu", tune="cached",
                              tune_cache_dir=root, report_cost=False)
    st = eng.plan.tuning_stats()
    assert st["graph_hit"] == 1 and st["hits"] == st["kernel_segments"] == 8
    snap = json.dumps(eng.metrics.snapshot())
    assert "serve_tune_cache_hits_total" in snap
    xs = np.random.RandomState(0).randn(6, 784).astype(np.float32)
    rows = [eng(x) for x in xs]
    want = _out(compile_graph(g, device="cpu"), g, xs)
    assert torch.equal(torch.stack([torch.as_tensor(r) for r in rows]), want)


def test_launcher_tune_cached(tmp_path):
    from repro_torch.launch import serve as launcher
    root = str(tmp_path / "tune")
    out = launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                         "--requests", "4", "--tune", "search",
                         "--tune-cache-dir", root])
    assert out["tuning"]["mode"] == "search" and out["tuning"]["searched"] >= 1
    out = launcher.main(["--graph", "TFC-w2a2", "--device", "cpu",
                         "--requests", "4", "--tune", "cached",
                         "--tune-cache-dir", root])
    st = out["tuning"]
    assert st["graph_hit"] == 1 and st["searched"] == st["misses"] == 0
    assert st["tuned_segments"] == st["kernel_segments"] == 8
    assert out["results"].shape[0] == 4


# ----------------------------------------------------------- harness bits

def test_time_fns_harness():
    from repro_torch.obs.profile import time_fns, time_fns_graphed
    ts = time_fns([lambda: None, lambda: None], 2)
    assert len(ts) == 2 and all(t >= 0.0 for t in ts)
    with pytest.raises(ValueError, match="CUDA"):
        time_fns_graphed([lambda: None], 1, device="cpu")


def test_kernel_version_is_stable_hex():
    v = kernel_version()
    assert v == kernel_version() and len(v) == 64 and int(v, 16) >= 0


def test_configure_persistent_cache_is_latched():
    from repro_torch.kernels import _build
    from repro_torch.tune import configure_persistent_cache
    first = configure_persistent_cache()
    assert first == configure_persistent_cache() == str(_build.build_dir())
