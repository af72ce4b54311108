"""Mesh-sharded compiled plans and split-merge serving on the CPU: the
inner behaviours of tests/test_dist_serve.py (the reference's
multi-virtual-device suite) on an 8-entry ``cpu`` mesh, the port's
counterpart of XLA's forced host devices.

  * a plan over the mesh is bit-identical to the one-device plan on the
    integer-path zoo models (TFC-w1a1 / CNV-w1a1: every sum is exact), at
    16 rows and at the remainder batches 1, 5 and 13 (pad and slice);
  * the shard counters span all 8 entries, each shard signature traced
    once;
  * the device-pinned placement, the degenerate (1, 1) mesh, the
    constant-output fallback and its warning, mesh= with device=;
  * the float32-epilogue tier within the summation-order bound (a shard
    of other rows may reorder the float32 sums);
  * the split-merge wave over 8 pinned workers, and over two mesh-sharded
    workers, surviving an injected fault;
  * the launcher's ``--devices 4``, in process.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import execute, transforms  # noqa: E402
from repro_torch.core.compile import compile_graph  # noqa: E402
from repro_torch.core.graph import TensorInfo  # noqa: E402
from repro_torch.dist.fault import elastic_mesh  # noqa: E402
from repro_torch.launch.mesh import make_virtual_mesh  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

N_ENTRIES = 8


@pytest.fixture(scope="module")
def mesh():
    return make_virtual_mesh(N_ENTRIES, "cpu")


def _inputs(graph, batch, seed=0):
    rng = np.random.RandomState(seed)
    shape = (batch,) + tuple(graph.inputs[0].shape[1:])
    return {graph.input_names[0]: rng.randn(*shape).astype(np.float32)}


def _equal(ref: dict, out: dict, what: str) -> None:
    assert set(ref) == set(out)
    for k in ref:
        a, b = ref[k].numpy(), out[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=f"{what}/{k}")


_PLANS = {}


def _plans(model, mesh):
    if model not in _PLANS:
        _PLANS[model] = (compile_graph(zoo.ZOO[model](), device="cpu"),
                         compile_graph(zoo.ZOO[model](), mesh=mesh))
    return _PLANS[model]


@pytest.mark.parametrize("model", ["TFC-w1a1", "CNV-w1a1"])
def test_mesh_sharded_plan_bit_identical(model, mesh):
    base, sharded = _plans(model, mesh)
    assert sharded.n_devices == N_ENTRIES
    assert sharded.placement() == {"kind": "mesh", "devices": N_ENTRIES,
                                   "mesh": {"data": N_ENTRIES, "model": 1}}
    assert sharded.requant_stats()["coverage"] == 1.0       # the integer path
    x = _inputs(base.graph, 16)
    _equal(base(x), sharded(x), model)


@pytest.mark.parametrize("model", ["TFC-w1a1", "CNV-w1a1"])
@pytest.mark.parametrize("batch", [1, 5, 13])
def test_mesh_remainder_batches_exact(model, batch, mesh):
    """Batches the data degree does not divide are zero-padded, split and
    sliced back, and stay bit-exact with the one-device rows."""
    base, sharded = _plans(model, mesh)
    x = _inputs(base.graph, batch, seed=batch)
    _equal(base(x), sharded(x), f"{model} batch {batch}")


def test_mesh_shard_counters_span_every_entry(mesh):
    sharded = compile_graph(zoo.ZOO["TFC-w1a1"](), mesh=mesh)
    assert sharded.shard_devices == [torch.device("cpu")] * N_ENTRIES
    assert sharded.devices() == [torch.device("cpu")]
    g = sharded.graph
    for batch in (16, 16, 13):
        sharded(_inputs(g, batch))
    assert sharded.shard_counts == [3] * N_ENTRIES
    # 16 and 13 rows both give 2-row shards: one signature, traced once
    assert sharded.trace_count == 1
    sharded(_inputs(g, 64))                                 # 8-row shards
    assert sharded.trace_count == 2 and sharded.shard_counts == [4] * N_ENTRIES


def test_device_pinned_plan_matches():
    base = compile_graph(zoo.ZOO["TFC-w1a1"](), device="cpu")
    pinned = compile_graph(zoo.ZOO["TFC-w1a1"](), device=torch.device("cpu"))
    assert pinned.placement() == {"kind": "device", "devices": 1, "device": "cpu"}
    assert pinned.n_devices == 1 and pinned.shard_devices == []
    x = _inputs(base.graph, 8)
    _equal(base(x), pinned(x), "pinned")


def test_elastic_mesh_pure_data_parallel():
    m = elastic_mesh(prefer_model=1, device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    # a data degree of 1 takes the plain path
    plan = compile_graph(zoo.ZOO["TFC-w1a1"](), mesh=m)
    assert plan.n_devices == 1 and plan.placement()["kind"] == "device"
    base = compile_graph(zoo.ZOO["TFC-w1a1"](), device="cpu")
    x = _inputs(base.graph, 5)
    _equal(base(x), plan(x), "(1, 1) mesh")


def test_constant_output_falls_back_with_warning(mesh, caplog):
    g = zoo.ZOO["TFC-w1a1"]()
    const = next(iter(g.initializers))
    g.outputs.append(TensorInfo(const, tuple(np.shape(g.initializers[const]))))
    with caplog.at_level(logging.WARNING, logger="repro_torch.compile"):
        plan = compile_graph(g, mesh=mesh)
    assert any("constant graph outputs" in r.getMessage() for r in caplog.records)
    assert plan.n_devices == 1 and plan.placement()["kind"] == "device"
    out = plan(_inputs(plan.graph, 5))
    np.testing.assert_array_equal(out[const].numpy(), np.asarray(g.initializers[const]))


def test_mesh_and_device_are_exclusive(mesh):
    with pytest.raises(ValueError, match="mesh= / device="):
        compile_graph(zoo.ZOO["TFC-w1a1"](), mesh=mesh, device="cpu")
    from repro_torch.serve import CompiledGraphEngine
    with pytest.raises(ValueError, match="mesh= / device="):
        CompiledGraphEngine(zoo.ZOO["TFC-w1a1"](), mesh=mesh, device="cpu")


def test_float32_tier_within_the_order_bound(mesh):
    """The float32 epilogue tier (``use_analysis=False``) is held within the
    summation-order bound ``2·K·2^-24·(|x|@|w|)`` of its final MatMul (the
    graph's output), not bit for bit: its float32 body orders a row's sums
    by a split chosen from the tile count, which depends on M, so a shard
    of fewer rows may sum in another order (on the card; the CPU's twins
    may do the same through their BLAS)."""
    g = zoo.ZOO["TFC-w2a2"]()
    base = compile_graph(zoo.ZOO["TFC-w2a2"](), device="cpu", use_analysis=False)
    sharded = compile_graph(zoo.ZOO["TFC-w2a2"](), mesh=mesh, use_analysis=False)
    assert sharded.requant_stats()["int32_segments"] == 0
    x = _inputs(g, 13, seed=3)
    ref = base(x)[g.output_names[0]]
    got = sharded(x)[g.output_names[0]]
    clean = transforms.cleanup(g)
    node = [n for n in clean.toposort() if n.op_type == "MatMul"][-1]
    env = execute(clean, x, device="cpu", return_all=True)
    xf, wf = env[node.inputs[0]], env[node.inputs[1]]
    bound = 2 * xf.shape[-1] * 2.0 ** -24 * (xf.abs() @ wf.abs()) + 2.0 ** -23 * ref.abs()
    assert bool(((got - ref).abs() <= bound).all())


def _wave_oracle(n):
    rng = np.random.RandomState(0)
    xs = [rng.randn(784).astype(np.float32) for _ in range(n)]
    base = compile_graph(zoo.ZOO["TFC-w1a1"](), device="cpu")
    oracle = base({base.graph.input_names[0]: np.stack(xs)})[base.graph.output_names[0]]
    return xs, oracle.numpy()


@pytest.mark.parametrize("kind", ["pinned", "mesh"])
def test_splitmerge_wave_spans_all_devices_and_survives_fault(kind, mesh):
    """8 workers pinned to the mesh's entries, or two workers whose engines
    are sharded over 4-entry meshes: every worker takes a shard, the merge
    keeps submission order, and a worker dying mid-shard loses nothing."""
    from repro_torch import obs
    from repro_torch.serve import (CompiledGraphEngine, SplitMergeFront, Worker,
                                   device_workers)
    reg = obs.MetricsRegistry()
    if kind == "pinned":
        workers = device_workers(zoo.ZOO["TFC-w1a1"], devices=list(mesh.devices.flat),
                                 metrics_registry=reg, report_cost=False, max_batch=8)
    else:
        workers = [Worker(name=f"mesh{i}", engine=CompiledGraphEngine(
            zoo.ZOO["TFC-w1a1"](), mesh=make_virtual_mesh(4, "cpu"),
            metrics_registry=reg, metrics_labels={"worker": f"mesh{i}"},
            report_cost=False, max_batch=8)) for i in range(2)]
        assert all(w.engine.plan.n_devices == 4 for w in workers)
    n = len(workers)
    xs, oracle = _wave_oracle(37)
    with SplitMergeFront(workers, metrics_registry=reg) as front:
        out = front(xs)
        np.testing.assert_array_equal(out, oracle)        # deterministic merge
        disp = {s["labels"]["worker"]: s["value"]
                for s in reg.snapshot()["splitmerge_dispatch_total"]["series"]}
        assert len(disp) == n and all(v >= 1 for v in disp.values())
        victim = workers[n - 1]
        victim.inject_fault()
        out2 = front(xs)
        np.testing.assert_array_equal(out2, oracle)
        s = front.stats()
        assert s["failed"] == [victim.name] and s["redispatched_shards"] == 1
    if kind == "mesh":
        assert all(c >= 1 for w in workers for c in w.engine.plan.shard_counts)


def test_launcher_devices_serves_over_the_mesh():
    from repro_torch.launch import serve as launcher
    out = launcher.main(["--graph", "TFC-w1a1", "--devices", "4", "--device", "cpu",
                         "--requests", "20", "--max-batch", "8"])
    assert out["plan_devices"] == 4
    assert out["placement"] == {"kind": "mesh", "devices": 4,
                                "mesh": {"data": 4, "model": 1}}
    base = compile_graph(zoo.ZOO["TFC-w1a1"](), device="cpu")
    rng = np.random.default_rng(0)
    xs = np.stack([rng.standard_normal(784, dtype=np.float32) for _ in range(20)])
    ref = base({base.graph.input_names[0]: xs})[base.graph.output_names[0]]
    np.testing.assert_array_equal(out["results"], ref.numpy())
