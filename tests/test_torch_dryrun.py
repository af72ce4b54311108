"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's, on the CPU.

  * ``models.api.input_specs`` gives the reference's shapes and dtypes for
    all 40 (arch, shape) pairs (the decode cache per layer, the
    reference's stacked on a leading axis), and the 32 / 8 matrix;
  * ``arch_config`` and ``_layers_reduced`` equal the reference's;
  * the trace's accounting on a column- then row-parallel MLP over a fake
    (16, 16) group: one all-reduce of the local result's bytes, and
    per-chip FLOPs 2·2·(B/16)·S·D·(F/16);
  * the trace's shortcuts are exact: rwkv6's time loop on meta shards
    against a step-by-step trace, and the depth extrapolation against a
    direct trace of three units, for every family;
  * ``run_cell`` is ``ok`` for every family's SMOKE config in the train,
    prefill and decode kinds (and long_500k where it runs) over a fake
    (2, 2) group, and in one kind each over a (2, 2, 2) group (which the
    trace flattens to a 2-d mesh: the depth test above traces every
    family's prefill there), in worker processes, and for one full-size
    cell (qwen2-1.5b decode_32k on the 256-rank mesh);
  * the roofline mode re-anchors on direct traces of 2 and 3 units where
    the 2-unit figure falls below the 1-unit one, as the reference does;
  * no process group outlives a cell.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import api as r_api  # noqa: E402

from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.models import api  # noqa: E402

FAMILY_ARCHS = ("qwen2_1_5b", "llava_next_34b", "deepseek_moe_16b", "whisper_base",
                "rwkv6_7b", "recurrentgemma_2b")
# each family's one kind on the (2, 2, 2) group, every kind twice
MULTI_POD_SHAPES = {"qwen2_1_5b": "decode_32k", "llava_next_34b": "train_4k",
                    "deepseek_moe_16b": "prefill_32k", "whisper_base": "prefill_32k",
                    "rwkv6_7b": "train_4k", "recurrentgemma_2b": "decode_32k"}


@pytest.fixture(scope="module")
def ref_dr():
    """The reference's dry-run module, its 512-device XLA flag undone
    (JAX is initialised already in this process)."""
    import importlib
    old = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def _shape_dtype(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _stacked(port_cache):
    """The port's per-layer cache as the reference lays it out: a dict of
    leaves stacked on a leading layer axis, or (the hybrid) a tuple of
    per-layer dicts."""
    if isinstance(port_cache, list) and all(set(c) == set(port_cache[0]) for c in port_cache):
        return {k: ((len(port_cache),) + tuple(port_cache[0][k].shape),
                    str(port_cache[0][k].dtype).replace("torch.", ""))
                for k in port_cache[0]}
    return None


@pytest.mark.parametrize("arch", all_archs())
def test_input_specs_equal_the_references(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    for shape in api.SHAPES:
        got, want = api.input_specs(cfg, shape), r_api.input_specs(rcfg, shape)
        assert set(got) == set(want), shape
        kind = api.SHAPES[shape]["kind"]
        if kind in ("train", "prefill"):
            assert set(got["batch"]) == set(want["batch"]), shape
            for k, v in got["batch"].items():
                assert v.device.type == "meta"
                assert _shape_dtype(v) == (tuple(want["batch"][k].shape),
                                           str(want["batch"][k].dtype)), (shape, k)
            if kind == "prefill":
                assert got["cache_len"] == want["cache_len"]
            continue
        assert _shape_dtype(got["tokens"]) == (tuple(want["tokens"].shape),
                                               str(want["tokens"].dtype))
        assert _shape_dtype(got["cache_index"]) == ((), "int32")
        stacked = _stacked(got["cache"])
        wc = want["cache"]
        if isinstance(wc, dict) and cfg.family != "hybrid":
            assert stacked == {k: (tuple(v.shape), str(v.dtype)) for k, v in wc.items()}
        else:                                   # the hybrid: one dict per layer
            assert len(got["cache"]) == len(wc)
            for g, w in zip(got["cache"], wc):
                assert {k: _shape_dtype(v) for k, v in g.items()} == \
                    {k: (tuple(v.shape), str(v.dtype)) for k, v in w.items()}
    vlm = api.input_specs(get_config("llava_next_34b"), "prefill_32k")
    assert vlm["cache_len"] == 32768 + get_config("llava_next_34b").n_patches


def test_shape_applicability_matrix():
    runs = skips = 0
    for arch in all_archs():
        for shape in api.SHAPES:
            ok = api.shape_applicable(get_config(arch), shape) is None
            assert ok == (r_api.shape_applicable(r_get_config(arch), shape) is None)
            runs += ok
            skips += not ok
    assert (runs, skips) == (32, 8)


def test_arch_config_and_layers_reduced_equal_the_references(ref_dr):
    for arch, shape, quant, kw in (("qwen2_1_5b", "train_4k", "w8a8", {}),
                                   ("qwen2_1_5b", "decode_32k", "w8a8", {}),
                                   ("qwen2_1_5b", "train_4k", "fp", {}),
                                   ("rwkv6_7b", "long_500k", "w8a8", {}),
                                   ("qwen2_1_5b", "train_4k", "w8a8",
                                    {"roofline": True, "shard_acts": True})):
        got, want = dr.arch_config(arch, shape, quant, **kw), ref_dr.arch_config(
            arch, shape, quant, **kw)
        assert (got.remat, got.quant.enabled, got.quant.kv_cache_bits, got.scan_unroll,
                got.shard_activations) == (want.remat, want.quant.enabled,
                                           want.quant.kv_cache_bits, want.scan_unroll,
                                           want.shard_activations)
    for arch, n in (("qwen2_1_5b", 2), ("recurrentgemma_2b", 1), ("whisper_base", 2)):
        (cfg, units, tail), (rcfg, r_units, r_tail) = (
            dr._layers_reduced(get_config(arch), n), ref_dr._layers_reduced(r_get_config(arch), n))
        assert (cfg.n_layers, cfg.n_enc_layers, units) == (rcfg.n_layers, rcfg.n_enc_layers,
                                                           r_units)
        assert tail == pytest.approx(r_tail)
    assert dr.COLLECTIVE_OPS == ref_dr.COLLECTIVE_OPS


def _mlp_trace(B=32, S=8, D=64, F=128):
    """A column- then row-parallel MLP on meta DTensors over a fake (16, 16)
    group, traced: (trace, local result bytes, B, S, D, F)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist import sharding as tsh
    from repro_torch.quantize.layers import qlinear
    mesh = dr.meta_mesh(False)
    with dr.fake_group(256):
        dm = mesh.device_mesh("cpu")

        def mk(shape, pl):
            sh = tsh.Sharding(dm, tuple(pl), None)
            return tsh.placed(torch.empty(tsh.local_shape(shape, sh), device="meta"), sh, shape)
        x = mk((B, S, D), [Shard(0), Replicate()])
        w1 = mk((D, F), [Replicate(), Shard(1)])
        w2 = mk((F, D), [Replicate(), Shard(0)])
        trace = dr.CellTrace()
        with trace:
            y = qlinear(torch.relu(qlinear(x, w1)), w2)
        assert tuple(y.placements) == (Shard(0), Replicate())
    assert not dist.is_initialized()
    return trace, (B // 16) * S * D * 4, B, S, D, F


def test_collectives_and_flops_of_a_tensor_parallel_mlp():
    trace, local_bytes, B, S, D, F = _mlp_trace()
    c = trace.collectives()
    assert c["counts"] == {"all-gather": 0, "all-reduce": 1, "reduce-scatter": 0,
                           "all-to-all": 0, "collective-permute": 0}
    assert c["bytes"]["all-reduce"] == local_bytes == c["total_bytes"]
    assert trace.flops == 2 * 2 * (B // 16) * S * D * (F // 16)
    # the reference's record layout
    assert dr.collective_bytes([("all-reduce", 8), ("all-gather", 4), ("all-reduce", 2)]) == {
        "bytes": {"all-gather": 4, "all-reduce": 10, "reduce-scatter": 0, "all-to-all": 0,
                  "collective-permute": 0},
        "counts": {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0},
        "total_bytes": 14}


def _small_mesh(shape=(2, 2)):
    return dr.traced_mesh(dr.meta_mesh(len(shape) == 3, shape))


def test_rwkv6_time_loop_on_meta_equals_a_step_by_step_trace(monkeypatch):
    """rwkv6 SMOKE, a prefill and a train step of 8 tokens: the time loop
    run on meta shards as one step over all positions gives the records
    (counts, bytes, FLOPs, argument and output bytes) of the loop run
    step by step."""
    from repro_torch.models import rwkv6
    mesh = _small_mesh()
    with dr.fake_group(mesh.size):
        mesh.device_mesh("cpu")
        for shape, kw in (("prefill_32k", {}), ("train_4k", {"microbatches": 1})):
            cfg = dr.arch_config("rwkv6_7b", shape, "w8a8", smoke=True)
            got = dr.trace_cell(cfg, shape, mesh, dims=(4, 8), **kw)
            with monkeypatch.context() as m:
                m.setattr(rwkv6, "_wkv_meta", rwkv6._wkv_loop)
                want = dr._measures(dr._trace(cfg, shape, mesh, dims=(4, 8), **kw))
            assert "time_loop" in got["extrapolation"]
            assert dr._measures(got) == want, shape
            assert want["collectives"]["total_bytes"] > 0 and want["cost_analysis"]["flops"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_depth_extrapolation_equals_a_direct_trace(arch):
    """Traced at 1 and 2 layer units and extrapolated to 3, every record
    of a prefill equals a direct trace of 3 units (the hybrid's tail
    layers kept in all three)."""
    cfg = dr.arch_config(arch, "prefill_32k", "w8a8", smoke=True)
    n_units, at = dr.depth_units(cfg)
    deep = at(3)
    mesh = _small_mesh((2, 2, 2))
    dims = (4, 32)
    with dr.fake_group(mesh.size):
        mesh.device_mesh("cpu")
        got = dr.trace_cell(deep, "prefill_32k", mesh, dims=dims)
        want = dr._measures(dr._trace(deep, "prefill_32k", mesh, dims=dims))
    assert got["extrapolation"]["depth"]["n_units"] == 3
    assert dr._measures(got) == want
    assert not dist.is_initialized()


def test_run_cell_ok_for_every_family_smoke_in_every_kind():
    """Every family's SMOKE config in every kind over a fake (2, 2) group,
    and in one kind over a (2, 2, 2) group: ``ok`` with the three
    records, and no group left; the train cells take the roofline mode's
    one microbatch.  In this process, whose earlier tests have paid
    DTensor's first-use costs (a worker process would pay them again)."""
    cells = [(arch, shape, (2, 2)) for arch in FAMILY_ARCHS for shape in api.SHAPES
             if api.shape_applicable(get_config(arch), shape) is None]
    cells += [(arch, shape, (2, 2, 2)) for arch, shape in MULTI_POD_SHAPES.items()]
    assert len(cells) == 6 * 3 + 2 + 6
    for arch, shape, mesh in cells:
        rec = dr.run_cell(arch, shape, multi_pod=len(mesh) == 3, device_type="cpu",
                          smoke=True, mesh_shape=mesh, roofline=shape == "train_4k")
        assert rec["status"] == "ok", (arch, shape, mesh, rec.get("error"))
        assert sorted(k for k in rec if k in ("collectives", "cost_analysis",
                                              "memory_analysis")) == [
            "collectives", "cost_analysis", "memory_analysis"]
        assert not dist.is_initialized()


def test_roofline_reanchors_on_direct_traces_of_two_and_three_units(monkeypatch):
    """``run_roofline_cell`` extrapolates c1 + (units - 1) (c2 - c1) from
    the 1- and 2-unit costs, and where a 2-unit figure falls below the
    1-unit one, re-anchors on the 2- and 3-unit costs; ``_cell_costs``
    traces each config at its own depth (``_trace``, no extrapolation)."""
    n = get_config("qwen2_1_5b").n_layers
    for falls, c2_flops in ((False, 14.0), (True, 8.0)):
        costs = {1: {"flops": 10.0, "collective_bytes": 100.0},
                 2: {"flops": c2_flops, "collective_bytes": 150.0},
                 3: {"flops": 11.0, "collective_bytes": 190.0}}
        seen = []

        def fake_costs(cfg, shape, mesh, **kw):
            seen.append(cfg.n_layers)
            return dict(costs[cfg.n_layers])
        monkeypatch.setattr(dr, "_cell_costs", fake_costs)
        rec = dr.run_roofline_cell("qwen2_1_5b", "decode_32k", device_type="cpu")
        assert rec["status"] == "ok", rec.get("error")
        assert not dist.is_initialized()
        if falls:
            assert seen == [1, 2, 3] and rec["extrapolation"]["base_n"] == 2
            want = (8.0 + (n - 2) * 3.0, 150.0 + (n - 2) * 40.0)
        else:
            assert seen == [1, 2] and rec["extrapolation"]["base_n"] == 1
            want = (10.0 + (n - 1) * 4.0, 100.0 + (n - 1) * 50.0)
        assert (rec["cost_analysis"]["flops"], rec["collectives"]["total_bytes"]) == want
    monkeypatch.undo()
    traced = []

    def fake_trace(cfg, shape, mesh, compile_=True, **kw):
        traced.append((cfg.n_layers, kw["microbatches"], kw["dims"]))
        return {"collectives": {"total_bytes": 7}, "cost_analysis": {"flops": 5.0}}
    monkeypatch.setattr(dr, "_trace", fake_trace)
    cfg3, _, _ = dr._layers_reduced(get_config("qwen2_1_5b"), 3)
    assert dr._cell_costs(cfg3, "decode_32k", None) == {"flops": 5.0,
                                                        "collective_bytes": 7.0}
    assert traced == [(3, 1, dr.cell_dims("decode_32k"))]


def test_full_size_cell_and_no_group_left(tmp_path):
    rec = dr.run_cell("qwen2_1_5b", "decode_32k", multi_pod=False, device_type="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert not dist.is_initialized()
    assert rec["device_mesh"] == {"data": 16, "model": 16}
    c = rec["collectives"]
    assert set(c) == {"bytes", "counts", "total_bytes"} and c["total_bytes"] > 0
    assert c["counts"]["all-reduce"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes"}
    assert "bytes accessed" not in rec["cost_analysis"] and "hlo_bytes" not in rec
    dr.save_record(rec, results_dir=tmp_path)
    saved = json.loads((tmp_path / "qwen2_1_5b_decode_32k_single_w8a8.json").read_text())
    assert saved["status"] == "ok"
    assert dr.RESULTS_DIR.parts[-2:] == ("experiments", "dryrun_torch")
    skipped = dr.run_cell("qwen2_1_5b", "long_500k", multi_pod=True, device_type="cpu")
    assert skipped["status"] == "skipped" and not dist.is_initialized()


def test_cuda_device_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    rec = dr.run_cell("qwen2_1_5b", "decode_32k", multi_pod=False)
    assert rec["status"] == "failed" and "device-type cpu" in rec["error"]
    assert not dist.is_initialized()
    with dr.fake_group(4):
        with pytest.raises(ValueError, match="device_type="):
            dr.meta_mesh(False, (2, 2)).device_mesh()
    assert not dist.is_initialized()
