"""The reference's public names that the port's modules carry too, on the
CPU: each exists where the reference has it, and computes the reference's
bits.

  * ``core.passes``' convenience entry points equal their pipelines;
  * ``core.compile.execute_compiled`` (exported by ``core``, as is
    ``scale_from_minmax``) is compile-then-run;
  * ``kernels.ops.quantize_weights_int8`` / ``_int4`` are the reference's
    bit for bit: it runs them outside ``jit``, so ``amax / 127.0`` is a
    true division there, and so it is here (ROADMAP C7);
  * ``serve.engine.percentile_ms`` is the reference's nearest rank;
  * ``models.ModelConfig``, ``models.api``, ``core.lowering``'s
    ``select_accumulator``, and ``kernels.flash_attention`` bound to the
    function, as ``repro.kernels`` binds it;
  * ``dist``'s sharding rules, meshes and collectives and
    ``launch.mesh``'s mesh builders (A16).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import passes as r_passes  # noqa: E402
from repro.core import serialize as rser  # noqa: E402
from repro.kernels import ops as r_ops  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro.serve import engine as r_engine  # noqa: E402
from repro_torch.core import serialize as tser  # noqa: E402

NAMES = {
    "repro_torch.core.passes": ("cleanup", "streamline_for_finn",
                                "streamline_for_hls4ml", "lower_to_qcdq",
                                "lower_to_quantized_op"),
    "repro_torch.core.compile": ("execute_compiled",),
    "repro_torch.core": ("execute_compiled", "scale_from_minmax"),
    "repro_torch.kernels.ops": ("quantize_weights_int8",
                                "quantize_weights_int4"),
    "repro_torch.serve.engine": ("percentile_ms",),
    "repro_torch.models": ("ModelConfig", "api"),
    "repro_torch.core.lowering": ("select_accumulator",),
    "repro_torch.kernels": ("flash_attention",),
    # multi-device (A16): the sharding rules, meshes and collectives
    "repro_torch.dist.sharding": ("param_pspecs", "batch_pspecs", "cache_pspecs",
                                  "data_axis_size", "to_shardings", "P",
                                  "_leaf_name", "_model_dim_for", "_data_axes",
                                  "_FSDP_MIN_SIZE", "_ROW_PARALLEL"),
    "repro_torch.dist": ("collectives", "fault", "sharding", "batch_pspecs",
                         "cache_pspecs", "data_axis_size", "param_pspecs",
                         "to_shardings"),
    "repro_torch.dist.fault": ("elastic_mesh", "Watchdog", "RestartPolicy",
                               "run_with_restarts"),
    "repro_torch.dist.collectives": ("ef_compress", "quantized_psum"),
    "repro_torch.launch.mesh": ("make_production_mesh", "make_host_mesh"),
}


@pytest.mark.parametrize("module", sorted(NAMES))
def test_reference_names_exist(module):
    mod = importlib.import_module(module)
    ref = importlib.import_module(module.replace("repro_torch", "repro"))
    for name in NAMES[module]:
        assert hasattr(mod, name), f"{module}.{name}"
        assert hasattr(ref, name), f"the reference has no {name}"


def test_bindings_are_the_references():
    import repro_torch.kernels as tk
    from repro_torch.core.lowering import base
    from repro_torch.models import common
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert tk.flash_attention is fa.flash_attention and callable(tk.flash_attention)
    from repro_torch.kernels import ops
    assert ops._fa is fa and ops.launch_counts()["flash_attention"] >= 0
    import repro_torch.core.lowering as low
    import repro_torch.models as models
    assert models.ModelConfig is common.ModelConfig
    assert low.select_accumulator is base.select_accumulator
    from repro_torch.core import quant_ops
    import repro_torch.core as core
    assert core.scale_from_minmax is quant_ops.scale_from_minmax


def _weights(seed, k, n):
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, n) * rng.rand(n) * 3).astype(np.float32)
    w[:, 0] = 0.0                        # a zero column: the 1e-8 floor
    w[::5, 1] *= np.float32(1e-6)
    return w


@pytest.mark.parametrize("k,n", [(64, 10), (784, 64), (4096, 512)])
@pytest.mark.parametrize("narrow", [True, False])
def test_quantize_weights_int8_is_the_references(k, n, narrow):
    from repro_torch.kernels import ops
    w = _weights(k + n, k, n)
    q, s = r_ops.quantize_weights_int8(w, narrow=narrow)
    tq, ts = ops.quantize_weights_int8(torch.from_numpy(w), narrow=narrow)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


@pytest.mark.parametrize("k,n", [(64, 10), (784, 64), (4096, 512)])
def test_quantize_weights_int4_is_the_references(k, n):
    from repro_torch.kernels import ops
    w = _weights(3 * k + n, k, n)
    q, s = r_ops.quantize_weights_int4(w)
    tq, ts = ops.quantize_weights_int4(torch.from_numpy(w))
    assert tuple(tq.shape) == (k // 2, n)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


def test_quantize_weights_divide_as_the_reference_does():
    """The reference's scale is ``amax / 127.0``, a true division: on these
    weights the product with float32(1 / 127) differs from it, and the
    port follows the division."""
    from repro_torch.kernels import ops
    w = _weights(0, 4096, 512)
    amax = np.abs(w).max(0)
    div = np.maximum(amax / np.float32(127.0), np.float32(1e-8))
    mul = np.maximum(amax * np.float32(1 / 127.0), np.float32(1e-8))
    assert (div != mul).any()
    np.testing.assert_array_equal(
        ops.quantize_weights_int8(torch.from_numpy(w))[1].numpy(), div)


def test_percentile_ms_is_the_references():
    from repro_torch.serve.engine import percentile_ms
    rng = np.random.RandomState(0)
    for n in (1, 2, 7, 100):
        vals = list(rng.rand(n) * 50)
        for pct in (0, 1, 50, 90, 99, 100):
            assert percentile_ms(vals, pct) == r_engine.percentile_ms(vals, pct)
    assert np.isnan(percentile_ms([], 50))


def _port(g):
    return tser.graph_from_json(rser.graph_to_json(g))


@pytest.mark.parametrize("name", NAMES["repro_torch.core.passes"])
def test_pass_entry_points_equal_the_references(name):
    """Each entry point runs its pipeline; where the reference's refuses
    the graph (``lower_to_quantized_op``: its cleanup folds the weight
    Quant, which the format cannot then represent), the port's refuses it
    alike."""
    from repro.core.formats import UnsupportedLowering as RUnsupported
    from repro_torch.core import passes
    from repro_torch.core.formats import UnsupportedLowering
    from test_graph import make_mlp_graph
    g = make_mlp_graph()
    try:
        want = getattr(r_passes, name)(g)
    except RUnsupported:
        with pytest.raises(UnsupportedLowering):
            getattr(passes, name)(_port(g))
        return
    got = getattr(passes, name)(_port(g))
    assert tser.graph_to_json(got) == tser.graph_to_json(
        passes.run_pipeline(_port(g), name))
    assert [n.op_type for n in got.nodes] == [n.op_type for n in want.nodes]


def test_execute_compiled_is_compile_then_run():
    from repro_torch.core import compile_graph, execute_compiled
    g = _port(rzoo.ZOO["TFC-w2a2"]())
    x = np.random.RandomState(0).randn(3, 784).astype(np.float32)
    got = execute_compiled(g, {"x": x}, device="cpu")
    want = compile_graph(g, device="cpu")({"x": x})
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k])
