"""Cross-segment fusion in the port against the reference, on the CPU.

Four legs, held bit for bit (``assert_array_equal``) unless a line says
otherwise:

  * the boundary glue, ``kernels.quant_pool``'s six functions (the float32
    and code-domain pools, the nibble packers) against
    ``repro.kernels.quant_pool`` over the cases of tests/test_fusion.py;
  * the negotiation: ``fusion_stats()``, the carriers, the fusion-rule
    segment counts and the interpreted ops of every ``ZOO`` key on both
    tiers equal the reference's, and equal the census ``chip_smoke.py``
    pins on the card (``CENSUS_FUSION``);
  * each of the four rules (residual Add with and without its Relu /
    Quant tails, MaxPool, AveragePool, Concat, the bipolar chain): the
    port's fused plan equals the reference's fused plan, the port's oracle
    and the port's own ``use_fusion=False`` plan, and the carried
    boundaries are int8 / uint8 tensors;
  * the reference's boundary corpus (``build_boundary_graph``) over a few
    seeds of each scale family, the three ways
    ``test_fuzz_boundary_chains`` checks the reference.

Graphs are built by the reference's builders and handed to the port as
``core/serialize.py`` JSON.  The scale families that assert bits are
dyadic or powers of two (ROADMAP C2).
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import execute as r_execute  # noqa: E402
from repro.core import serialize as rser  # noqa: E402
from repro.core.compile import compile_graph as r_compile  # noqa: E402
from repro.core.graph import GraphBuilder as RBuilder  # noqa: E402
from repro.core.passes import run_pipeline as r_run  # noqa: E402
from repro.kernels import quant_pool as rqp  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import compile_graph as t_compile  # noqa: E402
from repro_torch.core import execute as t_execute  # noqa: E402
from repro_torch.core import serialize as tser  # noqa: E402
from repro_torch.core.passes import run_pipeline as t_run  # noqa: E402
from repro_torch.kernels import quant_pool as tqp  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from test_fusion import (_act, _conv, _np_avgpool, _x,  # noqa: E402
                         build_bipolar_chain, build_pool, build_residual)
from test_fuzz_compile import build_boundary_graph  # noqa: E402

FUSION_KINDS = ("bipolar_act", "quant_pool", "eltwise_add", "quant_concat")


def _port(g):
    return tser.graph_from_json(rser.graph_to_json(g))


def _out(result, g):
    v = result[g.output_names[0]]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _t_oracle(g, x):
    gc = t_run(g, "compile_prep")
    return _out(t_execute(gc, {"x": x}, device="cpu"), gc)


# ------------------------------------------------ the glue: quant_pool

# tests/test_fusion.py's cases: (kernel, strides, pads, count_include_pad,
# zero point)
AVG_CASES = [
    ((2, 2), (2, 2), (0, 0, 0, 0), 0, 0),
    ((2, 2), (1, 1), (1, 1, 1, 1), 0, 0),     # real-count divisor
    ((2, 2), (1, 1), (1, 1, 1, 1), 1, 0),     # count_include_pad divisor
    ((3, 3), (2, 2), (1, 0, 1, 0), 0, 3),     # asymmetric pads + zero point
    ((3, 2), (1, 2), (0, 1, 0, 1), 1, 3),
    ((3, 3), (3, 3), (2, 2, 2, 2), 0, -2),
]
# CNV's 2x2 / 2; padded and strided windows with pads < kernel (the codes
# path's gate)
MAX_CASES = [((2, 2), (2, 2), (0, 0, 0, 0)), ((3, 3), (1, 1), (1, 1, 1, 1)),
             ((3, 3), (2, 2), (1, 0, 1, 0)), ((2, 2), (1, 1), (1, 1, 1, 1)),
             ((3, 2), (1, 2), (0, 1, 0, 1))]


@pytest.mark.parametrize("k,s,pads,cip,zp", AVG_CASES)
def test_avgpool_matches_reference(k, s, pads, cip, zp):
    """Both average pools equal the reference's bit for bit on a dyadic
    carrier (and each other, and the NumPy loops within float32)."""
    rng = np.random.RandomState(7)
    codes = rng.randint(-8, 8, size=(2, 3, 7, 9)).astype(np.int8)
    scale = np.float32(2.0 ** -3)
    vals = (codes.astype(np.float32) - np.float32(zp)) * scale
    kw = dict(kernel_shape=k, strides=s, pads=pads, count_include_pad=cip)
    want = np.asarray(rqp.avgpool2d(jnp.asarray(vals), **kw))
    got = tqp.avgpool2d(torch.from_numpy(vals), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    got_codes = tqp.avgpool2d_codes(torch.from_numpy(codes), scale, float(zp),
                                    **kw).numpy()
    np.testing.assert_array_equal(got_codes, np.asarray(rqp.avgpool2d_codes(
        jnp.asarray(codes), scale, float(zp), **kw)))
    np.testing.assert_array_equal(got_codes, got)
    np.testing.assert_allclose(got, _np_avgpool(vals, k, s, pads, cip),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k,s,pads", MAX_CASES)
def test_maxpool_matches_reference(k, s, pads):
    """The code-domain max over the full int8 range equals the
    reference's, and dequantizes to both float32 max pools (any scale,
    a zero point off 0)."""
    rng = np.random.RandomState(8)
    codes = rng.randint(-128, 128, size=(2, 4, 7, 9)).astype(np.int8)
    kw = dict(kernel_shape=k, strides=s, pads=pads)
    q = tqp.maxpool2d_codes(torch.from_numpy(codes), **kw)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(rqp.maxpool2d_codes(jnp.asarray(codes), **kw)))
    sc, z = np.float32(0.03), np.float32(1.0)
    vals = (codes.astype(np.float32) - z) * sc
    want = np.asarray(rqp.maxpool2d(jnp.asarray(vals), **kw))
    np.testing.assert_array_equal(
        tqp.maxpool2d(torch.from_numpy(vals), **kw).numpy(), want)
    np.testing.assert_array_equal((q.numpy().astype(np.float32) - z) * sc,
                                  want)


@pytest.mark.parametrize("shape", [(6,), (2, 3, 4), (1, 8, 5, 6), (2, 10),
                                   (3, 2, 32)])
def test_pack_unpack_match_reference(shape):
    """The nibble packers are the reference's, byte for byte, along the
    last axis; every byte unpacks as the reference unpacks it."""
    rng = np.random.RandomState(9)
    codes = rng.randint(-8, 8, size=shape).astype(np.int8)
    packed = tqp.pack_codes_int4(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8
    assert tuple(packed.shape) == shape[:-1] + (shape[-1] // 2,)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(rqp.pack_codes_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tqp.unpack_codes_int4(packed).numpy(),
                                  codes)
    every = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(
        tqp.unpack_codes_int4(torch.from_numpy(every)).numpy(),
        np.asarray(rqp.unpack_codes_int4(jnp.asarray(every))))


# ------------------------------------------- negotiation on the zoo

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _census(plan):
    """What negotiation decided and what it left interpreted."""
    return {"stats": plan.fusion_stats(),
            "fusion_kinds": {k: v for k, v in plan.fused_counts.items()
                             if k in FUSION_KINDS},
            "interp": plan.interp_op_counts()}


def _carriers(plan):
    return {t: (c.scale, c.zero_point, c.bits, c.signed, c.packed)
            for t, c in plan.fusion.carriers.items()}


def _zoo(pkg, key):
    return pkg.ZOO[key]()             # MobileNet at its default img 224


@pytest.mark.parametrize("use_analysis", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("key", list(rzoo.ZOO))
def test_zoo_negotiation_matches_reference(key, use_analysis):
    r_plan = r_compile(_zoo(rzoo, key), use_analysis=use_analysis)
    t_plan = t_compile(_zoo(tzoo, key), device="cpu",
                       use_analysis=use_analysis)
    assert _census(t_plan) == _census(r_plan)
    assert t_plan.fused_counts == r_plan.fused_counts
    assert _carriers(t_plan) == _carriers(r_plan)
    assert [s.meta for s in t_plan.segments if s.meta.get("fused_boundary")
            and s.kind in FUSION_KINDS] == \
        [s.meta for s in r_plan.segments if s.meta.get("fused_boundary")
         and s.kind in FUSION_KINDS]
    cs = _chip_smoke()
    want = cs.CENSUS_FUSION[(key, "int" if use_analysis else "f32")]
    assert _census(t_plan) == want
    off = t_compile(_zoo(tzoo, key), device="cpu", use_analysis=use_analysis,
                    use_fusion=False)
    assert off.fusion_stats()["enabled"] is False
    assert off.fusion_stats()["fused_boundary_segments"] == 0


def test_grouped_conv_negotiation_matches_reference():
    """chip_smoke.py's grouped conv (B5 on the compiled path): its census
    with fusion on is the reference's."""
    cs = _chip_smoke()
    g_port = cs.grouped_conv_graph()
    g_ref = rser.graph_from_json(tser.graph_to_json(g_port))
    for tier, kw in (("int", {}), ("f32", {"use_analysis": False})):
        r_plan = r_compile(g_ref, **kw)
        t_plan = t_compile(g_port, device="cpu", **kw)
        assert _census(t_plan) == _census(r_plan) == \
            cs.CENSUS_FUSION[("GroupedConv-g8", tier)]
        assert _carriers(t_plan) == _carriers(r_plan)


def test_cost_report_gains_the_fusion_line():
    """The load-time cost report of a fused plan reads ``fusion_stats()``
    as the reference's does."""
    from repro.analysis import cost as rcost
    from repro.core import transforms as rtr
    from repro_torch.analysis import cost as tcost
    from repro_torch.core import transforms as ttr
    r_plan = r_compile(rzoo.ZOO["CNV-w1a1"]())
    t_plan = t_compile(tzoo.ZOO["CNV-w1a1"](), device="cpu")
    rep_r = rcost.infer_cost(rtr.infer_shapes(r_plan.graph), plan=r_plan)
    rep_t = tcost.infer_cost(ttr.infer_shapes(t_plan.graph), plan=t_plan)
    assert "cross-segment fusion" in rep_t.table()
    assert rep_t.table() == rep_r.table()


def test_compile_records_the_boundary_gauges():
    from repro_torch.obs import default_registry
    t_compile(tzoo.ZOO["CNV-w1a1"](), device="cpu")
    reg, model = default_registry(), {"model": "CNV-w1a1"}
    assert reg.get("compile_integer_boundaries", model).value == 10
    assert reg.get("compile_boundary_bytes_saved", model).value == 559744
    t_compile(tzoo.ZOO["CNV-w1a1"](), device="cpu", use_fusion=False)
    assert reg.get("compile_boundary_bytes_saved", model).value == 0


# --------------------------------------------------- the four rules

@functools.lru_cache(maxsize=None)
def _reference(name):
    return RULE_GRAPHS[name]()


def build_concat():
    """tests/test_fusion.py's Concat case: two 1x1 conv branches, each
    Relu -> 4-bit Quant, concatenated as the graph output."""
    rng = np.random.RandomState(3)
    b = RBuilder("concat")
    x = b.add_input("x", (1, 4, 8, 8))
    h = b.quant(x, 1.0 / 128, 0.0, 8)
    a1 = _act(b, _conv(b, rng, h, 4, 8, k=1, pad=0), 4)
    a2 = _act(b, _conv(b, rng, h, 4, 8, k=1, pad=0), 4)
    (y,) = b.add_node("Concat", [a1, a2], 1, {"axis": 1})
    b.mark_output(y)
    return b.build()


RULE_GRAPHS = {
    "residual": lambda: build_residual(),
    "residual_out": lambda: build_residual(tail_conv=False),
    "residual_no_relu": lambda: build_residual(relu=False),
    "residual_relu_only": lambda: build_residual(act=False, tail_conv=False),
    "residual_bare": lambda: build_residual(relu=False, act=False,
                                            tail_conv=False),
    "maxpool": lambda: build_pool("MaxPool", 2, 2, 0),
    "maxpool_padded": lambda: build_pool("MaxPool", 3, 1, 1),
    "maxpool_out": lambda: build_pool("MaxPool", 3, 2, 1, tail_conv=False),
    "avgpool": lambda: build_pool("AveragePool", 2, 2, 0, tail_conv=False),
    "avgpool_real_count": lambda: build_pool("AveragePool", 2, 2, 1, 0,
                                             tail_conv=False),
    "avgpool_include_pad": lambda: build_pool("AveragePool", 3, 3, 2, 1,
                                              tail_conv=False),
    "concat": build_concat,
    "bipolar_chain": lambda: build_bipolar_chain(),
}
RULE_INPUTS = {"maxpool": (1, 4, 9, 9), "bipolar_chain": (1, 3, 8, 8)}
RULE_KINDS = {"residual": "eltwise_add", "maxpool": "quant_pool",
              "avgpool": "quant_pool", "concat": "quant_concat",
              "bipolar": "bipolar_act"}


@pytest.mark.parametrize("name", list(RULE_GRAPHS))
def test_rule_bit_exact_against_reference_and_oracle(name):
    g_ref = _reference(name)
    g_port = _port(g_ref)
    shape = tuple(d or 1 for d in g_port.inputs[0].shape)
    x = _x(sum(map(ord, name)) % 97, shape)
    r_plan = r_compile(g_ref)
    plan = t_compile(g_port, device="cpu")
    assert plan.requant_stats()["fp32_segments"] == 0, plan.describe()
    assert _census(plan) == _census(r_plan)
    kind = RULE_KINDS[name.split("_")[0]]
    assert plan.fused_counts.get(kind, 0) >= 1, plan.describe()
    got = _out(plan({"x": x}), g_port)
    np.testing.assert_array_equal(got, _out(r_plan({"x": x}), g_ref))
    np.testing.assert_array_equal(got, _t_oracle(g_port, x))
    off = t_compile(g_port, device="cpu", use_fusion=False)
    np.testing.assert_array_equal(got, _out(off({"x": x}), g_port))
    if name.startswith("avgpool"):
        seg = next(s for s in plan.segments if s.kind == "quant_pool")
        assert seg.meta["avg_path"] == "int32", plan.describe()


def test_float32_tier_rules_bit_exact():
    """The same rules on the float32-epilogue tier (B4 emits the codes)."""
    for name in ("residual", "maxpool_padded", "bipolar_chain", "concat"):
        g_ref = _reference(name)
        g_port = _port(g_ref)
        x = _x(5, tuple(d or 1 for d in g_port.inputs[0].shape))
        plan = t_compile(g_port, device="cpu", use_analysis=False)
        r_plan = r_compile(g_ref, use_analysis=False)
        assert _census(plan) == _census(r_plan), name
        got = _out(plan({"x": x}), g_port)
        np.testing.assert_array_equal(got, _out(r_plan({"x": x}), g_ref))
        np.testing.assert_array_equal(got, _t_oracle(g_port, x))


def test_boundary_tensors_carry_integer_dtypes():
    """Step the plan segment by segment: every negotiated carrier is an
    int8 tensor (uint8 when nibble-packed); without fusion the same
    tensors are float32."""
    g = _port(_reference("bipolar_chain"))
    x = torch.from_numpy(_x(4, (1, 3, 8, 8)))
    plan = t_compile(g, device="cpu")
    carried = plan.fusion.carriers
    assert any(c.packed for c in carried.values()), carried
    env = {"x": x}
    for seg in plan.segments:
        seg.run(plan.consts, env)
    for name, c in carried.items():
        assert env[name].dtype == (torch.uint8 if c.packed else torch.int8)
    off = t_compile(g, device="cpu", use_fusion=False)
    env = {"x": x}
    for seg in off.segments:
        seg.run(off.consts, env)
    for name in carried:
        assert env[name].dtype == torch.float32, name


def test_cnv_w1a1_zero_interpreted_pool_and_add():
    """The port's counterpart of tests/test_fusion.py's CNV-w1a1 pin: no
    interpreted MaxPool / Add / BipolarQuant with fusion on, the two
    MaxPools back without it, and both plans equal, bit for bit, to each
    other, the port's oracle and the reference's fused plan."""
    g = tzoo.ZOO["CNV-w1a1"]()
    plan = t_compile(g, device="cpu")
    counts = plan.interp_op_counts()
    assert not {"MaxPool", "Add", "BipolarQuant"} & set(counts), counts
    fs = plan.fusion_stats()
    assert fs["fused_boundary_segments"] == 19 and fs["integer_boundaries"] == 10
    off = t_compile(g, device="cpu", use_fusion=False)
    assert off.interp_op_counts().get("MaxPool", 0) == 2
    assert off.fusion_stats()["fused_boundary_segments"] == 0
    x = _x(0, (2, 3, 32, 32))
    got = _out(plan({"x": x}), g)
    np.testing.assert_array_equal(got, _out(off({"x": x}), g))
    np.testing.assert_array_equal(got, _t_oracle(g, x))
    r_plan = r_compile(rzoo.ZOO["CNV-w1a1"]())
    np.testing.assert_array_equal(got, _out(r_plan({"x": x}), g))


@pytest.mark.parametrize("key", ["TFC-w1a2", "CNV-w2a2"])
def test_zoo_fused_plan_equals_unfused_and_oracle(key):
    """The integer and float32 tiers with fusion on equal the plans without
    it and the oracle (TFC packs every boundary, CNV-w2a2 mixes int8 and
    packed carriers)."""
    g = tzoo.ZOO[key]()
    shape = (3, 784) if key.startswith("TFC") else (2, 3, 32, 32)
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    want = _t_oracle(g, x)
    for kw in ({}, {"use_analysis": False}):
        on = t_compile(g, device="cpu", **kw)
        off = t_compile(g, device="cpu", use_fusion=False, **kw)
        assert on.fusion_stats()["integer_boundaries"] == (
            4 if key.startswith("TFC") else 10)
        got = _out(on({"x": x}), g)
        np.testing.assert_array_equal(got, _out(off({"x": x}), g))
        np.testing.assert_array_equal(got, want)


def test_rescaled_mobilenet_fused_up_to_the_final_matmul():
    """MobileNet-w4a4 at img 32 with live activations on the integer path:
    27 carried boundaries, none packed (4-bit unsigned codes need 5 bits
    signed), and every tensor up to the float32 final MatMul equal to the
    unfused plan's and the oracle's."""
    from repro_torch.core import transforms as ttr
    x = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
    g = tzoo.rescale_conv_gains(tzoo.build_mobilenet(4, 4, img=32))
    plan = t_compile(g, device="cpu")
    fs = plan.fusion_stats()
    assert (fs["integer_boundaries"], fs["packed_boundaries"]) == (27, 0)
    pre = [n for n in plan.graph.toposort() if n.op_type == "MatMul"][-1] \
        .inputs[0]
    envs = []
    for p in (plan, t_compile(g, device="cpu", use_fusion=False)):
        env = {"x": torch.from_numpy(x)}
        for seg in p.segments:
            seg.run(p.consts, env)
        envs.append(env)
    oracle = t_execute(ttr.cleanup(g), {"x": x}, device="cpu",
                       return_all=True)
    np.testing.assert_array_equal(envs[0][pre].numpy(), oracle[pre].numpy())
    np.testing.assert_array_equal(envs[0][pre].numpy(), envs[1][pre].numpy())
    out = g.output_names[0]
    np.testing.assert_array_equal(envs[0][out].numpy(), envs[1][out].numpy())
    assert float((oracle[pre] != 0).float().mean()) > 0.3


# ------------------------------------------- the boundary corpus

# three seeds of each scale family (family = seed % 3: float, pow2, dyadic)
CORPUS_SEEDS = [600, 601, 602, 603, 604, 605, 606, 607, 608]


def _requant_paths(plan):
    return [s.meta["requant_path"] for s in plan.segments
            if s.meta.get("requant_path") is not None]


@pytest.mark.parametrize("seed", CORPUS_SEEDS)
def test_boundary_chains(seed):
    """The three checks of ``test_fuzz_boundary_chains`` on the port's
    plan: fusion is a bitwise no-op against ``use_fusion=False``; an
    all-int32 plan is bit-exact against the oracle (and the reference's
    fused plan); any other plan stays in the float envelope of both, up to
    5 % of outputs (the one-step flips directional modes admit)."""
    family = ("float", "pow2", "dyadic")[seed % 3]
    g_ref, x = build_boundary_graph(seed, scale_family=family)
    g = _port(g_ref)
    plan = t_compile(g, device="cpu")
    r_plan = r_compile(g_ref)
    assert _census(plan) == _census(r_plan)
    out = _out(plan({"x": x}), g)
    off = t_compile(g, device="cpu", use_fusion=False)
    np.testing.assert_array_equal(out, _out(off({"x": x}), g),
                                  err_msg=plan.describe())
    ref = _t_oracle(g, x)
    r_out = _out(r_plan({"x": x}), g_ref)
    paths = _requant_paths(plan)
    if paths and all(p == "int32" for p in paths):
        np.testing.assert_array_equal(out, ref, err_msg=plan.describe())
        np.testing.assert_array_equal(out, r_out)
    else:
        for want in (ref, r_out):
            close = np.isclose(want, out, atol=2e-4, rtol=2e-4)
            assert 1.0 - close.mean() <= 0.05, plan.describe()


def test_boundary_corpus_exercises_fused_boundaries():
    """The seeds above reach every fused boundary kind of the corpus,
    integer carriers and the bit-exact branch, or the checks would pass
    vacuously."""
    kinds: dict = {}
    carried = exact = 0
    for seed in CORPUS_SEEDS:
        g_ref, _ = build_boundary_graph(
            seed, scale_family=("float", "pow2", "dyadic")[seed % 3])
        plan = t_compile(_port(g_ref), device="cpu")
        carried += plan.fusion_stats()["integer_boundaries"]
        for s in plan.segments:
            if s.meta.get("fused_boundary"):
                kinds[s.kind] = kinds.get(s.kind, 0) + 1
        paths = _requant_paths(plan)
        exact += bool(paths) and all(p == "int32" for p in paths)
    assert {"eltwise_add", "quant_pool", "quant_concat"} <= set(kinds), kinds
    assert carried > 0 and exact >= 2, (kinds, carried, exact)


def test_reference_oracle_agrees_on_the_rule_graphs():
    """The two oracles agree on the rule graphs (power-of-two scales), so
    the port's oracle stands for the reference's here."""
    for name in ("residual", "maxpool", "bipolar_chain"):
        g_ref = _reference(name)
        x = _x(3, tuple(d or 1 for d in g_ref.inputs[0].shape))
        gc = r_run(g_ref, "compile_prep")
        np.testing.assert_array_equal(
            np.asarray(r_execute(gc, {"x": x})[gc.output_names[0]]),
            _t_oracle(_port(g_ref), x))
