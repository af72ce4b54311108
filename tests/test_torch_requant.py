"""The port's integer-only path against the reference, on the CPU.

Three legs, all held bit for bit (``assert_array_equal``): the integer
epilogue B3 (``int_epilogue_plain`` against the reference's
``int_epilogue``) over every rounding mode, signed / unsigned / narrow
bounds, shifts below, at and above 0, zero points and ReLU, with
accumulators up to the limits the lowering's proof obligations allow;
the integer bodies of B1 / B2 / B5 / B6 (the plain twins here, the
reference's Pallas kernels in interpret mode); and ``compile_graph``'s
analysis-driven default on the zoo: the reference's census and
``requant_stats()`` on every ``ZOO`` key, TFC / CNV at 100 % int32
segments and equal to both oracles and the reference's plan, MobileNet at
27 of 28 segments and equal up to its float32 final MatMul.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import execute as r_execute  # noqa: E402
from repro.core.compile import compile_graph as r_compile  # noqa: E402
from repro.core.passes import run_pipeline as r_run  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import quant_grouped_conv as rgc  # noqa: E402
from repro.kernels.requant import IntRequant as RIntRequant  # noqa: E402
from repro.kernels.requant import int_epilogue  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import compile_graph as t_compile  # noqa: E402
from repro_torch.core import execute as t_execute  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.quant_dequant import static_bounds  # noqa: E402
from repro_torch.kernels.requant import IntRequant  # noqa: E402
from repro_torch.kernels.requant import int_epilogue_plain  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP", "HALF_DOWN",
         "ROUND_TO_ZERO")
EXACT = 2 ** 24                     # the proof obligations' float32 bound
BOUNDS = [(True, False, 5), (True, True, 4), (False, False, 4),
          (False, True, 2), (True, False, 8)]


def _both(**fields):
    return IntRequant(**fields), RIntRequant(**fields)


def _edge(s: int, zp: int, half: bool) -> int:
    """The largest |acc * mult| obligation 4 admits for this shift and
    zero point (obligation 3 alone: 2**24 - 1)."""
    if s >= 0:
        room = (EXACT - 2 ** s) / 2 - abs(zp) * 2 ** s if half \
            else EXACT - abs(zp) * 2 ** s
    else:
        room = ((EXACT / 2 if half else EXACT) - abs(zp)) / 2 ** -s
    return int(np.ceil(room)) - 1


def _accs(rng, s, zp, half):
    """Random sums, every tie and near-tie of a 2**s grid, and the edges."""
    e = _edge(s, zp, half)
    step = 2 ** max(s, 0)
    ties = np.arange(-3 * step - 2, 3 * step + 3) if s > 0 else \
        np.arange(-20, 21)
    vals = np.concatenate([rng.randint(-5000, 5000, 64), ties,
                           [e, -e, e - 1, -e + 1, 0]])
    return vals.astype(np.int32)


def _check(acc, mult, fields):
    t_rq, r_rq = _both(**fields)
    got = int_epilogue_plain(torch.from_numpy(acc), torch.from_numpy(mult),
                             t_rq).numpy()
    want = np.asarray(int_epilogue(jnp.asarray(acc), jnp.asarray(mult),
                                   r_rq, jnp.float32))
    np.testing.assert_array_equal(got, want, err_msg=str(fields))


@pytest.mark.parametrize("act_shift", [-3, 0, 5])
@pytest.mark.parametrize("mode", MODES)
def test_int_epilogue_plain_matches_reference(mode, act_shift):
    rng = np.random.RandomState(abs(act_shift) * 10 + MODES.index(mode))
    half = mode in ("HALF_UP", "HALF_DOWN")
    n_cases = 0
    for signed, narrow, bits in BOUNDS:
        lo, hi = (int(v) for v in static_bounds(signed, narrow, bits))
        for zp in sorted({0, lo + 1, (lo + hi) // 2, hi}):
            for relu in (False, True):
                acc = _accs(rng, act_shift, zp, half)
                # multiplier 1 keeps the edges at the edge; odd ones spread
                mult = np.where(np.arange(acc.size) % 3 == 0, 1,
                                2 * rng.randint(0, 4, acc.size) + 1)
                big = np.abs(acc.astype(np.int64)) * mult >= \
                    _edge(act_shift, zp, half)
                mult = np.where(big, 1, mult).astype(np.int32)
                _check(acc.reshape(-1, 1), mult.reshape(-1, 1), dict(
                    shift=act_shift + 4, relu=relu, has_act=True,
                    act_shift=act_shift, act_zp=zp, act_lo=lo, act_hi=hi,
                    act_out_shift=4, rounding_mode=mode))
                n_cases += 1
    assert n_cases >= 30


@pytest.mark.parametrize("shift", [0, 3, 12])
def test_int_epilogue_plain_no_act_matches_reference(shift):
    rng = np.random.RandomState(shift)
    acc = np.concatenate([rng.randint(-70000, 70000, 61),
                          [EXACT - 1, -(EXACT - 1), 0]]).astype(np.int32)
    mult = np.where(np.abs(acc) > 2 ** 20, 1,
                    2 * rng.randint(0, 8, acc.size) + 1).astype(np.int32)
    for relu in (False, True):
        _check(acc.reshape(8, 8), mult.reshape(8, 8),
               dict(shift=shift, relu=relu))
    # per-channel multipliers broadcast along the rows
    _check(acc.reshape(8, 8), mult[:8].reshape(1, 8), dict(shift=shift))


# ------------------------------------------------ the kernels' bodies

SPECS = {
    "no_act": dict(shift=9),
    "relu": dict(shift=9, relu=True),
    "act_pos": dict(shift=9, relu=True, has_act=True, act_shift=6, act_zp=0,
                    act_lo=0, act_hi=15, act_out_shift=3,
                    rounding_mode="HALF_UP"),
    "act_neg": dict(shift=2, has_act=True, act_shift=-2, act_zp=-3,
                    act_lo=-8, act_hi=7, act_out_shift=4,
                    rounding_mode="ROUND"),
    "act_zero": dict(shift=4, has_act=True, act_shift=0, act_zp=5,
                     act_lo=0, act_hi=254, act_out_shift=4,
                     rounding_mode="FLOOR"),
}


def _dyadic_x(rng, shape, in_scale):
    """Activations on a dyadic grid: in_scale times integers in [-8, 8]."""
    return (rng.randint(-8, 9, shape) * in_scale).astype(np.float32)


@pytest.mark.parametrize("spec", list(SPECS) + [None],
                         ids=list(SPECS) + ["int32_fp32_epilogue"])
@pytest.mark.parametrize("int4", [False, True])
def test_matmul_integer_bodies_match_reference(spec, int4):
    rng = np.random.RandomState(11)
    m, k, n, in_scale = 13, 38, 9, 3 * 2.0 ** -5
    x = _dyadic_x(rng, (m, k), in_scale)
    w = rng.randint(-7, 8, (k, n)).astype(np.int8)
    if spec is None:         # int32 dot of integer values, float32 epilogue
        xi = np.round(x / np.float32(in_scale)).astype(np.float32)
        s = (2.0 ** -rng.randint(2, 6, n)).astype(np.float32)
        t_kw, r_kw, sv = dict(acc_dtype=torch.int32), \
            dict(acc_dtype=jnp.int32), s
        x_port, x_ref = xi, xi
    else:
        t_rq, r_rq = _both(**SPECS[spec])
        sv = (2 * rng.randint(0, 5, n) + 1).astype(np.int32)
        t_kw = dict(acc_dtype=torch.int32, requant=t_rq, in_scale=in_scale)
        r_kw = dict(acc_dtype=jnp.int32, requant=r_rq)
        # the reference's run closure divides before the kernel
        x_port, x_ref = x, x / np.float32(in_scale)
    wk = tops.pack_int4(torch.from_numpy(w)) if int4 else \
        torch.from_numpy(w)
    fn = tops.quant_matmul_int4 if int4 else tops.quant_matmul
    rfn = rops.quant_matmul_int4 if int4 else rops.quant_matmul
    got = fn(torch.from_numpy(x_port), wk, torch.from_numpy(sv), **t_kw)
    want = rfn(jnp.asarray(x_ref), jnp.asarray(wk.numpy()), jnp.asarray(sv),
               interpret=True, **r_kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", ["relu", "act_pos", "act_neg"])
@pytest.mark.parametrize("int4", [False, True])
def test_grouped_matmul_integer_body_matches_reference(spec, int4):
    rng = np.random.RandomState(12)
    g, m, kg, ng, in_scale = 3, 17, 10, 6, 2.0 ** -3
    x = _dyadic_x(rng, (g, m, kg), in_scale)
    w = rng.randint(-7, 8, (g, kg, ng)).astype(np.int8)
    mult = (2 * rng.randint(0, 4, g * ng) + 1).astype(np.int32)
    t_rq, r_rq = _both(**SPECS[spec])
    wk = tops.pack_int4_grouped(torch.from_numpy(w)) if int4 else \
        torch.from_numpy(w)
    got = tops.quant_grouped_matmul(
        torch.from_numpy(x), wk, torch.from_numpy(mult), packed=int4,
        acc_dtype=torch.int32, requant=t_rq, in_scale=in_scale)
    want = rgc.quant_grouped_matmul(
        jnp.asarray(x / np.float32(in_scale)), jnp.asarray(wk.numpy()),
        jnp.asarray(mult), packed=int4, interpret=True, acc_dtype=jnp.int32,
        requant=r_rq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", list(SPECS) + [None],
                         ids=list(SPECS) + ["int32_fp32_epilogue"])
def test_depthwise_integer_body_matches_reference(spec):
    rng = np.random.RandomState(13)
    c, in_scale = 6, 2.0 ** -4
    x = _dyadic_x(rng, (2, c, 9, 7), in_scale)
    taps = rng.randint(-7, 8, (9, c)).astype(np.int8)
    geo = dict(kernel_shape=(3, 3), strides=(2, 1), pads=(1, 0, 1, 1))
    if spec is None:         # int32 sums, then the fused fp32 epilogue
        xi = np.round(x / np.float32(in_scale)).astype(np.float32)
        s = (2.0 ** -rng.randint(2, 6, c)).astype(np.float32)
        epi = dict(relu=True, act_bits=4, act_signed=False,
                   act_rounding="HALF_DOWN")
        qs, qz = np.float32(0.25), np.float32(1.0)
        got = tops.quant_depthwise_conv2d(
            torch.from_numpy(xi), torch.from_numpy(taps), torch.from_numpy(s),
            None, torch.tensor(qs), torch.tensor(qz), acc_dtype=torch.int32,
            **geo, **epi)
        want = rgc.quant_depthwise_conv2d(
            jnp.asarray(xi), jnp.asarray(taps), jnp.asarray(s), None,
            jnp.asarray(qs), jnp.asarray(qz), acc_dtype=jnp.int32,
            interpret=True, **geo, **epi)
    else:
        t_rq, r_rq = _both(**SPECS[spec])
        mult = (2 * rng.randint(0, 4, c) + 1).astype(np.int32)
        got = tops.quant_depthwise_conv2d(
            torch.from_numpy(x), torch.from_numpy(taps),
            torch.from_numpy(mult), acc_dtype=torch.int32, requant=t_rq,
            in_scale=in_scale, **geo)
        want = rgc.quant_depthwise_conv2d(
            jnp.asarray(x / np.float32(in_scale)), jnp.asarray(taps),
            jnp.asarray(mult), acc_dtype=jnp.int32, requant=r_rq,
            interpret=True, **geo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_depthwise_requant_refuses_a_second_epilogue():
    x, taps = torch.zeros(1, 2, 4, 4), torch.zeros(9, 2, dtype=torch.int8)
    with pytest.raises(ValueError, match="IntRequant carries"):
        tops.quant_depthwise_conv2d(
            x, taps, 1, kernel_shape=(3, 3), relu=True,
            acc_dtype=torch.int32, requant=IntRequant(shift=1))


# ----------------------------------------------------------- the zoo

@functools.lru_cache(maxsize=None)
def _reference_plan(key):
    return r_compile(rzoo.ZOO[key](), use_fusion=False)


def _segment_meta(plan):
    keep = ("acc", "acc_bits", "requant_path", "fp32_ops_eliminated")
    return [(s.kind, {k: s.meta[k] for k in keep if k in s.meta})
            for s in plan.segments]


@pytest.mark.parametrize("key", list(rzoo.ZOO))
def test_zoo_census_and_requant_stats_match_reference(key):
    r_plan = _reference_plan(key)
    t_plan = t_compile(tzoo.ZOO[key](), device="cpu", use_fusion=False)
    assert t_plan.fused_counts == r_plan.fused_counts
    assert t_plan.requant_stats() == r_plan.requant_stats()
    assert t_plan.grouped_conv_stats() == r_plan.grouped_conv_stats()
    assert _segment_meta(t_plan) == _segment_meta(r_plan)
    assert t_plan.analysis is not None


def _oracle_in(g, x):
    gc = r_run(g, "compile_prep")
    return np.asarray(r_execute(gc, {"x": x})[gc.output_names[0]])


@pytest.mark.parametrize("key,shape", [("TFC-w1a1", (5, 784)),
                                       ("TFC-w2a2", (5, 784)),
                                       ("CNV-w1a1", (2, 3, 32, 32))])
def test_zoo_full_integer_coverage_and_bit_exact(key, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    g = tzoo.ZOO[key]()
    plan = t_compile(g, device="cpu", use_fusion=False)
    stats = plan.requant_stats()
    assert stats["coverage"] == 1.0 and stats["kernel_segments"] >= 4
    assert plan.fused_counts == _reference_plan(key).fused_counts
    got = plan({"x": x})[plan.graph.output_names[0]].numpy()
    np.testing.assert_array_equal(got, _oracle_in(rzoo.ZOO[key](), x))
    r_plan = _reference_plan(key)
    np.testing.assert_array_equal(
        got, np.asarray(r_plan({"x": x})[r_plan.graph.output_names[0]]))
    np.testing.assert_array_equal(
        got, t_execute(ttr.cleanup(g), {"x": x},
                       device="cpu")[g.output_names[0]].numpy())


def test_rescaled_mobilenet_integer_path_up_to_the_final_matmul():
    """MobileNet-w4a4 at img 32 with live activations: 27 of 28 kernel
    segments on int32, and every tensor up to the float32 final MatMul
    equal to the port's and the reference's oracles."""
    x = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
    g = tzoo.rescale_conv_gains(tzoo.build_mobilenet(4, 4, img=32))
    plan = t_compile(g, device="cpu")
    stats = plan.requant_stats()
    assert (stats["int32_segments"], stats["kernel_segments"]) == (27, 28)
    final = [n for n in plan.graph.toposort() if n.op_type == "MatMul"][-1]
    pre = final.inputs[0]
    env = {"x": torch.from_numpy(x)}
    for seg in plan.segments:                  # the plan's loop, keeping env
        seg.run(plan.consts, env)
    gc = ttr.cleanup(g)
    oracle = t_execute(gc, {"x": x}, device="cpu", return_all=True)
    np.testing.assert_array_equal(env[pre].numpy(), oracle[pre].numpy())
    assert float((oracle[pre] != 0).float().mean()) > 0.3     # live: 0.42
    rg = tzoo.rescale_conv_gains(rzoo.build_mobilenet(4, 4, img=32))
    from repro.core import transforms as rtr
    r_env = r_execute(rtr.cleanup(rg), {"x": x}, return_all=True)
    np.testing.assert_array_equal(env[pre].numpy(), np.asarray(r_env[pre]))
    seg = next(s for s in plan.segments if final in s.nodes)
    assert seg.meta["requant_path"] == "fp32"


def test_use_integer_requant_false_restores_fp32_path():
    x = np.random.RandomState(1).randn(3, 784).astype(np.float32)
    plan = t_compile(tzoo.build_tfc(2, 2), device="cpu",
                     use_integer_requant=False, use_fusion=False)
    stats = plan.requant_stats()
    assert stats["int32_segments"] == 0
    assert stats["fp32_segments"] == stats["kernel_segments"] == 4
    r_plan = r_compile(rzoo.build_tfc(2, 2), use_integer_requant=False,
                       use_fusion=False)
    assert plan.fused_counts == r_plan.fused_counts
    assert _segment_meta(plan) == _segment_meta(r_plan)
    np.testing.assert_array_equal(
        plan({"x": x})[plan.graph.output_names[0]].numpy(),
        np.asarray(r_plan({"x": x})[r_plan.graph.output_names[0]]))
    off = t_compile(tzoo.build_tfc(2, 2), device="cpu", use_analysis=False)
    assert off.analysis is None and off.requant_stats()["int32_segments"] == 0


def test_compile_records_the_integer_requant_gauges():
    from repro_torch.obs import default_registry
    t_compile(tzoo.build_tfc(1, 1), device="cpu")
    reg, model = default_registry(), {"model": "TFC-w1a1"}
    assert reg.get("compile_integer_requant_coverage", model).value == 1.0
    assert reg.get("compile_integer_requant_segments", model).value == 4
    t_compile(tzoo.build_tfc(1, 1), device="cpu", use_integer_requant=False)
    assert reg.get("compile_integer_requant_coverage", model).value == 0.0


# ------------------------------------------- chip_smoke.py's constants

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_constants_match_reference():
    """The census and requant stats chip_smoke.py holds the card to (it
    cannot run JAX) are the reference's compile_graph output."""
    cs = _chip_smoke()
    for (key, int4), census in cs.CENSUS.items():
        plan = r_compile(rzoo.ZOO[key](), use_analysis=False,
                         use_fusion=False, use_int4=int4)
        assert plan.fused_counts == census, key
    from repro.core import serialize as rser
    from repro_torch.core import serialize as tser
    graphs = {"MobileNet-w4a4 rescaled":
              lambda: tzoo.rescale_conv_gains(rzoo.build_mobilenet(4, 4)),
              # the port's own graph, handed over as JSON
              "GroupedConv-g8": lambda: rser.graph_from_json(
                  tser.graph_to_json(cs.grouped_conv_graph()))}
    for key, census in cs.CENSUS_ANALYSIS.items():
        g = graphs[key]() if key in graphs else rzoo.ZOO[key]()
        plan = r_compile(g, use_fusion=False)
        assert plan.fused_counts == census, key
        assert plan.requant_stats() == cs.REQUANT_STATS[key], key
