"""The port's grouped / depthwise tier (B5, B6) against the reference, on
the CPU, where the kernels run their plain twins and the reference runs
its Pallas kernels in interpret mode.

Kernel level: the carrier layouts (``grouped_weights``,
``depthwise_weights``, ``pack_int4_grouped``) are bit-exact, and
``quant_grouped_matmul``, ``quant_grouped_conv2d`` and
``quant_depthwise_conv2d`` are bit-exact on dyadic inputs, where every
float32 partial sum is exact whatever the summation order (the B6 cases
include the fused activation requant in every rounding mode).

Rule level: the reference's ``GRAPH_SWEEP`` configurations
(``tests/test_grouped_conv.py``) with power-of-two scales, plus the
block-diagonal fallback above ``MAX_BLOCKED_GROUPS``: census, interpreted
ops and ``grouped_conv_stats()`` equal the reference's, outputs bit-exact.

Zoo level: MobileNet-w4a4 at img 32 (every layer at full width) has the
reference's census and is bit-exact against the reference plan and both
oracles; its census at img 224 is the same (checked once against the
reference on the CPU; written down here).  The zoo's random weights let
MobileNet's activations die after its fourth conv (every later one is 0),
so the same graph with each conv's gain raised by a power of two
(``zoo.rescale_conv_gains``: same integer weights, dyadic scales) is held
bit-exact too, with live activations through all 27 convs.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import GraphBuilder as RBuilder  # noqa: E402
from repro.core import execute as r_execute  # noqa: E402
from repro.core import transforms as rtr  # noqa: E402
from repro.core.compile import compile_graph as r_compile  # noqa: E402
from repro.kernels import quant_grouped_conv as rgc  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import GraphBuilder as TBuilder  # noqa: E402
from repro_torch.core import execute as t_execute  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.core.compile import compile_graph  # noqa: E402
from repro_torch.core.lowering import MAX_BLOCKED_GROUPS  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_grouped_conv as tgc  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

# the fp32-epilogue tier these tests hold, with float32 boundaries; the
# analysis-driven integer default of compile_graph is held by
# tests/test_torch_requant.py, fusion (the default) by
# tests/test_torch_fusion.py
t_compile = functools.partial(compile_graph, use_analysis=False,
                              use_fusion=False)

MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP", "HALF_DOWN",
         "ROUND_TO_ZERO")
# power-of-two scales: every sum exact, so bit-exact parity is owed
W_SCALE, A_SCALE = 2.0 ** -4, 2.0 ** -3

# MobileNet-w4a4's census (reference, use_analysis=False, use_fusion=False);
# the same at img 32 and img 224
MOBILENET_CENSUS = {
    True: {"quant_dequant": 1, "quant_conv": 1, "quant_conv_dw": 13,
           "quant_conv_int4": 13, "quant_matmul_int4": 1, "interp": 1},
    False: {"quant_dequant": 1, "quant_conv": 14, "quant_conv_dw": 13,
            "quant_matmul": 1, "interp": 1},
}
MOBILENET_STATS = {  # img -> grouped_conv_stats(); reclaimed MACs scale
    32: {"grouped_segments": 13, "block_diagonal_grouped": 0,
         "reclaimed_macs": 86_939_136, "carrier_bytes_saved": 12_512_160},
    224: {"grouped_segments": 13, "block_diagonal_grouped": 0,
          "reclaimed_macs": 4_260_017_664, "carrier_bytes_saved": 12_512_160},
}


def _dyadic(rng, shape, step=1 / 8, lim=64):
    return (rng.randint(-lim, lim + 1, shape) * step).astype(np.float32)


def _out(result, g):
    v = result[g.output_names[0]]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ------------------------------------------------------- carrier layouts

@pytest.mark.parametrize("groups,shape", [(2, (6, 2, 3, 3)), (3, (9, 2, 1, 1)),
                                          (4, (4, 1, 3, 3))])
def test_grouped_weights_bit_exact(groups, shape):
    w = np.random.RandomState(groups).randint(-8, 8, shape).astype(np.int8)
    np.testing.assert_array_equal(tgc.grouped_weights(w, groups),
                                  rgc.grouped_weights(w, groups))


def test_depthwise_weights_bit_exact():
    w = np.random.RandomState(0).randint(-8, 8, (5, 1, 3, 2)).astype(np.int8)
    np.testing.assert_array_equal(tgc.depthwise_weights(w),
                                  rgc.depthwise_weights(w))
    with pytest.raises(ValueError, match="I/g == 1"):
        tgc.depthwise_weights(np.zeros((4, 2, 3, 3), np.int8))


def test_pack_int4_grouped_bit_exact_and_roundtrip():
    wg = np.random.RandomState(0).randint(-8, 8, (3, 10, 5)).astype(np.int8)
    packed = tops.pack_int4_grouped(torch.from_numpy(wg))
    assert packed.dtype == torch.int8 and packed.shape == (3, 5, 5)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(rgc.pack_int4_grouped(jnp.asarray(wg))))
    np.testing.assert_array_equal(tops.unpack_int4_grouped(packed).numpy(),
                                  wg)
    with pytest.raises(ValueError, match="even"):
        tops.pack_int4_grouped(torch.zeros(2, 3, 4, dtype=torch.int8))


# -------------------------------------------------------------------- B5

@pytest.mark.parametrize("g,m,kg,ng", [(2, 13, 10, 5), (3, 8, 4, 4),
                                       (5, 7, 18, 3), (1, 40, 36, 33)])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("per_channel", [False, True])
def test_grouped_matmul_twin_bit_exact_on_dyadic(g, m, kg, ng, int4,
                                                 per_channel):
    rng = np.random.RandomState(g * 100 + m)
    xg = _dyadic(rng, (g, m, kg))
    wg = rng.randint(-7, 8, (g, kg, ng)).astype(np.int8)
    s = (2.0 ** -rng.randint(2, 6, g * ng if per_channel else 1)) \
        .astype(np.float32).reshape(-1 if per_channel else ())
    w = tops.pack_int4_grouped(torch.from_numpy(wg)) if int4 else \
        torch.from_numpy(wg)
    want = np.asarray(rgc.quant_grouped_matmul(
        jnp.asarray(xg), jnp.asarray(w.numpy()), jnp.asarray(s),
        packed=int4, blocks=(8, 8, 8)))
    got = tops.quant_grouped_matmul(torch.from_numpy(xg), w,
                                    torch.from_numpy(s), packed=int4)
    np.testing.assert_array_equal(got.numpy(), want)
    # bias: added to the rounded product, as the reference's conv does
    b = (rng.randint(-32, 32, g * ng) / 16.0).astype(np.float32)
    got_b = tops.quant_grouped_matmul(torch.from_numpy(xg), w,
                                      torch.from_numpy(s), torch.from_numpy(b),
                                      packed=int4)
    np.testing.assert_array_equal(got_b.numpy(), want + b.reshape(g, 1, ng))


@pytest.mark.parametrize("cin,cout,groups,k,stride,pads,dil", [
    (4, 6, 2, 3, 1, (0, 0, 0, 0), 1),
    (6, 9, 3, 3, 2, (1, 2, 0, 1), 1),       # odd per-group channels, asym pad
    (8, 8, 4, 1, 1, (0, 0, 0, 0), 1),       # grouped pointwise
    (10, 20, 5, 3, 1, (1, 1, 1, 1), 2),     # dilated
    (6, 12, 6, 3, 1, (1, 1, 1, 1), 1),      # group == cin with multiplier 2
], ids=["g2", "g3_asym", "g4_pw", "g5_dil", "cin_mult2"])
def test_grouped_conv2d_bit_exact_on_dyadic(cin, cout, groups, k, stride,
                                            pads, dil):
    rng = np.random.RandomState(cin + cout)
    w = rng.randint(-7, 8, (cout, cin // groups, k, k)).astype(np.int8)
    s = (2.0 ** -rng.randint(2, 6, cout)).astype(np.float32)
    b = (rng.randint(-32, 32, cout) / 16.0).astype(np.float32)
    x = _dyadic(rng, (2, cin, 9, 9))
    wg = rgc.grouped_weights(w, groups)
    kw = dict(groups=groups, kernel_shape=(k, k), strides=(stride, stride),
              pads=pads, dilations=(dil, dil))
    want = np.asarray(rgc.quant_grouped_conv2d(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(s), jnp.asarray(b),
        **kw))
    got = tops.quant_grouped_conv2d(torch.from_numpy(x),
                                    torch.from_numpy(wg), torch.from_numpy(s),
                                    torch.from_numpy(b), **kw)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if (cin // groups) * k * k % 2 == 0:
        got4 = tops.quant_grouped_conv2d(
            torch.from_numpy(x), tops.pack_int4_grouped(torch.from_numpy(wg)),
            torch.from_numpy(s), torch.from_numpy(b), packed=True, **kw)
        np.testing.assert_array_equal(got4.numpy(), want)


# -------------------------------------------------------------------- B6

def _dw_both(c, stride, pads, dil, relu, bias, per_channel, act_bits=None,
             mode="ROUND", signed=True, narrow=False, seed=0):
    rng = np.random.RandomState(seed + c)
    w = rng.randint(-7, 8, (c, 1, 3, 3)).astype(np.int8)
    s = (2.0 ** -rng.randint(3, 6, c if per_channel else 1)) \
        .astype(np.float32).reshape(-1 if per_channel else ())
    b = (rng.randint(-16, 16, c) / 8.0).astype(np.float32) if bias else None
    x = _dyadic(rng, (2, c, 10, 9))
    taps = rgc.depthwise_weights(w)
    qs, qz = np.float32(A_SCALE), np.float32(0.0 if signed else 1.0)
    kw = dict(kernel_shape=(3, 3), strides=(stride, stride), pads=pads,
              dilations=(dil, dil), relu=relu, act_bits=act_bits,
              act_signed=signed, act_narrow=narrow, act_rounding=mode)
    want = np.asarray(rgc.quant_depthwise_conv2d(
        jnp.asarray(x), jnp.asarray(taps), jnp.asarray(s),
        None if b is None else jnp.asarray(b), jnp.asarray(qs),
        jnp.asarray(qz), **kw))
    got = tops.quant_depthwise_conv2d(
        torch.from_numpy(x), torch.from_numpy(taps), torch.from_numpy(s),
        None if b is None else torch.from_numpy(b),
        torch.tensor(qs), torch.tensor(qz), **kw)
    return got.numpy(), want


@pytest.mark.parametrize("c,stride,pads,dil,relu,bias,per_channel", [
    (5, 1, (1, 1, 1, 1), 1, True, True, True),       # odd channel count
    (7, 2, (1, 0, 2, 1), 2, False, False, False),    # strided, dilated, asym
    (130, 1, (1, 1, 1, 1), 1, True, False, True),    # > one 128-lane block
    (4, 2, (0, 0, 0, 0), 1, False, True, False),     # no epilogue at all
], ids=["c5", "c7_s2_d2_asym", "c130", "c4_s2_bias"])
def test_depthwise_twin_bit_exact_on_dyadic(c, stride, pads, dil, relu, bias,
                                            per_channel):
    got, want = _dw_both(c, stride, pads, dil, relu, bias, per_channel)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits,signed,narrow", [(2, False, False),
                                                (4, True, False),
                                                (8, True, True)])
def test_depthwise_fused_requant_bit_exact(mode, bits, signed, narrow):
    got, want = _dw_both(6, 1, (1, 1, 1, 1), 1, True, True, True,
                         act_bits=bits, mode=mode, signed=signed,
                         narrow=narrow)
    np.testing.assert_array_equal(got, want)


def test_depthwise_twin_makes_no_launch_and_rejects_bad_taps():
    tops.reset_launch_counts()
    taps = torch.ones(9, 3, dtype=torch.int8)
    tops.quant_depthwise_conv2d(torch.ones(1, 3, 5, 5), taps, 0.5,
                                kernel_shape=(3, 3))
    assert set(tops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="taps"):
        tops.quant_depthwise_conv2d(torch.ones(1, 3, 5, 5), taps[:4], 0.5,
                                    kernel_shape=(3, 3))
    with pytest.raises(ValueError, match="rounding_mode"):
        tops.quant_depthwise_conv2d(torch.ones(1, 3, 5, 5), taps, 0.5,
                                    kernel_shape=(3, 3), act_bits=4,
                                    act_rounding="NEAR")


# ----------------------------------------------------- rule-level sweep

def _conv_graph(builder, cin=4, cout=6, img=8, k=3, stride=1,
                pads=(0, 0, 0, 0), group=1, dilation=1, w_bits=4, bias=False,
                relu=True, a_bits=4, per_channel=False, seed=0, batch=2):
    """The reference sweep's graph (``tests/test_grouped_conv.py``) with
    power-of-two scales, built by either package's builder."""
    rng = np.random.RandomState(seed)
    b = builder("gconv_t")
    x = b.add_input("x", (batch, cin, img, img))
    h = b.quant(x, A_SCALE, 0.0, 8)
    w = (rng.randn(cout, cin // group, k, k) * 0.4).astype(np.float32)
    wname = b.add_initializer("w", w)
    if w_bits == 1:
        qw = b.bipolar_quant(wname, W_SCALE)
    elif per_channel:
        s = (2.0 ** -(3 + np.arange(cout) % 3)).astype(np.float32) \
            .reshape(cout, 1, 1, 1)
        qw = b.quant(wname, s, np.zeros((cout, 1, 1, 1), np.float32),
                     w_bits, narrow=True)
    else:
        qw = b.quant(wname, W_SCALE, 0.0, w_bits, narrow=True)
    ins = [h, qw]
    if bias:
        ins.append(b.add_initializer(
            "b", (rng.randint(-8, 8, cout) / 8.0).astype(np.float32)))
    attrs = {"kernel_shape": [k, k], "strides": [stride, stride],
             "pads": list(pads), "group": group}
    if dilation != 1:
        attrs["dilations"] = [dilation, dilation]
    (h,) = b.add_node("Conv", ins, 1, attrs)
    if relu:
        (h,) = b.add_node("Relu", [h], 1)
    if a_bits:
        h = b.quant(h, A_SCALE, 0.0, a_bits)
    b.mark_output(h)
    return b.build()


GRAPH_SWEEP = {
    "g2": dict(group=2, cin=4, cout=6),
    "g2_w1_bipolar": dict(group=2, cin=4, cout=4, w_bits=1),
    "g2_w8": dict(group=2, cin=4, cout=4, w_bits=8),
    "g4_stride_pad": dict(group=4, cin=8, cout=8, stride=2,
                          pads=(1, 1, 1, 1)),
    "g2_odd_channels": dict(group=2, cin=6, cout=6, w_bits=3),  # Kg=27 odd
    "g2_dilated": dict(group=2, cin=4, cout=4, dilation=2, img=10),
    "g2_bias_per_channel": dict(group=2, cin=4, cout=6, bias=True,
                                per_channel=True),
    "g3_asym_pad": dict(group=3, cin=6, cout=9, pads=(2, 0, 1, 1)),
    "dw": dict(group=4, cin=4, cout=4),
    "dw_w1_bipolar": dict(group=4, cin=4, cout=4, w_bits=1),
    "dw_w2_a2": dict(group=4, cin=4, cout=4, w_bits=2, a_bits=2),
    "dw_stride_pad_bias": dict(group=5, cin=5, cout=5, stride=2,
                               pads=(1, 1, 1, 1), bias=True),
    "dw_dilated": dict(group=4, cin=4, cout=4, dilation=2, img=10),
    "dw_no_epilogue": dict(group=4, cin=4, cout=4, relu=False, a_bits=0),
    "dw_relu_only": dict(group=4, cin=4, cout=4, a_bits=0),
    "dw_a8": dict(group=4, cin=4, cout=4, a_bits=8),
    "dw_per_channel": dict(group=4, cin=4, cout=4, per_channel=True),
    "cin_multiplier": dict(group=4, cin=4, cout=8),   # dw shape, mult 2
    "pointwise_grouped": dict(group=2, cin=8, cout=8, k=1),
    # above MAX_BLOCKED_GROUPS with a multiplier: block-diagonal fallback
    "block_diagonal_fallback": dict(group=MAX_BLOCKED_GROUPS + 2,
                                    cin=2 * (MAX_BLOCKED_GROUPS + 2),
                                    cout=MAX_BLOCKED_GROUPS + 2, k=1, img=4,
                                    relu=False, a_bits=0),
}


def _assert_same_plan(g_ref, g_port, x, **kw):
    r_plan = r_compile(g_ref, use_analysis=False, use_fusion=False, **kw)
    t_plan = t_compile(g_port, device="cpu", **kw)
    assert t_plan.fused_counts == r_plan.fused_counts
    assert t_plan.interp_op_counts() == r_plan.interp_op_counts()
    assert t_plan.grouped_conv_stats() == r_plan.grouped_conv_stats()
    assert t_plan.n_fused_nodes == r_plan.n_fused_nodes
    got = _out(t_plan({"x": x}), g_port)
    np.testing.assert_array_equal(got, _out(r_plan({"x": x}), g_ref))
    np.testing.assert_array_equal(
        got, _out(t_execute(ttr.cleanup(g_port), {"x": x}, device="cpu"),
                  g_port))
    return t_plan, got


@pytest.mark.parametrize("kw", list(GRAPH_SWEEP.values()),
                         ids=list(GRAPH_SWEEP.keys()))
def test_grouped_rule_matches_reference(kw):
    g_port = _conv_graph(TBuilder, **kw)
    x = np.random.RandomState(100).randn(*g_port.inputs[0].shape) \
        .astype(np.float32)
    plan, _ = _assert_same_plan(_conv_graph(RBuilder, **kw), g_port, x)
    stats = plan.grouped_conv_stats()
    fallback = kw["group"] > MAX_BLOCKED_GROUPS
    assert stats["block_diagonal_grouped"] == int(fallback)
    assert stats["grouped_segments"] == int(not fallback)
    assert plan.interp_op_counts().get("Conv", 0) == 0


def test_depthwise_epilogue_inside_one_segment():
    plan = t_compile(_conv_graph(TBuilder, group=4, cin=4, cout=4),
                     device="cpu")
    seg = next(s for s in plan.segments if s.kind == "quant_conv_dw")
    assert [n.op_type for n in seg.nodes] == ["Quant", "Conv", "Relu",
                                              "Quant"]
    assert plan.fused_counts.get("quant_dequant", 0) == 1


# ------------------------------------------------------ MobileNet zoo

@pytest.fixture(scope="module")
def mobilenet_reference():
    """The reference's plan outputs and oracle at img 32, computed once."""
    x = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
    g = rzoo.build_mobilenet(4, 4, img=32)
    out = {}
    for int4 in (True, False):
        plan = r_compile(g, use_analysis=False, use_fusion=False,
                         use_int4=int4)
        out[int4] = (plan.fused_counts, plan.interp_op_counts(),
                     plan.grouped_conv_stats(), _out(plan({"x": x}), g))
    out["oracle"] = _out(r_execute(rtr.cleanup(g), {"x": x}), g)
    live = tzoo.rescale_conv_gains(rzoo.build_mobilenet(4, 4, img=32))
    plan = r_compile(live, use_analysis=False, use_fusion=False)
    out["live"] = (_out(plan({"x": x}), live),
                   _out(r_execute(rtr.cleanup(live), {"x": x}), live))
    return x, out


@pytest.mark.parametrize("int4", [True, False])
def test_mobilenet_plan_bit_exact_against_reference(mobilenet_reference,
                                                    int4):
    x, ref = mobilenet_reference
    counts, interp, stats, r_out = ref[int4]
    g = tzoo.build_mobilenet(4, 4, img=32)
    plan = t_compile(g, device="cpu", use_int4=int4)
    assert plan.fused_counts == counts == MOBILENET_CENSUS[int4]
    assert plan.interp_op_counts() == interp == {"GlobalAveragePool": 1,
                                                 "Flatten": 1}
    assert plan.grouped_conv_stats() == stats == MOBILENET_STATS[32]
    got = _out(plan({"x": x}), g)
    assert got.shape == (2, 1000)
    np.testing.assert_array_equal(got, r_out)
    np.testing.assert_array_equal(got, ref["oracle"])
    np.testing.assert_array_equal(
        got, _out(t_execute(ttr.cleanup(g), {"x": x}, device="cpu"), g))


def test_rescaled_mobilenet_bit_exact_with_live_activations(
        mobilenet_reference):
    x, ref = mobilenet_reference
    r_plan_out, r_oracle = ref["live"]
    g = tzoo.rescale_conv_gains(tzoo.build_mobilenet(4, 4, img=32))
    plan = t_compile(g, device="cpu")
    assert plan.fused_counts == MOBILENET_CENSUS[True]
    gc = ttr.cleanup(g)
    env = t_execute(gc, {"x": x}, device="cpu", return_all=True)
    relus = [env[n.outputs[0]] for n in gc.toposort() if n.op_type == "Relu"]
    assert len(relus) == 27
    assert min(float((a != 0).float().mean()) for a in relus) > 0.2
    got = _out(plan({"x": x}), g)
    assert len(np.unique(got)) > 500          # of 2000 outputs
    np.testing.assert_array_equal(got, r_plan_out)
    np.testing.assert_array_equal(got, r_oracle)
    np.testing.assert_array_equal(got, env[g.output_names[0]].numpy())


def test_mobilenet_224_census_equals_img_32():
    """Compiling only: the census at the served size is the img-32 one."""
    plan = t_compile(tzoo.build_mobilenet(4, 4, img=224), device="cpu")
    assert plan.fused_counts == MOBILENET_CENSUS[True]
    assert plan.grouped_conv_stats() == MOBILENET_STATS[224]


# ------------------------------------------- ROADMAP C2's fuzz graph, pinned

def test_fuzz_seed_210664_port_plan_pinned():
    """``build_fuzz_graph(210664)`` (Quant -> depthwise Conv -> Relu ->
    Quant -> Trunc -> two grouped Convs -> Relu -> Quant, float scales): B6's
    and B5's own path.  The port's compiled plan on both tiers equals the
    reference's plan and the port's oracle bit for bit; the reference's
    oracle, whose XLA float32 grouped-conv sums differ from these by an ulp
    at some entries, may differ from the port's by one code step of the
    last quantizer (CEIL: a sum on a grid point flips a code), no more."""
    from repro.core import serialize as rser
    from repro_torch.core import serialize as tser
    from test_fuzz_compile import build_fuzz_graph

    g_ref, x = build_fuzz_graph(210664)
    g_port = tser.graph_from_json(rser.graph_to_json(g_ref))
    r_plan = _out(r_compile(g_ref, use_fusion=False)({"x": x}), g_ref)
    t_oracle = _out(t_execute(ttr.cleanup(g_port), {"x": x}, device="cpu"),
                    g_port)
    for kw in (dict(use_analysis=False), {}):
        plan = compile_graph(g_port, device="cpu", use_fusion=False, **kw)
        assert plan.fused_counts.get("quant_conv_dw") == 1
        assert plan.grouped_conv_stats()["grouped_segments"] == 3
        got = _out(plan({"x": x}), g_port)
        np.testing.assert_array_equal(got, r_plan)
        np.testing.assert_array_equal(got, t_oracle)
    last = [n for n in g_ref.toposort() if n.op_type == "Quant"][-1]
    step = float(np.asarray(g_ref.initializers[last.inputs[1]]))
    r_oracle = _out(r_execute(rtr.cleanup(g_ref), {"x": x}), g_ref)
    diff = np.abs(r_oracle - t_oracle)
    assert diff.max() <= np.float32(step)
