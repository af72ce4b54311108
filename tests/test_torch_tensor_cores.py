"""The host-side halves of the tensor-core bodies of B2 and B7, on the CPU.

The kernels themselves run only on a GPU (``test_torch_kernels_cuda.py``);
here are the parts a CPU can hold:

* B2's staging.  When the activation scale is a power of two whose
  reciprocal is a finite normal float32, the int8 tensor-core body
  multiplies by that reciprocal instead of dividing: the same bits for
  every float32 x (numpy sample, subnormals and extremes included).  Any
  other scale is refused there; the body then stages an exact integer
  quotient without dividing and divides the rest, emulated here: the same
  codes as the division.  Its 32-bit B3 path, emulated in numpy int32,
  equals the B3 twin wherever it runs.
* The lowering's proof that B2's staged codes ``q - z`` fit int8
  (``RequantPlan.int8_codes``), as the segment meta records it, and the
  twin's check of that proof; B2's integer twin with the proof against
  the reference's Pallas kernel (interpret mode), bit for bit.
* B7's bf16 body's roundings (the scale, log2(e) folded in, after the
  dot; exp2; P split into two bf16 parts), emulated in float32 PyTorch,
  within the one-bf16-step bound that ``chip_smoke.py`` and
  ``test_torch_kernels_cuda.py`` hold the kernel to against its twin, at
  qwen2-1.5B's head shape.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.requant import IntRequant as RIntRequant  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import compile_graph as t_compile  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.requant import IntRequant  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

F32 = np.finfo(np.float32)


# ------------------------------------------- B2: the staging multiply

def _float32_sample() -> np.ndarray:
    """Random bit patterns over every exponent (NaNs dropped), then zeros,
    the subnormal and normal extremes, infinities and small integers."""
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[~np.isnan(x)]
    sub = np.array([1, 2, 3, 0x7FFFFF, 0x400000, 0x12345], np.uint32) \
        .view(np.float32)
    edges = np.array([0.0, F32.tiny, F32.max, np.inf, 1.0, 0.5, 3.0, 127.0,
                      128.0, 2.0 ** -20, 1.5 * 2.0 ** -126], np.float32)
    small = np.arange(-300, 301, dtype=np.float32) * np.float32(0.125)
    base = np.concatenate([x, sub, edges, small])
    return np.concatenate([base, -base])


POW2_SCALES = [2.0 ** e for e in (-126, -24, -5, -3, -1, 0, 1, 7, 126)] \
    + [2.0 ** -127, -0.125]


@pytest.mark.parametrize("scale", POW2_SCALES)
def test_reciprocal_multiply_is_the_division_bit_for_bit(scale):
    r = tops.exact_reciprocal(scale)
    assert r is not None and r == 1.0 / scale
    x = _float32_sample()
    with np.errstate(all="ignore"):
        div = x / np.float32(scale)
        mul = x * np.float32(r)
    np.testing.assert_array_equal(div.view(np.int32), mul.view(np.int32))
    # and the codes the kernel stages from it (round to nearest even)
    fin = np.isfinite(div) & (np.abs(div) < 2.0 ** 31)
    np.testing.assert_array_equal(np.rint(div[fin]), np.rint(mul[fin]))


@pytest.mark.parametrize("scale", [3 * 2.0 ** -5, 0.1, 1.0 + 2.0 ** -23, 0.0,
                                   np.inf, np.nan, 2.0 ** 127, 2.0 ** -128,
                                   2.0 ** -149, -3.0])
def test_reciprocal_refused_where_it_could_differ(scale):
    """No power of two, or a reciprocal that is not a finite normal
    float32 (2**127 -> 2**-127 is subnormal; 2**-128 -> infinity)."""
    assert tops.exact_reciprocal(scale) is None


def test_reciprocal_of_a_non_power_of_two_does_differ():
    """Why the refusal matters: at 3·2^-5 the product with the rounded
    reciprocal moves some quotients by an ulp."""
    s = np.float32(3 * 2.0 ** -5)
    x = _float32_sample()
    x = x[np.isfinite(x) & (np.abs(x) < 1e30) & (np.abs(x) > 1e-30)]
    with np.errstate(all="ignore"):
        assert np.any(x / s != x * (np.float32(1) / s))


@pytest.mark.parametrize("scale,dyadic", [(3 * 2.0 ** -5, True), (5.0, True),
                                          (1.0 + 2.0 ** -23, False),
                                          (0.1, False), (1.0 / 3, False)])
def test_exact_quotient_staging_is_the_division(scale, dyadic):
    """The int8 body's staging at a scale that is no power of two: n =
    rint(x · float32(1/s)); where n·s - x is exactly 0 (one FMA on the
    card, exact in float64 here) it stages n without dividing, elsewhere
    x / s.  Where it skips the division, n has the division's bits.  Every
    grid value q·s of a dyadic scale (the integer path's) skips it; at a
    scale such as 0.1, q·s is rounded and the division runs."""
    s = np.float32(scale)
    grid = (np.arange(-300, 301) * s).astype(np.float32)
    x = np.concatenate([_float32_sample(), grid])
    with np.errstate(all="ignore"):
        n = np.rint(x * (np.float32(1) / s))
        exact = n.astype(np.float64) * np.float64(s) - x.astype(np.float64) == 0
        div = x / s
    np.testing.assert_array_equal(n[exact].view(np.int32),
                                  div[exact].view(np.int32))
    assert exact[-grid.size:].all() == dyadic
    assert not exact[np.isnan(x) | np.isinf(x)].any()


def _epilogue32(acc, mult, rq):
    """The int8 body's 32-bit B3 path in numpy int32, and where it runs
    (elsewhere the body calls the int64 B3)."""
    s, zp = rq.act_shift, rq.act_zp
    assert rq.has_act and 0 <= s <= 31 and abs(zp * 2 ** s) < 2 ** 30
    p = (acc.astype(np.int64) * mult.astype(np.int64)).astype(np.int32)
    runs = (p >= -2 ** 30) & (p < 2 ** 30)
    if rq.relu:
        p = np.maximum(p, 0)
    v = p + np.int32(zp * 2 ** s)
    q = v >> s
    r = v.view(np.uint32) & np.uint32((1 << s) - 1 if s else 0)
    half = np.uint32(1 << (s - 1) if s else 1)
    up = {"FLOOR": np.zeros_like(r, bool), "CEIL": r != 0,
          "DOWN": (r != 0) & (v < 0), "ROUND_TO_ZERO": (r != 0) & (v < 0),
          "UP": (r != 0) & (v > 0),
          "HALF_UP": np.where(v >= 0, r >= half, r > half),
          "HALF_DOWN": np.where(v >= 0, r > half, r >= half),
          "ROUND": (r > half) | ((r == half) & (q % 2 != 0))}[rq.rounding_mode]
    q = np.clip(q + up.astype(np.int32), rq.act_lo, rq.act_hi)
    return (q - zp).astype(np.float32) * np.float32(rq.out_mul()), runs


@pytest.mark.parametrize("mode", ["ROUND", "CEIL", "FLOOR", "UP", "DOWN",
                                  "HALF_UP", "HALF_DOWN", "ROUND_TO_ZERO"])
@pytest.mark.parametrize("act_shift", [0, 1, 6, 31])
def test_32bit_b3_path_equals_the_twin(mode, act_shift):
    from repro_torch.kernels.requant import int_epilogue_plain
    rng = np.random.RandomState(act_shift)
    zp = 0 if act_shift == 31 else 3
    for relu in (False, True):
        rq = IntRequant(shift=act_shift + 4, relu=relu, has_act=True,
                        act_shift=act_shift, act_zp=zp, act_lo=-7, act_hi=700,
                        act_out_shift=4, rounding_mode=mode)
        acc = np.concatenate([rng.randint(-2 ** 27, 2 ** 27, 4000),
                              rng.randint(-3000, 3000, 4000),
                              np.arange(-70, 70) * 2 ** max(act_shift - 1, 0)]
                             ).astype(np.int32)
        mult = rng.randint(1, 16, acc.size).astype(np.int32)
        got, runs = _epilogue32(acc, mult, rq)
        want = int_epilogue_plain(torch.from_numpy(acc), torch.from_numpy(mult),
                                  rq).numpy()
        np.testing.assert_array_equal(got[runs], want[runs])
        assert runs.mean() > 0.5


# ------------------------------------------- B2: the lowering's proof

def _b2_segments(plan):
    return [s for s in plan.segments if "b2_body" in s.meta]


def test_lowering_marks_the_int8_fit_on_mobilenet_pointwise_layers():
    """MobileNet-w4a4's integer plan (img 32): each of the 13 pointwise
    convs is fed 4-bit codes and takes the int8 tensor-core body; the
    final MatMul stays on the float32 body."""
    plan = t_compile(tzoo.build_mobilenet(4, 4, img=32), device="cpu")
    pw = [s for s in plan.segments if s.kind == "quant_conv_int4"]
    assert len(pw) == 13
    for s in pw:
        assert s.meta["requant_path"] == "int32"
        assert s.meta["b2_body"] == "int8_mma"
        grid = plan.analysis.range(s.inputs[0]).grid
        z = float(np.asarray(grid.zero_point))
        assert max(abs(grid.int_lo - z), abs(grid.int_hi - z)) <= 127
    final = [s for s in plan.segments if s.kind == "quant_matmul_int4"]
    assert [s.meta["b2_body"] for s in final] == ["f32"]
    assert {s.meta["b2_body"] for s in _b2_segments(plan)} == {"int8_mma",
                                                                "f32"}


@pytest.mark.parametrize("key", ["TFC-w1a1", "TFC-w2a2"])
def test_lowering_keeps_imad_for_unsigned_8bit_codes(key):
    """TFC's first layer reads the 8-bit unsigned input codes (0 .. 255):
    no int8 fit, so it keeps the IMAD body; its later layers fit."""
    plan = t_compile(tzoo.ZOO[key](), device="cpu")
    segs = _b2_segments(plan)
    assert [s.meta["b2_body"] for s in segs] == ["imad"] + ["int8_mma"] * 3
    grid = plan.analysis.range(segs[0].inputs[0]).grid
    z = float(np.asarray(grid.zero_point))
    assert max(abs(grid.int_lo - z), abs(grid.int_hi - z)) > 127


def test_float32_tier_records_the_float32_body():
    plan = t_compile(tzoo.build_tfc(2, 2), device="cpu", use_analysis=False)
    assert {s.meta["b2_body"] for s in _b2_segments(plan)} == {"f32"}


def test_int8_plan_is_bit_exact_against_the_reference_plan():
    """CNV-w2a2's integer plan, whose int4 layers all take the int8 body,
    through the twins (which check the proof) equals the reference's."""
    from repro.core.compile import compile_graph as r_compile
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    plan = t_compile(tzoo.ZOO["CNV-w2a2"](), device="cpu")
    assert {s.meta["b2_body"] for s in _b2_segments(plan)} == {"int8_mma"}
    r_plan = r_compile(rzoo.ZOO["CNV-w2a2"](), use_fusion=False)
    np.testing.assert_array_equal(
        plan({"x": x})[plan.graph.output_names[0]].numpy(),
        np.asarray(r_plan({"x": x})[r_plan.graph.output_names[0]]))


# --------------------------------------------- B2: the twin's check

IN_SCALES = {"pow2": 2.0 ** -3, "dyadic": 3 * 2.0 ** -5}
SPEC = dict(shift=9, relu=True, has_act=True, act_shift=6, act_zp=0,
            act_lo=0, act_hi=15, act_out_shift=3, rounding_mode="HALF_UP")


def _codes_x(rng, shape, in_scale, lo=-127, hi=127):
    return torch.from_numpy(
        (rng.randint(lo, hi + 1, shape) * in_scale).astype(np.float32))


@pytest.mark.parametrize("bad", [128, -129, 300])
def test_twin_raises_on_a_code_outside_int8_when_promised(bad):
    rng = np.random.RandomState(5)
    s = IN_SCALES["dyadic"]
    x = _codes_x(rng, (6, 20), s)
    x[2, 3] = bad * s
    w = tops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (20, 7))
                                        .astype(np.int8)))
    mult = torch.ones(7, dtype=torch.int32)
    kw = dict(acc_dtype=torch.int32, requant=IntRequant(**SPEC), in_scale=s)
    with pytest.raises(ValueError, match="outside"):
        tops.quant_matmul_int4(x, w, mult, int8_codes=True, **kw)
    # without the promise the IMAD body's twin takes it
    tops.quant_matmul_int4(x, w, mult, **kw)
    x[2, 3] = 127 * s if bad > 0 else -128 * s
    tops.quant_matmul_int4(x, w, mult, int8_codes=True, **kw)


def test_int8_codes_needs_the_int32_body():
    x = torch.zeros(2, 8)
    w = torch.zeros(4, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="int32"):
        tops.quant_matmul_int4(x, w, 1.0, int8_codes=True)
    # B1, B5 and B6 accept the keyword and keep their bodies
    w8 = torch.zeros(8, 3, dtype=torch.int8)
    assert torch.equal(tops.quant_matmul(x, w8, 1.0, int8_codes=True),
                       tops.quant_matmul(x, w8, 1.0))


@pytest.mark.parametrize("kind", list(IN_SCALES))
@pytest.mark.parametrize("spec", [None, "act"])
def test_int8_twin_matches_reference_kernel(kind, spec):
    """B2's integer body with the proof, codes over all of int8, ragged
    shape, against the reference's Pallas kernel in interpret mode."""
    rng = np.random.RandomState(6)
    m, k, n, s = 13, 70, 9, IN_SCALES[kind]
    x = _codes_x(rng, (m, k), s)
    w = rng.randint(-8, 8, (k, n)).astype(np.int8)
    wk = tops.pack_int4(torch.from_numpy(w))
    if spec is None:
        sv = (2.0 ** -rng.randint(2, 6, n)).astype(np.float32)
        t_kw, r_kw = dict(acc_dtype=torch.int32, in_scale=s), \
            dict(acc_dtype=jnp.int32)
    else:
        sv = (2 * rng.randint(0, 5, n) + 1).astype(np.int32)
        t_kw = dict(acc_dtype=torch.int32, requant=IntRequant(**SPEC),
                    in_scale=s)
        r_kw = dict(acc_dtype=jnp.int32, requant=RIntRequant(**SPEC))
    got = tops.quant_matmul_int4(x, wk, torch.from_numpy(sv),
                                 int8_codes=True, **t_kw)
    # the reference's run closure divides before the kernel
    want = rops.quant_matmul_int4(
        jnp.asarray(x.numpy() / np.float32(s)), jnp.asarray(wk.numpy()),
        jnp.asarray(sv), interpret=True, **r_kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- B7: the bf16 body's roundings

FA_TOL = 2e-5          # the float32 bound, and the near-zero clause in bf16


def _emulate_bf16_body(q, k, v, causal):
    """B7's bf16 tensor-core body in float32 PyTorch: per key tile of 64,
    S = Q·K^T (exact products summed in float32), the scale with log2(e)
    folded in (float32(scale) · float32(log2 e), rounded to float32) after
    the dot, the -1e30 mask, the online softmax in exp2, P as bf16 hi + lo
    parts multiplied into a float32 accumulator, l summed from the float32
    p, and one rounding of acc / max(l, 1e-30) to bf16."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = np.float32(np.float32(1.0 / math.sqrt(hd))
                       * np.float32(1.4426950408889634))
    qf = q.float().reshape(B, KV, G, Sq, hd)
    kf, vf = k.float(), v.float()
    m = torch.full((B, KV, G, Sq), -1e30)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, hd))
    rows = torch.arange(Sq)
    for k0 in range(0, min(Sk, Sq) if causal else Sk, 64):
        kb, vb = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = torch.einsum("bkgqh,bkch->bkgqc", qf, kb) * torch.tensor(scale)
        if causal:
            keys = k0 + torch.arange(kb.shape[2])
            s = s.masked_fill(keys[None, :] > rows[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        acc = acc * corr[..., None] \
            + torch.einsum("bkgqc,bkch->bkgqh", p_hi, vb) \
            + torch.einsum("bkgqc,bkch->bkgqh", p_lo, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).to(torch.bfloat16)


def _bf16_steps(a, b):
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize("S", [17, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_body_roundings_fit_the_twin_bound(S, causal):
    """qwen2-1.5B's heads (12 over 2 KV, hd 128), bf16 inputs: the
    emulated body within one bf16 step of the twin, or within FA_TOL
    where both round a near-zero float32 value."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, S, 128))
                                .astype(np.float32)).to(torch.bfloat16)
               for h in (12, 2, 2))
    got = _emulate_bf16_body(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    diff = (got.float() - want.float()).abs()
    ok = (_bf16_steps(got, want) <= 1) | (diff <= FA_TOL)
    assert bool(ok.all()), f"{int((~ok).sum())} entries beyond the bound"
    # P's split leaves float32-level differences only
    assert float(diff.max()) <= 2.0 ** -7 * float(want.float().abs().max())
