"""The port's straight-through estimators against the reference's
``custom_vjp`` (``repro.core.ste``), on the CPU.

* ``quant_ste``: ``gx`` equal bit for bit to the reference's gradient in
  float32 and bf16, in every rounding mode, signed, unsigned and narrow,
  with values at and beyond both clip edges; ``gs`` and ``gz`` within rel
  1e-5 in float32 (the sums run in another order), per-tensor and
  per-channel.  In bf16 the reference reduces ``gs`` / ``gz`` with bf16
  partial sums of its own (XLA's, which differ between its eager and
  jitted paths): there both sides must lie within the recursive-summation
  bound ``n·2^-8·Σ|t|`` of the exact sum of the bf16 products ``t``, and
  the port, which sums in float32 and rounds once, within one bf16
  rounding of it (ROADMAP C10).
* ``bipolar_quant_ste`` likewise.
* the gradient through ``quant_weight`` / ``quant_act`` (the dynamic
  max-abs scale) with tied maxima, against the jitted reference: both
  spread the max's gradient evenly over the ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.ste import bipolar_quant_ste as ref_bipolar  # noqa: E402
from repro.core.ste import quant_ste as ref_quant_ste  # noqa: E402
from repro.quantize import layers as ref_layers  # noqa: E402
from repro.quantize.config import W8A8 as REF_W8A8  # noqa: E402

from repro_torch.core import bipolar_quant_ste, fake_quant, quant_ste  # noqa: E402
from repro_torch.core.quant_ops import ROUNDING_MODES, quant  # noqa: E402
from repro_torch.quantize import layers  # noqa: E402
from repro_torch.quantize.config import W8A8  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_U = 2.0 ** -8
# (signed, narrow, bits): signed, signed narrow, unsigned, unsigned narrow
WIDTHS = [(True, False, 4), (True, True, 4), (False, False, 3), (False, True, 3)]


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _edge_x(rng, s, z, signed, narrow, bits, shape):
    """randn values plus x at, just inside and just beyond both clip
    edges (lo, hi in the integer domain, so x = s * (edge - z + d))."""
    lo = (-(2 ** (bits - 1)) + narrow) if signed else 0
    hi = (2 ** (bits - 1) - 1) if signed else 2 ** bits - 1 - narrow
    edges = [e - z + d for e in (lo, hi) for d in (-0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75)]
    x = rng.standard_normal(shape).astype(np.float32) * s * (hi - lo) / 2
    x.reshape(-1)[:len(edges)] = np.float32(s) * np.asarray(edges, np.float32)
    return x


def _vjp_both(x, s, z, g, dtype, signed, narrow, bits, mode):
    jd, td = DTYPES[dtype]
    fn = lambda a, b, c: ref_quant_ste(a, b, c, float(bits), signed, narrow, mode)
    y, vjp = jax.vjp(fn, *(jnp.asarray(v).astype(jd) for v in (x, s, z)))
    want = (y,) + vjp(jnp.asarray(g).astype(jd))
    tx, ts, tz = (torch.tensor(np.asarray(v)).to(td).requires_grad_() for v in (x, s, z))
    ty = quant_ste(tx, ts, tz, float(bits), signed, narrow, mode)
    ty.backward(torch.from_numpy(g).to(td))
    return want, (ty, tx.grad, ts.grad, tz.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ROUNDING_MODES)
def test_quant_ste_gx_bit_exact(dtype, mode):
    rng = np.random.default_rng(7)
    for signed, narrow, bits in WIDTHS:
        for s, z in ((0.25, 0.0), (0.375, 1.0 if signed else 2.0)):
            x = _edge_x(rng, s, z, signed, narrow, bits, (5, 12))
            g = rng.standard_normal(x.shape).astype(np.float32)
            (y, gx, _, _), (ty, tgx, _, _) = _vjp_both(
                x, np.float32(s), np.float32(z), g, dtype, signed, narrow, bits, mode)
            np.testing.assert_array_equal(f32(ty), f32(y))
            np.testing.assert_array_equal(f32(tgx), f32(gx))
            assert tgx.dtype == DTYPES[dtype][1]
            # the window is tested before rounding: just beyond an edge
            # rounds back onto it, and still takes no gradient
            assert (f32(tgx) == 0).sum() >= 4


def _sum_bound(g, elem_fn, shape, td):
    """Exact (float64) sums of the bf16 products t over the scale's
    broadcast, and the recursive-summation bound n·u·Σ|t|."""
    t = torch.from_numpy(g).to(td) * elem_fn()
    t64 = t.to(torch.float64)
    return t64.sum_to_size(shape).numpy(), (t64.abs().sum_to_size(shape) * (
        t.numel() / int(np.prod(shape) or 1)) * BF16_U).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_shape", [(), (1, 12)])
def test_quant_ste_scale_and_zero_point_gradients(dtype, scale_shape):
    rng = np.random.default_rng(3)
    for signed, narrow, bits in WIDTHS:
        s = (rng.uniform(0.1, 0.4, scale_shape)).astype(np.float32)
        z = np.full(scale_shape, 1.0 if signed else 2.0, np.float32)
        x = rng.standard_normal((6, 12)).astype(np.float32) * 1.5
        g = rng.standard_normal(x.shape).astype(np.float32)
        (_, _, gs, gz), (_, _, tgs, tgz) = _vjp_both(x, s, z, g, dtype, signed, narrow,
                                                     bits, "ROUND")
        assert tgs.shape == tuple(scale_shape) and tgz.shape == tuple(scale_shape)
        if dtype == "float32":
            for got, want in ((tgs, gs), (tgz, gz)):
                np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                           atol=1e-5 * np.abs(f32(want)).max())
            continue
        td = torch.bfloat16
        xs, ss, zs = (torch.tensor(np.asarray(v)).to(td) for v in (x, s, z))
        pre = xs / ss + zs
        lo = torch.tensor(float(-(2 ** (bits - 1)) + narrow) if signed else 0.0).to(td)
        hi = torch.tensor(float((2 ** (bits - 1) - 1) if signed else 2 ** bits - 1 - narrow)).to(td)
        inr = (pre >= lo) & (pre <= hi)
        q = torch.clamp(torch.round(pre), lo, hi)
        elem_s = lambda: torch.where(inr, (q - zs) - xs / ss, torch.where(pre < lo, lo - zs, hi - zs))
        elem_z = lambda: torch.where(inr, torch.zeros((), dtype=td), -ss)
        for got, want, elem in ((tgs, gs, elem_s), (tgz, gz, elem_z)):
            exact, bound = _sum_bound(g, elem, scale_shape, td)
            assert (np.abs(f32(want) - exact) <= bound + 1e-30).all()
            assert (np.abs(f32(got) - exact) <= BF16_U * np.abs(exact) + 1e-30).all()
            assert (np.abs(f32(got) - f32(want)) <= 2 * bound + 1e-30).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_shape", [(), (1, 10)])
def test_bipolar_quant_ste_matches_reference(dtype, scale_shape):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 10)).astype(np.float32) * 1.3
    x.reshape(-1)[:6] = [-1.0, 1.0, -1.0000001, 1.0000001, 0.0, -0.0]
    s = rng.uniform(0.5, 2.0, scale_shape).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    y, vjp = jax.vjp(ref_bipolar, jnp.asarray(x).astype(jd), jnp.asarray(s).astype(jd))
    gx, gs = vjp(jnp.asarray(g).astype(jd))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    ts = torch.from_numpy(s).to(td).requires_grad_()
    ty = bipolar_quant_ste(tx, ts)
    ty.backward(torch.from_numpy(g).to(td))
    np.testing.assert_array_equal(f32(ty), f32(y))
    np.testing.assert_array_equal(f32(tx.grad), f32(gx))
    assert ts.grad.shape == tuple(scale_shape)
    if dtype == "float32":
        np.testing.assert_allclose(f32(ts.grad), f32(gs), rtol=1e-5, atol=1e-6)
    else:
        sign = lambda: torch.where(torch.from_numpy(x).to(td) >= 0, 1.0, -1.0).to(td)
        exact, bound = _sum_bound(g, sign, scale_shape, td)
        assert (np.abs(f32(ts.grad) - exact) <= BF16_U * np.abs(exact) + 1e-30).all()
        assert (np.abs(f32(ts.grad) - f32(gs)) <= 2 * bound + 1e-30).all()


def test_fake_quant_ste_switch_and_no_grad_inputs():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 9)).astype(np.float32))
    want = quant(x, 0.0625, 0.0, 4, rounding_mode="HALF_UP")
    for ste in (True, False):
        got = fake_quant(x, 0.0625, bit_width=4, rounding_mode="HALF_UP", ste=ste)
        assert torch.equal(got, want)
    # Python-number scale and zero point: only x takes a gradient
    xg = x.clone().requires_grad_()
    fake_quant(xg, 0.0625, 1.0, bit_width=4).sum().backward()
    inside = (x / 0.0625 + 1.0 >= -8) & (x / 0.0625 + 1.0 <= 7)
    assert torch.equal(xg.grad, inside.float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_through_dynamic_scales_with_tied_maxima(dtype):
    """quant_weight (per-channel max-abs) and quant_act (per-tensor), and
    qlinear over both: tied maxima (equal values, and equal magnitudes of
    both signs) take the max's gradient evenly, as JAX's reduce_max
    spreads it."""
    jd, td = DTYPES[dtype]
    tol = 4 * BF16_U if dtype == "bfloat16" else 1e-5
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((16, 8)) * 0.05).astype(np.float32)
    w[3, 0] = w[9, 0] = 0.5                          # two equal maxima
    w[2, 1], w[5, 1], w[7, 1] = 0.25, -0.25, 0.25    # |.| tied across signs
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[0, 0, 0] = x[2, 4, 15] = -6.0                  # tied per-tensor max
    cases = ((ref_layers.quant_weight, layers.quant_weight, w, REF_W8A8.weights,
              W8A8.weights),
             (ref_layers.quant_act, layers.quant_act, x, REF_W8A8.acts, W8A8.acts))
    for ref_fn, port_fn, t, rtq, ptq in cases:
        g = rng.standard_normal(t.shape).astype(np.float32)
        _, vjp = jax.vjp(jax.jit(lambda a, f=ref_fn, q=rtq: f(a, q)), jnp.asarray(t).astype(jd))
        want = f32(vjp(jnp.asarray(g).astype(jd))[0])
        a = torch.from_numpy(t).to(td).requires_grad_()
        port_fn(a, ptq).backward(torch.from_numpy(g).to(td))
        got = f32(a.grad)
        # a max path given whole to one of the ties would miss by its half
        # share (about 1e-3 here) at both tied entries
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    g = rng.standard_normal((3, 5, 8)).astype(np.float32)
    _, vjp = jax.vjp(jax.jit(lambda a, b: ref_layers.qlinear(a, b, None, REF_W8A8)),
                     jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd))
    gx, gw = vjp(jnp.asarray(g).astype(jd))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).to(td).requires_grad_()
    layers.qlinear(tx, tw, None, W8A8).backward(torch.from_numpy(g).to(td))
    for got, want in ((f32(tx.grad), f32(gx)), (f32(tw.grad), f32(gw))):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
