"""Parity of repro_torch.core.quant_ops with the JAX reference (bit-exact).

The same numpy inputs, made from a seed, go through ``repro.core.quant_ops``
and its PyTorch counterpart; on normal floats the results must be equal bit
for bit.  Subnormal inputs are held against numpy instead of the reference,
whose CPU backend flushes them to zero (ROADMAP.md C1).
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import quant_ops as rq  # noqa: E402
from repro_torch.core import quant_ops as tq  # noqa: E402

MODES = rq.ROUNDING_MODES
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _x(seed=0, n=600, spread=4.0):
    """randn values plus exact .5 ties and signed zeros."""
    rng = np.random.RandomState(seed)
    ties = np.arange(-6, 7, dtype=np.float32) + 0.5
    x = np.concatenate([(rng.randn(n) * spread).astype(np.float32), ties,
                        np.array([0.0, -0.0, 1e-3, -1e-3], np.float32)])
    return x.astype(np.float32)


def _is_array(a):
    return isinstance(a, (np.ndarray, np.generic))


def _ref(fn, *args, **kw):
    return np.asarray(fn(*[jnp.asarray(a) if _is_array(a) else a
                           for a in args], **kw))


def _port(fn, *args, **kw):
    return fn(*[torch.from_numpy(np.array(a)) if _is_array(a) else a
                for a in args], **kw).numpy()


def test_rounding_mode_set_matches_reference():
    assert tq.ROUNDING_MODES == rq.ROUNDING_MODES


@pytest.mark.parametrize("mode", MODES)
def test_round_with_mode_bit_exact(mode):
    x = _x()
    np.testing.assert_array_equal(_port(tq.round_with_mode, x, mode),
                                  _ref(rq.round_with_mode, x, mode))


def test_round_with_mode_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown rounding_mode"):
        tq.round_with_mode(torch.zeros(3), "STOCHASTIC")


@pytest.mark.parametrize("mode", MODES)
def test_round_with_mode_subnormals_against_numpy(mode):
    """C1: torch keeps float32 subnormals; numpy is the oracle here."""
    tiny = np.float32(1.4e-45)
    x = np.array([tiny, -tiny, 3 * tiny, -5 * tiny, 1e-40, -1e-40],
                 np.float32)
    ref = {"ROUND": np.round, "CEIL": np.ceil, "FLOOR": np.floor,
           "DOWN": np.trunc, "ROUND_TO_ZERO": np.trunc,
           "UP": lambda v: np.sign(v) * np.ceil(np.abs(v)),
           "HALF_UP": lambda v: np.sign(v) * np.floor(np.abs(v) + 0.5),
           "HALF_DOWN": lambda v: np.sign(v) * np.ceil(np.abs(v) - 0.5)}[mode]
    np.testing.assert_array_equal(_port(tq.round_with_mode, x, mode), ref(x))


def _np_bounds(signed, narrow, bits):
    """Eqs. 2-3 from numpy's float32 exp2 (exact at integer widths)."""
    e = lambda v: np.exp2(np.float32(v))                   # noqa: E731
    one = np.float32(1)
    if signed:
        return (-e(np.float32(bits) - one) + (one if narrow else 0),
                e(np.float32(bits) - one) - one)
    return np.float32(0), e(bits) - one - (one if narrow else 0)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("narrow", [True, False])
def test_min_max_int_bit_exact(bits, signed, narrow):
    for fn_r, fn_t in ((rq.min_int, tq.min_int), (rq.max_int, tq.max_int)):
        a = np.asarray(fn_r(signed, narrow, bits))
        b = fn_t(signed, narrow, bits).numpy()
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.float32


@pytest.mark.parametrize("bits", [0.5, 6.5, 7.5, 13, 16, 24])
@pytest.mark.parametrize("signed", [True, False])
def test_min_max_int_against_numpy_exp2(bits, signed):
    """C4: the reference's float32 exp2 (XLA on the CPU computes it as
    exp(x * ln 2)) is up to 16 ulp off, and inexact even at integer widths
    >= 13 (2**13 -> 8192.004).  The port's torch.exp2 agrees with numpy's
    float32 exp2, so these widths are held against numpy."""
    for narrow in (True, False):
        lo, hi = _np_bounds(signed, narrow, bits)
        assert tq.min_int(signed, narrow, bits).item() == lo
        assert tq.max_int(signed, narrow, bits).item() == hi


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [1, 2, 4, 7.5, 8])
def test_quant_bit_exact(mode, bits):
    x = _x(seed=1)
    for signed in (True, False):
        for narrow in (True, False):
            zp = 0.0 if signed else 2.0
            kw = dict(signed=signed, narrow=narrow, rounding_mode=mode)
            np.testing.assert_array_equal(
                _port(tq.quant, x, np.float32(0.37), np.float32(zp),
                      np.float32(bits), **kw),
                _ref(rq.quant, x, np.float32(0.37), np.float32(zp),
                     np.float32(bits), **kw))


def test_quantize_int_channelwise_broadcast():
    rng = np.random.RandomState(2)
    x = rng.randn(5, 6).astype(np.float32) * 3
    s = (rng.rand(6).astype(np.float32) + 0.1)
    z = np.round(rng.randn(6)).astype(np.float32)
    bw = np.float32(4)
    np.testing.assert_array_equal(_port(tq.quantize_int, x, s, z, bw),
                                  _ref(rq.quantize_int, x, s, z, bw))
    q = _ref(rq.quantize_int, x, s, z, bw)
    np.testing.assert_array_equal(_port(tq.dequantize_int, q, s, z),
                                  _ref(rq.dequantize_int, q, s, z))


def test_bipolar_quant_bit_exact():
    x = _x(seed=3)
    for s in (np.float32(1.0), np.float32(0.25)):
        np.testing.assert_array_equal(_port(tq.bipolar_quant, x, s),
                                      _ref(rq.bipolar_quant, x, s))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("signed", [True, False])
def test_trunc_bit_exact(mode, signed):
    rng = np.random.RandomState(4)
    s, z = np.float32(0.125), np.float32(0.0)
    lo, hi = (-128, 127) if signed else (0, 255)
    x = (rng.randint(lo, hi + 1, size=300) * s).astype(np.float32)
    kw = dict(rounding_mode=mode, signed=signed)
    np.testing.assert_array_equal(
        _port(tq.trunc, x, s, z, np.float32(8), np.float32(4), **kw),
        _ref(rq.trunc, x, s, z, np.float32(8), np.float32(4), **kw))


def test_int_repr_bit_exact():
    x = _x(seed=5)
    a = _ref(rq.int_repr, x, np.float32(0.5), np.float32(0), np.float32(4))
    b = _port(tq.int_repr, x, np.float32(0.5), np.float32(0), np.float32(4))
    assert b.dtype == np.int8
    np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------ round_shift

def _fraction_round(fr: Fraction, mode: str) -> int:
    """Exact rational rounding, the oracle for round_shift."""
    sign = 1 if fr >= 0 else -1
    floor = fr.numerator // fr.denominator
    ceil = -((-fr.numerator) // fr.denominator)
    half = Fraction(1, 2)
    if mode == "FLOOR":
        return floor
    if mode == "CEIL":
        return ceil
    if mode in ("DOWN", "ROUND_TO_ZERO"):
        return int(fr)
    if mode == "UP":
        a = abs(fr)
        return sign * -((-a.numerator) // a.denominator)
    if mode == "ROUND":
        return round(fr)                    # ties to even
    a = abs(fr)
    if mode == "HALF_UP":
        v = a + half
        return sign * (v.numerator // v.denominator)
    v = a - half                            # HALF_DOWN
    return sign * -((-v.numerator) // v.denominator)


def _shift_inputs(shift: int) -> np.ndarray:
    rng = np.random.RandomState(shift)
    edges = [INT32_MIN, INT32_MIN + 1, -1, 0, 1, INT32_MAX - 1, INT32_MAX]
    vals = edges + list(rng.randint(INT32_MIN, INT32_MAX, size=64,
                                    dtype=np.int64))
    if shift:
        h = 1 << (shift - 1)
        for k in (-3, -2, -1, 0, 1, 2):     # exact ties around small values
            t = k * (1 << shift) + h
            if INT32_MIN <= t <= INT32_MAX:
                vals.append(t)
            if INT32_MIN <= -t <= INT32_MAX:
                vals.append(-t)
    return np.asarray(vals, np.int32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shift", [0, 1, 3, 7, 16, 30, 31])
def test_round_shift_full_int32_range(mode, shift):
    p = _shift_inputs(shift)
    port = tq.round_shift(torch.from_numpy(p), shift, mode)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(rq.round_shift(jnp.asarray(p), shift, mode)))
    oracle = [_fraction_round(Fraction(int(v), 1 << shift), mode) for v in p]
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(oracle, np.int64))


def test_round_shift_rejects_bad_arguments():
    p = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tq.round_shift(p, -1)
    with pytest.raises(ValueError):
        tq.round_shift(p, 2, "NEAREST")
