"""Kernel parity: each port kernel's plain twin against the reference's
Pallas kernel (run as the reference's own tests run it on the CPU, in
interpret mode).  The CUDA kernels against their twins on a GPU are in
``test_torch_kernels_cuda.py``.

Tolerances: B4 (quant_dequant) is bit-exact.  B1/B2 (quant_matmul[_int4])
are bit-exact on integer / dyadic activations, where every float32 partial
sum is exact whatever the summation order; on ``randn`` activations the
order differs (XLA's dot against torch's), so the bound is
``1e-6 · (|x| @ |w|) · |s|`` elementwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_dequant as tqdq  # noqa: E402

MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP", "HALF_DOWN",
         "ROUND_TO_ZERO")


def _acts(seed, shape, spread=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * spread).astype(np.float32)
    flat = x.reshape(-1)
    flat[:13] = np.arange(-6, 7, dtype=np.float32) * 0.5    # exact ties
    return x


# ------------------------------------------------------------------- B4

def _qdq_both(x, s, z, **kw):
    ref = np.asarray(rops.quant_dequant(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(z), **kw))
    port = tops.quant_dequant(torch.from_numpy(x), torch.from_numpy(s),
                              torch.from_numpy(z), **kw).numpy()
    return ref, port


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits,signed,narrow", [
    (8, True, False), (4, True, True), (2, False, False), (7.5, True, False),
    (1, False, False)])
def test_quant_dequant_twin_bit_exact(mode, bits, signed, narrow):
    x = _acts(0, (9, 40))
    s, z = np.float32(0.5), np.float32(0.0 if signed else 1.0)
    ref, port = _qdq_both(x, np.asarray(s), np.asarray(z), bit_width=bits,
                          signed=signed, narrow=narrow, rounding_mode=mode)
    assert port.dtype == np.float32 and port.shape == x.shape
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("emit_codes", [False, True])
def test_quant_dequant_twin_channelwise(emit_codes):
    rng = np.random.RandomState(1)
    x = _acts(1, (3, 5, 24))
    s = (rng.rand(24) * 0.5 + 0.05).astype(np.float32)
    z = np.round(rng.randn(24)).astype(np.float32)
    ref, port = _qdq_both(x, s, z, bit_width=4, signed=True,
                          emit_codes=emit_codes)
    assert port.dtype == (np.int8 if emit_codes else np.float32)
    np.testing.assert_array_equal(port, ref)


def test_quant_dequant_twin_makes_no_launch():
    before = tops.launch_counts()["quant_dequant"]
    tops.quant_dequant(torch.ones(4, 4), 0.5, 0.0)
    assert tops.launch_counts()["quant_dequant"] == before


def test_quant_dequant_rejects_bad_params():
    with pytest.raises(ValueError, match="rounding_mode"):
        tops.quant_dequant(torch.ones(2, 3), 1.0, 0.0, rounding_mode="NEAR")
    with pytest.raises(ValueError, match="scale"):
        tops.quant_dequant(torch.ones(2, 3), torch.ones(2), 0.0)


@pytest.mark.parametrize("bits,signed,narrow", [
    (8, True, False), (8, True, True), (8, False, True), (7.5, True, False),
    (1, True, False)])
def test_static_bounds_match_reference(bits, signed, narrow):
    from repro.kernels.quant_dequant import _static_bounds
    assert tqdq.static_bounds(signed, narrow, bits) == \
        _static_bounds(signed, narrow, bits)


# -------------------------------------------------------------- B1 / B2

def _weights(seed, k, n, lo=-7, hi=7):
    return np.random.RandomState(seed).randint(lo, hi + 1, (k, n)).astype(
        np.int8)


def _mm_both(int4, x, w, s, b=None):
    if int4:
        wp = np.array(rops.pack_int4(jnp.asarray(w)))
        ref = rops.quant_matmul_int4(jnp.asarray(x), jnp.asarray(wp),
                                     jnp.asarray(s),
                                     None if b is None else jnp.asarray(b))
        port = tops.quant_matmul_int4(torch.from_numpy(x),
                                      torch.from_numpy(wp),
                                      torch.from_numpy(s),
                                      None if b is None else
                                      torch.from_numpy(b))
    else:
        ref = rops.quant_matmul(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(s),
                                None if b is None else jnp.asarray(b))
        port = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(s),
                                 None if b is None else torch.from_numpy(b))
    return np.asarray(ref), port.numpy()


SHAPES = [(1, 784, 64), (8, 64, 64), (13, 98, 10), (5, 64, 10)]


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_matmul_twin_exact_on_dyadic(int4, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = (rng.randint(-128, 129, (m, k)) / 128.0).astype(np.float32)
    w = _weights(k, k, n)
    s = (2.0 ** -rng.randint(2, 6, n)).astype(np.float32)
    b = (rng.randint(-64, 64, n) / 16.0).astype(np.float32)
    ref, port = _mm_both(int4, x, w, s, b)
    assert port.shape == (m, n) and port.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_matmul_twin_randn_within_order_bound(int4, m, k, n):
    rng = np.random.RandomState(7 + m)
    x = rng.randn(m, k).astype(np.float32)
    w = _weights(k + 1, k, n)
    s = np.float32(0.0173)
    ref, port = _mm_both(int4, x, w, np.asarray(s))
    bound = 1e-6 * (np.abs(x) @ np.abs(w.astype(np.float32))) * abs(s)
    assert np.all(np.abs(port - ref) <= bound)


def test_quant_matmul_twin_scalar_scale_no_bias():
    x = _acts(3, (6, 32))
    w = _weights(3, 32, 12, -127, 127)
    ref, port = _mm_both(False, x, w, np.asarray(np.float32(0.25)))
    bound = 1e-6 * (np.abs(x) @ np.abs(w.astype(np.float32))) * 0.25
    assert np.all(np.abs(port - ref) <= bound)


def test_pack_unpack_int4_roundtrip_and_reference_bits():
    w = _weights(11, 64, 24, -8, 7)
    packed = tops.pack_int4(torch.from_numpy(w))
    assert packed.dtype == torch.int8 and packed.shape == (32, 24)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(rops.pack_int4(jnp.asarray(w))))
    np.testing.assert_array_equal(tops.unpack_int4(packed).numpy(), w)
    np.testing.assert_array_equal(
        tops.unpack_int4(packed).numpy(),
        np.asarray(rops.unpack_int4(jnp.asarray(packed.numpy()))))


def test_pack_int4_rejects_odd_k():
    with pytest.raises(ValueError, match="even"):
        tops.pack_int4(torch.zeros(3, 4, dtype=torch.int8))


def test_unported_matmul_options_raise():
    """Every body is ported; what raises is an option no body takes."""
    from repro_torch.kernels.requant import IntRequant
    x, w = torch.zeros(2, 4), torch.zeros(4, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="acc_dtype"):
        tops.quant_matmul(x, w, 1.0, acc_dtype=torch.float16)
    with pytest.raises(ValueError, match="needs acc_dtype=torch.int32"):
        tops.quant_matmul_int4(x, w[:2], 1, requant=IntRequant(shift=1))
    with pytest.raises(TypeError, match="IntRequant"):
        tops.quant_matmul(x, w, 1, acc_dtype=torch.int32, requant=object())
    with pytest.raises(ValueError, match="in_scale"):
        tops.quant_matmul(x, w, 1.0, in_scale=0.5)
    with pytest.raises(ValueError, match="out of range"):
        tops.quant_matmul(x, w, 1, acc_dtype=torch.int32,
                          requant=IntRequant(shift=1, act_shift=40))
    with pytest.raises(ValueError, match="K mismatch"):
        tops.quant_matmul(x, w[:3], 1.0)
