"""B7 (flash attention) on the CPU: the port's plain twin against the
reference's Pallas kernel (interpret mode) and its model-side
``chunked_attention``; the port's own ``chunked_attention`` (decode)
against the reference's; and the dispatch rule that sends the full-prefix
attention calls of ``forward`` / ``prefill`` to B7 and every other call to
the plain path.

Tolerances: float32 within 2e-5 (abs and rel), the reference's own
``tests/test_flash_attention.py`` bound; the sums run in other orders.
bf16 within one bf16 step of the reference, or 2e-5 where both round a
near-zero float32 value (the twin and the reference compute in float32
from the same bf16 inputs and round once, to nearest even).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.models.common import chunked_attention as ref_chunked  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402

TOL = 2e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_steps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 steps of two arrays of bf16 values (as float32)."""
    def key(x):
        i = (x.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(key(a) - key(b))


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        return
    ok = (_bf16_steps(got, want) <= 1) | (np.abs(got - want) <= TOL)
    assert ok.all(), f"{(~ok).sum()} entries beyond one bf16 step"


def _qkv(seed, B, H, KV, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, hd)).astype(np.float32))


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


# ------------------------------------------- the twin against the kernel

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4)])
def test_twin_matches_reference_kernel(dtype, hd, causal, H, KV):
    """At S multiples of the reference's blocks, interpret mode."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(hd + H, 1, H, KV, 128, 128, hd), dtype)
    want = ref_flash(jq, jk, jv, causal=causal, blocks=(64, 64))
    got = fa.flash_attention(tq, tk, tv, causal=causal)        # CPU: the twin
    assert got.dtype == DTYPES[dtype][1]
    assert_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_twin_matches_reference_kernel_other_blocks(causal):
    """Two batches, 256 rows, the reference's blocks (128, 64) against the
    twin's key tile of 64; non-causal also with Sk != Sq."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 2, 6, 2, 256, 256, 32), "float32")
    assert_close(_np(fa.flash_attention(tq, tk, tv, causal=causal)),
                 _np(ref_flash(jq, jk, jv, causal=causal, blocks=(128, 64))),
                 "float32")
    if not causal:
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(6, 1, 4, 2, 64, 192, 16), "float32")
        assert_close(_np(fa.flash_attention(tq, tk, tv, causal=False)),
                     _np(ref_flash(jq, jk, jv, causal=False, blocks=(64, 64))),
                     "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 17, 100, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_twin_matches_reference_chunked_attention_at_ragged_S(dtype, S, causal):
    """The reference's kernel needs whole blocks; its model-side attention
    (layout (B, S, H, hd)) does not, and computes the same function."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S, 2, 8, 2, S, S, 32), dtype)
    want = ref_chunked(jnp.moveaxis(jq, 1, 2), jnp.moveaxis(jk, 1, 2),
                       jnp.moveaxis(jv, 1, 2), causal=causal, chunk=48)
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert_close(_np(got), np.moveaxis(_np(want), 2, 1), dtype)


def test_cpu_wrapper_runs_the_twin_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 2, 9, 9, 16))
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    assert fa.launches == before
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :3], k, v)


# ------------------------------------- the plain path (decode) itself

@pytest.mark.parametrize("case", [
    dict(Sq=1, C=24, q_offset=10, kv_len=11, chunk=8),      # decode step
    dict(Sq=1, C=40, q_offset=33, kv_len=34, chunk=16),
    dict(Sq=3, C=24, q_offset=5, kv_len=8, chunk=8),        # a short chunk
    dict(Sq=1, C=24, q_offset=12, kv_len=13, chunk=8, window=4),
    dict(Sq=9, C=9, q_offset=0, kv_len=None, chunk=4, causal=False),
    dict(Sq=9, C=16, q_offset=0, kv_len=9, chunk=1024),     # prefill
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference(case, dtype):
    case = dict(case)
    Sq, C = case.pop("Sq"), case.pop("C")
    causal = case.pop("causal", True)
    rng = np.random.default_rng(Sq * 100 + C)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, Sq, 8, 16), (2, C, 2, 16), (2, C, 2, 16))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = ref_chunked(jq, jk, jv, causal=causal, **case)
    got = pcommon.chunked_attention(tq, tk, tv, causal=causal, **case)
    assert got.dtype == tq.dtype
    assert_close(_np(got), _np(want), dtype)


# ------------------------------------------------------ the dispatch rule

def test_takes_flash_rule():
    from repro_torch.models.transformer import takes_flash
    assert takes_flash(17, 0, 17)                # forward / prefill
    assert takes_flash(1, 0, 1)                  # a one-token prompt
    assert not takes_flash(1, 16, 17)            # decode
    assert not takes_flash(4, 16, 20)            # a chunk against a cache
    assert not takes_flash(17, 0, 20)            # more valid keys than queries


def test_prefill_and_forward_take_b7_decode_does_not(monkeypatch):
    """Spy on the model's B7 call: forward and prefill launch it once per
    layer with (B, H, S, hd) views; decode never does."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api, transformer
    cfg = get_smoke_config("qwen2-1.5b")
    params = api.init_params(0, cfg, "cpu")
    calls = []

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return fa.flash_attention(q, k, v, causal=causal)
    monkeypatch.setattr(transformer, "flash_attention", spy)
    toks = torch.randint(0, cfg.vocab, (2, 7), generator=torch.Generator().manual_seed(0))
    api.forward(params, {"tokens": toks}, cfg)
    assert calls == [((2, 4, 7, 16), (2, 2, 7, 16), True)] * cfg.n_layers
    calls.clear()
    logits, cache = api.prefill(params, {"tokens": toks}, cfg, 12)
    assert calls == [((2, 4, 7, 16), (2, 2, 7, 16), True)] * cfg.n_layers
    calls.clear()
    nxt = torch.argmax(logits, -1)[:, None]
    api.decode_step(params, cache, nxt, 7, cfg)
    assert calls == []
    monkeypatch.setattr(transformer, "takes_flash", lambda *a: False)
    api.prefill(params, {"tokens": toks}, cfg, 12)
    assert calls == []
