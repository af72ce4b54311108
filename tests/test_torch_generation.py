"""LM generation of the port against the reference, on the CPU:
``greedy_generate`` tokens and ``GenerationEngine`` results (slots of
``max_batch``, prompts left-padded with token 0, per-request token
counts) on the SMOKE configs of qwen2, olmo and starcoder2-3b with the
reference's weights carried over, under the FP32 recipe and under W8A8
with an 8-bit KV cache (float32 activations), and qwen2 in bf16.

Greedy tokens are compared for equality: the logits agree within the
tolerances of ``torch_lm_parity.py``, and at this data no argmax is that
close to a tie (``test_greedy_margins_exceed_the_tolerance`` checks it,
so a future equality failure shows whether it is a near-tie or a fault).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as lp  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.serve.generation import GenerationEngine as RefEngine  # noqa: E402
from repro.serve.generation import greedy_generate as ref_greedy  # noqa: E402

from repro_torch.serve import GenerationEngine, greedy_generate  # noqa: E402

CASES = [(arch, recipe, "float32") for arch in lp.ARCHS
         for recipe in ("fp32", "w8a8kv8")] + [("qwen2-1.5b", "w8a8kv8", "bfloat16")]


@pytest.mark.parametrize("arch,recipe,dtype", CASES)
def test_greedy_generate_matches_reference(arch, recipe, dtype):
    rc, jp, pc, pp = lp.both_params(arch, recipe, dtype)
    toks = lp.tokens(5, rc.vocab, (3, 7))
    want = jax.jit(ref_greedy, static_argnames=("cfg", "n_steps", "cache_len"))(
        jp, rc, {"tokens": jnp.asarray(toks)}, n_steps=6)
    got = greedy_generate(pp, pc, {"tokens": torch.from_numpy(toks)}, n_steps=6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,recipe,dtype", CASES)
def test_generation_engine_matches_reference(arch, recipe, dtype):
    rc, jp, pc, pp = lp.both_params(arch, recipe, dtype)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(1, rc.vocab, size=n).astype(np.int32), m)
            for n, m in ((4, 3), (9, 5), (6, 2), (3, 4), (11, 1))]
    ref_eng = RefEngine(jp, rc, max_batch=2)
    eng = GenerationEngine(pp, pc, max_batch=2)
    want = [ref_eng.submit(p, m) for p, m in reqs]
    got = [eng.submit(p, m) for p, m in reqs]
    ref_eng.run_pending()
    assert eng.run_pending() and not eng.queue
    for g, w, (_, m) in zip(got, want, reqs):
        assert g.result.shape == (m,) and g.result.dtype == torch.int32
        np.testing.assert_array_equal(g.result.numpy(), np.asarray(w.result))


def test_greedy_margins_exceed_the_tolerance():
    """Every greedy step of the float32 cases above has a top-2 logit gap
    wider than twice the tight logit bound (1e-5, abs + rel), so equal
    tokens are the expected outcome, not luck."""
    for arch, recipe, dtype in CASES:
        if dtype != "float32":
            continue
        rc, jp, pc, pp = lp.both_params(arch, recipe, dtype)
        toks = jnp.asarray(lp.tokens(5, rc.vocab, (3, 7)))
        logits, cache = jax.jit(ref_api.prefill, static_argnames=("cfg", "cache_len"))(
            jp, {"tokens": toks}, rc, 13)
        gaps = []
        for idx in range(7, 12):
            top = np.sort(np.asarray(logits), -1)
            gaps.append(top[:, -1] - top[:, -2])
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            logits, cache = jax.jit(ref_api.decode_step, static_argnames="cfg")(
                jp, cache, nxt, jnp.int32(idx), rc)
        assert np.min(gaps) > 2 * lp.TIGHT * (1 + np.abs(np.asarray(logits)).max()), \
            (arch, recipe, np.min(gaps))
