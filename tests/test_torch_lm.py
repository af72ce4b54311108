"""The LM serving slice of the port against the reference, on the CPU.

* ``quant_weight``, ``quant_act`` and ``quant_kv`` (and the Quant forward
  and the straight-through backward of ``quant_ste``) bit-exact in float32 and in bf16 against the reference
  under ``jax.jit``, as every model path runs it (there XLA multiplies by
  the float32 reciprocal of the constant bound where the code divides by
  it: ROADMAP C7);
* the SMOKE configs of qwen2, olmo and starcoder2-3b, with the reference's
  weights carried over by ``params_from_reference``: ``forward`` logits,
  ``prefill`` logits and KV cache, and ``decode_step`` logits and cache,
  under the FP32 recipe and under W8A8 with an 8-bit KV cache, in float32
  and in bf16 activations (tolerances in ``torch_lm_parity.py``);
* configs, parameter shapes and counts, the seeded init, the cache
  layout, and the launcher.

``greedy_generate`` and ``GenerationEngine`` are in
``test_torch_generation.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as lp  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.ste import quant_ste as ref_quant_ste  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.quantize import layers as ref_layers  # noqa: E402
from repro.quantize.config import W4A4 as REF_W4A4  # noqa: E402
from repro.quantize.config import W8A8 as REF_W8A8  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.ste import fake_quant, quant_ste  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.quantize import layers  # noqa: E402
from repro_torch.quantize.config import W4A4, W8A8  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(arch, recipe, dtype) for arch in lp.ARCHS
         for recipe, dtype in (("fp32", "float32"), ("w8a8kv8", "float32"),
                               ("w8a8kv8", "bfloat16"))]


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


# ------------------------------------------------ the quant functions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("recipe", ["w8a8", "w4a4"])
@pytest.mark.parametrize("shape", [(4, 33, 64), (1, 7, 1536)])
def test_quant_weight_and_act_bit_exact(dtype, recipe, shape):
    ref_r, port_r = (REF_W8A8, W8A8) if recipe == "w8a8" else (REF_W4A4, W4A4)
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:5] = [0.0, -0.0, 1e-9, 7.25, -7.25]
    w = (rng.standard_normal((shape[-1], 96)) * 0.02).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    for ref_fn, port_fn, a, b, tq, rtq in (
            (ref_layers.quant_act, layers.quant_act, jx, tx, port_r.acts, ref_r.acts),
            (ref_layers.quant_weight, layers.quant_weight, jw, tw, port_r.weights,
             ref_r.weights)):
        got = port_fn(b, tq)
        assert got.dtype == b.dtype
        want = jax.jit(ref_fn, static_argnums=1)(a, rtq)
        np.testing.assert_array_equal(lp.f32(got), lp.f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_kv_bit_exact(dtype, bits):
    rng = np.random.default_rng(bits)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = (rng.standard_normal((2, 9, 2, 16)) * 5).astype(np.float32)
    (jk, tk), (jv, tv) = _pair(k, dtype), _pair(v, dtype)
    got = layers.quant_kv(tk, tv, bits)
    want = jax.jit(ref_layers.quant_kv, static_argnums=2)(jk, jv, bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(lp.f32(g), lp.f32(w))
    assert layers.quant_kv(tk, tv, None) == (tk, tv)


def test_qlinear_and_qeinsum_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    for ref_r, port_r in ((None, None), (REF_W8A8, W8A8)):
        want = ref_layers.qlinear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), ref_r)
        got = layers.qlinear(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), port_r)
        np.testing.assert_allclose(lp.f32(got), lp.f32(want), rtol=1e-5, atol=1e-5)
        want = ref_layers.qeinsum("bsk,kn->bsn", jnp.asarray(x), jnp.asarray(w), ref_r)
        got = layers.qeinsum("bsk,kn->bsn", torch.from_numpy(x), torch.from_numpy(w), port_r)
        np.testing.assert_allclose(lp.f32(got), lp.f32(want), rtol=1e-5, atol=1e-5)


def test_quant_ste_forward_and_backward():
    """The Quant forward of quant_ste bit for bit, and its straight-through
    backward against the reference's custom_vjp (the full comparison is
    in test_torch_ste.py)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    s = np.float32(0.0625)
    fn = lambda a, b: ref_quant_ste(a, b, jnp.float32(0), 4.0, True, False, "HALF_UP")
    want, vjp = jax.vjp(fn, jnp.asarray(x), jnp.float32(s))
    g = rng.standard_normal(x.shape).astype(np.float32)
    want_gx, want_gs = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.tensor(s).requires_grad_()
    got = quant_ste(tx, ts, torch.tensor(0.0), 4.0, True, False, "HALF_UP")
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert torch.equal(fake_quant(torch.from_numpy(x), torch.tensor(s), bit_width=4,
                                  rounding_mode="HALF_UP"), got.detach())
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_gx))
    np.testing.assert_allclose(float(ts.grad), float(want_gs), rtol=1e-5)
    assert (tx.grad == 0).any() and (tx.grad != 0).any()     # both sides of the window


# ------------------------------------------------ the models, carried weights

@pytest.mark.parametrize("arch,recipe,dtype", CASES)
def test_forward_matches_reference(arch, recipe, dtype):
    rc, jp, pc, pp = lp.both_params(arch, recipe, dtype)
    toks = lp.tokens(3, rc.vocab, (2, 9))
    want, _ = jax.jit(ref_api.forward, static_argnames="cfg")(
        jp, {"tokens": jnp.asarray(toks)}, rc)
    got, aux = api.forward(pp, {"tokens": torch.from_numpy(toks)}, pc)
    assert got.dtype == torch.float32 and aux["n_prefix"] == 0
    lp.assert_logits(got, want, recipe, dtype)


@pytest.mark.parametrize("arch,recipe,dtype", CASES)
def test_prefill_and_decode_match_reference(arch, recipe, dtype):
    rc, jp, pc, pp = lp.both_params(arch, recipe, dtype)
    toks = lp.tokens(4, rc.vocab, (2, 9))
    want, rcache = jax.jit(ref_api.prefill, static_argnames=("cfg", "cache_len"))(
        jp, {"tokens": jnp.asarray(toks)}, rc, 16)
    got, pcache = api.prefill(pp, {"tokens": torch.from_numpy(toks)}, pc, 16)
    lp.assert_logits(got, want, recipe, dtype)
    assert len(pcache) == pc.n_layers
    for i, layer in enumerate(pcache):
        assert layer["k"].shape == (2, 16, pc.n_kv_heads, pc.hd)
        assert layer["k"].dtype == pc.act_dtype
        for name in ("k", "v"):
            lp.assert_cache(layer[name], rcache[name][i], recipe, dtype)
    # two decode steps on the reference's own next tokens
    for idx in (9, 10):
        nxt = np.argmax(lp.f32(want), -1).astype(np.int32)[:, None]
        want, rcache = jax.jit(ref_api.decode_step, static_argnames="cfg")(
            jp, rcache, jnp.asarray(nxt), jnp.int32(idx), rc)
        got, pcache = api.decode_step(pp, pcache, torch.from_numpy(nxt), idx, pc)
        lp.assert_logits(got, want, recipe, dtype)
        for i, layer in enumerate(pcache):
            for name in ("k", "v"):
                lp.assert_cache(layer[name][:, idx], rcache[name][i][:, idx], recipe,
                                dtype)
        assert not pcache[0]["k"][:, idx + 1:].any()


# ------------------------------------------------ configs, params, cache

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmo-1b", "starcoder2-3b",
                                  "starcoder2-7b"])
def test_configs_and_param_counts_match_reference(arch):
    ref_cfg = ref_get_config(arch)
    cfg = get_config(arch)
    want = {k: v for k, v in dataclasses.asdict(ref_cfg).items() if k != "quant"}
    got = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "quant"}
    assert got == want
    assert cfg.act_dtype == torch.bfloat16 and cfg.p_dtype == torch.float32
    assert cfg.param_count() == ref_cfg.param_count()
    smoke = get_smoke_config(arch)
    ref_specs = jax.tree.leaves(ref_api.param_specs(lp.ref_smoke(arch)))
    assert smoke.param_count() == sum(int(np.prod(s.shape)) for s in ref_specs)
    assert api.cache_specs(cfg, 4, 2048)["k"] == ref_api.cache_specs(
        ref_cfg, 4, 2048)["k"].shape[1:]


def test_unported_archs_and_families_raise():
    """No arch or family is left to port: the hybrid and ssm families
    (recurrentgemma-2b, rwkv6-7b) resolve and build
    (tests/test_torch_ssm_hybrid.py holds them against the reference);
    an unknown arch or family raises ValueError."""
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = get_smoke_config(arch)
        assert get_config(arch).family == cfg.family in ("ssm", "hybrid")
        params = api.init_params(0, cfg, "cpu")
        assert set(dict(params.named_parameters())) == set(api.param_shapes(cfg))
        assert api.shape_applicable(cfg, "long_500k") is None      # sub-quadratic
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-17")
    # a family the decoder-only module does not hold names its module
    for family, module in (("ssm", "rwkv6"), ("hybrid", "rglru"), ("audio", "encdec")):
        cfg = get_smoke_config("qwen2-1.5b").replace(family=family)
        with pytest.raises(ValueError, match=f"models/{module}.py"):
            transformer.param_shapes(cfg)
    with pytest.raises(ValueError, match="unknown family"):
        api.param_shapes(get_smoke_config("qwen2-1.5b").replace(family="cnn"))
    cfg = get_smoke_config("qwen2-1.5b")
    assert api.shape_applicable(cfg, "long_500k") is not None
    assert api.shape_applicable(cfg, "prefill_32k") is None


def test_seeded_init_draws_the_reference_distribution():
    cfg = get_smoke_config("qwen2-1.5b").replace(n_layers=1, d_model=256, d_ff=512,
                                                 vocab=10000)
    a = api.init_params(7, cfg, "cpu")
    b = api.init_params(torch.Generator().manual_seed(7), cfg, "cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
        assert not pa.requires_grad
        if pa.ndim == 1:
            assert not pa.any(), name
    w = a.layers[0].ffn.w_gate                    # fan_in 256: std 1/16
    std = min(0.02, 256 ** -0.5) * 0.8796         # trunc-normal at +-2
    assert abs(float(w.std()) - std) < 0.03 * std
    assert float(w.abs().max()) <= 2 * 0.02
    e = a.embed                                   # fan_in = vocab: std 1/100
    assert abs(float(e.std()) - 0.01 * 0.8796) < 0.03 * 0.01


def test_params_from_reference_round_trip_and_shape_check():
    arch = "starcoder2-3b"                        # layernorm (g, b), no bias
    tree = lp.reference_tree(arch)
    cfg = get_smoke_config(arch)
    p = api.params_from_reference(tree, cfg, "cpu")
    assert torch.equal(p.layers[1].attn_norm.g,
                       torch.tensor(np.asarray(tree["layers"]["attn_norm"][0][1])))
    assert torch.equal(p.lm_head, torch.tensor(np.asarray(tree["lm_head"])))
    names = {n for n, _ in p.named_parameters()}
    assert names == set(api.param_shapes(cfg))
    bad = dict(tree, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        api.params_from_reference(bad, cfg, "cpu")


def test_make_batch_and_init_cache():
    cfg = get_smoke_config("olmo-1b")
    batch = api.make_batch(torch.Generator().manual_seed(0), cfg, 3, 5, "cpu")
    assert batch["tokens"].shape == (3, 5) and batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < cfg.vocab
    cache = api.init_cache(cfg, 3, 11, "cpu")
    assert len(cache) == cfg.n_layers
    assert cache[0]["v"].shape == (3, 11, cfg.n_kv_heads, cfg.hd)
    assert cache[0]["v"].dtype == torch.float32


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = get_smoke_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.make_batch(torch.Generator().manual_seed(0), cfg, 1, 4)


# ------------------------------------------------ the launcher

def test_serve_launcher_smoke_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new-tokens", "4"])
    assert out["requests"] == 3 and out["tokens"] == 12
    # the compiled-graph, tuning and mesh flags serve now
    # (tests/test_torch_serve_tier.py, tests/test_torch_tune.py,
    # tests/test_torch_mesh_serve.py; the LM path takes no tuning and runs
    # under its own elastic mesh, as the reference's); an LM mesh of more
    # than one entry needs one process per device, under torchrun
    for flag in (["--mesh"], ["--mesh", "--tune", "cached"]):
        out = serve.main(["--smoke", "--device", "cpu", "--requests", "1",
                          "--max-new-tokens", "2"] + flag)
        assert out["requests"] == 1
    for flag in (["--devices", "2"], ["--devices", "2", "--tune-cache-dir", "x"]):
        with pytest.raises(RuntimeError, match="torchrun"):
            serve.main(["--smoke", "--device", "cpu"] + flag)
    out = serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                      "--requests", "1", "--max-new-tokens", "2",
                      "--tune", "cached", "--tune-cache-dir", "unused"])
    assert out["requests"] == 1
