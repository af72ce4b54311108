"""The vlm and moe families of the port against the reference, on the CPU
(llava-next-34b, deepseek-moe-16b, moonshot-v1-16b-a3b): the counterparts
of ``tests/test_arch_smoke.py``'s behaviours, with the reference's weights
carried over by ``params_from_reference``.

* full configs, ``param_count`` and ``active_param_count`` equal;
* SMOKE ``forward`` (with ``n_prefix`` and ``moe_aux``), ``prefill`` plus
  two ``decode_step``s (logits and every layer's cache), under FP32 and
  W8A8 with an 8-bit KV cache, float32 and bf16 activations, within
  ``torch_lm_parity.py``'s bounds.  The moe router's softmax differs from
  XLA's by an ulp here and there (``exp``), which can reorder two
  near-equal experts: moe logits are held with the W8A8 rule (a bounded
  share of entries beyond the tight bound), not bit for bit;
* decode matches forward at the last position (capacity 8.0, as the
  reference's test sets it: at the default a one-token decode step drops
  other choices than the prefill does);
* (the train steps are in ``test_torch_families_train.py``);
* ``greedy_generate`` with ``img_embeds`` and ``GenerationEngine`` equal
  to the reference's;
* ``moe_ffn`` against the reference's on seeded inputs: tokens dropped at
  capacity 1.25, B in {2, 6, 48} (G = gcd(B, 32)), tied router logits
  choosing the lower index, the per-expert scales bit-exact with a
  per-expert loop, the dispatch buffer bit-exact with the reference's.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as lp  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.quantize import layers as ref_layers  # noqa: E402
from repro.quantize.config import W8A8 as REF_W8A8  # noqa: E402
from repro.serve.generation import GenerationEngine as RefEngine  # noqa: E402
from repro.serve.generation import greedy_generate as ref_greedy  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.quantize import layers  # noqa: E402
from repro_torch.quantize.config import W8A8  # noqa: E402
from repro_torch.serve import GenerationEngine, greedy_generate  # noqa: E402

ARCHS = ("llava-next-34b", "deepseek-moe-16b", "moonshot-v1-16b-a3b")
# moonshot's SMOKE config is deepseek's under another name (the same
# shapes, experts and capacity): it runs one case of each behaviour
CASES = [(arch, recipe, dtype) for arch in ARCHS[:2]
         for recipe, dtype in (("fp32", "float32"), ("w8a8kv8", "float32"),
                               ("w8a8kv8", "bfloat16"))]
FORWARD_CASES = CASES + [("moonshot-v1-16b-a3b", "w8a8kv8", "bfloat16")]
DECODE_CASES = CASES + [("moonshot-v1-16b-a3b", "w8a8kv8", "float32")]
TIGHT = lp.TIGHT


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


def _assert_moe_logits(got, want, recipe, dtype):
    """moe: the W8A8 rule under every recipe (see the module docstring)."""
    lp.assert_logits(got, want, "w8a8kv8" if recipe == "fp32" else recipe, dtype)


def _assert_logits(cfg, got, want, recipe, dtype):
    if cfg.family == "moe":
        _assert_moe_logits(got, want, recipe, dtype)
    else:
        lp.assert_logits(got, want, recipe, dtype)


# ------------------------------------------------ configs and counts

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_counts_match_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    want = {k: v for k, v in dataclasses.asdict(ref_cfg).items() if k != "quant"}
    got = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "quant"}
    assert got == want
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    if cfg.family == "moe":
        assert cfg.active_param_count() < cfg.param_count()
    smoke = get_smoke_config(arch)
    ref_specs = jax.tree.leaves(ref_api.param_specs(lp.ref_smoke(arch)))
    assert smoke.param_count() == sum(int(np.prod(s.shape)) for s in ref_specs)
    names = set(api.param_shapes(smoke))
    assert ("img_proj" in names) == (cfg.family == "vlm")
    assert ("layers.0.moe.we_gate" in names) == (cfg.family == "moe")
    assert api.cache_specs(cfg, 4, 2048)["k"] == ref_api.cache_specs(
        ref_cfg, 4, 2048)["k"].shape[1:]


# ------------------------------------------------ forward, prefill, decode

@pytest.mark.parametrize("arch,recipe,dtype", FORWARD_CASES)
def test_forward_matches_reference(arch, recipe, dtype):
    rc, jp, pc, pp = lp.both_params(arch, recipe, dtype)
    arrays = dict(lp.frontend(rc, 2), tokens=lp.tokens(3, rc.vocab, (2, 9)))
    jb, tb = lp.batches(rc, pc, arrays)
    want, raux = _jit(ref_api.forward, "cfg")(jp, jb, rc)
    got, aux = api.forward(pp, tb, pc)
    assert got.shape == (2, 9 + api.n_prefix(pc), pc.vocab) and got.dtype == torch.float32
    assert aux["n_prefix"] == raux["n_prefix"] == api.n_prefix(pc)
    _assert_logits(pc, got, want, recipe, dtype)
    assert aux["moe_aux"].dtype == torch.float32
    if pc.family == "moe":
        rel = 1e-5 if dtype == "float32" else 1e-3
        assert float(aux["moe_aux"]) == pytest.approx(float(raux["moe_aux"]), rel=rel)
        assert float(aux["moe_aux"]) > 0
    else:
        assert float(aux["moe_aux"]) == 0.0


@pytest.mark.parametrize("arch,recipe,dtype", DECODE_CASES)
def test_prefill_and_decode_match_reference(arch, recipe, dtype):
    rc, jp, pc, pp = lp.both_params(arch, recipe, dtype)
    arrays = dict(lp.frontend(rc, 2), tokens=lp.tokens(4, rc.vocab, (2, 9)))
    jb, tb = lp.batches(rc, pc, arrays)
    n = 9 + api.n_prefix(pc)
    cache_len = n + 7
    want, rcache = _jit(ref_api.prefill, "cfg", "cache_len")(jp, jb, rc, cache_len)
    got, pcache = api.prefill(pp, tb, pc, cache_len)
    _assert_logits(pc, got, want, recipe, dtype)
    assert len(pcache) == pc.n_layers
    for i, layer in enumerate(pcache):
        assert layer["k"].shape == (2, cache_len, pc.n_kv_heads, pc.hd)
        for name in ("k", "v"):
            lp.assert_cache(layer[name], rcache[name][i], recipe, dtype)
    for idx in (n, n + 1):          # on the reference's own next tokens
        nxt = np.argmax(lp.f32(want), -1).astype(np.int32)[:, None]
        want, rcache = _jit(ref_api.decode_step, "cfg")(jp, rcache, jnp.asarray(nxt),
                                                         jnp.int32(idx), rc)
        got, pcache = api.decode_step(pp, pcache, torch.from_numpy(nxt), idx, pc)
        _assert_logits(pc, got, want, recipe, dtype)
        if dtype == "float32":
            for i, layer in enumerate(pcache):
                for name in ("k", "v"):
                    lp.assert_cache(layer[name][:, idx], rcache[name][i][:, idx], recipe,
                                    dtype)
        assert not pcache[0]["k"][:, idx + 1:].any()
    # bf16: one step's k / v are one token's projections of a residual that
    # already differs by bf16 steps (the reference keeps some bf16 sums in
    # float32), and under W8A8 an activation code flipped upstream moves a
    # projection by a code or two of that step's own scale (llava, layer 1:
    # 1.8 codes on one of its 64 entries).  So bf16 holds each step's rows
    # inside the whole cache, by the cache rule at the whole cache's scale
    for i, layer in enumerate(pcache):
        for name in ("k", "v"):
            lp.assert_cache(layer[name][:, :n + 2], rcache[name][i][:, :n + 2], recipe, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill + decode_step == forward at the last position (the port
    alone, as the reference's own test holds the reference)."""
    cfg = get_smoke_config(arch)
    if cfg.family == "moe":
        cfg = cfg.replace(moe_capacity_factor=8.0)      # no token drops
    params = api.init_params(3, cfg, "cpu")
    batch = api.make_batch(torch.Generator().manual_seed(3), cfg, 2, 8, "cpu")
    full, _ = api.forward(params, batch, cfg)
    n_prefix = api.n_prefix(cfg)
    pre = dict(batch, tokens=batch["tokens"][:, :7])
    _, cache = api.prefill(params, pre, cfg, 8 + n_prefix)
    logits, _ = api.decode_step(params, cache, batch["tokens"][:, 7:8], 7 + n_prefix, cfg)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].detach().numpy(),
                               atol=2e-3, rtol=1e-3)


def test_vlm_prefix_positions_and_cache_bound():
    """The image prefix takes positions 0..n_patches-1 (RoPE over S_total)
    and cache rows; a cache shorter than S_total raises."""
    rc, jp, pc, pp = lp.both_params("llava-next-34b", "fp32", "float32")
    arrays = dict(lp.frontend(rc, 1), tokens=lp.tokens(5, rc.vocab, (1, 4)))
    _, tb = lp.batches(rc, pc, arrays)
    _, cache = api.prefill(pp, tb, pc, 4 + pc.n_patches)
    assert cache[0]["k"][:, pc.n_patches - 1].any()
    with pytest.raises(ValueError, match="cannot take"):
        api.prefill(pp, tb, pc, 4 + pc.n_patches - 1)
    # without an image the vlm model is a plain decoder
    _, aux = api.forward(pp, {"tokens": tb["tokens"]}, pc)
    assert aux["n_prefix"] == 0


# ------------------------------------------------ generation

GEN_CASES = [("llava-next-34b", "fp32"), ("llava-next-34b", "w8a8kv8"),
             ("deepseek-moe-16b", "fp32"), ("deepseek-moe-16b", "w8a8kv8"),
             ("moonshot-v1-16b-a3b", "w8a8kv8")]


@pytest.mark.parametrize("arch,recipe", GEN_CASES)
def test_greedy_generate_matches_reference(arch, recipe):
    """With img_embeds for llava (decoding from S + n_patches)."""
    rc, jp, pc, pp = lp.both_params(arch, recipe, "float32")
    arrays = dict(lp.frontend(rc, 3), tokens=lp.tokens(5, rc.vocab, (3, 7)))
    jb, tb = lp.batches(rc, pc, arrays)
    want = _jit(ref_greedy, "cfg", "n_steps", "cache_len")(jp, rc, jb, n_steps=6)
    got = greedy_generate(pp, pc, tb, n_steps=6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["llava-next-34b", "deepseek-moe-16b"])
def test_generation_engine_matches_reference(arch):
    """Token prompts only, as the reference's engine (no image for vlm)."""
    rc, jp, pc, pp = lp.both_params(arch, "w8a8kv8", "float32")
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(1, rc.vocab, size=n).astype(np.int32), m)
            for n, m in ((4, 3), (9, 5))]
    ref_eng, eng = RefEngine(jp, rc, max_batch=2), GenerationEngine(pp, pc, max_batch=2)
    want = [ref_eng.submit(p, m) for p, m in reqs]
    got = [eng.submit(p, m) for p, m in reqs]
    ref_eng.run_pending()
    assert eng.run_pending() and not eng.queue
    for g, w, (_, m) in zip(got, want, reqs):
        assert g.result.shape == (m,)
        np.testing.assert_array_equal(g.result.numpy(), np.asarray(w.result))


# ------------------------------------------------ moe_ffn against the reference

def _moe_cfgs(capacity=1.25, recipe="fp32"):
    rc = lp.ref_smoke("deepseek-moe-16b").replace(moe_capacity_factor=capacity)
    pc = get_smoke_config("deepseek-moe-16b").replace(moe_capacity_factor=capacity)
    if recipe == "w8a8":
        rc, pc = rc.replace(quant=REF_W8A8), pc.replace(quant=W8A8)
    return rc, pc


def _moe_params(rc, pc, seed=0):
    tree = lp.reference_tree("deepseek-moe-16b")
    lt = jax.tree.map(lambda a: np.asarray(a)[seed % rc.n_layers], tree["layers"]["moe"])
    return jax.tree.map(jnp.asarray, lt), transformer.Params(
        {k: v.shape for k, v in lt.items()}, torch.float32, "cpu"), lt


def _moe_inputs(rc, pc, B, S, seed=0):
    jp, pp, lt = _moe_params(rc, pc, seed)
    for k, v in lt.items():
        getattr(pp, k).data.copy_(torch.from_numpy(v))
    x = np.random.default_rng(seed).standard_normal((B, S, rc.d_model)).astype(np.float32)
    return jp, pp, x


@pytest.mark.parametrize("recipe", ["fp32", "w8a8"])
@pytest.mark.parametrize("B", [2, 6, 48])
def test_moe_ffn_matches_reference_and_drops(B, recipe):
    """At capacity 1.25 tokens are dropped (some choice is not kept), and
    the output and aux match the jitted reference; G = gcd(B, 32)."""
    rc, pc = _moe_cfgs(1.25, recipe)
    S = 4
    jp, pp, x = _moe_inputs(rc, pc, B, S, seed=B)
    want, raux = _jit(ref_tf.moe_ffn, "cfg")(jnp.asarray(x), jp, rc)
    got, aux = transformer.moe_ffn(torch.from_numpy(x), pp, pc)
    G, Tl, C = transformer.moe_groups(B, S, pc)
    assert G == int(np.gcd(B, 32)) and Tl == B * S // G
    xg = torch.from_numpy(x).reshape(G, Tl, pc.d_model)
    _, top_i, _ = transformer.moe_route(xg, pp.router, pc)
    _, _, keep = transformer.moe_dispatch(xg, top_i, pc, C)
    assert not bool(keep.all())                  # some tokens dropped
    d = np.abs(got.numpy() - np.asarray(want))
    beyond = d > TIGHT * (1 + np.abs(np.asarray(want)))
    if recipe == "fp32":
        assert not beyond.any(), d.max()
    else:           # the W8A8 rule of torch_lm_parity.py
        assert beyond.mean() <= 0.01 and d.max() <= 0.05 * np.abs(np.asarray(want)).max()
    assert float(aux) == pytest.approx(float(raux), rel=TIGHT)


def test_moe_top_k_ties_choose_the_lower_index():
    """Tied router logits: lax.top_k and the port both take the lower
    expert index first (torch.topk does not promise this on CUDA)."""
    probs = torch.tensor([[[0.25, 0.125, 0.25, 0.25, 0.125]],
                          [[0.2, 0.2, 0.2, 0.2, 0.2]]])
    w, i = transformer.top_k_lower_index(probs, 3)
    rw, ri = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    assert i[0, 0].tolist() == [0, 2, 3] and i[1, 0].tolist() == [0, 1, 2]
    # through the router: two experts with identical columns tie everywhere
    rc, pc = _moe_cfgs()
    jp, pp, x = _moe_inputs(rc, pc, 2, 4)
    router = pp.router.data
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 2] + 10.0     # then 2 and 5 tie behind expert 6
    xg = torch.from_numpy(x).reshape(2, 4, pc.d_model)
    _, top_i, _ = transformer.moe_route(xg, pp.router, pc)
    r_probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(xg.numpy()),
                                        jnp.asarray(router.numpy())), -1)
    _, r_top = jax.lax.top_k(r_probs, pc.top_k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(r_top))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_expert_scales_bit_exact(dtype):
    """quant_weight_experts / quant_act_experts equal a per-expert loop of
    quant_weight / quant_act, and the reference's under vmap over E;
    qlinear_experts equals a loop of qlinear (within float32 order)."""
    td = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((5, 32, 24)) * 0.05).astype(np.float32)
    w[2] *= 40.0                        # one expert far larger than the rest
    x = rng.standard_normal((5, 12, 32)).astype(np.float32)
    x[:, 9:] = 0.0                      # padding rows count toward the amax
    x[3] *= 0.01
    tw, tx = torch.from_numpy(w).to(td), torch.from_numpy(x).to(td)
    gw = layers.quant_weight_experts(tw, W8A8.weights)
    gx = layers.quant_act_experts(tx, W8A8.acts)
    for e in range(5):
        assert torch.equal(gw[e], layers.quant_weight(tw[e], W8A8.weights)), e
        assert torch.equal(gx[e], layers.quant_act(tx[e], W8A8.acts)), e
    assert not torch.equal(gw, layers.quant_weight(tw, W8A8.weights))   # E is not reduced
    jd = getattr(jnp, dtype)
    rw = jax.jit(jax.vmap(lambda a: ref_layers.quant_weight(a, REF_W8A8.weights)))(
        jnp.asarray(w).astype(jd))
    rx = jax.jit(jax.vmap(lambda a: ref_layers.quant_act(a, REF_W8A8.acts)))(
        jnp.asarray(x).astype(jd))
    np.testing.assert_array_equal(lp.f32(gw), lp.f32(rw))
    np.testing.assert_array_equal(lp.f32(gx), lp.f32(rx))
    if dtype == "float32":
        y = layers.qlinear_experts(tx, tw, W8A8)
        for e in range(5):
            np.testing.assert_allclose(y[e].numpy(), layers.qlinear(tx[e], tw[e], recipe=W8A8)
                                       .numpy(), rtol=1e-6, atol=1e-6)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("B", [6])
def test_moe_dispatch_buffer_bit_exact(B):
    """The port's (E, G·C, D) buffer, viewed as the reference's
    (G, E, C, D), equals the reference's dispatch buffer (captured where
    it enters its expert constraint; the reference stops there)."""
    rc, pc = _moe_cfgs(1.25)
    S = 8
    jp, pp, x = _moe_inputs(rc, pc, B, S, seed=B + 1)
    seen = []

    def capture(buf, cfg):
        seen.append(np.asarray(buf))
        raise _Captured
    with mock.patch.object(ref_tf, "_constrain_experts", capture), \
            pytest.raises(_Captured):
        ref_tf.moe_ffn(jnp.asarray(x), jp, rc)
    G, Tl, C = transformer.moe_groups(B, S, pc)
    xg = torch.from_numpy(x).reshape(G, Tl, pc.d_model)
    _, top_i, _ = transformer.moe_route(xg, pp.router, pc)
    buf, _, keep = transformer.moe_dispatch(xg, top_i, pc, C)
    assert not bool(keep.all())
    got = buf.view(pc.n_experts, G, C, pc.d_model).permute(1, 0, 2, 3).numpy()
    assert got.shape == seen[0].shape
    np.testing.assert_array_equal(got, seen[0])


# ------------------------------------------------ launchers

@pytest.mark.parametrize("arch", ["llava-next-34b", "deepseek-moe-16b"])
def test_launchers_on_the_families(arch, tmp_path):
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                      "--max-new-tokens", "3"])
    assert out["requests"] == 3 and out["tokens"] == 9
    res = train.main(["--arch", arch, "--smoke", "--steps", "2", "--global-batch", "2",
                      "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert sorted(res["losses"]) == [1, 2]
    assert all(np.isfinite(v) and v > 0 for v in res["losses"].values())
