"""The ssm and hybrid families of the port (``models/rwkv6.py``, rwkv6-7b;
``models/rglru.py``, recurrentgemma-2b) against the reference, on the
CPU, with the reference's weights carried over by
``params_from_reference`` (``torch_lm_parity.reference_tree``: every
vector, the hybrid's group-stacked ones too, redrawn from N(0, 0.1)):

* the full configs, ``param_count`` and the SMOKE parameter counts equal;
  every layer's cache shape equal to the reference's; all ten archs
  resolve (``test_torch_lm.py`` holds the raises that remain);
* SMOKE ``forward`` under FP32 and W8A8; under FP32 ``prefill`` of 12 tokens then
  decode steps to 20 with every layer's cache (``tm_shift``, ``wkv``,
  ``cm_shift``; ``h``, ``conv``, the ring ``k`` / ``v``).  The hybrid's
  prompt is longer than SMOKE's window of 8, so the prefill rolls the
  ring and the decode wraps it; each decode step also matches the
  reference's forward at its position (the reference's own decode test
  stops at S = 8 and never wraps it);
* ``greedy_generate`` and ``GenerationEngine`` tokens equal the
  reference's (W8A8); one train step and one W4A8 QAT step from the
  reference's carried state equal ``jax.jit(make_train_step)``'s
  (``test_torch_families_train.py``'s check); the ring caches take no ``quant_kv`` (ROADMAP C19); the
  windowed attention never reaches B7;
* ``rg_lru`` alone, with ``h0`` folded in, at S in {1, 2, 7, 8, 37}, and
  ``associative_scan`` against a sequential scan;
* planted faults break the bounds: no sqrt(1 - a^2) factor, h0 not
  folded, the conv tail off by one, the ring slot off by one, the token
  shift taken from x_t;
* the launchers serve and train both SMOKE configs.

Tolerances (ROADMAP C18): the reference is not bit-stable here.  Under
``jit`` XLA CPU contracts the scans' ``a*b + c`` into fused multiply-adds
(reference ``rg_lru`` at (2, 37, 64) with h0 differs by 4.8e-7 between
jit and eager), and torch's ``sigmoid``, ``exp``, ``softplus`` and
``sqrt`` differ from XLA's by an ulp (C4).  So float32 is held by the
tight rule of ``torch_lm_parity.py`` (1e-5 abs + rel), W8A8 by its W8A8
rule, and the recurrent states by the logits' rule of their recipe (they
are float values, not codes).
"""
import dataclasses
import functools
import inspect
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as lp  # noqa: E402
from repro.configs import all_archs as ref_all_archs  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.serve.generation import GenerationEngine as RefEngine  # noqa: E402
from repro.serve.generation import greedy_generate as ref_greedy  # noqa: E402

from test_torch_families_train import check_train_step  # noqa: E402
from repro_torch.configs import all_archs, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import api, rglru, rwkv6, transformer  # noqa: E402
from repro_torch.quantize import layers  # noqa: E402
from repro_torch.serve import GenerationEngine, greedy_generate  # noqa: E402
from repro_torch.train import loop  # noqa: E402

ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
PROMPT, TOTAL = 12, 20          # prefill 12 tokens, decode to 20 (the hybrid's window is 8)


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


def _ref_layers(rcache, arch, n_layers):
    """The reference's cache (or its specs) as one {name: leaf} per layer:
    rwkv6 stacks its states on a leading L axis, the hybrid keeps a tuple."""
    if arch == "rwkv6-7b":
        return [{k: v[i] for k, v in rcache.items()} for i in range(n_layers)]
    return list(rcache)


def _ref_spec_layers(specs, arch, n_layers):
    if arch == "rwkv6-7b":
        return [{k: (tuple(v.shape[1:]), str(v.dtype)) for k, v in specs.items()}] * n_layers
    return [{k: (tuple(v.shape), str(v.dtype)) for k, v in layer.items()} for layer in specs]


# ------------------------------------------------ configs and counts

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_counts_match_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    want = {k: v for k, v in dataclasses.asdict(ref_cfg).items() if k != "quant"}
    got = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "quant"}
    assert got == want and cfg.sub_quadratic()
    assert cfg.param_count() == ref_cfg.param_count() == cfg.active_param_count()
    smoke = get_smoke_config(arch)
    ref_specs = jax.tree.leaves(ref_api.param_specs(lp.ref_smoke(arch)))
    assert smoke.param_count() == sum(int(np.prod(s.shape)) for s in ref_specs)
    assert set(api.param_shapes(smoke)) == set(
        dict(api.init_params(0, smoke, "cpu").named_parameters()))
    for c, rc in ((cfg, ref_cfg), (smoke, lp.ref_smoke(arch))):
        want = _ref_spec_layers(ref_api.cache_specs(rc, 4, 4096), arch, c.n_layers)
        got = [{k: (tuple(s), str(dt).split(".")[-1]) for k, (s, dt) in layer.items()}
               for layer in api.cache_specs(c, 4, 4096)]
        assert got == want
    assert all_archs() == ref_all_archs()


# ------------------------------------------------ forward, prefill, decode

@functools.lru_cache(maxsize=None)
def reference_run(arch, recipe, decode=True):
    """The jitted reference on one token sequence (2, 20): forward over
    all of it; with ``decode``, prefill of the first 12 (cache_len 20) and
    decode steps 12..19 on the sequence's own tokens.  Numpy results."""
    rc, jp, _, _ = lp.both_params(arch, recipe, "float32")
    toks = lp.tokens(4, rc.vocab, (2, TOTAL))
    fwd, _ = _jit(ref_api.forward, "cfg")(jp, {"tokens": jnp.asarray(toks)}, rc)
    if not decode:
        return {"toks": toks, "forward": np.asarray(fwd)}
    pre, cache = _jit(ref_api.prefill, "cfg", "cache_len")(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}, rc, TOTAL)
    pre_cache = jax.tree.map(np.asarray, cache)
    dec = _jit(ref_api.decode_step, "cfg")
    steps = []
    for idx in range(PROMPT, TOTAL):
        logits, cache = dec(jp, cache, jnp.asarray(toks[:, idx:idx + 1]), jnp.int32(idx), rc)
        steps.append(np.asarray(logits))
    return {"toks": toks, "forward": np.asarray(fwd), "prefill": np.asarray(pre),
            "pre_cache": pre_cache, "decode": steps,
            "cache": jax.tree.map(np.asarray, cache)}


def _hold_cache(pcache, rcache, arch, recipe, what):
    rl = _ref_layers(rcache, arch, len(pcache))
    assert len(pcache) == len(rl)
    for i, (g, w) in enumerate(zip(pcache, rl)):
        assert set(g) == set(w), (what, i)
        for name in g:
            try:
                lp.assert_logits(g[name], w[name], recipe, "float32")
            except AssertionError as e:
                raise AssertionError(f"{what}: layer {i} {name}: {e}") from None


def check_model(arch, recipe, *, decode=True):
    """The port against ``reference_run``: forward, prefill with every
    cache, each decode step against the reference's step and its forward
    at that position, and the final caches."""
    ref = reference_run(arch, recipe, decode)
    _, _, pc, pp = lp.both_params(arch, recipe, "float32")
    toks = torch.from_numpy(ref["toks"])
    got, aux = api.forward(pp, {"tokens": toks}, pc)
    assert got.shape == (2, TOTAL, pc.vocab) and got.dtype == torch.float32
    assert aux["n_prefix"] == 0 and float(aux["moe_aux"]) == 0.0
    lp.assert_logits(got, ref["forward"], recipe, "float32")
    if not decode:
        return
    logits, cache = api.prefill(pp, {"tokens": toks[:, :PROMPT]}, pc, TOTAL)
    lp.assert_logits(logits, ref["prefill"], recipe, "float32")
    _hold_cache(cache, ref["pre_cache"], arch, recipe, "prefill")
    for n, idx in enumerate(range(PROMPT, TOTAL)):
        logits, cache = api.decode_step(pp, cache, toks[:, idx:idx + 1], idx, pc)
        lp.assert_logits(logits, ref["decode"][n], recipe, "float32")
        if recipe == "fp32":
            lp.assert_logits(logits, ref["forward"][:, idx], recipe, "float32")
    _hold_cache(cache, ref["cache"], arch, recipe, "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    """FP32: forward, prefill and each decode step, every layer's cache;
    each decode step also equals the reference's forward at its position:
    the hybrid's ring, rolled by the prefill and wrapped by steps 16-19,
    gives the windowed attention of the full sequence."""
    check_model(arch, "fp32")


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_forward_matches_reference(arch):
    """W8A8 with 8-bit KV bits in the recipe (no cache of these families
    takes them); prefill and decode under W8A8 are held through
    ``greedy_generate`` and the engine below."""
    check_model(arch, "w8a8kv8", decode=False)


def test_hybrid_ring_layout_after_prefill_and_wrap():
    """Slot pos % 8 holds position pos: a 12-token prefill decoded to 20
    leaves the ring a 20-token prefill leaves; a 5-token prefill leaves
    slots 5-7 empty, and decoding from it past the window's end matches
    the forward at each position."""
    _, _, pc, pp = lp.both_params("recurrentgemma-2b", "fp32", "float32")
    toks = torch.from_numpy(reference_run("recurrentgemma-2b", "fp32")["toks"])
    a = rglru.layer_kinds(pc).index("attn")
    _, whole = api.prefill(pp, {"tokens": toks}, pc, TOTAL)
    _, cache = api.prefill(pp, {"tokens": toks[:, :PROMPT]}, pc, TOTAL)
    assert cache[a]["k"].shape[1] == pc.window
    for idx in range(PROMPT, TOTAL):
        _, cache = api.decode_step(pp, cache, toks[:, idx:idx + 1], idx, pc)
    for name in ("k", "v"):
        lp.assert_logits(cache[a][name], whole[a][name], "fp32", "float32")
    with torch.no_grad():
        full, _ = api.forward(pp, {"tokens": toks[:, :12]}, pc)
    _, cache = api.prefill(pp, {"tokens": toks[:, :5]}, pc, 12)
    assert cache[a]["k"][:, :5].any() and not cache[a]["k"][:, 5:].any()
    for idx in range(5, 12):
        logits, cache = api.decode_step(pp, cache, toks[:, idx:idx + 1], idx, pc)
        lp.assert_logits(logits, full[:, idx], "fp32", "float32")


# ------------------------------------------------ generation

# W8A8; the engine's one slot has the greedy test's shape (2 x 9 tokens,
# 5 steps), so the reference compiles its greedy_generate once for both
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    rc, jp, pc, pp = lp.both_params(arch, "w8a8kv8", "float32")
    toks = lp.tokens(5, rc.vocab, (2, 9))
    want = _jit(ref_greedy, "cfg", "n_steps", "cache_len")(jp, rc, {"tokens": jnp.asarray(toks)},
                                                           n_steps=5)
    got = greedy_generate(pp, pc, {"tokens": torch.from_numpy(toks)}, n_steps=5)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_generation_engine_matches_reference(arch):
    rc, jp, pc, pp = lp.both_params(arch, "w8a8kv8", "float32")
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(1, rc.vocab, size=n).astype(np.int32), m) for n, m in ((4, 3), (9, 5))]
    ref_eng, eng = RefEngine(jp, rc, max_batch=2), GenerationEngine(pp, pc, max_batch=2)
    want = [ref_eng.submit(p, m) for p, m in reqs]
    got = [eng.submit(p, m) for p, m in reqs]
    ref_eng.run_pending()
    assert eng.run_pending() and not eng.queue
    for g, w, (_, m) in zip(got, want, reqs):
        assert g.result.shape == (m,)
        np.testing.assert_array_equal(g.result.numpy(), np.asarray(w.result))


def test_ring_caches_take_no_quant_kv_and_no_b7(monkeypatch):
    """ROADMAP C19: the hybrid's ring writes call no quant_kv, as the
    reference's; no call of either family reaches B7 (the hybrid's
    attention is windowed, rwkv6 has none)."""
    def refuse(*a, **k):
        raise AssertionError("called")
    monkeypatch.setattr(layers, "quant_kv", refuse)
    monkeypatch.setattr(transformer, "quant_kv", refuse)
    monkeypatch.setattr(transformer, "flash_attention", refuse)
    windows = []
    real = transformer.chunked_attention

    def spy(q, k, v, **kw):
        windows.append(kw["window"])
        return real(q, k, v, **kw)
    monkeypatch.setattr(transformer, "chunked_attention", spy)
    for arch in ARCHS:
        cfg = lp.configs(arch, "w8a8kv8", "float32")[1]
        params = api.init_params(0, cfg, "cpu")
        toks = torch.from_numpy(lp.tokens(1, cfg.vocab, (2, 10)))
        with torch.no_grad():
            api.forward(params, {"tokens": toks}, cfg)
        logits, cache = api.prefill(params, {"tokens": toks}, cfg, 12)
        api.decode_step(params, cache, torch.argmax(logits, -1)[:, None], 10, cfg)
    n_attn = rglru.layer_kinds(get_smoke_config("recurrentgemma-2b")).count("attn")
    assert windows == [8] * (2 * n_attn)            # forward's and the prefill's


def test_decay_follows_the_stacked_reference_leaves():
    """ROADMAP C11: the reference stacks rwkv6's layers and the hybrid's
    groups, so their vectors are decayed; the hybrid's tail layers are
    not stacked, so their vectors escape the decay, as the final norm."""
    named = dict(api.init_params(0, get_smoke_config("rwkv6-7b"), "cpu").named_parameters())
    d = loop.decayed(named)
    assert {"layers.0.mu_r", "layers.1.ln2.b", "layers.0.u_bonus", "embed"} <= d
    assert "final_norm.g" not in d
    named = dict(api.init_params(0, get_smoke_config("recurrentgemma-2b"), "cpu")
                 .named_parameters())
    d = loop.decayed(named)
    assert {"groups.0.0.mix.lam", "groups.0.2.pre_norm.w", "tail.0.mix.conv_k"} <= d
    assert not {"tail.0.mix.lam", "tail.1.ffn_norm.w", "final_norm.w"} & d


# ------------------------------------------------ RG-LRU

def _lru_inputs(S, seed=0, W=64, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    p = {k: (rng.standard_normal(W) * 0.5).astype(np.float32)
         for k in ("lam", "w_rgate", "b_rgate", "w_igate", "b_igate")}
    return x, h0, p


def check_rg_lru(S):
    x, h0, p = _lru_inputs(S, seed=S)
    want, want_last = jax.jit(ref_rglru.rg_lru)(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                                                  p.items()}, jnp.asarray(h0))
    pt = transformer.Params({k: v.shape for k, v in p.items()}, torch.float32, "cpu")
    for k, v in p.items():
        getattr(pt, k).data.copy_(torch.from_numpy(v))
    got, got_last = rglru.rg_lru(torch.from_numpy(x), pt, torch.from_numpy(h0))
    lp.assert_logits(got, want, "fp32", "float32")
    lp.assert_logits(got_last, want_last, "fp32", "float32")


@pytest.mark.parametrize("S", [1, 2, 7, 8, 37])
def test_rg_lru_matches_reference(S):
    check_rg_lru(S)


def test_associative_scan_is_the_recurrence():
    """The tree gives the sequential h_t = a_t h_{t-1} + b_t (to float32
    order), at lengths around the powers of two."""
    g = torch.Generator().manual_seed(0)
    for n in (1, 2, 3, 5, 8, 9, 16, 33):
        a = torch.rand((2, n, 3), generator=g)
        b = torch.randn((2, n, 3), generator=g)
        _, h = rglru.associative_scan(a, b)
        want, prev = [], torch.zeros((2, 3))
        for t in range(n):
            prev = a[:, t] * prev + b[:, t]
            want.append(prev)
        torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-5, atol=1e-6)


# ------------------------------------------------ planted faults

def _mutant(module, name, old, new):
    """``module.name`` recompiled with ``old`` (found once) replaced by
    ``new`` in its source."""
    src = textwrap.dedent(inspect.getsource(getattr(module, name)))
    assert src.count(old) == 1, (name, old)
    ns = dict(vars(module))
    exec(compile(src.replace(old, new), f"<{name} mutant>", "exec"), ns)
    return ns[name]


FAULTS = {
    "no sqrt(1 - a^2)": (rglru, "rg_lru", "torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * ",
                         "", lambda: check_rg_lru(37)),
    "h0 not folded": (rglru, "rg_lru", "gated = torch.cat([first, gated[:, 1:]], dim=1)",
                      "pass", lambda: check_rg_lru(7)),
    "conv tail off by one": (rglru, "rec_mix", 'state["conv"].copy_(u_ext[:, -3:])',
                             'state["conv"].copy_(u_ext[:, -4:-1])',
                             lambda: check_model("recurrentgemma-2b", "fp32")),
    "ring slot off by one": (rglru, "decode_step", 'idx % st["k"].shape[1]',
                             '(idx + 1) % st["k"].shape[1]',
                             lambda: check_model("recurrentgemma-2b", "fp32")),
    "token shift from x_t": (rwkv6, "_token_shift", "return F.pad(x, (0, 0, 1, 0))[:, :-1]",
                             "return x", lambda: check_model("rwkv6-7b", "fp32", decode=False)),
}


# each fault is held by a check that the sound code passes in a test above
@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_break_the_bounds(fault):
    module, name, old, new, check = FAULTS[fault]
    with mock.patch.object(module, name, _mutant(module, name, old, new)):
        with pytest.raises(AssertionError):
            check()


# ------------------------------------------------ train steps

@pytest.mark.parametrize("recipe", ["fp32", "w4a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, recipe):
    """One train step and one W4A8 QAT step from the reference's carried
    state against ``jax.jit(make_train_step)``, by
    ``test_torch_families_train.py``'s check: the time loop and the
    RG-LRU scan under autograd, the hybrid's group / tail decay (at one
    group and one tail layer, ``TRAIN_LAYERS``)."""
    check_train_step(arch, recipe)


# ------------------------------------------------ launchers

@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_the_families(arch, tmp_path):
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                      "--max-new-tokens", "3"])
    assert out["requests"] == 3 and out["tokens"] == 9
    res = train.main(["--arch", arch, "--smoke", "--steps", "2", "--global-batch", "2",
                      "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert sorted(res["losses"]) == [1, 2]
    assert all(np.isfinite(v) and v > 0 for v in res["losses"].values())
