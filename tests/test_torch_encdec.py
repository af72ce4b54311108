"""The audio family of the port (``models/encdec.py``, whisper-base)
against the reference, on the CPU, with the reference's weights carried
over by ``params_from_reference``:

* the full config, ``param_count`` and the SMOKE parameter count equal;
* SMOKE ``forward``, ``prefill`` plus two ``decode_step``s (logits and
  every decoder layer's self and cross cache) under FP32 and W8A8 with
  an 8-bit KV cache, float32 and bf16 activations.  Logits within
  ``torch_lm_parity.py``'s bounds.  Whisper's cache holds projections,
  not codes (no cache write takes ``quant_kv``, as in the reference):
  float32 within the tight bound, bf16 by the bf16 rule of the logits
  (within 4 bf16 steps of the largest entry, mean below one step: the
  reference keeps some bf16 sums in float32, so the residual and its
  projections differ by bf16 steps);
* decode matches forward; the 8192-row position table clipped past its
  end as the reference's;
* one train step and one W4A8 QAT train step against
  ``jax.jit(make_train_step)`` (``test_torch_families_train.py``'s
  check);
* ``greedy_generate`` with ``frames`` equal to the reference's;
* routing: B7 runs once per decoder layer in a prefill and in a forward
  outside autograd, never in the encoder, a cross-attention, decode or a
  train step;
* ``GenerationEngine`` on audio raises naming ``frames`` (ROADMAP C16),
  where the reference's engine fails on the missing key;
* the sinusoidal table is cached and equal to the reference's; the
  launchers serve and train whisper's SMOKE config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as lp  # noqa: E402
from test_torch_families_train import check_train_step  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.serve.generation import GenerationEngine as RefEngine  # noqa: E402
from repro.serve.generation import greedy_generate as ref_greedy  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import api, common, encdec, transformer  # noqa: E402
from repro_torch.quantize import layers  # noqa: E402
from repro_torch.quantize.config import QuantRecipe  # noqa: E402
from repro_torch.serve import GenerationEngine, greedy_generate  # noqa: E402
from repro_torch.train import loop  # noqa: E402

ARCH = "whisper-base"
CASES = [("fp32", "float32"), ("w8a8kv8", "float32"), ("w8a8kv8", "bfloat16")]
CACHE = ("self_k", "self_v", "cross_k", "cross_v")


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


def _inputs(rc, pc, seed, B=2, S=9):
    return lp.batches(rc, pc, dict(lp.frontend(rc, B, seed), tokens=lp.tokens(seed, rc.vocab,
                                                                              (B, S))))


def assert_cache(got, want, dtype):
    """Whisper's cache entries: projections in the activation dtype."""
    if dtype == "float32":
        lp.assert_cache(got, want, "fp32", dtype)
    else:
        lp.assert_logits(got, want, "fp32", dtype)


def test_full_config_and_counts_match_reference():
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    want = {k: v for k, v in dataclasses.asdict(ref_cfg).items() if k != "quant"}
    got = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "quant"}
    assert got == want and cfg.family == "audio"
    assert cfg.param_count() == ref_cfg.param_count() == cfg.active_param_count()
    smoke = get_smoke_config(ARCH)
    ref_specs = jax.tree.leaves(ref_api.param_specs(lp.ref_smoke(ARCH)))
    assert smoke.param_count() == sum(int(np.prod(s.shape)) for s in ref_specs)
    spec = api.cache_specs(cfg, 4, 448)
    ref_spec = ref_api.cache_specs(ref_cfg, 4, 448)
    for name in CACHE:
        assert spec[name] == ref_spec[name].shape[1:]
    assert spec["n_layers"] == cfg.n_layers and spec["dtype"] == torch.bfloat16


@pytest.mark.parametrize("recipe,dtype", CASES)
def test_forward_matches_reference(recipe, dtype):
    rc, jp, pc, pp = lp.both_params(ARCH, recipe, dtype)
    jb, tb = _inputs(rc, pc, 3)
    want, raux = _jit(ref_api.forward, "cfg")(jp, jb, rc)
    got, aux = api.forward(pp, tb, pc)
    assert got.shape == (2, 9, pc.vocab) and got.dtype == torch.float32
    assert aux["n_prefix"] == raux["n_prefix"] == 0 and float(aux["moe_aux"]) == 0.0
    lp.assert_logits(got, want, recipe, dtype)


@pytest.mark.parametrize("recipe,dtype", CASES)
def test_prefill_and_decode_match_reference(recipe, dtype):
    rc, jp, pc, pp = lp.both_params(ARCH, recipe, dtype)
    jb, tb = _inputs(rc, pc, 4)
    want, rcache = _jit(ref_api.prefill, "cfg", "cache_len")(jp, jb, rc, 16)
    got, pcache = api.prefill(pp, tb, pc, 16)
    lp.assert_logits(got, want, recipe, dtype)
    assert len(pcache) == pc.n_layers
    for i, layer in enumerate(pcache):
        assert layer["self_k"].shape == (2, 16, pc.n_kv_heads, pc.hd)
        assert layer["cross_k"].shape == (2, pc.n_frames, pc.n_kv_heads, pc.hd)
        for name in CACHE:
            assert layer[name].dtype == pc.act_dtype
            assert_cache(layer[name], rcache[name][i], dtype)
    for idx in (9, 10):
        nxt = np.argmax(lp.f32(want), -1).astype(np.int32)[:, None]
        want, rcache = _jit(ref_api.decode_step, "cfg")(jp, rcache, jnp.asarray(nxt),
                                                         jnp.int32(idx), rc)
        got, pcache = api.decode_step(pp, pcache, torch.from_numpy(nxt), idx, pc)
        lp.assert_logits(got, want, recipe, dtype)
        assert not pcache[0]["self_k"][:, idx + 1:].any()
    for i, layer in enumerate(pcache):
        for name in CACHE:
            assert_cache(layer[name], rcache[name][i], dtype)


def test_decode_matches_forward_and_clips_positions():
    """prefill + decode_step == forward at the last position; past the
    8192-row table decode takes its last row, as the reference does."""
    cfg = get_smoke_config(ARCH)
    params = api.init_params(3, cfg, "cpu")
    batch = api.make_batch(torch.Generator().manual_seed(3), cfg, 2, 8, "cpu")
    assert batch["frames"].shape == (2, cfg.n_frames, cfg.d_model)
    full, _ = api.forward(params, batch, cfg)
    _, cache = api.prefill(params, dict(batch, tokens=batch["tokens"][:, :7]), cfg, 8)
    logits, _ = api.decode_step(params, cache, batch["tokens"][:, 7:8], 7, cfg)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].detach().numpy(),
                               atol=2e-3, rtol=1e-3)
    rc, jp, pc, pp = lp.both_params(ARCH, "fp32", "float32")
    jb, tb = _inputs(rc, pc, 6, B=1, S=3)
    n = encdec.DECODE_POSITIONS + 2
    _, rcache = _jit(ref_api.prefill, "cfg", "cache_len")(jp, jb, rc, n)
    _, pcache = api.prefill(pp, tb, pc, n)
    nxt = np.array([[5]], np.int32)
    want, _ = _jit(ref_api.decode_step, "cfg")(jp, rcache, jnp.asarray(nxt),
                                                jnp.int32(n - 1), rc)
    got, _ = api.decode_step(pp, pcache, torch.from_numpy(nxt), n - 1, pc)
    lp.assert_logits(got, want, "fp32", "float32")


@pytest.mark.parametrize("recipe", ["fp32", "w4a8"])
def test_train_step_matches_reference(recipe):
    check_train_step(ARCH, recipe)


def test_decay_follows_the_stacked_reference_leaves():
    """The reference stacks enc_layers / dec_layers: their norm vectors
    are decayed there (ROADMAP C11); the final norms are not, the
    embedding (a matrix) is."""
    params = api.init_params(0, get_smoke_config(ARCH), "cpu")
    named = dict(params.named_parameters())
    decayed = loop.decayed(named)
    assert "enc_layers.0.attn_norm.g" in decayed and "dec_layers.1.ffn.b_up" in decayed
    assert "enc_final_norm.g" not in decayed and "final_norm.b" not in decayed
    assert "embed" in decayed


@pytest.mark.parametrize("recipe", ["fp32", "w8a8kv8"])
def test_greedy_generate_with_frames_matches_reference(recipe):
    rc, jp, pc, pp = lp.both_params(ARCH, recipe, "float32")
    jb, tb = _inputs(rc, pc, 5, B=3, S=7)
    want = _jit(ref_greedy, "cfg", "n_steps", "cache_len")(jp, rc, jb, n_steps=6)
    got = greedy_generate(pp, pc, tb, n_steps=6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ routing and the cache

def test_b7_runs_in_the_decoder_prefix_only(monkeypatch):
    """B7 once per decoder layer in forward (outside autograd) and in
    prefill; the encoder's self-attention and every cross-attention run
    chunked_attention non-causally; decode and a train step never reach
    B7."""
    cfg = get_smoke_config(ARCH)
    params = api.init_params(0, cfg, "cpu")
    batch = api.make_batch(torch.Generator().manual_seed(1), cfg, 2, 7, "cpu")
    flash, plain = [], []
    real_flash, real_plain = transformer.flash_attention, transformer.chunked_attention

    def spy_flash(q, k, v, *, causal=True):
        flash.append((tuple(q.shape), tuple(k.shape), causal))
        return real_flash(q, k, v, causal=causal)

    def spy_plain(q, k, v, **kw):
        plain.append((q.shape[1], k.shape[1], kw["causal"]))
        return real_plain(q, k, v, **kw)
    monkeypatch.setattr(transformer, "flash_attention", spy_flash)
    monkeypatch.setattr(transformer, "chunked_attention", spy_plain)
    L, F, H, hd = cfg.n_layers, cfg.n_frames, cfg.n_heads, cfg.hd
    b7 = [((2, H, 7, hd), (2, cfg.n_kv_heads, 7, hd), True)] * L
    with torch.no_grad():
        api.forward(params, batch, cfg)
    assert flash == b7
    assert plain == [(F, F, False)] * cfg.n_enc_layers + [(7, F, False)] * L
    flash.clear()
    plain.clear()
    logits, cache = api.prefill(params, batch, cfg, 12)
    assert flash == b7
    assert plain == [(F, F, False)] * cfg.n_enc_layers + [(7, F, False)] * L
    flash.clear()
    plain.clear()
    api.decode_step(params, cache, torch.argmax(logits, -1)[:, None], 7, cfg)
    assert flash == [] and plain == [(1, 12, True), (1, F, False)] * L
    plain.clear()
    state = loop.init_train_state(0, cfg, loop.TrainHyper(), "cpu")
    loop.make_train_step(cfg, loop.TrainHyper())(state, batch)
    assert flash == [] and len(plain) == cfg.n_enc_layers + 2 * L


def test_cache_writes_take_no_quant_kv(monkeypatch):
    """A kv-bits recipe leaves whisper's cache in the activation dtype, as
    the reference's (no quant_kv call): the cache under W8A8-kv8 equals
    the cache under W8A8 with no KV bits."""
    def refuse(*a, **k):
        raise AssertionError("quant_kv called on the audio path")
    monkeypatch.setattr(layers, "quant_kv", refuse)
    monkeypatch.setattr(transformer, "quant_kv", refuse)
    cfg = get_smoke_config(ARCH)
    params = api.init_params(0, cfg, "cpu")
    batch = api.make_batch(torch.Generator().manual_seed(2), cfg, 2, 5, "cpu")
    caches = []
    for kv in (8.0, None):
        c = cfg.replace(quant=QuantRecipe.w_a(8.0, 8.0, kv_cache_bits=kv))
        logits, cache = api.prefill(params, batch, c, 8)
        api.decode_step(params, cache, torch.argmax(logits, -1)[:, None], 5, c)
        caches.append(cache)
    for a, b in zip(*caches):
        for name in CACHE:
            assert torch.equal(a[name], b[name]), name


def test_generation_engine_on_audio_raises_naming_frames():
    """ROADMAP C16: the reference's engine passes only the tokens and its
    prefill reads the frames; the port's engine says so."""
    rc, jp, pc, pp = lp.both_params(ARCH, "fp32", "float32")
    prompt = np.arange(1, 5, dtype=np.int32)
    eng = GenerationEngine(pp, pc)
    eng.submit(prompt, 2)
    with pytest.raises(ValueError, match="frames.*C16"):
        eng.run_pending()
    ref_eng = RefEngine(jp, rc)
    ref_eng.submit(prompt, 2)
    with pytest.raises(KeyError, match="frames"):
        ref_eng.run_pending()


def test_sinusoidal_table_cached_and_equal_to_reference():
    a = common.sinusoidal_embedding(encdec.DECODE_POSITIONS, 64, "cpu")
    assert common.sinusoidal_embedding(encdec.DECODE_POSITIONS, 64) is a
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(ref_common.sinusoidal_embedding(encdec.DECODE_POSITIONS, 64)))
    assert a.dtype == torch.float32 and a.shape == (encdec.DECODE_POSITIONS, 64)


def test_launchers_on_audio(tmp_path):
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5",
                      "--max-new-tokens", "3"])
    assert out["requests"] == 5 and out["tokens"] == 15
    assert all(r.shape == (3,) and r.dtype == torch.int32 for r in out["results"])
    res = train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--global-batch", "2",
                      "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert sorted(res["losses"]) == [1, 2]
    assert all(np.isfinite(v) and v > 0 for v in res["losses"].values())


def test_audio_launcher_slots_are_the_engines_left_padded_slots():
    """The launcher's audio path builds its slots with the engine's
    left_pad and adds only the seeded frames."""
    from repro_torch.launch import serve
    from repro_torch.serve.generation import left_pad
    toks = left_pad([np.array([5, 6]), np.array([7, 8, 9])])
    assert toks.dtype == torch.int32 and toks.tolist() == [[0, 5, 6], [7, 8, 9]]
    cfg = get_smoke_config(ARCH)
    params = api.init_params(0, cfg, "cpu")
    prompts = [np.array([3, 4]), np.array([5, 6, 7]), np.array([8])]
    got = serve._serve_audio(params, cfg, prompts, 2, "cpu", slot=2)
    assert len(got) == 3
    for n, i in enumerate((0, 2)):
        slot = prompts[i:i + 2]
        frames = api.frontend_batch(torch.Generator().manual_seed(n), cfg, len(slot), "cpu")
        want = greedy_generate(params, cfg, dict(frames, tokens=left_pad(slot)), 2)
        for j in range(len(slot)):
            assert torch.equal(got[i + j], want[j])


def test_encdec_param_names_and_reference_load():
    cfg = get_smoke_config(ARCH)
    tree = lp.reference_tree(ARCH)
    p = api.params_from_reference(tree, cfg, "cpu")
    assert {n for n, _ in p.named_parameters()} == set(api.param_shapes(cfg))
    assert torch.equal(p.dec_layers[1].cross_norm.g,
                       torch.tensor(np.asarray(tree["dec_layers"]["cross_norm"][0][1])))
    assert torch.equal(p.enc_layers[0].ffn.b_up,
                       torch.tensor(np.asarray(tree["enc_layers"]["ffn"]["b_up"][0])))
    with pytest.raises(ValueError, match="encoder-decoder"):
        encdec.param_shapes(get_smoke_config("qwen2-1.5b"))
    with pytest.raises(KeyError, match="frames"):
        api.forward(p, {"tokens": torch.zeros((1, 3), dtype=torch.int32)}, cfg)
