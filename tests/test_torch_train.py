"""The port's training path against the reference, on the CPU.

* ``optim``: the cosine schedule, AdamW (decay only on the leaves it
  names; by default matrices), ``clip_by_global_norm`` and ``ef_compress``
  against the jitted reference;
* ``SyntheticLMStream`` batches bit for bit; ``CheckpointManager``'s
  round trip, retention, crash safety and missing-leaf error, as
  ``tests/test_substrate.py`` checks the reference's; PTQ calibration;
* ``make_train_step`` from one ``train_state_from_reference`` state (the
  reference's state after one step, so the moments and counters are
  carried too) against ``jax.jit(repro.train.loop.make_train_step)`` for
  3 steps, the gradient at the carried state beside it.  Bounds:
    - float32, FP32 recipe (qwen2, olmo, starcoder2-3b): loss and
      grad_norm rel 1e-5, parameters 1e-5 abs;
    - float32, W8A8: the same on loss, grad_norm and parameters, and at
      most 1 % of gradient entries beyond 1e-5 (abs + rel), as
      ``torch_lm_parity.py``'s rule: an entry near a rounding tie may
      quantize to the neighbouring code;
    - bf16 activations, W8A8 (qwen2): the two packages round other bf16
      intermediates (ROADMAP C7, C10), so the gradient differs in bf16
      steps, not ulps.  Measured on this test's state (CPU): loss rel
      2.4e-5, the whole gradient's relative L2 0.0092, the worst leaf's
      0.031.  Bounds: loss rel 1e-4, whole-gradient rel-L2 0.02, worst
      leaf 0.05; each of four planted faults breaks one (gx without its
      clip window and the scale gradient dropped: whole 0.041, worst leaf
      0.085; attention detached: wq's gradient gone; z-loss dropped: loss
      rel 5.3e-4), ``test_bf16_bound_fails_on_planted_faults``;
* microbatch equivalence, resume from a checkpoint, the loss decreasing
  over 40 SMOKE steps, and the launcher with ``--device cpu``.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as lp  # noqa: E402
from repro.ckpt import CheckpointManager as RefManager  # noqa: E402
from repro.data import SyntheticLMStream as RefStream  # noqa: E402
from repro.dist.collectives import ef_compress as ref_ef_compress  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim.schedule import cosine_schedule as ref_cosine  # noqa: E402
from repro.quantize import calibrate as ref_cal  # noqa: E402
from repro.quantize.config import TensorQuant as RefTQ  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402

from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ste  # noqa: E402
from repro_torch.data import SyntheticLMStream, to_device  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.quantize import calibrate  # noqa: E402
from repro_torch.quantize.config import TensorQuant  # noqa: E402
from repro_torch.train import loop  # noqa: E402

TIGHT = 1e-5
# a learning rate that moves every parameter at once (lr 1e-3 from the
# first step): a parity bound on the parameters then means something
HYPER = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def f32(x) -> np.ndarray:
    return lp.f32(x.detach() if isinstance(x, torch.Tensor) else x)


def _named(tree_like_params, cfg) -> dict:
    """A reference parameter-shaped tree as {dotted name: tensor}."""
    model = api.params_from_reference(jax.tree.map(np.asarray, tree_like_params),
                                      cfg.replace(param_dtype="float32"), "cpu")
    return {k: v.detach() for k, v in model.named_parameters()}


# ------------------------------------------------------------------ optim

def test_cosine_schedule_matches_jitted_reference():
    """lr on the device, as float32, against the jitted reference (whose
    divisions by constants are reciprocal products, as the port's).
    XLA's float32 cos differs from torch's by an ulp (2^-24 abs) at some
    arguments; through ``0.1 + 0.45·(1 + cos)`` that is at most 2^-24 ·
    0.45 / 0.1 relative, plus a rounding or two: 4·2^-23 bounds it."""
    for peak, warm, total in ((3e-4, 100, 10_000), (1e-3, 3, 7), (3e-4, 11, 100)):
        fn = jax.jit(functools.partial(ref_cosine, peak=peak, warmup_steps=warm,
                                       total_steps=total))
        steps = np.unique(np.linspace(0, total + 2, 400).astype(np.int32))
        want = np.asarray(jax.vmap(fn)(jnp.asarray(steps)))
        got = cosine_schedule(torch.from_numpy(steps), peak=peak, warmup_steps=warm,
                              total_steps=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=4 * 2 ** -23, atol=0)


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "n": (1 + 0.1 * rng.standard_normal(6)).astype(np.float32)}


def test_adamw_and_clip_match_reference():
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_adamw.adamw_init(rp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = adamw.adamw_init(pp)
    upd = jax.jit(functools.partial(ref_adamw.adamw_update, weight_decay=0.1,
                                    max_grad_norm=1.0))
    for step in range(4):
        grads = {k: (rng.standard_normal(v.shape) * (0.3 if step % 2 else 3.0))
                 .astype(np.float32) for k, v in params.items()}
        lr = np.float32(1e-2 / (step + 1))
        rp, rs, rm = upd({k: jnp.asarray(v) for k, v in grads.items()}, rs, rp,
                         lr=jnp.float32(lr))
        pp, ps, pm = adamw.adamw_update({k: torch.from_numpy(v) for k, v in grads.items()},
                                        ps, pp, lr=torch.tensor(lr))
        assert int(ps.step) == int(rs.step) == step + 1
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        for k in params:
            # the clip factor comes from a norm summed in another order:
            # relative 1e-6 of each leaf's largest entry
            for got, want in ((pp[k], rp[k]), (ps.mu[k], rs.mu[k]), (ps.nu[k], rs.nu[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())
    # clip: the norm before clipping, leaves scaled to max_norm
    g = {k: torch.from_numpy(v * 10) for k, v in params.items()}
    clipped, gn = adamw.clip_by_global_norm(g, 1.0)
    rc, rgn = ref_adamw.clip_by_global_norm({k: jnp.asarray(v.numpy()) for k, v in g.items()},
                                            1.0)
    np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(rc[k]), rtol=1e-6, atol=1e-7)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


def test_adamw_decays_only_the_named_leaves():
    p = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
    zero = {k: torch.zeros_like(v) for k, v in p.items()}
    out, _, _ = adamw.adamw_update(zero, adamw.adamw_init(p), p, lr=0.1, weight_decay=0.5)
    assert float((out["b"] - 1).abs().max()) < 1e-6 and float(out["w"][0, 0]) < 1.0
    p = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
    out, _, _ = adamw.adamw_update(zero, adamw.adamw_init(p), p, lr=0.1, weight_decay=0.5,
                                   decay={"b"})
    assert float(out["b"][0]) < 1.0 and torch.equal(out["w"], torch.ones((2, 2)))
    # the train step decays what the reference decays: its per-layer
    # leaves are stacked (L, ...), so a layer's norm weight is a matrix
    # there (ROADMAP C11); only the top-level vectors escape
    named = dict(api.init_params(0, get_smoke_config("qwen2-1.5b"), "cpu").named_parameters())
    assert loop.decayed(named) == set(named) - {"final_norm.w"}


def test_ef_compress_matches_jitted_reference_and_keeps_the_invariant():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((7, 9)).astype(np.float32),
         "b": (rng.standard_normal(13) * 1e-3).astype(np.float32),
         "z": np.zeros(4, np.float32)}
    r = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32) for k, v in g.items()}
    wc, wr = jax.jit(ref_ef_compress)(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tr = {k: torch.from_numpy(v) for k, v in r.items()}
    gc, gr = collectives.ef_compress(tg, tr)
    for k in g:
        np.testing.assert_array_equal(gc[k].numpy(), np.asarray(wc[k]))
        np.testing.assert_array_equal(gr[k].numpy(), np.asarray(wr[k]))
        np.testing.assert_allclose((gc[k] + gr[k]).numpy(), g[k] + r[k], rtol=0,
                                   atol=2 ** -23 * np.abs(g[k] + r[k]).max())
        if k != "z":    # int8 codes of a per-leaf symmetric scale
            s = float(np.abs(g[k] + r[k]).max()) / 127
            codes = gc[k].numpy() / s
            assert np.abs(codes - np.round(codes)).max() < 1e-3
            assert np.abs(np.round(codes)).max() == 127
    state = compress.compress_init(tg)
    applied, total = torch.zeros(13), torch.zeros(13)
    for i in range(20):
        step_g = {"b": torch.from_numpy(rng.standard_normal(13).astype(np.float32))}
        cg, state = compress.compressed_grads(step_g, compress.CompressState(
            {"b": state.residual["b"]}))
        applied, total = applied + cg["b"], total + step_g["b"]
    np.testing.assert_allclose((applied + state.residual["b"]).numpy(), total.numpy(),
                               rtol=1e-4, atol=1e-4)
    # quantized_psum is ported (tests/test_torch_dist_gloo.py sums over
    # two ranks); without a group or an ambient mesh it has no ranks
    with pytest.raises(ValueError, match="group="):
        collectives.quantized_psum({"a": tg["a"]}, "data")


# ------------------------------------------------------------- data, ckpt

def test_synthetic_stream_batches_bit_identical_to_reference():
    kw = dict(vocab=1000, global_batch=6, seq_len=12, seed=5)
    for extra in ({}, {"n_hosts": 3, "host_index": 2, "learnable": False,
                       "extra_specs": {"img": ((2, 3), np.float32)}}):
        ref, port = RefStream(**kw, **extra), SyntheticLMStream(**kw, **extra)
        for _ in range(3):
            a, b = ref.next(), port.next()
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])
                assert b[k].dtype == a[k].dtype
        assert port.state_dict() == ref.state_dict()
    # resume and prefetch reproduce the stream
    port = SyntheticLMStream(**kw)
    port.load_state_dict({"step": 7, "seed": 5})
    np.testing.assert_array_equal(port.next()["tokens"], RefStream(**kw).batch_at(7)["tokens"])
    pre = SyntheticLMStream(**kw)
    pre.start_prefetch()
    try:
        for i in range(3):
            np.testing.assert_array_equal(pre.next_prefetched()["labels"],
                                          RefStream(**kw).batch_at(i)["labels"])
    finally:
        pre.stop()
    with pytest.raises(AssertionError, match="seed"):
        port.load_state_dict({"step": 0, "seed": 6})
    dev = to_device(RefStream(**kw).batch_at(0), "cpu")
    assert dev["tokens"].dtype == torch.int32 and dev["tokens"].shape == (6, 12)


def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": adamw.AdamWState(step=torch.tensor(5, dtype=torch.int32),
                                    mu={"w": torch.ones(2, 3)}, nu={"w": torch.zeros(2, 3)}),
            "step": torch.tensor(5, dtype=torch.int32)}


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_roundtrip_and_latest(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    state = _state()
    mgr.save(5, state, extra={"data_step": 5})
    with torch.no_grad():           # the step updates in place after save
        state["params"]["w"] += 1
    mgr.save(9, state)
    mgr.wait()
    assert mgr.latest_step() == 9 and mgr.all_steps() == [5, 9]
    target = _state()
    for t in target["params"].values():
        t.zero_()
    out = mgr.restore(5, target)
    assert out is target
    assert torch.equal(target["params"]["w"], torch.arange(6.0).reshape(2, 3))
    assert target["opt"].step.dtype == torch.int32 and int(target["opt"].step) == 5
    assert mgr.manifest(5)["extra"]["data_step"] == 5
    mgr.restore(9, target)
    assert torch.equal(target["params"]["w"], torch.arange(6.0).reshape(2, 3) + 1)
    # the layout is the reference's: its manager reads the port's files
    with np.load(tmp_path / "step_0000000009" / "arrays.npz") as z:
        assert sorted(z.files) == ["opt/mu/w", "opt/nu/w", "opt/step", "params/w", "step"]
    assert RefManager(tmp_path).latest_step() == 9


def test_checkpoint_retention_crash_safety_and_missing_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path / "a", keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.zeros(3)})
    assert mgr.all_steps() == [3, 4]
    mgr = CheckpointManager(tmp_path / "b")
    mgr.save(3, {"w": torch.ones(2)})
    (tmp_path / "b" / "step_0000000007.tmp").mkdir()         # crashed mid-save
    assert mgr.latest_step() == 3 and CheckpointManager(tmp_path / "b").latest_step() == 3
    (tmp_path / "b" / "LATEST").unlink()                      # LATEST lost: scan
    assert CheckpointManager(tmp_path / "b").latest_step() == 3
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(3, {"w": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, {"w": torch.zeros(3)})
    bf = CheckpointManager(tmp_path / "c")
    x = torch.randn(5).to(torch.bfloat16)
    bf.save(1, {"x": x})
    y = bf.restore(1, {"x": torch.zeros(5, dtype=torch.bfloat16)})["x"]
    assert torch.equal(x, y)


def test_calibration_matches_reference():
    rng = np.random.default_rng(0)
    samples = [(rng.standard_normal((7, 33)) * 2 + 0.3).astype(np.float32) for _ in range(3)]
    js, ts = [jnp.asarray(s) for s in samples], [torch.from_numpy(s) for s in samples]
    for pct in (99.9, 90.0, 50.0, 100.0):
        for got, want in zip(calibrate.percentile_stats(ts, pct),
                             ref_cal.percentile_stats(js, pct)):
            np.testing.assert_allclose(float(got), float(want), rtol=2.4e-7)
    for kw in (dict(bit_width=8), dict(bit_width=4, signed=False, symmetric=False),
               dict(bit_width=3, narrow=True)):
        for name in ("calibrate_minmax", "calibrate_percentile", "calibrate_mse"):
            got = getattr(calibrate, name)(ts, TensorQuant(**kw))
            want = getattr(ref_cal, name)(js, RefTQ(**kw))
            for g, w in zip(got, want):
                np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# --------------------------------------------- the train step vs the reference

def _batch(rng, vocab):
    return {k: rng.integers(0, vocab, (4, 8)).astype(np.int32) for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def _reference_run(arch, recipe, dtype, z_loss=1e-4):
    """The reference's state after one step (the carried state), its
    gradient there on the next batch (under fake quant), then 3 steps: (carried state as
    numpy, batches, gradient, [(loss, grad_norm)], final params)."""
    rc, _ = lp.configs(arch, recipe, dtype)
    hyper = ref_loop.TrainHyper(**HYPER, z_loss=z_loss)
    tree = jax.tree.map(jnp.asarray, lp.reference_tree(arch))
    state = {"params": tree, "opt": ref_adamw.adamw_init(tree),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(ref_loop.make_train_step(rc, hyper))
    rng = np.random.default_rng(0)
    state, _ = step(state, jax.tree.map(jnp.asarray, _batch(rng, rc.vocab)))
    carried = jax.tree.map(np.asarray, state)
    batches = [_batch(rng, rc.vocab) for _ in range(3)]
    loss = grads = None
    if recipe != "fp32":         # the gradient is compared under fake quant
        (loss, _), grads = jax.jit(jax.value_and_grad(ref_loop.loss_fn, has_aux=True),
                                   static_argnums=(2, 3))(
            state["params"], jax.tree.map(jnp.asarray, batches[0]), rc, hyper)
        loss, grads = float(loss), jax.tree.map(np.asarray, grads)
    metrics = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return carried, batches, loss, grads, metrics, jax.tree.map(np.asarray, state["params"])


def _port_gradient(arch, recipe, dtype, z_loss=1e-4):
    """The port's loss and gradient at the carried state."""
    _, pc = lp.configs(arch, recipe, dtype)
    carried, batches, *_ = _reference_run(arch, recipe, dtype)
    hyper = loop.TrainHyper(**HYPER, z_loss=z_loss)
    state = loop.train_state_from_reference(carried, pc, hyper, "cpu")
    loss, _ = loop.loss_fn(state["params"], to_device(batches[0], "cpu"), pc, hyper)
    named = dict(state["params"].named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(named.items(), grads)}


def _bf16_readings(arch, z_loss=1e-4):
    """(loss rel, whole-gradient rel-L2, worst leaf rel-L2) of the port's
    bf16 gradient against the reference's."""
    _, pc = lp.configs(arch, "w8a8kv8", "bfloat16")
    _, _, rloss, rgrads, _, _ = _reference_run(arch, "w8a8kv8", "bfloat16")
    want = _named(rgrads, pc)
    loss, got = _port_gradient(arch, "w8a8kv8", "bfloat16", z_loss)
    diff2 = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    norm2 = sum(float((want[k] ** 2).sum()) for k in want)
    worst = max(float((got[k] - want[k]).norm() / want[k].norm()) for k in want)
    return abs(loss / rloss - 1), (diff2 / norm2) ** 0.5, worst


BF16_BOUNDS = (1e-4, 0.02, 0.05)     # loss rel, whole-gradient rel-L2, worst leaf


@pytest.mark.parametrize("arch,recipe,dtype", [
    ("qwen2-1.5b", "fp32", "float32"), ("olmo-1b", "fp32", "float32"),
    ("starcoder2-3b", "fp32", "float32"), ("qwen2-1.5b", "w8a8kv8", "float32"),
    ("qwen2-1.5b", "w8a8kv8", "bfloat16")])
def test_train_step_matches_reference(arch, recipe, dtype):
    _, pc = lp.configs(arch, recipe, dtype)
    carried, batches, rloss, rgrads, rmetrics, rparams = _reference_run(arch, recipe, dtype)
    hyper = loop.TrainHyper(**HYPER)
    state = loop.train_state_from_reference(carried, pc, hyper, "cpu")
    assert int(state["step"]) == int(state["opt"].step) == 1
    if dtype == "bfloat16":
        readings = _bf16_readings(arch)
        assert all(r <= b for r, b in zip(readings, BF16_BOUNDS)), readings
    elif recipe != "fp32":
        loss, got = _port_gradient(arch, recipe, dtype)
        want = _named(rgrads, pc)
        beyond = sum(int((torch.abs(got[k] - want[k]) > TIGHT * (1 + want[k].abs())).sum())
                     for k in want)
        assert beyond <= 0.01 * sum(v.numel() for v in want.values()), beyond
        assert loss == pytest.approx(rloss, rel=TIGHT)
    step = loop.make_train_step(pc, hyper)
    for b, (rl, rg) in zip(batches, rmetrics):
        state, m = step(state, to_device(b, "cpu"))
        assert all(v.device.type == "cpu" and v.ndim == 0 for v in m.values())
        if dtype == "float32":
            assert float(m["loss"]) == pytest.approx(rl, rel=TIGHT)
            assert float(m["grad_norm"]) == pytest.approx(rg, rel=TIGHT)
        else:
            assert float(m["loss"]) == pytest.approx(rl, rel=BF16_BOUNDS[0])
    assert int(state["step"]) == int(state["opt"].step) == 4
    if dtype == "float32":
        want = _named(rparams, pc)
        for k, p in state["params"].named_parameters():
            np.testing.assert_allclose(f32(p), want[k].numpy(), rtol=0, atol=TIGHT, err_msg=k)


_BACKWARD = ste._QuantSTE.backward


def _no_window(ctx, g):
    out = list(_BACKWARD(ctx, g))
    out[0] = g
    return tuple(out)


def _no_scale_grad(ctx, g):
    out = list(_BACKWARD(ctx, g))
    out[1] = None
    return tuple(out)


@pytest.mark.parametrize("fault", ["gx without its clip window", "scale gradient dropped",
                                   "attention detached", "z-loss dropped"])
def test_bf16_bound_fails_on_planted_faults(fault):
    """Each planted fault lands beyond one of BF16_BOUNDS, so the bound
    tells a sound bf16 train step from a broken one."""
    attn = transformer.chunked_attention
    patches = {
        "gx without its clip window": mock.patch.object(
            ste._QuantSTE, "backward", staticmethod(_no_window)),
        "scale gradient dropped": mock.patch.object(
            ste._QuantSTE, "backward", staticmethod(_no_scale_grad)),
        "attention detached": mock.patch.object(
            transformer, "chunked_attention", lambda *a, **k: attn(*a, **k).detach()),
    }
    z_loss = 0.0 if fault == "z-loss dropped" else 1e-4
    if fault in patches:
        with patches[fault]:
            readings = _bf16_readings("qwen2-1.5b", z_loss)
    else:
        readings = _bf16_readings("qwen2-1.5b", z_loss)
    assert any(r > b for r, b in zip(readings, BF16_BOUNDS)), (fault, readings)


# ------------------------------------------------------------- train e2e

def test_train_state_specs_and_init():
    cfg = get_smoke_config("qwen2-1.5b")
    hyper = loop.TrainHyper(compress_grads=True)
    specs = loop.train_state_specs(cfg, hyper)
    state = loop.init_train_state(0, cfg, hyper, "cpu")
    from repro_torch.ckpt.manager import _flatten
    fs, fl = _flatten(specs), _flatten(state)
    assert fs.keys() == fl.keys() and "opt/mu/layers.1.attn.wq" in fs
    for k in fs:
        assert fs[k].device.type == "meta"
        assert (fs[k].shape, fs[k].dtype) == (fl[k].shape, fl[k].dtype), k
    assert all(p.requires_grad for p in state["params"].parameters())
    # serving parameters stay frozen
    assert not any(p.requires_grad for p in api.init_params(0, cfg, "cpu").parameters())


def test_differentiated_attention_takes_the_plain_path():
    """A call autograd differentiates never reaches B7's wrapper: the
    train step runs chunked_attention; forward without gradients and
    prefill still take B7 (its twin here on the CPU)."""
    cfg = get_smoke_config("qwen2-1.5b")
    state = loop.init_train_state(0, cfg, loop.TrainHyper(), "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(0))}
    batch["labels"] = batch["tokens"]
    calls = []
    real = transformer.flash_attention

    def spy(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)
    with mock.patch.object(transformer, "flash_attention", spy):
        loop.make_train_step(cfg, loop.TrainHyper())(state, batch)
        assert calls == []
        with torch.no_grad():
            api.forward(state["params"], batch, cfg)
        api.prefill(state["params"], batch, cfg, 8)
    assert calls == [False] * (2 * cfg.n_layers)
    assert not transformer.takes_flash(8, 0, 8, differentiated=True)


def _smoke_step(arch, hyper, seed=0):
    cfg = get_smoke_config(arch)
    return cfg, loop.init_train_state(seed, cfg, hyper, "cpu"), loop.make_train_step(cfg, hyper)


def test_train_loss_decreases_smoke():
    hyper = loop.TrainHyper(peak_lr=3e-3, warmup_steps=5, total_steps=60, z_loss=0.0)
    cfg, state, step = _smoke_step("qwen2-1.5b", hyper)
    stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=8, seq_len=16, seed=0)
    losses = []
    for _ in range(40):
        state, m = step(state, to_device(stream.next(), "cpu"))
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses[::8]


def test_train_microbatch_equivalence_and_remat():
    """microbatches=2 against 1 (the reference's bound, 5e-3), and remat
    on against off (the same computation: equal parameters)."""
    cfg = get_smoke_config("olmo-1b")
    batch = api.make_batch(torch.Generator().manual_seed(1), cfg, 4, 8, "cpu")
    out = {}
    for name, mbs, remat in (("one", 1, False), ("two", 2, False), ("remat", 1, True)):
        hyper = loop.TrainHyper(microbatches=mbs, z_loss=0.0)
        c = cfg.replace(remat=remat)
        state = loop.init_train_state(1, c, hyper, "cpu")
        state, _ = loop.make_train_step(c, hyper)(state, batch)
        out[name] = dict(state["params"].named_parameters())
    for k, p in out["one"].items():
        assert float((p - out["two"][k]).abs().max()) < 5e-3, k
        assert torch.equal(p, out["remat"][k]), k


def test_train_resume_from_checkpoint_and_compression(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run; the compressed
    step keeps compressed + new residual == grad + old residual."""
    hyper = loop.TrainHyper(z_loss=0.0, warmup_steps=2, total_steps=20, compress_grads=True)
    cfg, state, step = _smoke_step("olmo-1b", hyper)
    stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=4, seq_len=8, seed=2)
    mgr = CheckpointManager(tmp_path)
    for _ in range(3):
        state, _ = step(state, to_device(stream.next(), "cpu"))
    mgr.save(3, state, extra=stream.state_dict())
    for _ in range(3):
        state, m_ref = step(state, to_device(stream.next(), "cpu"))
    cfg2, state2, _ = _smoke_step("olmo-1b", hyper, seed=9)      # other weights
    stream2 = SyntheticLMStream(vocab=cfg.vocab, global_batch=4, seq_len=8, seed=2)
    st = mgr.latest_step()
    mgr.restore(st, state2)
    stream2.load_state_dict(mgr.manifest(st)["extra"])
    assert int(state2["step"]) == 3
    for _ in range(3):
        state2, m_res = step(state2, to_device(stream2.next(), "cpu"))
    assert float(m_res["loss"]) == pytest.approx(float(m_ref["loss"]), rel=1e-5)
    # the compression invariant, on the gradient of one more step
    named = dict(state2["params"].named_parameters())
    old = {k: v.clone() for k, v in state2["compress"].residual.items()}
    loss, _ = loop.loss_fn(state2["params"], to_device(stream2.next(), "cpu"), cfg2, hyper)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    comp, new = compress.compressed_grads(grads, state2["compress"])
    for k in grads:
        lhs, rhs = comp[k] + new.residual[k], grads[k] + old[k]
        assert float((lhs - rhs).abs().max()) <= 2 ** -23 * float(rhs.abs().max()), k


def test_train_launcher_on_cpu(tmp_path):
    """The launcher end to end; a run that crashes at step 4 restarts,
    resumes from step 3 with the stream's state and reproduces steps 4-6
    of the uninterrupted run."""
    from repro_torch.launch import train as launcher
    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "6", "--global-batch", "2",
            "--seq", "16", "--ckpt-every", "3", "--device", "cpu"]
    full = launcher.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert full["start"] == 0 and sorted(full["losses"]) == [1, 2, 3, 4, 5, 6]
    assert CheckpointManager(tmp_path / "a").all_steps() == [3, 6]
    real = launcher.make_train_step
    calls = []

    def crashing(cfg, hyper):
        fn = real(cfg, hyper)

        def step(state, batch):
            calls.append(int(state["step"]))
            if len(calls) == 4:
                raise RuntimeError("injected fault at step 4")
            return fn(state, batch)
        return step
    with mock.patch.object(launcher, "make_train_step", crashing), \
            mock.patch("repro_torch.dist.fault.RestartPolicy.delay_s", lambda *a: 0.0):
        resumed = launcher.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert calls == [0, 1, 2, 3, 3, 4, 5] and resumed["start"] == 3
    for s in (4, 5, 6):
        assert resumed["losses"][s] == pytest.approx(full["losses"][s], rel=1e-5)
    again = launcher.main(args + ["--ckpt-dir", str(tmp_path / "a")])   # nothing left
    assert again["start"] == 6 and again["losses"] == {}
