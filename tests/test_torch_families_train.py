"""The vlm and moe families' train steps against the reference, on the
CPU (llava-next-34b, deepseek-moe-16b, moonshot-v1-16b-a3b; the rest of
the families' parity is in ``test_torch_families.py``): one train step
and one W4A8 QAT train step from the reference's carried state against
``jax.jit(make_train_step)``, the vlm prefix sliced off the logits and
the moe ``moe_aux`` in the loss.  moonshot's SMOKE config is deepseek's
under another name: it runs the QAT step only.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as lp  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.quantize.config import W4A8 as REF_W4A8  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402

from repro_torch.data import to_device  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.quantize.config import W4A8  # noqa: E402
from repro_torch.train import loop  # noqa: E402

ARCHS = ("llava-next-34b", "deepseek-moe-16b", "moonshot-v1-16b-a3b")
TIGHT = lp.TIGHT


# ------------------------------------------------ train steps

HYPER = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
# depth of the train cases where it is cut from SMOKE's: the hybrid keeps
# its one group and one of its two tail layers (the reference compiles
# each tail layer unrolled, ~3 s of its step's compile a layer)
TRAIN_LAYERS = {"recurrentgemma-2b": 4}


def _train_batch(rc, seed):
    rng = np.random.default_rng(seed)
    arrays = {k: rng.integers(0, rc.vocab, (2, 8)).astype(np.int32)
              for k in ("tokens", "labels")}
    arrays.update(lp.frontend(rc, 2, seed))
    return arrays


def _train_configs(arch, recipe):
    rc, pc = lp.configs(arch, "fp32", "float32")
    if arch in TRAIN_LAYERS:
        rc, pc = (c.replace(n_layers=TRAIN_LAYERS[arch]) for c in (rc, pc))
    if recipe == "w4a8":
        rc, pc = rc.replace(quant=REF_W4A8), pc.replace(quant=W4A8)
    return rc, pc


@functools.lru_cache(maxsize=None)
def reference_train_run(arch, recipe):
    """The reference's state after one step from its init (the carried
    state, numpy), the next batch, and the next step's metrics and
    parameters."""
    rc, _ = _train_configs(arch, recipe)
    hyper = ref_loop.TrainHyper(**HYPER, moe_aux_weight=0.01 if rc.family == "moe" else 0.0)
    tree = lp.reference_tree(arch)
    if arch in TRAIN_LAYERS:
        # the hybrid's stacked groups stay; its unrolled tail is cut
        tree = dict(tree, tail=tree["tail"][:rc.n_layers % len(rc.block_pattern)])
    tree = jax.tree.map(jnp.asarray, tree)
    state = {"params": tree, "opt": ref_adamw.adamw_init(tree),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(ref_loop.make_train_step(rc, hyper))
    ref_batch = lambda a: {k: jnp.asarray(v) for k, v in a.items()}
    state, _ = step(state, ref_batch(_train_batch(rc, 0)))
    carried = jax.tree.map(np.asarray, state)
    batch = _train_batch(rc, 1)
    state, m = step(state, ref_batch(batch))
    metrics = {k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux", "nll")}
    return carried, batch, metrics, jax.tree.map(np.asarray, state["params"])


def _named(tree, cfg) -> dict:
    model = api.params_from_reference(tree, cfg.replace(param_dtype="float32"), "cpu")
    return {k: v.detach() for k, v in model.named_parameters()}


@pytest.mark.parametrize("arch,recipe", [(a, r) for a in ARCHS[:2] for r in ("fp32", "w4a8")]
                         + [("moonshot-v1-16b-a3b", "w4a8")])
def test_train_step_matches_reference(arch, recipe):
    check_train_step(arch, recipe)


def check_train_step(arch, recipe):
    """One step from the carried state: loss and grad_norm rel 1e-5
    (``tests/test_torch_train.py``'s float32 bounds); moe_aux within 1e-5
    and weighted into the loss.  Parameters: FP32 every entry within
    1e-5.  W4A8: an entry near a rounding tie may quantize to the
    neighbouring code (the W8A8 rule of ``torch_lm_parity.py``), which
    changes the gradient of the entries it touches (0.09 % of deepseek's
    gradient entries here); where the moments are tiny AdamW follows that
    gradient's sign, so at most 1 % of the parameters lie beyond 1e-5 and
    none beyond 2·lr + 1e-5: at this second step |m̂| / √v̂ <= 1 (by
    Cauchy-Schwarz over the two gradients, with b1 0.9 and b2 0.95), so
    each side moves an entry by at most lr plus the same decay."""
    rc, pc = _train_configs(arch, recipe)
    carried, batch, rm, rparams = reference_train_run(arch, recipe)
    hyper = loop.TrainHyper(**HYPER, moe_aux_weight=0.01 if pc.family == "moe" else 0.0)
    state = loop.train_state_from_reference(carried, pc, hyper, "cpu")
    state, m = loop.make_train_step(pc, hyper)(state, to_device(batch, "cpu"))
    assert float(m["loss"]) == pytest.approx(rm["loss"], rel=TIGHT)
    assert float(m["grad_norm"]) == pytest.approx(rm["grad_norm"], rel=TIGHT)
    assert float(m["moe_aux"]) == pytest.approx(rm["moe_aux"], rel=TIGHT)
    if pc.family == "moe":
        assert float(m["loss"]) == pytest.approx(
            float(m["nll"]) + float(m["z_loss"]) + 0.01 * float(m["moe_aux"]), rel=1e-6)
        assert float(m["moe_aux"]) > 0
    want = _named(rparams, pc)
    beyond = total = 0
    for k, p in state["params"].named_parameters():
        d = (p.detach() - want[k]).abs()
        if recipe == "fp32":
            assert float(d.max()) <= TIGHT, k
        assert float(d.max()) <= 2 * HYPER["peak_lr"] + TIGHT, k
        beyond += int((d > TIGHT).sum())
        total += d.numel()
    assert beyond <= 0.01 * total, beyond


def test_vlm_loss_slices_the_image_prefix():
    """loss_fn's nll is the cross-entropy of the logits after the
    n_patches prefix against the labels, and matches the reference's."""
    rc, jp, pc, pp = lp.both_params("llava-next-34b", "fp32", "float32")
    arrays = _train_batch(rc, 5)
    jb, tb = lp.batches(rc, pc, arrays)
    hyper = loop.TrainHyper(z_loss=0.0)
    loss, metrics = loop.loss_fn(pp, tb, pc, hyper)
    logits, _ = api.forward(pp, tb, pc)
    sliced = logits[:, pc.n_patches:]
    want = torch.nn.functional.cross_entropy(sliced.reshape(-1, pc.vocab),
                                             tb["labels"].reshape(-1).long())
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    rloss, _ = jax.jit(ref_loop.loss_fn, static_argnums=(2, 3))(
        jp, jb, rc, ref_loop.TrainHyper(z_loss=0.0))
    assert float(loss) == pytest.approx(float(rloss), rel=TIGHT)
