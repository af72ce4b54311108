"""Shared set-up of the LM parity tests (``test_torch_lm.py``,
``test_torch_generation.py``, ``test_torch_families.py``,
``test_torch_encdec.py``): the SMOKE configs in both packages, the
reference's parameters carried into the port, the families' frontend
stubs, and the tolerances.

Weights: the reference's seeded init, as numpy, with every vector (norm
weights, biases, gates, decays, token-shift mixes) redrawn from N(0, 0.1):
the init leaves them at 0, and a layernorm with g = 0 would zero the
whole residual branch.

Tolerances, by what differs between the two computations:

* float32 (``tight``): the packages sum in other orders and their ``exp``,
  ``rsqrt``, ``pow`` and ``sin``/``cos`` differ by an ulp or so; logits
  within 1e-5 (abs + rel).
* W8A8 on float32 activations: the same, except that a value within
  ulps of a rounding tie may quantize to the neighbouring code: at most
  1 % of the entries beyond the tight bound, none beyond one code of the
  KV cache or 5 % of the largest logit.
* bf16 activations: the quant functions are bit-exact, but XLA's CPU
  fusions keep some bf16 intermediates in float32 (the residual sum
  ``x + a`` feeding the next norm is not rounded to bf16), so one bf16
  step of difference enters per block: logits within 4 bf16 steps of the
  largest logit with a mean below one step; KV-cache codes within one
  step (bf16 ``x / s`` has steps of 0.5 above 64, so codes sit on ties
  and one bf16 step upstream flips them), see ``assert_cache``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import api as ref_api
from repro.quantize.config import FP32 as REF_FP32
from repro.quantize.config import QuantRecipe as RefRecipe

from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.models import api as port_api
from repro_torch.quantize.config import FP32, QuantRecipe

ARCHS = ("qwen2-1.5b", "olmo-1b", "starcoder2-3b")
TIGHT = 1e-5
BF16_STEP = 2.0 ** -8


def configs(arch: str, recipe: str, dtype: str):
    """(reference cfg, port cfg) of an arch's SMOKE config with ``recipe``
    ("fp32" or "w8a8kv8") and activation dtype ``dtype``."""
    rc = ref_smoke(arch).replace(dtype=dtype)
    pc = port_smoke(arch).replace(dtype=dtype)
    if recipe == "fp32":
        return rc.replace(quant=REF_FP32), pc.replace(quant=FP32)
    return (rc.replace(quant=RefRecipe.w_a(8.0, 8.0, kv_cache_bits=8.0)),
            pc.replace(quant=QuantRecipe.w_a(8.0, 8.0, kv_cache_bits=8.0)))


@functools.lru_cache(maxsize=None)
def reference_tree(arch: str, seed: int = 0):
    """The reference's parameters (numpy leaves), vectors redrawn: 1-D
    leaves and 2-D leaves stacked on the layer axis, or, under the
    hybrid's ``groups``, on the group axis."""
    cfg = ref_smoke(arch)
    tree = jax.tree.map(np.asarray, ref_api.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    n_groups = cfg.n_layers // len(cfg.block_pattern) if cfg.block_pattern else None

    def redraw(path, x):
        lead = n_groups if getattr(path[0], "key", None) == "groups" else cfg.n_layers
        vec = x.ndim == 1 or (x.ndim == 2 and x.shape[0] == lead)
        return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype) if vec else x
    return jax.tree_util.tree_map_with_path(redraw, tree)


def both_params(arch: str, recipe: str, dtype: str):
    """(ref cfg, ref params, port cfg, port params on the CPU)."""
    rc, pc = configs(arch, recipe, dtype)
    tree = reference_tree(arch)
    return (rc, jax.tree.map(jnp.asarray, tree), pc,
            port_api.params_from_reference(tree, pc, "cpu"))


def frontend(cfg, batch: int, seed: int = 7) -> dict:
    """The family's stub embeddings as numpy float32 (N(0, 1)):
    ``img_embeds`` (vlm), ``frames`` (audio), nothing otherwise."""
    rng = np.random.default_rng(seed)
    rows = {"vlm": ("img_embeds", cfg.n_patches), "audio": ("frames", cfg.n_frames)}
    if cfg.family not in rows:
        return {}
    name, n = rows[cfg.family]
    return {name: rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)}


def batches(rc, pc, arrays: dict):
    """(reference batch, port batch) of numpy ``arrays``: int arrays as
    they are, the frontend's embeddings cast to each config's activation
    dtype (the port's from the reference's cast values)."""
    jb, tb = {}, {}
    for k, v in arrays.items():
        if v.dtype.kind in "iu":
            jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v)
        else:
            jb[k] = jnp.asarray(v).astype(rc.act_dtype)
            tb[k] = torch.from_numpy(np.array(f32(jb[k]))).to(pc.act_dtype)
    return jb, tb


def tokens(seed: int, vocab: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_logits(got, want, recipe: str, dtype: str) -> None:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    big = float(np.abs(want).max())
    if dtype == "bfloat16":
        assert d.max() <= 4 * BF16_STEP * big, (d.max(), big)
        assert d.mean() <= BF16_STEP * big, (d.mean(), big)
        return
    beyond = d > TIGHT * (1 + np.abs(want))
    if recipe == "fp32":
        assert not beyond.any(), d.max()
        return
    assert beyond.mean() <= 0.01, beyond.mean()
    assert d.max() <= 0.05 * big, (d.max(), big)


def assert_cache(got, want, recipe: str, dtype: str) -> None:
    """One layer's k or v cache (or one decode step's slice of it).

    Under W8A8 each side holds ``s * q`` with its own scale ``s`` (max|x|
    / 127 of the quantized tensor, hence max|cache| / 127) and codes q.
    float32: the scales agree to a few ulps and the codes ``cache / s``
    to one step, on at most 1 % of the entries.  bf16: each value is
    within one step ``s`` of the reference's plus 3·2^-8 of its size: the
    two scales, rounded to bf16, may be one bf16 step (at most 2^-7
    relative) apart, and each side rounds ``s * q`` to bf16 (2^-9 each);
    ``s`` itself is read from the bf16 max, hence its slack of two bf16
    steps.  A bf16 ``x / s`` above 64 has steps of 0.5, so half the codes
    sit on ties that one bf16 step upstream flips: the mean difference
    stays below half a step."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    if recipe == "fp32":
        if dtype == "bfloat16":
            assert (d <= 2 * BF16_STEP * np.abs(want) + TIGHT).all(), d.max()
        else:
            assert (d <= TIGHT * (1 + np.abs(want))).all(), d.max()
        return
    s_got, s_want = np.abs(got).max() / 127, np.abs(want).max() / 127
    if s_want == 0:
        assert s_got == 0
        return
    if dtype == "float32":
        dc = np.abs(got / s_got - want / s_want)
        assert abs(s_got / s_want - 1) <= 2.0 ** -21, (s_got, s_want)
        assert dc.max() <= 1 + 1e-3, dc.max()
        assert (dc > 1e-3).mean() <= 0.01, (dc > 1e-3).mean()
    else:
        assert (d <= s_want * (1 + 2 * BF16_STEP) + 3 * BF16_STEP * np.abs(want)).all(), \
            (d.max(), s_want)
        assert d.mean() <= 0.5 * s_want, (d.mean(), s_want)
