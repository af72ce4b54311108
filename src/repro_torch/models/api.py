"""Unified LM API: family dispatch and the shape cells (counterpart of
``repro.models.api``).

Families: ``dense``, ``moe`` and ``vlm`` -> ``transformer.py``; ``audio``
-> ``encdec.py``; ``ssm`` -> ``rwkv6.py``; ``hybrid`` -> ``rglru.py``.

``params_from_reference`` loads the reference's parameter pytree (as
numpy arrays), so that both packages compute with the same weights: the
port's own ``init_params`` draws the reference's distribution from a
``torch.Generator``, whose bits differ from ``jax.random``'s.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.executor import resolve_device

from . import encdec, rglru, rwkv6, transformer
from .common import ModelConfig, dtensor_scope

# the families outside the decoder-only transformer, by module
FAMILY_MODULES = {"audio": encdec, "ssm": rwkv6, "hybrid": rglru}


def _mod(cfg: ModelConfig):
    mod = FAMILY_MODULES.get(cfg.family)
    if mod is not None:
        return mod
    transformer.check_family(cfg)
    return transformer


def param_shapes(cfg: ModelConfig) -> dict:
    return _mod(cfg).param_shapes(cfg)


def param_specs(cfg: ModelConfig) -> dict:
    """{dotted name: meta-device tensor}: shapes and dtypes, no storage
    (the reference's ShapeDtypeStruct tree)."""
    return {name: torch.empty(shape, dtype=cfg.p_dtype, device="meta")
            for name, shape in param_shapes(cfg).items()}


def reference_layout(cfg: ModelConfig) -> dict:
    """{port name: (reference path, reference shape, stacked)}: where each
    parameter sits in the reference's tree (``params_from_reference``'s
    source) and that leaf's shape, its layers stacked on a leading axis
    where ``stacked``.  ``dist.sharding.param_pspecs`` judges each port
    leaf by it."""
    return _mod(cfg).reference_layout(cfg)


def empty_params(cfg: ModelConfig, device=None):
    """The model with zeroed parameters on ``device`` (CUDA unless given
    another); on ``meta``, shapes and dtypes only (a dry-run's)."""
    model_class = {"audio": encdec.EncDec, "ssm": rwkv6.Rwkv6,
                   "hybrid": rglru.Hybrid}.get(cfg.family)
    if model_class is None:
        transformer.check_family(cfg)
        model_class = transformer.Transformer
    return model_class(cfg, resolve_device(device))


def init_params(generator, cfg: ModelConfig, device=None):
    """Seeded parameters on ``device`` (CUDA unless given another).
    ``generator`` is a ``torch.Generator`` on that device, or an int seed
    for one."""
    device = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    return _mod(cfg).init_params(generator, cfg, device)


def params_from_reference(tree: dict, cfg: ModelConfig, device=None):
    """The reference's parameter pytree (numpy leaves) on ``device`` (CUDA
    unless given another)."""
    return _mod(cfg).params_from_reference(tree, cfg, resolve_device(device))


def forward(params, batch, cfg: ModelConfig):
    with dtensor_scope(params, batch):
        return _mod(cfg).forward(params, batch, cfg)


def prefill(params, batch, cfg: ModelConfig, cache_len: int):
    with dtensor_scope(params, batch):
        return _mod(cfg).prefill(params, batch, cfg, cache_len)


def decode_step(params, cache, tokens, cache_index: int, cfg: ModelConfig):
    with dtensor_scope(params, cache, tokens):
        return _mod(cfg).decode_step(params, cache, tokens, cache_index, cfg)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    return _mod(cfg).cache_specs(cfg, batch, cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """A zeroed cache on ``device`` (CUDA unless given another): KV
    entries, or the recurrent families' per-layer states."""
    return _mod(cfg).init_cache(cfg, batch, cache_len, resolve_device(device))


# --------------------------------------------------------------- shapes

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason."""
    if shape_name == "long_500k" and not cfg.sub_quadratic():
        return ("full-attention arch: O(S^2) at 524k tokens violates the "
                "sub-quadratic requirement")
    return None


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins (shapes and dtypes, no storage) for every
    model input of a shape cell, as the reference's ShapeDtypeStructs:

    train   -> {"batch": {tokens, labels [, frames | img_embeds]}}
    prefill -> {"batch": {tokens [, frames | img_embeds]}, "cache_len"}
    decode  -> {"cache", "tokens" (B, 1), "cache_index" (0-d int32)}

    The vlm's ``cache_len`` is S + n_patches.  The decode cache is the
    port's: one dict per layer of meta tensors (``init_cache``), where
    the reference stacks the layers on a leading axis."""
    sh = SHAPES[shape_name]
    return specs_for(cfg, sh["kind"], sh["global_batch"], sh["seq_len"])


def specs_for(cfg: ModelConfig, kind: str, B: int, S: int) -> dict:
    """``input_specs`` of a cell of ``kind`` with B rows of S tokens."""
    meta = lambda shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device="meta")
    if kind == "train":
        spec = {"tokens": meta((B, S)), "labels": meta((B, S))}
        spec.update(_frontend_specs(cfg, B))
        return {"batch": spec}
    if kind == "prefill":
        spec = {"tokens": meta((B, S))}
        spec.update(_frontend_specs(cfg, B))
        return {"batch": spec, "cache_len": S + n_prefix(cfg)}
    return {"cache": init_cache(cfg, B, S, "meta"), "tokens": meta((B, 1)),
            "cache_index": meta(())}


def _frontend_specs(cfg: ModelConfig, B: int) -> dict:
    """The modality frontend's stub inputs for B rows, as meta tensors."""
    return {name: torch.empty((B,) + shape, dtype=cfg.act_dtype, device="meta")
            for name, shape in frontend_shapes(cfg).items()}


def make_batch(generator: torch.Generator, cfg: ModelConfig, batch: int,
               seq: int, device=None) -> dict:
    """Concrete random batch (smoke tests / examples): tokens and labels,
    and the modality frontend's stub embeddings (the audio family's
    ``frames`` (B, n_frames, D), the vlm family's ``img_embeds``
    (B, n_patches, D), standard normal in the activation dtype), drawn on
    ``generator``'s device and placed on ``device`` (CUDA unless given
    another)."""
    _mod(cfg)
    device = resolve_device(device)
    out = {k: torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                            dtype=torch.int32, device=generator.device).to(device)
           for k in ("tokens", "labels")}
    out.update(frontend_batch(generator, cfg, batch, device))
    return out


def frontend_shapes(cfg: ModelConfig) -> dict:
    """The modality frontend's stub embeddings, per batch row: {"frames":
    (n_frames, D)} (audio), {"img_embeds": (n_patches, D)} (vlm), {} for
    the text families."""
    if cfg.family == "audio":
        return {"frames": (cfg.n_frames, cfg.d_model)}
    if cfg.family == "vlm":
        return {"img_embeds": (cfg.n_patches, cfg.d_model)}
    return {}


def n_prefix(cfg: ModelConfig) -> int:
    """Positions the modality frontend prepends to the token sequence: the
    vlm family's ``n_patches`` image embeddings, 0 for every other family
    (whisper's frames feed its encoder, not the decoder's sequence)."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def frontend_batch(generator: torch.Generator, cfg: ModelConfig, batch: int,
                   device=None) -> dict:
    """``frontend_shapes``' embeddings for ``batch`` rows."""
    return {name: torch.randn((batch,) + shape, generator=generator, dtype=torch.float32,
                              device=generator.device).to(cfg.act_dtype)
            .to(resolve_device(device))
            for name, shape in frontend_shapes(cfg).items()}
