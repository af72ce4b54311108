"""Decoder-only transformer stack, dense family (counterpart of
``repro.models.transformer``).

The parameters are ``nn.Module``s named after the reference's pytree keys
(``Transformer.layers`` is an ``nn.ModuleList`` of ``Block``s); ``forward``
gives the training-path logits, ``prefill`` runs a prompt and fills the
KV cache, ``decode_step`` runs one token against it.  The cache is a list
with one ``{"k", "v"}`` dict per layer, each (B, C, KV, hd) as in the
reference.  Unlike the reference's functional update, ``prefill`` and
``decode_step`` write the new entries into the cache tensors in place
(one token's keys and values per step instead of a copy of the cache).
``forward`` is differentiable: QAT trains through it (``train/loop.py``)
with the straight-through gradients of ``core/ste.py``; ``prefill`` and
``decode_step`` run without autograd.

Attention: the full-prefix cases (``forward`` and ``prefill``: no query
offset, as many keys as queries) run in the flash-attention
kernel B7 (``kernels/flash_attention.py``), which computes the same
function as the reference's ``chunked_attention`` there: the reference's
extra cache positions are masked and each adds exactly 0.  B7 has no
backward, so a call that autograd differentiates (a train step) runs the
reference's own training attention, the plain ``chunked_attention``, as
does every other case (decode).  On CUDA tensors B7 launches or raises.

``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``), as the reference wraps each layer in
``jax.checkpoint``.

QONNX quantization enters through ``repro_torch.quantize.layers`` at every
linear (recipe-controlled), and at the KV-cache write.  The ``moe``,
``vlm``, ``hybrid``, ``ssm`` and ``audio`` families are not ported yet
(ROADMAP A17).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.quantize.layers import qlinear, quant_kv
from .common import (
    ModelConfig,
    apply_rope,
    chunked_attention,
    ffn_apply,
    ffn_param_shapes,
    init_,
    norm,
    sinusoidal_embedding,
    softcap,
)

PORTED_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet "
            "(ROADMAP A17); the port runs the dense family")


# ------------------------------------------------------------ parameters

def _param(shape, dtype, device) -> nn.Parameter:
    # serving parameters take no gradient; the train state turns it on
    # (train.loop.init_train_state, train_state_from_reference)
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def attn_param_shapes(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
         "wo": (H * hd, d)}
    if cfg.qkv_bias:
        p.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    return p


def norm_param_shapes(cfg: ModelConfig) -> dict:
    d = (cfg.d_model,)
    if cfg.norm == "rms":
        return {"w": d}
    if cfg.norm == "layernorm":
        return {"g": d, "b": d}
    if cfg.norm == "nonparam":
        return {}
    raise ValueError(cfg.norm)


class Params(nn.Module):
    """A flat set of parameters given as {name: shape}."""

    def __init__(self, shapes: dict, dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, dtype, device))


class Norm(Params):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(norm_param_shapes(cfg), cfg.p_dtype, device)
        self.kind = cfg.norm

    def weight(self):
        """The reference's norm argument: w, (g, b) or None."""
        if self.kind == "rms":
            return self.w
        if self.kind == "layernorm":
            return (self.g, self.b)
        return None


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.attn_norm = Norm(cfg, device)
        self.attn = Params(attn_param_shapes(cfg), cfg.p_dtype, device)
        self.ffn_norm = Norm(cfg, device)
        self.ffn = Params(ffn_param_shapes(cfg), cfg.p_dtype, device)


class Transformer(nn.Module):
    """The parameters of one dense LM: ``embed`` (V, D), ``layers``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (D, V)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.p_dtype, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), cfg.p_dtype, device)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def param_shapes(cfg: ModelConfig) -> dict:
    """{dotted name: shape} of every parameter (one entry per layer)."""
    check_family(cfg)
    out = {"embed": (cfg.vocab, cfg.d_model)}
    layer = {}
    for sub, shapes in (("attn_norm", norm_param_shapes(cfg)),
                        ("attn", attn_param_shapes(cfg)),
                        ("ffn_norm", norm_param_shapes(cfg)),
                        ("ffn", ffn_param_shapes(cfg))):
        layer.update({f"{sub}.{k}": s for k, s in shapes.items()})
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    out.update({f"final_norm.{k}": s for k, s in norm_param_shapes(cfg).items()})
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """{dotted name: tensor on the meta device} of every parameter: shapes
    and dtypes without storage (the reference's ShapeDtypeStruct tree)."""
    return {name: torch.empty(shape, dtype=cfg.p_dtype, device="meta")
            for name, shape in param_shapes(cfg).items()}


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Transformer:
    """Seeded init with the reference's distribution (``common.init_``)."""
    model = Transformer(cfg, device)
    for p in model.parameters():
        init_(p.data, generator)
    return model


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    """Load the reference's parameter pytree, as numpy arrays (layers
    stacked on a leading L axis, layernorm weights as (g, b) tuples)."""
    model = Transformer(cfg, device)

    def put(param: torch.Tensor, value) -> None:
        value = torch.tensor(np.asarray(value))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(value.shape)} for a parameter "
                             f"of shape {tuple(param.shape)}")
        param.data.copy_(value.to(param.dtype))

    def put_norm(mod: Norm, value, i=None) -> None:
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        if cfg.norm == "rms":
            put(mod.w, pick(value))
        elif cfg.norm == "layernorm":
            put(mod.g, pick(value[0]))
            put(mod.b, pick(value[1]))

    put(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        put(model.lm_head, tree["lm_head"])
    if cfg.norm != "nonparam":
        put_norm(model.final_norm, tree["final_norm"])
    lt = tree["layers"]
    for i, blk in enumerate(model.layers):
        if cfg.norm != "nonparam":
            put_norm(blk.attn_norm, lt["attn_norm"], i)
            put_norm(blk.ffn_norm, lt["ffn_norm"], i)
        for sub in ("attn", "ffn"):
            mod = getattr(blk, sub)
            for name, _ in mod.named_parameters():
                put(getattr(mod, name), lt[sub][name][i])
    return model


# ------------------------------------------------------------- attention

def takes_flash(sq: int, q_offset: int, kv_len: int, differentiated: bool = False, *,
                causal: bool = True, window: Optional[int] = None) -> bool:
    """Whether an attention call runs in B7: exactly the calls where B7
    computes the reference's ``chunked_attention`` (causal with no window,
    so every query sees keys 0..q, with no offset and as many valid keys
    as queries) and autograd will not differentiate it (B7 has no
    backward).  B7 is causal only: a non-causal call (an encoder's, a
    cross-attention's) or a windowed one runs the plain path."""
    return (causal and window is None and q_offset == 0 and kv_len == sq
            and not differentiated)


def _flash(q, k, v) -> torch.Tensor:
    """B7 over (B, S, H, hd) / (B, S, KV, hd) tensors: the kernel reads the
    transposed views through their strides and writes in q's layout."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def attention(x, p, cfg: ModelConfig, *, positions, kv_cache=None,
              cache_index: int = 0):
    """Self-attention with an optional KV cache.

    x: (B, S, D).  kv_cache: dict(k=(B, C, KV, hd), v=...) or None; it is
    updated in place.  Returns (out, kv_cache_or_None).
    """
    recipe = cfg.quant
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = qlinear(x, p.wq, getattr(p, "bq", None), recipe=recipe).reshape(B, S, H, hd)
    k = qlinear(x, p.wk, getattr(p, "bk", None), recipe=recipe).reshape(B, S, KV, hd)
    v = qlinear(x, p.wv, getattr(p, "bv", None), recipe=recipe).reshape(B, S, KV, hd)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    idx = int(cache_index)
    if kv_cache is not None:
        if recipe.enabled and recipe.kv_cache_bits:
            k, v = quant_kv(k, v, recipe.kv_cache_bits)
        ck, cv = kv_cache["k"], kv_cache["v"]
        if idx < 0 or idx + S > ck.shape[1]:
            raise ValueError(f"cache of length {ck.shape[1]} cannot take "
                             f"{S} entries at {idx}")
        ck[:, idx:idx + S] = k.to(ck.dtype)
        cv[:, idx:idx + S] = v.to(cv.dtype)
        k, v, kv_len = ck, cv, idx + S
        new_cache = kv_cache
    else:
        kv_len, new_cache = S, None
    differentiated = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if takes_flash(S, idx, kv_len, differentiated, causal=True, window=None):
        out = _flash(q, k[:, :S], v[:, :S])
    else:
        out = chunked_attention(q, k, v, causal=True, q_offset=idx,
                                chunk=cfg.attn_chunk, kv_len=kv_len)
    out = out.reshape(B, S, H * hd)
    return qlinear(out, p.wo, recipe=recipe), new_cache


# ------------------------------------------------------------------ blocks

def block(x, lp: Block, cfg: ModelConfig, *, positions, kv_cache=None,
          cache_index: int = 0):
    """One transformer block.  Returns (x, kv_cache, aux)."""
    h = norm(x, lp.attn_norm.weight(), cfg.norm)
    a, new_cache = attention(h, lp.attn, cfg, positions=positions,
                             kv_cache=kv_cache, cache_index=cache_index)
    x = x + a
    h = norm(x, lp.ffn_norm.weight(), cfg.norm)
    return x + ffn_apply(h, lp.ffn, cfg, cfg.quant), new_cache, 0.0


def embed_inputs(params: Transformer, batch: dict, cfg: ModelConfig):
    """Token embedding.  Returns (h, n_prefix)."""
    check_family(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    h = params.embed[tokens.long()].to(cfg.act_dtype)
    if cfg.pos == "sinusoidal":
        emb = sinusoidal_embedding(h.shape[1], cfg.d_model, h.device)
        h = h + emb.to(h.dtype)[None]
    return h, 0


def _logits(params: Transformer, h, cfg: ModelConfig) -> torch.Tensor:
    head = params.head()
    logits = torch.matmul(h, head.to(h.dtype))
    return softcap(logits, cfg.logits_softcap).to(torch.float32)


def _train_block(x, lp: Block, cfg: ModelConfig, positions):
    return block(x, lp, cfg, positions=positions)[0]


def forward(params: Transformer, batch: dict, cfg: ModelConfig):
    """Training-path logits, differentiable.  batch: tokens (B, S).

    Returns (logits (B, S, V) float32, aux dict)."""
    h, n_prefix = embed_inputs(params, batch, cfg)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.layers:
        if remat:       # the block draws no random numbers: no RNG state kept
            h = checkpoint(_train_block, h, lp, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _train_block(h, lp, cfg, positions)
    h = norm(h, params.final_norm.weight(), cfg.norm)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=h.device),
           "n_prefix": n_prefix}
    return _logits(params, h, cfg), aux


# ------------------------------------------------------------------ serving

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Per-layer cache shape and dtype: k and v are (B, C, KV, hd)."""
    check_family(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"n_layers": cfg.n_layers, "k": shape, "v": shape,
            "dtype": cfg.act_dtype}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> list:
    spec = cache_specs(cfg, batch, cache_len)
    return [{"k": torch.zeros(spec["k"], dtype=spec["dtype"], device=device),
             "v": torch.zeros(spec["v"], dtype=spec["dtype"], device=device)}
            for _ in range(spec["n_layers"])]


@torch.no_grad()
def prefill(params: Transformer, batch: dict, cfg: ModelConfig, cache_len: int):
    """Prompt processing: runs the full prompt once, filling the KV cache.

    Returns (last_token_logits (B, V), cache).  cache_len >= prompt length.
    """
    h, _ = embed_inputs(params, batch, cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    cache = init_cache(cfg, B, cache_len, h.device)
    for lp, kc in zip(params.layers, cache):
        h, _, _ = block(h, lp, cfg, positions=positions, kv_cache=kc,
                        cache_index=0)
    h = norm(h[:, -1:], params.final_norm.weight(), cfg.norm)
    return _logits(params, h, cfg)[:, -1], cache


@torch.no_grad()
def decode_step(params: Transformer, cache: list, tokens, cache_index: int,
                cfg: ModelConfig):
    """One decode step: tokens (B, 1) against a cache filled to
    cache_index.  Returns (logits (B, V), cache), the cache updated in
    place."""
    h, _ = embed_inputs(params, {"tokens": tokens}, cfg)
    positions = int(cache_index) + torch.arange(h.shape[1], dtype=torch.int32,
                                                device=h.device)
    for lp, kc in zip(params.layers, cache):
        h, _, _ = block(h, lp, cfg, positions=positions, kv_cache=kc,
                        cache_index=cache_index)
    h = norm(h, params.final_norm.weight(), cfg.norm)
    return _logits(params, h, cfg)[:, -1], cache
