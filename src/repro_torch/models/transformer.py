"""Decoder-only transformer stack: dense GQA, fine-grained MoE, VLM
(counterpart of ``repro.models.transformer``).

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
linear (recipe-controlled), and at the KV-cache write.

vlm: ``img_embeds`` (B, n_patches, D), projected by ``img_proj``, are
prepended to the token embeddings; positions, the cache and the logits
run over the whole S_total = n_patches + S.  moe: ``moe_ffn`` replaces
the block's FFN (its parameters are the block's ``moe``), and its
load-balance term is summed over the layers into ``aux["moe_aux"]``.
The audio family is ``models/encdec.py``, the ssm family
``models/rwkv6.py`` and the hybrid family ``models/rglru.py``, whose
windowed attention layers call ``attention`` and ``attend`` here with
their window.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import reduce_partial
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.quantize.layers import qlinear, qlinear_experts, quant_kv
from .common import (
    ModelConfig,
    apply_rope,
    chunked_attention,
    cache_zeros,
    constrain_logits,
    constrain_residual,
    ffn_apply,
    on_shards,
    pin_batch,
    ffn_param_shapes,
    init_,
    is_dtensor,
    norm,
    reshape,
    sinusoidal_embedding,
    softcap,
)

PORTED_FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family in PORTED_FAMILIES:
        return
    from .api import FAMILY_MODULES     # api imports this module
    module = FAMILY_MODULES.get(cfg.family)
    if module is None:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    raise ValueError(f"{cfg.name} ({cfg.family} family) runs in models/"
                     f"{module.__name__.rsplit('.', 1)[-1]}.py, not in the decoder-only "
                     "transformer")


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


def moe_param_shapes(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": (d, E), "we_gate": (E, d, f), "we_up": (E, d, f),
         "we_down": (E, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_ff
        p.update(ws_gate=(d, fs), ws_up=(d, fs), ws_down=(fs, d))
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
        key, shapes = ffn_block_shapes(cfg)
        setattr(self, key, Params(shapes, cfg.p_dtype, device))


def ffn_block_shapes(cfg: ModelConfig) -> tuple:
    """The block's feed-forward: ("moe", its experts' shapes) for the moe
    family, else ("ffn", the FFN's)."""
    if cfg.family == "moe":
        return "moe", moe_param_shapes(cfg)
    return "ffn", ffn_param_shapes(cfg)


class Transformer(nn.Module):
    """The parameters of one LM: ``embed`` (V, D), ``layers``,
    ``final_norm``, without tied embeddings ``lm_head`` (D, V), and for
    the vlm family the patch projector ``img_proj`` (D, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.p_dtype, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), cfg.p_dtype, device)
        if cfg.family == "vlm":
            self.img_proj = _param((cfg.d_model, cfg.d_model), cfg.p_dtype, device)

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
                        ffn_block_shapes(cfg)):
        layer.update({f"{sub}.{k}": s for k, s in shapes.items()})
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    out.update({f"final_norm.{k}": s for k, s in norm_param_shapes(cfg).items()})
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    if cfg.family == "vlm":
        out["img_proj"] = (cfg.d_model, cfg.d_model)
    return out


def norm_layout(cfg: ModelConfig, prefix: str, ref_path: tuple, lead: tuple = ()) -> dict:
    """The reference layout (see ``reference_layout``) of a ``Norm`` at
    ``prefix``, whose reference leaf is ``ref_path``: ``w``, or layernorm's
    (g, b) tuple; ``lead`` is the reference's stacking axis, if any."""
    d = (cfg.d_model,)
    if cfg.norm == "rms":
        return {f"{prefix}.w": (ref_path, lead + d, bool(lead))}
    if cfg.norm == "layernorm":
        return {f"{prefix}.{k}": (ref_path + (i,), lead + d, bool(lead))
                for i, k in enumerate(("g", "b"))}
    return {}


def params_layout(shapes: dict, prefix: str, ref_path: tuple, lead: tuple = ()) -> dict:
    """The reference layout of a ``Params`` of ``shapes`` at ``prefix``,
    whose reference subtree is ``ref_path``, stacked on ``lead``."""
    return {f"{prefix}.{k}": (ref_path + (k,), lead + tuple(s), bool(lead))
            for k, s in shapes.items()}


def reference_layout(cfg: ModelConfig) -> dict:
    """{port name: (reference path, reference shape, stacked)} for every
    parameter: where ``params_from_reference`` takes it from, and the
    shape of that reference leaf (its layers stacked on a leading L axis,
    which ``stacked`` marks).  The sharding rules read it
    (``dist.sharding.param_pspecs``)."""
    check_family(cfg)
    out = {"embed": (("embed",), (cfg.vocab, cfg.d_model), False)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (("lm_head",), (cfg.d_model, cfg.vocab), False)
    if cfg.family == "vlm":
        out["img_proj"] = (("img_proj",), (cfg.d_model, cfg.d_model), False)
    out.update(norm_layout(cfg, "final_norm", ("final_norm",)))
    lead = (cfg.n_layers,)
    ffn_key, ffn_shapes = ffn_block_shapes(cfg)
    for i in range(cfg.n_layers):
        pre = f"layers.{i}"
        out.update(norm_layout(cfg, f"{pre}.attn_norm", ("layers", "attn_norm"), lead))
        out.update(params_layout(attn_param_shapes(cfg), f"{pre}.attn", ("layers", "attn"), lead))
        out.update(norm_layout(cfg, f"{pre}.ffn_norm", ("layers", "ffn_norm"), lead))
        out.update(params_layout(ffn_shapes, f"{pre}.{ffn_key}", ("layers", ffn_key), lead))
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Transformer:
    """Seeded init with the reference's distribution (``common.init_``)."""
    model = Transformer(cfg, device)
    for p in model.parameters():
        init_(p.data, generator)
    return model


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    """Load the reference's parameter pytree, as numpy arrays (layers
    stacked on a leading L axis, a moe block's experts (L, E, ...),
    layernorm weights as (g, b) tuples)."""
    model = Transformer(cfg, device)
    put_param(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        put_param(model.lm_head, tree["lm_head"])
    if cfg.family == "vlm":
        put_param(model.img_proj, tree["img_proj"])
    if cfg.norm != "nonparam":
        put_norm_param(model.final_norm, tree["final_norm"])
    lt = tree["layers"]
    for i, blk in enumerate(model.layers):
        if cfg.norm != "nonparam":
            put_norm_param(blk.attn_norm, lt["attn_norm"], i)
            put_norm_param(blk.ffn_norm, lt["ffn_norm"], i)
        for sub in ("attn", ffn_block_shapes(cfg)[0]):
            put_params(getattr(blk, sub), lt[sub], i)
    return model


def put_param(param: torch.Tensor, value) -> None:
    """Copy a reference leaf (numpy) into ``param``; shapes must agree."""
    value = torch.tensor(np.asarray(value))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} for a parameter "
                         f"of shape {tuple(param.shape)}")
    param.data.copy_(value.to(param.dtype))


def put_norm_param(mod: Norm, value, i=None) -> None:
    """A reference norm leaf (w, or (g, b) for layernorm; layer i of a
    stacked one) into ``mod``."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if mod.kind == "rms":
        put_param(mod.w, pick(value))
    elif mod.kind == "layernorm":
        put_param(mod.g, pick(value[0]))
        put_param(mod.b, pick(value[1]))


def put_params(mod: Params, subtree: dict, i: int) -> None:
    """Layer i of a stacked reference subtree {name: (L, ...)} into ``mod``."""
    for name, param in mod.named_parameters():
        put_param(param, subtree[name][i])


# ------------------------------------------------------------- attention

def takes_flash(sq: int, q_offset: int, kv_len: int, differentiated: bool = False, *,
                causal: bool = True, window: int = 0) -> bool:
    """Whether an attention call runs in B7: exactly the calls where B7
    computes the reference's ``chunked_attention`` and autograd will not
    differentiate it (B7 has no backward).  That is causal with no window
    (``window`` 0, as ``chunked_attention`` and ``ModelConfig`` spell it),
    so every query sees keys 0..q, with no offset and as many valid keys
    as queries.  B7 is causal only: a non-causal call (an encoder's, a
    cross-attention's) or a windowed one runs the plain path."""
    return (causal and not window and q_offset == 0 and kv_len == sq
            and not differentiated)


def _flash(q, k, v) -> torch.Tensor:
    """B7 over (B, S, H, hd) / (B, S, KV, hd) tensors: the kernel reads the
    transposed views through their strides and writes in q's layout."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def attend(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset: int = 0,
           kv_len: Optional[int] = None, window: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd), keys valid
    below ``kv_len`` (all by default), each query seeing the last
    ``window`` positions (0: all), routed by ``takes_flash``: B7 on the
    first Sq keys, or the plain ``chunked_attention``.  On DTensors B7
    runs on each rank's batch rows and KV groups (``on_shards``), which
    need no communication; a meta ``q`` (a dry-run's trace, which
    computes nothing) takes ``chunked_attention`` with its sharding hook,
    as the reference's models do.  Every model's attention call site
    comes through here (``models/encdec.py`` and ``models/rglru.py``
    too)."""
    Sq = q.shape[1]
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    differentiated = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if not q.is_meta and takes_flash(Sq, q_offset, kv_len, differentiated,
                                     causal=causal, window=window):
        bh = (0, 2)
        return on_shards(_flash, (q, k[:, :Sq], v[:, :Sq]), (bh, bh, bh), (bh,),
                         k.shape[2])
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset, window=window,
                             chunk=cfg.attn_chunk, kv_len=kv_len,
                             shard=cfg.shard_activations)


def attention(x, p, cfg: ModelConfig, *, positions, kv_cache=None,
              cache_index: int = 0, window: int = 0):
    """Self-attention with an optional KV cache, over the last ``window``
    positions (0: all).

    x: (B, S, D).  kv_cache: dict(k=(B, C, KV, hd), v=...) or None; it is
    updated in place.  Returns (out, kv_cache_or_None).
    """
    recipe = cfg.quant
    B, S, _ = x.shape
    q, k, v = project_qkv(x, p, cfg, positions)
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
    out = attend(q, k, v, cfg, causal=True, q_offset=idx, kv_len=kv_len, window=window)
    return qlinear(reshape(out, B, S, -1), p.wo, recipe=recipe), new_cache


def project_qkv(x, p, cfg: ModelConfig, positions):
    """q (B, S, H, hd), k and v (B, S, KV, hd) of x (B, S, D), RoPE'd at
    ``positions`` where the config uses it."""
    recipe = cfg.quant
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = reshape(qlinear(x, p.wq, getattr(p, "bq", None), recipe=recipe), B, S, H, hd)
    k = reshape(qlinear(x, p.wk, getattr(p, "bk", None), recipe=recipe), B, S, KV, hd)
    v = reshape(qlinear(x, p.wv, getattr(p, "bv", None), recipe=recipe), B, S, KV, hd)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# --------------------------------------------------------------------- MoE

def moe_groups(B: int, S: int, cfg: ModelConfig) -> tuple:
    """(G, Tl, C): token groups (gcd(B, 32), the reference's dp-alignable
    split), tokens per group, and each expert's capacity per group,
    computed on Python floats as the reference does."""
    G = math.gcd(B, 32)
    Tl = B * S // G
    C = max(int(np.ceil(Tl * cfg.top_k * cfg.moe_capacity_factor / cfg.n_experts)), 1)
    return G, Tl, C


def top_k_lower_index(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index, as
    ``lax.top_k``: the first k of a stable descending sort (``torch.topk``
    does not promise the tie order on CUDA)."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def moe_route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Router over token groups xg (G, Tl, D): (top_w (G, Tl, k)
    normalised, top_i (G, Tl, k), load-balance aux float32)."""
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                          router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k_lower_index(probs, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    # Switch's load-balancing term E * sum_e f_e * P_e; jnp.mean is the sum
    # times the float32 reciprocal of the count (C5), and the division by
    # the constant k a reciprocal product under jit (C7)
    inv_n = torch.full((), 1.0 / (xg.shape[0] * xg.shape[1]), dtype=torch.float32,
                       device=xg.device)
    inv_k = torch.full((), 1.0 / k, dtype=torch.float32, device=xg.device)
    me = probs.sum(dim=(0, 1)) * inv_n
    counts = F.one_hot(top_i.long(), E).to(torch.float32).sum(2)     # (G, Tl, E)
    ce = counts.sum(dim=(0, 1)) * inv_n * inv_k
    return top_w, top_i, E * torch.sum(me * ce)


def moe_dispatch(xg: torch.Tensor, top_i: torch.Tensor, cfg: ModelConfig, C: int):
    """Capacity dispatch of token groups xg (G, Tl, D) to the experts
    top_i (G, Tl, k) chose.  Returns (buf (E, G·C, D) in x's dtype, slot
    (G, Tl·k) int64: each choice's row of buf, keep (G, Tl·k)).

    The (g, e, pos) slot of a kept choice (pos, its rank among group g's
    choices of expert e, below C) receives exactly one token, so a
    non-accumulating write into zeros gives the reference's
    ``.at[].add(mode="drop")`` values (there a dropped choice adds a
    zero); dropped choices write to one spare row past the buffer's end.
    Row e·G·C + g·C + pos of ``buf`` is the reference's buf[g, e, pos].

    On DTensors each rank dispatches its own groups (``common.on_shards``): buf
    is then sharded over the data axes on its G·C dim, which keeps row
    e·G·C + g·C + pos of the global buffer, and ``slot`` holds rows of
    the rank's shard, which ``moe_combine`` reads on the same rank."""
    g = ((0, None),) * 2
    return on_shards(lambda a, b: _dispatch(a, b, cfg, C), (xg, top_i), g,
                     ((1, None), (0, None), (0, None)))


def _dispatch(xg, top_i, cfg: ModelConfig, C: int):
    G, Tl, D = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    flat_e = top_i.reshape(G, Tl * k).long()
    oh = F.one_hot(flat_e, E).to(torch.int32)                       # (G, Tl*k, E)
    pos_in_e = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0].long()
    keep = pos < C
    g_idx = torch.arange(G, device=xg.device)[:, None]
    slot = flat_e * (G * C) + g_idx * C + torch.clamp_max(pos, C - 1)
    rows = E * G * C
    dest = torch.where(keep, slot, rows)
    tok = g_idx * Tl + torch.arange(Tl * k, device=xg.device)[None] // k
    buf = torch.zeros((rows + 1, D), dtype=xg.dtype, device=xg.device)
    buf.index_put_((dest.reshape(-1),), xg.reshape(G * Tl, D)[tok.reshape(-1)])
    return buf[:rows].view(E, G * C, D), slot, keep


def moe_combine(ybuf, slot, keep, top_w, k: int):
    """Each token's k expert outputs from ybuf (E, G·C, D) at ``slot``,
    zero where dropped, weighted by top_w (G, Tl, k) and summed in the
    order j = 0..k-1 from zeros in ybuf's dtype: y (G, Tl, D)."""
    # the group dim of the first argument decides the split (G, not G·C)
    return on_shards(lambda sl, ke, tw, yb: _combine(yb, sl, ke, tw, k),
                     (slot, keep, top_w, ybuf),
                     ((0, None), (0, None), (0, None), (1, None)), ((0, None),))


def _combine(ybuf, slot, keep, top_w, k: int):
    D = ybuf.shape[-1]
    G, Tlk = slot.shape
    yt = ybuf.reshape(-1, D)[slot.reshape(-1)].view(G, Tlk, D)
    yt = torch.where(keep[..., None], yt, yt.new_zeros(()))
    yt = (yt * top_w.reshape(G, Tlk, 1).to(ybuf.dtype)).view(G, Tlk // k, k, D)
    y = torch.zeros((G, Tlk // k, D), dtype=yt.dtype, device=ybuf.device)
    for j in range(k):
        y = y + yt[:, :, j]
    return y


def moe_ffn(x, p, cfg: ModelConfig):
    """Fine-grained MoE (DeepSeekMoE-style): shared experts (dense) + top-k
    routed experts with the reference's grouped capacity dispatch.

    The experts run as batched matmuls over E (``qlinear_experts``: each
    expert's weight and activation scales its own, as the reference's
    ``vmap``); each token's k weighted contributions are summed in the
    order j = 0..k-1 from zeros in x's dtype, as the reference's scatter
    adds them (no atomics).  Returns (y (B, S, D), aux float32)."""
    recipe = cfg.quant
    B, S, D = x.shape
    k = cfg.top_k
    G, Tl, C = moe_groups(B, S, cfg)
    xg = reshape(x, G, Tl, D)
    top_w, top_i, aux = moe_route(xg, p.router, cfg)
    buf, slot, keep = moe_dispatch(xg, top_i, cfg, C)

    g = qlinear_experts(buf, p.we_gate, recipe)
    u = qlinear_experts(buf, p.we_up, recipe)
    h = F.silu(g.to(torch.float32)).to(buf.dtype) * u
    ybuf = qlinear_experts(h, p.we_down, recipe)                    # (E, G*C, D)

    y = moe_combine(ybuf, slot, keep, top_w, k)

    if cfg.n_shared_experts:
        shared = SimpleNamespace(w_gate=p.ws_gate, w_up=p.ws_up, w_down=p.ws_down)
        y = y + reshape(ffn_apply(x, shared, cfg.replace(ffn="swiglu"), recipe), G, Tl, D)
    return reshape(y, B, S, D), aux


# ------------------------------------------------------------------ blocks

def block(x, lp: Block, cfg: ModelConfig, *, positions, kv_cache=None,
          cache_index: int = 0):
    """One transformer block.  Returns (x, kv_cache, aux)."""
    x = constrain_residual(x, cfg)
    h = norm(x, lp.attn_norm.weight(), cfg.norm)
    a, new_cache = attention(h, lp.attn, cfg, positions=positions,
                             kv_cache=kv_cache, cache_index=cache_index)
    x = x + a
    h = norm(x, lp.ffn_norm.weight(), cfg.norm)
    if cfg.family == "moe":
        f, aux = moe_ffn(h, lp.moe, cfg)
    else:
        f, aux = ffn_apply(h, lp.ffn, cfg, cfg.quant), 0.0
    return x + f, new_cache, aux


def embed_inputs(params: Transformer, batch: dict, cfg: ModelConfig):
    """Token embedding, with the vlm family's projected patch embeddings
    prepended when the batch has ``img_embeds``.  Returns (h, n_prefix)."""
    check_family(cfg)
    h = token_embedding(params, batch["tokens"], cfg)
    n_prefix = 0
    if cfg.family == "vlm" and "img_embeds" in batch:
        img = as_input(batch["img_embeds"], h.device).to(cfg.act_dtype)
        img = qlinear(img, params.img_proj, recipe=cfg.quant)
        h = torch.cat([img, h], dim=1)
        n_prefix = img.shape[1]
    if cfg.pos == "sinusoidal":
        emb = sinusoidal_embedding(h.shape[1], cfg.d_model, h.device)
        h = h + emb.to(h.dtype)[None]
    return h, n_prefix


def token_embedding(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """The rows of ``params.embed`` for ``tokens`` (B, S), in the
    activation dtype: every LM family's input embedding."""
    embed = params.embed
    if is_dtensor(embed):
        # DTensor's embedding rule gathers a vocab-sharded table's rows
        # on each rank and sums them over the model axis at once
        return reduce_partial(F.embedding(as_input(tokens, embed.device).long(),
                                          embed)).to(cfg.act_dtype)
    tokens = torch.as_tensor(tokens, device=embed.device)
    return embed[tokens.long()].to(cfg.act_dtype)


def final_logits(params, h, cfg: ModelConfig) -> torch.Tensor:
    """The final norm, the output head (``params.head()``) and the
    softcap over h (B, S, D): every LM family's float32 logits."""
    h = norm(pin_batch(h), params.final_norm.weight(), cfg.norm)
    logits = constrain_logits(torch.matmul(h, params.head().to(h.dtype)))
    return softcap(logits, cfg.logits_softcap).to(torch.float32)


def _train_block(x, lp: Block, cfg: ModelConfig, positions):
    x, _, aux = block(x, lp, cfg, positions=positions)
    return x, aux


def forward(params: Transformer, batch: dict, cfg: ModelConfig):
    """Training-path logits, differentiable.  batch: tokens (B, S)
    [+ img_embeds (B, P, D)].

    Returns (logits (B, S_total, V) float32, aux dict: ``moe_aux``, the
    load-balance terms summed in layer order in float32, and
    ``n_prefix``)."""
    h, n_prefix = embed_inputs(params, batch, cfg)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    moe_aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in params.layers:
        if remat:       # the block draws no random numbers: no RNG state kept
            h, a = checkpoint(_train_block, h, lp, cfg, positions,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, a = _train_block(h, lp, cfg, positions)
        moe_aux = moe_aux + a
    return final_logits(params, h, cfg), {"moe_aux": moe_aux, "n_prefix": n_prefix}


# ------------------------------------------------------------------ serving

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Per-layer cache shape and dtype: k and v are (B, C, KV, hd)."""
    check_family(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"n_layers": cfg.n_layers, "k": shape, "v": shape,
            "dtype": cfg.act_dtype}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               like=None) -> list:
    """A zeroed cache on ``device``; with ``like``, where ``like`` is
    (its DTensors placed by ``cache_pspecs``: ``common.cache_zeros``)."""
    spec = cache_specs(cfg, batch, cache_len)
    return [{n: new_zeros(spec[n], spec["dtype"], device, like) for n in ("k", "v")}
            for _ in range(spec["n_layers"])]


def new_zeros(shape, dtype, device=None, like=None) -> torch.Tensor:
    """``torch.zeros`` on ``device``, or beside ``like`` (``cache_zeros``)."""
    if like is not None:
        return cache_zeros(shape, dtype, like)
    return torch.zeros(shape, dtype=dtype, device=device)


def as_input(x, device) -> torch.Tensor:
    """A batch input as a tensor on ``device``; a DTensor as it is."""
    return x if is_dtensor(x) else torch.as_tensor(x, device=device)


def param_device(params: nn.Module) -> torch.device:
    """The device of ``params``' tensors (their shards' on DTensors), read
    off the registered parameters: reading an FSDP-sharded parameter as
    an attribute all-gathers it (``dist.sharding.distribute_model``)."""
    return next(params.parameters()).device


@torch.no_grad()
def prefill(params: Transformer, batch: dict, cfg: ModelConfig, cache_len: int):
    """Prompt processing: runs the full prompt (with the vlm family's
    image prefix) once, filling the KV cache.

    Returns (last_token_logits (B, V), cache).  cache_len >= S_total.
    """
    h, _ = embed_inputs(params, batch, cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    cache = init_cache(cfg, B, cache_len, h.device, like=h)
    for lp, kc in zip(params.layers, cache):
        h, _, _ = block(h, lp, cfg, positions=positions, kv_cache=kc,
                        cache_index=0)
    return final_logits(params, h[:, -1:], cfg)[:, -1], cache


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
    return final_logits(params, h, cfg)[:, -1], cache
