"""Shared LM substrate: config, norms, RoPE, chunked attention, FFNs
(counterpart of ``repro.models.common``).

Every LM architecture of ``repro_torch.configs`` is expressed through
``ModelConfig``.  The reference stacks its layers on a leading L axis and
runs them under ``lax.scan``; the port keeps one ``nn.Module`` per layer
(``models/transformer.py``) and runs them in a Python loop.

``chunked_attention`` is the reference's online-softmax attention over
KV chunks, GQA-grouped (q reshaped to (B, S, KV, G, hd)), in plain
PyTorch.  The serving path runs it for decode; full-prefix attention
(``forward``, ``prefill``) runs in the flash-attention kernel B7
(``kernels/flash_attention.py``), which computes the same function.

The reference's mesh-sharding hooks (``constrain_logits``,
``constrain_residual``, ``_shard_attn``) are no-ops on one device and are
not ported (ROADMAP A16).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.quantize.layers import qlinear


# ---------------------------------------------------------------- config

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    norm: str = "rms"              # rms | nonparam | layernorm
    ffn: str = "swiglu"            # swiglu | gelu
    pos: str = "rope"              # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- moe ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # --- hybrid (RG-LRU + local attention) ---
    block_pattern: tuple = ()
    lru_width: int = 0
    window: int = 0                # local attention window (0 = full)
    # --- ssm (rwkv6) ---
    rwkv_head_dim: int = 64
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 0
    # --- vlm ---
    n_patches: int = 0
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    quant: QuantRecipe = field(default_factory=lambda: FP32)
    attn_chunk: int = 1024
    # the reference's compile and mesh switches; the eager port ignores them
    remat: bool = False
    shard_activations: bool = False
    scan_unroll: bool = False
    logits_softcap: float = 0.0
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid-with-window only.)"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        from . import api
        return int(sum(math.prod(s) for s in api.param_shapes(self).values()))

    def active_param_count(self) -> int:
        """Params active per token (MoE: shared + top_k routed)."""
        if self.family != "moe":
            return self.param_count()
        raise NotImplementedError("the moe family is not ported yet (ROADMAP A17)")


# ----------------------------------------------------------------- norms

def _mean_last(t: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` over the last axis as XLA computes it: the sum times
    the float32 reciprocal of the count (ROADMAP C5)."""
    inv = torch.full((), 1.0 / t.shape[-1], dtype=t.dtype, device=t.device)
    return torch.sum(t, dim=-1, keepdim=True) * inv


def norm(x: torch.Tensor, w, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """rms (scaled), nonparam (OLMo LN without affine), layernorm (w = (g,b))."""
    xf = x.to(torch.float32)
    if kind == "rms":
        y = xf * torch.rsqrt(_mean_last(xf * xf) + eps)
        return (y * (1.0 + w.to(torch.float32))).to(x.dtype)
    if kind in ("nonparam", "layernorm"):
        mu = _mean_last(xf)
        d = xf - mu
        var = _mean_last(d * d)
        y = d * torch.rsqrt(var + eps)
        if kind == "nonparam":
            return y.to(x.dtype)
        g, b = w
        return (y * g.to(torch.float32) + b.to(torch.float32)).to(x.dtype)
    raise ValueError(kind)


# ------------------------------------------------------------------ RoPE

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., S, hd/2)
    if ang.ndim == 2:                                    # (S, hd/2) -> broadcast B
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_embedding(n_pos: int, d: int, device=None) -> torch.Tensor:
    pos = np.arange(n_pos)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000, (2 * (i // 2)) / d)
    emb = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.as_tensor(emb, dtype=torch.float32, device=device)


# ---------------------------------------------------- chunked attention

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      window: int = 0, chunk: int = 1024,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """Flash-style attention, chunked over KV, online softmax, GQA-grouped.

    q: (B, Sq, H, hd);  k, v: (B, Sk, KV, hd);  H = KV * G.
    q_offset: absolute position of q[0] (decode: current cache length).
    window:  local attention span (0 = unbounded).
    kv_len:  valid length of k/v (decode with cache); keys at and past it
             are masked.
    Returns (B, Sq, H, hd) in q's dtype.

    The reference pads k/v to whole chunks and scans every chunk.  A key
    that is masked (padding, past ``kv_len``, or after every query) adds
    ``exp(-1e30 - m) = 0`` to the sums and leaves the running max alone,
    so the port drops those chunks and the padding: the same bits, less
    work on a partly filled cache.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    chunk = min(chunk, Sk)
    valid_len = Sk if kv_len is None else int(kv_len)
    dev = q.device

    qg = q.reshape(B, Sq, KV, G, hd).to(torch.float32) * scale
    q_pos = q_offset + torch.arange(Sq, dtype=torch.int32, device=dev)
    last = min(valid_len, Sk)
    if causal:
        last = min(last, q_offset + Sq)

    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    for start in range(0, max(last, 1), chunk):
        kb = k[:, start:start + chunk].to(torch.float32)     # (B, C, KV, hd)
        vb = v[:, start:start + chunk].to(torch.float32)
        k_pos = start + torch.arange(kb.shape[1], dtype=torch.int32, device=dev)
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, kb)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        mask = mask & (k_pos[None, :] < valid_len)
        if window:
            mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))            # (B, KV, G, Sq)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p, vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]     # (B, KV, G, Sq, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


# ------------------------------------------------------------------ FFN

def ffn_apply(x, p, cfg: ModelConfig, recipe: QuantRecipe) -> torch.Tensor:
    """SwiGLU or GELU FFN over (B, S, D); ``p`` holds w_gate / w_up /
    w_down (and b_up / b_down where the config has them)."""
    if cfg.ffn == "swiglu":
        g = qlinear(x, p.w_gate, recipe=recipe)
        u = qlinear(x, p.w_up, recipe=recipe)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = qlinear(x, p.w_up, getattr(p, "b_up", None), recipe=recipe)
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return qlinear(h, p.w_down, getattr(p, "b_down", None), recipe=recipe)


def ffn_param_shapes(cfg: ModelConfig, d_in=None, d_ff=None, bias=False) -> dict:
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.ffn == "swiglu":
        return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    p = {"w_up": (d, f), "w_down": (f, d)}
    if bias:
        p.update(b_up=(f,), b_down=(d,))
    return p


# ------------------------------------------------------------ utilities

def init_(t: torch.Tensor, generator: torch.Generator, init_scale=0.02) -> None:
    """The reference's ``init_from_specs`` rule, in place: trunc-normal in
    [-2, 2] times min(init_scale, fan_in^-1/2) for matrices, zeros for
    vectors (norms are zeros + 1 in ``norm``).  The distribution is the
    reference's; the bits are not (``torch.Generator`` is not
    ``jax.random``), so tests carry weights across instead."""
    if t.ndim >= 2:
        fan_in = t.shape[-2]
        std = init_scale if fan_in == 0 else min(init_scale, fan_in ** -0.5)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)
    else:
        t.zero_()


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return torch.tanh(logits / cap) * cap
