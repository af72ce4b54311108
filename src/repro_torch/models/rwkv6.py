"""RWKV-6 "Finch": attention-free, data-dependent decay, ssm family
(counterpart of ``repro.models.rwkv6``).

Per layer: time-mix (the wkv recurrence) + channel-mix, both with
token-shift interpolation.  Per head (dim N = cfg.rwkv_head_dim):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t            (state:  N x N)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)        (readout, bonus u)

with w_t = exp(-exp(omega_t)) a data-dependent per-channel decay, omega_t
from a low-rank projection.  The recurrence runs in float32, one time step
after another in the reference's order (its ``lax.scan``): a Python loop
of a few launches per step.  Decode carries S as the cache, O(1) a token.

The parameters are ``nn.Module``s named after the reference's pytree keys
(``layers.{i}.ln1``, ``mu_r`` ... ``mu_g``, ``w_r`` ... ``w_o``, ``w0``,
``w_lora_a`` / ``w_lora_b``, ``u_bonus``, ``mu_ck``, ``mu_cr``, ``w_ck``,
``w_cv``, ``w_cr``), one module per layer.  The cache is a list with one
``{"tm_shift" (B, D), "wkv" (B, H, N, N) float32, "cm_shift" (B, D)}``
dict per layer; ``prefill`` and ``decode_step`` update it in place.
``forward`` is differentiable (QAT), with ``cfg.remat`` recomputing each
layer in the backward.  No attention, so no call reaches B7.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import reduce_partial
from repro_torch.quantize.layers import qlinear
from . import transformer
from .common import (ModelConfig, constrain_residual, init_, is_dtensor, norm, on_shards, pad_seq,
                     reshape)
from .transformer import (Norm, _param, norm_layout, norm_param_shapes, params_layout,
                          put_norm_param, put_param)

LORA_R = 64  # low-rank dim for the decay projection


def _heads(cfg: ModelConfig):
    N = cfg.rwkv_head_dim
    return cfg.d_model // N, N


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name} ({cfg.family}) is not an ssm (rwkv6) model")


# ------------------------------------------------------------ parameters

def layer_param_shapes(cfg: ModelConfig) -> dict:
    """One layer's parameters but its norms, in the reference's key order."""
    d, f = cfg.d_model, cfg.d_ff
    H, N = _heads(cfg)
    p = {f"mu_{c}": (d,) for c in "rkvwg"}
    p.update({f"w_{c}": (d, d) for c in "rkvgo"})
    p.update(w0=(d,), w_lora_a=(d, LORA_R), w_lora_b=(LORA_R, d), u_bonus=(H, N),
             mu_ck=(d,), mu_cr=(d,), w_ck=(d, f), w_cv=(f, d), w_cr=(d, d))
    return p


class RwkvLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.ln2 = Norm(cfg, device)
        for name, shape in layer_param_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.p_dtype, device))


class Rwkv6(nn.Module):
    """The parameters of one RWKV-6 LM: ``embed`` (V, D), ``layers``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (D, V)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.p_dtype, device)
        self.layers = nn.ModuleList(RwkvLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), cfg.p_dtype, device)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def param_shapes(cfg: ModelConfig) -> dict:
    """{dotted name: shape} of every parameter (one entry per layer)."""
    check_family(cfg)
    norms = norm_param_shapes(cfg)
    layer = {f"{ln}.{k}": s for ln in ("ln1", "ln2") for k, s in norms.items()}
    layer.update(layer_param_shapes(cfg))
    out = {"embed": (cfg.vocab, cfg.d_model)}
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    out.update({f"final_norm.{k}": s for k, s in norms.items()})
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


def reference_layout(cfg: ModelConfig) -> dict:
    """{port name: (reference path, reference shape, stacked)}, as
    ``transformer.reference_layout``."""
    check_family(cfg)
    out = {"embed": (("embed",), (cfg.vocab, cfg.d_model), False)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (("lm_head",), (cfg.d_model, cfg.vocab), False)
    out.update(norm_layout(cfg, "final_norm", ("final_norm",)))
    lead = (cfg.n_layers,)
    for i in range(cfg.n_layers):
        for ln in ("ln1", "ln2"):
            out.update(norm_layout(cfg, f"layers.{i}.{ln}", ("layers", ln), lead))
        out.update(params_layout(layer_param_shapes(cfg), f"layers.{i}", ("layers",), lead))
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Rwkv6:
    """Seeded init with the reference's distribution (``common.init_``)."""
    model = Rwkv6(cfg, device)
    for p in model.parameters():
        init_(p.data, generator)
    return model


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> Rwkv6:
    """Load the reference's parameter pytree (numpy leaves; layers stacked
    on a leading L axis, layernorm weights as (g, b) tuples)."""
    model = Rwkv6(cfg, device)
    put_param(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        put_param(model.lm_head, tree["lm_head"])
    lt = tree["layers"]
    for i, layer in enumerate(model.layers):
        if cfg.norm != "nonparam":
            put_norm_param(layer.ln1, lt["ln1"], i)
            put_norm_param(layer.ln2, lt["ln2"], i)
        for name in layer_param_shapes(cfg):
            put_param(getattr(layer, name), lt[name][i])
    if cfg.norm != "nonparam":
        put_norm_param(model.final_norm, tree["final_norm"])
    return model


# ------------------------------------------------------------------ mixing

def _token_shift(x, prev=None):
    """x_{t-1} along the sequence; the first step takes the carried
    ``prev`` (B, D), or zeros."""
    if prev is None and is_dtensor(x):
        return pad_seq(x, 1)[:, :-1]
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def wkv(r, k, v, w, u, s0):
    """The recurrence over time, float32: r, k, v, w (B, S, H, N), u (H, N),
    s0 (B, H, N, N).  Returns (out (B, S, H, N), the last state).  On
    DTensors each rank runs its own batch rows and heads
    (``common.on_shards``)."""
    seq = (0, 2)
    return on_shards(_wkv, (r, k, v, w, u, s0), (seq, seq, seq, seq, (None, 0), (0, 1)),
                       (seq, (0, 1)), r.shape[2])


def _wkv(r, k, v, w, u, s0):
    if r.is_meta:
        return _wkv_meta(r, k, v, w, u, s0)
    return _wkv_loop(r, k, v, w, u, s0)


def _wkv_meta(r, k, v, w, u, s0):
    """The recurrence on meta shards (a dry-run's: shapes, no values): the
    S identical steps as one step over all S positions at once, the same
    operations on tensors with a time axis, so each op counted per step
    counts S times (the readout's S·B·H products of (1, N) by (N, N)) and
    the time loop costs a trace a few ops, not a few per token."""
    kv = k[..., :, None] * v[..., None, :]                          # (B, S, H, N, N)
    state = w[..., :, None] * s0[:, None] + kv                      # each step's state
    out = torch.einsum("bshn,bshnm->bshm", r, state + u[None, None, :, :, None] * kv)
    return out, state[:, -1]


def _wkv_loop(r, k, v, w, u, s0):
    state, outs = s0, []
    ub = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                # (B, H, N, N)
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state + ub * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def time_mix(x, p: RwkvLayer, cfg: ModelConfig, state=None):
    """x (B, S, D).  state: a layer's cache dict or None (training); its
    ``tm_shift`` and ``wkv`` are updated in place."""
    recipe = cfg.quant
    B, S, D = x.shape
    H, N = _heads(cfg)
    xs = _token_shift(x, None if state is None else state["tm_shift"])
    r = qlinear(_lerp(x, xs, p.mu_r), p.w_r, recipe=recipe)
    k = qlinear(_lerp(x, xs, p.mu_k), p.w_k, recipe=recipe)
    v = qlinear(_lerp(x, xs, p.mu_v), p.w_v, recipe=recipe)
    g = qlinear(_lerp(x, xs, p.mu_g), p.w_g, recipe=recipe)
    xw = _lerp(x, xs, p.mu_w).to(torch.float32)
    omega = p.w0.to(torch.float32) + reduce_partial(torch.matmul(
        torch.tanh(torch.matmul(xw, p.w_lora_a.to(torch.float32))),
        p.w_lora_b.to(torch.float32)))
    w = torch.exp(-torch.exp(torch.clamp(omega, -20.0, 8.0)))       # (B, S, D) in (0, 1)

    f32 = lambda t: reshape(t, B, S, H, N).to(torch.float32)
    s0 = (transformer.new_zeros((B, H, N, N), torch.float32, x.device, like=x)
          if state is None else state["wkv"])
    out, s_last = wkv(f32(r), f32(k), f32(v), reshape(w, B, S, H, N),
                      p.u_bonus.to(torch.float32), s0)
    out = reshape(out, B, S, D) * F.silu(g.to(torch.float32))
    out = qlinear(out.to(x.dtype), p.w_o, recipe=recipe)
    if state is not None:
        state["tm_shift"].copy_(x[:, -1])
        state["wkv"].copy_(s_last)
    return out


def channel_mix(x, p: RwkvLayer, cfg: ModelConfig, state=None):
    """state: a layer's cache dict or None; its ``cm_shift`` is updated in
    place."""
    recipe = cfg.quant
    xs = _token_shift(x, None if state is None else state["cm_shift"])
    k = qlinear(_lerp(x, xs, p.mu_ck), p.w_ck, recipe=recipe)
    k = torch.square(torch.relu(k.to(torch.float32))).to(x.dtype)
    kv = qlinear(k, p.w_cv, recipe=recipe)
    r = torch.sigmoid(qlinear(_lerp(x, xs, p.mu_cr), p.w_cr, recipe=recipe)
                      .to(torch.float32))
    out = (r * kv.to(torch.float32)).to(x.dtype)
    if state is not None:
        state["cm_shift"].copy_(x[:, -1])
    return out


def block(x, lp: RwkvLayer, cfg: ModelConfig, state=None):
    x = constrain_residual(x, cfg)
    x = x + time_mix(norm(x, lp.ln1.weight(), cfg.norm), lp, cfg, state)
    return x + channel_mix(norm(x, lp.ln2.weight(), cfg.norm), lp, cfg, state)


# ------------------------------------------------------------------ forward

def forward(params: Rwkv6, batch: dict, cfg: ModelConfig):
    """Training-path logits (B, S, V) float32, differentiable, and the aux
    dict (``moe_aux`` 0, ``n_prefix`` 0)."""
    h = transformer.token_embedding(params, batch["tokens"], cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.layers:
        if remat:       # the layer draws no random numbers: no RNG state kept
            h = checkpoint(block, h, lp, cfg, use_reentrant=False, preserve_rng_state=False)
        else:
            h = block(h, lp, cfg)
    return transformer.final_logits(params, h, cfg), {
        "moe_aux": torch.zeros((), dtype=torch.float32, device=h.device), "n_prefix": 0}


# ------------------------------------------------------------------ serving

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> list:
    """Per layer {name: (shape, dtype)}: O(1) state, independent of
    cache_len."""
    check_family(cfg)
    H, N = _heads(cfg)
    d = cfg.d_model
    layer = {"tm_shift": ((batch, d), cfg.act_dtype),
             "wkv": ((batch, H, N, N), torch.float32),
             "cm_shift": ((batch, d), cfg.act_dtype)}
    return [dict(layer) for _ in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               like=None) -> list:
    """Zeroed states on ``device``, or beside ``like`` (``transformer.new_zeros``)."""
    return [{n: transformer.new_zeros(s, dt, device, like) for n, (s, dt) in layer.items()}
            for layer in cache_specs(cfg, batch, cache_len)]


@torch.no_grad()
def prefill(params: Rwkv6, batch: dict, cfg: ModelConfig, cache_len: int):
    """Run the prompt, carrying the recurrent state per layer.  Returns
    (last-token logits (B, V), cache)."""
    h = transformer.token_embedding(params, batch["tokens"], cfg)
    cache = init_cache(cfg, h.shape[0], cache_len, h.device, like=h)
    for lp, st in zip(params.layers, cache):
        h = block(h, lp, cfg, st)
    return transformer.final_logits(params, h[:, -1:], cfg)[:, -1], cache


@torch.no_grad()
def decode_step(params: Rwkv6, cache: list, tokens, cache_index: int, cfg: ModelConfig):
    """One token against the carried state (``cache_index`` is unused: the
    state does not grow).  Returns (logits (B, V), cache), updated in
    place."""
    h = transformer.token_embedding(params, tokens, cfg)
    for lp, st in zip(params.layers, cache):
        h = block(h, lp, cfg, st)
    return transformer.final_logits(params, h, cfg)[:, -1], cache
