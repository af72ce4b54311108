"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks + local attention
(counterpart of ``repro.models.rglru``).

The block pattern (cfg.block_pattern, e.g. ("rec", "rec", "attn")) repeats
over the depth; the tail (n_layers % len(pattern)) reuses the pattern's
prefix.  The parameters keep the reference's layout: ``groups.{g}.{j}``
is layer j of group g (the reference stacks each pattern position over
the groups), ``tail.{j}`` a tail layer; each layer has ``pre_norm``,
``ffn_norm``, ``mix`` (the recurrent block's or the attention's weights)
and ``ffn``.

RG-LRU recurrence (Griffin), diagonal and gated:

    r_t = sigmoid(x_t * w_r + b_r)           (recurrence gate)
    i_t = sigmoid(x_t * w_i + b_i)           (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

computed by ``associative_scan``, which follows ``jax.lax.associative_scan``'s
own recursion (adjacent pairs combined, the scan of those, then the even
positions filled in): O(log S) launches and the reference's order of
combines.

The attention layers are windowed (cfg.window): ``forward`` and the prompt
run ``chunked_attention`` with the window (``transformer.attend``; B7 is
causal without a window and never runs here, ROADMAP C8); the cache keeps
a ring of the last min(cache_len, window) keys and values, slot
``pos % window`` holding position ``pos``, and decode attends over the
ring with its own float32 masked softmax, as the reference does.  As in
the reference, no ring write goes through ``quant_kv`` (ROADMAP C19).

The cache is a list with one dict per layer: ``{"h" (B, W) float32,
"conv" (B, 3, W)}`` for a recurrent layer, ``{"k", "v"}`` (B, win, KV,
hd) for an attention layer.  ``prefill`` builds it; ``decode_step``
updates it in place.  ``forward`` is differentiable (QAT), with
``cfg.remat`` recomputing each group in the backward.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.quantize.layers import qlinear
from . import transformer
from .common import ModelConfig, ffn_apply, ffn_param_shapes, init_, norm
from .transformer import Norm, Params, _param, attn_param_shapes, norm_param_shapes

_C = 8.0  # RG-LRU decay sharpness constant


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise ValueError(f"{cfg.name} ({cfg.family}) is not a hybrid (RG-LRU) model")


# ------------------------------------------------------------ parameters

def rec_param_shapes(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {"w_in_gate": (d, w), "w_in_rec": (d, w), "conv_k": (4, w), "lam": (w,),
            "w_rgate": (w,), "b_rgate": (w,), "w_igate": (w,), "b_igate": (w,),
            "w_out": (w, d)}


def group_layout(cfg: ModelConfig):
    """(pattern, n_groups, tail kinds)."""
    pat = tuple(cfg.block_pattern)
    n_groups = cfg.n_layers // len(pat)
    return pat, n_groups, pat[:cfg.n_layers - n_groups * len(pat)]


def layer_kinds(cfg: ModelConfig) -> list:
    pat, n_groups, tail = group_layout(cfg)
    return list(pat) * n_groups + list(tail)


def _mix_shapes(cfg: ModelConfig, kind: str) -> dict:
    return rec_param_shapes(cfg) if kind == "rec" else attn_param_shapes(cfg)


class HybridLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        self.kind = kind
        self.pre_norm = Norm(cfg, device)
        self.ffn_norm = Norm(cfg, device)
        self.mix = Params(_mix_shapes(cfg, kind), cfg.p_dtype, device)
        self.ffn = Params(ffn_param_shapes(cfg), cfg.p_dtype, device)


class Hybrid(nn.Module):
    """The parameters of one hybrid LM: ``embed`` (V, D), ``groups`` (one
    ``ModuleList`` of the pattern's layers per group), ``tail``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (D, V)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        pat, n_groups, tail = group_layout(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.p_dtype, device)
        self.groups = nn.ModuleList(
            nn.ModuleList(HybridLayer(cfg, kind, device) for kind in pat)
            for _ in range(n_groups))
        self.tail = nn.ModuleList(HybridLayer(cfg, kind, device) for kind in tail)
        self.final_norm = Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), cfg.p_dtype, device)

    def layers(self) -> list:
        """Every layer in depth order (the reference's ``_unstack_groups``)."""
        return [lp for g in self.groups for lp in g] + list(self.tail)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def param_shapes(cfg: ModelConfig) -> dict:
    """{dotted name: shape} of every parameter (one entry per layer)."""
    check_family(cfg)
    pat, n_groups, tail = group_layout(cfg)
    norms = norm_param_shapes(cfg)

    def layer(kind):
        out = {f"{n}.{k}": s for n in ("pre_norm", "ffn_norm") for k, s in norms.items()}
        out.update({f"mix.{k}": s for k, s in _mix_shapes(cfg, kind).items()})
        out.update({f"ffn.{k}": s for k, s in ffn_param_shapes(cfg).items()})
        return out

    out = {"embed": (cfg.vocab, cfg.d_model)}
    for g in range(n_groups):
        for j, kind in enumerate(pat):
            out.update({f"groups.{g}.{j}.{k}": s for k, s in layer(kind).items()})
    for j, kind in enumerate(tail):
        out.update({f"tail.{j}.{k}": s for k, s in layer(kind).items()})
    out.update({f"final_norm.{k}": s for k, s in norms.items()})
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Hybrid:
    """Seeded init with the reference's distribution (``common.init_``)."""
    model = Hybrid(cfg, device)
    for p in model.parameters():
        init_(p.data, generator)
    return model


def _put_layer(lp: HybridLayer, sub: dict, i=None) -> None:
    """A reference layer subtree (index i of a group-stacked one) into lp."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if lp.pre_norm.kind != "nonparam":
        transformer.put_norm_param(lp.pre_norm, sub["pre_norm"], i)
        transformer.put_norm_param(lp.ffn_norm, sub["ffn_norm"], i)
    for part in ("mix", "ffn"):
        for name, param in getattr(lp, part).named_parameters():
            transformer.put_param(param, pick(sub[part][name]))


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> Hybrid:
    """Load the reference's parameter pytree (numpy leaves): ``groups`` a
    tuple over the pattern of subtrees stacked on the group axis, ``tail``
    a tuple of unstacked subtrees, layernorm weights as (g, b) tuples."""
    model = Hybrid(cfg, device)
    transformer.put_param(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        transformer.put_param(model.lm_head, tree["lm_head"])
    for g, group in enumerate(model.groups):
        for j, lp in enumerate(group):
            _put_layer(lp, tree["groups"][j], g)
    for j, lp in enumerate(model.tail):
        _put_layer(lp, tree["tail"][j])
    if cfg.norm != "nonparam":
        transformer.put_norm_param(model.final_norm, tree["final_norm"])
    return model


# ---------------------------------------------------------------- RG-LRU

def _combine(c1, c2):
    (a1, b1), (a2, b2) = c1, c2
    return a1 * a2, a2 * b1 + b2


def associative_scan(a, b):
    """Inclusive scan of ``_combine`` over axis 1 of a and b (B, S, W), by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    those (the odd positions), combine each with the next even element
    (the even positions), interleave; element 0 is kept as it is."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_head = (odd[0][:, :-1], odd[1][:, :-1])
    else:
        odd_head = odd
    even = _combine(odd_head, (a[:, 2::2], b[:, 2::2]))
    even = [torch.cat([x[:, :1], e], dim=1) for x, e in zip((a, b), even)]
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _interleave(even, odd):
    """even[0], odd[0], even[1], odd[1], ... along axis 1 (even has as many
    entries as odd, or one more)."""
    m = odd.shape[1]
    out = torch.stack([even[:, :m], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, m:]], dim=1) if even.shape[1] > m else out


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def rg_lru(x, p, h0=None):
    """x (B, S, W).  Returns (y in x's dtype, h_last (B, W) float32); h0
    (B, W), the carried state, is folded into the first step."""
    xf = x.to(torch.float32)
    f32 = lambda t: t.to(torch.float32)
    r = torch.sigmoid(xf * f32(p.w_rgate) + f32(p.b_rgate))
    i = torch.sigmoid(xf * f32(p.w_igate) + f32(p.b_igate))
    a = torch.exp(-_C * _softplus(f32(p.lam)) * r)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    if h0 is not None:
        first = gated[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None]
        gated = torch.cat([first, gated[:, 1:]], dim=1)
    _, h = associative_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def rec_mix(x, p, cfg: ModelConfig, state=None):
    """The Griffin recurrent block.  state: a layer's cache dict {"h",
    "conv"} or None; updated in place."""
    recipe = cfg.quant
    gate = F.gelu(qlinear(x, p.w_in_gate, recipe=recipe).to(torch.float32),
                  approximate="tanh").to(x.dtype)
    u = qlinear(x, p.w_in_rec, recipe=recipe)                         # (B, S, W)
    # temporal conv (causal, width 4) over the carried 3-row tail
    if state is not None:
        u_ext = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    else:
        u_ext = F.pad(u, (0, 0, 3, 0))
    ck = p.conv_k.to(torch.float32)
    L = u_ext.shape[1]
    uc = u_ext[:, 3:L].to(torch.float32) * ck[3]
    for j in range(1, 4):
        uc = uc + u_ext[:, 3 - j:L - j].to(torch.float32) * ck[3 - j]
    y, h_last = rg_lru(uc.to(u.dtype), p, h0=None if state is None else state["h"])
    out = qlinear(y * gate, p.w_out, recipe=recipe)
    if state is not None:
        state["h"].copy_(h_last)
        state["conv"].copy_(u_ext[:, -3:])
    return out


# ------------------------------------------------------------ attention

def _prefill_window_attn(x, p, cfg: ModelConfig, positions, win: int):
    """Windowed attention over the prompt, and the ring of its last ``win``
    keys and values, rolled so that slot pos % win holds position pos."""
    B, S, _ = x.shape
    q, k, v = transformer.project_qkv(x, p, cfg, positions)
    out = transformer.attend(q, k, v, cfg, causal=True, window=cfg.window)
    out = qlinear(out.reshape(B, S, -1), p.wo, recipe=cfg.quant)
    ring = {}
    for name, t in (("k", k), ("v", v)):
        if S >= win:
            # t[S - win + i] goes to slot (S - win + i) % win: a roll by (S - win) % win
            t = torch.roll(t[:, S - win:], (S - win) % win, dims=1)
        else:
            t = F.pad(t, (0, 0, 0, 0, 0, win - S))
        ring[name] = t.to(cfg.act_dtype)
    return out, ring


def _windowed_decode_attn(x, p, st: dict, slot: int, cache_index: int, cfg: ModelConfig):
    """One decode token over the ring (written in place at ``slot``): a
    float32 softmax over every written slot (the ring's positions are out
    of order, and the softmax does not care)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = cache_index + torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = transformer.project_qkv(x, p, cfg, pos)
    ck, cv = st["k"], st["v"]
    win = ck.shape[1]
    slot = min(slot, win - S)           # dynamic_update_slice's clamp
    ck[:, slot:slot + S] = k.to(ck.dtype)
    cv[:, slot:slot + S] = v.to(cv.dtype)
    n_valid = min(cache_index + 1, win)
    # the reference divides by the constant sqrt(hd); under jit XLA takes
    # the product with its float32 reciprocal (ROADMAP C7)
    inv = torch.full((), 1.0 / np.sqrt(hd), dtype=torch.float32, device=x.device)
    qg = q.reshape(B, 1, KV, H // KV, hd).to(torch.float32) * inv
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, ck.to(torch.float32))
    written = torch.arange(win, device=x.device) < n_valid
    s = torch.where(written, s, torch.full((), -1e30, device=x.device))
    pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqc,bckh->bkgqh", pr, cv.to(torch.float32))
    out = out / torch.clamp_min(pr.sum(-1)[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(x.dtype)
    return qlinear(out, p.wo, recipe=cfg.quant)


# ------------------------------------------------------------------ layers

def _ffn(x, lp: HybridLayer, cfg: ModelConfig):
    return x + ffn_apply(norm(x, lp.ffn_norm.weight(), cfg.norm), lp.ffn, cfg, cfg.quant)


def _train_layer(x, lp: HybridLayer, cfg: ModelConfig, positions):
    h = norm(x, lp.pre_norm.weight(), cfg.norm)
    if lp.kind == "rec":
        mix = rec_mix(h, lp.mix, cfg)
    else:
        mix, _ = transformer.attention(h, lp.mix, cfg, positions=positions, window=cfg.window)
    return _ffn(x + mix, lp, cfg)


def _train_group(x, group, cfg: ModelConfig, positions):
    for lp in group:
        x = _train_layer(x, lp, cfg, positions)
    return x


def forward(params: Hybrid, batch: dict, cfg: ModelConfig):
    """Training-path logits (B, S, V) float32, differentiable, and the aux
    dict (``moe_aux`` 0, ``n_prefix`` 0)."""
    h = transformer.token_embedding(params, batch["tokens"], cfg)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for group in params.groups:
        if remat:       # the group draws no random numbers: no RNG state kept
            h = checkpoint(_train_group, h, group, cfg, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _train_group(h, group, cfg, positions)
    h = _train_group(h, params.tail, cfg, positions)
    return transformer.final_logits(params, h, cfg), {
        "moe_aux": torch.zeros((), dtype=torch.float32, device=h.device), "n_prefix": 0}


# ------------------------------------------------------------------ serving

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> list:
    """Per layer {name: (shape, dtype)}: a recurrent layer's state, an
    attention layer's ring of min(cache_len, window) entries."""
    check_family(cfg)
    w, KV, hd = cfg.lru_width, cfg.n_kv_heads, cfg.hd
    win = min(cache_len, cfg.window) if cfg.window else cache_len
    act = cfg.act_dtype
    rec = {"h": ((batch, w), torch.float32), "conv": ((batch, 3, w), act)}
    attn = {"k": ((batch, win, KV, hd), act), "v": ((batch, win, KV, hd), act)}
    return [dict(rec if kind == "rec" else attn) for kind in layer_kinds(cfg)]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> list:
    return [{n: torch.zeros(s, dtype=dt, device=device) for n, (s, dt) in layer.items()}
            for layer in cache_specs(cfg, batch, cache_len)]


@torch.no_grad()
def prefill(params: Hybrid, batch: dict, cfg: ModelConfig, cache_len: int):
    """The prompt: recurrent layers carry their state from zeros, attention
    layers keep the ring of the last min(cache_len, window) keys and
    values.  Returns (last-token logits (B, V), cache)."""
    h = transformer.token_embedding(params, batch["tokens"], cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    win = min(cache_len, cfg.window) if cfg.window else cache_len
    cache = init_cache(cfg, B, cache_len, h.device)
    for i, lp in enumerate(params.layers()):
        hn = norm(h, lp.pre_norm.weight(), cfg.norm)
        if lp.kind == "rec":
            mix = rec_mix(hn, lp.mix, cfg, state=cache[i])
        else:
            mix, cache[i] = _prefill_window_attn(hn, lp.mix, cfg, positions, win)
        h = _ffn(h + mix, lp, cfg)
    return transformer.final_logits(params, h[:, -1:], cfg)[:, -1], cache


@torch.no_grad()
def decode_step(params: Hybrid, cache: list, tokens, cache_index: int, cfg: ModelConfig):
    """One token: the ring caches are written at slot cache_index % win,
    the recurrent states carried.  Returns (logits (B, V), cache), updated
    in place."""
    h = transformer.token_embedding(params, tokens, cfg)
    idx = int(cache_index)
    for lp, st in zip(params.layers(), cache):
        hn = norm(h, lp.pre_norm.weight(), cfg.norm)
        if lp.kind == "rec":
            mix = rec_mix(hn, lp.mix, cfg, state=st)
        else:
            mix = _windowed_decode_attn(hn, lp.mix, st, idx % st["k"].shape[1], idx, cfg)
        h = _ffn(h + mix, lp, cfg)
    return transformer.final_logits(params, h, cfg)[:, -1], cache
