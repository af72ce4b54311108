"""Whisper-style encoder-decoder backbone, audio family (counterpart of
``repro.models.encdec``).

The conv frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, n_frames, d_model).  The
encoder is a bidirectional self-attention stack; the decoder runs causal
self-attention, cross-attention over the encoder's states, and a GELU
FFN with biases.  LayerNorm, sinusoidal positions, and an output head
tied to the token embedding.

The parameters are ``nn.Module``s named after the reference's pytree keys:
``embed``, ``enc_layers`` / ``dec_layers`` (one module per layer),
``enc_final_norm`` and ``final_norm``.  The cache is a list with one
``{"self_k", "self_v", "cross_k", "cross_v"}`` dict per decoder layer,
each (B, C, KV, hd) (the cross entries (B, n_frames, KV, hd)), in the
activation dtype.  As the reference, no cache write goes through
``quant_kv``: a kv-bits recipe leaves whisper's cache in that dtype.
``prefill`` and ``decode_step`` write the self-attention entries into the
cache in place.

Attention routing (``transformer.attend``, ROADMAP C8): the encoder's
self-attention and every cross-attention are non-causal and run the
plain ``chunked_attention``; the decoder's causal full-prefix
self-attention in ``forward`` (outside autograd) and in ``prefill`` runs
the flash-attention kernel B7; decode runs ``chunked_attention``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.quantize.layers import qlinear
from . import transformer
from .common import ModelConfig, ffn_apply, ffn_param_shapes, init_, norm, sinusoidal_embedding
from .transformer import Norm, Params, _param, attn_param_shapes, norm_param_shapes

# decode_step reads its position from a table of this many rows, as the
# reference does (positions past the end take the last row)
DECODE_POSITIONS = 8192


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.attn_norm = Norm(cfg, device)
        self.attn = Params(attn_param_shapes(cfg), cfg.p_dtype, device)
        self.ffn_norm = Norm(cfg, device)
        self.ffn = Params(ffn_param_shapes(cfg, bias=True), cfg.p_dtype, device)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.self_norm = Norm(cfg, device)
        self.self_attn = Params(attn_param_shapes(cfg), cfg.p_dtype, device)
        self.cross_norm = Norm(cfg, device)
        self.cross_attn = Params(attn_param_shapes(cfg), cfg.p_dtype, device)
        self.ffn_norm = Norm(cfg, device)
        self.ffn = Params(ffn_param_shapes(cfg, bias=True), cfg.p_dtype, device)


_ENC_SUBS = (("attn_norm", "norm"), ("attn", "attn"), ("ffn_norm", "norm"), ("ffn", "ffn"))
_DEC_SUBS = (("self_norm", "norm"), ("self_attn", "attn"), ("cross_norm", "norm"),
             ("cross_attn", "attn"), ("ffn_norm", "norm"), ("ffn", "ffn"))


class EncDec(nn.Module):
    """The parameters of one encoder-decoder: ``embed`` (V, D), tied to
    the output head, ``enc_layers``, ``enc_final_norm``, ``dec_layers``
    and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.p_dtype, device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device) for _ in range(cfg.n_enc_layers))
        self.enc_final_norm = Norm(cfg, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, device)

    def head(self) -> torch.Tensor:
        return self.embed.T


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name} ({cfg.family}) is not an encoder-decoder")


def _sub_shapes(cfg: ModelConfig, kind: str) -> dict:
    return {"norm": norm_param_shapes(cfg), "attn": attn_param_shapes(cfg),
            "ffn": ffn_param_shapes(cfg, bias=True)}[kind]


def param_shapes(cfg: ModelConfig) -> dict:
    """{dotted name: shape} of every parameter (one entry per layer)."""
    check_family(cfg)
    out = {"embed": (cfg.vocab, cfg.d_model)}
    for stack, n, subs in (("enc_layers", cfg.n_enc_layers, _ENC_SUBS),
                           ("dec_layers", cfg.n_layers, _DEC_SUBS)):
        layer = {f"{sub}.{k}": s for sub, kind in subs
                 for k, s in _sub_shapes(cfg, kind).items()}
        for i in range(n):
            out.update({f"{stack}.{i}.{k}": s for k, s in layer.items()})
        if stack == "enc_layers":
            out.update({f"enc_final_norm.{k}": s for k, s in norm_param_shapes(cfg).items()})
    out.update({f"final_norm.{k}": s for k, s in norm_param_shapes(cfg).items()})
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> EncDec:
    """Seeded init with the reference's distribution (``common.init_``)."""
    model = EncDec(cfg, device)
    for p in model.parameters():
        init_(p.data, generator)
    return model


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> EncDec:
    """Load the reference's parameter pytree (numpy leaves; layers stacked
    on a leading L axis, layernorm weights as (g, b) tuples)."""
    model = EncDec(cfg, device)
    transformer.put_param(model.embed, tree["embed"])
    for mods, lt, subs in ((model.enc_layers, tree["enc_layers"], _ENC_SUBS),
                           (model.dec_layers, tree["dec_layers"], _DEC_SUBS)):
        for i, layer in enumerate(mods):
            for sub, kind in subs:
                mod = getattr(layer, sub)
                if kind == "norm":
                    transformer.put_norm_param(mod, lt[sub], i)
                else:
                    transformer.put_params(mod, lt[sub], i)
    transformer.put_norm_param(model.enc_final_norm, tree["enc_final_norm"])
    transformer.put_norm_param(model.final_norm, tree["final_norm"])
    return model


# ------------------------------------------------------------------ layers

def _proj(x, p, name: str, cfg: ModelConfig, heads: int):
    """One of q / k / v: (B, S, D) -> (B, S, heads, hd)."""
    y = qlinear(x, getattr(p, f"w{name}"), getattr(p, f"b{name}", None), recipe=cfg.quant)
    return y.reshape(x.shape[0], x.shape[1], heads, cfg.hd)


def _out(a, p, cfg: ModelConfig):
    B, S = a.shape[:2]
    return qlinear(a.reshape(B, S, cfg.n_heads * cfg.hd), p.wo, recipe=cfg.quant)


def _mha(x, p, cfg: ModelConfig, *, kv=None, causal: bool):
    """Self- (kv None) or cross-attention (kv: the encoder's states)."""
    src = x if kv is None else kv
    q = _proj(x, p, "q", cfg, cfg.n_heads)
    k = _proj(src, p, "k", cfg, cfg.n_kv_heads)
    v = _proj(src, p, "v", cfg, cfg.n_kv_heads)
    return _out(transformer.attend(q, k, v, cfg, causal=causal), p, cfg)


def _ffn(x, lp, cfg: ModelConfig):
    return ffn_apply(norm(x, lp.ffn_norm.weight(), cfg.norm), lp.ffn, cfg, cfg.quant)


def _enc_layer(x, lp: EncLayer, cfg: ModelConfig):
    x = x + _mha(norm(x, lp.attn_norm.weight(), cfg.norm), lp.attn, cfg, causal=False)
    return x + _ffn(x, lp, cfg)


def _dec_layer(x, lp: DecLayer, enc_out, cfg: ModelConfig):
    x = x + _mha(norm(x, lp.self_norm.weight(), cfg.norm), lp.self_attn, cfg, causal=True)
    x = x + _mha(norm(x, lp.cross_norm.weight(), cfg.norm), lp.cross_attn, cfg,
                 kv=enc_out, causal=False)
    return x + _ffn(x, lp, cfg)


def _run(layer_fn, x, layers, cfg: ModelConfig, *args):
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        if remat:       # the layer draws no random numbers: no RNG state kept
            x = checkpoint(layer_fn, x, lp, *args, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer_fn(x, lp, *args, cfg)
    return x


def _with_positions(h, n_pos: int, cfg: ModelConfig):
    return h + sinusoidal_embedding(n_pos, cfg.d_model, h.device).to(h.dtype)[None]


def _frames(batch: dict, device) -> torch.Tensor:
    if "frames" not in batch:
        raise KeyError("the audio family needs the batch's 'frames' (B, n_frames, "
                       "d_model): the encoder's input embeddings")
    return torch.as_tensor(batch["frames"], device=device)


def encode(params: EncDec, frames, cfg: ModelConfig):
    """frames (B, n_frames, d_model) stub embeddings -> encoder states."""
    h = torch.as_tensor(frames, device=params.embed.device).to(cfg.act_dtype)
    h = _with_positions(h, h.shape[1], cfg)
    h = _run(_enc_layer, h, params.enc_layers, cfg)
    return norm(h, params.enc_final_norm.weight(), cfg.norm)


def decode(params: EncDec, enc_out, tokens, cfg: ModelConfig):
    """Decoder logits (B, S, V) float32 for tokens (B, S) over enc_out."""
    h = transformer.token_embedding(params, tokens, cfg)
    h = _with_positions(h, h.shape[1], cfg)
    h = _run(_dec_layer, h, params.dec_layers, cfg, enc_out)
    return transformer.final_logits(params, h, cfg)


def forward(params: EncDec, batch: dict, cfg: ModelConfig):
    """Training-path logits, differentiable.  batch: frames, tokens.

    Returns (logits (B, S, V) float32, aux dict)."""
    enc_out = encode(params, _frames(batch, params.embed.device), cfg)
    logits = decode(params, enc_out, batch["tokens"], cfg)
    return logits, {"moe_aux": torch.zeros((), dtype=torch.float32, device=logits.device),
                    "n_prefix": 0}


# ------------------------------------------------------------------ serving

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Per-layer cache shapes and dtype: self (B, C, KV, hd), cross
    (B, n_frames, KV, hd)."""
    check_family(cfg)
    self_shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    cross_shape = (batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
    return {"n_layers": cfg.n_layers, "self_k": self_shape, "self_v": self_shape,
            "cross_k": cross_shape, "cross_v": cross_shape, "dtype": cfg.act_dtype}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> list:
    spec = cache_specs(cfg, batch, cache_len)
    names = ("self_k", "self_v", "cross_k", "cross_v")
    return [{n: torch.zeros(spec[n], dtype=spec["dtype"], device=device) for n in names}
            for _ in range(spec["n_layers"])]


@torch.no_grad()
def prefill(params: EncDec, batch: dict, cfg: ModelConfig, cache_len: int):
    """Encode the frames, compute each layer's cross K / V, and run the
    decoder prompt, filling the self-attention cache.

    Returns (last logits (B, V), cache).  cache_len >= prompt length."""
    enc_out = encode(params, _frames(batch, params.embed.device), cfg)
    h = transformer.token_embedding(params, batch["tokens"], cfg)
    B, S, _ = h.shape
    if S > cache_len:
        raise ValueError(f"cache of length {cache_len} cannot take {S} entries at 0")
    h = _with_positions(h, S, cfg)
    KV = cfg.n_kv_heads
    cache = []
    for lp in params.dec_layers:
        hn = norm(h, lp.self_norm.weight(), cfg.norm)
        p = lp.self_attn
        q = _proj(hn, p, "q", cfg, cfg.n_heads)
        sk = torch.zeros((B, cache_len, KV, cfg.hd), dtype=cfg.act_dtype, device=h.device)
        sv = torch.zeros_like(sk)
        sk[:, :S] = _proj(hn, p, "k", cfg, KV).to(sk.dtype)
        sv[:, :S] = _proj(hn, p, "v", cfg, KV).to(sv.dtype)
        h = h + _out(transformer.attend(q, sk, sv, cfg, causal=True, kv_len=S), p, cfg)
        hn = norm(h, lp.cross_norm.weight(), cfg.norm)
        p = lp.cross_attn
        qc = _proj(hn, p, "q", cfg, cfg.n_heads)
        ck = _proj(enc_out, p, "k", cfg, KV)
        cv = _proj(enc_out, p, "v", cfg, KV)
        h = h + _out(transformer.attend(qc, ck, cv, cfg, causal=False), p, cfg)
        h = h + _ffn(h, lp, cfg)
        cache.append({"self_k": sk, "self_v": sv, "cross_k": ck.to(cfg.act_dtype),
                      "cross_v": cv.to(cfg.act_dtype)})
    return transformer.final_logits(params, h[:, -1:], cfg)[:, -1], cache


@torch.no_grad()
def decode_step(params: EncDec, cache: list, tokens, cache_index: int, cfg: ModelConfig):
    """One decoder token against a cache filled to cache_index, the cross
    K / V precomputed by ``prefill``.  Returns (logits (B, V), cache), the
    self-attention entries written in place."""
    h = transformer.token_embedding(params, tokens, cfg)
    idx = int(cache_index)
    row = min(max(idx, 0), DECODE_POSITIONS - 1)
    pos = sinusoidal_embedding(DECODE_POSITIONS, cfg.d_model, h.device)[row:row + 1]
    h = h + pos.to(h.dtype)[None]
    B, S, _ = h.shape
    KV = cfg.n_kv_heads
    for lp, c in zip(params.dec_layers, cache):
        sk, sv = c["self_k"], c["self_v"]
        if idx < 0 or idx + S > sk.shape[1]:
            raise ValueError(f"cache of length {sk.shape[1]} cannot take "
                             f"{S} entries at {idx}")
        hn = norm(h, lp.self_norm.weight(), cfg.norm)
        p = lp.self_attn
        q = _proj(hn, p, "q", cfg, cfg.n_heads)
        sk[:, idx:idx + S] = _proj(hn, p, "k", cfg, KV).to(sk.dtype)
        sv[:, idx:idx + S] = _proj(hn, p, "v", cfg, KV).to(sv.dtype)
        h = h + _out(transformer.attend(q, sk, sv, cfg, causal=True, q_offset=idx,
                                        kv_len=idx + S), p, cfg)
        hn = norm(h, lp.cross_norm.weight(), cfg.norm)
        p = lp.cross_attn
        qc = _proj(hn, p, "q", cfg, cfg.n_heads)
        h = h + _out(transformer.attend(qc, c["cross_k"], c["cross_v"], cfg, causal=False),
                     p, cfg)
        h = h + _ffn(h, lp, cfg)
    return transformer.final_logits(params, h, cfg)[:, -1], cache
