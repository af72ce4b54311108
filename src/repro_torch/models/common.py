"""Shared LM substrate: config, norms, RoPE, chunked attention, FFNs
(counterpart of ``repro.models.common``).

Every LM architecture of ``repro_torch.configs`` is expressed through
``ModelConfig``.  The reference stacks its layers on a leading L axis and
runs them under ``lax.scan``; the port keeps one ``nn.Module`` per layer
(``models/transformer.py``) and runs them in a Python loop.

``chunked_attention`` is the reference's online-softmax attention over
KV chunks, GQA-grouped (q reshaped to (B, S, KV, G, hd)), in plain
PyTorch.  The serving path runs it for decode and the train step for
every attention (autograd differentiates it); full-prefix attention
outside autograd (``forward``, ``prefill``) runs in the flash-attention
kernel B7 (``kernels/flash_attention.py``), which computes the same
function.

The reference's mesh-sharding hooks (``constrain_logits``,
``constrain_residual``, ``_shard_attn``) read the ambient ``Mesh``
(``with mesh:``, ``dist.sharding``) and compute the reference's spec
(``logits_spec``, ``residual_spec``, ``attn_specs``).  A sharding
constraint is no arithmetic: each hook returns a plain tensor as it is,
and redistributes a DTensor to the spec's placements (same values).

**DTensors.**  Every family's ``forward``, ``prefill`` and
``decode_step`` (``models/api.py``) and the train step (``train/loop.py``,
its backward included) run under ``dtensor_scope``: where a parameter or
an input is a DTensor, the call runs under DTensor's
``implicit_replication()``, so the tensors a model builds inside itself
(the RoPE and sinusoidal tables, masks, ``arange`` positions, the 0-d
constants of the fake quant) act as replicated on the DTensors' mesh;
on plain tensors the scope does nothing.  Caches and carried states
built inside a model are DTensors placed by ``cache_pspecs`` over the
ambient mesh (``cache_zeros``), and a head split whose model-axis shard
does not divide the heads replicates that axis first (``reshape``).
Parameters sharded over the data axes (FSDP) read whole, all-gathered
by ``dist.sharding.distribute_model``.  Attention, the wkv recurrence,
the RG-LRU scan and MoE dispatch run on each rank's shards
(``on_shards``): B7 among them where it applies, but on a dry-run's meta
shards attention runs ``chunked_attention``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
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
    remat: bool = False            # recompute each block in the backward
    # gates the residual and attention sharding hooks, as in the reference
    shard_activations: bool = False
    scan_unroll: bool = False      # the reference's scan switch; ignored

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
        total = self.param_count()
        expert = 3 * self.d_model * self.d_ff          # gate/up/down per expert
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return int(total - inactive)


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
    """The (n_pos, d) float32 table of the reference's numpy expression,
    built once per (n_pos, d, device) and cached: whisper's decode step
    asks for the 8192-row table on every token.  Callers must not write
    into it."""
    return _sinusoidal(int(n_pos), int(d), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=32)
def _sinusoidal(n_pos: int, d: int, device: torch.device) -> torch.Tensor:
    pos = np.arange(n_pos)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000, (2 * (i // 2)) / d)
    emb = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.as_tensor(emb, dtype=torch.float32, device=device)


# ------------------------------------------------------- sharding hooks

def _ambient_mesh():
    from repro_torch.dist.sharding import current_mesh
    return current_mesh()


def _model_axis_size() -> int:
    """Size of the ambient mesh's 'model' axis (0 if no mesh context)."""
    m = _ambient_mesh()
    if m is not None and "model" in m.axis_names:
        return int(m.shape["model"])
    return 0


def _dp_axes():
    """DP axis names of the ambient mesh and the mesh (((), None) if no
    mesh context)."""
    m = _ambient_mesh()
    if m is None:
        return (), None
    return tuple(a for a in ("pod", "data") if a in m.axis_names), m


def _dp_size(dp, m) -> int:
    size = 1
    for a in dp:
        size *= int(m.shape[a])
    return size


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return False
    return isinstance(x, DTensor)


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        # a model's parameters are DTensors all or none (distribute_model)
        yield from itertools.islice(tree.parameters(), 1)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@contextlib.contextmanager
def dtensor_scope(*trees):
    """``implicit_replication()`` where any tensor of ``trees`` is a
    DTensor, so plain tensors built inside the model act as replicated;
    nothing otherwise.  ``trees``: modules, dicts, lists of tensors."""
    if not any(is_dtensor(t) for tree in trees for t in _leaves(tree)):
        yield
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        yield           # an enclosing scope's; its exit, not ours, ends it
        return
    with implicit_replication():
        yield


def reshape(t, *shape):
    """``t.reshape(*shape)``.  On a DTensor whose shard cannot follow the
    reshape (a model-axis shard of H·hd features split into heads that
    the axis does not divide), the mesh dims that shard a dim the reshape
    changes are replicated first, as GSPMD would gather them; the
    backward brings the gradient to the result's placements before it
    reshapes it back (DTensor's own view backward would meet the same
    split)."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    return _DReshape.apply(t, shape)


def _placements_for_reshape(t, shape) -> list:
    """``t``'s placements, its shards of dims the reshape changes made
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    new = torch.empty(t.shape, device="meta").reshape(*shape).shape
    pre_new, acc = {}, 1
    for e, n in enumerate(new):
        pre_new.setdefault((acc, n), e)
        acc *= n
    kept, pre = set(), 1
    for d, n in enumerate(t.shape):
        if (pre, n) in pre_new:
            kept.add(d)
        pre *= n
    return [Replicate() if isinstance(pl, Shard) and pl.dim not in kept else pl
            for pl in t.placements]


class _DReshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shape):
        ctx.in_shape = tuple(t.shape)
        try:
            out = t.reshape(*shape)
        except (RuntimeError, NotImplementedError):
            out = t.redistribute(t.device_mesh, _placements_for_reshape(t, shape)) \
                   .reshape(*shape)
        ctx.out_placements = list(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist.sharding import contiguous_shards
        if list(g.placements) != ctx.out_placements:
            g = g.redistribute(g.device_mesh, ctx.out_placements)
        return contiguous_shards(g).reshape(*ctx.in_shape), None


def on_shards(fn, args: tuple, dims: tuple, out_dims: tuple, heads: int = 1):
    """``fn(*args)`` computed on each rank's shards where the arguments are
    DTensors (``local_map``), for functions independent across the batch
    (or MoE token groups) and across head groups (attention, the wkv
    recurrence): argument i is sharded over the data axes on its batch
    dim and over "model" on its head dim (``dims[i]``: (batch dim or
    None, head dim or None)), output j likewise (``out_dims``).  A dim
    the axes do not divide (the batch of the first argument that has one,
    or ``heads``, the coarsest head grouping) is replicated over them.
    An argument replicated over a mesh dim that splits an output (the wkv
    recurrence's bonus ``u``, shared by every batch row) gets a gradient
    that is a pending sum over that dim: each rank's is its rows' part.
    On plain tensors, the call."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = next(a for a in args if is_dtensor(a)).device_mesh
    names = dm.mesh_dim_names or ()
    data = [i for i, n in enumerate(names) if n != "model"]
    n_data = math.prod(dm.size(i) for i in data)
    batch = next(a.shape[d[0]] for a, d in zip(args, dims) if d[0] is not None)
    split_b = batch % n_data == 0
    split_h = "model" in names and heads % dm.size(names.index("model")) == 0

    def pl(bdim, hdim):
        out = []
        for i, n in enumerate(names):
            if n == "model":
                out.append(Shard(hdim) if (split_h and hdim is not None) else Replicate())
            else:
                out.append(Shard(bdim) if (split_b and bdim is not None) else Replicate())
        return tuple(out)

    def local(*shards):
        # DTensor wraps the shards' gradients as they come: give it
        # contiguous ones, as it assumes of a local shard it later views
        out = fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t for t in shards))
        return tuple(o.contiguous() for o in out) if isinstance(out, tuple) else out.contiguous()

    out_pl = tuple(pl(*d) for d in out_dims)
    in_pl = tuple(pl(*d) for d in dims)
    split = [any(isinstance(o[i], Shard) for o in out_pl) for i in range(len(names))]
    grad_pl = tuple(tuple(Partial() if split[i] and isinstance(p, Replicate) else p
                          for i, p in enumerate(ps)) for ps in in_pl)
    run = local_map(local, out_placements=out_pl, in_placements=in_pl,
                    in_grad_placements=grad_pl, device_mesh=dm, redistribute_inputs=True)
    out = run(*args)
    return out[0] if len(out_dims) == 1 and isinstance(out, (tuple, list)) else out


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def pad_seq(t, before: int, after: int = 0):
    """``t`` zero-padded on dim 1 (the sequence), as ``F.pad``; a DTensor
    by concatenating zeros shaped as its slices (placed alike), which
    every DTensor version shards through."""
    if not is_dtensor(t):
        pad = [0, 0] * (t.ndim - 2) + [before, after]
        return F.pad(t, pad)
    parts = [t]
    if before:
        parts.insert(0, torch.zeros_like(t[:, :1]).expand(-1, before, *t.shape[2:]))
    if after:
        parts.append(torch.zeros_like(t[:, :1]).expand(-1, after, *t.shape[2:]))
    return torch.cat(parts, dim=1)


def roll_seq(t, shift: int):
    """``torch.roll(t, shift, dims=1)``; a DTensor as the concatenation of
    its two slices (the same values; DTensor has no sharding rule for
    ``roll`` in every version)."""
    if not is_dtensor(t):
        return torch.roll(t, shift, dims=1)
    shift %= t.shape[1]
    if not shift:
        return t
    return torch.cat([t[:, -shift:], t[:, :-shift]], dim=1)


def cache_zeros(shape, dtype, like) -> torch.Tensor:
    """Zeros for a cache or carried state of ``shape``: on ``like``'s
    device; where ``like`` is a DTensor, a DTensor over its mesh placed
    by ``cache_pspecs`` over the ambient mesh (the batch dim over the data
    axes), its shards allocated where ``like``'s are."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from repro_torch.dist.sharding import Sharding, cache_pspecs, placed_zeros, placements
    mesh = _ambient_mesh()
    if mesh is None:
        raise RuntimeError("a cache for DTensor inputs needs the ambient mesh "
                           "(with mesh: ...)")
    spec = cache_pspecs(tuple(shape), mesh)
    return placed_zeros(tuple(shape), dtype,
                        Sharding(like.device_mesh, placements(spec, mesh), spec),
                        like.to_local().device)


def _constrain(x, spec):
    """x, redistributed to ``spec``'s placements over the ambient mesh if
    it is a DTensor; a plain tensor (or no spec) as it is."""
    if spec is None or not is_dtensor(x):
        return x
    from repro_torch.dist.sharding import placements
    want = placements(spec, _ambient_mesh(), tuple(x.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, list(want))


def logits_spec(shape: tuple):
    """The reference's constraint on LM-head logits of ``shape``: batch
    over DP, vocab over model; None outside a mesh with both."""
    dp, m = _dp_axes()
    if not dp or "model" not in m.axis_names:
        return None
    from repro_torch.dist.sharding import P
    tp = int(m.shape["model"])
    batch, vocab = shape[0], shape[-1]
    b_ax = (dp if len(dp) > 1 else dp[0]) if batch % _dp_size(dp, m) == 0 else None
    v_ax = "model" if vocab % tp == 0 else None
    return P(*([b_ax] + [None] * (len(shape) - 2) + [v_ax]))


def constrain_logits(logits):
    """Pin the LM-head output to (batch over DP, vocab over model), as the
    reference does; the values are unchanged."""
    return _constrain(logits, logits_spec(tuple(logits.shape)))


def residual_spec(shape: tuple, cfg: ModelConfig):
    """The reference's Megatron-SP constraint on a (B, S, D) residual
    stream: batch over DP, sequence over 'model' (not for moe), feature
    replicated; None when ``cfg.shard_activations`` is off, the rank is
    not 3 or there is no mesh with a model axis."""
    if not cfg.shard_activations or len(shape) != 3:
        return None
    dp, m = _dp_axes()
    if m is None or "model" not in m.axis_names:
        return None
    from repro_torch.dist.sharding import P
    tp = int(m.shape["model"])
    B, S, _ = shape
    b_ax = (dp if len(dp) > 1 else dp[0]) if (dp and B % _dp_size(dp, m) == 0) else None
    s_ax = "model" if (S % tp == 0 and S > 1 and cfg.family != "moe") else None
    return P(b_ax, s_ax, None)


def constrain_residual(x, cfg: ModelConfig):
    """The residual stream's sharding constraint (``residual_spec``).  A
    DTensor stream that spec leaves free is pinned to the layout GSPMD
    propagates from the reference's Megatron rules: batch over DP, the
    rest replicated (DTensor's own per-op choices drift from it)."""
    spec = residual_spec(tuple(x.shape), cfg)
    if spec is None:
        return pin_batch(x)
    return _constrain(x, spec)


def pin_batch(x):
    """A DTensor redistributed to ``batch_spec`` (batch over DP, the rest
    replicated); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return _constrain(x, batch_spec(tuple(x.shape)))


def batch_spec(shape: tuple):
    """Batch over the ambient mesh's DP axes (where they divide it), every
    other dim replicated; None outside a mesh."""
    dp, m = _dp_axes()
    if m is None:
        return None
    from repro_torch.dist.sharding import P
    b_ax = (dp if len(dp) > 1 else dp[0]) if (dp and shape[0] % _dp_size(dp, m) == 0) else None
    return P(b_ax, *([None] * (len(shape) - 1)))


def attn_specs(Sq: int, KV: int, G: int, hd: int, enabled: bool = True) -> dict:
    """The reference's constraints on chunked attention's operands, in its
    layouts: qg (B, Sq, KV, G, hd), kc / vc (B, n_chunks, C, KV, hd);
    {} when disabled or the model axis is 1 or absent.  Prefill shards G,
    else KV, else the query sequence over 'model'; decode (Sq == 1) the
    head dim."""
    if not enabled:
        return {}
    tp = _model_axis_size()
    if tp <= 1:
        return {}
    from repro_torch.dist.sharding import P
    U = P.UNCONSTRAINED
    if Sq > 1:
        if G % tp == 0:
            return {"qg": P(U, U, U, "model", U)}
        if KV % tp == 0:
            kv = P(U, U, U, "model", U)
            return {"qg": P(U, U, "model", U, U), "kc": kv, "vc": kv}
        if Sq % tp == 0:
            return {"qg": P(U, "model", U, U, U)}
        return {}
    if hd % tp == 0:
        hd_spec = P(U, U, U, U, "model")
        return {"qg": hd_spec, "kc": hd_spec, "vc": hd_spec}
    return {}


def _shard_attn(qg, k, v, Sq, KV, G, enabled):
    """``attn_specs`` applied to qg and to the port's unchunked k / v
    (B, Sk, KV, hd): the chunk axes (unconstrained in every spec) merge."""
    specs = attn_specs(Sq, KV, G, qg.shape[-1], enabled)
    if not specs:
        return qg, k, v
    from repro_torch.dist.sharding import P

    def unchunked(spec):
        return None if spec is None else P(spec[0], spec[2], spec[3], spec[4])

    return (_constrain(qg, specs.get("qg")), _constrain(k, unchunked(specs.get("kc"))),
            _constrain(v, unchunked(specs.get("vc"))))


# ---------------------------------------------------- chunked attention

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      window: int = 0, chunk: int = 1024,
                      kv_len: Optional[int] = None, shard: bool = False) -> torch.Tensor:
    """Flash-style attention, chunked over KV, online softmax, GQA-grouped.

    q: (B, Sq, H, hd);  k, v: (B, Sk, KV, hd);  H = KV * G.
    q_offset: absolute position of q[0] (decode: current cache length).
    window:  local attention span (0 = unbounded).
    kv_len:  valid length of k/v (decode with cache); keys at and past it
             are masked.
    shard:   apply the attention sharding hook (``cfg.shard_activations``).
    Returns (B, Sq, H, hd) in q's dtype.

    On DTensors without the hook's constraints (``shard`` off, or a model
    axis of 1), each rank computes its own batch rows and KV groups
    (``on_shards``; groups the model axis does not divide run whole on
    every rank): attention needs no communication then.

    The reference pads k/v to whole chunks and scans every chunk.  A key
    that is masked (padding, past ``kv_len``, or after every query) adds
    ``exp(-1e30 - m) = 0`` to the sums and leaves the running max alone,
    so the port drops those chunks and the padding: the same bits, less
    work on a partly filled cache.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    if is_dtensor(q) and not attn_specs(Sq, KV, G, hd, shard):
        def local(ql, kl, vl):
            return chunked_attention(ql, kl, vl, causal=causal, q_offset=q_offset,
                                     window=window, chunk=chunk, kv_len=kv_len)
        bh = (0, 2)
        return on_shards(local, (q, k, v), (bh, bh, bh), (bh,), KV)
    scale = 1.0 / np.sqrt(hd)
    chunk = min(chunk, Sk)
    valid_len = Sk if kv_len is None else int(kv_len)
    dev = q.device

    qg = reshape(q, B, Sq, KV, G, hd).to(torch.float32) * scale
    qg, k, v = _shard_attn(qg, k, v, Sq, KV, G, shard)
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
    out = reshape(out.permute(0, 3, 1, 2, 4), B, Sq, H, hd)
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
