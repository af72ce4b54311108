"""B7: flash attention (causal or full, GQA) as one CUDA kernel.

Replaces ``repro/kernels/flash_attention.py`` · ``flash_attention`` (Pallas
body ``_flash_kernel``).  CUDA source: ``csrc/flash_attention.cu``.

    out[b, h] = softmax(q[b, h] · k[b, h // G]^T / sqrt(hd) [causal]) · v[b, h // G]

q is (B, H, Sq, hd), k and v (B, KV, Sk, hd), H = KV · G; the output has
q's shape and dtype (float32 or bfloat16 in, float32 sums inside).  The
causal mask is the reference's: key j is visible to query i when j <= i.
Unlike the reference, Sq and Sk need not be multiples of a block: the
kernel masks the ragged edge itself.

Bound on the card: operations, 4·hd per visible (query, key) pair.  Two
bodies (design in the source):

  * bfloat16: both products on the bf16 tensor cores (``mma.sync``,
    float32 accumulation), the online softmax on the accumulator
    fragments in registers, K and V tiles double-buffered in shared
    memory by 16-byte ``cp.async`` copies so that the next tile's loads
    overlap this tile's products.  The scale, log2(e) folded in,
    multiplies the float32 scores after the dot (the softmax takes exp2),
    and P enters P·V as two bf16 parts (hi + lo), so the result stays
    within one bf16 step of the twin.  The copies need every row of q,
    k, v and the output on 16 bytes: the wrapper raises on a base
    address or a stride (of a dimension longer than 1) that breaks it.
  * float32: both products on the float32 CUDA cores (no TF32).

Every tensor is read through its strides with a contiguous last
dimension, so the model hands over transposed views of its (B, S, H, hd)
activations and its KV cache without a copy, and the output is written
in q's memory layout.

On a CPU tensor the wrapper runs ``flash_attention_plain``, the same
online softmax in PyTorch over the kernel's key tiles; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from ._build import check, load

HEAD_DIMS = (16, 32, 64, 128)     # the head widths the kernel is built for
BLOCK_K = 64                      # the kernel's key tile (csrc: BK)
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0        # kernel launches (the plain twin does not count)


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q (B, H, Sq, hd) and k, v "
                         f"(B, KV, Sk, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")


def _check_rows_aligned(*tensors) -> None:
    """The bf16 body copies rows in 16-byte pieces: every row of every
    tensor must start on 16 bytes (a base address and strides of
    dimensions longer than 1 in whole 16-byte units)."""
    for t in tensors:
        unit = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
                n > 1 and st % unit for n, st in zip(t.shape[:3], t.stride()[:3])):
            raise ValueError(
                "flash_attention (bfloat16): every row must start on 16 bytes; "
                f"got strides {tuple(t.stride())} at address offset "
                f"{t.data_ptr() % 16}")


def flash_attention_plain(q, k, v, *, causal=True, block=BLOCK_K) -> torch.Tensor:
    """The plain PyTorch twin: the reference's online softmax over key
    tiles of ``block`` (the kernel's tile), float32 state, the same mask
    fill, scale placement and final division."""
    _check_shapes(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = (q.to(torch.float32) * (1.0 / math.sqrt(hd))).reshape(B, KV, G, Sq, hd)
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    k_end = min(Sk, Sq) if causal else Sk      # later tiles are all masked
    for k0 in range(0, k_end, block):
        kb = k[:, :, k0:k0 + block].to(torch.float32)     # (B, KV, c, hd)
        vb = v[:, :, k0:k0 + block].to(torch.float32)
        s = torch.einsum("bkgqh,bkch->bkgqc", qg, kb)
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=dev)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bkch->bkgqh", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd);  k, v: (B, KV, Sk, hd);  H = KV * G.

    Returns (B, H, Sq, hd) in q's dtype.  On CUDA: float32 or bfloat16
    (all three alike), hd in ``HEAD_DIMS``, last dimension contiguous
    (any other strides; for bfloat16 every row on 16 bytes)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_shapes(q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError("flash_attention takes float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention is built for head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous last dimension")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} exceed the launch grid")
    out = torch.empty_like(q)            # q's layout when q is dense
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v, out)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    lib = load()
    err = lib.fa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk,
        hd, _DTYPES[q.dtype], int(causal), 1.0 / math.sqrt(hd),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "fa_launch")
    launches += 1
    return out
