"""B4: fused quantize-dequantize — the QONNX ``Quant`` op as one CUDA kernel.

Replaces ``repro/kernels/quant_dequant.py`` · ``quant_dequant`` (Pallas body
``_qdq_kernel``).  CUDA source: ``csrc/quant_dequant.cu``.

    q   = clip(round_mode(x / s + z), lo, hi)
    out = (q - z) * s           or the int8 codes q when ``emit_codes``

``s`` and ``z`` are per tensor or per last-dim channel; the bit width,
signedness, ``narrow`` and rounding mode are static, and the clip bounds
come from Python doubles as in the reference (``_static_bounds``), rounded
once to float32.

Bound on the card: bytes.  One float32 read and one float32 (or int8)
write per element, at 3.35 TB/s on an H100; the arithmetic is a handful
of float ops per element.  Design (details in the source): the geometry
is a host plan, ``qdq_launch_plan`` — a scalar head that brings x onto 16
bytes, a body of float4 loads (several in flight per thread) and 16-byte
or 4-code stores in a grid-stride loop sized to a few waves of SMs, and a
scalar tail; per-tensor ``s`` and ``z`` are read once per thread,
per-channel columns advanced without a division, and the index is 32-bit
below 2^31 elements.  The division ``x / s`` is a multiply by ``1 / s``
where ``s`` is a power of two whose reciprocal is a finite normal float32
(both round the same real number once: ``exact_inverses``), else the IEEE
division; ``quant_dequant_host_half`` is that arithmetic in PyTorch, which
the CPU tests hold against the twin bit for bit.

On a CPU tensor the wrapper runs ``quant_dequant_plain``, the same
arithmetic in PyTorch; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ._build import SMS, check, load

ROUNDING_MODE_IDS = {"ROUND": 0, "CEIL": 1, "FLOOR": 2, "UP": 3, "DOWN": 4,
                     "ROUND_TO_ZERO": 4, "HALF_UP": 5, "HALF_DOWN": 6}

launches = 0        # kernel launches (the plain twin does not count)


def static_bounds(signed: bool, narrow: bool, bit_width: float) -> tuple[float, float]:
    """Eqs. 2-3 with ``narrow``, computed in Python doubles."""
    b = float(bit_width)
    if signed:
        lo = -(2.0 ** (b - 1)) + (1.0 if narrow else 0.0)
        hi = 2.0 ** (b - 1) - 1.0
    else:
        lo = 0.0
        hi = 2.0 ** b - 1.0 - (1.0 if narrow else 0.0)
    return lo, hi


def _round(v: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "ROUND":
        return torch.round(v)
    if mode in ("DOWN", "ROUND_TO_ZERO"):
        return torch.trunc(v)
    if mode == "UP":
        return torch.sign(v) * torch.ceil(torch.abs(v))
    if mode == "CEIL":
        return torch.ceil(v)
    if mode == "FLOOR":
        return torch.floor(v)
    if mode == "HALF_UP":
        return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)
    return torch.sign(v) * torch.ceil(torch.abs(v) - 0.5)      # HALF_DOWN


def _row(p: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A scale / zero point as a float32 (1,) or (N,) vector."""
    p = p.reshape(-1).to(torch.float32)
    if p.numel() not in (1, n):
        raise ValueError(f"{name} must be a scalar or have {n} entries, "
                         f"got {p.numel()}")
    return p


def quant_dequant_plain(x, scale, zero_point, *, bit_width=8, signed=True,
                        narrow=False, rounding_mode="ROUND",
                        emit_codes=False) -> torch.Tensor:
    """The plain PyTorch twin of the kernel (same arithmetic, same order)."""
    n = x.shape[-1]
    s = _row(torch.as_tensor(scale, device=x.device), n, "scale")
    z = _row(torch.as_tensor(zero_point, device=x.device), n, "zero_point")
    lo, hi = static_bounds(signed, narrow, bit_width)
    q = _round(x.to(torch.float32) / s + z, rounding_mode.upper())
    q = torch.clamp(q, lo, hi)
    if emit_codes:
        return q.to(torch.int8)
    return ((q - z) * s).to(x.dtype)


def exact_inverses(s: torch.Tensor) -> torch.Tensor:
    """``csrc/qdq_round.cuh`` · ``exact_inverse`` elementwise, on the bits:
    ``1 / s`` where ``s`` is a power of two (either sign) whose reciprocal
    is a finite normal float32 (biased exponent 1 .. 253), else 0.  There
    ``x * (1 / s)`` and ``x / s`` round the same real number ``x · 2^-e``
    once, so they agree in every bit, subnormal results, overflow, signed
    zeros and NaN included."""
    b = s.to(torch.float32).contiguous().view(torch.int32)
    e = (b >> 23) & 0xFF
    ok = ((b & 0x7FFFFF) == 0) & (e >= 1) & (e <= 253)
    inv = ((b & -(2 ** 31)) | ((254 - e) << 23)).view(torch.float32)
    return torch.where(ok, inv, torch.zeros_like(inv))


def quant_dequant_host_half(x, scale, zero_point, *, bit_width=8, signed=True,
                            narrow=False, rounding_mode="ROUND",
                            emit_codes=False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: ``x * exact_inverse(s)`` where
    that inverse exists (per tensor or per column), else ``x / s``; then
    the twin's rounding, clip and dequant.  Equal to
    ``quant_dequant_plain`` bit for bit (the CPU tests hold it so)."""
    n = x.shape[-1]
    s = _row(torch.as_tensor(scale, device=x.device), n, "scale")
    z = _row(torch.as_tensor(zero_point, device=x.device), n, "zero_point")
    lo, hi = static_bounds(signed, narrow, bit_width)
    x = x.to(torch.float32)
    inv = exact_inverses(s)
    t = torch.where(inv != 0, x * inv, x / s)
    q = torch.clamp(_round(t + z, rounding_mode.upper()), lo, hi)
    if emit_codes:
        return q.to(torch.int8)
    return (q - z) * s


# ------------------------------------------------------ the launch plan

QDQ_THREADS = 256              # threads per block (the kernel's THREADS)
QDQ_UMAX = 4                   # 16-byte loads in flight per thread, at most
# a trip of the grid: four waves of full occupancy (8 blocks of 256
# threads per SM); larger tensors loop
QDQ_MAX_BLOCKS = SMS * 8 * 4
# fewer blocks than this and a thread keeps fewer loads in flight, so the
# grid still spreads over the SMs
QDQ_MIN_BLOCKS = SMS * 4
QDQ_GEO_FIELDS = ("n", "nvec", "cols", "head", "tail", "ovec", "unroll",
                  "blocks", "wide")


@dataclass(frozen=True)
class QdqPlan:
    """B4's launch geometry, in the order of the kernel's ``Geo``
    (``QDQ_GEO_FIELDS``): ``head`` scalar elements bring x onto 16 bytes,
    ``nvec`` float4 vectors follow, ``tail`` scalar elements end it (block
    0 takes head and tail); ``ovec``: the output of the body is on 16
    bytes (float32) or 4 bytes (codes) too, so it is stored a vector at a
    time; ``unroll`` vectors per thread per trip, ``blocks`` of
    ``QDQ_THREADS`` threads, a grid-stride loop past ``blocks · threads ·
    unroll`` vectors; ``wide``: 64-bit indices (n >= 2^31)."""
    n: int
    nvec: int
    cols: int
    head: int
    tail: int
    ovec: int
    unroll: int
    blocks: int
    wide: int

    @property
    def sweep(self) -> int:
        """Vectors one trip of the grid covers."""
        return self.blocks * QDQ_THREADS * self.unroll

    @functools.cached_property
    def ints(self):
        """The C interface's geometry array (built once per plan)."""
        return (ctypes.c_longlong * len(QDQ_GEO_FIELDS))(
            *(getattr(self, f) for f in QDQ_GEO_FIELDS))

    def element_visits(self):
        """Every element index the launch computes, once per visit, in the
        kernel's loops (head and tail, then each thread's vectors trip by
        trip): a numpy int64 array, for the coverage tests."""
        import numpy as np
        t = np.arange(min(self.head + self.tail, QDQ_THREADS))
        parts = [np.where(t < self.head, t, self.head + 4 * self.nvec + t - self.head)]
        base = (np.arange(self.blocks)[:, None] * QDQ_THREADS * self.unroll
                + np.arange(QDQ_THREADS)[None, :]).ravel()
        for trip in range(-(-self.nvec // self.sweep) if self.nvec else 0):
            v0 = base + trip * self.sweep
            v0 = v0[v0 < self.nvec]
            for j in range(self.unroll):
                v = v0 + j * QDQ_THREADS
                v = v[v < self.nvec]
                parts.append((self.head + 4 * v[:, None] + np.arange(4)).ravel())
        return np.concatenate(parts).astype(np.int64)


@functools.lru_cache(maxsize=1024)
def qdq_launch_plan(numel: int, cols: int, per_channel: bool, x_phase: int = 0,
                    o_phase: int = 0, max_blocks: int = QDQ_MAX_BLOCKS,
                    override=None) -> QdqPlan:
    """B4's geometry for ``numel`` elements in rows of ``cols`` (per
    channel; a per-tensor plan has no columns and keeps ``cols`` 1).

    ``x_phase``: x's address in float32 elements, mod 4 (a view whose
    storage offset is not a multiple of 4 elements); ``o_phase``: the
    output's, in its own elements, mod 4.  The head is the ``(4 - x_phase)
    % 4`` elements before x's first 16-byte boundary; the body's stores go
    a vector at a time only where the output has x's phase, so that it is
    then aligned too (the wrapper allocates it so).  ``unroll`` is the most loads in
    flight (4, 2, 1) that still leave ``QDQ_MIN_BLOCKS`` blocks, and the
    grid is capped at ``max_blocks`` (a grid-stride loop covers the rest).

    ``override``: ``(unroll, max_blocks)`` (``qdq_blocks``) in place of the
    heuristic's loads in flight and ``max_blocks``, as the autotuner gives
    them; an unroll outside 1..QDQ_UMAX or a cap outside the grid's limit
    raises ``ValueError``."""
    if numel < 0 or cols < 1 or not 0 <= x_phase < 4 or not 0 <= o_phase < 4:
        raise ValueError(f"qdq_launch_plan: bad geometry numel={numel} cols={cols} "
                         f"phases {x_phase}, {o_phase}")
    head = min((4 - x_phase) % 4, numel)
    nvec = (numel - head) // 4
    tail = numel - head - 4 * nvec
    if override is None:
        unroll = 1
        for u in (QDQ_UMAX, 2):
            if -(-nvec // (QDQ_THREADS * u)) >= QDQ_MIN_BLOCKS:
                unroll = u
                break
    else:
        unroll, max_blocks = (int(v) for v in override)
        if not 1 <= unroll <= QDQ_UMAX or not 1 <= max_blocks < 2 ** 31:
            raise ValueError(f"qdq_launch_plan: override {tuple(override)} is not "
                             f"(unroll 1..{QDQ_UMAX}, a grid of 1 .. 2^31 - 1)")
    blocks = max(1, min(-(-nvec // (QDQ_THREADS * unroll)), max_blocks))
    return QdqPlan(numel, nvec, cols if per_channel else 1, head, tail,
                   int(o_phase == x_phase), unroll, blocks, int(numel >= 2 ** 31))


def qdq_blocks(plan: QdqPlan) -> tuple[int, int]:
    """The choices of a plan, as ``qdq_launch_plan``'s ``override`` takes
    them: ``(unroll, blocks)``."""
    return (plan.unroll, plan.blocks)


def quant_dequant(x: torch.Tensor, scale, zero_point, *, bit_width=8,
                  signed=True, narrow=False, rounding_mode="ROUND",
                  emit_codes=False, blocks=None) -> torch.Tensor:
    """Fused QDQ over a (..., N) float32 tensor; scale / zero_point are
    scalars or (N,) tensors.  Returns float32 values of ``x``'s shape, or
    int8 codes when ``emit_codes`` (widths must fit int8).  ``blocks``:
    the launch plan's ``override`` (``qdq_blocks``), None for the
    heuristic; the twin ignores it."""
    global launches
    mode = rounding_mode.upper()
    if mode not in ROUNDING_MODE_IDS:
        raise ValueError(f"unknown rounding_mode {rounding_mode!r}")
    if x.device.type == "cpu":
        return quant_dequant_plain(x, scale, zero_point, bit_width=bit_width,
                                   signed=signed, narrow=narrow,
                                   rounding_mode=mode, emit_codes=emit_codes)
    if x.device.type != "cuda":
        raise ValueError(f"quant_dequant runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("quant_dequant takes a contiguous float32 tensor, "
                         f"got {x.dtype} contiguous={x.is_contiguous()}")
    if x.ndim == 0:
        raise ValueError("quant_dequant needs at least one dimension")
    n = x.shape[-1]
    s = _row(torch.as_tensor(scale, device=x.device), n, "scale").contiguous()
    z = _row(torch.as_tensor(zero_point, device=x.device), n,
             "zero_point").contiguous()
    if s.device != x.device or z.device != x.device:
        raise ValueError("scale and zero_point must lie on x's device")
    lo, hi = static_bounds(signed, narrow, bit_width)
    numel = x.numel()
    dtype = torch.int8 if emit_codes else x.dtype
    x_phase = x.data_ptr() // 4 % 4
    if x_phase == 0:
        out = torch.empty(x.shape, dtype=dtype, device=x.device)
    else:                   # the output at x's phase: the body's stores stay vectors
        out = torch.empty(numel + 3, dtype=dtype, device=x.device)[
            x_phase:x_phase + numel].view(x.shape)
    if numel == 0:
        return out
    per_channel = s.numel() > 1 or z.numel() > 1
    plan = qdq_launch_plan(numel, max(n, 1), per_channel, x_phase,
                           out.data_ptr() // out.element_size() % 4,
                           override=None if blocks is None else tuple(blocks))
    err = load().qdq_launch(
        x.data_ptr(), s.data_ptr(), z.data_ptr(), out.data_ptr(), plan.ints,
        int(s.numel() > 1), int(z.numel() > 1), lo, hi,
        ROUNDING_MODE_IDS[mode], int(emit_codes),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "qdq_launch")
    launches += 1
    return out
