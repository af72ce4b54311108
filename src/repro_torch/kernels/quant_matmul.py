"""B1 / B2: weight-quantized matmuls as CUDA kernels.

Replaces ``repro/kernels/quant_matmul.py`` · ``quant_matmul`` (Pallas body
``_qmm_kernel``, B1: int8 weights (K, N)) and ``quant_matmul_int4``
(``_qmm4_kernel``, B2: int4 weights packed two per byte along K, (K/2, N),
row 2r in the low nibble and 2r+1 in the high nibble).  CUDA source:
``csrc/quant_matmul.cu``.

    out = epilogue(x @ w_int)  [+ bias]

x (M, K) float32; bias (N,) or None, added last.  Three bodies, chosen as
the reference chooses them:

  * ``acc_dtype=torch.float32`` (default): a true float32 dot (no TF32),
    then ``acc * w_scale``, w_scale a scalar or (N,);
  * ``acc_dtype=torch.int32``: an exact int32 dot of integer-valued x,
    then ``float(acc) * w_scale``;
  * ``acc_dtype=torch.int32, requant=IntRequant(...)``: the int32 dot, then
    the integer epilogue B3 (``kernels/requant.py``); ``w_scale`` then
    carries the int32 multipliers ``M_x * M_w``.

On the integer bodies ``in_scale`` (a float32 value) divides x as it is
staged, an IEEE division: the lowering passes the activation scale, whose
quotients it proved to be the integers ``q - z``.

Bound on the card: at the TFC shapes (M <= 256, (K, N) in {(784, 64),
(64, 64), (64, 10)}) the 784-wide layer is bound by operations (the
float32 FMA or int32 IMAD rate of the CUDA cores) and the narrow layers by
the bytes of x and the output.  Design: each block owns a 32x32 output
tile and loops over K itself; the weight tile is staged in shared memory,
and B2 unpacks the nibbles while staging, so device memory serves only
the packed bytes.  Ragged edges are masked, with no padding copies.

B2's integer body has a second form on the int8 tensor cores, taken when
the caller passes ``int8_codes=True``: the lowering's proof
(``RequantPlan.int8_codes``) that every staged code ``q - z`` lies in
[-127, 127].  Its bound is bytes (MobileNet-224's pointwise layers need
0.0044 ms of int8 tensor-core work and 0.0448 ms to move x and the output
once), but at 8 rows its layers give few blocks with many K steps, so its
design (in the source) shortens each step's chain of latencies: 16-byte
``cp.async`` copies of x and the packed weights into a ring of raw
stages, each converted once per block to int8 codes in shared memory
while the previous step's ``mma.sync`` products run, one barrier a step,
and the B3 epilogue on 32-bit integers where that is exact.  The staging
(``csrc/int_staging.cuh``, shared with B5 / B6; its host half is
``staging`` and ``staged_values``) keeps the IEEE division's bits: when
``in_scale`` is a power of two whose reciprocal is a finite normal
float32 (``exact_reciprocal``) it multiplies by that reciprocal;
otherwise a quotient that is exactly an integer is staged without
dividing and any other x is divided.  Integer
sums are exact, so both integer forms equal the twin bit for bit.  With
the proof the twin raises on a staged code outside int8, so a wrong proof
shows on the CPU.  ``int8_codes`` without ``acc_dtype=torch.int32``
raises; B1 accepts the keyword (the lowering passes it to every body) and
keeps its body.  ``body_launches`` counts B2's launches per body.

On CPU tensors the wrappers run the plain twins (``*_plain``); on CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from ._build import check, load
from .quant_dequant import ROUNDING_MODE_IDS
from .requant import IntRequant, int_epilogue_plain

launches = {"quant_matmul": 0, "quant_matmul_int4": 0}
# B2's launches per body: the float32 dot, the int32 dot on the CUDA cores
# (IMAD) and the int32 dot on the int8 tensor cores
body_launches = {"f32": 0, "imad": 0, "int8_mma": 0}


def b2_body(acc_dtype, int8_codes: bool) -> str:
    """The body B2 runs for these arguments (a key of ``body_launches``)."""
    if acc_dtype != torch.int32:
        return "f32"
    return "int8_mma" if int8_codes else "imad"


def exact_reciprocal(scale) -> Optional[float]:
    """``1 / scale`` when multiplying by it gives the bits of dividing by
    ``scale`` for every float32 x: ``scale`` a power of two (either sign)
    whose reciprocal is a finite normal float32.  Both then round the
    same real number ``x · 2^-e`` once.  Else None."""
    s = np.float32(scale)
    if not np.isfinite(s) or s == 0 or abs(math.frexp(float(s))[0]) != 0.5:
        return None
    r = float(s) ** -1
    f32 = np.finfo(np.float32)
    if not float(f32.tiny) <= abs(r) <= float(f32.max):
        return None
    return r


# the integer bodies' staging modes (``csrc/int_staging.cuh``), by id
STAGING_MODES = ("reciprocal", "quotient", "division")


@functools.lru_cache(maxsize=256)
def staging(in_scale) -> tuple[int, float, float]:
    """How an integer body stages ``x / in_scale`` (``csrc/int_staging.cuh``,
    shared by B2's int8 body and B5 / B6): ``(mode, div, mul)``, mode an
    index of ``STAGING_MODES``.  ``reciprocal`` where ``exact_reciprocal``
    holds (``mul`` that reciprocal; no in_scale is a division by 1);
    ``quotient`` where 1 / in_scale is a finite normal float32, so that the
    guess ``rint(x · float32(1 / in_scale))`` is worth checking; else
    ``division``.  All three give the IEEE division's integers."""
    div = 1.0 if in_scale is None else float(np.float32(in_scale))
    mul = exact_reciprocal(div)
    if mul is not None:
        return 0, div, mul
    d = np.float32(div)
    with np.errstate(all="ignore"):
        rcp = np.float32(1) / d
    if np.isfinite(d) and d != 0 and np.isfinite(rcp) and \
            abs(float(rcp)) >= float(np.finfo(np.float32).tiny):
        return 1, div, 0.0
    return 2, div, 0.0


def staged_values(x: torch.Tensor, in_scale) -> torch.Tensor:
    """The host half of ``csrc/int_staging.cuh``: the integers the kernels
    stage for float32 ``x``, computed their way in float32 (the reciprocal
    multiply, or the guess kept where ``n · div - x`` is exactly 0, else the
    division), in float64 as ``int_values`` returns them."""
    mode, div, mul = staging(in_scale)
    x = x.to(torch.float32)
    d = torch.tensor(div, dtype=torch.float32)
    if mode == 0:
        q = x * torch.tensor(mul, dtype=torch.float32)
    else:
        q = x / d
        if mode == 1:
            n = torch.round(x * (torch.tensor(1.0, dtype=torch.float32) / d))
            # n · div exact in float64 (48 bits); the difference is 0 only
            # where the float32 FMA's is
            q = torch.where(n.double() * div - x.double() == 0, n, q)
    return torch.round(q).to(torch.float64)


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued int8 -> (K//2, N) int8 carriers: packed row r
    holds rows 2r (low nibble) and 2r+1 (high nibble)."""
    if w_int.shape[0] % 2:
        raise ValueError("K must be even for int4 packing")
    lo = w_int[0::2].to(torch.int32) & 0xF
    hi = w_int[1::2].to(torch.int32) & 0xF
    byte = (hi << 4) | lo                               # 0 .. 255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed int8 -> (K, N) sign-extended int4 values in int8."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(w_packed, 4), 4)
    hi = torch.bitwise_right_shift(w_packed, 4)
    return torch.stack([lo, hi], dim=1).reshape(-1, w_packed.shape[1])


# ------------------------------------------------ epilogue, shared by B5/B6

def check_epilogue(name: str, acc_dtype, requant, in_scale) -> None:
    """Raise on an accumulator / epilogue combination the kernels lack."""
    if acc_dtype not in (torch.float32, torch.int32):
        raise ValueError(f"{name}: acc_dtype must be torch.float32 or "
                         f"torch.int32, not {acc_dtype}")
    if in_scale is not None and acc_dtype != torch.int32:
        raise ValueError(f"{name}: in_scale= divides x on the int32 bodies "
                         "only")
    if requant is None:
        return
    if acc_dtype != torch.int32:
        raise ValueError(f"{name}: requant= needs acc_dtype=torch.int32")
    if not isinstance(requant, IntRequant):
        raise TypeError(f"{name}: requant must be an IntRequant")
    if requant.rounding_mode.upper() not in ROUNDING_MODE_IDS:
        raise ValueError(f"{name}: unknown rounding_mode "
                         f"{requant.rounding_mode!r}")
    # the reference's int32 shifts are defined up to 31 bits; inside that
    # range the kernel's int64 arithmetic cannot overflow
    if not (0 <= requant.shift <= 62 and -31 <= requant.act_shift <= 31):
        raise ValueError(f"{name}: shift {requant.shift} / act_shift "
                         f"{requant.act_shift} out of range")


def int_values(x: torch.Tensor, in_scale) -> torch.Tensor:
    """What the integer bodies stage: ``x / in_scale`` (an IEEE division by
    a tensor on x's device) rounded to nearest, in float64, where every
    int32 and every dot of them below 2**53 is exact."""
    x = x.to(torch.float32)
    if in_scale is not None and float(in_scale) != 1.0:
        x = x / torch.full((), float(in_scale), dtype=torch.float32,
                           device=x.device)
    return torch.round(x).to(torch.float64)


def plain_epilogue(acc: torch.Tensor, w_scale, bias, acc_dtype, requant,
                   channel_shape) -> torch.Tensor:
    """The twins' epilogue over ``acc``: float32 sums, or exact integer sums
    in float64 for the int32 bodies.  ``channel_shape`` views a per-channel
    scale or bias against ``acc``."""
    def per_channel(v, dtype):
        t = torch.as_tensor(v, dtype=dtype, device=acc.device)
        return t.reshape(()) if t.numel() == 1 else t.reshape(channel_shape)
    if acc_dtype == torch.int32:
        acc = acc.to(torch.int64).to(torch.int32)     # the int32 accumulator
        if requant is not None:
            out = int_epilogue_plain(acc, per_channel(w_scale, torch.int32),
                                     requant)
        else:
            out = acc.to(torch.float32) * per_channel(w_scale, torch.float32)
    else:
        out = acc * per_channel(w_scale, torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(channel_shape)
    return out


def epilogue_args(name: str, acc_dtype, requant, in_scale, w_scale,
                  n: int, device) -> tuple:
    """Launch arguments of the epilogue: ``(epi, scale, in_div, rq,
    out_mul)``.  ``scale`` is a contiguous (1,) or (n,) vector, float32, or
    the int32 multipliers on the B3 body (epi 2); ``rq`` the IntRequant's
    nine ints for the C interface."""
    check_epilogue(name, acc_dtype, requant, in_scale)
    epi = 0 if acc_dtype == torch.float32 else (1 if requant is None else 2)
    s = torch.as_tensor(w_scale, dtype=torch.int32 if epi == 2
                        else torch.float32, device=device)
    s = s.reshape(-1).contiguous()
    if s.numel() not in (1, n):
        raise ValueError(f"{name}: w_scale must be a scalar or ({n},)")
    rq, out_mul = None, 0.0
    if requant is not None:
        r = requant
        rq = (ctypes.c_int * 9)(
            r.shift, int(r.relu), int(r.has_act), r.act_shift, r.act_zp,
            r.act_lo, r.act_hi, r.act_out_shift,
            ROUNDING_MODE_IDS[r.rounding_mode.upper()])
        out_mul = r.out_mul()
    in_div = 1.0 if in_scale is None else float(in_scale)
    return epi, s, in_div, rq, out_mul


# ------------------------------------------------------------------ B1/B2

def quant_matmul_plain(x, w_int, w_scale, bias=None, *,
                       acc_dtype=torch.float32, requant=None,
                       in_scale=None) -> torch.Tensor:
    """Plain twin of B1: the float32 product (or the exact integer one),
    then the epilogue, then the bias."""
    check_epilogue("quant_matmul", acc_dtype, requant, in_scale)
    if acc_dtype == torch.int32:
        acc = torch.matmul(int_values(x, in_scale), w_int.to(torch.float64))
    else:
        acc = torch.matmul(x.to(torch.float32), w_int.to(torch.float32))
    return plain_epilogue(acc, w_scale, bias, acc_dtype, requant, (-1,))


def _check_int8_codes(x, acc_dtype, in_scale) -> None:
    """With ``int8_codes`` promised, every staged code must fit int8."""
    if acc_dtype != torch.int32:
        raise ValueError("quant_matmul_int4: int8_codes=True needs "
                         "acc_dtype=torch.int32")
    v = int_values(x, in_scale)
    if v.numel() and (float(v.min()) < -128 or float(v.max()) > 127):
        raise ValueError("quant_matmul_int4: int8_codes=True, but a staged "
                         f"code lies in [{float(v.min()):g}, "
                         f"{float(v.max()):g}], outside [-128, 127]")


def quant_matmul_int4_plain(x, w_packed, w_scale, bias=None, *,
                            int8_codes: bool = False,
                            **kw) -> torch.Tensor:
    """Plain twin of B2: unpack the nibbles, then the B1 twin; with
    ``int8_codes`` it first checks that every staged code fits int8."""
    if int8_codes:
        _check_int8_codes(x, kw.get("acc_dtype", torch.float32),
                          kw.get("in_scale"))
    return quant_matmul_plain(x, unpack_int4(w_packed), w_scale, bias, **kw)


def _launch(name, x, w, w_scale, bias, k, packed, acc_dtype, requant,
            in_scale, int8_codes=False) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D float32 tensor")
    if w.dtype != torch.int8 or w.ndim != 2 or not w.is_contiguous():
        raise ValueError(f"{name}: weights must be a contiguous 2-D int8 tensor")
    m, n = x.shape[0], w.shape[1]
    epi, s, in_div, rq, out_mul = epilogue_args(
        name, acc_dtype, requant, in_scale, w_scale, n, x.device)
    b = None
    if bias is not None:
        b = bias.reshape(-1)
        if b.dtype != torch.float32 or b.numel() != n or not b.is_contiguous():
            raise ValueError(f"{name}: bias must be a contiguous float32 (N,)")
    for t in (w, s) + (() if b is None else (b,)):
        if t.device != x.device:
            raise ValueError(f"{name}: every operand must lie on {x.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias_ptr = None if b is None else b.data_ptr()
    if int8_codes:
        err = load().qmm_i8_launch(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), bias_ptr, out.data_ptr(),
            m, k, n, int(s.numel() > 1), epi, in_div, staging(in_scale)[2], rq,
            out_mul, stream)
        check(err, "qmm_i8_launch")
    else:
        err = load().qmm_launch(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), bias_ptr, out.data_ptr(),
            m, k, n, int(s.numel() > 1), int(packed), epi, in_div, rq, out_mul,
            stream)
        check(err, "qmm_launch")
    launches[name] += 1
    if packed:
        body_launches[b2_body(acc_dtype, int8_codes)] += 1
    return out


def quant_matmul(x: torch.Tensor, w_int: torch.Tensor, w_scale,
                 bias: Optional[torch.Tensor] = None, *,
                 acc_dtype=torch.float32, requant: Optional[IntRequant] = None,
                 in_scale=None, int8_codes: bool = False) -> torch.Tensor:
    """out = epilogue(x @ w_int) [+ bias]; x (M, K) f32, w_int (K, N) int8
    (acc_dtype / requant / in_scale: see the module docstring; int8_codes
    is accepted and B1 keeps its body)."""
    if x.shape[-1] != w_int.shape[0]:
        raise ValueError(f"quant_matmul: K mismatch {tuple(x.shape)} @ "
                         f"{tuple(w_int.shape)}")
    kw = dict(acc_dtype=acc_dtype, requant=requant, in_scale=in_scale)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_int, w_scale, bias, **kw)
    return _launch("quant_matmul", x, w_int, w_scale, bias, w_int.shape[0],
                   packed=False, **kw)


def quant_matmul_int4(x: torch.Tensor, w_packed: torch.Tensor, w_scale,
                      bias: Optional[torch.Tensor] = None, *,
                      acc_dtype=torch.float32,
                      requant: Optional[IntRequant] = None,
                      in_scale=None, int8_codes: bool = False) -> torch.Tensor:
    """out = epilogue(x @ unpack(w_packed)) [+ bias]; w_packed (K/2, N).
    ``int8_codes``: the staged codes are proven to fit int8, so the integer
    body runs on the int8 tensor cores."""
    if x.shape[-1] != 2 * w_packed.shape[0]:
        raise ValueError(f"quant_matmul_int4: K mismatch {tuple(x.shape)} @ "
                         f"packed {tuple(w_packed.shape)}")
    kw = dict(acc_dtype=acc_dtype, requant=requant, in_scale=in_scale)
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, w_packed, w_scale, bias,
                                       int8_codes=int8_codes, **kw)
    if int8_codes and acc_dtype != torch.int32:
        raise ValueError("quant_matmul_int4: int8_codes=True needs "
                         "acc_dtype=torch.int32")
    return _launch("quant_matmul_int4", x, w_packed, w_scale, bias,
                   x.shape[-1], packed=True, int8_codes=int8_codes, **kw)
