#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a host with one CUDA GPU (sm_90a)

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. the card's name and power limit (nvidia-smi), then the CUDA kernels are
   built from ``src/repro_torch/kernels/csrc`` with nvcc (build time and
   the ptxas register report are printed);
2. every kernel against its plain PyTorch twin on the card: B1 / B2
   (quant_matmul, quant_matmul_int4) at the TFC shapes and ragged ones,
   exact on dyadic inputs and within the summation-order bound
   ``2·K·2^-24·(|x|@|w|)·|s|`` on randn inputs; B4 (quant_dequant) bit-exact
   over every rounding mode, signedness, width, granularity and output kind;
   B5 (quant_grouped_matmul, int8 and int4, per-tensor and per-channel
   scale, with and without bias, ragged M / Kg / Ng, and through the conv
   wrapper's strided view) exact on dyadic inputs and within the order
   bound on randn; B6 (quant_depthwise_conv2d) bit-exact on randn inputs
   (its twin sums the taps in the kernel's order) with no epilogue, ReLU
   only, bias, per-channel scale, act bits {2, 4, 8} in every rounding
   mode, stride 2, asymmetric pads, dilation 2 and channel counts off the
   block, at MobileNet-224 shapes among others.  Then the integer bodies
   of B1 / B2 / B5 / B6 (int32 sums, the integer epilogue B3) against their
   twins with ``torch.equal``: every rounding mode, ReLU on and off, the
   act Quant on and off, act_shift -3 / 0 / 5, zero points, signed,
   unsigned and narrow bounds, per-tensor and per-channel multipliers,
   ragged shapes, the int32 body with the float32 epilogue, and sums just
   below 2^24; B2's int8 tensor-core body (``int8_codes=True``) with codes
   over all of int8 at ragged M, N and K and MobileNet pointwise shapes, at
   a power-of-two scale (the reciprocal multiply) and at IN_SCALE (the
   exact-quotient staging), with x off the scale's grid (the division), and
   at its own accumulator limit, each ``torch.equal`` to the twin and to
   the IMAD body, its launches counted per body.  Then the B5 / B6
   redesign's boundaries (``check_redesign``): B6 at DW_GEOMETRIES (planes
   of 1x1, 7x7 and 13x13, C off the planes per block, N = 1, odd H at
   stride 2, asymmetric pads, dilation 2, 5x5 and 1x3 kernels, tiles off
   16 bytes) and every MobileNet-224 depthwise layer at 8 rows, the
   float32 body in every rounding mode and the integer bodies in every
   staging of x (a power-of-two scale: the reciprocal; IN_SCALE: the
   exact-quotient check; x off its grid: the division fallback;
   TINY_SCALE: the division), all ``torch.equal``; B5 at GQ_SHAPES (Ng 1,
   8, 12, 16, 40, Kg off 4 and above the staged slice, int8 and int4) in
   all three bodies and stagings; the per-staging launch counts checked.
   Last B7
   (flash_attention; bf16 on its tensor-core body) against its twin at
   qwen2-1.5B's heads (12 over 2 KV heads, hd 128) and olmo-1B's (16 over
   16), S in {1, 17, 512, 2048, 2047}, B in {1, 4}, causal and not, float32
   (within 2e-5, abs + rel) and bf16 (within one bf16 step, or 2e-5 near
   zero);
3. the main path on the float32-epilogue tier (``use_analysis=False``),
   each graph built by the port's zoo, compiled on CUDA and held against
   the port's oracle on the CPU with the reference's segment census:
   TFC-w2a2 (packed int4: B2 + B4) and TFC-w1a1 with ``use_int4=False``
   (B1 + B4), CNV-w1a1 and CNV-w2a2 (B1, B2, B4), and MobileNet-w4a4 at
   img 224 with 8 rows (B1, B2, B4, B6), all bit-exact.  The zoo's random
   weights let MobileNet's activations quantize to 0 after its fourth
   conv, so the same graph with its conv gains raised by powers of two
   (``zoo.rescale_conv_gains``: same integer weights) runs too, 2 x 8 rows:
   bit-exact through the global average pool, and its final MatMul, whose
   inputs (sums x float32(1/49)) are not dyadic, within the order bound.
   Last a grouped conv (group 8, 64 -> 64 channels, 3x3, 56x56: B5 + B4),
   bit-exact;
4. serving on that tier: a ``CompiledGraphEngine`` answers 64 submitted
   TFC requests and one 40-row batch in 16-row slots, each row bit-exact
   against the oracle on the CPU; a second one serves the rescaled
   MobileNet-w4a4 at img 224 in 8-row slots, 16 submitted requests and one
   ragged 5-row batch, each row bit-exact against the compiled plan's rows
   and within the order bound of the CPU oracle;
3'. + 4'. the same on the integer path, ``compile_graph``'s defaults (the
   analysis tier and B3): TFC-w1a1 / w1a2 / w2a2 (4 of 4 int32 segments),
   CNV-w1a1 / w2a2 (9 of 9), MobileNet-w4a4 at img 224 as the zoo builds it
   and rescaled (27 of 28: the final MatMul stays float32) and the grouped
   conv (B5 on int32), each with the reference's census and
   ``requant_stats()`` and bit-exact against the CPU oracle (MobileNet's
   final MatMul within the order bound); then both engines on integer
   plans, with the load-time cost report.  B2's launches are counted per
   body around every forward: each launches B2's int8 tensor-core body
   once per segment whose meta chose it, exactly 13 per MobileNet-224
   forward (its pointwise convs; TFC's count is printed); B6's 13
   MobileNet-224 launches must all take the reciprocal staging (the zoo's
   activation scales are powers of two), B5's staging is printed;
5. timings beside each kernel's bound, its twin and one library call
   computing the same function (CUDA events, median of 30 samples of 10
   calls after warm-up; device time from a replayed CUDA graph of the 10
   calls, call time from eager calls): at the TFC shapes with M = 256, and
   at the shapes of one MobileNet-w4a4 forward at img 224 with 8 rows
   (B5 at the grouped conv's shape), for the float32 bodies and for the
   integer ones (their library call is ``torch._int_mm`` on the int8
   operands where its shape rules allow, the epilogue not included; B2 on
   the body the lowering picks, and its 13 MobileNet pointwise layers also
   on the int8 body at a power-of-two scale and on the IMAD body; B6's
   13 depthwise layers also at a power-of-two scale; the library call of
   B5's / B6's integer rows is ``torch.bmm`` / ``F.conv2d(groups=C)`` on
   the float32 codes, the same exact sums without the epilogue);
   one MobileNet plan call's device time by kernel name (torch.profiler)
   and the device's busy share, on each path; then each engine's requests
   per second;
6. the LM serving path: first qwen2's SMOKE config on the card against
   the CPU (prefill logits, greedy tokens); then qwen2-1.5B at full width
   (28 layers, W8A8 with an 8-bit KV cache, bf16 activations, seeded
   weights): (a) a B=4, S=2048 prefill with exactly 28 B7 launches, held
   against the same prefill on the plain attention; (b) the launcher's
   traffic (8 requests, 16 new tokens, slots of 4) and the same with
   prompts of 512-2048 tokens through GenerationEngine, tokens per second,
   one slot of each held against greedy_generate;
7. LM timings: B7 at the prefill's attention shape (bf16 and float32)
   beside its twin, F.scaled_dot_product_attention and its bound; prefill
   and decode-step wall times; one decode step by kernel name.

Launch counts are reset just before phase 3 and read just after phase 4,
again around phases 3' and 4', and around phase 6 (a) and (b); every
kernel of each path must have launched there.  The last lines are the card, a JSON line of per-kernel
numbers (summed over one MobileNet-224 forward of 8 rows; B5 over the
grouped conv; the integer rows named ``<kernel>/int32``; B7 over one
qwen2-1.5B prefill at B=4, S=2048, its launches those of phase 6 (b))
and the JSON result line.  It imports nothing of JAX and nothing of the JAX package
``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 on the tensor cores, dense
TFC_LAYERS = [(784, 64), (64, 64), (64, 64), (64, 10)]
M_TIMED = 256
SLOT = 8                       # MobileNet-224 rows per plan call / slot
REPLACES = {
    "quant_matmul": "src/repro/kernels/quant_matmul.py:139",
    "quant_matmul_int4": "src/repro/kernels/quant_matmul.py:184",
    "quant_dequant": "src/repro/kernels/quant_dequant.py:126",
    "quant_grouped_matmul": "src/repro/kernels/quant_grouped_conv.py:218",
    "quant_depthwise_conv2d": "src/repro/kernels/quant_grouped_conv.py:392",
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
}
SOURCES = {
    "quant_matmul": "src/repro_torch/kernels/csrc/quant_matmul.cu",
    "quant_matmul_int4": "src/repro_torch/kernels/csrc/quant_matmul.cu",
    "quant_dequant": "src/repro_torch/kernels/csrc/quant_dequant.cu",
    "quant_grouped_matmul": "src/repro_torch/kernels/csrc/quant_grouped_conv.cu",
    "quant_depthwise_conv2d": "src/repro_torch/kernels/csrc/quant_grouped_conv.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# the kernels of the zoo's compiled path (phases 3 + 4); B7 runs on the LM path
ZOO_KERNELS = ("quant_matmul", "quant_matmul_int4", "quant_dequant", "quant_grouped_matmul",
               "quant_depthwise_conv2d")
# the reference's census (use_analysis=False, use_fusion=False)
CENSUS = {
    ("TFC-w2a2", True): {"quant_dequant": 4, "quant_matmul_int4": 4, "interp": 3},
    ("TFC-w1a1", False): {"quant_dequant": 1, "quant_matmul": 4, "interp": 3},
    ("CNV-w1a1", True): {"quant_dequant": 1, "quant_conv": 1, "quant_conv_int4": 5,
                         "quant_matmul_int4": 3, "interp": 8},
    ("CNV-w2a2", True): {"quant_dequant": 3, "quant_conv": 1, "quant_conv_int4": 5,
                         "quant_matmul_int4": 3, "interp": 5},
    ("MobileNet-w4a4", True): {"quant_dequant": 1, "quant_conv": 1, "quant_conv_dw": 13,
                               "quant_conv_int4": 13, "quant_matmul_int4": 1,
                               "interp": 1},
}
# the reference's census and requant stats on the integer path: compile_graph's
# defaults (use_analysis=True, use_integer_requant=True) with use_fusion=False,
# held against the reference by tests/test_torch_requant.py
_TFC_INT = {"quant_dequant": 4, "quant_matmul_int4": 4, "interp": 3}
_MOBILENET_INT = {"quant_dequant": 1, "quant_conv": 1, "quant_conv_dw": 13,
                  "quant_conv_int4": 13, "interp": 1, "quant_matmul_int4": 1}
CENSUS_ANALYSIS = {
    "TFC-w1a1": {"quant_dequant": 1, "quant_matmul_int4": 4, "interp": 3},
    "TFC-w1a2": _TFC_INT,
    "TFC-w2a2": _TFC_INT,
    "CNV-w1a1": {"quant_dequant": 1, "quant_conv": 1, "interp": 8, "quant_conv_int4": 5,
                 "quant_matmul_int4": 3},
    "CNV-w2a2": {"quant_dequant": 3, "quant_conv": 1, "quant_conv_int4": 5, "interp": 5,
                 "quant_matmul_int4": 3},
    "MobileNet-w4a4": _MOBILENET_INT,
    "MobileNet-w4a4 rescaled": _MOBILENET_INT,
    "GroupedConv-g8": {"quant_dequant": 1, "quant_conv_grouped_int4": 1},
}


def _rq_stats(kernel, int32, eliminated):
    return {"kernel_segments": kernel, "int32_segments": int32,
            "fp32_segments": kernel - int32, "fp32_ops_eliminated": eliminated,
            "coverage": int32 / kernel}


REQUANT_STATS = {
    "TFC-w1a1": _rq_stats(4, 4, 202), "TFC-w1a2": _rq_stats(4, 4, 202),
    "TFC-w2a2": _rq_stats(4, 4, 202), "CNV-w1a1": _rq_stats(9, 9, 284170),
    "CNV-w2a2": _rq_stats(9, 9, 1133578),
    "MobileNet-w4a4": _rq_stats(28, 27, 40341504),
    "MobileNet-w4a4 rescaled": _rq_stats(28, 27, 40341504),
    "GroupedConv-g8": _rq_stats(1, 1, 12845056),
}
# the kernels with an integer body (B3 inlined); B4 has none
INT_KERNELS = ("quant_matmul", "quant_matmul_int4", "quant_grouped_matmul",
               "quant_depthwise_conv2d")
INT8_OPS = 1979e12             # H100 SXM int8 dense tensor-core rate (data sheet)
MOBILENET_224_STATS = {"grouped_segments": 13, "block_diagonal_grouped": 0,
                       "reclaimed_macs": 4_260_017_664,
                       "carrier_bytes_saved": 12_512_160}
# the synthetic grouped conv that puts B5 on the compiled path
GCONV = dict(n=SLOT, c=64, img=56, groups=8)
MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP", "HALF_DOWN",
         "ROUND_TO_ZERO")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(run, samples: int) -> float:
    import torch
    ts = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def time_ms(fn, reps=10, samples=30) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn`` after warm-up.

    Device ms: ``reps`` calls captured in one CUDA graph and replayed, so
    the host's launch path is out of the measurement.  Call ms: ``reps``
    eager calls back to back, which at these shapes is bound by the
    host's launch path (Python wrapper, ctypes, launch)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def eager():
        for _ in range(reps):
            fn()
    device = _median_event_ms(graph.replay, samples) / reps
    call = _median_event_ms(eager, samples) / reps
    return device, call


# ----------------------------------------------------------------- phase 2

def check_matmuls(ops, torch, np, dev, err):
    """B1 / B2 against their twins; returns the number of cases."""
    rng = np.random.RandomState(0)
    # M = 16 is the serving slot, 64 the main path's batch, 256 the timed one
    shapes = [(m, k, n) for m in (1, 8, 16, 64, 256)
              for k, n in ((784, 64), (64, 64), (64, 10))]
    shapes += [(13, 98, 10), (33, 130, 70), (256, 784, 64)]
    n_cases = 0
    for m, k, n in shapes:
        for int4 in (False, True):
            name = "quant_matmul_int4" if int4 else "quant_matmul"
            fn = ops.quant_matmul_int4 if int4 else ops.quant_matmul
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (k, n)).astype(np.int8))
            wk = ops.pack_int4(w) if int4 else w
            for per_col in (False, True):
                for with_bias in (False, True):
                    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, n if per_col else 1))
                                         .astype(np.float32)).reshape(-1 if per_col else ())
                    b = torch.from_numpy((rng.randint(-64, 64, n) / 16.0)
                                         .astype(np.float32)) if with_bias else None
                    # dyadic activations: every partial sum exact -> equal
                    x = torch.from_numpy((rng.randint(-128, 129, (m, k)) / 128.0)
                                         .astype(np.float32))
                    args = [t.to(dev) if t is not None else None for t in (x, wk, s, b)]
                    got = fn(*args)
                    want = ops.quant_matmul_int4_plain(*args) if int4 \
                        else ops.quant_matmul_plain(*args)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} {m}x{k}x{n} differs on dyadic x")
                    # randn activations: summation order may differ
                    xr = torch.randn(m, k, generator=torch.Generator().manual_seed(m * k + n))
                    args[0] = xr.to(dev)
                    got = fn(*args)
                    want = ops.quant_matmul_int4_plain(*args) if int4 \
                        else ops.quant_matmul_plain(*args)
                    mag = (xr.abs() @ w.float().abs()).to(dev) * s.abs().to(dev)
                    # order bound on the sums, plus one rounding of the result
                    bound = 2 * k * 2.0 ** -24 * mag + 2.0 ** -23 * want.abs()
                    diff = (got - want).abs()
                    if bool((diff > bound).any()):
                        raise AssertionError(f"{name} {m}x{k}x{n} beyond the order bound")
                    err[name] = max(err[name], float(diff.max()))
                    n_cases += 2
    return n_cases


def check_quant_dequant(ops, torch, np, dev, err):
    """B4 against its twin, bit-exact; returns the number of cases."""
    from repro_torch.kernels.quant_dequant import static_bounds
    rng = np.random.RandomState(1)
    n_cases = 0
    for shape in ((61, 130), (256, 784)):
        x = (rng.randn(*shape) * 4).astype(np.float32)
        x.reshape(-1)[:13] = np.arange(-6, 7, dtype=np.float32) * 0.5
        x = torch.from_numpy(x).to(dev)
        ncol = shape[1]
        for per_channel in (False, True):
            s = torch.from_numpy((rng.rand(ncol) * 0.5 + 0.05).astype(np.float32)).to(dev) \
                if per_channel else torch.tensor(0.37, device=dev)
            z = torch.from_numpy(np.round(rng.randn(ncol)).astype(np.float32)).to(dev) \
                if per_channel else torch.tensor(1.0, device=dev)
            for mode in MODES:
                for bits in (1, 2, 4, 7.5, 8):
                    for signed, narrow in ((True, False), (True, True), (False, False),
                                           (False, True)):
                        for codes in (False, True):
                            if codes and static_bounds(signed, narrow, bits)[1] > 127:
                                continue             # codes must fit int8
                            kw = dict(bit_width=bits, signed=signed, narrow=narrow,
                                      rounding_mode=mode, emit_codes=codes)
                            got = ops.quant_dequant(x, s, z, **kw)
                            want = ops.quant_dequant_plain(x, s, z, **kw)
                            if not torch.equal(got, want):
                                raise AssertionError(f"quant_dequant differs: {shape} {kw}")
                            n_cases += 1
    torch.cuda.synchronize()
    err["quant_dequant"] = 0.0
    return n_cases


def check_grouped_matmul(ops, torch, np, dev, err):
    """B5 against its twin; returns the number of cases."""
    rng = np.random.RandomState(6)
    g8, m8 = GCONV["groups"], GCONV["n"] * GCONV["img"] ** 2
    kg8, ng8 = GCONV["c"] // g8 * 9, GCONV["c"] // g8
    shapes = [(g8, m8, kg8, ng8), (2, 13, 10, 5), (3, 65, 18, 33), (4, 100, 36, 17),
              (1, 33, 130, 70), (64, 40, 2, 1)]
    n_cases = 0
    for g, m, kg, ng in shapes:
        for int4 in (False, True):
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (g, kg, ng)).astype(np.int8))
            wk = (ops.pack_int4_grouped(w) if int4 else w).to(dev)
            for per_ch in (False, True):
                for with_bias in (False, True):
                    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, g * ng if per_ch else 1))
                                         .astype(np.float32)).reshape(-1 if per_ch else ())
                    b = torch.from_numpy((rng.randint(-64, 64, g * ng) / 16.0)
                                         .astype(np.float32)) if with_bias else None
                    s, b = s.to(dev), None if b is None else b.to(dev)
                    x = torch.from_numpy((rng.randint(-128, 129, (g, m, kg)) / 128.0)
                                         .astype(np.float32)).to(dev)
                    got = ops.quant_grouped_matmul(x, wk, s, b, packed=int4)
                    want = ops.quant_grouped_matmul_plain(x, wk, s, b, packed=int4)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"B5 {g}x{m}x{kg}x{ng} int4={int4} differs "
                                             "on dyadic x")
                    xr = torch.randn(g, m, kg, generator=torch.Generator().manual_seed(
                        g * m + kg)).to(dev)
                    got = ops.quant_grouped_matmul(xr, wk, s, b, packed=int4)
                    want = ops.quant_grouped_matmul_plain(xr, wk, s, b, packed=int4)
                    mag = torch.matmul(xr.abs(), w.to(dev).float().abs()) * s.abs().reshape(
                        (g, 1, ng) if per_ch else ())
                    bound = 2 * kg * 2.0 ** -24 * mag + 2.0 ** -23 * want.abs()
                    diff = (got - want).abs()
                    if bool((diff > bound).any()):
                        raise AssertionError(f"B5 {g}x{m}x{kg}x{ng} beyond the order bound")
                    err["quant_grouped_matmul"] = max(err["quant_grouped_matmul"],
                                                      float(diff.max()))
                    n_cases += 2
    # through the conv wrapper: a strided view of the im2col matrix in,
    # the (M, O) matrix out
    x = torch.from_numpy((rng.randint(-64, 65, (2, 24, 13, 11)) / 64.0)
                         .astype(np.float32)).to(dev)
    wg = torch.from_numpy(rng.randint(-7, 8, (6, 4 * 9, 5)).astype(np.int8)).to(dev)
    for int4 in (False, True):
        wk = ops.pack_int4_grouped(wg) if int4 else wg
        kw = dict(groups=6, kernel_shape=(3, 3), strides=(2, 1), pads=(1, 0, 2, 1),
                  dilations=(1, 2), packed=int4)
        got = ops.quant_grouped_conv2d(x, wk, 0.125, **kw)
        xg = ops.extract_patches(x, (3, 3), (2, 1), (1, 0, 2, 1), (1, 2))[0]
        want = ops.quant_grouped_matmul_plain(
            xg.view(xg.shape[0], 6, 36).permute(1, 0, 2), wk, 0.125, packed=int4)
        want = want.permute(1, 0, 2).reshape(2, got.shape[2], got.shape[3], 30) \
            .permute(0, 3, 1, 2)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B5 through quant_grouped_conv2d differs (int4={int4})")
        n_cases += 1
    return n_cases


def _mobilenet_layers(img=224):
    """(kind, cin, cout, stride, input H) of each MobileNet-V1 conv."""
    from repro_torch.models import zoo
    out, h = [], img
    for kind, cin, cout, stride in zoo.MOBILENET_V1:
        out.append((kind, cin, cout, stride, h))
        h = (h - 1) // stride + 1
    return out


def check_depthwise(ops, torch, np, dev, err):
    """B6 against its twin, bit-exact on randn inputs; returns the number of
    cases."""
    rng = np.random.RandomState(7)
    geos = [dict(strides=(1, 1), pads=(1, 1, 1, 1), dilations=(1, 1)),
            dict(strides=(2, 2), pads=(1, 1, 1, 1), dilations=(1, 1)),
            dict(strides=(2, 1), pads=(2, 0, 1, 1), dilations=(1, 1)),
            dict(strides=(1, 1), pads=(2, 2, 2, 2), dilations=(2, 2))]
    epis = [dict(relu=False, act_bits=None), dict(relu=True, act_bits=None)]
    epis += [dict(relu=True, act_bits=bits, act_signed=signed, act_rounding=mode)
             for bits, signed in ((2, False), (4, False), (8, True)) for mode in MODES]
    n_cases = 0

    def case(x, c, geo, epi, per_ch, with_bias, zp):
        taps = torch.from_numpy(rng.randint(-7, 8, (9, c)).astype(np.int8)).to(dev)
        s = torch.from_numpy((rng.rand(c if per_ch else 1) * 0.1 + 0.01)
                             .astype(np.float32)).to(dev).reshape(-1 if per_ch else ())
        b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev) if with_bias else None
        qs, qz = torch.tensor(0.173, device=dev), torch.tensor(zp, device=dev)
        kw = dict(kernel_shape=(3, 3), **geo, **epi)
        got = ops.quant_depthwise_conv2d(x, taps, s, b, qs, qz, **kw)
        want = ops.quant_depthwise_conv2d_plain(x, taps, s, b, qs, qz, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B6 {tuple(x.shape)} {kw} per_ch={per_ch} "
                                 f"bias={with_bias} differs")

    for c in (32, 37, 130):
        x = (torch.randn(2, c, 15, 14, generator=torch.Generator().manual_seed(c)) * 2).to(dev)
        for geo in geos:
            for i, epi in enumerate(epis):
                case(x, c, geo, epi, per_ch=bool(i % 2), with_bias=bool(i % 3),
                     zp=float(i % 2))
                n_cases += 1
    # every MobileNet-224 depthwise layer at 8 rows, with its own epilogue
    for kind, cin, _, stride, h in _mobilenet_layers():
        if kind != "dw":
            continue
        x = torch.randn(SLOT, cin, h, h, generator=torch.Generator().manual_seed(h)).to(dev)
        case(x, cin, dict(strides=(stride, stride), pads=(1, 1, 1, 1), dilations=(1, 1)),
             dict(relu=True, act_bits=4, act_signed=False), per_ch=False, with_bias=False,
             zp=0.0)
        n_cases += 1
    err["quant_depthwise_conv2d"] = 0.0
    return n_cases


# ------------------------------------------------ phase 2, B7 flash attention

FA_TOL = 2e-5    # float32: the bound of the reference's tests/test_flash_attention.py
# (H, KV, hd): qwen2-1.5B's GQA (G = 6) and olmo-1B's G = 1
FA_SHAPES = {"qwen2": (12, 2, 128), "olmo": (16, 16, 128)}


def _bf16_steps(torch, a, b):
    """Distance in bf16 steps between two bf16 tensors."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def check_flash_attention(ops, torch, dev, err):
    """B7 against its twin at qwen2's and olmo's head shapes, S in {1, 17,
    512, 2048, 2047}, B in {1, 4}, causal and not, float32 and bf16, q, k
    and v as the model passes them (transposed views of (B, S, H, hd)).
    float32: within FA_TOL (abs + rel).  bf16: within one bf16 step of the
    twin, or within FA_TOL where both round a near-zero float32 value (the
    two sum in other orders before their one rounding to bf16).  Returns
    the number of cases."""
    g = torch.Generator(device=dev).manual_seed(7)
    n_cases, worst_steps = 0, 0
    for label, (H, KV, hd) in FA_SHAPES.items():
        for S in (1, 17, 512, 2048, 2047):
            for B in (1, 4):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev)
                               .to(dtype).transpose(1, 2) for h in (H, KV, KV))
                    for causal in (True, False):
                        got = ops.flash_attention(q, k, v, causal=causal)
                        want = ops.flash_attention_plain(q, k, v, causal=causal)
                        torch.cuda.synchronize()
                        diff = (got.float() - want.float()).abs()
                        if dtype == torch.float32:
                            ok = diff <= FA_TOL + FA_TOL * want.abs()
                        else:
                            steps = _bf16_steps(torch, got, want)
                            ok = (steps <= 1) | (diff <= FA_TOL)
                            worst_steps = max(worst_steps, int(steps[diff > FA_TOL].max())
                                              if bool((diff > FA_TOL).any()) else 0)
                        if not bool(ok.all()):
                            raise AssertionError(
                                f"flash_attention {label} B={B} S={S} {dtype} causal={causal}: "
                                f"{int((~ok).sum())} entries beyond the bound, max diff "
                                f"{float(diff.max())}")
                        err["flash_attention"] = max(err["flash_attention"], float(diff.max()))
                        n_cases += 1
    print(f"flash_attention vs twin: {n_cases} cases, max abs diff "
          f"{err['flash_attention']:.3e} (bf16 entries beyond {FA_TOL}: at most "
          f"{worst_steps} bf16 step apart)", flush=True)
    return n_cases


# ------------------------------------------------ phase 2, integer bodies

IN_SCALE = 3 * 2.0 ** -5       # a dyadic activation scale that is no power of two
# B2's int8 body: the zoo's kind of activation scale (a power of two, staged
# by the exact reciprocal) and IN_SCALE (no power of two: the exact-quotient
# check, else the IEEE division)
TC_IN_SCALES = (2.0 ** -3, IN_SCALE)
STAGING_NAMES = ("reciprocal", "quotient", "division")   # ops.staging's modes


def int_specs():
    """The epilogues the integer cases run: None (the int32 body with the
    float32 epilogue), B3 without an act Quant (ReLU off and on), and B3
    with one in every rounding mode at act_shift -3, 0 and 5, the ReLU,
    the zero point and signed / unsigned / narrow / int8 bounds varying."""
    from repro_torch.kernels.requant import IntRequant
    bounds = [(-16, 15, (-2, 0, 1)), (-7, 7, (0, 1, -3)), (0, 15, (0, 3, 1)),
              (0, 14, (1, 0, 2)), (-128, 127, (5, -1, 0))]
    specs = [None, IntRequant(shift=9), IntRequant(shift=9, relu=True)]
    for i, (mode, s) in enumerate((m, s) for m in MODES for s in (-3, 0, 5)):
        lo, hi, zps = bounds[i % len(bounds)]
        specs.append(IntRequant(shift=s + 4, relu=bool(i % 2), has_act=True, act_shift=s,
                                act_zp=zps[i % 3], act_lo=lo, act_hi=hi, act_out_shift=4,
                                rounding_mode=mode))
    return specs


def _body(torch, spec, n, per_ch, rng, np, dev):
    """(scale or multipliers, keyword arguments) of one integer case."""
    if spec is None:
        s = (2.0 ** -rng.randint(2, 6, n if per_ch else 1)).astype(np.float32)
        return torch.from_numpy(s).to(dev), dict(acc_dtype=torch.int32)
    mult = (2 * rng.randint(0, 5, n if per_ch else 1) + 1).astype(np.int32)
    return torch.from_numpy(mult).to(dev), dict(acc_dtype=torch.int32, requant=spec,
                                                in_scale=IN_SCALE)


def _int_x(torch, np, rng, shape, dev, spec, qmax=8):
    """Integer-valued activations: q * IN_SCALE on the B3 body (the kernel
    divides it back), q itself on the float32-epilogue body."""
    q = rng.randint(-qmax, qmax + 1, shape).astype(np.float32)
    return torch.from_numpy(q * np.float32(IN_SCALE) if spec is not None else q).to(dev)


def check_integer(ops, torch, np, dev, err):
    """B1 / B2 / B5 / B6 on their integer bodies against their twins, all
    with torch.equal (integer sums are exact in any order); returns the
    number of cases per kernel."""
    rng = np.random.RandomState(21)
    specs = int_specs()
    n_cases = {k: 0 for k in INT_KERNELS}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} integer body differs: {what}")
        n_cases[name] += 1

    # B1 / B2: ragged, TFC and MobileNet-pointwise shapes; every spec
    for m, k, n in ((37, 130, 70), (256, 784, 64), (64, 64, 10), (1568, 256, 256)):
        for int4 in (False, True):
            name = "quant_matmul_int4" if int4 else "quant_matmul"
            fn, plain = ((ops.quant_matmul_int4, ops.quant_matmul_int4_plain) if int4
                         else (ops.quant_matmul, ops.quant_matmul_plain))
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (k, n)).astype(np.int8))
            wk = (ops.pack_int4(w) if int4 else w).to(dev)
            for i, spec in enumerate(specs):
                s, kw = _body(torch, spec, n, bool(i % 2), rng, np, dev)
                x = _int_x(torch, np, rng, (m, k), dev, spec)
                bias = torch.randn(n, generator=torch.Generator().manual_seed(i)).to(dev) \
                    if i % 5 == 0 else None
                same(name, fn(x, wk, s, bias, **kw), plain(x, wk, s, bias, **kw),
                     f"{m}x{k}x{n} {spec}")
    # accumulators at the obligation-3 limit: one row of x and one column of
    # w at their largest, summed over K, just below 2**24
    k = 1040
    for int4 in (False, True):
        name = "quant_matmul_int4" if int4 else "quant_matmul"
        fn, plain = ((ops.quant_matmul_int4, ops.quant_matmul_int4_plain) if int4
                     else (ops.quant_matmul, ops.quant_matmul_plain))
        wmax = 7 if int4 else 127
        qmax = (2 ** 24 - 1) // (k * wmax)
        w = torch.from_numpy(rng.randint(-wmax, wmax + 1, (k, 5)).astype(np.int8))
        w[:, 0] = wmax
        wk = (ops.pack_int4(w) if int4 else w).to(dev)
        q = rng.randint(-qmax, qmax + 1, (3, k)).astype(np.float32)
        q[0] = qmax
        q[1] = -qmax
        for spec in specs[:3]:
            x = torch.from_numpy(q * np.float32(IN_SCALE) if spec is not None else q).to(dev)
            s, kw = _body(torch, spec, 5, False, np.random.RandomState(0), np, dev)
            s = torch.ones_like(s)              # mult 1: acc * mult stays below 2**24
            got = fn(x, wk, s, **kw)
            same(name, got, plain(x, wk, s, **kw), f"edge {spec}")

    # B2's int8 tensor-core body (int8_codes: the lowering's proof that the
    # staged codes fit int8), equal to the twin and to the IMAD body, its
    # launches counted per body: codes over all of int8, ragged M, N and K
    # and MobileNet-224 pointwise shapes at 8 rows, both scale kinds (a
    # power of two: the reciprocal multiply; IN_SCALE: the exact-quotient
    # staging), x off the scale's grid (random values and exact halves,
    # where the staging divides), and sums at the limit
    before = ops.b2_body_counts()
    n_tc = 0

    def tc_case(x, wk, s, bias, kw, what):
        nonlocal n_tc
        got = ops.quant_matmul_int4(x, wk, s, bias, int8_codes=True, **kw)
        same("quant_matmul_int4", got,
             ops.quant_matmul_int4_plain(x, wk, s, bias, int8_codes=True, **kw), what)
        same("quant_matmul_int4", ops.quant_matmul_int4(x, wk, s, bias, **kw), got,
             what + " (IMAD body)")
        n_tc += 1
        return got

    for m, k, n, sp in ((1, 32, 10, specs), (17, 784, 64, specs), (37, 98, 70, specs),
                        (392, 1024, 1024, specs[:6]), (1568, 256, 512, specs[:4]),
                        (25088, 64, 128, specs[:4])):
        wk = ops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (k, n)).astype(np.int8))).to(dev)
        for i, spec in enumerate(sp):
            for in_scale in TC_IN_SCALES:
                s, kw = _body(torch, spec, n, bool(i % 2), rng, np, dev)
                kw["in_scale"] = in_scale
                q = rng.randint(-127, 128, (m, k)).astype(np.float32)
                bias = torch.randn(n, generator=torch.Generator().manual_seed(i)).to(dev) \
                    if i % 3 == 0 else None
                tc_case(torch.from_numpy(q * np.float32(in_scale)).to(dev), wk, s, bias, kw,
                        f"int8 body {m}x{k}x{n} in_scale={in_scale} {spec}")
    for i, spec in enumerate(specs[:6]):
        wk = ops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (130, 40)).astype(np.int8))).to(dev)
        q = rng.uniform(-120, 120, (70, 130))
        q[::3] = np.round(q[::3]) + 0.5
        for in_scale in TC_IN_SCALES:
            s, kw = _body(torch, spec, 40, bool(i % 2), rng, np, dev)
            kw["in_scale"] = in_scale
            tc_case(torch.from_numpy((q * in_scale).astype(np.float32)).to(dev), wk, s, None, kw,
                    f"int8 body, x off the grid, in_scale={in_scale} {spec}")
    # the limit of int8 codes: -127 / 127 against -8 over K = 16510 (ragged
    # in 32), sums of +-16,774,160, just below 2**24
    k = 16510
    w = torch.from_numpy(rng.randint(-8, 8, (k, 5)).astype(np.int8))
    w[:, 0] = -8
    wk = ops.pack_int4(w).to(dev)
    q = rng.randint(-127, 128, (3, k)).astype(np.float32)
    q[0], q[1] = -127, 127
    for spec in specs[:3]:
        for in_scale in TC_IN_SCALES:
            s, kw = _body(torch, spec, 5, False, np.random.RandomState(0), np, dev)
            kw["in_scale"] = in_scale
            what = f"int8 body at the limit, in_scale={in_scale} {spec}"
            got = tc_case(torch.from_numpy(q * np.float32(in_scale)).to(dev), wk,
                          torch.ones_like(s), None, kw, what)
            if spec is None and float(got.abs().max()) != 16774160.0:
                raise AssertionError(f"{what}: the sums did not reach the limit")
    after = ops.b2_body_counts()
    if after["int8_mma"] - before["int8_mma"] != n_tc or \
            after["imad"] - before["imad"] != n_tc:
        raise AssertionError(f"B2 body launches {before} -> {after} for {n_tc} int8 cases")
    n_cases["quant_matmul_int4 (int8 body)"] = n_tc

    # B5: the grouped conv's shape and ragged ones, int8 and int4
    g8, m8 = GCONV["groups"], GCONV["n"] * GCONV["img"] ** 2
    shapes = [((g8, m8, GCONV["c"] // g8 * 9, GCONV["c"] // g8), specs[:6]),
              ((3, 65, 18, 33), specs), ((2, 13, 10, 5), specs), ((1, 33, 130, 70), specs[:8])]
    for (g, m, kg, ng), sp in shapes:
        for int4 in (False, True):
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (g, kg, ng)).astype(np.int8))
            wk = (ops.pack_int4_grouped(w) if int4 else w).to(dev)
            for i, spec in enumerate(sp):
                s, kw = _body(torch, spec, g * ng, bool(i % 2), rng, np, dev)
                x = _int_x(torch, np, rng, (g, m, kg), dev, spec)
                same("quant_grouped_matmul",
                     ops.quant_grouped_matmul(x, wk, s, packed=int4, **kw),
                     ops.quant_grouped_matmul_plain(x, wk, s, packed=int4, **kw),
                     f"{g}x{m}x{kg}x{ng} int4={int4} {spec}")

    # B6: ragged geometries with every spec, then every MobileNet-224
    # depthwise layer at 8 rows; spec None runs the fused float32 epilogue
    geos = [dict(strides=(1, 1), pads=(1, 1, 1, 1), dilations=(1, 1)),
            dict(strides=(2, 1), pads=(2, 0, 1, 1), dilations=(1, 1)),
            dict(strides=(1, 1), pads=(2, 2, 2, 2), dilations=(2, 2))]
    fp32_epi = dict(relu=True, act_bits=4, act_signed=False, act_rounding="HALF_UP")

    def dw_case(x_shape, geo, spec, per_ch, qmax=8, taps=None):
        c = x_shape[1]
        taps = taps if taps is not None else \
            torch.from_numpy(rng.randint(-7, 8, (9, c)).astype(np.int8)).to(dev)
        s, kw = _body(torch, spec, c, per_ch, rng, np, dev)
        x = _int_x(torch, np, rng, x_shape, dev, spec, qmax)
        args = (x, taps, s)
        if spec is None:
            args += (None, torch.tensor(0.25, device=dev), torch.tensor(1.0, device=dev))
            kw.update(fp32_epi)
        kw.update(kernel_shape=(3, 3), **geo)
        same("quant_depthwise_conv2d", ops.quant_depthwise_conv2d(*args, **kw),
             ops.quant_depthwise_conv2d_plain(*args, **kw), f"{x_shape} {geo} {spec}")

    for c in (32, 37):
        for geo in geos:
            for i, spec in enumerate(specs):
                dw_case((2, c, 15, 14), geo, spec, bool(i % 2))
    for j, (kind, cin, _, stride, h) in enumerate(_mobilenet_layers()):
        if kind == "dw":
            dw_case((SLOT, cin, h, h), dict(strides=(stride, stride), pads=(1, 1, 1, 1),
                                            dilations=(1, 1)), specs[3 + j % 24], True)
    # accumulators at the limit: 9 taps of the largest weight and input
    qmax = (2 ** 24 - 1) // (9 * 127)
    taps = torch.full((9, 4), 127, dtype=torch.int8, device=dev)
    for spec in specs[:3]:
        dw_case((1, 4, 6, 6), geos[0], spec, False, qmax=qmax, taps=taps)
    for k in INT_KERNELS:
        err[k + "/int32"] = 0.0
    return n_cases


# ----------------------------------- phase 2, the B5 / B6 redesign's cases

# B6 geometries beyond check_depthwise's, (N, C, H, W, kernel, strides,
# dilations, pads): the tile and plane-group boundaries (planes of 1x1,
# 7x7, 13x13; C off the planes per block; N = 1), odd H at stride 2,
# dilation 2, asymmetric pads, 5x5 and 1x3 kernels, tiles whose rows are
# not on 16 bytes
DW_GEOMETRIES = [
    (2, 5, 1, 1, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),
    (3, 37, 7, 7, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),
    (1, 19, 13, 13, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),
    (2, 6, 15, 14, (3, 3), (2, 2), (1, 1), (1, 1, 1, 1)),
    (2, 5, 33, 31, (3, 3), (2, 1), (1, 1), (2, 0, 1, 1)),
    (2, 4, 20, 24, (3, 3), (1, 1), (2, 2), (2, 2, 2, 2)),
    (1, 3, 40, 44, (5, 5), (1, 1), (1, 1), (2, 2, 2, 2)),
    (2, 7, 17, 9, (1, 3), (1, 1), (1, 1), (0, 1, 0, 1)),
    (1, 2, 70, 66, (3, 3), (1, 2), (1, 1), (1, 1, 1, 1)),
    (1, 3, 57, 100, (3, 3), (2, 2), (1, 1), (1, 1, 1, 1)),
]
# B5 shapes (G, M, Kg, Ng): Ng 1, 8, 12, 16, 40; Kg off 4 (the element
# path); Kg above the 128-wide staged slice (the K loop)
GQ_SHAPES = [(3, 70, 36, 1), (4, 100, 72, 8), (2, 65, 18, 12), (3, 129, 40, 16),
             (2, 33, 36, 40), (3, 50, 27, 12), (2, 90, 300, 8), (1, 257, 258, 40)]
# the integer bodies' stagings: a power of two (the reciprocal), IN_SCALE
# (the exact-quotient check) and, with x off IN_SCALE's grid, its division
# fallback; TINY_SCALE's reciprocal overflows float32, so every x is
# divided (its twin runs on the CPU, whose division keeps the subnormals)
STAGINGS = ((2.0 ** -3, False), (IN_SCALE, False), (IN_SCALE, True))
TINY_SCALE = 3 * 2.0 ** -140


def _staged_x(torch, np, rng, shape, dev, in_scale, off_grid, qmax=8):
    """q · in_scale, every seventh element moved off the grid if asked."""
    x = rng.randint(-qmax, qmax + 1, shape).astype(np.float32) * np.float32(in_scale)
    if off_grid:
        x.reshape(-1)[::7] += np.float32(in_scale / 3)
    return torch.from_numpy(x).to(dev)


def check_redesign(ops, torch, np, dev, err):
    """B6 and B5 at the redesign's boundaries (DW_GEOMETRIES, every
    MobileNet-224 depthwise layer at 8 rows, GQ_SHAPES), each body against
    its twin: B6 torch.equal throughout (float32 on randn in every rounding
    mode, the integer bodies in every staging); B5's integer bodies
    torch.equal, its float32 body exact on dyadic x and within the order
    bound on randn; the staging counts follow the scales.  Returns the
    number of cases per kernel."""
    rng = np.random.RandomState(31)
    specs = int_specs()
    n_cases = {"quant_depthwise_conv2d": 0, "quant_grouped_matmul": 0}
    before = ops.staging_counts()
    expect = {k: dict.fromkeys(("reciprocal", "quotient", "division"), 0) for k in n_cases}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its twin: {what}")
        n_cases[name] += 1

    def dw_float(x, taps, geo_kw, mode, i):
        c = x.shape[1]
        s = torch.from_numpy((rng.rand(c) * 0.1 + 0.01).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev) if i % 2 else None
        qs = torch.tensor(0.125 if i % 3 else 0.173, device=dev)     # power of two or not
        qz = torch.tensor(float(i % 2), device=dev)
        kw = dict(geo_kw, relu=True, act_bits=4, act_signed=False, act_rounding=mode)
        same("quant_depthwise_conv2d", ops.quant_depthwise_conv2d(x, taps, s, b, qs, qz, **kw),
             ops.quant_depthwise_conv2d_plain(x, taps, s, b, qs, qz, **kw),
             f"float32 {tuple(x.shape)} {kw}")

    def twin(plain, args, kw, cpu):
        if not cpu:
            return plain(*args, **kw)
        return plain(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw).to(dev)

    def dw_int(shape, taps, geo_kw, spec, in_scale, off_grid):
        x = _staged_x(torch, np, rng, shape, dev, in_scale, off_grid)
        c = shape[1]
        if spec is None:
            s = torch.from_numpy((2.0 ** -rng.randint(2, 6, c)).astype(np.float32)).to(dev)
            kw = dict(acc_dtype=torch.int32, in_scale=in_scale)
        else:
            s = torch.from_numpy((2 * rng.randint(0, 5, c) + 1).astype(np.int32)).to(dev)
            kw = dict(acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
        kw.update(geo_kw)
        same("quant_depthwise_conv2d", ops.quant_depthwise_conv2d(x, taps, s, **kw),
             twin(ops.quant_depthwise_conv2d_plain, (x, taps, s), kw, in_scale == TINY_SCALE),
             f"integer {shape} {geo_kw} in_scale={in_scale} off_grid={off_grid} {spec}")
        expect["quant_depthwise_conv2d"][STAGING_NAMES[ops.staging(in_scale)[0]]] += 1

    layers = [(SLOT, cin, h, h, (3, 3), (st, st), (1, 1), (1, 1, 1, 1))
              for kind, cin, _, st, h in _mobilenet_layers() if kind == "dw"]
    for j, (n, c, h, w, ks, st, dil, pads) in enumerate(DW_GEOMETRIES + layers):
        geo_kw = dict(kernel_shape=ks, strides=st, dilations=dil, pads=pads)
        taps = torch.from_numpy(rng.randint(-7, 8, (ks[0] * ks[1], c)).astype(np.int8)).to(dev)
        x = torch.randn(n, c, h, w, generator=torch.Generator().manual_seed(j)).to(dev)
        for i, mode in enumerate(MODES if j >= len(DW_GEOMETRIES) or j % 3 == 0 else MODES[::3]):
            dw_float(x, taps, geo_kw, mode, i + j)
        for k, (in_scale, off_grid) in enumerate(STAGINGS):
            dw_int((n, c, h, w), taps, geo_kw, specs[3 + (3 * j + k) % 24], in_scale, off_grid)
        dw_int((n, c, h, w), taps, geo_kw, None, STAGINGS[j % 3][0], STAGINGS[j % 3][1])
        if j < len(DW_GEOMETRIES):
            dw_int((n, c, h, w), taps, geo_kw, specs[j % 3], TINY_SCALE, False)

    for g, m, kg, ng in GQ_SHAPES:
        for int4 in (False, True) if kg % 2 == 0 else (False,):
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (g, kg, ng)).astype(np.int8))
            wk = (ops.pack_int4_grouped(w) if int4 else w).to(dev)
            s = torch.from_numpy((2.0 ** -rng.randint(2, 6, g * ng)).astype(np.float32)).to(dev)
            b = torch.from_numpy((rng.randint(-64, 64, g * ng) / 16.0).astype(np.float32)).to(dev)
            x = torch.from_numpy((rng.randint(-128, 129, (g, m, kg)) / 128.0)
                                 .astype(np.float32)).to(dev)
            what = f"B5 {g}x{m}x{kg}x{ng} int4={int4}"
            same("quant_grouped_matmul", ops.quant_grouped_matmul(x, wk, s, b, packed=int4),
                 ops.quant_grouped_matmul_plain(x, wk, s, b, packed=int4), what + " dyadic")
            xr = torch.randn(g, m, kg, generator=torch.Generator().manual_seed(m + kg)).to(dev)
            got = ops.quant_grouped_matmul(xr, wk, s, b, packed=int4)
            want = ops.quant_grouped_matmul_plain(xr, wk, s, b, packed=int4)
            mag = torch.matmul(xr.abs(), w.to(dev).float().abs()) * s.abs().reshape(g, 1, ng)
            diff = (got - want).abs()
            if bool((diff > 2 * kg * 2.0 ** -24 * mag + 2.0 ** -23 * want.abs()).any()):
                raise AssertionError(f"{what} beyond the order bound")
            err["quant_grouped_matmul"] = max(err["quant_grouped_matmul"], float(diff.max()))
            n_cases["quant_grouped_matmul"] += 1
            for k, (in_scale, off_grid) in enumerate(STAGINGS + ((TINY_SCALE, False),)):
                for spec in (None, specs[3 + (k + ng) % 24]):
                    xi = _staged_x(torch, np, rng, (g, m, kg), dev, in_scale, off_grid)
                    if spec is None:
                        si, kw = s, dict(acc_dtype=torch.int32, in_scale=in_scale)
                    else:
                        si = torch.from_numpy((2 * rng.randint(0, 5, g * ng) + 1)
                                              .astype(np.int32)).to(dev)
                        kw = dict(acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
                    same("quant_grouped_matmul",
                         ops.quant_grouped_matmul(xi, wk, si, packed=int4, **kw),
                         twin(ops.quant_grouped_matmul_plain, (xi, wk, si),
                              dict(kw, packed=int4), in_scale == TINY_SCALE),
                         f"{what} in_scale={in_scale} off_grid={off_grid} {spec}")
                    expect["quant_grouped_matmul"][STAGING_NAMES[ops.staging(in_scale)[0]]] += 1
    after = ops.staging_counts()
    moved = {k: {m: after[k][m] - before[k][m] for m in after[k]} for k in after}
    if moved != expect:
        raise AssertionError(f"staging launches {moved}, expected {expect}")
    print(f"redesign cases: {n_cases}; integer launches by staging {moved}", flush=True)
    return n_cases


# ------------------------------------------------------------ phases 3 + 4

_ORACLES: dict = {}


def _oracle(g, x, return_all=False, key=None):
    """The port's oracle on the CPU; with ``key`` the result is kept, so the
    integer path reuses what the float32 path computed on the same input."""
    from repro_torch.core import execute, transforms
    if key is not None and key in _ORACLES:
        return _ORACLES[key]
    out = execute(transforms.cleanup(g), {g.input_names[0]: x}, device="cpu",
                  return_all=return_all)
    if key is not None:
        _ORACLES[key] = out
    return out


def _check_plan(plan, key, int4, ops, before, needs):
    if plan.fused_counts != CENSUS[(key, int4)]:
        raise AssertionError(f"{key}: census {plan.fused_counts} != {CENSUS[(key, int4)]}")
    after = ops.launch_counts()
    for k in needs:
        if after[k] <= before[k]:
            raise AssertionError(f"{key}: kernel {k} was not launched")
    return {k: after[k] - before[k] for k in after}


def grouped_conv_graph():
    """Quant -> Conv(group 8, 64 -> 64, 3x3, pads 1, 4-bit weights) -> Relu
    -> Quant on 56x56 maps: no zoo model has a grouped conv with a channel
    multiplier, so this one puts B5 on the compiled path."""
    import numpy as np
    from repro_torch.core import GraphBuilder
    c, img, g = GCONV["c"], GCONV["img"], GCONV["groups"]
    b = GraphBuilder("GroupedConv-g8")
    x = b.add_input("x", (GCONV["n"], c, img, img))
    h = b.quant(x, 1.0 / 64, 0.0, 8)
    w = np.random.RandomState(9).randn(c, c // g, 3, 3).astype(np.float32) * 0.3
    qw = b.quant(b.add_initializer("w", w), 1.0 / 16, 0.0, 4, narrow=True)
    (h,) = b.add_node("Conv", [h, qw], 1, {"kernel_shape": [3, 3], "strides": [1, 1],
                                          "pads": [1, 1, 1, 1], "group": g})
    (h,) = b.add_node("Relu", [h], 1)
    h = b.quant(h, 1.0 / 8, 0.0, 4, signed=False)
    b.mark_output(h)
    return b.build()


def _final_matmul(graph):
    """The (activation, dequantized weight) input names of the last MatMul."""
    node = [n for n in graph.toposort() if n.op_type == "MatMul"][-1]
    return node.inputs[0], node.inputs[1]


def order_bound(xf, wf, ref):
    """Summation-order bound of a float32 product (K terms) plus one
    rounding of the result, elementwise."""
    k = xf.shape[-1]
    return 2 * k * 2.0 ** -24 * (xf.abs() @ wf.abs()) + 2.0 ** -23 * ref.abs()


def run_main_path(torch, np, dev):
    from repro_torch.core import compile_graph
    from repro_torch.core.executor import to_tensor
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.serve import CompiledGraphEngine

    needs = {"TFC-w2a2": ("quant_matmul_int4", "quant_dequant"),
             "TFC-w1a1": ("quant_matmul", "quant_dequant"),
             "CNV-w1a1": ("quant_matmul", "quant_matmul_int4", "quant_dequant"),
             "CNV-w2a2": ("quant_matmul", "quant_matmul_int4", "quant_dequant"),
             "MobileNet-w4a4": ("quant_matmul", "quant_matmul_int4", "quant_dequant",
                                "quant_depthwise_conv2d")}
    xs = {"TFC": np.random.RandomState(2).randn(64, 784).astype(np.float32),
          "CNV": np.random.RandomState(12).randn(SLOT, 3, 32, 32).astype(np.float32)}
    for key, int4 in [k for k in CENSUS if not k[0].startswith("MobileNet")]:
        g = zoo.ZOO[key]()
        x = xs[key[:3]]
        before = ops.launch_counts()
        plan = compile_graph(g, device=dev, use_int4=int4, use_analysis=False)
        out = plan({"x": x})[plan.graph.output_names[0]]
        torch.cuda.synchronize()
        ref = _oracle(g, x, key=key)[g.output_names[0]]
        if tuple(out.shape) != (x.shape[0], 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{key}: bad output {tuple(out.shape)}")
        if not torch.equal(out.cpu(), ref):
            raise AssertionError(f"{key}: compiled CUDA plan differs from the oracle "
                                 f"by {float((out.cpu() - ref).abs().max())}")
        launched = _check_plan(plan, key, int4, ops, before, needs[key])
        print(f"main path {key} use_int4={int4}: bit-exact vs oracle, "
              f"fused_counts={plan.fused_counts}, launches={launched}", flush=True)

    # MobileNet-w4a4 at img 224 as the zoo builds it: its random weights
    # let every activation after the fourth conv quantize to 0, so it is
    # held bit-exact but says little past that point; the same graph with
    # its conv gains raised (zoo.rescale_conv_gains: same integer weights,
    # dyadic scales) keeps the activations live and carries the real check
    x16 = np.random.RandomState(13).randn(2 * SLOT, 3, 224, 224).astype(np.float32)
    g = zoo.build_mobilenet(4, 4, img=224)
    before = ops.launch_counts()
    plan = compile_graph(g, device=dev, use_analysis=False)
    out = plan({"x": x16[:SLOT]})[g.output_names[0]]
    torch.cuda.synchronize()
    if not torch.equal(out.cpu(), _oracle(g, x16[:SLOT], key="MobileNet-w4a4")[
            g.output_names[0]]):
        raise AssertionError("MobileNet-224 (zoo): compiled CUDA plan differs from the oracle")
    launched = _check_plan(plan, "MobileNet-w4a4", True, ops, before,
                           needs["MobileNet-w4a4"])
    if plan.grouped_conv_stats() != MOBILENET_224_STATS:
        raise AssertionError(f"MobileNet-224 stats {plan.grouped_conv_stats()}")
    print(f"main path MobileNet-w4a4 img 224 (zoo weights), {SLOT} rows: bit-exact vs the "
          f"CPU oracle; fused_counts={plan.fused_counts}, "
          f"grouped_conv_stats={plan.grouped_conv_stats()}, launches={launched}", flush=True)

    t0 = time.perf_counter()
    live = zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224))
    oracle = _oracle(live, x16, return_all=True, key="MobileNet-w4a4 rescaled")
    ref = oracle[live.output_names[0]]
    t_oracle = time.perf_counter() - t0
    before = ops.launch_counts()
    lplan = compile_graph(live, device=dev, use_analysis=False)
    pre, w_name = _final_matmul(lplan.graph)
    rows = []
    for i in (0, SLOT):
        env = {"x": to_tensor(x16[i:i + SLOT], dev)}
        for seg in lplan.segments:          # the plan's own loop, keeping env
            seg.run(lplan.consts, env)
        torch.cuda.synchronize()
        if not torch.equal(env[pre].cpu(), oracle[pre][i:i + SLOT]):
            raise AssertionError("MobileNet-224: the plan differs from the oracle "
                                 f"before the final MatMul ({pre})")
        rows.append(env[lplan.graph.output_names[0]].cpu())
    out = torch.cat(rows)
    if tuple(out.shape) != (2 * SLOT, 1000) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"MobileNet-224: bad output {tuple(out.shape)}")
    live_share = float((oracle[pre] != 0).float().mean())
    if live_share < 0.5:
        raise AssertionError(f"MobileNet-224 (rescaled): pooled features {live_share:.3f} "
                             "nonzero; the check would be vacuous")
    bound = order_bound(oracle[pre], oracle[w_name], ref)
    diff = (out - ref).abs()
    if bool((diff > bound).any()):
        raise AssertionError("MobileNet-224: final MatMul beyond the order bound "
                             f"({float(diff.max())})")
    launched = _check_plan(lplan, "MobileNet-w4a4", True, ops, before,
                           needs["MobileNet-w4a4"])
    print(f"main path MobileNet-w4a4 img 224 (conv gains rescaled), 2 x {SLOT} rows: "
          f"bit-exact vs the CPU oracle through the global average pool ({pre}, "
          f"{live_share:.3f} of it nonzero); final MatMul within the order bound, max diff "
          f"{float(diff.max())}, {int((diff == 0).sum())} of {diff.numel()} outputs "
          f"bit-exact; launches={launched}; CPU oracle {t_oracle:.1f} s", flush=True)

    # the grouped conv: B5 (int4) + B4, bit-exact
    gg = grouped_conv_graph()
    xg = np.random.RandomState(14).randn(*gg.inputs[0].shape).astype(np.float32)
    before = ops.launch_counts()
    gplan = compile_graph(gg, device=dev, use_analysis=False)
    gout = gplan({"x": xg})[gg.output_names[0]]
    torch.cuda.synchronize()
    want = {"quant_dequant": 1, "quant_conv_grouped_int4": 1}
    if gplan.fused_counts != want:
        raise AssertionError(f"grouped conv census {gplan.fused_counts} != {want}")
    if not torch.equal(gout.cpu(), _oracle(gg, xg, key="GroupedConv-g8")[
            gg.output_names[0]]):
        raise AssertionError("grouped conv: compiled CUDA plan differs from the oracle")
    after = ops.launch_counts()
    if after["quant_grouped_matmul"] <= before["quant_grouped_matmul"]:
        raise AssertionError("grouped conv: B5 was not launched")
    print(f"main path {gg.name} {tuple(xg.shape)}: bit-exact vs oracle, fused_counts="
          f"{gplan.fused_counts}, grouped_conv_stats={gplan.grouped_conv_stats()}",
          flush=True)

    # phase 4: serving TFC in 16-row slots, held against the oracle on the CPU
    tfc = zoo.build_tfc(2, 2)
    eng = CompiledGraphEngine(tfc, max_batch=16, device=dev, use_analysis=False,
                              report_cost=False)
    xt = np.random.RandomState(3).randn(64, 784).astype(np.float32)
    reqs = [eng.submit(r) for r in xt]
    if eng.run_pending() != 64:
        raise AssertionError("run_pending did not run 64 requests")
    got = np.stack([r.wait() for r in reqs])
    if not np.array_equal(got, _oracle(tfc, xt, key="serve TFC")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("served rows differ from the oracle")
    x40 = xt[:40] * 0.5
    if not np.array_equal(eng(x40), _oracle(tfc, x40, key="serve TFC 40")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("engine(x) differs from the oracle")
    if eng.n_completed != 64:
        raise AssertionError(f"engine completed {eng.n_completed}, not 64")
    print(f"serving TFC-w2a2: 64 requests via run_pending + one 40-row call, all rows "
          f"bit-exact vs the CPU oracle; completed={eng.n_completed}", flush=True)

    # serving MobileNet-224 (rescaled) in 8-row slots: rows equal the
    # plan's, which phase 3 held against the oracle
    meng = CompiledGraphEngine(live, max_batch=SLOT, device=dev, use_analysis=False,
                               report_cost=False)
    if meng.conv_segments_fused != 27 or meng.grouped_conv_stats != MOBILENET_224_STATS:
        raise AssertionError("MobileNet engine: conv telemetry differs")
    reqs = [meng.submit(r) for r in x16]
    if meng.run_pending() != 2 * SLOT:
        raise AssertionError(f"run_pending did not run {2 * SLOT} requests")
    served = torch.from_numpy(np.stack([r.wait() for r in reqs]))
    ragged = torch.from_numpy(meng(x16[3:8]))
    if not torch.equal(served, out) or not torch.equal(ragged, out[3:8]):
        raise AssertionError("served MobileNet rows differ from the compiled plan's")
    if bool(((served - ref).abs() > bound).any()):
        raise AssertionError("served MobileNet rows beyond the oracle's order bound")
    print(f"serving MobileNet-w4a4 img 224 (rescaled): {2 * SLOT} requests via run_pending in "
          f"{SLOT}-row slots + one ragged 5-row call, every row bit-exact vs the "
          f"compiled plan and within the CPU oracle's order bound; "
          f"completed={meng.n_completed}", flush=True)
    return (eng, xt), (meng, np.concatenate([x16] * 4)), (lplan, x16[:SLOT])


def _check_int_plan(plan, key, ops, before, needs):
    """The integer plan's census, requant stats and kernel launches."""
    if plan.fused_counts != CENSUS_ANALYSIS[key]:
        raise AssertionError(f"{key} (int): census {plan.fused_counts} != "
                             f"{CENSUS_ANALYSIS[key]}")
    if plan.requant_stats() != REQUANT_STATS[key]:
        raise AssertionError(f"{key} (int): requant stats {plan.requant_stats()}")
    after = ops.launch_counts()
    for k in needs:
        if after[k] <= before[k]:
            raise AssertionError(f"{key} (int): kernel {k} was not launched")
    return {k: after[k] - before[k] for k in after}


MOBILENET_INT8_BODIES = 13     # B2 int8 tensor-core launches per MobileNet-224 forward


def check_b2_bodies(ops, plan, before, forwards, label, exact=None):
    """B2's launches per body since ``before`` (``ops.b2_body_counts()``):
    each forward launches the int8 tensor-core body once per segment whose
    meta chose it (``exact`` of them, where given); returns the counts."""
    after = ops.b2_body_counts()
    got = {k: after[k] - before[k] for k in after}
    per_fwd = sum(s.meta.get("b2_body") == "int8_mma" for s in plan.segments)
    if exact is not None and per_fwd != exact:
        raise AssertionError(f"{label}: {per_fwd} segments chose B2's int8 body, not {exact}")
    if got["int8_mma"] != forwards * per_fwd:
        raise AssertionError(f"{label}: {got['int8_mma']} int8-body B2 launches in "
                             f"{forwards} forwards, not {forwards} x {per_fwd}")
    return got


def run_integer_path(torch, np, dev):
    """Phases 3 + 4 on the integer path: compile_graph's defaults (the
    analysis tier and B3), every model bit-exact against the CPU oracle
    (MobileNet's float32 final MatMul within the order bound)."""
    from repro_torch.core import compile_graph
    from repro_torch.core.executor import to_tensor
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.serve import CompiledGraphEngine

    needs = {"TFC": ("quant_matmul_int4", "quant_dequant"),
             "CNV": ("quant_matmul", "quant_matmul_int4", "quant_dequant"),
             "Mob": ("quant_matmul", "quant_matmul_int4", "quant_dequant",
                     "quant_depthwise_conv2d")}
    xs = {"TFC": np.random.RandomState(2).randn(64, 784).astype(np.float32),
          "CNV": np.random.RandomState(12).randn(SLOT, 3, 32, 32).astype(np.float32)}
    for key in ("TFC-w1a1", "TFC-w1a2", "TFC-w2a2", "CNV-w1a1", "CNV-w2a2"):
        g = zoo.ZOO[key]()
        x = xs[key[:3]]
        before = ops.launch_counts()
        plan = compile_graph(g, device=dev)
        bodies = ops.b2_body_counts()
        out = plan({"x": x})[plan.graph.output_names[0]]
        torch.cuda.synchronize()
        bodies = check_b2_bodies(ops, plan, bodies, 1, key)
        ref = _oracle(g, x, key=key)[g.output_names[0]]
        if tuple(out.shape) != (x.shape[0], 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{key} (int): bad output {tuple(out.shape)}")
        if not torch.equal(out.cpu(), ref):
            raise AssertionError(f"{key} (int): compiled CUDA plan differs from the oracle "
                                 f"by {float((out.cpu() - ref).abs().max())}")
        launched = _check_int_plan(plan, key, ops, before, needs[key[:3]])
        rq = plan.requant_stats()
        print(f"integer path {key}: bit-exact vs oracle, requant {rq['int32_segments']}/"
              f"{rq['kernel_segments']} int32 segments, fused_counts={plan.fused_counts}, "
              f"launches={launched}, B2 launches by body {bodies}", flush=True)

    x16 = np.random.RandomState(13).randn(2 * SLOT, 3, 224, 224).astype(np.float32)
    g = zoo.build_mobilenet(4, 4, img=224)
    before = ops.launch_counts()
    plan = compile_graph(g, device=dev)
    bodies = ops.b2_body_counts()
    staged = ops.staging_counts()["quant_depthwise_conv2d"]
    out = plan({"x": x16[:SLOT]})[g.output_names[0]]
    torch.cuda.synchronize()
    bodies = check_b2_bodies(ops, plan, bodies, 1, "MobileNet-224 (zoo, int)",
                             exact=MOBILENET_INT8_BODIES)
    staged = {k: v - staged[k] for k, v in ops.staging_counts()["quant_depthwise_conv2d"].items()}
    if staged != {"reciprocal": 13, "quotient": 0, "division": 0}:
        raise AssertionError(f"MobileNet-224 (zoo, int): B6 launches by staging {staged}, "
                             "not 13 on the reciprocal")
    print(f"integer path MobileNet-w4a4 img 224: its 13 depthwise segments (B6) launched "
          f"by staging {staged}", flush=True)
    if not torch.equal(out.cpu(), _oracle(g, x16[:SLOT], key="MobileNet-w4a4")[
            g.output_names[0]]):
        raise AssertionError("MobileNet-224 (zoo, int): compiled CUDA plan differs from "
                             "the oracle")
    launched = _check_int_plan(plan, "MobileNet-w4a4", ops, before, needs["Mob"])
    print(f"integer path MobileNet-w4a4 img 224 (zoo weights), {SLOT} rows: bit-exact vs the "
          f"CPU oracle; requant 27/28 int32 segments; launches={launched}; B2 launches by "
          f"body {bodies}", flush=True)

    live = zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224))
    oracle = _oracle(live, x16, return_all=True, key="MobileNet-w4a4 rescaled")
    ref = oracle[live.output_names[0]]
    before = ops.launch_counts()
    iplan = compile_graph(live, device=dev)
    pre, w_name = _final_matmul(iplan.graph)
    final = [s for s in iplan.segments if s.kind == "quant_matmul_int4"]
    if len(final) != 1 or final[0].meta["requant_path"] != "fp32":
        raise AssertionError("MobileNet-224 (int): the final MatMul is not the one "
                             "float32 segment")
    rows = []
    for i in (0, SLOT):
        env = {"x": to_tensor(x16[i:i + SLOT], dev)}
        bodies = ops.b2_body_counts()
        for seg in iplan.segments:          # the plan's own loop, keeping env
            seg.run(iplan.consts, env)
        torch.cuda.synchronize()
        check_b2_bodies(ops, iplan, bodies, 1, "MobileNet-224 (rescaled, int)",
                        exact=MOBILENET_INT8_BODIES)
        if not torch.equal(env[pre].cpu(), oracle[pre][i:i + SLOT]):
            raise AssertionError("MobileNet-224 (int): the plan differs from the oracle "
                                 f"before the final MatMul ({pre})")
        rows.append(env[iplan.graph.output_names[0]].cpu())
    out = torch.cat(rows)
    bound = order_bound(oracle[pre], oracle[w_name], ref)
    diff = (out - ref).abs()
    if bool((diff > bound).any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError("MobileNet-224 (int): final MatMul beyond the order bound "
                             f"({float(diff.max())})")
    launched = _check_int_plan(iplan, "MobileNet-w4a4 rescaled", ops, before, needs["Mob"])
    print(f"integer path MobileNet-w4a4 img 224 (conv gains rescaled), 2 x {SLOT} rows: "
          f"requant 27/28 int32 segments, bit-exact vs the CPU oracle through the global "
          f"average pool; final MatMul (float32) within the order bound, max diff "
          f"{float(diff.max())}, {int((diff == 0).sum())} of {diff.numel()} outputs "
          f"bit-exact; launches={launched}", flush=True)

    gg = grouped_conv_graph()
    xg = np.random.RandomState(14).randn(*gg.inputs[0].shape).astype(np.float32)
    before = ops.launch_counts()
    gplan = compile_graph(gg, device=dev)
    staged = ops.staging_counts()["quant_grouped_matmul"]
    gout = gplan({"x": xg})[gg.output_names[0]]
    torch.cuda.synchronize()
    staged = {k: v - staged[k] for k, v in ops.staging_counts()["quant_grouped_matmul"].items()}
    seg = next(s for s in gplan.segments if s.kind == "quant_conv_grouped_int4")
    if seg.meta["requant_path"] != "int32":
        raise AssertionError("grouped conv: B5's segment is not on the int32 path")
    if not torch.equal(gout.cpu(), _oracle(gg, xg, key="GroupedConv-g8")[
            gg.output_names[0]]):
        raise AssertionError("grouped conv (int): compiled CUDA plan differs from the oracle")
    launched = _check_int_plan(gplan, "GroupedConv-g8", ops, before,
                               ("quant_grouped_matmul", "quant_dequant"))
    print(f"integer path {gg.name} {tuple(xg.shape)}: B5 segment on requant_path int32, "
          f"bit-exact vs oracle, launches={launched}, B5 by staging {staged}", flush=True)

    # phase 4 on the integer path: the engine serves TFC-w2a2 in 16-row slots
    # and the rescaled MobileNet-224 in 8-row slots; report_cost is on
    tfc = zoo.build_tfc(2, 2)
    eng = CompiledGraphEngine(tfc, max_batch=16, device=dev)
    if eng.plan.requant_stats()["coverage"] != 1.0 or eng.cost_report is None:
        raise AssertionError("TFC engine: not on the integer path, or no cost report")
    xt = np.random.RandomState(3).randn(64, 784).astype(np.float32)
    reqs = [eng.submit(r) for r in xt]
    bodies = ops.b2_body_counts()
    if eng.run_pending() != 64:
        raise AssertionError("run_pending did not run 64 requests")
    bodies = check_b2_bodies(ops, eng.plan, bodies, 4, "TFC-w2a2 engine (int)")
    got = np.stack([r.wait() for r in reqs])
    if not np.array_equal(got, _oracle(tfc, xt, key="serve TFC")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("served integer-path rows differ from the oracle")
    x40 = xt[:40] * 0.5
    if not np.array_equal(eng(x40), _oracle(tfc, x40, key="serve TFC 40")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("engine(x) on the integer path differs from the oracle")
    rep = eng.cost_report
    print(f"serving TFC-w2a2 on the integer path: 64 requests via run_pending (4 slots of 16; "
          f"B2 launches by body {bodies}) + one 40-row "
          f"call, all rows bit-exact vs the CPU oracle; cost report at load: "
          f"{len(rep.layers)} layers, {rep.macs} MACs, {rep.bops:.6g} BOPs, "
          f"{int(rep.total_weight_bits)} weight bits", flush=True)

    meng = CompiledGraphEngine(live, max_batch=SLOT, device=dev)
    if meng.plan.requant_stats() != REQUANT_STATS["MobileNet-w4a4 rescaled"] or \
            meng.cost_report is None:
        raise AssertionError("MobileNet engine: not on the integer path, or no cost report")
    reqs = [meng.submit(r) for r in x16]
    bodies = ops.b2_body_counts()
    if meng.run_pending() != 2 * SLOT:
        raise AssertionError(f"run_pending did not run {2 * SLOT} requests")
    bodies = check_b2_bodies(ops, meng.plan, bodies, 2, "MobileNet-224 engine (int)",
                             exact=MOBILENET_INT8_BODIES)
    served = torch.from_numpy(np.stack([r.wait() for r in reqs]))
    ragged = torch.from_numpy(meng(x16[3:8]))
    if not torch.equal(served, out) or not torch.equal(ragged, out[3:8]):
        raise AssertionError("served integer-path MobileNet rows differ from the plan's")
    if bool(((served - ref).abs() > bound).any()):
        raise AssertionError("served MobileNet rows beyond the oracle's order bound")
    rep = meng.cost_report
    print(f"serving MobileNet-w4a4 img 224 (rescaled) on the integer path: {2 * SLOT} "
          f"requests in {SLOT}-row slots (B2 launches by body {bodies}) + one ragged 5-row "
          f"call, every row bit-exact vs "
          f"the plan (whose rows are bit-exact vs the CPU oracle through the pool) and "
          f"within the oracle's order bound; cost report at load: {len(rep.layers)} "
          f"layers, {rep.macs} MACs, {int(rep.total_weight_bits)} weight bits", flush=True)
    return (eng, xt), (meng, np.concatenate([x16] * 4)), (iplan, x16[:SLOT])


def requests_per_s(eng, xs) -> float:
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        reqs = [eng.submit(r) for r in xs]
        eng.run_pending()
        for r in reqs:
            r.wait()
        rates.append(len(xs) / (time.perf_counter() - t0))
    return statistics.median(rates)


# ----------------------------------------------------------------- phase 5

def _timed(**fns) -> dict:
    """{key: device ms, key_call: call ms} for each named callable."""
    out = {}
    for key, fn in fns.items():
        call_key = "call_ms" if key == "ms" else key.replace("_ms", "_call_ms")
        out[key], out[call_key] = time_ms(fn)
    return out


def _matmul_row(ops, torch, dev, g, m, k, n, int4, shape):
    x = torch.randn(m, k, generator=g).to(dev)
    w = torch.randint(-8 if int4 else -127, 8 if int4 else 128, (k, n), generator=g,
                      dtype=torch.int8)
    wk = (ops.pack_int4(w) if int4 else w).to(dev)
    wf = w.float().to(dev)
    s = torch.full((n,), 2.0 ** -6, device=dev)
    fn = ops.quant_matmul_int4 if int4 else ops.quant_matmul
    plain = ops.quant_matmul_int4_plain if int4 else ops.quant_matmul_plain
    nbytes = 4 * m * k + (k * n // 2 if int4 else k * n) + 4 * n + 4 * m * n
    return dict(shape=shape, **_timed(ms=lambda: fn(x, wk, s),
                                      plain_ms=lambda: plain(x, wk, s),
                                      library_ms=lambda: torch.matmul(x, wf) * s),
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=2 * m * k * n / FP32_FLOPS * 1e3)


def _qdq_row(ops, torch, dev, g, rows, cols, bits, signed, scale, shape):
    x = (torch.randn(rows, cols, generator=g) * 2).to(dev)
    s, z = torch.tensor(scale, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(bit_width=bits, signed=signed)
    qmin, qmax = (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if signed else (0, 2 ** bits - 1)
    return dict(shape=shape, **_timed(
        ms=lambda: ops.quant_dequant(x, s, z, **kw),
        plain_ms=lambda: ops.quant_dequant_plain(x, s, z, **kw),
        library_ms=lambda: torch.fake_quantize_per_tensor_affine(x, scale, 0, qmin, qmax)),
        bytes_ms=(8 * rows * cols + 8) / HBM_BYTES_PER_S * 1e3,
        ops_ms=6 * rows * cols / FP32_FLOPS * 1e3)


def timings(ops, torch, dev):
    """Per kernel, the rows of one TFC forward at M = M_TIMED."""
    g = torch.Generator().manual_seed(5)
    rows = {k: [] for k in REPLACES}
    for k, n in TFC_LAYERS:
        for int4 in (False, True):
            rows["quant_matmul_int4" if int4 else "quant_matmul"].append(
                _matmul_row(ops, torch, dev, g, M_TIMED, k, n, int4, f"{M_TIMED}x{k}x{n}"))
    for cols, bits, signed, scale in ((784, 8, True, 1 / 128), (64, 2, False, 0.5),
                                      (64, 2, False, 0.5), (64, 2, False, 0.5)):
        rows["quant_dequant"].append(_qdq_row(ops, torch, dev, g, M_TIMED, cols, bits,
                                              signed, scale, f"{M_TIMED}x{cols}"))
    return rows


def timings_mobilenet(ops, torch, dev):
    """Per kernel, the rows of one MobileNet-w4a4 forward at img 224 with
    SLOT rows (B5: the grouped conv of phase 3)."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(15)
    rows = {k: [] for k in REPLACES}
    rows["quant_dequant"].append(_qdq_row(ops, torch, dev, g, SLOT, 3 * 224 * 224, 8,
                                          True, 1 / 128, f"{SLOT}x{3 * 224 * 224}"))
    for kind, cin, cout, stride, h in _mobilenet_layers():
        ho = (h - 1) // stride + 1
        if kind == "conv":          # first conv: im2col K = 27 (odd): int8, B1
            m = SLOT * ho * ho
            rows["quant_matmul"].append(_matmul_row(ops, torch, dev, g, m, 27, cout, False,
                                                    f"{m}x27x{cout}"))
        elif kind == "pw":
            m = SLOT * h * h
            rows["quant_matmul_int4"].append(_matmul_row(
                ops, torch, dev, g, m, cin, cout, True, f"{m}x{cin}x{cout}"))
        else:
            x = torch.randn(SLOT, cin, h, h, generator=g).to(dev)
            taps = torch.randint(-8, 8, (9, cin), generator=g, dtype=torch.int8).to(dev)
            wf = taps.float().t().reshape(cin, 1, 3, 3).contiguous()
            s = torch.tensor(2.0 ** -6, device=dev)
            qs, qz = torch.tensor(0.125, device=dev), torch.tensor(0.0, device=dev)
            kw = dict(kernel_shape=(3, 3), strides=(stride, stride), pads=(1, 1, 1, 1),
                      relu=True, act_bits=4, act_signed=False)
            n_out = SLOT * cin * ho * ho
            rows["quant_depthwise_conv2d"].append(dict(
                shape=f"{SLOT}x{cin}x{h}x{h}/s{stride}",
                **_timed(ms=lambda: ops.quant_depthwise_conv2d(x, taps, s, None, qs, qz, **kw),
                         plain_ms=lambda: ops.quant_depthwise_conv2d_plain(
                             x, taps, s, None, qs, qz, **kw),
                         library_ms=lambda: F.conv2d(x, wf, None, stride, 1, 1, cin)),
                bytes_ms=(4 * x.numel() + 9 * cin + 4 * n_out + 12) / HBM_BYTES_PER_S * 1e3,
                ops_ms=(18 + 8) * n_out / FP32_FLOPS * 1e3))
        if kind != "dw":            # the act Quant B4 runs after conv / pointwise
            c_out = cout * ho * ho if kind == "conv" else cout * h * h
            rows["quant_dequant"].append(_qdq_row(ops, torch, dev, g, SLOT, c_out, 4, False,
                                                  0.125, f"{SLOT}x{c_out}"))
    rows["quant_matmul_int4"].append(_matmul_row(ops, torch, dev, g, SLOT, 1024, 1000, True,
                                                 f"{SLOT}x1024x1000"))
    # B5 at the grouped conv's shape: (G, M, Kg) view of its im2col matrix
    c, img, grp = GCONV["c"], GCONV["img"], GCONV["groups"]
    x = torch.randn(GCONV["n"], c, img, img, generator=g).to(dev)
    patches = ops.extract_patches(x, (3, 3), (1, 1), (1, 1, 1, 1))[0]
    m, kg, ng = patches.shape[0], c // grp * 9, c // grp
    xg = patches.view(m, grp, kg).permute(1, 0, 2)
    w = torch.randint(-8, 8, (grp, kg, ng), generator=g, dtype=torch.int8)
    wk = ops.pack_int4_grouped(w).to(dev)
    wf = w.float().to(dev)
    s = torch.full((c,), 2.0 ** -4, device=dev)
    rows["quant_grouped_matmul"].append(dict(
        shape=f"{grp}x{m}x{kg}x{ng} int4",
        **_timed(ms=lambda: ops.quant_grouped_matmul(xg, wk, s, packed=True),
                 plain_ms=lambda: ops.quant_grouped_matmul_plain(xg, wk, s, packed=True),
                 library_ms=lambda: torch.bmm(xg, wf)),
        bytes_ms=(4 * m * grp * kg + grp * kg * ng // 2 + 4 * c + 4 * m * c)
        / HBM_BYTES_PER_S * 1e3,
        ops_ms=2 * m * grp * kg * ng / FP32_FLOPS * 1e3))
    wfull = w.float().permute(0, 2, 1).reshape(c, c // grp, 3, 3).to(dev)
    conv_ms = time_ms(lambda: F.conv2d(x, wfull, None, 1, 1, 1, grp))[0]
    print(f"(library yardstick, conv only, no scale or epilogue) F.conv2d groups={grp} on "
          f"{tuple(x.shape)}: device {conv_ms:.6f} ms", flush=True)
    return rows


def _int_mm_ok(m, k, n) -> bool:
    """torch._int_mm's shape rules on CUDA (M > 16, K and N multiples of 8)."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def _timing_spec():
    """The B3 epilogue of the timed integer rows: ReLU and an unsigned 4-bit
    act Quant, as MobileNet-w4a4's layers have."""
    from repro_torch.kernels.requant import IntRequant
    return IntRequant(shift=9, relu=True, has_act=True, act_shift=6, act_zp=0, act_lo=0,
                      act_hi=15, act_out_shift=3, rounding_mode="ROUND")


def _int_matmul_row(ops, torch, dev, g, m, k, n, int4, shape, int8_codes=False,
                    in_scale=IN_SCALE, spec=_timing_spec):
    """One integer-body row; for B2 ``int8_codes`` picks the int8 tensor-core
    body (else IMAD), ``in_scale`` the staging division (IN_SCALE) or the
    exact reciprocal multiply (a power of two), and ``spec`` the epilogue
    (B3 by default; None: the float32 epilogue over the same int32 sums)."""
    q = torch.randint(-8, 9, (m, k), generator=g, dtype=torch.int8)
    x = (q.float() * in_scale).to(dev)
    w = torch.randint(-8 if int4 else -127, 8 if int4 else 128, (k, n), generator=g,
                      dtype=torch.int8)
    wk = (ops.pack_int4(w) if int4 else w).to(dev)
    mult = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32).mul(2).add(1).to(dev)
    kw = dict(acc_dtype=torch.int32, in_scale=in_scale)
    if spec is not None:
        kw["requant"] = spec()
    else:
        mult = mult.float().mul(2.0 ** -6)
    if int8_codes:
        kw["int8_codes"] = True
    fn = ops.quant_matmul_int4 if int4 else ops.quant_matmul
    plain = ops.quant_matmul_int4_plain if int4 else ops.quant_matmul_plain
    # the twin's int8-fit check reads its result on the host, which a CUDA
    # graph cannot capture: the twin is timed without it (same arithmetic)
    plain_kw = {key: v for key, v in kw.items() if key != "int8_codes"}
    fns = dict(ms=lambda: fn(x, wk, mult, **kw), plain_ms=lambda: plain(x, wk, mult, **plain_kw))
    if _int_mm_ok(m, k, n):
        q8, w8 = q.to(dev), w.to(dev)
        fns["library_ms"] = lambda: torch._int_mm(q8, w8)
    row = dict(shape=shape, **_timed(**fns),
               bytes_ms=(4 * m * k + (k * n // 2 if int4 else k * n) + 4 * n + 4 * m * n)
               / HBM_BYTES_PER_S * 1e3,
               ops_ms=2 * m * k * n / INT8_OPS * 1e3)
    row.setdefault("library_ms", None)
    row.setdefault("library_call_ms", None)
    return row


B2_INT8 = "quant_matmul_int4/int32 (int8 body, power-of-two scale)"
B2_INT8_F32 = "quant_matmul_int4/int32 (int8 body, power-of-two scale, float32 epilogue)"
B2_IMAD = "quant_matmul_int4/int32 (IMAD body)"


def int_timings(ops, torch, dev):
    """The integer bodies (B3 epilogue) at the shapes of one TFC forward at
    M = M_TIMED and of one MobileNet-w4a4 forward at img 224 with SLOT rows
    (the 27 int32 segments; the final MatMul stays float32); B5 at the
    grouped conv's shape.  B2 takes the body the lowering picks: IMAD for
    TFC's first layer (8-bit input codes), the int8 tensor-core body
    elsewhere, at IN_SCALE (the division).  Beside them, in ``b2``, the 13
    MobileNet pointwise layers on the int8 body at a power-of-two scale
    (the reciprocal multiply) and on the IMAD body (B2's integer body
    before the int8 one); in
    ``b6`` the 13 depthwise layers at a power-of-two scale (the reciprocal
    staging of the main path's scales)."""
    g = torch.Generator().manual_seed(25)
    tfc = {k + "/int32": [] for k in INT_KERNELS}
    for i, (k, n) in enumerate(TFC_LAYERS):
        for int4 in (False, True):
            tfc[("quant_matmul_int4" if int4 else "quant_matmul") + "/int32"].append(
                _int_matmul_row(ops, torch, dev, g, M_TIMED, k, n, int4, f"{M_TIMED}x{k}x{n}",
                                int8_codes=int4 and i > 0))
    mob = {k + "/int32": [] for k in INT_KERNELS}
    b2 = {B2_INT8: [], B2_INT8_F32: [], B2_IMAD: []}
    b6 = {B6_POW2: []}
    spec = _timing_spec()
    for kind, cin, cout, stride, h in _mobilenet_layers():
        ho = (h - 1) // stride + 1
        if kind == "conv":
            m = SLOT * ho * ho
            mob["quant_matmul/int32"].append(_int_matmul_row(
                ops, torch, dev, g, m, 27, cout, False, f"{m}x27x{cout}"))
        elif kind == "pw":
            m = SLOT * h * h
            shape = f"{m}x{cin}x{cout}"
            mob["quant_matmul_int4/int32"].append(_int_matmul_row(
                ops, torch, dev, g, m, cin, cout, True, shape, int8_codes=True))
            b2[B2_INT8].append(_int_matmul_row(ops, torch, dev, g, m, cin, cout, True, shape,
                                               int8_codes=True, in_scale=TC_IN_SCALES[0]))
            b2[B2_INT8_F32].append(_int_matmul_row(ops, torch, dev, g, m, cin, cout, True,
                                                   shape, int8_codes=True,
                                                   in_scale=TC_IN_SCALES[0], spec=None))
            b2[B2_IMAD].append(_int_matmul_row(ops, torch, dev, g, m, cin, cout, True, shape))
        else:
            q = torch.randint(-8, 9, (SLOT, cin, h, h), generator=g).float()
            taps = torch.randint(-8, 8, (9, cin), generator=g, dtype=torch.int8)
            mob["quant_depthwise_conv2d/int32"].append(
                _int_dw_row(ops, torch, dev, q, taps, stride, IN_SCALE, spec))
            b6[B6_POW2].append(_int_dw_row(ops, torch, dev, q, taps, stride,
                                           TC_IN_SCALES[0], spec))
    c, img, grp = GCONV["c"], GCONV["img"], GCONV["groups"]
    q = torch.randint(-8, 9, (GCONV["n"], c, img, img), generator=g).float().to(dev)
    x = q * IN_SCALE
    patches = ops.extract_patches(x, (3, 3), (1, 1), (1, 1, 1, 1))[0]
    m, kg, ng = patches.shape[0], c // grp * 9, c // grp
    xg = patches.view(m, grp, kg).permute(1, 0, 2)
    qg = ops.extract_patches(q, (3, 3), (1, 1), (1, 1, 1, 1))[0].view(m, grp, kg).permute(1, 0, 2)
    w = torch.randint(-8, 8, (grp, kg, ng), generator=g, dtype=torch.int8)
    wk = ops.pack_int4_grouped(w).to(dev)
    wf = w.float().to(dev)
    mult = torch.full((c,), 3, dtype=torch.int32, device=dev)
    kw = dict(packed=True, acc_dtype=torch.int32, requant=spec, in_scale=IN_SCALE)
    # the library yardstick: the same sums (exact in float32) on the codes,
    # without the epilogue
    mob["quant_grouped_matmul/int32"].append(dict(
        shape=f"{grp}x{m}x{kg}x{ng} int4",
        **_timed(ms=lambda: ops.quant_grouped_matmul(xg, wk, mult, **kw),
                 plain_ms=lambda: ops.quant_grouped_matmul_plain(xg, wk, mult, **kw),
                 library_ms=lambda: torch.bmm(qg, wf)),
        bytes_ms=(4 * m * grp * kg + grp * kg * ng // 2 + 4 * c + 4 * m * c)
        / HBM_BYTES_PER_S * 1e3,
        ops_ms=2 * m * grp * kg * ng / INT8_OPS * 1e3))
    return tfc, mob, b2, b6


B6_POW2 = "quant_depthwise_conv2d/int32 (power-of-two scale)"


def _int_dw_row(ops, torch, dev, q, taps, stride, in_scale, spec):
    """One B6 integer-body row (B3 epilogue) on x = q · in_scale; its
    library yardstick F.conv2d(groups=C) sums the float32 codes q (exact)
    without the epilogue."""
    import torch.nn.functional as F
    slot, cin, h = q.shape[0], q.shape[1], q.shape[2]
    ho = (h - 1) // stride + 1
    x = (q * in_scale).to(dev)
    qd, td = q.to(dev), taps.to(dev)
    wf = taps.float().t().reshape(cin, 1, 3, 3).contiguous().to(dev)
    mult = torch.full((cin,), 3, dtype=torch.int32, device=dev)
    kw = dict(kernel_shape=(3, 3), strides=(stride, stride), pads=(1, 1, 1, 1),
              acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
    n_out = slot * cin * ho * ho
    return dict(shape=f"{slot}x{cin}x{h}x{h}/s{stride}",
                **_timed(ms=lambda: ops.quant_depthwise_conv2d(x, td, mult, **kw),
                         plain_ms=lambda: ops.quant_depthwise_conv2d_plain(x, td, mult, **kw),
                         library_ms=lambda: F.conv2d(qd, wf, None, stride, 1, 1, cin)),
                bytes_ms=(4 * x.numel() + 9 * cin + 4 * cin + 4 * n_out) / HBM_BYTES_PER_S * 1e3,
                ops_ms=18 * n_out / INT8_OPS * 1e3)


def profile_forward(torch, plan, x, label, reps=5):
    """One plan call's device time by kernel name (torch.profiler), beside
    its wall time without the profiler: the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    xd = torch.from_numpy(x).cuda()

    def run():
        for _ in range(reps):
            plan({"x": xd})
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.key_averages():
        # device-side events only: an aten op repeats its kernels' time
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            by_name[e.key] = (t / reps / 1e3, e.count / reps)
    busy = sum(t for t, _ in by_name.values())
    print(f"profile[{label}]: one MobileNet-224 plan call of {len(x)} rows: wall "
          f"{wall_ms:.6f} ms (no profiler), kernels {busy:.6f} ms (profiler), device busy "
          f"share {busy / wall_ms:.3f}", flush=True)
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"profile[{label}]:   {t:.6f} ms in {n:g} launches  {key[:110]}", flush=True)


def walls_in_turns(torch, plans: dict, x, pairs=10, reps=5):
    """Wall ms of one plan call (host clock around ``reps`` calls and a
    sync), the plans run in turns (A B, then B A, ...) ``pairs`` times;
    prints each plan's median and quartiles."""
    xd = torch.from_numpy(x).cuda()
    names = list(plans)
    walls = {n: [] for n in names}
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            plans[name]({"x": xd})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                plans[name]({"x": xd})
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / reps * 1e3)
    for name, ws in walls.items():
        q = statistics.quantiles(ws, n=4)
        print(f"plan call wall[{name}], MobileNet-224 {len(x)} rows, {pairs} turns: median "
              f"{statistics.median(ws):.6f} ms, quartiles {q[0]:.6f} / {q[2]:.6f} ms", flush=True)


def _fmt(v) -> str:
    return "n/a" if v is None else f"{v:.6f} ms"


def report(rows, launches, err, label):
    """Print one line per timed shape; returns the per-kernel JSON entries
    (times summed over the shapes; the library time only where one call
    computes the product at every shape, else null)."""
    kernels = []
    for name, rs in rows.items():
        if not rs:
            continue
        base = name.split("/")[0]
        for r in rs:
            bound = max(r["bytes_ms"], r["ops_ms"])
            print(f"time[{label}] {name} {r['shape']}: device kernel {r['ms']:.6f} ms, plain "
                  f"{r['plain_ms']:.6f} ms, library {_fmt(r['library_ms'])}, bound "
                  f"{bound:.6f} ms ({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'}); "
                  f"per eager call: kernel {r['call_ms']:.6f} ms, plain "
                  f"{r['plain_call_ms']:.6f} ms, library {_fmt(r['library_call_ms'])}",
                  flush=True)
        by_bytes = sum(r["bytes_ms"] for r in rs if r["bytes_ms"] >= r["ops_ms"])
        by_ops = sum(r["ops_ms"] for r in rs if r["ops_ms"] > r["bytes_ms"])
        libs = [r["library_ms"] for r in rs]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[base], replaces=REPLACES[base],
            launches=launches[name], max_abs_err=err[name],
            ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=by_bytes + by_ops,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None if None in libs else sum(libs)))
        print(f"sum[{label}] {name} over {len(rs)} shapes: device {kernels[-1]['ms']:.6f} ms, "
              f"eager {sum(r['call_ms'] for r in rs):.6f} ms, bound "
              f"{kernels[-1]['bound_ms']:.6f} ms ({kernels[-1]['bound_by']}), plain "
              f"{kernels[-1]['plain_ms']:.6f} ms, library {_fmt(kernels[-1]['library_ms'])}",
              flush=True)
    return kernels


# ---------------------------------------------------- phase 6: the LM path

LM_ARCH = "qwen2-1.5b"
LM_B, LM_S = 4, 2048           # the prefill of (a), and the timed attention shape
LM_NEW = 16                    # the launcher's --max-new-tokens
# qwen2-1.5B at full width: layers, d_model, heads, KV heads, head_dim, d_ff, vocab
LM_SHAPE = (28, 1536, 12, 2, 128, 8960, 151936)
# Relative L2 bound on the last-token logits of B7's prefill against the
# plain attention's (the reference's chunked_attention).  The two differ
# only in the order of float32 sums inside the attention, so a bf16 output
# moves by one step here and there; under W8A8 such a step can move a code
# of the next fake quant (a bf16 x / s above 64 has steps of 0.5: half the
# codes sit on ties), and the flips compound over 28 layers.  Each bound
# lies between the sound reading and the smallest planted-fault reading
# (planted_faults: a causal mask one key late reads 0.23 and 0.17 on the
# H100, a wrong head map, scale or a missing mask about 1.3-1.4).
LM_REL_L2 = {"w8a8kv8": 0.15, "fp32": 0.05}
LM_FAULTS = ("mask one key late", "kv heads swapped", "no 1/sqrt(hd)", "no causal mask")
# card against CPU on the SMOKE config (float32 activations): the B7 path
# there sums in another order than the CPU twin, at float32 precision
LM_SMALL_REL_L2 = 1e-4


def _lm_recipe():
    from repro_torch.quantize.config import QuantRecipe
    return QuantRecipe.w_a(8.0, 8.0, kv_cache_bits=8.0)     # the launcher's default


def _finite(torch, t, shape, what):
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{what}: shape {tuple(t.shape)} (want {tuple(shape)}) "
                             f"or non-finite values")


def lm_small_check(torch, dev):
    """qwen2's SMOKE config (2 layers, d 64, hd 16), float32 activations,
    one seeded init on the CPU copied to the card: prefill logits on the
    card within LM_SMALL_REL_L2 of the CPU's (the CPU path is the one the
    tests hold against the reference) and greedy tokens equal, under the
    FP32 recipe and under W8A8 with the 8-bit KV cache."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from repro_torch.quantize.config import FP32
    from repro_torch.serve import greedy_generate
    for recipe in (FP32, _lm_recipe()):
        cfg = get_smoke_config(LM_ARCH).replace(quant=recipe)
        p_cpu = api.init_params(3, cfg, "cpu")
        p_dev = api.init_params(3, cfg, "cpu").to(dev)
        toks = torch.randint(1, cfg.vocab, (3, 9), generator=torch.Generator().manual_seed(4),
                             dtype=torch.int32)
        want, _ = api.prefill(p_cpu, {"tokens": toks}, cfg, 17)
        got, _ = api.prefill(p_dev, {"tokens": toks.to(dev)}, cfg, 17)
        rel = float((got.cpu() - want).norm() / want.norm())
        t_cpu = greedy_generate(p_cpu, cfg, {"tokens": toks}, 8)
        t_dev = greedy_generate(p_dev, cfg, {"tokens": toks.to(dev)}, 8).cpu()
        same = float((t_cpu == t_dev).float().mean())
        print(f"lm small check [{cfg.name}, {recipe.tag()}]: card vs CPU prefill logits rel-L2 "
              f"{rel:.3e} (bound {LM_SMALL_REL_L2}), greedy tokens equal on {same:.3f} of "
              f"{t_cpu.numel()}", flush=True)
        if rel > LM_SMALL_REL_L2 or not torch.equal(t_cpu, t_dev):
            raise AssertionError(f"LM small check {recipe.tag()}: card differs from CPU")


def _pad_left(torch, prompts):
    """The engine's slot batch: prompts left-padded with token 0."""
    S = max(len(p) for p in prompts)
    toks = torch.zeros((len(prompts), S), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = torch.as_tensor(p, dtype=torch.int32)
    return toks


def _check_slot(torch, params, cfg, prompts, results, dev, label):
    """The engine's tokens of one slot against greedy_generate on the same
    left-padded batch (the same kernels at the same shapes: equal)."""
    from repro_torch.serve import greedy_generate
    want = greedy_generate(params, cfg, {"tokens": _pad_left(torch, prompts).to(dev)},
                           LM_NEW).cpu()
    got = torch.stack(results)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: engine tokens differ from greedy_generate")


def _faulty(orig, fault):
    """The plain attention with one planted fault, as a wrong B7 would
    compute it."""
    def attn(q, k, v, **kw):
        if fault == "mask one key late":          # query i also sees key i+1
            kw["q_offset"] += 1
        elif fault == "kv heads swapped":         # a wrong GQA head map
            k, v = k.roll(1, dims=2), v.roll(1, dims=2)
        elif fault == "no 1/sqrt(hd)":
            q = q * float(q.shape[-1]) ** 0.5
        elif fault == "no causal mask":
            kw["causal"] = False
        return orig(q, k, v, **kw)
    return attn


def planted_faults(torch, api, transformer, params, toks, cfg, sound, tag):
    """The (a) comparison read again with a planted attention fault on the
    plain path, against the sound plain prefill ``sound``: each fault must
    land beyond LM_REL_L2, or the bound would not tell a wrong attention
    from a sound one."""
    for fault in LM_FAULTS:
        with mock.patch.object(transformer, "takes_flash", lambda *a: False), \
                mock.patch.object(transformer, "chunked_attention",
                                  _faulty(transformer.chunked_attention, fault)):
            bad, _ = api.prefill(params, {"tokens": toks}, cfg, LM_S)
        rel = float((bad - sound).norm() / sound.norm())
        top1 = float((bad.argmax(-1) == sound.argmax(-1)).float().mean())
        print(f"lm (a) [{tag}] planted fault '{fault}': rel-L2 {rel:.4e} against the sound "
              f"plain prefill (bound {LM_REL_L2[tag]}, must exceed it), "
              f"top-1 agreement {top1:.2f}", flush=True)
        if rel <= LM_REL_L2[tag]:
            raise AssertionError(f"planted fault '{fault}' [{tag}] within the bound: {rel}")


def run_lm_path(torch, np, dev, ops):
    """Phase 6: qwen2-1.5B at full width (28 layers), W8A8 with the 8-bit
    KV cache, bf16 activations, seeded weights on the card.
    (a) prefill B=4, S=2048 with exactly 28 B7 launches and nothing else,
        held against the same prefill on the plain attention (and again
        without fake quant), relative L2 within LM_REL_L2, top-1 printed;
        then the plain prefill with planted attention faults read against
        the sound one (planted_faults);
    (b) the launcher's traffic (``python -m repro_torch.launch.serve``:
        8 requests of 4-11 tokens from default_rng(0), 16 new tokens, slots
        of 4), then the same with prompts of 512-2048 tokens through
        GenerationEngine; every result 16 tokens in the vocabulary, and
        one slot of each held against greedy_generate.
    Launch counts are set to 0 before (a) and before (b) and read after
    each.  Returns (params, cfg, tokens, launches of (b))."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import api, transformer
    from repro_torch.quantize.config import FP32
    from repro_torch.serve import GenerationEngine

    cfg = get_config(LM_ARCH).replace(quant=_lm_recipe())
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab)
    if shape != LM_SHAPE or cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} is not qwen2-1.5B at full width: {shape}")
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, dev)
    torch.cuda.synchronize()
    print(f"lm: {cfg.name} at full width, {cfg.param_count()} float32 parameters, "
          f"{cfg.n_layers} layers, recipe {cfg.quant.tag()}, {cfg.dtype} activations; "
          f"seeded init on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    toks = torch.randint(1, cfg.vocab, (LM_B, LM_S), generator=torch.Generator().manual_seed(11),
                         dtype=torch.int32).to(dev)

    # (a) one prefill through B7, counted
    ops.reset_launch_counts()
    logits, _ = api.prefill(params, {"tokens": toks}, cfg, LM_S)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"lm (a) prefill B={LM_B} S={LM_S}: launches {counts}", flush=True)
    if counts["flash_attention"] != cfg.n_layers or sum(counts.values()) != cfg.n_layers:
        raise AssertionError(f"prefill launched {counts}, want {cfg.n_layers} x B7 only")
    _finite(torch, logits, (LM_B, cfg.vocab), "prefill logits")
    for tag, c in (("w8a8kv8", cfg), ("fp32", cfg.replace(quant=FP32))):
        a = logits if tag == "w8a8kv8" else api.prefill(params, {"tokens": toks}, c, LM_S)[0]
        # every attention call on the plain path: the reference's computation
        with mock.patch.object(transformer, "takes_flash", lambda *a: False):
            b, _ = api.prefill(params, {"tokens": toks}, c, LM_S)
        rel = float((a - b).norm() / b.norm())
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"lm (a) [{tag}]: B7 prefill vs plain-attention prefill, last-token logits "
              f"rel-L2 {rel:.4e} (bound {LM_REL_L2[tag]}), top-1 agreement {top1:.2f} "
              f"of {LM_B} rows", flush=True)
        if rel > LM_REL_L2[tag]:
            raise AssertionError(f"B7 prefill [{tag}] beyond the bound: {rel}")
        planted_faults(torch, api, transformer, params, toks, c, b, tag)
    del logits, a, b

    # (b) the launcher's traffic, then long prompts, counted together
    ops.reset_launch_counts()
    short = launcher.main(["--arch", LM_ARCH])
    rng = np.random.default_rng(0)
    eng = GenerationEngine(params, cfg, max_batch=4)
    t0 = time.perf_counter()
    long_prompts = [rng.integers(1, cfg.vocab, size=rng.integers(512, 2049)) for _ in range(8)]
    reqs = [eng.submit(p, LM_NEW) for p in long_prompts]
    eng.run_pending()
    dt = time.perf_counter() - t0
    lm_launches = ops.launch_counts()
    print(f"lm (b) launches over both traffics: {lm_launches}", flush=True)
    if lm_launches["flash_attention"] <= 0:
        raise AssertionError("B7 never launched on the LM serving path")
    n_tok = sum(int(r.result.shape[0]) for r in reqs)
    print(f"lm (b) launcher traffic ({short['requests']} requests of 4-11 tokens, slots of 4): "
          f"{short['tokens']} tokens in {short['seconds']:.3f} s, "
          f"{short['tokens_per_s']:.1f} tokens/s (host clock, first call included)", flush=True)
    print(f"lm (b) long prompts ({len(reqs)} requests of "
          f"{min(len(p) for p in long_prompts)}-{max(len(p) for p in long_prompts)} tokens, "
          f"slots of 4): {n_tok} tokens in {dt:.3f} s, {n_tok / dt:.1f} tokens/s", flush=True)
    for r in short["results"] + [r.result for r in reqs]:
        if r.shape != (LM_NEW,) or int(r.min()) < 0 or int(r.max()) >= cfg.vocab:
            raise AssertionError(f"a served result is not {LM_NEW} tokens of the vocabulary")
    rng = np.random.default_rng(0)          # the launcher's prompts, drawn again
    short_prompts = [rng.integers(1, cfg.vocab, size=rng.integers(4, 12)) for _ in range(8)]
    _check_slot(torch, params, cfg, short_prompts[:4], short["results"][:4], dev,
                "launcher slot 0")
    _check_slot(torch, params, cfg, long_prompts[4:], [r.result for r in reqs[4:]], dev,
                "long-prompt slot 1")
    print("lm (b) one slot of each traffic equals greedy_generate on its padded batch",
          flush=True)
    return params, cfg, toks, lm_launches


# ----------------------------------------------------- phase 7: LM timings

def lm_attention_timings(torch, ops, cfg, dev):
    """B7 at the prefill's attention shape (B=4, S=2048, qwen2's heads, the
    model's layout), bf16 as the model runs it and float32: kernel, twin
    and F.scaled_dot_product_attention (causal, GQA) on the same inputs,
    beside the bound (causal FLOPs 2·B·H·S²·hd at the card's peak for the
    input type, 989 TFLOP/s bf16 or 67 TFLOP/s float32, or q + k + v + out
    bytes at 3.35 TB/s).  Per launch; one prefill runs n_layers launches."""
    import torch.nn.functional as F
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(17)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(LM_B, LM_S, h, hd, generator=g, device=dev).to(dtype)
                   .transpose(1, 2) for h in (H, KV, KV))
        r = _timed(ms=lambda: ops.flash_attention(q, k, v),
                   plain_ms=lambda: ops.flash_attention_plain(q, k, v),
                   library_ms=lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True))
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        r["ops_ms"] = 2 * LM_B * H * LM_S ** 2 * hd / peak * 1e3
        r["bytes_ms"] = (2 * q.numel() + 2 * k.numel()) * q.element_size() / HBM_BYTES_PER_S * 1e3
        bound = max(r["ops_ms"], r["bytes_ms"])
        name = str(dtype).replace("torch.", "")
        print(f"time[lm attention {name}] B={LM_B} H={H} KV={KV} S={LM_S} hd={hd} causal, per "
              f"launch: device kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"sdpa {r['library_ms']:.6f} ms, bound {bound:.6f} ms "
              f"({'operations' if r['ops_ms'] >= r['bytes_ms'] else 'bytes'}); per eager call: "
              f"kernel {r['call_ms']:.6f} ms, plain {r['plain_call_ms']:.6f} ms, sdpa "
              f"{r['library_call_ms']:.6f} ms; x{cfg.n_layers} per prefill: kernel "
              f"{cfg.n_layers * r['ms']:.6f} ms", flush=True)
        rows[name] = r
    return rows


def _profile_lm(torch, run, label, wall_ms):
    """One call of ``run`` under torch.profiler: device time by kernel name
    and by PyTorch op, beside the call's wall time without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, by_op = {}, {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            by_name[e.key] = (t / 1e3, e.count)
        elif e.key.startswith("aten::"):
            t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            if t > 0:
                by_op[e.key] = (t / 1e3, e.count)
    busy = sum(t for t, _ in by_name.values())
    print(f"profile[{label}]: device kernels {busy:.3f} ms in "
          f"{sum(n for _, n in by_name.values())} launches (profiler), against a median "
          f"wall of {wall_ms:.3f} ms without it", flush=True)
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"profile[{label}]:   {t:.3f} ms in {n} launches  {key[:100]}", flush=True)
    # by PyTorch op (device time of the kernels each op launched; an op that
    # calls another, as aten::to calls aten::copy_, repeats its time)
    for key, (t, n) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"profile[{label}] op:   {t:.3f} ms in {n} calls  {key}", flush=True)


def lm_walls(torch, params, cfg, toks, reps=3, steps=8):
    """Prefill (B=4, S=2048) and decode-step wall times (host clock around
    work that ends in a sync; medians), then one prefill's and one decode
    step's device time by kernel name and by op (torch.profiler)."""
    from repro_torch.models import api
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": toks}, cfg, LM_S + steps + 2)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"wall[lm prefill] B={LM_B} S={LM_S}: median {statistics.median(walls):.3f} ms over "
          f"{reps} (each {', '.join(f'{w:.3f}' for w in walls)})", flush=True)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    dwalls = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, tok, LM_S + i, cfg)
        torch.cuda.synchronize()
        dwalls.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    print(f"wall[lm decode step] B={LM_B}, cache {LM_S}-{LM_S + steps - 1}: median "
          f"{statistics.median(dwalls):.3f} ms over {steps} steps", flush=True)
    _profile_lm(torch, lambda: api.prefill(params, {"tokens": toks}, cfg, LM_S),
                "lm prefill", statistics.median(walls))
    _profile_lm(torch, lambda: api.decode_step(params, cache, tok, LM_S + steps, cfg),
                "lm decode step", statistics.median(dwalls))
    return statistics.median(walls), statistics.median(dwalls)


def lm_kernel_entry(rows, launches, err, cfg):
    """The B7 entry of the kernels line: one prefill (n_layers launches) at
    B=4, S=2048 on the model's bf16 inputs."""
    r, L = rows["bfloat16"], cfg.n_layers
    return dict(name="flash_attention", route="cuda", source=SOURCES["flash_attention"],
                replaces=REPLACES["flash_attention"], launches=launches["flash_attention"],
                max_abs_err=err["flash_attention"], ms=L * r["ms"], plain_ms=L * r["plain_ms"],
                bound_ms=L * max(r["ops_ms"], r["bytes_ms"]),
                bound_by="operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
                library_ms=L * r["library_ms"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False     # true fp32 twins
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)", flush=True)
    print(_build.build_info.get("log", "(library reused)"), flush=True)

    # phase 2: each kernel against its twin
    err = {k: 0.0 for k in REPLACES}
    n_mm = check_matmuls(ops, torch, np, dev, err)
    n_qd = check_quant_dequant(ops, torch, np, dev, err)
    n_gm = check_grouped_matmul(ops, torch, np, dev, err)
    n_dw = check_depthwise(ops, torch, np, dev, err)
    print(f"kernels vs twins: {n_mm} matmul cases, {n_qd} quant_dequant cases, "
          f"{n_gm} grouped matmul cases, {n_dw} depthwise cases; max_abs_err {err}",
          flush=True)
    n_int = check_integer(ops, torch, np, dev, err)
    print(f"integer bodies vs twins (torch.equal): {n_int} cases", flush=True)
    check_redesign(ops, torch, np, dev, err)
    check_flash_attention(ops, torch, dev, err)

    # phases 3 + 4: the float32-epilogue path (use_analysis=False), counted
    ops.reset_launch_counts()
    (eng, xt), (meng, xm), (lplan, x8) = run_main_path(torch, np, dev)
    launches = ops.launch_counts()
    print(f"main-path launches (float32 epilogue): {launches}", flush=True)
    for k in ZOO_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")

    # phases 3 + 4 again on the integer path (compile_graph's defaults),
    # counted on their own
    ops.reset_launch_counts()
    (ieng, ixt), (imeng, ixm), (iplan, ix8) = run_integer_path(torch, np, dev)
    int_counts = ops.launch_counts()
    print(f"main-path launches (integer path): {int_counts}; B2 by body "
          f"{ops.b2_body_counts()}", flush=True)
    for k in ZOO_KERNELS:
        if int_counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the integer path")
    launches.update({k + "/int32": int_counts[k] for k in INT_KERNELS})

    # phase 5: times
    rows = timings(ops, torch, dev)
    report(rows, launches, err, "TFC M=256")
    print("(sums above: one TFC forward at M=256, four matmul layers and four "
          "activation quantizers)", flush=True)
    rows = timings_mobilenet(ops, torch, dev)
    kernels = report(rows, launches, err, f"MobileNet-224 N={SLOT}")
    print(f"(sums above: one MobileNet-w4a4 forward at img 224 with {SLOT} rows; "
          "B5 over the grouped conv's one layer)", flush=True)
    tfc_int, mob_int, b2_rows, b6_rows = int_timings(ops, torch, dev)
    report(tfc_int, launches, err, "TFC M=256, integer")
    print("(sums above: one TFC forward at M=256 on the integer bodies)", flush=True)
    kernels += report(mob_int, launches, err, f"MobileNet-224 N={SLOT}, integer")
    print(f"(sums above: the 27 int32 segments of one MobileNet-w4a4 forward at img 224 "
          f"with {SLOT} rows, B2 on its int8 tensor-core body at IN_SCALE; B5 over the "
          f"grouped conv's one layer)", flush=True)
    b2_launches = {k: launches["quant_matmul_int4/int32"] for k in b2_rows}
    report(b2_rows, b2_launches, {k: err["quant_matmul_int4/int32"] for k in b2_rows},
           f"MobileNet-224 N={SLOT}, integer, B2 bodies")
    print("(sums above: B2's 13 pointwise layers on the int8 body at a power-of-two scale, "
          "with B3 and with the float32 epilogue, and on the IMAD body at IN_SCALE, timed in "
          "the same run)", flush=True)
    report(b6_rows, {B6_POW2: launches["quant_depthwise_conv2d/int32"]},
           {B6_POW2: err["quant_depthwise_conv2d/int32"]},
           f"MobileNet-224 N={SLOT}, integer, B6 power-of-two scale")
    print("(sums above: B6's 13 depthwise layers at a power-of-two scale, the reciprocal "
          "staging of the main path's scales, timed in the same run)", flush=True)
    profile_forward(torch, lplan, x8, "float32 epilogue")
    profile_forward(torch, iplan, ix8, "integer path")
    walls_in_turns(torch, {"float32 epilogue": lplan, "integer path": iplan}, x8)
    # engines in turns: float32, integer, integer, float32
    for model, pair in (("TFC-w2a2, max_batch=16", ((eng, xt), (ieng, ixt))),
                        (f"MobileNet-w4a4 img 224, max_batch={SLOT}", ((meng, xm), (imeng, ixm)))):
        for label, (e, xs) in zip(("float32 epilogue", "integer path", "integer path",
                                   "float32 epilogue"), pair + pair[::-1]):
            rate = requests_per_s(e, xs)
            print(f"engine[{label}]: {rate:.1f} requests/s ({model}, {len(xs)} requests per "
                  f"run_pending, median of 5)", flush=True)

    # phase 6: the LM serving path (B7), counted on its own
    lm_small_check(torch, dev)
    params, cfg, toks, lm_launches = run_lm_path(torch, np, dev, ops)
    launches["flash_attention"] = lm_launches["flash_attention"]
    # phase 7: LM timings
    rows = lm_attention_timings(torch, ops, cfg, dev)
    kernels.append(lm_kernel_entry(rows, launches, err, cfg))
    lm_walls(torch, params, cfg, toks)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
