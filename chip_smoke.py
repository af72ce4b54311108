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
3. the main path: TFC-w2a2 (packed int4: B2 + B4) and TFC-w1a1 with
   ``use_int4=False`` (B1 + B4) are built by the port's zoo, compiled on
   CUDA and held bit-exact against the port's oracle on the CPU, with the
   reference's segment census;
4. serving: a ``CompiledGraphEngine`` answers 64 submitted requests and one
   40-row batch in 16-row slots, each row bit-exact against the oracle on
   the CPU;
5. timings at the TFC shapes with M = 256 beside each kernel's bound, its
   twin and one library call computing the same function (CUDA events,
   median of 30 samples of 10 calls after warm-up; device time from a
   replayed CUDA graph of the 10 calls, call time from eager calls), and
   the engine's requests per second.

Launch counts are reset just before phase 3 and read just after phase 4;
every kernel of the path must have launched there.  The last lines are the
card, a JSON line of per-kernel numbers, and the JSON result line.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TFC_LAYERS = [(784, 64), (64, 64), (64, 64), (64, 10)]
M_TIMED = 256
REPLACES = {
    "quant_matmul": "src/repro/kernels/quant_matmul.py:139",
    "quant_matmul_int4": "src/repro/kernels/quant_matmul.py:184",
    "quant_dequant": "src/repro/kernels/quant_dequant.py:126",
}
SOURCES = {
    "quant_matmul": "src/repro_torch/kernels/csrc/quant_matmul.cu",
    "quant_matmul_int4": "src/repro_torch/kernels/csrc/quant_matmul.cu",
    "quant_dequant": "src/repro_torch/kernels/csrc/quant_dequant.cu",
}
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


# ------------------------------------------------------------ phases 3 + 4

def run_main_path(torch, np, dev):
    from repro_torch.core import compile_graph, execute, transforms
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.serve import CompiledGraphEngine

    census = {
        ("TFC-w2a2", True): {"quant_dequant": 4, "quant_matmul_int4": 4, "interp": 3},
        ("TFC-w1a1", False): {"quant_dequant": 1, "quant_matmul": 4, "interp": 3},
    }
    needs = {("TFC-w2a2", True): ("quant_matmul_int4", "quant_dequant"),
             ("TFC-w1a1", False): ("quant_matmul", "quant_dequant")}
    x = np.random.RandomState(2).randn(64, 784).astype(np.float32)
    for (key, int4), want_counts in census.items():
        g = zoo.ZOO[key]()
        before = ops.launch_counts()
        plan = compile_graph(g, device=dev, use_int4=int4)
        out = plan({"x": x})[plan.graph.output_names[0]]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        after = ops.launch_counts()
        ref = execute(transforms.cleanup(g), {"x": x}, device="cpu")[g.output_names[0]]
        if tuple(out.shape) != (64, 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{key}: bad output {tuple(out.shape)}")
        if not torch.equal(out.cpu(), ref):
            raise AssertionError(f"{key}: compiled CUDA plan differs from the oracle "
                                 f"by {float((out.cpu() - ref).abs().max())}")
        if plan.fused_counts != want_counts:
            raise AssertionError(f"{key}: census {plan.fused_counts} != {want_counts}")
        for k in needs[(key, int4)]:
            if after[k] <= before[k]:
                raise AssertionError(f"{key}: kernel {k} was not launched")
        print(f"main path {key} use_int4={int4}: bit-exact vs oracle, "
              f"fused_counts={plan.fused_counts}, launches="
              f"{ {k: after[k] - before[k] for k in after} }")

    # phase 4: serving, in 16-row slots, held against the oracle on the CPU
    g = zoo.build_tfc(2, 2)
    eng = CompiledGraphEngine(g, max_batch=16, device=dev)
    clean = transforms.cleanup(g)

    def oracle(rows):
        return execute(clean, {"x": rows}, device="cpu")[g.output_names[0]].numpy()

    xs = np.random.RandomState(3).randn(64, 784).astype(np.float32)
    reqs = [eng.submit(r) for r in xs]
    if eng.run_pending() != 64:
        raise AssertionError("run_pending did not run 64 requests")
    got = np.stack([r.wait() for r in reqs])
    if not np.array_equal(got, oracle(xs)):
        raise AssertionError("served rows differ from the oracle")
    x40 = xs[:40] * 0.5
    if not np.array_equal(eng(x40), oracle(x40)):
        raise AssertionError("engine(x) differs from the oracle")
    if eng.n_completed != 64:
        raise AssertionError(f"engine completed {eng.n_completed}, not 64")
    print(f"serving: 64 requests via run_pending + one 40-row call, all rows "
          f"bit-exact vs the CPU oracle; completed={eng.n_completed}")
    return eng, xs


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


def timings(ops, torch, dev):
    """Per kernel: (rows of per-shape numbers, summed entry)."""
    g = torch.Generator().manual_seed(5)
    rows = {k: [] for k in REPLACES}
    for k, n in TFC_LAYERS:
        x = torch.randn(M_TIMED, k, generator=g).to(dev)
        w = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int8)
        wp = ops.pack_int4(w).to(dev)
        w = w.to(dev)
        s = torch.full((n,), 0.125, device=dev)
        for name, wk in (("quant_matmul", w), ("quant_matmul_int4", wp)):
            fn = ops.quant_matmul_int4 if name.endswith("int4") else ops.quant_matmul
            plain = ops.quant_matmul_int4_plain if name.endswith("int4") \
                else ops.quant_matmul_plain
            wbytes = k * n // 2 if name.endswith("int4") else k * n
            nbytes = 4 * M_TIMED * k + wbytes + 4 * n + 4 * M_TIMED * n
            flops = 2 * M_TIMED * k * n
            wf = w.float()
            rows[name].append(dict(
                shape=f"{M_TIMED}x{k}x{n}",
                **_timed(ms=lambda: fn(x, wk, s),
                         plain_ms=lambda: plain(x, wk, s),
                         library_ms=lambda: torch.matmul(x, wf) * s),
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=flops / FP32_FLOPS * 1e3))
    for cols, bits, signed, scale in ((784, 8, True, 1 / 128), (64, 2, False, 0.5),
                                      (64, 2, False, 0.5), (64, 2, False, 0.5)):
        x = (torch.randn(M_TIMED, cols, generator=g) * 2).to(dev)
        s = torch.tensor(scale, device=dev)
        z = torch.tensor(0.0, device=dev)
        kw = dict(bit_width=bits, signed=signed)
        qmin, qmax = (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if signed else (0, 2 ** bits - 1)
        rows["quant_dequant"].append(dict(
            shape=f"{M_TIMED}x{cols}",
            **_timed(ms=lambda: ops.quant_dequant(x, s, z, **kw),
                     plain_ms=lambda: ops.quant_dequant_plain(x, s, z, **kw),
                     library_ms=lambda: torch.fake_quantize_per_tensor_affine(
                         x, scale, 0, qmin, qmax)),
            bytes_ms=(8 * M_TIMED * cols + 8) / HBM_BYTES_PER_S * 1e3,
            ops_ms=6 * M_TIMED * cols / FP32_FLOPS * 1e3))
    return rows


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
    print(f"kernels vs twins: {n_mm} matmul cases, {n_qd} quant_dequant cases; "
          f"max_abs_err {err}", flush=True)

    # phases 3 + 4: the main path, counted
    ops.reset_launch_counts()
    eng, xs = run_main_path(torch, np, dev)
    launches = ops.launch_counts()
    print(f"main-path launches: {launches}", flush=True)
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")

    # phase 5: times
    rate = requests_per_s(eng, xs)
    print(f"engine: {rate:.1f} requests/s (TFC-w2a2, max_batch=16, 64 requests "
          f"per run_pending, median of 5)", flush=True)
    rows = timings(ops, torch, dev)
    kernels = []
    for name, rs in rows.items():
        for r in rs:
            bound = max(r["bytes_ms"], r["ops_ms"])
            print(f"time {name} {r['shape']}: device kernel {r['ms']:.6f} ms, plain "
                  f"{r['plain_ms']:.6f} ms, library {r['library_ms']:.6f} ms, bound "
                  f"{bound:.6f} ms ({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'}); "
                  f"per eager call: kernel {r['call_ms']:.6f} ms, plain "
                  f"{r['plain_call_ms']:.6f} ms, library {r['library_call_ms']:.6f} ms",
                  flush=True)
        by_bytes = sum(r["bytes_ms"] for r in rs if r["bytes_ms"] >= r["ops_ms"])
        by_ops = sum(r["ops_ms"] for r in rs if r["ops_ms"] > r["bytes_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name], max_abs_err=err[name],
            ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=by_bytes + by_ops,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=sum(r["library_ms"] for r in rs)))
    print("(per-kernel numbers below sum one TFC forward at M=256: four matmul "
          "layers, four activation quantizers)")
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
