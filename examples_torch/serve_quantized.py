"""Serving example on the PyTorch port: PTQ-calibrated, KV-quantized
batched generation.

  1. init a small LM, calibrate activation ranges on sample batches (PTQ)
  2. serve a batch of requests with the GenerationEngine (float baseline)
  3. re-serve with W8A8 + int8 KV cache (QONNX recipe) and compare outputs
  4. offline weight quantization to int8 / int4, then the weight-only
     matmul kernels (B1 ``quant_matmul``, B2 ``quant_matmul_int4``) on
     layer 0's up projection
  5. compiled-QONNX-graph serving: a zoo graph partitioned onto the
     integer kernels (core/compile.py) behind the ServeScheduler
     (submit -> future, pipelined slot dispatch), checked against the
     interpreted §V oracle

Run:  PYTHONPATH=src python examples_torch/serve_quantized.py [--device cpu]

Everything runs on ``--device`` (CUDA by default; without CUDA the
example raises rather than falling back to the CPU).  On the card every
prefill of steps 2-3 runs the flash-attention kernel (B7) once per
layer, step 4 runs B1 and B2, and step 5's plan runs B2 and B4 (B3
inside them), captured in a CUDA graph; on the CPU each kernel's wrapper
runs its plain twin.  The parameters and every input are drawn on the
CPU from seeded ``torch.Generator`` s (the reference's ``jax.random``
draws cannot be reproduced) and the graph samples from the reference's
numpy seed, so the card and the CPU serve the same values.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import execute, transforms
from repro_torch.core.executor import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import api, zoo
from repro_torch.quantize import calibrate
from repro_torch.quantize.config import QuantRecipe, TensorQuant
from repro_torch.serve import (CompiledGraphEngine, GenerationEngine,
                               ServeScheduler, greedy_generate)


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def lm_config():
    """qwen2's SMOKE config widened to d 128 / f 256 / 4 layers (head_dim
    16, float32)."""
    return get_smoke_config("qwen2-1.5b").replace(d_model=128, d_ff=256, n_layers=4)


def seeded(seed: int, shape, device, scale: float = 1.0) -> torch.Tensor:
    """Standard normal values drawn on the CPU from ``seed``, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device)


def calibration(samples) -> dict:
    """Step 1: the 8-bit scale of three calibrators over ``samples``."""
    tq = TensorQuant(bit_width=8)
    return {"minmax": float(calibrate.calibrate_minmax(samples, tq)[0]),
            "pct99.9": float(calibrate.calibrate_percentile(samples, tq, pct=99.9)[0]),
            "mse": float(calibrate.calibrate_mse(samples, tq)[0])}


def float_serving(params, cfg, prompts) -> dict:
    """Step 2: the prompts as one slot of a ``GenerationEngine``, 8 new
    tokens each."""
    eng = GenerationEngine(params, cfg, max_batch=4)
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    t0 = time.perf_counter()
    eng.run_pending()
    return {"results": [host(r.result) for r in reqs], "seconds": time.perf_counter() - t0}


def quantized_serving(params, cfg, tokens: torch.Tensor) -> dict:
    """Step 3: 8 greedy tokens in float and under W8A8 with an 8-bit KV
    cache, and the share of them that agree."""
    cfg_q = cfg.replace(quant=QuantRecipe.w_a(8, 8, kv_cache_bits=8))
    out_f = host(greedy_generate(params, cfg, {"tokens": tokens}, n_steps=8))
    out_q = host(greedy_generate(params, cfg_q, {"tokens": tokens}, n_steps=8))
    return {"float": out_f, "w8a8": out_q, "agreement": float((out_f == out_q).mean())}


def up_projection(params) -> torch.Tensor:
    """Layer 0's FFN up projection, (d, f): ``x @ w`` is its product."""
    return params.layers[0].ffn.w_up.detach()


def weight_only(w: torch.Tensor, x: torch.Tensor) -> dict:
    """Step 4: ``x @ w`` through int8 (B1) and packed-int4 (B2) weights;
    each product's relative L2 error against the float one."""
    w8, s8 = ops.quantize_weights_int8(w)
    w4, s4 = ops.quantize_weights_int4(w)
    y_ref = x @ w
    rel = lambda y: float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref))
    return {"int8": rel(ops.quant_matmul(x, w8, s8)),
            "int4": rel(ops.quant_matmul_int4(x, w4, s4))}


def graph_serving(g, samples, device) -> dict:
    """Step 5: ``samples`` through a ``CompiledGraphEngine`` (4 rows a
    slot) behind a ``ServeScheduler``, against the interpreted oracle on
    the cleaned graph."""
    eng = CompiledGraphEngine(g, max_batch=4, device=device)
    t0 = time.perf_counter()
    # the scheduler is the primary serving path: submit -> future,
    # background flushes, pipelined slot dispatch; leaving the block
    # stops and joins its thread, also when a request fails
    with ServeScheduler(eng, window_ms=2.0) as sched:
        reqs = [sched.submit(s) for s in samples]
        results = [host(r.wait(timeout=120)) for r in reqs]
    ms = (time.perf_counter() - t0) * 1e3
    gc = transforms.cleanup(g)
    oracle = host(execute(gc, {"x": np.stack(samples)}, device=device)[gc.output_names[0]])
    md = max(float(np.max(np.abs(r - oracle[i]))) for i, r in enumerate(results))
    stats = eng.latency_stats()
    return {"fused_counts": dict(eng.plan.fused_counts), "results": results,
            "oracle": oracle, "maxdiff": md, "ms": ms,
            "latency_p50_ms": stats["latency_p50_ms"],
            "latency_p99_ms": stats["latency_p99_ms"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="examples_torch/serve_quantized.py")
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = lm_config()
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu").to(dev)

    # -- 1. PTQ calibration -------------------------------------------------
    cal = calibration([seeded(i, (64,), dev, 1.5) for i in range(8)])
    print(f"calibration scales: minmax={cal['minmax']:.4f} "
          f"pct99.9={cal['pct99.9']:.4f} mse={cal['mse']:.4f}")

    # -- 2. float serving ---------------------------------------------------
    fs = float_serving(params, cfg, [np.arange(1, 6 + i) for i in range(4)])
    print(f"float serving: {len(fs['results'])} reqs in {fs['seconds']:.1f}s")
    for i, r in enumerate(fs["results"][:2]):
        print(f"  req{i}: {r}")

    # -- 3. quantized serving (W8A8 + int8 KV) ------------------------------
    qs = quantized_serving(params, cfg, torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32,
                                                      device=dev))
    print(f"W8A8+KV8 vs float: token agreement = {qs['agreement']:.2f}")

    # -- 4. offline weight quantization (serving storage path) --------------
    w = up_projection(params)
    wo = weight_only(w, seeded(9, (4, w.shape[0]), dev))
    print(f"weight-only matmul rel-err: int8={wo['int8']:.4f} int4={wo['int4']:.4f}; "
          f"HBM bytes/weight: bf16=2.0 int8=1.0 int4=0.5")

    # -- 5. compiled QONNX graph serving ------------------------------------
    rng = np.random.default_rng(0)
    samples = [rng.standard_normal(784).astype(np.float32) for _ in range(6)]
    gs = graph_serving(zoo.build_tfc(2, 2), samples, dev)
    print(f"compiled TFC-w2a2: segments {gs['fused_counts']}")
    print(f"graph serving: {len(samples)} reqs in {gs['ms']:.0f}ms "
          f"(p50={gs['latency_p50_ms']:.1f}ms p99={gs['latency_p99_ms']:.1f}ms), "
          f"maxdiff vs interpreted oracle = {gs['maxdiff']:.2e}")
    return {"calibration": cal, "float_serving": fs, "quantized": qs, "weight_only": wo,
            "graph": gs}


if __name__ == "__main__":
    main()
