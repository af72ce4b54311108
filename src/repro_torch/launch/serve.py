"""Serving launcher: the LM engine or the compiled-graph tier
(counterpart of ``repro.launch.serve``).

LM generation (default):

    python -m repro_torch.launch.serve --arch qwen2-1.5b            # on CUDA
    python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke --device cpu

Builds the architecture's config (``--smoke``: its reduced SMOKE config)
with the recipe ``--wbits / --abits / --kv-bits`` (default W8A8 with an
8-bit KV cache; ``--wbits 0`` serves in float), initialises seeded
weights (seed 0) on the device, and serves ``--requests`` prompts of 4 to
11 random tokens (``numpy.random.default_rng(0)``) through
``GenerationEngine`` in slots of 4, ``--max-new-tokens`` each; it logs
tokens per second.  Every arch serves (``--arch llava-next-34b``,
``deepseek-moe-16b``, ``moonshot-v1-16b-a3b``, ``whisper-base``,
``rwkv6-7b`` and ``recurrentgemma-2b`` too).  The
engine serves token prompts only (a vlm request runs without an image);
the audio family's prefill needs frames the engine cannot pass (ROADMAP
C16), so for it the launcher serves the same slots, left-padded as the
engine pads them, through ``greedy_generate`` with seeded stub frames
(``torch.Generator`` seeded with the slot's index).

Compiled-QONNX-graph serving (the scheduler / registry stack: submit ->
future over the pipelined engine, p50/p99 at the end):

    python -m repro_torch.launch.serve --graph TFC-w2a2 --requests 64
    python -m repro_torch.launch.serve --graph TFC-w2a2 --device cpu
    python -m repro_torch.launch.serve --graph TFC-w2a2 --splitmerge

On CUDA the engine's first call captures the plan's one slot shape in a
CUDA graph; every flush after it replays that graph.

  --splitmerge          shard the request wave across one engine per CUDA
                        device (``--device`` names one): deterministic merge
                        order, failed workers re-dispatched
  --metrics-port PORT   serve the process-wide metrics registry over HTTP
                        (GET /metrics Prometheus text, /metrics.json)
  --trace-jsonl PATH    write one JSON span per line for the full request
                        lifecycle (submit -> queue -> flush -> dispatch ->
                        sync -> complete)
  --hold                with --metrics-port: keep the endpoint up until
                        Ctrl-C
  --tune MODE           per-segment kernel launch geometry
                        (``repro_torch.tune``): ``off`` (the plans'
                        heuristics), ``cached`` (from the tune cache) or
                        ``search`` (time the kernels on the first load and
                        persist the winners)
  --tune-cache-dir PATH the tune cache's root (default
                        ``$REPRO_TUNE_CACHE_DIR`` or ``~/.cache/repro-tune``)

Everything runs on CUDA unless ``--device cpu`` is given.  Mesh-sharded
plans (``--mesh``) and forced device counts (``--devices``) are not
ported: those flags raise.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.models import api
from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.serve.generation import GenerationEngine, greedy_generate, left_pad

log = logging.getLogger("repro_torch.launch.serve")

# flags of the reference launcher whose tiers the port does not have yet
NOT_PORTED = {
    "mesh": "mesh-sharded plans: ROADMAP A16",
    "devices": "multi-device serving: ROADMAP A16",
}


def serve_graph(args) -> dict:
    """Serve a zoo graph behind EngineRegistry + ServeScheduler (or the
    split-merge front); returns the run's counts, rate, stats and result
    rows (in submission order)."""
    from repro_torch import obs
    from repro_torch.models import zoo
    from repro_torch.serve import (EngineRegistry, ServeScheduler,
                                   SplitMergeFront, device_workers)

    device = resolve_device(args.device)
    server = tracer = sink = None
    try:
        if args.metrics_port is not None:
            server = obs.http.start_metrics_server(port=args.metrics_port)
            log.info("metrics on http://0.0.0.0:%d/metrics", server.port)
        if args.trace_jsonl:
            sink = obs.JsonlSink(args.trace_jsonl)
            tracer = obs.Tracer(sink)
            log.info("tracing spans to %s", args.trace_jsonl)
        rng = np.random.default_rng(0)
        if args.splitmerge:
            workers = device_workers(
                zoo.ZOO[args.graph],
                devices=None if args.device is None else [device],
                metrics_registry=obs.default_registry(),
                max_batch=args.max_batch, pipeline=not args.no_pipeline,
                report_cost=False, tracer=tracer, tune=args.tune,
                tune_cache_dir=args.tune_cache_dir)
            with SplitMergeFront(workers,
                                 metrics_registry=obs.default_registry()) as front:
                eng = workers[0].engine
                xs = [rng.standard_normal(eng.sample_shape, dtype=np.float32)
                      for _ in range(args.requests)]
                for w in workers:                   # capture each worker's slot
                    w.engine(xs[0])
                t0 = time.monotonic()
                rows = front.submit_wave(xs, deadline_ms=args.deadline_ms) \
                    .wait(timeout=300)
                dt = time.monotonic() - t0
                stats = front.stats()
            log.info("splitmerge %s on %s: %d requests over %d workers in "
                     "%.2fs (%.1f req/s), %s", args.graph, device, len(xs),
                     len(workers), dt, len(xs) / dt, stats)
        else:
            # engines share the process-wide registry (distinct model
            # labels), so the HTTP endpoint exports the fleet in one snapshot
            registry = EngineRegistry(max_batch=args.max_batch,
                                      pipeline=not args.no_pipeline,
                                      metrics_registry=obs.default_registry(),
                                      tracer=tracer, device=device,
                                      tune=args.tune,
                                      tune_cache_dir=args.tune_cache_dir)
            eng = registry.register(args.graph, zoo.ZOO[args.graph]())
            xs = [rng.standard_normal(eng.sample_shape, dtype=np.float32)
                  for _ in range(args.requests)]
            eng(xs[0])                            # capture the slot shape
            with ServeScheduler(eng, window_ms=args.window_ms,
                                max_queue=max(args.max_batch * 4,
                                              args.requests)) as sched:
                t0 = time.monotonic()    # interval math never uses wall clock
                reqs = [sched.submit(x, deadline_ms=args.deadline_ms)
                        for x in xs]
                rows = [r.wait(timeout=300) for r in reqs]
                dt = time.monotonic() - t0
            stats = sched.stats()
            log.info(
                "graph %s (%s) on %s: %d requests in %.2fs (%.1f req/s), "
                "latency p50=%.2fms p99=%.2fms, queued p50=%.2fms, "
                "%d flushes, %d deadline miss(es), %d capture(s), %d replays",
                args.graph,
                "pipelined" if not args.no_pipeline else "per-chunk sync",
                device, len(reqs), dt, len(reqs) / dt,
                stats["latency_p50_ms"], stats["latency_p99_ms"],
                stats["queued_p50_ms"], stats["flushes"],
                stats["deadline_misses"], eng.plan.trace_count,
                eng.plan.replay_count)
        if server is not None:
            from repro_torch.obs.report import render
            print(render(obs.default_registry().snapshot(), "serve_"))
            if args.hold:
                log.info("holding metrics endpoint open on port %d (Ctrl-C "
                         "to exit)", server.port)
                try:
                    while True:
                        time.sleep(3600)
                except KeyboardInterrupt:
                    pass
    finally:
        if sink is not None:
            sink.close()
        if server is not None:
            server.close()
    return {"graph": args.graph, "requests": len(xs), "seconds": dt,
            "requests_per_s": len(xs) / dt, "stats": stats,
            "tuning": eng.plan.tuning_stats(),
            "metrics_port": None if server is None else server.port,
            "results": np.stack([np.asarray(r) for r in rows])}


def serve_lm(args) -> dict:
    """Serve the launcher's traffic; returns the run's counts, rate and
    results (one int32 token tensor per request, in submission order)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    recipe = (QuantRecipe.w_a(args.wbits, args.abits, kv_cache_bits=args.kv_bits)
              if args.wbits else FP32)
    cfg = cfg.replace(quant=recipe)
    device = resolve_device(args.device)
    log.info("%s on %s, recipe %s", cfg.name, device, recipe.tag())
    params = api.init_params(0, cfg, device)
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(4, 12))
               for _ in range(args.requests)]
    if cfg.family == "audio":
        results = _serve_audio(params, cfg, prompts, args.max_new_tokens, device)
    else:
        eng = GenerationEngine(params, cfg, max_batch=4)
        reqs = [eng.submit(p, args.max_new_tokens) for p in prompts]
        eng.run_pending()
        results = [r.result for r in reqs]
    dt = time.monotonic() - t0
    n_tok = sum(int(r.shape[0]) for r in results)
    log.info("%d requests, %d tokens in %.2fs (%.1f tok/s)",
             len(results), n_tok, dt, n_tok / dt)
    return {"requests": len(results), "tokens": n_tok, "seconds": dt,
            "tokens_per_s": n_tok / dt, "results": results}


def _serve_audio(params, cfg, prompts, max_new_tokens: int, device, slot: int = 4) -> list:
    """The engine's slots (``left_pad``) through ``greedy_generate`` with
    seeded stub frames; int32 tokens on the host."""
    out = []
    for n, i in enumerate(range(0, len(prompts), slot)):
        batch = prompts[i:i + slot]
        toks = left_pad(batch)
        frames = api.frontend_batch(torch.Generator().manual_seed(n), cfg, len(batch), device)
        res = greedy_generate(params, cfg, dict(frames, tokens=toks.to(device)),
                              max_new_tokens).cpu()
        out.extend(res[j] for j in range(len(batch)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain twins)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--wbits", type=float, default=8)
    ap.add_argument("--abits", type=float, default=8)
    ap.add_argument("--kv-bits", type=float, default=8)
    # compiled-graph serving tier
    ap.add_argument("--graph", metavar="MODEL", default=None,
                    help="serve a zoo graph (e.g. TFC-w2a2) behind the "
                         "scheduler/registry stack instead of the LM engine")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline passed to submit()")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="per-chunk-sync dispatch (the baseline)")
    ap.add_argument("--splitmerge", action="store_true",
                    help="shard request waves across one engine per device "
                         "(SplitMergeFront)")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--devices", type=int, default=None, metavar="N")
    ap.add_argument("--tune", choices=("off", "cached", "search"), default="off")
    ap.add_argument("--tune-cache-dir", metavar="PATH", default=None)
    # observability
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="expose the metrics registry over HTTP: GET "
                         "/metrics (Prometheus text) and /metrics.json")
    ap.add_argument("--trace-jsonl", metavar="PATH", default=None,
                    help="write request-lifecycle spans to PATH, one JSON "
                         "object per line")
    ap.add_argument("--hold", action="store_true",
                    help="with --metrics-port: keep the endpoint up after "
                         "the run until Ctrl-C")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: {what}")
    if args.graph:
        return serve_graph(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
