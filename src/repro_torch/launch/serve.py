"""Serving launcher: the LM engine or the compiled-graph tier
(counterpart of ``repro.launch.serve``).

LM generation (default):

    python -m repro_torch.launch.serve --arch qwen2-1.5b            # on CUDA
    python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke --device cpu

Builds the architecture's config (``--smoke``: its reduced SMOKE config)
with the recipe ``--wbits / --abits / --kv-bits`` (default W8A8 with an
8-bit KV cache; ``--wbits 0`` serves in float) and
``shard_activations=True``, derives ``elastic_mesh()`` over the devices
present (``--device`` names one: a (1, 1) mesh), initialises seeded
weights (seed 0) on its device, and, under that mesh, serves ``--requests`` prompts of 4 to
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

Distributed serving (compiled-graph path):

  --mesh                compile the served plan data-parallel over
                        ``elastic_mesh(prefer_model=1)`` (every CUDA device,
                        or the ``--device`` named: a (1, 1) mesh, the plain
                        path)
  --devices N           serve over an N-entry mesh cycling over the devices
                        present (on one GPU: N entries of ``cuda:0``), the
                        counterpart of the reference's forced host device
                        count; implies ``--mesh`` (with ``--splitmerge``:
                        one worker per entry)

The LM path runs one process per device.  Under torchrun each rank
starts the process group (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``) and serves its shards of a mesh of one entry per rank
(tensor parallelism; with 2-4 ranks a (1, N) mesh); rank 0 prints a JSON
summary (counts, rate, launch counts, every request's tokens) as its last
line:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --device cpu --requests 4

Without torchrun a mesh of more than one entry (``--devices N`` with
N > 1, or several GPUs) raises, naming torchrun.

Everything runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.dist.fault import elastic_mesh
from repro_torch.dist.sharding import distribute_model, param_pspecs, to_shardings
from repro_torch.kernels.ops import launch_counts
from repro_torch.launch.mesh import make_virtual_mesh, mesh_rank, torchrun_group
from repro_torch.models import api
from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.serve.generation import GenerationEngine, greedy_generate, left_pad

log = logging.getLogger("repro_torch.launch.serve")



def graph_mesh(args):
    """The compiled-graph path's mesh: ``--devices N`` entries, or
    ``--mesh``'s elastic mesh, or None (the plain one-device plan)."""
    if args.devices:
        return make_virtual_mesh(args.devices, args.device)
    if args.mesh:
        return elastic_mesh(prefer_model=1, device=args.device)
    return None


def lm_mesh(args):
    """The LM path's mesh: ``--devices N`` entries, else ``elastic_mesh()``
    over the devices present (or the one named), or over the process
    group's ranks under torchrun."""
    if args.devices:
        if torch.distributed.is_initialized():
            raise ValueError("--devices is a mesh of one process; under torchrun the "
                             "mesh is the process group's")
        return make_virtual_mesh(args.devices, args.device)
    return elastic_mesh(device=args.device)


def serve_graph(args) -> dict:
    """Serve a zoo graph behind EngineRegistry + ServeScheduler (or the
    split-merge front); returns the run's counts, rate, stats and result
    rows (in submission order)."""
    from repro_torch import obs
    from repro_torch.models import zoo
    from repro_torch.serve import (EngineRegistry, ServeScheduler,
                                   SplitMergeFront, device_workers)

    mesh = graph_mesh(args)
    device = resolve_device(args.device) if mesh is None else mesh.devices.flat[0]
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
            if args.devices:
                devices = list(mesh.devices.flat)       # one worker per entry
            else:
                devices = None if args.device is None else [device]
            workers = device_workers(
                zoo.ZOO[args.graph],
                devices=devices,
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
                                      tracer=tracer, tune=args.tune,
                                      tune_cache_dir=args.tune_cache_dir,
                                      **({"device": device} if mesh is None
                                         else {"mesh": mesh}))
            eng = registry.register(args.graph, zoo.ZOO[args.graph]())
            if mesh is not None:
                log.info("mesh-sharded plan spans %d device(s): mesh %s over %s, "
                         "placement %s", eng.plan.n_devices, mesh.shape,
                         [str(d) for d in eng.plan.devices()], eng.plan.placement())
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
            "plan_devices": eng.plan.n_devices, "placement": eng.plan.placement(),
            "metrics_port": None if server is None else server.port,
            "results": np.stack([np.asarray(r) for r in rows])}


def serve_lm(args) -> dict:
    """Serve the launcher's traffic under the launcher's mesh; returns the
    run's counts, rate, this process's rank, the kernels' launch counts
    and the results (one int32 token tensor per request, in submission
    order, on the host).

    Over a mesh of several entries (under torchrun: one rank per entry)
    each rank holds its shards of the parameters, placed as the dry-run's
    prefill and decode cells place them (``param_pspecs`` without FSDP),
    the caches by ``cache_pspecs``; every rank submits the same seeded
    prompts, so every rank runs the same slots, and each slot's tokens
    come back whole on every rank (``serve.generation``)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    recipe = (QuantRecipe.w_a(args.wbits, args.abits, kv_cache_bits=args.kv_bits)
              if args.wbits else FP32)
    cfg = cfg.replace(quant=recipe, shard_activations=True)
    mesh = lm_mesh(args)
    rank = mesh_rank(mesh)
    log.info("mesh %s, %s, recipe %s (rank %d on %s)", mesh.shape, cfg.name, recipe.tag(),
             rank, mesh.devices.flat[rank])
    with mesh:
        res = _serve_lm_on(args, cfg, mesh, mesh.devices.flat[rank])
    return dict(res, rank=rank, mesh=mesh.shape, launches=launch_counts())


def _serve_lm_on(args, cfg, mesh, device) -> dict:
    params = api.init_params(0, cfg, device)
    if mesh.size > 1:
        distribute_model(params, to_shardings(param_pspecs(params, mesh, fsdp=False), mesh))
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
    ap.add_argument("--mesh", action="store_true",
                    help="compile the served plan data-parallel over an "
                         "elastic mesh of the devices present")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="serve over an N-entry mesh cycling over the "
                         "devices present (implies --mesh)")
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
    if args.graph:
        logging.basicConfig(level=logging.INFO)
        return serve_graph(args)
    with torchrun_group(args.device) as rank:
        logging.basicConfig(level=logging.INFO,
                            format=f"[rank {rank}] %(levelname)s %(name)s: %(message)s")
        return serve_lm(args)


def _summary(res: dict) -> str:
    """The LM run's JSON summary line (results as lists of token ids)."""
    return json.dumps(dict(res, results=[r.tolist() for r in res["results"]]))


if __name__ == "__main__":
    out = main()
    if "rank" in out and out["rank"] == 0:    # the LM path: rank 0 reports
        print(_summary(out))
