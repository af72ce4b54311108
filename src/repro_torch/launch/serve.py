"""LM serving launcher (counterpart of the LM half of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen2-1.5b            # on CUDA
    python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke --device cpu

Builds the architecture's config (``--smoke``: its reduced SMOKE config)
with the recipe ``--wbits / --abits / --kv-bits`` (default W8A8 with an
8-bit KV cache; ``--wbits 0`` serves in float), initialises seeded
weights (seed 0) on the device, and serves ``--requests`` prompts of 4 to
11 random tokens (``numpy.random.default_rng(0)``) through
``GenerationEngine`` in slots of 4, ``--max-new-tokens`` each; it logs
tokens per second.  Runs on CUDA unless ``--device cpu`` is given.

The compiled-graph serving tier (``--graph``), mesh and split-merge
serving (``--mesh``, ``--splitmerge``, ``--devices``) and the
observability endpoints are not ported yet: those flags raise.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.models import api
from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.serve.generation import GenerationEngine

log = logging.getLogger("repro_torch.launch.serve")

# flags of the reference launcher whose tiers the port does not have yet
NOT_PORTED = {
    "graph": "the compiled-graph serving tier (scheduler, registry): ROADMAP A13",
    "mesh": "mesh-sharded plans: ROADMAP A16",
    "splitmerge": "split-merge serving: ROADMAP A13 and A16",
    "devices": "multi-device serving: ROADMAP A16",
    "metrics_port": "the metrics endpoint: ROADMAP A14",
    "trace_jsonl": "request tracing: ROADMAP A14",
    "hold": "the metrics endpoint: ROADMAP A14",
}


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
    eng = GenerationEngine(params, cfg, max_batch=4)
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    reqs = [eng.submit(rng.integers(1, cfg.vocab, size=rng.integers(4, 12)),
                       args.max_new_tokens)
            for _ in range(args.requests)]
    eng.run_pending()
    dt = time.monotonic() - t0
    n_tok = sum(int(r.result.shape[0]) for r in reqs)
    log.info("%d requests, %d tokens in %.2fs (%.1f tok/s)",
             len(reqs), n_tok, dt, n_tok / dt)
    return {"requests": len(reqs), "tokens": n_tok, "seconds": dt,
            "tokens_per_s": n_tok / dt, "results": [r.result for r in reqs]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain twins)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--wbits", type=float, default=8)
    ap.add_argument("--abits", type=float, default=8)
    ap.add_argument("--kv-bits", type=float, default=8)
    ap.add_argument("--graph", metavar="MODEL", default=None)
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--splitmerge", action="store_true")
    ap.add_argument("--devices", type=int, default=None, metavar="N")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT")
    ap.add_argument("--trace-jsonl", metavar="PATH", default=None)
    ap.add_argument("--hold", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: {what}")
    return serve_lm(args)


if __name__ == "__main__":
    main()
