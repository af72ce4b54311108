"""Find the online mix's knee on the card: one set-up, then the open loop
at each offered rate in turn.

    PYTHONPATH=src python -m bench.sweep --config mobilenet-w4a4 \\
        --traffic online --seed 1 --seconds 8 --rates 500,1000,2000 \\
        [--trace 1]

Prints one line a rate: p50 / p95 latency over every request due, the
refused and late requests, and the p95 of the window's first and last
quarter (a growing backlog shows as a rising last quarter).  The knee is
the highest rate whose p95 meets the mix's deadline with nothing refused
and no rising backlog; the cell runs at four fifths of it.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True, help="an open-loop mix")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="profile each rate: device idle share and gaps")
    args = p.parse_args(argv)
    import torch

    from bench import harness, manifest, seeded
    from bench.devtrace import traced
    from bench.loadgen import OpenLoop
    from bench.stats import nearest_rank
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = manifest.load_config(manifest.load(), args.config)
    traffic = manifest.load_traffic(args.traffic)
    params, pool = harness.draw(cfg, args.seed)
    engine = harness.serve(cfg, params, "cuda")
    loop = OpenLoop(engine, traffic, pool, seeded.traffic_rng(args.seed))
    try:
        loop.warm()
        for rate in (float(r) for r in args.rates.split(",")):
            loop.traffic = dict(traffic, rate_per_s=rate)
            summary = None
            if args.trace:
                rec, summary = traced(lambda: loop.run(args.seconds), [])
            else:
                rec = loop.run(args.seconds)
            run = harness.Run(cfg, 0.0, rec, rec["t1"] - rec["t0"], summary)
            lat = rec["latency_ms"]
            q = max(1, len(lat) // 4)
            row = {"rate_per_s": rate, "requests": len(lat),
                   "p50_ms": nearest_rank(lat, 50),
                   "p95_first_quarter_ms": nearest_rank(lat[:q], 95),
                   "p95_last_quarter_ms": nearest_rank(lat[-q:], 95),
                   "refused": rec["refused"], "lost": rec["lost"],
                   "late_max_ms": float(max(rec["late_s"])) * 1e3}
            for name in ("latency_p95_ms", "images_per_s", "slot_fill_pct",
                         "queue_wait_p50_ms", "device_idle_pct"):
                row[name] = manifest.reader(name)(run)
            if summary is not None:
                row["idle_gaps"] = summary["idle_gaps"][:3]
            print(json.dumps(row), flush=True)
    finally:
        loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
