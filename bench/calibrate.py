"""The two readings a cell's comparison limit is set from, on the card.

    PYTHONPATH=src python -m bench.calibrate --workload cnv-w2a2.offline \\
        --seconds 2 --seeds 11,12,13 [--control-seeds 11,12,13]

For each seed: the program's ``logit_rel_err`` from a run of the cell
(``harness.run_cell``: the timed path at the cell's sizes, a short
window), and the control's: the reference computed in bfloat16, the
precision below the configuration's float32, against the float64
reference on as many of the seed's images as a run compares.  The limit
goes above the program's largest reading and below the control's least.
"""
from __future__ import annotations

import argparse
import json
import sys


def control_reading(cfg: dict, seed: int, device) -> float:
    import torch

    from bench import check, harness, seeded
    params, pool = harness.draw(cfg, seed)
    index = seeded.sample_rng(seed).integers(pool.shape[0],
                                             size=cfg["check"]["rows"])
    low = check.reference_rows(cfg, params, pool, index, device=device,
                               dtype=torch.bfloat16)
    ref = check.reference_rows(cfg, params, pool, index, device=device)
    return check.logit_rel_err(low, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    import torch

    from bench import harness, manifest
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bm = manifest.load()
    cfg = manifest.load_config(bm, manifest.cell(bm, args.workload)["config"])
    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(args.workload, seed, args.seconds,
                                     False, bm=bm)
        program[seed] = result["checks"]["logit_rel_err"]["value"]
        print(json.dumps({"seed": seed, "program": program[seed],
                          "lost": result["checks"]["lost_requests"]["value"],
                          "metrics": result["metrics"]}), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        control[seed] = control_reading(cfg, seed, "cuda")
        print(json.dumps({"seed": seed, "control": control[seed]}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "program_max": max(program.values()),
                      "control_min": min(control.values(), default=None)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
