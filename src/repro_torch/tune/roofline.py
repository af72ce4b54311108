"""Roofline model of one Hopper launch plan, for pruning tuning candidates.

Counterpart of ``repro.tune.roofline``, with the machine of the port: one
NVIDIA H100 SXM (the data sheet's dense rates, ``PERF.md`` §3) and the
shared memory a block may take (``kernels._build.SMEM_MAX``).  The models
price what a candidate geometry provably costs, so the autotuner can drop
dominated candidates without timing them:

  * footprint — the plan's own dynamic shared memory; a candidate over
    ``SMEM_MAX`` cannot launch and is dropped outright;
  * ``matmul_plan_traffic`` — modeled HBM bytes of a tiled matmul: x is
    read once per column tile, the weights once per row tile, the output
    written once (a K split moves the same bytes);
  * ``wave_idle`` — the share of the card's block slots the last wave of
    a grid leaves empty: the axis on which a K split (same bytes, same
    footprint) differs from no split.

A candidate beaten on every axis by another (``pareto_prune``) cannot win
on a machine whose only axes are these, and is not timed.
"""
from __future__ import annotations

from ..kernels._build import SMEM_MAX, SMS

# the card's rates (bytes and operations bounds of a launch, as PERF.md's
# kernel table states them)
HBM_BW = 3.35e12               # HBM3 bandwidth, B/s
PEAK_OPS = {"float32": 67e12,  # CUDA-core float32 FMA, FLOP/s
            "bf16": 989e12,    # tensor cores, dense
            "int8": 1979e12}   # tensor cores, dense, OP/s
THREADS_PER_SM = 2048          # resident threads an SM holds

__all__ = ["HBM_BW", "PEAK_OPS", "SMEM_MAX", "SMS", "THREADS_PER_SM",
           "feasible", "matmul_plan_traffic", "pareto_prune", "wave_idle"]


def feasible(smem_bytes: int) -> bool:
    """Whether a block of this dynamic shared memory can launch."""
    return 0 <= smem_bytes <= SMEM_MAX


def matmul_plan_traffic(m: int, n: int, k: int, bm: int, bn: int, *,
                        x_bytes: float = 4, w_bytes: float = 1,
                        out_bytes: float = 4) -> int:
    """Modeled HBM bytes of an (M, K) @ (K, N) product in (bm, bn) output
    tiles: x streamed once per column of tiles, the weights once per row of
    tiles, the output written once; dimensions padded to the tile first,
    since padding waste is part of what a tiling costs."""
    tm, tn = -(-m // bm), -(-n // bn)
    x_reads = tn * tm * bm * k * x_bytes
    w_reads = tm * k * tn * bn * w_bytes
    return int(x_reads + w_reads + tm * bm * tn * bn * out_bytes)


def wave_idle(blocks: int, threads: int, smem_bytes: int) -> float:
    """Share of the card's block slots the grid's last wave leaves empty:
    an SM holds as many blocks as its threads and shared memory allow."""
    per_sm = max(1, min(THREADS_PER_SM // max(1, threads),
                        SMEM_MAX // max(1, smem_bytes)))
    slots = SMS * per_sm
    blocks = max(1, blocks)
    last = blocks - (-(-blocks // slots) - 1) * slots
    return 1.0 - last / slots


def pareto_prune(candidates, cost_fn, keep: int):
    """Drop provably dominated candidates, keep at most ``keep`` of the rest.

    ``cost_fn(cand)`` returns a tuple of costs of any length (lower is
    better on every axis); a candidate is dominated when another costs no
    more on every axis and differs on one.  Survivors come cheapest-first
    in lexicographic cost order, truncated to ``keep``."""
    costs = [(tuple(cost_fn(c)), c) for c in candidates]
    survivors = []
    for ca, a in costs:
        dominated = any(all(x <= y for x, y in zip(cb, ca)) and cb != ca
                        for cb, _ in costs)
        if not dominated:
            survivors.append((ca, a))
    survivors.sort(key=lambda t: t[0])
    return [c for _, c in survivors[:keep]]
