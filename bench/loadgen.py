"""The one traffic generator: a closed loop or an open loop, set by a mix's
data file (``bench/traffic/*.json``, key ``loop``).

* ``closed``: one client scoring batches back to back through
  ``CompiledGraphEngine.__call__`` (pipelined, one sync a call).  A call
  holds ``slots_per_call`` slots, the last filled to ``last_slot_fill`` of
  ``max_batch``, drawn from the seeded image pool; ``call_batches``
  distinct batches take turns.
* ``open``: independent clients, one image a request, submitted through a
  ``ServeScheduler`` at ``rate_per_s`` whatever the server does.  The gaps
  between arrivals are the exponential distribution's quantiles, scaled
  to the window and shuffled by the seed: every seed sends the same number
  of requests, with the same set of gaps, in another order.  A request is
  timed from when it was due to its result; a refused one never completes.

The benchmark's own ``record_function`` ranges (``bench.call``,
``bench.submit``, ``bench.wait``) label what the host was doing in a
trace.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function


def rows_per_call(traffic: dict, max_batch: int) -> int:
    last = max(1, round(traffic["last_slot_fill"] * max_batch))
    return (traffic["slots_per_call"] - 1) * max_batch + last


def arrival_offsets(rate: float, seconds: float, rng) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate * seconds)``
    requests: the exponential quantiles as gaps, summing to ``seconds``,
    in a seeded order."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    rng.shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class ClosedLoop:
    def __init__(self, engine, traffic: dict, pool: torch.Tensor, rng):
        self.engine = engine
        self.traffic = traffic
        self.rows = rows_per_call(traffic, engine.max_batch)
        self.last_slot_start = ((traffic["slots_per_call"] - 1)
                                * engine.max_batch)
        n = pool.shape[0]
        self.batch_index = [np.resize(rng.permutation(n), self.rows)
                            for _ in range(traffic["call_batches"])]
        self.batches = [pool[torch.from_numpy(i)] for i in self.batch_index]

    def warm(self) -> None:
        """Every call batch once (the capture), then the mix for
        ``warm_seconds``."""
        for batch in self.batches:
            self.engine(batch)
        self.run(self.traffic["warm_seconds"])

    def run(self, seconds: float) -> dict:
        """Calls back to back while the window is open; the window closes
        when the last call started in it has returned."""
        calls = []
        replays0 = self.engine.plan.replay_count
        t0 = time.monotonic()
        end = t0 + seconds
        while time.monotonic() < end:
            b = len(calls) % len(self.batches)
            with record_function("bench.call"):
                out = self.engine(self.batches[b])
            calls.append((b, out))
        t1 = time.monotonic()
        n = len(calls) * self.rows
        return {"t0": t0, "t1": t1, "attempted": n, "completed": n,
                "failed": 0, "lost": 0, "calls": calls,
                "replays": self.engine.plan.replay_count - replays0}

    def close(self) -> None:
        pass

    def sample(self, record: dict, n: int, rng) -> tuple:
        """(pool indices, served rows) of ``n`` rows the window served:
        half from the last, padded slot of the calls, half from anywhere."""
        calls = record["calls"]
        last = self.rows - self.last_slot_start
        n_last = min(n // 2, len(calls) * last)
        picks = [(int(rng.integers(len(calls))),
                  self.last_slot_start + int(rng.integers(last)))
                 for _ in range(n_last)]
        flat = rng.choice(len(calls) * self.rows,
                          size=min(n - n_last, len(calls) * self.rows),
                          replace=False)
        picks += [divmod(int(f), self.rows) for f in flat]
        index = np.array([self.batch_index[calls[c][0]][j] for c, j in picks])
        rows = np.stack([calls[c][1][j] for c, j in picks])
        return index, rows


class OpenLoop:
    def __init__(self, engine, traffic: dict, pool: torch.Tensor, rng):
        from repro_torch.serve.scheduler import ServeScheduler
        self.engine = engine
        self.traffic = traffic
        self.pool = pool
        self.rng = rng
        self.sched = ServeScheduler(engine, window_ms=traffic["window_ms"],
                                    max_queue=traffic["max_queue"],
                                    block=False).start()

    def warm(self) -> None:
        """Fill whole slots once (the capture), then run the mix."""
        n = min(2 * self.engine.max_batch, self.traffic["max_queue"])
        reqs = [self.sched.submit(self.pool[i % self.pool.shape[0]])
                for i in range(n)]
        for r in reqs:
            r.wait(timeout=600)
        self.run(self.traffic["warm_seconds"])

    def run(self, seconds: float) -> dict:
        from repro_torch.serve.scheduler import QueueFull
        tr = self.traffic
        offsets = arrival_offsets(tr["rate_per_s"], seconds, self.rng)
        index = self.rng.integers(self.pool.shape[0], size=len(offsets))
        reqs, late = [], np.empty(len(offsets))
        replays0 = self.engine.plan.replay_count
        t0 = time.monotonic()
        for i, off in enumerate(offsets):
            wait = t0 + off - time.monotonic()
            if wait > 0:
                with record_function("bench.wait"):
                    time.sleep(wait)
            late[i] = time.monotonic() - (t0 + off)
            try:
                with record_function("bench.submit"):
                    reqs.append(self.sched.submit(
                        self.pool[index[i]], deadline_ms=tr["deadline_ms"]))
            except QueueFull:
                reqs.append(None)
        give_up = t0 + offsets[-1] + tr["drain_seconds"]
        latency, waits, lost = [], [], 0
        for off, r in zip(offsets, reqs):
            if r is not None:
                try:
                    r.wait(timeout=max(0.0, give_up - time.monotonic()))
                except Exception:   # timed out, or the flush's error
                    lost += 1
            if r is None or r.completed is None or r.error is not None:
                latency.append(math.inf)
                continue
            latency.append((r.completed - (t0 + off)) * 1e3)
            waits.append((r.started - (t0 + off)) * 1e3)
        t1 = time.monotonic()
        refused = sum(r is None for r in reqs)
        done = [i for i, r in enumerate(reqs)
                if r is not None and r.completed is not None
                and r.error is None]
        return {"t0": t0, "t1": t1, "attempted": len(reqs),
                "completed": len(done), "failed": len(reqs) - len(done),
                "refused": refused, "lost": lost, "latency_ms": latency,
                "queue_wait_ms": waits, "late_s": late, "index": index,
                "requests": reqs, "done": done,
                "replays": self.engine.plan.replay_count - replays0}

    def close(self) -> None:
        self.sched.stop()

    def sample(self, record: dict, n: int, rng) -> tuple:
        done = record["done"]
        picks = rng.choice(len(done), size=min(n, len(done)), replace=False)
        index = np.array([record["index"][done[p]] for p in picks])
        rows = np.stack([record["requests"][done[p]].result for p in picks])
        return index, rows


LOOPS = {"closed": ClosedLoop, "open": OpenLoop}
