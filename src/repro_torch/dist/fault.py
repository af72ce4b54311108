"""Fault tolerance primitives: straggler watchdog, bounded restarts,
elastic mesh derivation (counterpart of ``repro.dist.fault``).

All host-side logic, so the same code runs on a laptop and under a
cluster process launcher.  ``elastic_mesh`` derives a ``Mesh``
(``dist.sharding``) from the devices present, or from the process
group's ranks under torchrun.
"""
from __future__ import annotations

import contextlib
import logging
import random
import statistics
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np


log = logging.getLogger("repro_torch.dist.fault")


class Watchdog:
    """Flags steps whose wall time exceeds ``threshold`` x the rolling median.

    ``floor_s`` guards the cold regime: until steps take at least that long,
    nothing is flagged (sub-millisecond smoke steps jitter by integer
    factors without being stragglers).

    ``step_end`` without a matching ``step_start`` is a no-op returning
    False (never a crash, never a bogus sample), and ``cancel()`` discards
    an in-flight measurement — call it when a step dies mid-flight so the
    exception-handling time can't pollute the rolling median.  The
    ``step(i)`` context manager wires both up: it cancels on exception and
    records on clean exit.
    """

    def __init__(self, threshold: float = 1.5, window: int = 16,
                 floor_s: float = 0.05):
        self.threshold = threshold
        self.window = window
        self.floor_s = floor_s
        self.durations: deque[float] = deque(maxlen=window)
        self.stragglers: list[int] = []
        self._t0: float | None = None

    def step_start(self) -> None:
        self._t0 = time.monotonic()

    def cancel(self) -> None:
        """Discard the in-flight measurement (step died mid-flight)."""
        self._t0 = None

    @contextlib.contextmanager
    def step(self, step: int):
        """``with wd.step(i): ...`` — start/end with exception-safe cancel."""
        self.step_start()
        try:
            yield self
        except BaseException:
            self.cancel()
            raise
        self.step_end(step)

    def step_end(self, step: int) -> bool:
        """Record the step duration; True if the step was a straggler.

        A missed ``step_start`` (e.g. an exception tore down the previous
        step and the caller's recovery path skipped straight to
        ``step_end``) is tolerated: nothing is recorded, False returned.
        """
        if self._t0 is None:
            return False
        dt = time.monotonic() - self._t0
        self._t0 = None
        flagged = False
        if self.durations:
            baseline = max(statistics.median(self.durations), self.floor_s)
            if dt > self.threshold * baseline:
                flagged = True
                self.stragglers.append(step)
                log.warning("step %d straggled: %.3fs vs %.3fs median",
                            step, dt, baseline)
        self.durations.append(dt)
        return flagged


@dataclass
class RestartPolicy:
    """Bounded-restart policy with capped exponential backoff.

    The delay before attempt *k* is ``min(backoff_s * backoff_mult**(k-1),
    max_backoff_s)``, optionally stretched by up to ``jitter`` (a fraction:
    0.25 means "up to 25% longer") so a fleet of restarting workers doesn't
    thunder back in lock-step.  Without the cap the old behaviour grew the
    delay unboundedly (``backoff *= mult`` forever) — a worker on its 30th
    restart would sleep for days.
    """
    max_restarts: int = 3
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    max_backoff_s: float = 60.0
    jitter: float = 0.0            # fraction of the delay added uniformly
    restartable: tuple = (RuntimeError, OSError)
    history: list[str] = field(default_factory=list)

    def delay_s(self, attempt: int) -> float:
        """Sleep before retrying after failed ``attempt`` (0-based)."""
        d = min(self.backoff_s * self.backoff_mult ** attempt,
                self.max_backoff_s)
        if self.jitter > 0:
            d *= 1.0 + random.uniform(0.0, self.jitter)
        return max(0.0, d)


def run_with_restarts(make_state, run, policy: RestartPolicy):
    """Run ``run(make_state())`` with up to ``policy.max_restarts`` retries.

    State is rebuilt from scratch (checkpoint resume lives inside
    ``make_state``) on every attempt — the crash-only design: no attempt to
    patch up a half-dead attempt's state.
    """
    for attempt in range(policy.max_restarts + 1):
        try:
            return run(make_state())
        except policy.restartable as e:          # noqa: PERF203
            policy.history.append(f"attempt {attempt}: {e!r}")
            if attempt == policy.max_restarts:
                log.error("restart budget exhausted after %d attempts",
                          attempt + 1)
                raise
            delay = policy.delay_s(attempt)
            log.warning("attempt %d failed (%r); restarting in %.1fs",
                        attempt, e, delay)
            if delay > 0:
                time.sleep(delay)


def elastic_mesh(prefer_model: int = 16, device=None):
    """Build a ("data", "model") ``Mesh`` from the devices actually present.

    The model axis is the largest divisor of the device count that is
    <= ``prefer_model``; everything else becomes data parallelism.
    Without a process group the devices are the CUDA devices present
    (``device=None`` or ``"cuda"``; raising without CUDA, as
    ``core.executor.resolve_device`` does), or the one named device
    (``"cpu"``, ``"cuda:1"``): a (1, 1) mesh.  On a one-device host this
    degenerates to (1, 1), so the same launcher runs everywhere.

    Under an initialised process group (``launch.mesh.torchrun_group``)
    the mesh comes from the group instead: one entry per rank, entry i
    rank i's device (``group_devices``), by the same ``prefer_model``
    rule."""
    import torch
    import torch.distributed as dist

    from .sharding import Mesh
    if dist.is_available() and dist.is_initialized():
        devices = group_devices(device)
    elif device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(device)]
    n = len(devices)
    model = 1
    for cand in range(min(prefer_model, n), 0, -1):
        if n % cand == 0:
            model = cand
            break
    return Mesh(np.array(devices, dtype=object).reshape(n // model, model),
                ("data", "model"))


def group_devices(device=None) -> list:
    """Each rank's device in the initialised process group, in rank order:
    ``cpu`` for every rank where ``device`` names the CPU, else rank r's
    ``cuda:(r mod LOCAL_WORLD_SIZE)`` (torchrun numbers a host's ranks
    together, so that is ``cuda:LOCAL_RANK`` on each host; the local
    world defaults to the CUDA devices present)."""
    import os

    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * world
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a mesh of "
                           "CPU ranks")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", torch.cuda.device_count()))
    return [torch.device("cuda", r % local) for r in range(world)]
