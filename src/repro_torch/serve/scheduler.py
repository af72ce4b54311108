"""ServeScheduler: the submit -> future serving loop over an engine
(counterpart of ``repro.serve.scheduler``, stdlib only).

Replaces the caller-driven ``run_pending()`` loop as the primary serving
path: callers ``submit()`` and get a ``GraphRequest`` future back; a
background thread flushes the engine whenever

  * a full ``max_batch`` slot has accumulated,
  * the oldest queued request has waited ``window_ms`` (the flush window),
  * or a request's deadline is within ``flush_margin_ms`` of now
    (deadline-aware early flush).

Each flush names the trigger that fired (``full`` / ``window`` /
``deadline``, or ``stop`` for the final drain) on its flush span and in
the engine's ``serve_scheduler_flushes_total{reason}``.

Backpressure is a bounded queue: ``submit`` blocks (or raises
``QueueFull`` with ``block=False``) while ``max_queue`` requests are
already waiting, so a slow model sheds load at the front door instead of
growing an unbounded backlog.  All flushes go through the engine's
pipelined dispatch, and the engine's rolling p50/p99 telemetry is logged
at each flush and surfaced by ``stats()``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger("repro_torch.serve")

_POLL_S = 0.05          # upper bound on condition waits: keeps the loop
                        # responsive to stop() and to racing submits


class QueueFull(RuntimeError):
    """Non-blocking submit found the bounded queue at capacity."""


class ServeScheduler:
    """Background flush loop + bounded admission over a CompiledGraphEngine.

    Usable as a context manager::

        with ServeScheduler(engine, window_ms=5.0) as sched:
            req = sched.submit(x, deadline_ms=50.0)
            y = req.wait(timeout=10.0)
    """

    def __init__(self, engine, *, window_ms: float = 5.0,
                 max_queue: int = 256, block: bool = True,
                 flush_margin_ms: Optional[float] = None):
        self.engine = engine
        self.window_ms = float(window_ms)
        self.max_queue = int(max_queue)
        self.block = block
        # a deadline is met only if dispatch *and* compute land before it;
        # flush once the slack shrinks to the margin (default: the window)
        self.flush_margin_ms = (self.window_ms if flush_margin_ms is None
                                else float(flush_margin_ms))
        self._cv = threading.Condition()
        self._running = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.n_submitted = 0
        self.n_rejected = 0
        # scheduler metrics live in the engine's registry under the same
        # labels, so one snapshot carries the whole serving path
        m, lbl = engine.metrics, engine._metric_labels
        self._obs_on = engine._obs_on
        self._m_submitted = m.counter(
            "serve_scheduler_submitted_total",
            help="requests admitted through the scheduler", labels=lbl)
        self._m_rejected = m.counter(
            "serve_scheduler_rejected_total",
            help="submits rejected by backpressure (QueueFull/timeout)",
            labels=lbl)
        self._m_wait = m.histogram(
            "serve_admission_wait_ms", unit="ms",
            help="time spent blocked on the bounded queue before admission",
            window=512, labels=lbl)
        # post-flush hooks: fn(n_flushed) after every non-empty flush.  The
        # splitmerge front and routing layers use these to observe drain
        # progress without polling; hook errors are logged, never raised
        # into the flush loop.
        self._flush_hooks: list = []

    def add_flush_hook(self, fn) -> None:
        """Register ``fn(n_flushed)`` to run after each non-empty flush."""
        with self._cv:
            self._flush_hooks.append(fn)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ServeScheduler":
        with self._cv:
            if self._running:
                return self
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError(
                    "previous scheduler thread has not exited; refusing to "
                    "start a second flush loop on the same engine")
            self._running = True
            self._stopped = False
            self._thread = threading.Thread(
                target=self._loop, name="serve-scheduler", daemon=True)
            self._thread.start()
        return self

    def stop(self, *, flush: bool = True) -> None:
        """Stop the loop; by default drain whatever is still queued.

        Admission closes first (submits serialize on the same condition
        variable, so anything admitted before the flag flips is covered by
        the final drain; anything after raises) — a producer racing
        shutdown gets a loud error, never a future that silently hangs.
        """
        with self._cv:
            self._running = False
            self._stopped = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=60)
            if t.is_alive():
                # a hung flush (stuck device call): keep the handle so a
                # restart can't spawn a second loop, and skip the final
                # drain — it would race the zombie's run_pending
                log.error("serve-scheduler thread did not exit within 60s; "
                          "skipping final flush")
                return
            self._thread = None
        if flush:
            self._flush(reason="stop")

    def __enter__(self) -> "ServeScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- submit

    def submit(self, x, *, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None):
        """Admit one sample; returns its ``GraphRequest`` future.

        Blocks while the bounded queue is full (``timeout`` caps the wait);
        with ``block=False`` a full queue raises ``QueueFull`` immediately.
        """
        # monotonic throughout: a wall-clock (NTP) step must never expire
        # every admission timeout at once or record a negative wait
        t_enter = time.monotonic()
        give_up = None if timeout is None else t_enter + timeout
        waited = False
        try:
            with self._cv:
                if self._stopped:
                    raise RuntimeError(
                        "scheduler is stopped; start() it (or run the "
                        "engine's run_pending loop) before submitting")
                while self.engine.pending() >= self.max_queue:
                    if not self.block:
                        self.n_rejected += 1
                        raise QueueFull(
                            f"serve queue at capacity ({self.max_queue})")
                    remaining = (None if give_up is None
                                 else give_up - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        self.n_rejected += 1
                        raise QueueFull(
                            f"timed out after {timeout}s waiting for "
                            f"queue space")
                    waited = True
                    self._cv.wait(_POLL_S if remaining is None
                                  else min(remaining, _POLL_S))
                    if self._stopped:  # woken by shutdown, not queue space
                        raise RuntimeError(
                            "scheduler stopped while waiting for queue "
                            "space")
                r = self.engine.submit(x, deadline_ms=deadline_ms)
                self.n_submitted += 1
                self._cv.notify_all()          # wake the flush loop
        except QueueFull:
            if self._obs_on:
                self._m_rejected.inc()
            raise
        if self._obs_on:
            self._m_submitted.inc()
            if waited:                 # only admission *waits* are observed
                self._m_wait.observe((time.monotonic() - t_enter) * 1e3)
        return r

    # --------------------------------------------------------- flush loop

    def _poll(self) -> tuple[Optional[str], Optional[float], bool]:
        """(the trigger that fired, or None; seconds until the next
        trigger; full slots only?).

        The trigger is ``"full"`` (a whole slot is queued), ``"window"``
        (the oldest request has waited ``window_ms``) or ``"deadline"`` (a
        deadline is within ``flush_margin_ms``); where a time trigger is
        due it names the flush, whichever came due first.  Reads the
        engine's ``flush_signals()`` snapshot rather than its queue
        internals.  When only the full-slot trigger fired, the partial tail
        slot is left queued — a request submitted a millisecond ago keeps
        batching until its own window/deadline is due instead of riding
        out in a mostly-padded slot.
        """
        eng = self.engine
        pending, oldest, deadline = eng.flush_signals()
        if not pending:
            return None, None, False
        # same monotonic clock the engine stamps submitted/deadline with
        now = time.monotonic()
        t_next, why = oldest + self.window_ms / 1e3, "window"
        if deadline is not None:
            t_due = deadline - self.flush_margin_ms / 1e3
            if t_due < t_next:
                t_next, why = t_due, "deadline"
        if now >= t_next:
            return why, 0.0, False
        if pending >= eng.max_batch:           # a full slot never waits
            return "full", 0.0, True
        return None, t_next - now, False

    def _flush(self, *, only_full_slots: bool = False,
               reason: Optional[str] = None) -> int:
        n = self.engine.run_pending(only_full_slots=only_full_slots,
                                    reason=reason)
        if n:
            with self._cv:
                self._cv.notify_all()      # queue space freed: wake waiters
                hooks = list(self._flush_hooks)
            for fn in hooks:
                try:
                    fn(n)
                except Exception:
                    log.exception("flush hook failed")
        return n

    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    return
            reason, delay, full_only = self._poll()
            if reason is not None:
                try:
                    self._flush(only_full_slots=full_only, reason=reason)
                except Exception:          # requests carry their own error
                    log.exception("serve flush failed")
                continue
            with self._cv:
                if not self._running:
                    return
                self._cv.wait(_POLL_S if delay is None
                              else max(1e-4, min(delay, _POLL_S)))

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Scheduler counters merged over the engine's registry-backed
        telemetry (``submitted``/``rejected`` are lifetime totals; the
        explicit ``*_total`` aliases match the exported counter names)."""
        s = dict(self.engine.latency_stats())
        s.update(submitted=self.n_submitted, rejected=self.n_rejected,
                 submitted_total=self.n_submitted,
                 rejected_total=self.n_rejected,
                 admission_wait_p99_ms=self._m_wait.percentile(99),
                 pending=self.engine.pending(), running=self._running,
                 window_ms=self.window_ms, max_queue=self.max_queue)
        return s
