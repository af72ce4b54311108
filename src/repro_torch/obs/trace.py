"""Request tracing (a copy of ``repro.obs.trace``, stdlib only):

A ``Span`` is a named time interval with attributes; a ``Tracer`` mints
span/trace ids and hands finished spans to a **sink** (any callable taking
the span record dict — ``JsonlSink`` appends one JSON object per line,
``ListSink`` collects in memory for tests).

Two ways to produce spans:

  * live, via the context-manager API (monotonic clock)::

        with tracer.span("flush", queue_depth=12) as sp:
            with tracer.span("dispatch", parent=sp):
                ...

  * retroactively, via ``emit(name, t0, t1, ...)`` — the serving engine
    already timestamps every request (submit/dispatch/complete), so at
    flush time it emits the submit->queue->dispatch->sync->complete spans
    from those timestamps without adding clock reads to the hot path.

Disabled tracing is **free**: instrumented code guards on
``tracer is not None and tracer.enabled`` (the serving engine folds this
into one attribute check), so the submit hot path performs zero
allocations attributable to this module — proven by the tracemalloc test
in tests/test_torch_obs.py.  Sinks are locked; span records are plain dicts::

    {"name", "trace", "span", "parent", "t0", "t1", "dur_ms", ...attrs}
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Callable, Optional

__all__ = ["Span", "Tracer", "JsonlSink", "ListSink"]

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _new_id() -> str:
    with _ids_lock:
        return f"{next(_ids):08x}"


class Span:
    """One named interval.  Ends (and reaches the sink) on ``end()`` or
    context-manager exit; attributes are set at creation or via ``set``."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], t0: float, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, t1: Optional[float] = None) -> None:
        if self.t1 is not None:        # idempotent: first end wins
            return
        self.t1 = self._tracer.clock() if t1 is None else t1
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def to_record(self) -> dict:
        rec = {"name": self.name, "trace": self.trace_id,
               "span": self.span_id, "parent": self.parent_id,
               "t0": self.t0, "t1": self.t1,
               "dur_ms": None if self.t1 is None
               else (self.t1 - self.t0) * 1e3}
        rec.update(self.attrs)
        return rec


class Tracer:
    """Mints spans, stamps ids, forwards finished spans to the sink.

    ``enabled=False`` turns every guard off — instrumented code must check
    ``tracer.enabled`` (or hold ``tracer=None``) before touching the span
    API, which is what keeps disabled tracing allocation-free.
    ``clock`` defaults to ``time.monotonic``; the serving engine emits
    retro spans with explicit ``time.monotonic()`` timestamps (all of a
    request's spans then share the live-span clock, and a wall-clock step
    can never produce a negative span duration).
    """

    def __init__(self, sink: Optional[Callable[[dict], None]] = None,
                 *, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.sink = sink
        self.enabled = enabled
        self.clock = clock
        self.n_spans = 0

    # ------------------------------------------------------------ spans

    def new_trace_id(self) -> str:
        return _new_id()

    def span(self, name: str, *, parent: Optional[Span] = None,
             trace_id: Optional[str] = None, **attrs) -> Span:
        """Start a live span now (context manager; ends on exit)."""
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        else:
            trace_id = trace_id or _new_id()
            parent_id = None
        return Span(self, name, trace_id, parent_id, self.clock(), attrs)

    def emit(self, name: str, t0: float, t1: float, *,
             trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, **attrs) -> str:
        """Record a completed interval from explicit timestamps; returns
        the new span id (to parent further retro spans under it)."""
        sp = Span(self, name, trace_id or _new_id(), parent_id, t0, attrs)
        sp.end(t1)
        return sp.span_id

    def _record(self, span: Span) -> None:
        self.n_spans += 1
        if self.sink is not None:
            self.sink(span.to_record())


class JsonlSink:
    """Appends one JSON object per span to ``path`` (locked, line-atomic).

    The file handle stays open between spans; ``close()`` (or context
    exit) flushes.  Floats land as plain JSON numbers — downstream tools
    (``jq``, pandas) read the file directly.
    """

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def __call__(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._fh is None:
                raise ValueError(f"JsonlSink({self.path!r}) is closed")
            self._fh.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ListSink(list):
    """In-memory sink (tests): a list of span record dicts."""

    def __call__(self, record: dict) -> None:
        self.append(record)
