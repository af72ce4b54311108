"""EngineRegistry: named multi-model routing over compiled-graph engines
(counterpart of ``repro.serve.registry``).

One registry fronts many served models: ``register`` compiles a graph into
a ``CompiledGraphEngine`` under a name, ``submit``/``__call__`` route by
name, and ``reload`` hot-swaps a model atomically under in-flight requests
(the engine compiles the new plan while the old one keeps serving, then
swaps under the engine lock — queued old-model requests are flushed
through the old plan first; see ``CompiledGraphEngine.reload``).
"""
from __future__ import annotations

import difflib
import threading

from .engine import CompiledGraphEngine


class EngineRegistry:
    """Thread-safe name -> CompiledGraphEngine routing table.

    ``default_engine_kw`` (e.g. ``max_batch=16, report_cost=False``) seed
    every engine built by ``register(name, graph)``; per-call kwargs
    override them.
    """

    def __init__(self, **default_engine_kw):
        self._lock = threading.RLock()
        self._engines: dict[str, CompiledGraphEngine] = {}
        self._reserved: set[str] = set()       # names compiling right now
        self._default_kw = default_engine_kw
        self._router = None                    # see set_router / route

    # ----------------------------------------------------------- mutation

    def register(self, name: str, graph=None, *, engine=None,
                 **engine_kw) -> CompiledGraphEngine:
        """Serve ``graph`` (compiled here) or a pre-built ``engine`` as
        ``name``.  Re-registering a live name is an error — model swaps go
        through ``reload`` so in-flight requests are handled.

        Engines built here get ``metrics_labels={"model": name}`` (unless
        overridden), so a registry whose ``default_engine_kw`` carries a
        shared ``metrics_registry`` exports every model as distinct label
        sets of the same metric families.
        """
        if (graph is None) == (engine is None):
            raise ValueError("pass exactly one of graph= or engine=")
        if engine is not None and engine_kw:
            raise ValueError(
                f"engine_kw {sorted(engine_kw)} cannot apply to a pre-built "
                f"engine=; construct the engine with them instead")
        # reserve the name before the (expensive) compile: a duplicate
        # registration fails fast instead of paying for a discarded engine,
        # and two racing registrations can't both build one name
        with self._lock:
            if name in self._engines or name in self._reserved:
                raise ValueError(
                    f"model {name!r} is already registered; use "
                    f"reload({name!r}, graph) to hot-swap it")
            self._reserved.add(name)
        try:
            if engine is None:
                kw = {**self._default_kw, **engine_kw}
                kw.setdefault("metrics_labels", {"model": name})
                engine = CompiledGraphEngine(graph, **kw)
            with self._lock:
                self._engines[name] = engine
        finally:
            with self._lock:
                self._reserved.discard(name)
        return engine

    def unregister(self, name: str) -> CompiledGraphEngine:
        """Remove a model: admission closes first (a submit racing the
        unregister errors loudly rather than stranding its future on an
        orphaned engine), then pending requests are flushed."""
        with self._lock:
            eng = self.get(name)
            eng.close()
            del self._engines[name]
        eng.run_pending()      # drain outside the registry lock: one
        return eng             # model's teardown must not stall the others

    def reload(self, name: str, graph) -> CompiledGraphEngine:
        """Hot-swap ``name`` to serve ``graph`` (atomic per engine)."""
        eng = self.get(name)
        eng.reload(graph)
        return eng

    # ------------------------------------------------------------ routing

    def get(self, name: str) -> CompiledGraphEngine:
        with self._lock:
            try:
                return self._engines[name]
            except KeyError:
                hint = difflib.get_close_matches(name, self._engines, n=1)
                raise KeyError(
                    f"unknown model {name!r}; registered: "
                    f"{sorted(self._engines)}"
                    + (f" (did you mean {hint[0]!r}?)" if hint else "")
                ) from None

    def submit(self, name: str, x, **kw):
        return self.get(name).submit(x, **kw)

    def set_router(self, fn) -> None:
        """Install a routing policy for ``route()``: ``fn(engines, x) ->
        name`` picks which registered model serves an un-named request
        (``engines`` is a name -> engine snapshot).  ``None`` restores the
        default least-pending policy."""
        with self._lock:
            self._router = fn

    def route(self, x, **kw):
        """Submit ``x`` without naming a model: the installed router (or
        the default least-pending policy — fewest queued requests, ties
        broken by name for determinism) picks the engine.  Counts per-model
        routed traffic as ``serve_routed_total{model=...}`` in the chosen
        engine's registry.  Returns the ``GraphRequest`` future."""
        with self._lock:
            if not self._engines:
                raise KeyError("no models registered; nothing to route to")
            engines = dict(self._engines)
            router = self._router
        if router is not None:
            name = router(engines, x)
            if name not in engines:
                raise KeyError(
                    f"router chose unknown model {name!r}; registered: "
                    f"{sorted(engines)}")
        else:
            name = min(engines, key=lambda n: (engines[n].pending(), n))
        eng = engines[name]
        eng.metrics.counter(
            "serve_routed_total",
            help="requests sent to this model by registry routing",
            labels=eng._metric_labels).inc()
        return eng.submit(x, **kw)

    def __call__(self, name: str, x):
        return self.get(name)(x)

    def run_pending(self) -> int:
        """Flush every engine; returns total requests run."""
        with self._lock:
            engines = list(self._engines.values())
        return sum(eng.run_pending() for eng in engines)

    # ------------------------------------------------------- introspection

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._engines)

    def stats(self) -> dict:
        """Per-model latency/fusion telemetry snapshot (every model's dict
        comes from the same registry-backed ``latency_stats`` the engine
        and scheduler serve, so the three views can no longer diverge)."""
        with self._lock:
            engines = dict(self._engines)
        return {name: {**eng.latency_stats(),
                       "fused_counts": eng.fused_counts,
                       "pending": eng.pending()}
                for name, eng in engines.items()}

    def metrics_snapshot(self) -> dict:
        """Merged metrics snapshot across every engine's registry.

        With a shared ``metrics_registry`` all engines write one registry
        and this is just its snapshot; with per-engine (default) private
        registries the snapshots are merged series-wise, each engine's
        series tagged with its model label.
        """
        with self._lock:
            engines = dict(self._engines)
        seen, merged = set(), {}
        for eng in engines.values():
            if id(eng.metrics) in seen:
                continue
            seen.add(id(eng.metrics))
            for mname, fam in eng.metrics.snapshot().items():
                if mname not in merged:
                    merged[mname] = {**fam, "series": list(fam["series"])}
                else:
                    merged[mname]["series"].extend(fam["series"])
        return merged

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._engines

    def __len__(self) -> int:
        return len(self._engines)
