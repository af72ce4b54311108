"""Render a metrics snapshot as a table (a copy of
``repro.obs.report``, stdlib only).

    python -m repro_torch.obs.report METRICS_snapshot.json
    python -m repro_torch.obs.report --url http://localhost:9100/metrics.json
    ... | python -m repro_torch.obs.report -          # stdin

Input is the registry's JSON snapshot schema (``MetricsRegistry.to_json``,
the ``/metrics.json`` endpoint, the CI ``METRICS_snapshot.json``
artifact).  Counters/gauges print one row per label set; histograms print
count / mean / p50 / p90 / p99.  ``--filter SUBSTR`` narrows by metric
name.
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["render", "main"]


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return "-"
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != v:                                   # nan
            return "nan"
        if v and (abs(v) >= 1e6 or abs(v) < 1e-3):
            return f"{v:.4g}"
        return f"{v:,.3f}".rstrip("0").rstrip(".")
    return f"{v:,}"


def render(snapshot: dict, name_filter: str = "") -> str:
    """Snapshot dict -> aligned text table (one row per series)."""
    rows = []
    for name in sorted(snapshot):
        if name_filter and name_filter not in name:
            continue
        fam = snapshot[name]
        unit = f" [{fam['unit']}]" if fam.get("unit") else ""
        for s in fam.get("series", []):
            labels = _fmt_labels(s.get("labels", {}))
            if fam["type"] == "histogram":
                value = (f"count={_fmt(s.get('count', 0))} "
                         f"sum={_fmt(s.get('sum', 0.0))} "
                         f"p50={_fmt(s.get('p50'))} "
                         f"p90={_fmt(s.get('p90'))} "
                         f"p99={_fmt(s.get('p99'))}")
            else:
                value = _fmt(s.get("value"))
            rows.append((name + unit, fam["type"], labels, value))
    if not rows:
        return "(no metrics matched)"
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    w2 = min(48, max(len(r[2]) for r in rows))
    head = (f"{'metric':{w0}s} {'type':{w1}s} {'labels':{w2}s} value")
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(f"{r[0]:{w0}s} {r[1]:{w1}s} {r[2][:w2]:{w2}s} {r[3]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a metrics snapshot (JSON) as a table.")
    ap.add_argument("path", nargs="?",
                    help="snapshot JSON path ('-' for stdin)")
    ap.add_argument("--url", metavar="URL",
                    help="fetch the snapshot from a /metrics.json endpoint")
    ap.add_argument("--filter", default="",
                    help="only metrics whose name contains this substring")
    args = ap.parse_args(argv)

    if (args.path is None) == (args.url is None):
        ap.error("pass exactly one of PATH or --url")
    if args.url:
        from urllib.request import urlopen
        with urlopen(args.url, timeout=10) as resp:   # noqa: S310 (CLI arg)
            snapshot = json.loads(resp.read().decode("utf-8"))
    elif args.path == "-":
        snapshot = json.load(sys.stdin)
    else:
        with open(args.path, encoding="utf-8") as f:
            snapshot = json.load(f)
    print(render(snapshot, args.filter))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
