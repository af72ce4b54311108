"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``bench/configs/<name>.json``) and a traffic
mix (``bench/traffic/<name>.json``); a metric ``<family>[.<split>]`` is read
by ``bench/metrics/<family>.py`` (its ``read(run)``).  A later change adds a
configuration, a mix, a cell or a metric by adding files and entries:

- a configuration is its file: sizes, ``max_batch``, the ``check`` rows
  and limit, ``cpu_image_shape`` (the size the CPU tests run it at) and
  its layer table, a chain or a graph in ``bench/table.py``'s grammar
  (named tensors, ``add``, padded ``maxpool``).  Its ``"reference"`` key
  names its plain reference, a file under ``bench/reference/`` with
  ``forward`` and ``last_codes`` as ``bench/reference/forward.py`` has
  them (``check.reference``): the existing file, or a copy of its own;
- the CPU tests (``bench/test_bench_reference.py``) take every
  configuration ``BENCHMARK.json`` lists, so a new one is checked against
  the port's oracle, for live codes, against its bfloat16 control and
  against the port's cost report without an edit.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bm: dict, name: str) -> dict:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bm['workloads']]}")


def config_entry(bm: dict, name: str) -> dict:
    for c in bm["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bm: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(bm, name)["file"]).read_text())


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def load_traffic(name: str) -> dict:
    return json.loads(traffic_path(name).read_text())


def metrics_for(bm: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones without the trace, the per-layer ones with it."""
    group = bm["per_layer"] if trace else bm["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader_path(metric_name: str) -> Path:
    return BENCH / "metrics" / f"{metric_name.split('.')[0]}.py"


def reader(metric_name: str):
    """The ``read(run)`` of the metric's family."""
    family = metric_name.split(".")[0]
    return importlib.import_module(f"bench.metrics.{family}").read
