"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names against the port's zoo (CPU)."""
import json
import re
from pathlib import Path

import pytest

from bench import manifest

ROOT = Path(__file__).resolve().parent.parent
BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BM["end_to_end"] + BM["per_layer"]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _names():
    yield from (c["name"] for c in BM["configs"])
    for w in BM["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in METRICS)
    for c in BM["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_command():
    assert set(BM) == TOP_KEYS
    assert BM["command"][:1] == ["python3"] and len(BM["command"]) <= 32
    assert BM["paths"] == ["bench"]
    script = ROOT / BM["command"][1]
    assert script.is_file() and script.parent == ROOT / "bench"
    assert 1 <= BM["run_seconds"] <= 51 and int(BM["run_seconds"]) == \
        BM["run_seconds"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= ({"bound"} if metric in BM["end_to_end"] else {"layer", "moves"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in BM["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    assert manifest.reader_path(metric["name"]).is_file()


def test_names_are_unique():
    for group in (BM["configs"], BM["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BM["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads", [w["name"] for w in BM["workloads"]])
    reported = e2e[metric["moves"]].get("workloads", cells)
    assert set(cells) <= set(reported)


@pytest.mark.parametrize("cell", BM["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(cell):
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200
    entry = manifest.config_entry(BM, cell["config"])
    assert (ROOT / entry["file"]).is_file()
    assert entry["file"].startswith("bench/")
    assert manifest.traffic_path(cell["traffic"]).is_file()
    assert manifest.load_traffic(cell["traffic"])["loop"] in ("closed", "open")
    # every cell reports setup_s, one other end-to-end metric and one
    # per-layer metric
    e2e = manifest.metrics_for(BM, cell["name"], trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert manifest.metrics_for(BM, cell["name"], trace=True)


def test_every_config_is_used_and_its_file_matches():
    used = {w["config"] for w in BM["workloads"]}
    assert used == {c["name"] for c in BM["configs"]}
    files = [c["file"] for c in BM["configs"]]
    assert len(files) == len(set(files))
    for c in BM["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert (ROOT / cfg["reference"]).is_file()


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BM["workloads"])
    assert four <= max(1, len(BM["workloads"]) // 4)


def test_file_under_64_kib_and_run_time_fits():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # a full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    # 2 x 90 s of compile a cell and 1,200 s spare, within 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BM["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
