"""The traffic generator's seeded schedules, and the isolation of the
benchmark from JAX and of the reference from the port (CPU)."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import loadgen, manifest, seeded

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


class _Engine:
    """What the closed loop reads of an engine at construction."""
    max_batch = 32


def _schedule(seed, rate=1500.0, seconds=10.0):
    rng = seeded.traffic_rng(seed)
    return loadgen.arrival_offsets(rate, seconds, rng), rng.integers(512,
                                                                     size=8)


@pytest.mark.parametrize("seed", (0, 5, 2**31 + 3, -7))
def test_a_seed_gives_the_same_arrivals_every_time(seed):
    (a, ia), (b, ib) = _schedule(seed), _schedule(seed)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ia, ib)
    assert len(a) == 15000 and a[0] == 0.0 and a[-1] < 10.0
    assert np.all(np.diff(a) > 0)


def test_seeds_send_the_same_gaps_in_another_order():
    a, _ = _schedule(1)
    b, _ = _schedule(2)
    ga, gb = np.diff(np.append(a, 10.0)), np.diff(np.append(b, 10.0))
    np.testing.assert_allclose(np.sort(ga), np.sort(gb), rtol=0, atol=1e-12)
    assert not np.allclose(ga, gb)
    assert abs(ga.mean() - 1 / 1500) < 1e-9


@pytest.mark.parametrize("name", ("offline",))
def test_a_seed_gives_the_same_call_batches_every_time(name):
    traffic = manifest.load_traffic(name)
    pool = torch.arange(512, dtype=torch.float32)[:, None]
    loops = [loadgen.ClosedLoop(_Engine(), traffic, pool,
                                seeded.traffic_rng(9)) for _ in range(2)]
    rows = loadgen.rows_per_call(traffic, 32)
    assert rows == 15 * 32 + 20 == loops[0].rows
    for x, y in zip(loops[0].batches, loops[1].batches):
        assert torch.equal(x, y) and x.shape == (rows, 1)
        # distinct images within a call
        assert len(torch.unique(x)) == rows
    other = loadgen.ClosedLoop(_Engine(), traffic, pool,
                               seeded.traffic_rng(10))
    assert not torch.equal(other.batches[0], loops[0].batches[0])


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_under_bench_imports_jax_or_the_jax_package(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert "repro_torch" not in names and "bench" not in names


def _run(cwd: Path, *args):
    return subprocess.run(
        [sys.executable, "bench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = _run(ROOT, "--workload", "cnv-w2a2.offline", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_in_a_tree_of_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "cnv-w2a2.offline", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from bench import run
    import repro_torch  # noqa: F401  (the port's name starts with "repro")
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "repro.core", object())
    found = run.forbidden_modules()
    assert {"jax", "repro"} <= set(found) and "repro_torch" not in found


def test_traffic_files_are_data_the_generator_reads():
    for path in sorted((BENCH / "traffic").glob("*.json")):
        traffic = json.loads(path.read_text())
        assert traffic["loop"] in loadgen.LOOPS
