"""The comparison's two readings at each cell's own size, on the card:
a sound run of the timed path within the limit, the bfloat16 control
beyond it.  Skips without a CUDA card; on the card:

    PYTHONPATH=src python -m pytest -q bench/test_bench_card.py
"""
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_a_sound_run_passes(cuda, workload):
    from bench import harness, manifest
    from bench.calibrate import control_reading
    bm = manifest.load()
    cfg = manifest.load_config(bm, manifest.cell(bm, workload)["config"])
    limit = cfg["check"]["logit_rel_err_limit"]
    for seed in (41, 42, 2**31 + 43):
        assert control_reading(cfg, seed, cuda) > limit
    result, _ = harness.run_cell(workload, 44, 1.0, False, bm=bm)
    assert result["correct"] is True
    assert result["checks"]["logit_rel_err"]["value"] <= limit
