"""Shared set-up of the example tests (``test_torch_examples*.py``): the
examples of both packages are loaded from their files, by path, with the
loader and the stdout capture of ``chip_smoke.py``, whose phase 15 runs
the same examples on the card."""
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
        sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["chip_smoke"])
    return sys.modules["chip_smoke"]


load = _chip_smoke().load_file          # a module from a path relative to the repo root
stdout_of = _chip_smoke().stdout_of     # (the lines fn(*args) printed, its return value)
