"""Run one cell of the benchmark on the CUDA card it is started on.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, with no install: ``src/`` goes on the path
here.  The last line of standard output is the result (one JSON object);
the numbers compared with the reference, each beside its limit, are the
last lines of standard error.  Without a CUDA card, without the port's
sources, or with JAX loaded once the window has closed, it exits non-zero
and prints no result.  The kernel library is built once into the port's
fixed ``src/repro_torch/kernels/build/`` and loaded from there after.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def process_start() -> float:
    """This process's start on the monotonic clock (Linux), so set-up
    counts the interpreter's own start; else now."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / ticks
        return time.monotonic() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: src/repro_torch is not in this checkout",
              file=sys.stderr)
        return 2
    # the kernel library's fixed place in the checkout, built once
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        ROOT / "src" / "repro_torch" / "kernels" / "build")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "ext")
    # the checkout's root and src/ on the path, and not bench/ itself,
    # whose module names must not shadow others
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != here
        and p not in (str(ROOT), str(ROOT / "src"))]

    import torch

    from bench import harness, manifest
    bm = manifest.load(ROOT)
    chips = manifest.cell(bm, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.empty(0, device="cuda")     # the CUDA context, among the imports
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=t_start, bm=bm)
    found = forbidden_modules()
    if found:
        print(f"bench: loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    info.append(f"card {power_limit()}")
    for line in info:
        print(line)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
