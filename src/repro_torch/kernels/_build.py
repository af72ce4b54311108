"""Build and load the CUDA kernels of ``csrc/`` at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into an object for ``sm_90a``, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library's name carries a hash of the flags, the sources
and the headers they share (``csrc/*.cuh``), so an edited source or
header is rebuilt and an unchanged tree is loaded as built.
The build goes to ``kernels/build/`` beside this file (listed in
``.gitignore``), or to ``$REPRO_TORCH_BUILD_DIR``.

The flags keep nvcc's IEEE defaults (``-prec-div=true``, ``-ftz=false``):
fast math would break the correctly rounded division and flush
subnormals that the reference keeps.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# the card the host plans size their grids and shared memory for (H100 SXM)
SMS = 132                      # streaming multiprocessors
SMEM_MAX = 232_448             # shared memory one block may use
# -Xptxas -v only adds the register / shared-memory report to the build log
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C interface: (name, argument types); each entry returns cudaError_t
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the epilogue's tail of B1 / B2 (CUDA cores) / B5 / B6: body (epi), x
# divisor (in_div), its exact reciprocal (in_mul), the staging mode of x,
# the IntRequant ints (rq, a host pointer or null) and the output scale
_STAGE = [_I, _F, _F, _I, _P, _F]
SIGNATURES = {
    # B4: x, s, z, out, the plan's geometry (a long long array), s_stride,
    # z_stride, lo, hi, mode, codes
    "qdq_launch": [_P] * 5 + [_I, _I, _F, _F, _I, _I, _P],
    # B1 / B2 on the CUDA cores: x, w, s, bias, out, the plan's geometry (an
    # int array), s_stride, packed, then the epilogue tail, then a conv's
    # geometry (an int array, or null) before the stream
    "qmm_launch": [_P] * 6 + [_I, _I] + _STAGE + [_P, _P],
    # B2 on the int8 tensor cores: M, K, N, s_stride, epi; in_div, in_mul;
    # rq; out_mul; a conv's geometry (an int array, or null)
    "qmm_i8_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _F,
                      _P, _P],
    # B5 / B6: x, w, s, bias, [qs, qz,] out, the plan's geometry (an int
    # array), ..., then the epilogue tail
    "gqmm_launch": [_P] * 6 + [_LL] * 4 + [_I, _I] + _STAGE + [_P],
    "dw_launch": [_P] * 8 + [_I, _I, _I, _F, _F, _I] + _STAGE + [_P],
    # q, k, v, out; B, H, KV, Sq, Sk, hd, dtype, causal; scale; 12 strides
    "fa_launch": [_P] * 4 + [_I] * 8 + [_F] + [_LL] * 12 + [_P],
}

# set by ``load`` on the build that actually ran nvcc (chip_smoke prints it)
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "build"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags and of every source and header: an edited shared
    header (``*.cuh``) rebuilds the library as an edited source does."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link; returns the library path
    (an up-to-date existing build is reused)."""
    out_dir = build_dir()
    lib = out_dir / f"librepro_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            for _, _, q in procs:
                q.kill()
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        objs.append(str(obj))
    tmp = out_dir / f"lib_{tag}.so"
    link = subprocess.run([nvcc, ARCH, "-shared", *objs, "-o", str(tmp)],
                          capture_output=True, text=True)
    for o in objs:
        Path(o).unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)                  # atomic: racing builders agree
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(logs),
                      library=str(lib))
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
