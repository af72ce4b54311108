"""Tuning-key and block-selection value types.

Counterpart of ``repro.tune.config``.  ``KernelSig`` is the
content-addressed identity of one kernel-shaped workload: (kernel family,
shape bucket, carrier bits, requant path, backend, interpret) as in the
reference, plus two fields the Hopper plans need: ``body``, the body B1 /
B2 run (two matmuls of equal shape may run different bodies: MobileNet's
first conv on IMAD, its pointwise convs on the int8 tensor cores), and
``geometry``, the plan inputs the (m, n, k) fields do not determine
(B6's plan depends on the whole conv, not on rows × taps).  Two segments
with equal signatures call the same wrapper with the same plan inputs, so
they share one cache entry and one search.

``BlockConfig`` is what the autotuner answers with: the block tuple a
lowering rule threads into the kernel wrapper (its launch plan's
``override``), and where it came from: ``default`` (the heuristic plan's
own choices: no cache entry, no search), ``cached`` (read from the tune
cache) or ``search`` (measured in this compile).  It is recorded per
segment in ``Segment.meta["blocks"]`` and aggregated by
``CompiledPlan.tuning_stats``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Optional


def bucket_rows(m: Optional[int]) -> int:
    """Shape bucket for the leading (batch·spatial) dim: next power of two.

    The M dim varies per serving batch while K/N are weight-fixed, so M is
    bucketed (an M=900 and an M=1024 workload share a tiling) and K/N stay
    exact.  Unknown rows (symbolic shapes) bucket to 1.
    """
    if not m or m <= 1:
        return 1
    return 1 << (int(m) - 1).bit_length()


@dataclass(frozen=True)
class KernelSig:
    """Content-addressed identity of one tunable kernel workload.

    family   — "matmul" (B1 / B2, conv via im2col included), "grouped"
               (B5), "depthwise" (B6), "qdq" (B4)
    m        — bucketed leading rows (``bucket_rows``)
    n, k     — exact weight dims (N out-cols; K contraction / taps; k=0 for
               the elementwise qdq family)
    groups   — G for the grouped family, else 1
    bits     — integer carrier width: 8 dense, 4 packed, 0 carrier-free
    requant  — epilogue path, "int32" | "fp32" | "none"
    backend  — "cuda:<device name>" or "cpu": where the timing ran, so an
               entry timed on another card never answers for this one
    interpret — True where the plain twins ran (the CPU)
    body     — the matmul family's body (``kernels.quant_matmul.b2_body``:
               "f32", "imad", "int8_mma"), "" for the other families
    geometry — the plan inputs that m / n / k do not determine, as ints
               (depthwise: H, W, OH, OW, kh, kw, strides, dilations,
               pads); empty where there are none
    """
    family: str
    m: int
    n: int
    k: int
    groups: int = 1
    bits: int = 8
    requant: str = "fp32"
    backend: str = "cpu"
    interpret: bool = True
    body: str = ""
    geometry: tuple = ()

    def canonical_json(self) -> str:
        """Deterministic serialization — the cache-key basis."""
        return json.dumps(asdict(self), sort_keys=True)


@dataclass(frozen=True)
class BlockConfig:
    """One selected launch geometry and its provenance.

    ``blocks`` is the target launch plan's ``override``: ``(tile, split,
    stages)`` for B1 / B2 on the CUDA cores, ``(BM, BN, BK)`` (one fixed
    point) for B2's int8 body, ``(BN, KS)`` grouped, ``(flat, planes or
    tile width, rows per thread, row groups)`` depthwise, ``(unroll,
    max_blocks)`` qdq.
    """
    blocks: tuple
    source: str = "default"          # "default" | "cached" | "search"

    @property
    def tuned(self) -> bool:
        return self.source != "default"

    def to_json(self) -> dict:
        return {"blocks": list(self.blocks), "source": self.source}
