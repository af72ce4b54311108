"""Arbitrary-precision QONNX datatypes (paper §II / the qonnx DataType system).

A copy of ``repro.analysis.datatypes`` (numpy only).

A ``DataType`` names the *container* semantics of a tensor in the quantized
domain: ``INT<N>`` / ``UINT<N>`` for arbitrary integer widths (N need not be
a power of two, nor <= 8 — INT3, UINT17, ... are all first-class), ``BIPOLAR``
for the {-1, +1} binary weights of BipolarQuant, and ``FLOAT32`` for anything
not provably on an integer grid.

The QONNX convention (and this module's) is that a fake-quantized float
tensor *carries* an integer datatype annotation: the values are floats, but
the annotation records the minimal integer container of the underlying
quantized representation.  Downstream consumers (the compiled executor, the
cost reporter, FINN/hls4ml-style backends) read the annotation to size
datapaths and accumulators.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

_INT_RE = re.compile(r"^(U?)INT(\d+)$")


@dataclass(frozen=True)
class DataType:
    """One QONNX datatype: an integer interval (or FLOAT32).

    name   — canonical spelling: "INT4", "UINT8", "BIPOLAR", "FLOAT32"
    bits   — container width in bits (1 for BIPOLAR, 32 for FLOAT32)
    signed — whether the interval includes negatives
    """
    name: str
    bits: int
    signed: bool

    # ------------------------------------------------------------- bounds
    def is_integer(self) -> bool:
        return self.name != "FLOAT32"

    def min(self) -> float:
        if self.name == "FLOAT32":
            return -np.finfo(np.float32).max
        if self.name == "BIPOLAR":
            return -1.0
        return -(2.0 ** (self.bits - 1)) if self.signed else 0.0

    def max(self) -> float:
        if self.name == "FLOAT32":
            return float(np.finfo(np.float32).max)
        if self.name == "BIPOLAR":
            return 1.0
        return 2.0 ** (self.bits - 1) - 1.0 if self.signed else 2.0 ** self.bits - 1.0

    def allowed(self, value) -> bool:
        """Is every element of ``value`` representable in this datatype?"""
        v = np.asarray(value)
        if self.name == "FLOAT32":
            return True
        if self.name == "BIPOLAR":
            return bool(np.all(np.isin(v, (-1.0, 1.0))))
        if v.size == 0:
            return True
        return bool(np.all(v == np.round(v)) and
                    v.min() >= self.min() and v.max() <= self.max())

    def carrier(self) -> np.dtype:
        """Smallest standard numpy dtype that can store this datatype."""
        if self.name == "FLOAT32":
            return np.dtype(np.float32)
        for nb, s, u in ((8, np.int8, np.uint8), (16, np.int16, np.uint16),
                         (32, np.int32, np.uint32), (64, np.int64, np.uint64)):
            if self.bits <= nb:
                return np.dtype(s if self.signed else u)
        return np.dtype(np.int64)

    def __str__(self) -> str:
        return self.name

    # ------------------------------------------------------- constructors
    @staticmethod
    def int(bits: float, signed: bool = True) -> "DataType":
        """INT<N>/UINT<N>; fractional widths round up to the container."""
        nb = int(math.ceil(float(bits)))
        if nb < 1:
            raise ValueError(f"bit width must be >= 1, got {bits}")
        return DataType(f"{'' if signed else 'U'}INT{nb}", nb, signed)

    @staticmethod
    def from_string(name: str) -> "DataType":
        n = name.upper()
        if n == "FLOAT32":
            return FLOAT32
        if n == "BIPOLAR":
            return BIPOLAR
        m = _INT_RE.match(n)
        if not m:
            raise ValueError(f"unknown datatype {name!r} "
                             "(expected INT<N>/UINT<N>/BIPOLAR/FLOAT32)")
        return DataType.int(int(m.group(2)), signed=(m.group(1) == ""))

    @staticmethod
    def from_bounds(lo: float, hi: float) -> "DataType":
        """Minimal integer datatype containing the closed interval [lo, hi].

        The bounds are integer values (the caller's range analysis already
        proved integrality); non-finite bounds yield FLOAT32.
        """
        if not (np.isfinite(lo) and np.isfinite(hi)) or lo > hi:
            return FLOAT32
        lo, hi = float(lo), float(hi)
        if lo >= 0:
            bits = max(1, int(math.ceil(math.log2(hi + 1))) if hi > 0 else 1)
            return DataType.int(bits, signed=False)
        bits = 1
        while -(2.0 ** (bits - 1)) > lo or 2.0 ** (bits - 1) - 1 < hi:
            bits += 1
        return DataType.int(bits, signed=True)

    @staticmethod
    def for_values(values) -> "DataType":
        """Minimal datatype of a concrete tensor (FLOAT32 if non-integral)."""
        v = np.asarray(values, np.float64)
        if v.size == 0 or not np.all(np.isfinite(v)) or \
                not np.all(v == np.round(v)):
            return FLOAT32
        return DataType.from_bounds(float(v.min()), float(v.max()))


FLOAT32 = DataType("FLOAT32", 32, True)
BIPOLAR = DataType("BIPOLAR", 1, True)
INT8 = DataType.int(8)
UINT8 = DataType.int(8, signed=False)
INT32 = DataType.int(32)
