"""Mean device ms a timed replay of the traced slice spends in the gemm
segments: B1 / B2 / B5 with their conv glue (``bench.segments``)."""
from bench.segments import read_class


def read(run):
    return read_class(run, "gemm")
