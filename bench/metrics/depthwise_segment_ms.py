"""Mean device ms a timed replay of the traced slice spends in B6's depthwise
segments (``bench.segments``)."""
from bench.segments import read_class


def read(run):
    return read_class(run, "depthwise")
