"""Mean device ms a timed replay of the traced slice spends in the interpreted
fallback's segments (``bench.segments``)."""
from bench.segments import read_class


def read(run):
    return read_class(run, "interp")
