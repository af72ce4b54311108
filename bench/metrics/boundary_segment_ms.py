"""Mean device ms a timed replay of the traced slice spends in the
boundary segments: B4, bipolar activations, pools, residual adds and
concats (``bench.segments``)."""
from bench.segments import read_class


def read(run):
    return read_class(run, "boundary")
