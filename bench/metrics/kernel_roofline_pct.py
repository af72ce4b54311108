"""The least time a slot's work needs over the device kernel time a replay
takes in the traced slice.  The least time is the larger of the slot's
operations at the int8 peak and its compulsory bytes (float32 input,
weights at their declared widths, float32 output) at HBM bandwidth; the
padded rows of a slot are computed, so a slot counts ``max_batch`` rows."""
from bench import counts


def read(run):
    t = run.trace
    if t is None or not t["replays"] or not t["kernel_s"]:
        return None
    least = counts.least_seconds(run.cfg, run.cfg["max_batch"])
    return 100.0 * least / (t["kernel_s"] / t["replays"])
