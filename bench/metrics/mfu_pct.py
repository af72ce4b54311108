"""The whole step's share of the card's int8 peak: 2 x the configuration's
MACs an image x images a second over 1,979 TOP/s (H100 SXM, dense)."""
from bench import counts


def read(run):
    ips = run.record["completed"] / run.window_s
    return 100.0 * 2 * counts.macs(run.cfg) * ips / counts.PEAK_INT8_OPS
