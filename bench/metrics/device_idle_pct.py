"""Share of the traced slice in which no kernel, copy or memset ran on the
device (``torch.profiler``)."""


def read(run):
    t = run.trace
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
