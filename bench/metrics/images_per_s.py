"""Images completed in the window over the window's seconds (host clock)."""


def read(run):
    return run.record["completed"] / run.window_s
