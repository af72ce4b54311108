"""Process start to the first timed request (host clock): imports, the
kernel library, weights, compile, the input pool, warm-up and capture."""


def read(run):
    return run.setup_s
