"""setup_s (s): from the process's start to the first timed call: imports,
the pool made from the seed, the kernels loaded (built on a checkout's
first run) and the warm-up calls."""


def read(run):
    return run.setup_s
