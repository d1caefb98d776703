"""From process start to the window: imports, the kernels' libraries,
weights, warm-up (and in a training cell its first steps)."""

UNIT, BETTER, SOURCE, MOVES = "s", "lower", "host_clock", None


def read(run):
    return run.setup_s
