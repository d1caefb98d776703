"""The card's peak allocated memory over the window (reset at its start)."""

UNIT, BETTER, SOURCE, MOVES = "GiB", "lower", "host_clock", None


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
