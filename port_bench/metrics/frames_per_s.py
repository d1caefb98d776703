"""Frames served per second: every frame of every request of the window
over the whole window (the last request in flight included)."""

UNIT, BETTER, SOURCE, MOVES = "frames/s", "higher", "host_clock", None


def read(run):
    return run.frames / run.window_s if run.kind == "serve" else None
