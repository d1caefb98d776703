"""Images (or clip frames) consumed per second by the training steps of the
window, over the whole window."""

UNIT, BETTER, SOURCE, MOVES = "frames/s", "higher", "host_clock", None


def read(run):
    return run.frames / run.window_s if run.kind == "train" else None
