"""Share of the profiled segment's span in which no kernel, copy or set ran
on the card, in percent."""

UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "frames_per_s"


def read(run):
    seg = run.segment
    if run.kind != "serve" or seg is None or seg.span_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.span_s)
