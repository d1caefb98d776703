"""Share of the profiled segment's busy device time spent in the kernels
that the attention modules launched, in percent."""

UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "frames_per_s"


def read(run):
    seg = run.segment
    if run.kind != "serve" or seg is None or seg.busy_s <= 0 or seg.attn_device_s <= 0:
        return None
    return 100.0 * seg.attn_device_s / seg.busy_s
