"""Attention modules of the profiled segment: the sum of each call's least
time (projections and core, from its shapes) over the sum of the device
time of the kernels launched inside it, in percent."""

UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "frames_per_s"


def read(run):
    seg = run.segment
    if run.kind != "serve" or seg is None or seg.attn_device_s <= 0:
        return None
    return 100.0 * seg.attn_bound_s / seg.attn_device_s
