"""Model FLOPs of the window's steps (forward and backward, counted once on
the plain reference, nothing recomputed) over the window's length times the
bf16 peak, in percent."""

from port_bench.harness.yardstick import PEAK_BF16_FLOPS

UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "train_frames_per_s"


def read(run):
    if run.kind != "train" or not run.flops:
        return None
    return 100.0 * run.flops / (run.window_s * PEAK_BF16_FLOPS)
