"""Model FLOPs of the window's requests (counted once on the plain
reference) over the window's length times the bf16 peak, in percent."""

from port_bench.harness.yardstick import PEAK_BF16_FLOPS

UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "frames_per_s"


def read(run):
    if run.kind != "serve" or not run.flops:
        return None
    return 100.0 * run.flops / (run.window_s * PEAK_BF16_FLOPS)
