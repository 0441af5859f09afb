"""Model FLOPs of the traced rounds (local training's masked MLP forward and
backward, and the eval forwards) over the traced window, as a share of the
dense bf16 peak, in %."""
from portbench.yardstick import peaks


def read(trace, ctx):
    if "fl_flops" not in ctx:
        return None
    return 100.0 * ctx["fl_flops"] / trace.window_s / peaks.PEAK_FLOPS
