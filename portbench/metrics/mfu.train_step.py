"""Model FLOPs of the traced steps (6 x matmul parameters x tokens plus the
causal attention) over the traced window, as a share of the dense bf16
peak, in %."""
from portbench.yardstick import peaks


def read(trace, ctx):
    if "train_flops" not in ctx:
        return None
    return 100.0 * ctx["train_flops"] / trace.window_s / peaks.PEAK_FLOPS
