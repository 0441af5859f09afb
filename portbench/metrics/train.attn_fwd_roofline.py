"""The attention forward kernel's share of its roofline, in %: the least time
one call could take (the larger of its FLOPs over the bf16 peak and its bytes
over the HBM rate) over the device time of one call, averaged over the calls
in the traced window."""
from portbench.yardstick import peaks


def read(trace, ctx):
    calls = trace.count(peaks.is_flash_fwd)
    if "flash_bound_s" not in ctx or not calls:
        return None
    per_call = trace.device_seconds(peaks.is_flash_fwd) / calls
    return 100.0 * ctx["flash_bound_s"] / per_call
