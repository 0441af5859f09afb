"""Device time of the port's hand-written FL kernels (by device symbol, the
frozen list in the yardstick), ms per FL round."""
from portbench.yardstick import peaks


def read(trace, ctx):
    if "rounds" not in ctx:
        return None
    return 1e3 * trace.device_seconds(peaks.is_own_fl_kernel) / ctx["rounds"]
