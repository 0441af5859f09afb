"""Device time of every other device operation of the FL round (the parts
that run as torch ops), ms per FL round."""
from portbench.yardstick import peaks


def read(trace, ctx):
    if "rounds" not in ctx:
        return None
    return 1e3 * trace.device_seconds(lambda n: not peaks.is_own_fl_kernel(n)) / ctx["rounds"]
