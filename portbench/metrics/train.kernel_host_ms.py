"""Host time of the program's ``kernel.*`` spans (each hand-written kernel
launch through ``kernels.ops``: its checks, the ctypes call and the
launcher), ms per step, from the first traced pass."""
from portbench.yardstick import spans


def read(trace, ctx):
    if "steps" not in ctx:
        return None
    recs = spans.first_pass("train.step", ctx["steps"])
    return spans.host_ms(recs, lambda n: n.startswith("kernel."), ctx["steps"])
