"""Device time of the program's ``train.sign`` spans (the stochastic sign
over every leaf), ms per step, from the first traced pass."""
from portbench.yardstick import spans


def read(trace, ctx):
    if "steps" not in ctx:
        return None
    recs = spans.first_pass("train.step", ctx["steps"])
    return spans.device_ms(recs, lambda n: n == "train.sign", ctx["steps"])
