"""Device time of the program's ``train.update`` spans (the optimizer's
update), ms per step, from the first traced pass."""
from portbench.yardstick import spans


def read(trace, ctx):
    if "steps" not in ctx:
        return None
    recs = spans.first_pass("train.step", ctx["steps"])
    return spans.device_ms(recs, lambda n: n == "train.update", ctx["steps"])
