"""Device time of the program's ``train.fwd_bwd`` spans (each
microbatch's loss, gradients and their accumulation), ms per step, from
the first traced pass."""
from portbench.yardstick import spans


def read(trace, ctx):
    if "steps" not in ctx:
        return None
    recs = spans.first_pass("train.step", ctx["steps"])
    return spans.device_ms(recs, lambda n: n == "train.fwd_bwd", ctx["steps"])
