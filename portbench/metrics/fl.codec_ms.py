"""Device time of the program's ``fl.codec`` spans (uplink, aggregate,
downlink: the static codec graph, the adaptive bucket graphs), ms per FL
round, from the first traced pass."""
from portbench.yardstick import spans


def read(trace, ctx):
    if "rounds" not in ctx:
        return None
    recs = spans.first_pass("fl.round", ctx["rounds"])
    return spans.device_ms(recs, lambda n: n == "fl.codec", ctx["rounds"])
