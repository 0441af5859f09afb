"""Device operations (kernels, copies, fills) in the traced window, per FL round."""


def read(trace, ctx):
    if "rounds" not in ctx:
        return None
    return len(trace.device_ops) / ctx["rounds"]
