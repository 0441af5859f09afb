"""Share of the traced window in which no device operation ran, in %: one
minus the union of the device intervals over the window, both from one trace."""


def read(trace, ctx):
    if "rounds" not in ctx:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
