"""Device time of the cuBLAS GEMM kernels (by the frozen name rule), ms per step."""
from portbench.yardstick import peaks


def read(trace, ctx):
    if "steps" not in ctx:
        return None
    return 1e3 * trace.device_seconds(peaks.is_gemm) / ctx["steps"]
