"""scatter_min_ms_per_search.sssp: device ms of the kernels launched inside
``aten::scatter_reduce`` (the round loop's two min-relax passes) per traced
SSSP search."""
from portbench.bench import trace


def read(ctx):
    if ctx.kernel != "sssp" or ctx.trace is None or not ctx.levels:
        return None
    us = trace.device_us_under(ctx.trace, "aten::scatter_reduce")
    return us / 1e3 / len(ctx.levels) if us > 0 else None
