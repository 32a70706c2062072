"""relax_ms_per_search.sssp: device ms of the kernels whose name holds
``sssp_relax`` (the round loop's frontier compaction and relax) per traced
SSSP search; none for a program without that kernel."""
from portbench.bench import trace


def read(ctx):
    if ctx.kernel != "sssp" or ctx.trace is None or not ctx.levels:
        return None
    us, n = trace.kernel_time(ctx.trace, "sssp_relax")
    return us / 1e3 / len(ctx.levels) if n else None
