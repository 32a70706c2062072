"""core_spmv_roofline.bfs: the ``core_spmv`` kernel's bound (the bytes its
inputs need over the memory bandwidth, from each traced launch's output)
over its device time a launch, in percent of the H100's peak."""
from portbench.bench import roofline, trace


def read(ctx):
    if ctx.kernel != "bfs" or ctx.trace is None or not ctx.core_outputs:
        return None
    us, n = trace.kernel_time(ctx.trace, "core_spmv")
    if not n or us <= 0:
        return None
    bounds = [roofline.core_spmv_bound_s(o, ctx.core_words) for o in ctx.core_outputs]
    return 100.0 * (sum(bounds) / len(bounds)) / (us / 1e6 / n)
