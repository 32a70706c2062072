"""sssp_relax_roofline.sssp: the ``sssp_relax`` kernels' bound (the bytes the
traced searches' rounds must read, from the program's counter
``sssp.frontier_edges`` and the rounds, over the memory bandwidth) over the
device time of every kernel whose name holds ``sssp_relax`` (the frontier's
scan and compaction and the relax), in percent of the H100's peak."""
from portbench.bench import roofline, trace


def read(ctx):
    if ctx.kernel != "sssp" or ctx.trace is None or not sum(ctx.levels):
        return None
    entries = ctx.counters.get("sssp.frontier_edges")
    us, n = trace.kernel_time(ctx.trace, "sssp_relax")
    if entries is None or not n or us <= 0:
        return None
    bound = roofline.sssp_relax_bound_s(entries, sum(ctx.levels), ctx.num_vertices)
    return 100.0 * bound / (us / 1e6)
