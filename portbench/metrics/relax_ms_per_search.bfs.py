"""relax_ms_per_search.bfs: device ms of the kernels whose name holds
``bfs_relax`` (the level loop's frontier scan and relax, both directions)
per traced BFS search; none for a program without that kernel."""
from portbench.bench import trace


def read(ctx):
    if ctx.kernel != "bfs" or ctx.trace is None or not ctx.levels:
        return None
    us, n = trace.kernel_time(ctx.trace, "bfs_relax")
    return us / 1e3 / len(ctx.levels) if n else None
