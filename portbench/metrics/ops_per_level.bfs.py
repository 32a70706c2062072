"""ops_per_level.bfs: device operations of the traced window (kernels,
copies, memsets) over the BFS levels its searches ran (``stats.levels``)."""


def read(ctx):
    if ctx.kernel != "bfs" or ctx.trace is None or not sum(ctx.levels):
        return None
    return len(ctx.trace.device) / sum(ctx.levels)
