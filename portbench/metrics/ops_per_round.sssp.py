"""ops_per_round.sssp: device operations of the traced window (kernels,
copies, memsets) over the delta-stepping rounds its searches ran."""


def read(ctx):
    if ctx.kernel != "sssp" or ctx.trace is None or not sum(ctx.levels):
        return None
    return len(ctx.trace.device) / sum(ctx.levels)
