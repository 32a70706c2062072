"""idle_share.bfs: the share of the traced window in which no operation ran
on the device (1 - union of device intervals / window), in percent."""
from portbench.bench import trace


def read(ctx):
    if ctx.kernel != "bfs" or ctx.trace is None:
        return None
    return 100.0 * trace.idle_share(ctx.trace)
