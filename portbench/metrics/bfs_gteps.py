"""bfs_gteps: the specification's harmonic-mean TEPS over every BFS search
of the window, each search's traversed edges over its own time, in 1e9."""
from portbench.bench.teps import harmonic_mean_teps


def read(ctx):
    if ctx.kernel != "bfs":
        return None
    return harmonic_mean_teps(ctx.edges, ctx.times_s) / 1e9
