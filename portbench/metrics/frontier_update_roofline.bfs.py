"""frontier_update_roofline.bfs: the ``frontier_update`` kernel's bound (its
bitmaps' bytes over the memory bandwidth) over its device time a launch, in
percent of the H100's peak."""
from portbench.bench import roofline, trace


def read(ctx):
    if ctx.kernel != "bfs" or ctx.trace is None:
        return None
    us, n = trace.kernel_time(ctx.trace, "frontier_update")
    if not n or us <= 0:
        return None
    return 100.0 * roofline.frontier_update_bound_s(ctx.bitmap_words) / (us / 1e6 / n)
