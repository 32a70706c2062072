"""settles_per_vertex.sssp: the vertices the traced searches' rounds took into
their frontiers (the program's counter ``sssp.frontier_vertices``, the
rounds' frontier sizes summed) over the vertices they reached
(``sssp.reached_vertices``), over the traced window: delta-stepping's
re-relaxation, 1.0 where every reached vertex's row is relaxed once.  None
for a program without those counters."""


def read(ctx):
    if ctx.kernel != "sssp":
        return None
    frontier = ctx.counters.get("sssp.frontier_vertices")
    reached = ctx.counters.get("sssp.reached_vertices")
    if frontier is None or not reached:
        return None
    return frontier / reached
