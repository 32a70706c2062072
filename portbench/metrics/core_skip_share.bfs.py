"""core_skip_share.bfs: the bottom-up levels that skipped the core step
because no core row was left unvisited (the program's counter
``bfs.core_steps_skipped``: no ``core_spmv`` launch, no merge) over the
bottom-up levels of a graph with a core (``bfs.core_steps``), in percent,
over the traced window; none for a program without those counters or a
window without a core step."""


def read(ctx):
    if ctx.kernel != "bfs":
        return None
    skipped = ctx.counters.get("bfs.core_steps_skipped")
    steps = ctx.counters.get("bfs.core_steps")
    if skipped is None or not steps:
        return None
    return 100.0 * skipped / steps
