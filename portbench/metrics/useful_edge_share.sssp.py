"""useful_edge_share.sssp: the share of the edge entries the SSSP rounds'
passes read that leave the round's frontier, in percent: the program's
counters ``sssp.frontier_edges`` over ``sssp.scanned_edges``
(``repro_torch.tracing.counters()``, kept while the profiler records)."""


def read(ctx):
    if ctx.kernel != "sssp" or ctx.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:            # a program without the counters
        return None
    c = tracing.counters()
    scanned = c.get("sssp.scanned_edges", 0)
    return 100.0 * c.get("sssp.frontier_edges", 0) / scanned if scanned else None
