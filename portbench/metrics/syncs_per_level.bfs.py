"""syncs_per_level.bfs: the calls of a BFS level that synchronise the host
with the device, over the levels: the ``repro_torch.bfs.sync`` marks (the
next frontier's size), ``compact`` marks (a top-down level's live-chunk
count) and ``stats`` marks (each write of a host int into the stats)."""
from portbench.bench import phases


def read(ctx):
    p = phases.of(ctx, "bfs")
    return None if p is None else p.syncs / p.steps
