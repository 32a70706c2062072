"""host_ms_per_td_level.bfs: host ms of a top-down BFS level's whole issue:
the mean duration of the ``repro_torch.bfs.level.td`` ranges (from the
direction decision to the next ``sync``); none for a program without the
phase ranges or a window without a top-down level.  It is read under the
profiler, which adds its own cost to each launch."""
from portbench.bench import ranges


def read(ctx):
    tr = ranges.of(ctx, "bfs")
    if tr is None:
        return None
    ivs = ranges.intervals(tr, "bfs", "level.td")
    return sum(e - s for s, e in ivs) / 1e3 / len(ivs) if ivs else None
