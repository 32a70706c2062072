"""start_launches_per_search.bfs: the device operations a BFS search's
prologue issues: the CUDA runtime calls that put work on the device
(``ranges.LAUNCHES``) whose host start lies inside a
``repro_torch.bfs.start`` range, over those ranges (one a search); none for
a program without the phase ranges."""
from portbench.bench import ranges


def read(ctx):
    tr = ranges.of(ctx, "bfs")
    if tr is None:
        return None
    ivs = ranges.intervals(tr, "bfs", "start")
    return ranges.launches_in(tr, ivs) / len(ivs) if ivs else None
