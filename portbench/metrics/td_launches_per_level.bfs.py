"""td_launches_per_level.bfs: the device operations a top-down BFS level
issues: the CUDA runtime calls that put work on the device
(``ranges.LAUNCHES``) whose host start lies inside a
``repro_torch.bfs.level.td`` range (the level's chunk count, relax and
epilogue, to the next ``sync``), over those ranges; none for a program
without the phase ranges or a window without a top-down level."""
from portbench.bench import ranges


def read(ctx):
    tr = ranges.of(ctx, "bfs")
    if tr is None:
        return None
    ivs = ranges.intervals(tr, "bfs", "level.td")
    return ranges.launches_in(tr, ivs) / len(ivs) if ivs else None
