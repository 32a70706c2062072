"""host_ms_per_level.bfs: host ms a BFS level spends issuing work: the span
of each level (its ``repro_torch.bfs.level.*`` mark to the next level mark or
``finish``) less its ``sync``, ``compact`` and ``stats`` phases, over the
levels."""
from portbench.bench import phases


def read(ctx):
    p = phases.of(ctx, "bfs")
    if p is None:
        return None
    return sum(p.host_us.get(x, 0.0) for x in phases.BFS_WORK) / 1e3 / p.steps
