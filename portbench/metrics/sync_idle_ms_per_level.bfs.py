"""sync_idle_ms_per_level.bfs: device-idle ms a BFS level of the gaps that
begin while the host is blocked on a synchronising call (in a
``repro_torch.bfs.sync``, ``compact`` or ``stats`` phase): their round
trips."""
from portbench.bench import phases


def read(ctx):
    p = phases.of(ctx, "bfs")
    return None if p is None else p.sync_idle_us() / 1e3 / p.steps
