"""launch_idle_ms_per_level.bfs: device-idle ms a BFS level of the gaps that
begin while the host issues work (in any ``repro_torch.bfs`` phase but
``sync``, ``compact`` and ``stats``): the device running dry behind the
host."""
from portbench.bench import phases


def read(ctx):
    p = phases.of(ctx, "bfs")
    return None if p is None else p.launch_idle_us() / 1e3 / p.steps
