"""sync_idle_ms_per_round.sssp: device-idle ms an SSSP round of the gaps that
begin while the host is blocked on the changed set's size (in a
``repro_torch.sssp.sync`` phase), over the ``round`` marks."""
from portbench.bench import phases


def read(ctx):
    p = phases.of(ctx, "sssp")
    return None if p is None else p.sync_idle_us() / 1e3 / p.steps
