"""Group-based monitor communication (paper T3): the interconnect model
and monitor election, a numpy-only copy of ``repro.comms.topology``.  The
collectives of ``repro.comms.hierarchical`` come with the multi-device
layouts."""
from repro_torch.comms.topology import (
    MonitorPlan,
    TreeTopology,
    elect_monitors,
    plan_device_mesh,
    simulate_messages,
)

__all__ = [
    "TreeTopology", "MonitorPlan", "elect_monitors", "plan_device_mesh",
    "simulate_messages",
]
