"""Group-based monitor communication (paper T3): the interconnect model and
monitor election (a numpy-only copy of ``repro.comms.topology``), the port's
meshes (virtual, device and process meshes) and the bitmap and min monitor
collectives of the sharded engines."""
from repro_torch.comms.topology import (
    MonitorPlan,
    TreeTopology,
    elect_monitors,
    plan_device_mesh,
    simulate_messages,
)
from repro_torch.comms.mesh import Mesh, VertexComm, make_mesh
from repro_torch.comms.hierarchical import (
    INF_U32,
    compressed_hierarchical_por,
    decode_delta,
    encode_delta,
    hierarchical_all_gather,
    hierarchical_pmin,
    hierarchical_por,
)

__all__ = [
    "TreeTopology", "MonitorPlan", "elect_monitors", "plan_device_mesh",
    "simulate_messages", "Mesh", "VertexComm", "make_mesh", "INF_U32",
    "compressed_hierarchical_por", "decode_delta", "encode_delta",
    "hierarchical_all_gather", "hierarchical_pmin", "hierarchical_por",
]
