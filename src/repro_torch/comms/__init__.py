"""Group-based monitor communication (paper T3): the interconnect model and
monitor election (a numpy-only copy of ``repro.comms.topology``), the port's
meshes (virtual, device and process meshes), the bitmap and min monitor
collectives of the sharded engines, and the psum and all-to-all of
data-parallel training."""
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
    all_to_all_spmd,
    compressed_hierarchical_por,
    compressed_hierarchical_psum,
    decode_delta,
    encode_delta,
    flat_all_to_all,
    flat_psum,
    hierarchical_all_gather,
    hierarchical_all_to_all,
    hierarchical_pmin,
    hierarchical_por,
    hierarchical_psum,
    psum_spmd,
)

__all__ = [
    "TreeTopology", "MonitorPlan", "elect_monitors", "plan_device_mesh",
    "simulate_messages", "Mesh", "VertexComm", "make_mesh", "INF_U32",
    "compressed_hierarchical_por", "decode_delta", "encode_delta",
    "hierarchical_all_gather", "hierarchical_pmin", "hierarchical_por",
    "all_to_all_spmd", "compressed_hierarchical_psum", "flat_all_to_all",
    "flat_psum", "hierarchical_all_to_all", "hierarchical_psum", "psum_spmd",
]
