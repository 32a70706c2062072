"""Production meshes and the card's roofline constants (the port of
``repro.launch.mesh``).

The meshes are virtual :class:`~repro_torch.comms.mesh.Mesh` objects: a
``(16, 16)`` ``("data", "model")`` mesh of 256 chips, or ``(2, 16, 16)``
``("pod", "data", "model")`` of 512.  The dry run builds them on the
``meta`` device, so they hold no memory and touch no card; each is a name
for the layout a step's shardings refer to.

The roofline denominators are those of one NVIDIA H100 80GB HBM3 (SXM5)
at its 700 W power limit, from the NVIDIA H100 datasheet (dense rates, no
sparsity).  ``LINK_BW`` is the per-GPU scale-out rate: a 256-GPU mesh spans
32 eight-GPU nodes, so a collective over the mesh crosses one 400 Gb/s NDR
InfiniBand port per GPU (50e9 B/s).  NVLink inside a node runs at
``NVLINK_BW`` (450e9 B/s per direction), recorded beside it.
"""
from __future__ import annotations

from repro_torch.comms.mesh import make_mesh

#: the card the constants describe, as the records name it
CARD = "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
CONSTANTS_SOURCE = "NVIDIA H100 datasheet"

PEAK_FLOPS_BF16 = 989.4e12     # dense, tensor cores
PEAK_FLOPS_TF32 = 494.7e12     # dense, tensor cores
PEAK_FLOPS_FP32 = 66.9e12      # outside the tensor cores (TF32 off)
PEAK_OPS_INT8 = 1979e12        # dense, tensor cores
HBM_BW = 3.35e12               # bytes/s
LINK_BW = 50e9                 # bytes/s per GPU: one 400 Gb/s NDR port
NVLINK_BW = 450e9              # bytes/s per GPU and direction (NVLink 4)
CHIPS_SINGLE_POD = 256
CHIPS_MULTI_POD = 512


def constants() -> dict:
    """The constants as a record stores them."""
    return {"card": CARD, "source": CONSTANTS_SOURCE,
            "peak_flops_bf16": PEAK_FLOPS_BF16, "peak_flops_tf32": PEAK_FLOPS_TF32,
            "peak_flops_fp32": PEAK_FLOPS_FP32, "peak_ops_int8": PEAK_OPS_INT8,
            "hbm_bw": HBM_BW, "link_bw": LINK_BW, "nvlink_bw": NVLINK_BW}


def make_production_mesh(*, multi_pod: bool = False, device="meta"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, virtual=True)


def make_host_mesh(shape=(2, 4), axes=("data", "model"), device="cpu"):
    """Small virtual mesh (tests / examples)."""
    return make_mesh(shape, axes, device=device, virtual=True)


def make_group_mesh(shape=None, group_axis: str = "group",
                    member_axis: str = "member", *, device=None,
                    virtual: bool = False):
    """(group, member) mesh for the vertex-sharded engine (layer 2, T3).

    With ``shape=None`` the shape comes from the interconnect model:
    ``comms.topology.plan_device_mesh`` sizes the member axis to the router
    group over the visible devices of ``device``'s type (the cards; one
    CPU).  ``virtual`` puts every shard on ``device``."""
    if shape is None:
        import torch

        from repro_torch.comms.topology import plan_device_mesh
        from repro_torch.util import resolve_device

        dev = resolve_device(device)
        shape = plan_device_mesh(torch.cuda.device_count() if dev.type == "cuda" else 1)
    return make_mesh(shape, (group_axis, member_axis), device=device,
                     virtual=virtual)
