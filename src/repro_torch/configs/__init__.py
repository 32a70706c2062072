"""Architecture configs of the port (its own copies of ``repro.configs``).

Importing this package registers every ported architecture.
"""
from repro_torch.configs import base, graph500_arch, recsys_archs  # noqa: F401
from repro_torch.configs.base import REGISTRY, all_arch_ids, all_cells, get

__all__ = ["base", "REGISTRY", "all_arch_ids", "all_cells", "get"]
