"""Models of the port's side workloads: xDeepFM (``recsys``), the LM stack
(``layers``, ``moe``, ``transformer``) and the GNN stack (``gnn``: GAT,
GraphSAGE, DimeNet, EquiformerV2; its owner-partitioned step in
``gnn_dist``).  The dry run (``launch.dryrun``) runs their steps shape-only
on ``meta``."""
from repro_torch.models import gnn, layers, moe, recsys, transformer

__all__ = ["gnn", "layers", "moe", "recsys", "transformer"]
