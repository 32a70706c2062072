"""The single-device Graph500 BFS path in PyTorch (counterpart of repro.core)."""
from repro_torch.core.kronecker import EdgeList, generate_edges, sample_roots
from repro_torch.core.graph_build import CSRGraph, build_csr
from repro_torch.core.reorder import Reordering, degree_reorder, reorder_graph
from repro_torch.core.heavy import (
    HeavyCore, build_heavy_core, pack_bitmap, padded_bitmap_words, unpack_bitmap,
)
from repro_torch.core.bfs_steps import (
    ChunkedEdgeView, EdgeView, chunk_edge_view, edge_view,
)
from repro_torch.core.hybrid_bfs import BFSResult, BFSStats
from repro_torch.core.validate import CHECK_NAMES, validate, validate_batch
from repro_torch.core.teps import Graph500Run, traversed_edges
from repro_torch.core.plan import (
    BFSPlan, CompiledBFS, Graph500Result, PreparedGraph, TraversalPlan,
    compile_plan,
)
from repro_torch.core.pipeline import BuiltGraph, Graph500Config, build, run

__all__ = [
    "EdgeList", "generate_edges", "sample_roots", "CSRGraph", "build_csr",
    "Reordering", "degree_reorder", "reorder_graph", "HeavyCore",
    "build_heavy_core", "pack_bitmap", "padded_bitmap_words", "unpack_bitmap",
    "ChunkedEdgeView", "EdgeView", "chunk_edge_view", "edge_view",
    "BFSResult", "BFSStats", "CHECK_NAMES", "validate", "validate_batch",
    "Graph500Run", "traversed_edges", "BFSPlan", "CompiledBFS",
    "Graph500Result", "PreparedGraph", "TraversalPlan", "compile_plan",
    "BuiltGraph", "Graph500Config", "build", "run",
]
