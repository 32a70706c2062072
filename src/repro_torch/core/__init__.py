"""The Graph500 BFS and SSSP kernels in PyTorch, on one device and on
meshes (root-parallel, vertex-sharded and composed), with checked execution,
fault injection and the plan auto-tuner (counterpart of repro.core)."""
from repro_torch.core.kronecker import EdgeList, generate_edges, sample_roots
from repro_torch.core.graph_build import (
    DEFAULT_MAX_WEIGHT, CSRGraph, build_csr, edge_weights,
)
from repro_torch.core.reorder import (
    Reordering, degree_reorder, reorder_graph, sort_host,
)
from repro_torch.core.heavy import (
    HeavyCore, build_heavy_core, pack_bitmap, padded_bitmap_words, unpack_bitmap,
)
from repro_torch.core.bfs_steps import (
    ChunkedEdgeView, EdgeView, chunk_edge_view, edge_view, masked_relax_step,
    relax_step, with_edge_weights,
)
from repro_torch.core.faults import FAULT_CLASSES, FaultSpec
from repro_torch.core.hybrid_bfs import BFSResult, BFSStats, SHARD_EXCHANGES
from repro_torch.core.distributed_bfs import (
    PARTITIONS, DistBFSResult, ShardedGraph, gather_result, modeled_wire_bytes,
    owner_local_of, partition_permutation, shard_edge_skew, shard_graph,
)
from repro_torch.core.sssp_steps import (
    INF_U32, SSSP_EXCHANGES, bucket_width, sssp_max_rounds, sssp_oracle,
)
from repro_torch.core.validate import (
    CHECK_NAMES, SSSP_CHECK_NAMES, SsspValidation, validate, validate_batch,
    validate_sssp, validate_sssp_batch,
)
from repro_torch.core.kernels import KERNELS, KernelSpec, kernel_spec, rekernel_plan
from repro_torch.core.teps import Graph500Run, run_graph500, traversed_edges
from repro_torch.core.plan import (
    BFSPlan, CompiledBFS, Graph500Result, PreparedGraph, ServeBatch,
    ShardedRun, TraversalPlan, compile_plan,
)
from repro_torch.core.pipeline import BuiltGraph, Graph500Config, build, run, serve

# The tuner loads lazily, as in the JAX package: ``python -m
# repro_torch.core.tune`` must find it unimported when it runs it.
_TUNE_EXPORTS = ("TuneReport", "TuneResult", "enumerate_plans",
                 "load_table", "save_tuned", "sweep", "tuned_plan")


def __getattr__(name):
    if name in _TUNE_EXPORTS:
        from repro_torch.core import tune
        return getattr(tune, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EdgeList", "generate_edges", "sample_roots", "CSRGraph", "build_csr",
    "DEFAULT_MAX_WEIGHT", "edge_weights", "with_edge_weights", "relax_step",
    "masked_relax_step", "INF_U32", "bucket_width", "sssp_max_rounds",
    "sssp_oracle", "SSSP_EXCHANGES", "SSSP_CHECK_NAMES", "SsspValidation",
    "validate_sssp", "validate_sssp_batch", "KERNELS", "KernelSpec", "kernel_spec",
    "rekernel_plan",
    "Reordering", "degree_reorder", "reorder_graph", "HeavyCore",
    "build_heavy_core", "pack_bitmap", "padded_bitmap_words", "unpack_bitmap",
    "ChunkedEdgeView", "EdgeView", "chunk_edge_view", "edge_view",
    "BFSResult", "BFSStats", "CHECK_NAMES", "validate", "validate_batch",
    "Graph500Run", "run_graph500", "traversed_edges", "BFSPlan", "CompiledBFS",
    "Graph500Result", "PreparedGraph", "TraversalPlan", "compile_plan",
    "BuiltGraph", "Graph500Config", "build", "run", "serve", "FAULT_CLASSES",
    "FaultSpec", "ServeBatch", "sort_host", "SHARD_EXCHANGES", "PARTITIONS",
    "DistBFSResult", "ShardedGraph", "ShardedRun", "gather_result",
    "modeled_wire_bytes", "owner_local_of", "partition_permutation",
    "shard_edge_skew", "shard_graph", *_TUNE_EXPORTS,
]
