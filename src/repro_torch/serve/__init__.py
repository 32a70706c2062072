"""BFS-as-a-service on the port: the persistent serving subsystem
(counterpart of ``repro.serve``).

Layering:

  ``cache``      hot-root parent LRU (bitwise-exact hits)
  ``coalescer``  deterministic double-buffered query -> root-batch replay
  ``metrics``    latency percentiles / qps / occupancy report
  ``engine``     resident compiled plan + checked batch solver

The cache, coalescer and metrics are numpy-only copies of the JAX
package's; only ``engine`` touches the compiled stack, and it is imported
lazily, as in the JAX package.
"""
from repro_torch.serve.cache import CachedAnswer, ParentCache
from repro_torch.serve.coalescer import (Answer, BatchOutcome, BatchRecord,
                                         CoalescePolicy, Query, replay)
from repro_torch.serve.metrics import ServeReport

__all__ = [
    "Answer", "BatchOutcome", "BatchRecord", "CachedAnswer",
    "CoalescePolicy", "Engine", "ParentCache", "Query", "ServeConfig",
    "ServeReport", "replay", "resolve_serve_plan",
]


def __getattr__(name):
    if name in ("Engine", "ServeConfig", "resolve_serve_plan"):
        from repro_torch.serve import engine as _engine
        return getattr(_engine, name)
    raise AttributeError(f"module 'repro_torch.serve' has no attribute {name!r}")
