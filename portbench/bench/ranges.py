"""The program's phase ranges in the search spans: the runtime calls that put
work on the device inside them, and their durations.

The port puts each phase of its search loops in a range named
``repro_torch.<loop>.<phase>`` on the profiler's host timeline (the
program's ``repro_torch/tracing.py``): a range runs from where its phase
opens to where the next phase of its depth opens, and a BFS level's or an
SSSP round's range encloses the ranges of its parts.  A program that only
marks where each phase begins (empty ranges) has none: :func:`of` tells
the two apart by a step's range holding the start of one of its parts.

A device operation is counted by its launch on the host: the CUDA API calls
in :data:`LAUNCHES`, whose host start lies inside a range.
That needs no link from the device's activity to the host, and holds with
or without the profiler's kernel links.
"""
from __future__ import annotations

import bisect

from portbench.bench.phases import PREFIX, STEPS
from portbench.bench.trace import Trace

#: The CUDA API calls that put work on the device: kernel launches (the
#: runtime's two calls and the lower-level ``cuLaunchKernel`` pair), copies
#: and memsets.
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})
#: The parts a step of each loop encloses.
PARTS = {"bfs": ("core", "relax", "epilogue"), "sssp": ("bucket", "relax", "tally")}


def intervals(tr: Trace, loop: str, phase: str) -> list:
    """[(start, end)] of the ranges ``repro_torch.<loop>.<phase>``, sorted."""
    name = f"{PREFIX}{loop}.{phase}"
    return sorted((s, e) for n, s, e in tr.host if n == name)


def of(ctx, loop: str) -> Trace | None:
    """The trace of a traced run of ``loop``'s kernel whose program puts its
    phases in enclosing ranges; None in another kernel's run, without a
    trace, or where a step's range holds none of its parts' starts."""
    if ctx.kernel != loop or ctx.trace is None:
        return None
    steps = [iv for p in STEPS[loop] for iv in intervals(ctx.trace, loop, p)]
    parts = sorted(s for p in PARTS[loop] for s, _ in intervals(ctx.trace, loop, p))
    for s, e in steps:
        i = bisect.bisect_right(parts, s)
        if i < len(parts) and parts[i] < e:
            return ctx.trace
    return None


def launches_in(tr: Trace, ivs: list) -> int:
    """The calls of :data:`LAUNCHES` whose host start lies in one of the
    disjoint, sorted intervals ``ivs``."""
    starts = [s for s, _ in ivs]
    n = 0
    for name, s, _ in tr.host:
        if name in LAUNCHES:
            j = bisect.bisect_right(starts, s) - 1
            n += j >= 0 and s < ivs[j][1]
    return n
