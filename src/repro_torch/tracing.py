"""Phase marks and counters of the port's search loops, for ``torch.profiler``.

A mark is an empty ``record_function`` range, opened and closed at once.
The profiler records it on its host timeline, the clock on which it also
places the device's activity, and since the range launches nothing, no
device-side annotation spans it: a trace's device activity is the same with
the marks as without them.  A phase of a search loop runs from its mark to
the next mark; the engines name their marks ``repro_torch.<loop>.<phase>``
(``core/hybrid_bfs.py``'s bitmap engine, ``core/sssp_steps.py``'s
single-device engine); ``core/pipeline.py``'s ``build`` marks its phases
``repro_torch.build.<phase>`` the same way.

The range is the profiler's fast ``RecordFunction``
(``torch._C._profiler._RecordFunctionFast``, the one torch's generated code
uses): on an H100 host it costs about 2 us with the profiler recording,
against about 11 us for ``torch.profiler.record_function``, whose dispatcher
round trip lengthened a traced BFS search by 4-7%.

A counter adds host integers under a name; :func:`counters` returns them.
Marks and counters are kept only while a profiler session records.  With
none recording, a mark or a count costs one check of the profiler's state;
the engines read :func:`recording` once a search and skip their mark sites
on that local.  The profiler's own trace (``export_chrome_trace``) is the
store of the marks: this module keeps none.
"""
from __future__ import annotations

import torch

_counts: dict[str, int] = {}


def recording() -> bool:
    """Whether a ``torch.profiler`` session is recording now."""
    return torch._C._autograd._profiler_enabled()


def mark(name: str) -> None:
    """An empty ``record_function`` range named ``name``, while a profiler
    records."""
    if recording():
        with torch._C._profiler._RecordFunctionFast(name):
            pass


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``, while a profiler records."""
    if recording():
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the counters."""
    return dict(_counts)


def reset() -> None:
    """Clear the counters."""
    _counts.clear()
