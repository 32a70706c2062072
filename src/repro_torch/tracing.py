"""Phase ranges and counters of the port's search loops, for ``torch.profiler``.

A search loop's phases are ranges on the profiler's host timeline, the
clock on which it also places the device's activity.  A :class:`Phases`
opens each phase where the loop enters it and closes it where the next
phase of the same depth opens: a BFS level's range (depth 0) encloses the
ranges of its parts (depth 1), and ends where the next ``sync`` opens.  The
engines name their phases ``repro_torch.<loop>.<phase>``
(``core/hybrid_bfs.py``'s bitmap engine, ``core/sssp_steps.py``'s
single-device engine) and end a search with the empty mark
``repro_torch.<loop>.done``.  Each device operation issued inside a range
has that range, and the ranges around it, in its chain of CPU parents, so
a trace puts the operation and its device time down to its phase.
``core/pipeline.py``'s ``build`` marks its phases ``repro_torch.build.<phase>``
with empty ranges (:func:`mark`).

The range is the profiler's fast ``RecordFunction``
(``torch._C._profiler._RecordFunctionFast``, the one torch's generated code
uses): on an H100 host it costs about 2 us with the profiler recording,
against about 11 us for ``torch.profiler.record_function``, whose dispatcher
round trip lengthened a traced BFS search by 4-7%.  It is no user
annotation, so the profiler draws no device-side echo of it: a trace's
device activity is the same with the ranges as without them.

A counter adds integers under a name; :func:`counters` returns them.  A
search counts on the host (:func:`count`), into a device integer that its
kernels add to (:func:`device_counter`, one int64 accumulator a device), or
by a reduction of its own tensors taken later (:func:`count_later`): the
device's part is reduced and read back in one copy a device when
:func:`counters` is next called, so a traced search issues no device work
and no synchronisation for its counters.  Ranges and counters are kept
only while a profiler session records.  With none recording, a mark or a
host count costs one check of the profiler's state; the engines read
:func:`recording` once a search and skip their range sites on that local.
The profiler's own trace (``export_chrome_trace``) is the store of the
ranges: this module keeps none.
"""
from __future__ import annotations

import torch

#: Counters one device's accumulator holds.
DEVICE_SLOTS = 8
#: Bytes of tensors held for :func:`count_later` past which the held counts
#: are reduced on the device at once (no readback) and the tensors let go.
HELD_BYTES = 1 << 30

_counts: dict[str, int] = {}
_device: dict = {}     # device -> (int64 [DEVICE_SLOTS] accumulator, {name: its slot}, values read)
_later: list = []      # [(name, fn, args)]: fn(*args) is a device integer
_held = 0


def recording() -> bool:
    """Whether a ``torch.profiler`` session is recording now."""
    return torch._C._autograd._profiler_enabled()


def mark(name: str) -> None:
    """An empty fast range named ``name``, while a profiler records."""
    if recording():
        with torch._C._profiler._RecordFunctionFast(name):
            pass


class Phases:
    """The open phase ranges of one traced search of ``loop``, innermost
    last; make one only while :func:`recording`."""

    __slots__ = ("prefix", "open")

    def __init__(self, loop: str):
        self.prefix = f"repro_torch.{loop}."
        self.open: list = []

    def enter(self, phase: str, depth: int = 0) -> None:
        """Close the open ranges at ``depth`` and deeper, then open the
        range ``phase`` at ``depth``."""
        self.close(depth)
        r = torch._C._profiler._RecordFunctionFast(self.prefix + phase)
        r.__enter__()
        self.open.append(r)

    def close(self, depth: int = 0) -> None:
        """Close the open ranges at ``depth`` and deeper, innermost first."""
        while len(self.open) > depth:
            self.open.pop().__exit__(None, None, None)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``, while a profiler records."""
    if recording():
        _counts[name] = _counts.get(name, 0) + int(n)


def device_counter(name: str, device) -> torch.Tensor:
    """The int64 scalar on ``device`` that device code adds the counter
    ``name`` into; what it gains is added to the counter at the next
    :func:`counters`.  A device's accumulator is allocated (one fill) at
    its first counter."""
    device = torch.device(device)
    if device not in _device:
        _device[device] = (torch.zeros(DEVICE_SLOTS, dtype=torch.int64, device=device), {}, [])
    acc, views, seen = _device[device]
    if name not in views:
        if len(views) == DEVICE_SLOTS:
            raise ValueError(f"more than {DEVICE_SLOTS} device counters on {device}")
        views[name] = acc[len(views)]
        seen.append(0)
    return views[name]


def count_later(name: str, fn, *args: torch.Tensor) -> None:
    """Add ``fn(*args)``, an integer tensor of one element on the device of
    ``args``, to the counter ``name`` at the next :func:`counters`, which
    holds ``args`` until then."""
    global _held
    _later.append((name, fn, args))
    _held += sum(a.numel() * a.element_size() for a in args)
    if _held > HELD_BYTES:
        _later[:] = [(n, _same, (f(*a),)) for n, f, a in _later]
        _held = 0


def _same(x):
    return x


def counters() -> dict:
    """A copy of the counters, with what the devices hold for them added
    in: one readback a device that holds any."""
    global _held
    pending: dict = {}
    for name, fn, args in _later:
        x = fn(*args)
        pending.setdefault(x.device, ([], []))
        pending[x.device][0].append(name)
        pending[x.device][1].append(x.reshape(1).to(torch.int64))
    _later.clear()
    _held = 0
    for dev in set(_device) | set(pending):
        acc, views, seen = _device.get(dev, (None, {}, []))
        later_names, later = pending.get(dev, ([], []))
        vals = torch.cat(([acc] if acc is not None else []) + later).tolist()
        for i, name in enumerate(views):
            _counts[name] = _counts.get(name, 0) + vals[i] - seen[i]
            seen[i] = vals[i]
        for name, n in zip(later_names, vals[DEVICE_SLOTS if acc is not None else 0:]):
            _counts[name] = _counts.get(name, 0) + n
    return dict(_counts)


def reset() -> None:
    """Clear the counters, the devices' accumulators and the held counts."""
    global _held
    _counts.clear()
    _device.clear()
    _later.clear()
    _held = 0
