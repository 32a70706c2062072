"""The program's phase marks in the search spans, and the device's idle time
put down to the phase in which each idle gap begins.

The port marks the phases of its search loops for ``torch.profiler`` with
empty ranges named ``repro_torch.<loop>.<phase>`` (the program's
``repro_torch/tracing.py``): a phase runs from its mark to the next mark of
its search.  An empty range launches nothing, so the marks add nothing to
the device activity of a trace.  :func:`phases` reduces a trace, whose host
operations are already cut to the search spans, to:

  * the number of marks of each phase;
  * the host time of each phase, from each of its marks to the next mark;
  * the device-idle time of the gaps that begin in each phase.  A gap counts
    whole to the phase it begins in: one that begins while the host is
    blocked on a synchronising call (``sync``, ``compact``, ``stats``) is
    that call's round trip, even where it runs on into the next phase, and
    one that begins while the host issues work is the device running dry.
    Gaps that begin before a search's first mark or after its ``done`` are
    the harness's own time inside its span: ``outside_us``, in no phase.

A program without the marks gives None.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

from portbench.bench.trace import Trace, merged

PREFIX = "repro_torch."
LAST = "done"
#: The marks that open a step of each loop: a BFS level, an SSSP round.
STEPS = {"bfs": ("level.td", "level.bu"), "sssp": ("round",)}
#: The phases opened by a call that synchronises the host with the device.
SYNCS = {"bfs": ("sync", "compact", "stats"), "sssp": ("sync",)}
#: The phases of a BFS level in which the host issues work.
BFS_WORK = ("level.td", "level.bu", "core", "relax", "epilogue")


@dataclass
class Phases:
    loop: str
    marks: dict          # phase -> its marks
    host_us: dict        # phase -> us from its marks to the next marks
    idle_us: dict        # phase -> us of the device-idle gaps begun in it
    outside_us: float    # idle begun before a search's first mark or after done

    @property
    def steps(self) -> int:
        return sum(self.marks.get(p, 0) for p in STEPS[self.loop])

    @property
    def syncs(self) -> int:
        return sum(self.marks.get(p, 0) for p in SYNCS[self.loop])

    def sync_idle_us(self) -> float:
        return sum(self.idle_us.get(p, 0.0) for p in SYNCS[self.loop])

    def launch_idle_us(self) -> float:
        return sum(us for p, us in self.idle_us.items() if p not in SYNCS[self.loop])


def phases(tr: Trace, loop: str) -> Phases | None:
    """The phases of the program's ``loop`` (``bfs``, ``sssp``) in ``tr``;
    None when ``tr`` holds none of its marks."""
    prefix = f"{PREFIX}{loop}."
    marks = sorted(((s, name[len(prefix):]) for name, s, _ in tr.host
                    if name.startswith(prefix)), key=lambda m: m[0])
    if not marks:
        return None
    at = [t for t, _ in marks]
    out = Phases(loop, {}, {}, {}, 0.0)
    busy = merged((s, e) for _, s, e in tr.device)
    for s0, s1 in tr.spans:
        lo, hi = bisect.bisect_left(at, s0), bisect.bisect_left(at, s1)
        span_at, span = at[lo:hi], marks[lo:hi]
        for i, (t, name) in enumerate(span):
            out.marks[name] = out.marks.get(name, 0) + 1
            if i + 1 < len(span):
                out.host_us[name] = out.host_us.get(name, 0.0) + span_at[i + 1] - t
        inside = [iv for iv in busy if iv[1] > s0 and iv[0] < s1]
        edges = [s0] + [x for iv in inside for x in iv] + [s1]
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            j = bisect.bisect_right(span_at, g0) - 1
            if j < 0 or span[j][1] == LAST:
                out.outside_us += g1 - g0
            else:
                name = span[j][1]
                out.idle_us[name] = out.idle_us.get(name, 0.0) + (g1 - g0)
    return out


def of(ctx, loop: str) -> Phases | None:
    """The phases of ``loop`` in a traced run of its kernel; None in another
    kernel's run, without a trace, or without a step of the loop."""
    if ctx.kernel != loop or ctx.trace is None:
        return None
    p = phases(ctx.trace, loop)
    return p if p is not None and p.steps else None
