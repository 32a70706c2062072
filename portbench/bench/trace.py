"""Reduction of a ``torch.profiler`` trace of the traced window.

The harness records a span ``portbench.search`` around each traced search
(the program's call and the synchronisation that ends it).  The traced window is the union of the search spans,
so the harness's own work between searches (counting a search's edges)
stays out of it.  From the profiler's device activities (kernels, copies,
memsets) inside the search spans: the busy time (the union of their
intervals), the idle share, the device time and count by name, and the
idle gaps, each named by the host operation that overlapped it most.
Device time under a host operation (:func:`device_us_under`) follows the
profiler's link from each kernel to the operation that launched it and the
operations around that.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SEARCH_SPAN = "portbench.search"
NO_OP = "(no host operation)"


@dataclass
class Trace:
    spans: list                        # [(start_us, end_us)] of the searches, sorted
    device: list                       # [(name, start_us, end_us)] inside them
    host: list                         # [(name, start_us, end_us)] host operations
    launches: list = field(default_factory=list)  # [(device us, host op names)]

    @property
    def window_us(self) -> float:
        return sum(e - s for s, e in self.spans)

    @property
    def window_s(self) -> float:
        return self.window_us / 1e6


def _clip(spans: list, starts: list, t0: float, t1: float):
    """``(t0, t1)`` cut to the search span it starts in; None outside."""
    j = bisect.bisect_right(starts, t0) - 1
    if j < 0 or t0 >= spans[j][1]:
        return None
    return t0, min(t1, spans[j][1])


def from_profiler(prof) -> Trace | None:
    """The trace of the search spans; None when the profiler recorded no
    device activity in them."""
    from torch.autograd import DeviceType

    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == SEARCH_SPAN and e.device_type == DeviceType.CPU)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    device, host, launches = [], [], []
    for e in events:
        if e.name.startswith("portbench."):
            continue    # the harness's spans, and their device-side echoes
        iv = _clip(spans, starts, e.time_range.start, e.time_range.end)
        if iv is None:
            continue
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, *iv))
            continue
        host.append((e.name, *iv))
        k_us = sum(k.duration for k in getattr(e, "kernels", ()) or ())
        if k_us:
            names, a = set(), e
            while a is not None and a.name not in names:
                names.add(a.name)
                a = a.cpu_parent
            launches.append((k_us, frozenset(names)))
    if not device:
        return None
    return Trace(spans, device, host, launches)


def merged(intervals) -> list:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr: Trace) -> float:
    return sum(e - s for s, e in merged((s, e) for _, s, e in tr.device))


def idle_share(tr: Trace) -> float:
    return 1.0 - busy_us(tr) / tr.window_us


def device_by_name(tr: Trace) -> dict:
    """name -> (device us, count)."""
    out = {}
    for name, s, e in tr.device:
        us, n = out.get(name, (0.0, 0))
        out[name] = (us + (e - s), n + 1)
    return out


def kernel_time(tr: Trace, fragment: str) -> tuple[float, int]:
    """Device us and launches of the kernels whose name holds ``fragment``."""
    hits = [(us, n) for name, (us, n) in device_by_name(tr).items() if fragment in name]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def device_us_under(tr: Trace, prefix: str) -> float:
    """Device us of the kernels launched inside a host operation whose name
    starts with ``prefix``, each kernel counted once."""
    return sum(us for us, names in tr.launches
               if any(n.startswith(prefix) for n in names))


def idle_gaps(tr: Trace) -> dict:
    """Host operation name -> us of device idle time it overlapped most."""
    busy = merged((s, e) for _, s, e in tr.device)
    gaps = []
    for s0, s1 in tr.spans:
        inside = [iv for iv in busy if iv[1] > s0 and iv[0] < s1]
        edges = [s0] + [x for iv in inside for x in iv] + [s1]
        gaps += list(zip(edges[::2], edges[1::2]))
    host = sorted(tr.host, key=lambda h: h[1])
    out: dict = {}
    nxt, active = 0, []
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        while nxt < len(host) and host[nxt][1] < g1:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[2] > g0]
        best, best_ov, best_len = NO_OP, 0.0, 0.0
        for name, s, e in active:
            ov = min(e, g1) - max(s, g0)
            if ov > best_ov or (ov == best_ov and ov > 0 and e - s < best_len):
                best, best_ov, best_len = name, ov, e - s
        out[best] = out.get(best, 0.0) + (g1 - g0)
    return out


def breakdown(tr: Trace, top: int = 10, width: int = 160) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the longest idle gaps by host operation, in seconds (a
    kernel's name cut to its first ``width`` characters)."""
    ops = sorted(((n[:width], us / 1e6) for n, (us, _) in device_by_name(tr).items()),
                 key=lambda x: -x[1])[:top]
    gaps = sorted(((n, us / 1e6) for n, us in idle_gaps(tr).items()),
                  key=lambda x: -x[1])[:top]
    return {"device_ops": [list(x) for x in ops], "idle_gaps": [list(x) for x in gaps]}
