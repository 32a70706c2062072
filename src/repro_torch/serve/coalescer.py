"""Query coalescer: deterministic double-buffered root-batch formation
(DESIGN.md §14).  A copy of ``repro.serve.coalescer``.

Production BFS traffic is a stream of single-root queries, but every
engine in this repo is batched: the compiled plan amortizes dispatch,
mesh collectives and (on real hardware) kernel launches across a root
batch.  The coalescer bridges the two — it packs arriving queries into
root batches under a **deadline/size policy** while the previous batch
traverses (double buffering: batch k+1 fills during batch k's flight),
so the engine never idles waiting for a full batch and a lone query
never waits longer than ``max_wait_s``.

The whole loop is a discrete-event replay over a virtual clock: query
*arrival* times come from the trace, batch *service* times come from the
injected ``solve_fn`` (the live engine reports measured wall seconds;
tests inject a deterministic cost model, exactly like the plan tuner's
``measure=``).  Given the same trace and the same service times the
packing is bit-for-bit reproducible.

Batch formation rules (all times virtual):

  * a miss seeds the *filling* buffer; its arrival starts the deadline
    clock (``t_open``);
  * the buffer closes at ``min(t_full, t_open + max_wait_s)`` — full
    beats deadline — but cannot launch before the engine is free
    (``t_launch = max(close, t_free)``); while the engine is busy,
    late arrivals keep topping the buffer up to capacity;
  * capacity counts **unique roots**: same-root queries coalesce into
    one slot and fan the single answer out (never re-traversed);
  * a query whose root is already *in flight* joins that batch's slot
    and is answered at its completion (no new slot, no re-traversal);
  * short batches are padded to ``batch_size`` by repeating the first
    root — padding rows are masked out of every account (no answers, no
    failure attribution, no occupancy credit);
  * roots whose rows still fail the spec checks after the engine's own
    recovery are **re-queued** (ready at the failing batch's completion,
    attempt counter bumped) rather than answered wrong; a query past
    ``max_requeues`` is answered as ``kind="failed"`` with no parent.
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class CoalescePolicy:
    """Deadline/size policy of the filling buffer.

    ``batch_size`` is the root-batch capacity (unique roots per launch;
    the engine pads short batches up to it), ``max_wait_s`` the longest
    a batch-seeding query waits for co-travellers before the buffer
    closes, ``max_requeues`` the per-query re-queue budget for roots the
    checked path refuses to answer.
    """

    batch_size: int = 8
    max_wait_s: float = 2e-3
    max_requeues: int = 2

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got "
                             f"{self.batch_size}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got "
                             f"{self.max_wait_s}")
        if self.max_requeues < 0:
            raise ValueError(f"max_requeues must be >= 0, got "
                             f"{self.max_requeues}")


@dataclass(frozen=True)
class Query:
    """One root query.  ``t_ready`` is when it entered the queue (the
    arrival for fresh queries, the failing batch's completion for
    re-queued ones); ``attempts`` counts prior failed traversals."""

    qid: int
    root: int
    arrival_s: float
    t_ready: float = None  # type: ignore[assignment]
    attempts: int = 0

    def __post_init__(self):
        if self.t_ready is None:
            object.__setattr__(self, "t_ready", self.arrival_s)


class BatchOutcome:
    """What ``solve_fn`` returns for one launched batch: row-major
    results for the PADDED root vector, the row indices (< n_real) still
    failing after engine-side recovery, the measured/modeled service
    seconds, and the padding-masked per-check failure counts."""

    def __init__(self, parent: np.ndarray, level: np.ndarray,
                 failed_rows=(), service_s: float = 0.0,
                 check_counts: Optional[dict] = None):
        self.parent = parent
        self.level = level
        self.failed_rows = set(int(i) for i in failed_rows)
        self.service_s = float(service_s)
        self.check_counts = dict(check_counts or {})


@dataclass
class Answer:
    """One query's resolution.  ``kind``:

      ``batch``    traversed as a member of a launched batch
      ``join``     attached to an already-in-flight batch for its root
      ``hit``      served from the hot-root cache (no traversal)
      ``requeue``  answered by a batch after >= 1 re-queue
      ``failed``   re-queue budget exhausted; ``parent`` is None

    ``latency_s`` is always ``done_s - arrival_s`` of the ORIGINAL
    arrival — re-queues accumulate latency, padding rows never produce
    an Answer at all.
    """

    qid: int
    root: int
    arrival_s: float
    done_s: float
    latency_s: float
    kind: str
    attempts: int = 0
    batch_seq: Optional[int] = None
    parent: Optional[np.ndarray] = None
    level: Optional[np.ndarray] = None


@dataclass
class BatchRecord:
    """Accounting for one launched batch (padding excluded throughout:
    ``occupancy`` is real roots / capacity)."""

    seq: int
    t_open: float
    t_launch: float
    t_complete: float
    service_s: float
    n_roots: int                # unique REAL roots traversed
    n_pad: int                  # repeated-root padding rows (masked)
    n_queries: int              # queries resolved via this batch (joins incl.)
    occupancy: float
    oldest_wait_s: float        # t_launch - t_open (the deadline policy cost)
    used_fallback: bool
    failed_roots: list = field(default_factory=list)
    check_counts: dict = field(default_factory=dict)


class _Filling:
    """The open (filling) buffer: unique-root slots in arrival order."""

    def __init__(self, q: Query, capacity: int):
        self.slots: OrderedDict[int, list] = OrderedDict({q.root: [q]})
        self.capacity = capacity
        self.t_open = q.t_ready
        self.t_full = math.inf

    @property
    def full(self) -> bool:
        return len(self.slots) >= self.capacity

    def offer(self, q: Query) -> bool:
        """Add ``q``: same-root queries always coalesce into their slot;
        a new root takes a slot only below capacity."""
        if q.root in self.slots:
            self.slots[q.root].append(q)
            return True
        if self.full:
            return False
        self.slots[q.root] = [q]
        if self.full:
            self.t_full = q.t_ready
        return True


class _InFlight:
    """A launched batch awaiting completion; late same-root queries may
    still join its slots until it completes."""

    def __init__(self, seq: int, slots: OrderedDict, t_open: float,
                 t_launch: float, outcome: BatchOutcome, n_pad: int,
                 used_fallback: bool, joined: set):
        self.seq = seq
        self.slots = slots
        self.t_open = t_open
        self.t_launch = t_launch
        self.outcome = outcome
        self.t_complete = t_launch + outcome.service_s
        self.n_pad = n_pad
        self.used_fallback = used_fallback
        self.joined = joined            # qids attached after launch


def replay(
    queries,
    policy: CoalescePolicy,
    solve_fn: Callable[[np.ndarray, int, bool], BatchOutcome],
    cache=None,
) -> tuple[list, list]:
    """Run the serving replay over ``queries`` (Query list, any order).

    ``solve_fn(padded_roots, n_real, use_fallback)`` performs one batch
    traversal: ``padded_roots`` is int32 ``[batch_size]`` (rows >=
    ``n_real`` repeat row 0 and are masked from all accounting),
    ``use_fallback`` is True when the batch carries re-queued queries so
    the engine should arm its degraded-path recovery.  ``cache`` is an
    optional :class:`repro_torch.serve.cache.ParentCache`; completed batches
    populate it at their completion time, arrivals consult it at theirs
    — the replay never lets an answer be visible before the virtual
    instant it exists.

    Returns ``(answers, batches)``; every input query yields exactly one
    :class:`Answer`.
    """
    ready: list = [(q.t_ready, q.qid, q) for q in queries]
    heapq.heapify(ready)
    seq_src = len(ready)            # requeue tie-break ids, after all fresh
    answers: list = []
    batches: list = []
    carry: deque = deque()          # misses that found the buffer full
    in_flight: Optional[_InFlight] = None
    filling: Optional[_Filling] = None
    t_free = 0.0

    def finalize(fl: _InFlight) -> None:
        nonlocal seq_src
        roots = list(fl.slots)
        failed = {roots[i] for i in fl.outcome.failed_rows
                  if i < len(roots)}
        n_queries = sum(len(qs) for qs in fl.slots.values())
        for row, root in enumerate(roots):
            qs = fl.slots[root]
            if root in failed:
                for q in qs:
                    if q.attempts >= policy.max_requeues:
                        answers.append(Answer(
                            q.qid, q.root, q.arrival_s, fl.t_complete,
                            fl.t_complete - q.arrival_s, "failed",
                            attempts=q.attempts + 1, batch_seq=fl.seq))
                    else:
                        seq_src += 1
                        heapq.heappush(ready, (fl.t_complete, seq_src,
                                               replace(q, t_ready=fl.t_complete,
                                                       attempts=q.attempts + 1)))
                continue
            p_row = fl.outcome.parent[row]
            l_row = fl.outcome.level[row]
            if cache is not None:
                cache.put(root, p_row, l_row)
            for q in qs:
                kind = ("requeue" if q.attempts > 0 else
                        "join" if q.qid in fl.joined else "batch")
                answers.append(Answer(
                    q.qid, q.root, q.arrival_s, fl.t_complete,
                    fl.t_complete - q.arrival_s, kind,
                    attempts=q.attempts, batch_seq=fl.seq,
                    parent=p_row, level=l_row))
        batches.append(BatchRecord(
            seq=fl.seq, t_open=fl.t_open, t_launch=fl.t_launch,
            t_complete=fl.t_complete, service_s=fl.outcome.service_s,
            n_roots=len(roots), n_pad=fl.n_pad,
            n_queries=n_queries,
            occupancy=len(roots) / policy.batch_size,
            oldest_wait_s=fl.t_launch - fl.t_open,
            used_fallback=fl.used_fallback,
            failed_roots=sorted(failed),
            check_counts=fl.outcome.check_counts))

    def classify(q: Query) -> bool:
        """Hit / join resolution at the query's ready time; False means
        the query needs a batch slot."""
        if cache is not None:
            ans = cache.get(q.root)
            if ans is not None:
                answers.append(Answer(
                    q.qid, q.root, q.arrival_s, q.t_ready,
                    q.t_ready - q.arrival_s, "hit", attempts=q.attempts,
                    parent=ans.parent, level=ans.level))
                return True
        if in_flight is not None and q.root in in_flight.slots:
            in_flight.slots[q.root].append(q)
            in_flight.joined.add(q.qid)
            return True
        return False

    while True:
        t_next = ready[0][0] if ready else math.inf
        t_cmpl = in_flight.t_complete if in_flight is not None else math.inf

        if filling is None:
            if carry:
                # Drain the overflow into the next buffer up to capacity.
                # No cache consult here: these queries were classified as
                # misses at their (past) ready time — answering from rows
                # cached after that would be time-travel.  Same-root
                # joins into the just-launched batch ARE legal (the root
                # was in flight before completion either way).
                while carry:
                    q = carry.popleft()
                    if in_flight is not None and q.root in in_flight.slots:
                        in_flight.slots[q.root].append(q)
                        in_flight.joined.add(q.qid)
                        continue
                    if filling is None:
                        filling = _Filling(q, policy.batch_size)
                    elif not filling.offer(q):
                        carry.appendleft(q)
                        break
                continue
            if not ready and in_flight is None:
                break
            if t_cmpl <= t_next:
                fl, in_flight = in_flight, None
                finalize(fl)
                continue
            q = heapq.heappop(ready)[2]
            if not classify(q):
                filling = _Filling(q, policy.batch_size)
            continue

        t_close = min(filling.t_full, filling.t_open + policy.max_wait_s)
        t_launch = max(t_close, t_free)
        if t_cmpl <= min(t_next, t_launch):
            fl, in_flight = in_flight, None
            finalize(fl)
            continue
        if t_next <= t_launch:
            q = heapq.heappop(ready)[2]
            if not classify(q) and not filling.offer(q):
                carry.append(q)     # buffer full: seeds the next batch
            continue

        # launch: the engine is serial, so any prior batch has already
        # completed (t_cmpl <= t_free <= t_launch finalized it above)
        assert in_flight is None
        roots = list(filling.slots)
        n_real = len(roots)
        n_pad = policy.batch_size - n_real
        padded = np.asarray(roots + [roots[0]] * n_pad, np.int32)
        use_fallback = any(q.attempts > 0
                           for qs in filling.slots.values() for q in qs)
        outcome = solve_fn(padded, n_real, use_fallback)
        # serial engine + finalize-before-launch means len(batches) is
        # always the next sequence number
        in_flight = _InFlight(len(batches), filling.slots, filling.t_open,
                              t_launch, outcome, n_pad, use_fallback, set())
        t_free = in_flight.t_complete
        filling = None

    return answers, batches
