"""2-D-tree interconnect model + monitor election (paper §3.3, §4.3, eq. 5).
A copy of ``repro.comms.topology`` (numpy only).

The Tianhe pre-exascale fabric is a 4-level optoelectronic 2-D tree:
nodes -> HFR-E router (24 ports) -> switchboard -> bunch-of-blades -> cabinet.
Eq. (5) decomposes accumulated hops::

    acc_hops = HNR_hops + NRM_hops + BoB_hops + Cab_hops

We model it as a complete tree with per-level fanouts; a message between
nodes whose lowest common ancestor is level L costs ``2L - 1`` hops (up
L-1 switches, across, down L-1). Level 1 (same router) costs 1 hop —
matching the paper's "message from and to a same group only need one or
several hops".

Monitor election policies (paper Fig. 15):
  random    — any node of the group
  heaviest  — the node holding the heaviest buffered vertex
  orchestra — minimize traffic-weighted hops: intra-group collection cost
              + inter-monitor mirror-group cost, solved by 2 rounds of
              coordinate descent over groups (the paper's "centrality,
              proportion of heavy vertices and topology" criterion)

On a device mesh the same machinery plans the (group, member) split of
the vertex-sharded engine (:func:`plan_device_mesh`, which the plan
auto-tuner enumerates); the hop model doubles as the cost model for the
Fig. 16 benchmark.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Default fanouts: 4 nodes/router, 8 routers/switchboard, 4 boards/BoB,
# 4 BoBs/cabinet -> 512 nodes (the full system).
DEFAULT_FANOUTS = (4, 8, 4, 4)
LEVEL_NAMES = ("HNR", "NRM", "BoB", "Cab")


@dataclass(frozen=True)
class TreeTopology:
    fanouts: tuple[int, ...] = DEFAULT_FANOUTS

    @property
    def n_nodes(self) -> int:
        return int(np.prod(self.fanouts))

    @property
    def group_size(self) -> int:
        """Nodes per HFR-E router — the monitor group size."""
        return self.fanouts[0]

    @property
    def n_groups(self) -> int:
        return self.n_nodes // self.group_size

    def level(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Lowest-common-ancestor level of node pairs (0 = same node).

        Level i means: a and b fall in the same level-i subtree (of
        ``prod(fanouts[:i])`` nodes) but different level-(i-1) subtrees.
        """
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        lvl = np.zeros(np.broadcast_shapes(a.shape, b.shape), np.int64)
        size = 1
        for i, f in enumerate(self.fanouts, start=1):
            prev = size
            size *= f
            exact = ((a // prev) != (b // prev)) & ((a // size) == (b // size))
            lvl = np.where(exact, i, lvl)
        return lvl

    def hops(self, a, b) -> np.ndarray:
        """Hop count between nodes per the 2L-1 tree-switch model."""
        lvl = self.level(a, b)
        return np.where(lvl == 0, 0, 2 * lvl - 1)

    def hop_breakdown(self, a, b) -> dict[str, np.ndarray]:
        """Per-level hop attribution (eq. 5 terms)."""
        lvl = self.level(a, b)
        out = {}
        for i, name in enumerate(LEVEL_NAMES):
            # a message at LCA level L spends 2 hops at each level < L
            # and 1 hop at level L (the crossing switch)
            contrib = np.where(lvl > i + 1, 2, np.where(lvl == i + 1, 1, 0))
            out[f"{name}_hops"] = contrib
        return out

    def group_of(self, node) -> np.ndarray:
        return np.asarray(node) // self.group_size


@dataclass
class MonitorPlan:
    topology: TreeTopology
    monitors: np.ndarray  # [n_groups] node id elected per group
    policy: str

    def route_hops(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Hops of monitor-routed messages: src -> mon(src) -> mon(dst) -> dst."""
        t = self.topology
        gs, gd = t.group_of(src), t.group_of(dst)
        ms, md = self.monitors[gs], self.monitors[gd]
        same_group = gs == gd
        direct = t.hops(src, dst)
        routed = t.hops(src, ms) + t.hops(ms, md) + t.hops(md, dst)
        return np.where(same_group, direct, routed)

    def batched_route_hops(self, src: np.ndarray, dst: np.ndarray) -> float:
        """Like route_hops but inter-monitor legs batch per (gs, gd) pair —
        the paper's "forwarding <A0,A1> for message_1 and message_2 would
        further batch into only one-time communication"."""
        t = self.topology
        gs, gd = t.group_of(src), t.group_of(dst)
        ms, md = self.monitors[gs], self.monitors[gd]
        same = gs == gd
        intra = np.where(same, t.hops(src, dst),
                         t.hops(src, ms) + t.hops(md, dst))
        total = float(np.sum(intra))
        pairs = {(int(a), int(b)) for a, b in zip(gs[~same], gd[~same])}
        for a, b in pairs:
            total += float(t.hops(self.monitors[a], self.monitors[b]))
        return total


def elect_monitors(
    topology: TreeTopology,
    heavy_weight: np.ndarray,   # [n_nodes] heavy-vertex traffic proxy
    policy: str = "orchestra",
    seed: int = 0,
    traffic: np.ndarray | None = None,  # [n_groups, n_groups] optional
) -> MonitorPlan:
    t = topology
    g, gs = t.n_groups, t.group_size
    nodes = np.arange(t.n_nodes).reshape(g, gs)
    w = np.asarray(heavy_weight, np.float64).reshape(g, gs)

    if policy == "random":
        rng = np.random.default_rng(seed)
        mon = nodes[np.arange(g), rng.integers(0, gs, size=g)]
    elif policy == "heaviest":
        mon = nodes[np.arange(g), np.argmax(w, axis=1)]
    elif policy == "orchestra":
        # coordinate descent: per group pick the member minimizing
        #   sum_members w_m * hops(m, cand)            (collection)
        # + sum_other_groups traffic * hops(cand, mon_other)  (mirror group)
        if traffic is None:
            gw = w.sum(axis=1)
            traffic = np.outer(gw, gw) / max(gw.sum(), 1.0)
        mon = nodes[np.arange(g), np.argmax(w, axis=1)]  # heaviest init
        for _ in range(2):
            for gi in range(g):
                cands = nodes[gi]
                collect = np.array([
                    float(np.sum(w[gi] * t.hops(nodes[gi], c))) for c in cands
                ])
                others = np.delete(np.arange(g), gi)
                mirror = np.array([
                    float(np.sum(traffic[gi, others] * t.hops(c, mon[others])))
                    for c in cands
                ])
                mon[gi] = cands[np.argmin(collect + mirror)]
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return MonitorPlan(topology=t, monitors=mon, policy=policy)


def plan_device_mesh(
    n_devices: int,
    topology: TreeTopology | None = None,
) -> tuple[int, int]:
    """Factor ``n_devices`` into the (group, member) mesh shape for the
    vertex-sharded BFS engine (paper T3 mapped onto mesh axes).

    The member axis models one router group: its size is the largest
    divisor of ``n_devices`` not exceeding the topology's ``group_size``
    (default fanouts: 4 nodes per HFR-E router) — members fill a router
    before a second router is used, exactly as nodes do on the machine.
    Everything above rides the group axis, the inter-group (monitor
    mirror) phase of the two-phase collective.  Default topology:
    1 -> (1, 1), 2 -> (1, 2), 4 -> (1, 4), 8 -> (2, 4), 512 -> (128, 4).
    """
    t = topology or TreeTopology()
    gs = t.group_size
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    member = 1
    for cand in range(min(gs, n_devices), 0, -1):
        if n_devices % cand == 0:
            member = cand
            break
    return n_devices // member, member


def simulate_messages(
    n_messages: int,
    topology: TreeTopology,
    seed: int = 0,
    skew: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Random peer-to-peer message pattern (bottom-up BFS traffic proxy).

    ``skew`` biases destinations toward heavy-vertex owners (power-law),
    matching "over 95% messages roam more than one networking hop".
    """
    rng = np.random.default_rng(seed)
    n = topology.n_nodes
    src = rng.integers(0, n, size=n_messages)
    if skew is None:
        dst = rng.integers(0, n, size=n_messages)
    else:
        p = np.asarray(skew, np.float64)
        p = p / p.sum()
        dst = rng.choice(n, size=n_messages, p=p)
    return src, dst
