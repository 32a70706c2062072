"""Device meshes of the port: virtual meshes on one device, and process
meshes over ``torch.distributed``.

Counterpart of ``repro.util.make_mesh`` and of the JAX package's forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count``).  A
:class:`Mesh` names its axes and sizes and holds one ``torch.device`` per
flat shard (row-major over the axes, so the vertex shards of a
``(group, member)`` mesh are group-major, as JAX's ``_shard_index``
numbers them), plus the flat shards this process holds.

  * **Virtual mesh** (``make_mesh(..., virtual=True)``): every shard lies on
    the one ``device``.  The sharded engines run them in lockstep from one
    host loop; a collective is a tensor operation over the list of shard
    tensors.  This is what the CPU tests and the one-card chip runs use.
  * **Device mesh** (the default): one shard per visible card; fewer cards
    than shards is a ``ValueError``.  A shard on another card is reached
    with ``.to(device)``.
  * **Process mesh**: inside an initialised ``torch.distributed`` group a
    mesh with a ``group`` axis aligns that axis to the process rank, as the
    JAX package aligns it to the process boundary: process ``p`` holds the
    ``member`` shards of group ``p`` (of every root lane), all on its own
    device.  The member legs of the collectives stay in the process; the
    legs over ``group`` and the scalar sums go through
    ``torch.distributed.all_gather`` / ``all_reduce``.  The backend is gloo,
    which takes CPU tensors: a CUDA tensor is staged through the host
    (``.cpu()``, the collective, ``.to(device)``), and on one card that host
    hop *is* the wire between the processes.  NCCL, with one card per rank,
    needs a machine with several cards.

:class:`VertexComm` is the collective layer over the vertex shards of one
root lane; ``comms.hierarchical`` builds the monitor exchange on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
import torch

from repro_torch.util import resolve_device


def dist_world() -> tuple[int, int]:
    """``(rank, world size)`` of the initialised ``torch.distributed`` group,
    ``(0, 1)`` when there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True, eq=False)
class Mesh:
    """A named device mesh: shard ``f`` (row-major over ``shape``) lies on
    ``devices[f]``; this process holds the flat shards ``local``."""

    shape: tuple
    axis_names: tuple
    devices: tuple
    local: tuple
    world: int = 1      # processes the mesh spans

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans several processes."""
        return self.world > 1

    @property
    def axes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_mesh(shape, axis_names, *, device=None, virtual: bool = False) -> Mesh:
    """Build a mesh of ``shape`` with ``axis_names``.

    ``virtual=True`` puts every shard on ``device`` (None: the card).  With
    ``virtual=False`` there is one shard per visible card of ``device``'s
    type (one device on the CPU), and too few is JAX's ``ValueError``.  In
    an initialised ``torch.distributed`` group a mesh with a ``group`` axis
    is a process mesh: that axis must equal the world size (``ValueError``
    otherwise), and this process's shards (its group's) lie on ``device``.
    """
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    dev = resolve_device(device)
    n = math.prod(shape)
    rank, world = dist_world()
    if world > 1 and "group" in axis_names:
        g = shape[axis_names.index("group")]
        if g != world:
            raise ValueError(
                f"a process mesh aligns 'group' to the processes: group axis "
                f"{g} != {world} processes (mesh shape {shape})")
        gi = axis_names.index("group")
        local = tuple(f for f in range(n) if _coords(f, shape)[gi] == rank)
        return Mesh(shape, axis_names, (dev,) * n, local, world=world)
    if virtual:
        return Mesh(shape, axis_names, (dev,) * n, tuple(range(n)))
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", i) for i in range(min(n, have)))
    else:
        have, devices = 1, (dev,)
    if n > have:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {have}")
    return Mesh(shape, axis_names, devices, tuple(range(n)))


def _coords(f: int, shape: tuple) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(f % s)
        f //= s
    return tuple(reversed(out))


class VertexComm:
    """Collectives over the vertex shards ``d = g*M + m`` of root lane
    ``lane`` of a mesh with ``group`` and ``member`` axes.

    Every method takes and returns lists over this process's vertex shards
    (:attr:`local`, ascending).  A gather returns, for each local shard, the
    list of its peers' tensors along the axis, on the shard's device; shards
    with the same peers share one list, so a fold over it can be computed
    once (:func:`repro_torch.comms.hierarchical` keys its folds on it).
    """

    def __init__(self, mesh: Mesh, lane: int = 0):
        self.mesh = mesh
        self.G = mesh.size("group")
        self.M = mesh.size("member")
        self.n = self.G * self.M
        base = lane * self.n
        self.local = [f - base for f in mesh.local if base <= f < base + self.n]
        self.devices = [mesh.devices[base + d] for d in self.local]
        self.device = self.devices[0]
        self.distributed = mesh.distributed

    def _wire(self, xs: list) -> list:
        """All-gather this process's stacked shard tensors over the group
        axis (the processes): ``[G][M, ...]`` on this process's device."""
        import torch.distributed as dist

        stacked = torch.stack(xs).cpu()
        out = [torch.empty_like(stacked) for _ in range(self.mesh.world)]
        dist.all_gather(out, stacked)
        return [t.to(self.device) for t in out]

    def gather(self, xs: list, axis: str) -> list:
        """Per local shard, its peers' tensors along ``axis``: ``"member"``
        (the shards of its group, by member), ``"group"`` (the shards of its
        member index, by group) or ``"flat"`` (every shard, group-major)."""
        M = self.M
        if self.distributed and axis != "member":
            blocks = self._wire(xs)     # [G][M, ...]
            by_d = {g * M + m: blocks[g][m] for g in range(self.G) for m in range(M)}
        else:
            by_d = dict(zip(self.local, xs))
        if axis == "member":
            key, peers = (lambda d: d // M), (lambda d: [by_d[d // M * M + m]
                                                         for m in range(M)])
        elif axis == "group":
            key, peers = (lambda d: d % M), (lambda d: [by_d[g * M + d % M]
                                                        for g in range(self.G)])
        elif axis == "flat":
            key, peers = (lambda d: 0), (lambda d: [by_d[e] for e in range(self.n)])
        else:
            raise ValueError(f"unknown axis {axis!r}")
        lists: dict = {}
        out = []
        for d in self.local:
            if key(d) not in lists:
                lists[key(d)] = peers(d)
            out.append(lists[key(d)])
        if len(set(self.devices)) > 1:   # a device mesh over several cards
            out = [[t.to(dev) for t in ps] for ps, dev in zip(out, self.devices)]
        return out

    def psum(self, vals: list) -> torch.Tensor:
        """Sum over every vertex shard of the local shards' equally shaped
        int64 tensors (the JAX package's psum over both axes)."""
        tot = torch.stack([v.to(self.device, torch.int64) for v in vals]).sum(0)
        if self.distributed:
            import torch.distributed as dist

            host = tot.cpu()
            dist.all_reduce(host)
            tot = host.to(self.device)
        return tot

    def all_rows(self, rows: list) -> list:
        """Every vertex shard's row (``rows`` are this process's, by local
        shard): the replicate step that gives every process the full
        result."""
        if not self.distributed:
            return rows
        blocks = self._wire(rows)
        return [blocks[g][m] for g in range(self.G) for m in range(self.M)]
