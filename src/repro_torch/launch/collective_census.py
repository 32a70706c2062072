"""Collective byte census for the dry run's roofline (the port's counterpart
of ``repro.launch.hlo_analysis``).

The JAX package parses the compiled HLO for collectives.  The port has no
HLO, so a census records every collective the port's code runs while the
census is active: each primitive of ``comms/mesh.VertexComm`` and
``comms/hierarchical.py`` calls :func:`repro_torch.comms.mesh.note_collective`
once per call with ``(kind, output bytes of one device, group size)``, and
does nothing else when no census is active.  The kinds are the HLO ops the
JAX package's primitive lowers to:

  * OR / min reduce-scatter over ``member``: ``all-to-all`` of the whole
    input (JAX builds it from ``lax.all_to_all`` and a local fold);
  * OR / min all-reduce over an axis: non-tiled ``all-gather`` (gather and
    a local fold);
  * the codec's inter-group leg: two ``all-gather``\\ s, the ``(mode,
    count)`` header and the payload;
  * the sum reduce-scatter: ``reduce-scatter``; the sum all-reduce and the
    scalar ``VertexComm.psum``: ``all-reduce``;
  * the member / group / flat gathers: ``all-gather``;
  * the hierarchical all-to-all: two ``all-to-all``\\ s (member, then
    group); the flat one: one over every shard.

Reported per kind, with the ring formulas of ``hlo_analysis.py`` kept
exactly (N the group size):

  * ``operand_bytes`` — the sum of operand sizes;
  * ``link_bytes`` — bytes that cross links per device:
      all-gather      (N-1)/N x output
      reduce-scatter  (N-1)/N x operand (= N x output)
      all-reduce      2 (N-1)/N x size
      all-to-all      (N-1)/N x size
      collective-permute  size

**Modelled entries** (``"modeled": true``).  The port runs on one card, so
some collectives that the JAX cell's shardings imply never run.  The cell
plans (``launch.input_specs``) enter them through :meth:`Census.model`, the
same formulas, with these rules:

  * *Megatron TP over* ``model`` (size M > 1): per transformer layer two
    all-reduces of the block's activations ``[B/D, S, d_model]`` in bf16
    in the forward (after ``wo`` and after the MLP / MoE combine), two in
    the backward (the column-parallel inputs' gradients) and two in the
    remat recompute; one more each for the vocab-sharded embedding lookup
    (forward, backward).  With a sequence-sharded layout each all-reduce is
    a reduce-scatter plus an all-gather of the same activation.
  * *Data-parallel gradients* over the batch axes (size D > 1): one
    all-reduce of every parameter's gradient shard (its shard shape, in its
    dtype); under ZeRO-1 a reduce-scatter of it plus an all-gather of the
    updated parameter shard.
  * *The decode cache's sequence-sharded reductions*: when the KV cache's
    sequence is sharded over ``model`` (or, at batch 1, over every axis),
    each layer all-reduces the attention partials over those shards: the
    float32 output ``[B/D, H, head_dim]`` and its max and sum ``[B/D, H]``.
  * *Row-sharded embedding tables* (xDeepFM, over ``model``): one
    all-reduce of the looked-up rows ``[B/D, F, d]`` in float32 in the
    forward, one in the backward of a train step.
  * *The transposes of differentiated collectives*: a collective that the
    port runs on an input that requires a gradient has its transpose in
    the backward (all-gather and reduce-scatter swap, an all-to-all and an
    all-reduce stay what they are), of the same bytes.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.comms import mesh as _mesh

# HLO dtype names -> bytes (a copy of the JAX package's table).
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")
_TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
              "all-reduce": "all-reduce", "all-to-all": "all-to-all",
              "collective-permute": "collective-permute"}


def shape_bytes(dtype: str, shape) -> int:
    """Bytes of an array of HLO dtype ``dtype`` and ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def ring_bytes(kind: str, out_bytes: float, n: int) -> tuple[float, float]:
    """(operand bytes, link bytes) of one collective of ``kind`` whose
    output on one device is ``out_bytes``, over a group of ``n``."""
    n = max(int(n), 1)
    if kind == "all-gather":
        return out_bytes / n, out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        op = out_bytes * n
        return op, op * (n - 1) / n
    if kind == "all-reduce":
        return out_bytes, 2.0 * out_bytes * (n - 1) / n
    if kind == "all-to-all":
        return out_bytes, out_bytes * (n - 1) / n
    if kind == "collective-permute":
        return out_bytes, out_bytes
    raise ValueError(f"unknown collective {kind!r}; expected one of {KINDS}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    operand_bytes: dict
    link_bytes: dict

    @property
    def total_operand_bytes(self) -> float:
        return float(sum(self.operand_bytes.values()))

    @property
    def total_link_bytes(self) -> float:
        return float(sum(self.link_bytes.values()))

    def to_json(self):
        return {
            "counts": dict(self.counts),
            "operand_bytes": {k: float(v) for k, v in self.operand_bytes.items()},
            "link_bytes": {k: float(v) for k, v in self.link_bytes.items()},
            "total_operand_bytes": self.total_operand_bytes,
            "total_link_bytes": self.total_link_bytes,
        }


def collective_stats(entries) -> CollectiveStats:
    """Fold ``(kind, output bytes, group size)`` entries into per-kind
    counts, operand bytes and link bytes."""
    counts = defaultdict(int)
    operand = defaultdict(float)
    link = defaultdict(float)
    for kind, out_bytes, n, *_ in entries:
        op, lk = ring_bytes(kind, float(out_bytes), n)
        counts[kind] += 1
        operand[kind] += op
        link[kind] += lk
    return CollectiveStats(counts, operand, link)


class Census:
    """The collectives one run issues, as ``(kind, output bytes, group size,
    modeled, what)`` entries.  Use as a context manager around the run;
    censuses do not nest."""

    def __init__(self):
        self.entries: list[tuple] = []

    def __enter__(self) -> "Census":
        if _mesh._census is not None:
            raise RuntimeError("a collective census is already active")
        _mesh._census = self._note
        return self

    def __exit__(self, *exc) -> None:
        _mesh._census = None

    def _note(self, kind: str, out_bytes: int, group: int, grad: bool) -> None:
        self.entries.append((kind, int(out_bytes), int(group), False, "run"))
        if grad:
            self.entries.append((_TRANSPOSE[kind], int(out_bytes), int(group), True,
                                 "transpose of a differentiated " + kind))

    def model(self, kind: str, out_bytes: float, group: int, what: str,
              times: int = 1) -> None:
        """Enter ``times`` modelled collectives (no-op for a group of 1)."""
        if group > 1:
            for _ in range(times):
                self.entries.append((kind, float(out_bytes), int(group), True, what))

    def stats(self, modeled=None) -> CollectiveStats:
        """Stats of every entry (``modeled=None``), or only the modelled
        (True) or run (False) ones."""
        return collective_stats([e for e in self.entries
                                 if modeled is None or e[3] == modeled])

    def to_json(self) -> dict:
        out = self.stats().to_json()
        out["run"] = self.stats(False).to_json()
        out["modeled"] = self.stats(True).to_json()
        whats = defaultdict(lambda: [0, 0.0])
        for kind, b, n, modeled, what in self.entries:
            if modeled:
                whats[what][0] += 1
                whats[what][1] += ring_bytes(kind, b, n)[1]
        out["modeled_by_rule"] = {k: {"count": c, "link_bytes": lb}
                                  for k, (c, lb) in sorted(whats.items())}
        out["extrapolated"] = False
        return out
