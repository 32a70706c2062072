"""Deterministic fault injection for the Graph500 engines (DESIGN.md §13).

Counterpart of ``repro.core.faults``.  A :class:`FaultSpec`
names one injection **site**, one **kind** of corruption and firing
predicates (level / device / root); ``compile_plan(plan, built, fault=...)``
threads it into every traversal of the compiled plan, so the checked
execution of ``CompiledBFS.run(..., check=...)`` and the retry -> fallback ->
quarantine recovery can be exercised deterministically.

The JAX package evaluates the predicates on traced loop values and bakes the
fault into the compiled program.  Here the level and root are host ints of
the engines' host loops, so :func:`fires` decides on the host and returns a
Python bool, and the corruption is one ``torch.where`` on the level's mask.
A traversal with ``fault=None`` (or a fault of another site) makes exactly
the device operations it made without the hook.

Sites, as in the JAX package:

  ``parent``      the parent epilogue of the bitmap BFS engines (one device
                  and sharded) and of the SSSP engines; kinds ``self`` (the
                  vertices found become their own parent) and ``offset``
                  (their parent id is bumped +1 mod V);
  ``exchange``    a shard's outgoing per-level delta words at the entry of
                  the sharded engines' exchange (every wiring); kinds
                  ``zero`` and ``flip`` (one bit XORed in);
  ``codec``       a shard's encoded ``(mode, payload, count)`` wire triple
                  on the inter-group leg of ``hier_or_packed`` /
                  ``hier_or_sieve``; kinds ``payload_flip``,
                  ``trunc_count`` and ``wrong_mode``;
  ``inter_group`` the inter-group leg of the OR and min exchanges: every
                  receiver keeps only group 0's contribution; kind ``drop``;
  ``sieve``       the visited-sieve mask of ``hier_or_sieve`` marked
                  all-ones; kind ``stale``.

The last four act on the multi-device exchange: on one device there is none,
and a fault of those sites is accepted and does nothing, as in the JAX
package.  Their predicates see the flat vertex-shard index as ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

FAULT_SITES = ("exchange", "parent", "codec", "inter_group", "sieve")

FAULT_KINDS = {
    "exchange": ("zero", "flip"),
    "parent": ("self", "offset"),
    "codec": ("payload_flip", "trunc_count", "wrong_mode"),
    "inter_group": ("drop",),
    "sieve": ("stale",),
}

#: The fault classes of the detection matrix: one (site, kind) pair per
#: distinct silent-corruption mode.
FAULT_CLASSES = tuple(
    (site, kind) for site in FAULT_SITES for kind in FAULT_KINDS[site])


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic injected fault (frozen, hashable).

    ``level``/``device``/``root`` are firing predicates on the loop's level
    (SSSP: round), the flat shard index and the traversal's root (``-1``
    matches everything); ``persistent=True`` widens the level predicate
    from ``lvl == level`` to ``lvl >= level``.  ``word`` / ``bit`` /
    ``seed`` parameterize the exchange corruptions.
    """

    site: str
    kind: str
    level: int = -1        # BFS level to fire at (-1 = every level)
    persistent: bool = False  # fire at every level >= `level`
    device: int = -1       # flat shard index (-1 = every device)
    root: int = -1         # global root id (-1 = every root)
    word: int = 0          # target word / payload slot
    bit: int = 0           # target bit within the word
    seed: int = 0          # mixed into the payload_flip mask

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; expected "
                             f"one of {FAULT_SITES}")
        if self.kind not in FAULT_KINDS[self.site]:
            raise ValueError(
                f"unknown kind {self.kind!r} for site {self.site!r}; "
                f"expected one of {FAULT_KINDS[self.site]}")

    def describe(self) -> str:
        when = ("always" if self.level < 0 else
                f"level>={self.level}" if self.persistent else
                f"level=={self.level}")
        where = "all devices" if self.device < 0 else f"device {self.device}"
        which = "all roots" if self.root < 0 else f"root {self.root}"
        return (f"{self.site}/{self.kind} @ {when}, {where}, {which}")


def fires(fault, site: str, *, level=None, device=None, root=None):
    """Whether ``fault`` fires at this ``site`` for the given loop values
    (host ints), or ``None`` when it cannot (no fault, another site), so
    callers skip the hook entirely."""
    if fault is None or fault.site != site:
        return None
    act = True
    if level is not None and fault.level >= 0:
        act &= (int(level) >= fault.level if fault.persistent
                else int(level) == fault.level)
    if device is not None and fault.device >= 0:
        act &= int(device) == fault.device
    if root is not None and fault.root >= 0:
        act &= int(root) == fault.root
    return act


def corrupt_parent(fault, parent: torch.Tensor, newly: torch.Tensor,
                   self_ids: torch.Tensor, sentinel: int, *, level,
                   device=None, root=None) -> torch.Tensor:
    """Site ``parent``: corrupt the parent epilogue of one level.

    ``parent`` holds the post-relax int32 parents of the level's vertex
    range (unvisited marked ``sentinel``), ``newly`` the vertices found
    (BFS) or improved (SSSP) this level, ``self_ids`` each slot's own
    vertex id.  Returns ``parent`` itself when the fault does not fire.
    """
    if not fires(fault, "parent", level=level, device=device, root=root):
        return parent
    if fault.kind == "self":
        wrong = self_ids.to(parent.dtype)
    else:  # offset: a wrong-but-plausible (in-range) parent id
        wrong = torch.where(parent + 1 >= sentinel, 0, parent + 1)
    return torch.where(newly, wrong, parent)


def _wrap32(x: int) -> int:
    """A 32-bit pattern as the int32 value of the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _flip_mask(fault) -> int:
    """Seed-derived 32-bit corruption mask (never zero), as int32 bits."""
    m = ((fault.seed * 0x9E3779B1) ^ 0x5A5A5A5A) & 0xFFFFFFFF
    return _wrap32(m or 0x5A5A5A5A)


def corrupt_delta(fault, words: torch.Tensor, *, level, device=None,
                  root=None) -> torch.Tensor:
    """Site ``exchange``: corrupt a shard's outgoing int32 delta words (a
    new tensor; ``words`` itself is left as it was)."""
    if not fires(fault, "exchange", level=level, device=device, root=root):
        return words
    if fault.kind == "zero":
        return torch.zeros_like(words)
    bad = words.clone()
    w = fault.word % words.shape[0]
    bad[w] ^= _wrap32(1 << (fault.bit % 32))
    return bad


def corrupt_encoded(fault, mode: torch.Tensor, payload: torch.Tensor,
                    count: torch.Tensor, *, level, device=None, root=None):
    """Site ``codec``: corrupt a shard's ``(mode, payload, count)`` wire
    triple between encode and decode."""
    if not fires(fault, "codec", level=level, device=device, root=root):
        return mode, payload, count
    if fault.kind == "payload_flip":
        bad = payload.clone()
        w = fault.word % payload.shape[0]
        bad[w] ^= _flip_mask(fault)
        return mode, bad, count
    if fault.kind == "trunc_count":
        return mode, payload, count // 2
    return 1 - mode, payload, count     # wrong_mode: sparse <-> dense


def drop_peers(fault, combined: torch.Tensor, first_leg: torch.Tensor, *,
               level, device=None, root=None) -> torch.Tensor:
    """Site ``inter_group``: the combined inter-group result loses every
    contribution but group 0's (``first_leg``)."""
    if not fires(fault, "inter_group", level=level, device=device, root=root):
        return combined
    return first_leg


def corrupt_known(fault, known: torch.Tensor, *, level, device=None,
                  root=None) -> torch.Tensor:
    """Site ``sieve``: a maximally stale visited-sieve mask (every bit
    claimed known, so the sieve strips the whole delta)."""
    if not fires(fault, "sieve", level=level, device=device, root=root):
        return known
    return torch.full_like(known, -1)
