"""Kernel registry: the Graph500 kernels the plan layer dispatches on.

Counterpart of ``repro.core.kernels``.  A kernel is one point on four
interface axes: the state carried across the round loop (BFS: frontier and
visited; SSSP: the changed set and a distance plane), the relax rule, the
exchange combine of the sharded engines (OR for BFS, min for SSSP), and
the result/validation contract (the five BFS checks or the five SSSP
invariants).  ``plan.validate_plan`` and ``plan.compile_plan`` consult
this table; the engines live in ``hybrid_bfs`` and ``sssp_steps``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.hybrid_bfs import ENGINES, SHARD_EXCHANGES
from repro_torch.core.sssp_steps import SSSP_EXCHANGES
from repro_torch.core.validate import (
    CHECK_NAMES, SSSP_CHECK_NAMES, validate_batch, validate_sssp_batch,
)


@dataclass(frozen=True)
class KernelSpec:
    """One kernel row: the static facts the plan layer dispatches on."""

    name: str
    combine: str             # shard-exchange reduction: "or" | "min"
    needs_weights: bool      # requires an EdgeView weight plane
    engines: tuple           # plan.engine values this kernel supports
    shard_exchanges: tuple   # valid plan.exchange values for this kernel
    default_exchange: str    # what the generic default normalizes to
    check_names: tuple       # validation vocabulary (failure attribution)


KERNELS = {
    "bfs": KernelSpec(
        name="bfs", combine="or", needs_weights=False,
        engines=ENGINES, shard_exchanges=SHARD_EXCHANGES,
        default_exchange="hier_or", check_names=CHECK_NAMES),
    "sssp": KernelSpec(
        name="sssp", combine="min", needs_weights=True,
        engines=("bitmap",), shard_exchanges=SSSP_EXCHANGES,
        default_exchange="hier_min", check_names=SSSP_CHECK_NAMES),
}


def kernel_spec(name: str) -> KernelSpec:
    spec = KERNELS.get(name)
    if spec is None:
        raise ValueError(f"unknown kernel {name!r}; expected one of "
                         f"{tuple(KERNELS)}")
    return spec


def rekernel_plan(plan, kernel: str):
    """Retarget ``plan`` at ``kernel``: layout, mesh, partition and α/β
    carry over, and an exchange outside the target kernel's family falls
    back to that kernel's default wiring."""
    if kernel == plan.kernel:
        return plan
    spec = kernel_spec(kernel)
    kw: dict = {"kernel": kernel}
    if plan.exchange not in spec.shard_exchanges:
        kw["exchange"] = spec.default_exchange
    return dataclasses.replace(plan, **kw)


def validate_result_batch(kernel: str, ev, parents, levels, roots):
    """The kernel's batched spec validation."""
    if kernel == "sssp":
        return validate_sssp_batch(ev, parents, levels, roots)
    return validate_batch(ev, parents, levels, roots)
