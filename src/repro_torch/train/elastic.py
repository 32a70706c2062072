"""Elastic scaling and the straggler policy: the port of
``repro.train.elastic`` (host logic, copied).

Checkpoints store logical arrays (``checkpoint.py``), so elasticity reduces
to re-planning the mesh for the surviving devices and placing the restored
tensors there.  Straggler mitigation (monitor quorum): the gradient
reduction is hierarchical (T3: reduce-scatter within a group, the monitors
across groups, gather within the group), so a straggling group delays only
the cross-group phase; :class:`StragglerPolicy` decides per step whether to
wait, proceed with the quorum and rescale the sum by
``n_groups / n_reporting``, or evict the group and re-plan with
:func:`plan_mesh`.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.comms.mesh import Mesh
from repro_torch.train import checkpoint


def plan_mesh(n_devices: int, *, model_parallel: int = None,
              pods: int = 1, axis_names=("data", "model")) -> tuple[int, ...]:
    """Choose a (data, model) factorization for a (possibly shrunk) device
    count: keep model-parallel degree as close to the original as divides."""
    if model_parallel is None:
        model_parallel = max(1, int(math.sqrt(n_devices)))
    per_pod = n_devices // pods
    while per_pod % model_parallel:
        model_parallel //= 2
    model_parallel = max(1, model_parallel)
    data = per_pod // model_parallel
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


def reshard_restore(ckpt_dir: str, like, target, step: int | None = None):
    """Restore a checkpoint onto another placement: ``target`` is a device
    (one tree) or a :class:`~repro_torch.comms.mesh.Mesh` (one replica per
    local shard; shards on one device share one tree).  Returns
    ``(tree or list of trees, manifest)``."""
    if not isinstance(target, Mesh):
        return checkpoint.restore(ckpt_dir, like, step=step, device=target)
    trees: dict = {}
    manifest = None
    for f in target.local:
        dev = target.devices[f]
        if dev not in trees:
            trees[dev], manifest = checkpoint.restore(ckpt_dir, like, step=step,
                                                      device=dev)
    return [trees[target.devices[f]] for f in target.local], manifest


# ---------------------------------------------------------------------------
# Straggler policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    quorum_frac: float = 0.75     # proceed when this many groups reported
    wait_ms: float = 200.0        # grace period before quorum decision
    evict_after: int = 50         # consecutive slow steps before eviction

    def decide(self, n_groups: int, reported: int, slow_streak: int) -> str:
        """-> 'wait' | 'proceed' | 'evict'."""
        if reported == n_groups:
            return "proceed"
        if slow_streak >= self.evict_after:
            return "evict"
        if reported >= math.ceil(self.quorum_frac * n_groups):
            return "proceed"
        return "wait"

    @staticmethod
    def rescale(grad_sum: dict, n_groups: int, reported: int) -> dict:
        """Unbiased rescale of a partial hierarchical reduction."""
        return {k: g * (n_groups / max(reported, 1)) for k, g in grad_sum.items()}
