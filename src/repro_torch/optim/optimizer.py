"""Optimizers and learning-rate schedules: the port of
``repro.optim.optimizer``, with its functional contract.

A parameter set is a mapping from the JAX package's pytree paths
(``"table"``, ``"cin/0/w"``, ``"mlp/1/b"``, ...) to tensors.
``opt.init(params)`` returns the state and ``opt.update(grads, state,
params)`` returns ``(new_params, new_state)`` without touching its inputs,
so a caller can keep an earlier step's parameters (the resume tests do).

The arithmetic follows the JAX package's to the last bit where it can:
every schedule and every update is float32 on the device (Python scalars
enter as float32, as JAX's weakly typed constants do), ``1 - b ** step``
is a float32 ``pow``, and the global-norm clip sums the squared leaves in
JAX's leaf order (:func:`leaf_order`: dict keys sorted, list items by
index).  Only the order inside each leaf's sum is torch's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

Params = dict
Schedule = Callable[[torch.Tensor], torch.Tensor]

F32 = torch.float32


def _path_key(path: str) -> tuple:
    return tuple(int(p) if p.isdigit() else p for p in path.split("/"))


def leaf_order(params) -> list:
    """The keys of a path-keyed mapping in the JAX package's pytree leaf
    order (``jax.tree.leaves`` of the nested dict / list it flattens)."""
    return sorted(params, key=_path_key)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=like.device)


# ---------------------------------------------------------------------------
# Schedules: step (an int32 tensor) -> float32 tensor on its device
# ---------------------------------------------------------------------------

def constant(lr: float) -> Schedule:
    return lambda step: _f32(lr, step)


def cosine(lr: float, warmup: int, total: int, floor: float = 0.1) -> Schedule:
    def f(step):
        step = step.to(F32)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * lr + (1 - floor) * lr * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos).to(F32)
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        floor: float = 0.01) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat plateau, then
    exponential-style decay to ``floor * lr`` over ``decay`` steps."""
    def f(step):
        step = step.to(F32)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = lr * torch.pow(_f32(floor, step), t)
        out = torch.where(step < warmup, warm,
                          torch.where(step < warmup + stable, _f32(lr, step), dec))
        return out.to(F32)
    return f


# ---------------------------------------------------------------------------
# AdamW / SGD
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 []
    m: Params
    v: Params


def _zeros(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def _step0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Params) -> AdamWState:
        zeros = _zeros(params)
        return AdamWState(_step0(params), zeros,
                          {k: z.clone() for k, z in zeros.items()})

    def update(self, grads: Params, state: AdamWState, params: Params):
        step = state.step + 1
        gf = {k: g.to(F32) for k, g in grads.items()}
        if self.grad_clip is not None:
            sq = 0
            for k in leaf_order(gf):
                sq = sq + torch.sum(torch.square(gf[k]))
            gnorm = torch.sqrt(sq)
            scale = torch.minimum(_f32(1.0, gnorm),
                                  torch.div(_f32(self.grad_clip, gnorm), gnorm + 1e-9))
            gf = {k: g * scale for k, g in gf.items()}
        b1, b2 = self.b1, self.b2
        m = {k: b1 * state.m[k] + (1 - b1) * g for k, g in gf.items()}
        v = {k: b2 * state.v[k] + (1 - b2) * g * g for k, g in gf.items()}
        stepf = step.to(F32)
        c1 = 1 - torch.pow(_f32(b1, stepf), stepf)
        c2 = 1 - torch.pow(_f32(b2, stepf), stepf)
        lr = self.schedule(step)

        def upd(p, m_, v_):
            u = (m_ / c1) / (torch.sqrt(v_ / c2) + self.eps)
            u = u + self.weight_decay * p.to(F32)
            return (p.to(F32) - lr * u).to(p.dtype)

        new_params = {k: upd(p, m[k], v[k]) for k, p in params.items()}
        return new_params, AdamWState(step, m, v)


class SGDState(NamedTuple):
    step: torch.Tensor      # int32 []
    momentum: Params


@dataclasses.dataclass(frozen=True)
class SGD:
    schedule: Schedule
    momentum: float = 0.9

    def init(self, params: Params) -> SGDState:
        return SGDState(_step0(params), _zeros(params))

    def update(self, grads: Params, state: SGDState, params: Params):
        step = state.step + 1
        lr = self.schedule(step)
        mom = {k: self.momentum * state.momentum[k] + g.to(F32)
               for k, g in grads.items()}
        new_params = {k: (p.to(F32) - lr * mom[k]).to(p.dtype)
                      for k, p in params.items()}
        return new_params, SGDState(step, mom)
