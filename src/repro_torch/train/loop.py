"""Training-loop driver: data -> step -> metrics -> checkpoint cadence (the
port of ``repro.train.loop``).

Framework-thin: the caller owns the step function; this owns restart logic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train import checkpoint


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    log_every: int = 10
    keep: int = 3


def run_loop(
    cfg: LoopConfig,
    params,
    opt_state,
    step_fn: Callable,            # (params, opt_state, batch) -> (p, s, loss)
    batch_fn: Callable[[int], Any],
    *,
    log=print,
) -> tuple[Any, Any, list[float]]:
    """Run steps ``[start, total_steps)``, where ``start`` is the latest
    checkpoint's step in ``cfg.ckpt_dir`` (0 without one), checkpointing
    every ``ckpt_every`` steps.  Returns ``(params, opt_state, losses)``,
    the losses of the logged steps."""
    start = 0
    if cfg.ckpt_dir:
        last = checkpoint.latest_step(cfg.ckpt_dir)
        if last is not None:
            state = {"params": params, "opt": opt_state}
            state, manifest = checkpoint.restore(cfg.ckpt_dir, state)
            params, opt_state = state["params"], state["opt"]
            start = manifest["step"]
            log(f"[loop] resumed from step {start}")
    losses = []
    t0 = time.perf_counter()
    for step in range(start, cfg.total_steps):
        batch = batch_fn(step)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
            lv = float(loss)
            losses.append(lv)
            dt = time.perf_counter() - t0
            log(f"[loop] step {step} loss {lv:.4f} ({dt:.1f}s)")
        if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
            checkpoint.save(cfg.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state}, keep=cfg.keep)
    return params, opt_state, losses
