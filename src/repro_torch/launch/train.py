"""Training CLI launcher: the port of ``repro.launch.train``'s graph500 and
recsys branches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm --full --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch graph500 --scale 16

Runs on the card (``--device cpu`` for the plain versions).  The smoke
config is the default; ``--full`` instantiates the published widths
(xDeepFM: 39 fields x 2^20 rows, D = 10, CIN 200-200-200, MLP 400-400).
The recsys branch trains with ``AdamW(cosine(1e-3, 5, steps))`` on batches
of ``8 x --batch`` rows from ``data.synthetic.recsys_batch`` through
``train.loop.run_loop``, checkpointing into ``--ckpt-dir`` (resuming from
its latest checkpoint) when one is given.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import all_arch_ids, get
from repro_torch.data.synthetic import recsys_batch
from repro_torch.optim import AdamW, cosine
from repro_torch.train import train_step as TS
from repro_torch.train.loop import LoopConfig, run_loop
from repro_torch.util import resolve_device


def main(argv: list | None = None, *, log=print) -> dict:
    """Run the launcher; returns what it printed as numbers (the recsys
    branch: ``losses``; graph500: ``harmonic_mean_teps`` and ``valid``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_arch_ids())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = get(args.arch)
    cfg = spec.make_config() if args.full else spec.make_smoke_config()
    log(f"[train] arch={args.arch} family={spec.family} cfg={cfg}")

    if spec.family == "graph500":
        from repro_torch.core.pipeline import run
        cfg = dataclasses.replace(cfg, scale=args.scale, device=device.type)
        _, result = run(cfg)
        log(f"[train] GTEPS={result.harmonic_mean_teps / 1e9:.5f} "
            f"valid={result.all_valid}")
        return dict(harmonic_mean_teps=result.harmonic_mean_teps,
                    valid=result.all_valid)

    from repro_torch.models import recsys
    params = recsys.init_params(cfg, seed=0, device=device)
    opt = AdamW(cosine(1e-3, 5, args.steps))
    step = TS.make_xdeepfm_train_step(cfg, opt)

    def batch_fn(i):
        return recsys_batch(0, i, args.batch * 8, cfg.n_sparse,
                            cfg.rows_per_field, device=device)

    opt_state = opt.init(params)
    lc = LoopConfig(total_steps=args.steps,
                    ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 2, 1),
                    log_every=max(args.steps // 10, 1))
    _, _, losses = run_loop(lc, params, opt_state, step, batch_fn, log=log)
    if losses:
        log(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        log(f"[train] done: the checkpoint is at step {args.steps} already")
    return dict(losses=losses)


if __name__ == "__main__":
    main()
