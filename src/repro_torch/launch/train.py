"""Training CLI launcher: the port of ``repro.launch.train`` (its graph500,
LM, recsys and GNN branches).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm --full --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch graph500 --scale 16

Runs on the card (``--device cpu`` for the plain versions).  The smoke
config is the default; ``--full`` instantiates the published widths
(xDeepFM: 39 fields x 2^20 rows, D = 10, CIN 200-200-200, MLP 400-400;
olmo-1b: 16 layers, d 2048, vocab 50,304).  The LM branch trains on
``--batch`` sequences of ``--seq`` tokens from ``data.synthetic.lm_batch``
with ``AdamW(wsd(3e-4, 5, max(steps - 15, 5), 10))`` for ``minicpm-2b`` and
``AdamW(cosine(3e-4, 5, steps))`` otherwise.  The recsys branch trains with
``AdamW(cosine(1e-3, 5, steps))`` on batches of ``8 x --batch`` rows from
``data.synthetic.recsys_batch``.  The GNN branch trains with
``AdamW(cosine(1e-3, 5, steps))`` on one fixed graph: ``gat-cora`` and
``graphsage-reddit`` full-graph on ``make_feature_graph(0, --scale,
edge_factor=4)``, ``dimenet`` and ``equiformer-v2`` on
``make_molecule_batch(0, 8, 8, 16)`` against zero targets.  Each runs
through ``train.loop.run_loop``, checkpointing into ``--ckpt-dir``
(resuming from its latest checkpoint) when one is given.  An unknown
family raises ``ValueError``.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import all_arch_ids, get
from repro_torch.data.synthetic import lm_batch, recsys_batch
from repro_torch.optim import AdamW, cosine, wsd
from repro_torch.train import train_step as TS
from repro_torch.train.loop import LoopConfig, run_loop
from repro_torch.util import resolve_device


def main(argv: list | None = None, *, log=print) -> dict:
    """Run the launcher; returns what it printed as numbers (the LM, recsys
    and GNN branches: ``losses``; graph500: ``harmonic_mean_teps`` and
    ``valid``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_arch_ids())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
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

    if spec.family == "lm":
        from repro_torch.models import transformer
        params = transformer.init_params(cfg, seed=0, device=device)
        sched = wsd(3e-4, 5, max(args.steps - 15, 5), 10) \
            if args.arch == "minicpm-2b" else cosine(3e-4, 5, args.steps)
        opt = AdamW(sched)
        step = TS.make_lm_train_step(cfg, opt)

        def batch_fn(i):
            return lm_batch(0, i, args.batch, args.seq, cfg.vocab, device=device)
    elif spec.family == "recsys":
        from repro_torch.models import recsys
        params = recsys.init_params(cfg, seed=0, device=device)
        opt = AdamW(cosine(1e-3, 5, args.steps))
        step = TS.make_xdeepfm_train_step(cfg, opt)

        def batch_fn(i):
            return recsys_batch(0, i, args.batch * 8, cfg.n_sparse,
                                cfg.rows_per_field, device=device)
    elif spec.family == "gnn":
        opt = AdamW(cosine(1e-3, 5, args.steps))
        params, step = _gnn_branch(args, cfg, opt, device)

        def batch_fn(i):
            return None
    else:
        raise ValueError(f"launch.train: {args.arch} has no branch for its "
                         f"family {spec.family!r}")

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


def _gnn_branch(args, cfg, opt, device):
    """The GNN archs' parameters and step (the step ignores its batch)."""
    from repro_torch.data.graphs import make_feature_graph, make_molecule_batch
    from repro_torch.models import gnn
    params = gnn.INITS[args.arch](cfg, seed=0, device=device)
    if args.arch in ("gat-cora", "graphsage-reddit"):
        g, labels = make_feature_graph(0, args.scale, d_feat=cfg.d_in,
                                       n_classes=cfg.n_classes, edge_factor=4,
                                       device=device)
        raw = TS.make_gnn_train_step("gat" if args.arch == "gat-cora" else "sage",
                                     cfg, opt)
        return params, lambda p, s, _b: raw(p, s, g, labels)
    g, species, tri = make_molecule_batch(0, 8, 8, 16, device=device)
    if args.arch == "dimenet":
        raw = TS.make_dimenet_train_step(cfg, opt, 8)
        tgt = torch.zeros((8,), device=device)
        return params, lambda p, s, _b: raw(p, s, g, species, tri, tgt)
    raw = TS.make_equiformer_train_step(cfg, opt)
    tgt = torch.zeros((g.n_nodes,), device=device)
    return params, lambda p, s, _b: raw(p, s, g, species, tgt)


if __name__ == "__main__":
    main()
