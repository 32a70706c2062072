"""Deterministic synthetic LM and recsys batches (seeded; no I/O).

The port's counterparts of ``repro.data.synthetic.lm_batch`` and
``recsys_batch``: the same power laws and label rate, drawn from a
``torch.Generator``, so the streams differ from JAX's (as the Kronecker
generator's does).  A batch is a pure function of (seed, step, device).
"""
from __future__ import annotations

import torch

from repro_torch.util import resolve_device


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device=None) -> dict:
    """Zipf-ish token stream: realistic id skew for the embedding and vocab
    paths.

    ids = clip(int(u^(-1/1.1) - 1), 0, vocab - 1) with u uniform on [1e-6,
    1) (the inverse CDF of a truncated Zipf(1.1)), int32 [batch, seq + 1];
    ``tokens`` are its first ``seq`` columns and ``labels`` its last ``seq``.
    """
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    u = torch.rand((batch, seq + 1), generator=gen, device=device)
    u = u * (1.0 - 1e-6) + 1e-6
    ids = (u ** (-1 / 1.1) - 1.0).to(torch.int32).clamp_(0, vocab - 1)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def recsys_batch(seed: int, step: int, batch: int, n_fields: int,
                 rows_per_field: int, device=None,
                 generator: torch.Generator | None = None) -> dict:
    """Power-law categorical ids per field + Bernoulli(0.25) labels.

    ids int32 [batch, n_fields] = clip(int(u^-1.2 - 1), 0, rows - 1) with u
    uniform on [1e-6, 1): low ids are hot.  labels float32 [batch].
    ``generator`` (on ``device``) replaces the one seeded from (seed, step).
    """
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(
            (seed + 7) * 1_000_003 + step)
    u = torch.rand((batch, n_fields), generator=gen, device=device)
    u = u * (1.0 - 1e-6) + 1e-6
    ids = (u ** -1.2 - 1.0).to(torch.int32).clamp_(0, rows_per_field - 1)
    labels = (torch.rand((batch,), generator=gen, device=device) < 0.25) \
        .to(torch.float32)
    return {"ids": ids, "labels": labels}
