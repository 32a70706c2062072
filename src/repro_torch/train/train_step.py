"""Step functions for the xDeepFM workload: the port of the serving steps of
``repro.train.train_step``.  The train step, its loss and the optimizer are
not ported yet (ROADMAP Queue 1, item 12)."""
from __future__ import annotations

import torch

from repro_torch.models import recsys


def make_xdeepfm_serve_step(cfg: recsys.XDeepFMConfig):
    """step(params, ids [B, F]) -> click probabilities [B]."""
    def step(params: recsys.XDeepFM, ids: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(recsys.forward(params, ids, cfg))
    return step


def make_retrieval_step(cfg: recsys.XDeepFMConfig):
    """step(params, query_ids [1, F], cand_emb [N, D]) -> scores [N]."""
    def step(params: recsys.XDeepFM, query_ids: torch.Tensor,
             cand_emb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return recsys.retrieval_scores(params, query_ids, cand_emb, cfg)
    return step
