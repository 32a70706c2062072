"""xdeepfm [arXiv:1803.05170; paper]: 39 sparse fields, CIN 200-200-200."""
from __future__ import annotations

from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.recsys import XDeepFMConfig


def xdeepfm_full() -> XDeepFMConfig:
    return XDeepFMConfig(
        n_sparse=39, embed_dim=10, cin_layers=(200, 200, 200),
        mlp_layers=(400, 400), rows_per_field=1 << 20)


def xdeepfm_smoke() -> XDeepFMConfig:
    return XDeepFMConfig(
        n_sparse=8, embed_dim=4, cin_layers=(16, 16), mlp_layers=(32,),
        rows_per_field=128)


register(ArchSpec(
    arch_id="xdeepfm", family="recsys",
    make_config=xdeepfm_full, make_smoke_config=xdeepfm_smoke,
    shapes=RECSYS_SHAPES, source="arXiv:1803.05170; paper",
    notes="fused table 39 x 2^20 rows; make_config() keeps the JAX default "
          "use_cin_kernel=False (CIN through the einsum path, which the JAX "
          "train step differentiates); serving on the card sets "
          "use_cin_kernel=True for the fused hand-written CUDA kernel, the "
          "only CIN path that fits serve_bulk"))
