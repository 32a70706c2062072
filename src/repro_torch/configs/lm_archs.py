"""The five LM architectures (exact public dims, [source; tier]): the port's
copy of ``repro.configs.lm_archs``.

One module (not five) because they share the LMConfig surface; the
registry still exposes them as individual ``--arch`` ids.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

# ---------------------------------------------------------------------------
# starcoder2-15b [arXiv:2402.19173; hf] - GQA kv=4, RoPE, GELU, layernorm
# ---------------------------------------------------------------------------

def starcoder2_15b() -> LMConfig:
    return LMConfig(
        name="starcoder2-15b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=4, d_ff=24576, vocab=49152, norm="layernorm", mlp="gelu",
        rope_theta=100000.0, tied_embeddings=False)


def starcoder2_15b_smoke() -> LMConfig:
    return LMConfig(
        name="starcoder2-15b-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=512, vocab=512, norm="layernorm", mlp="gelu",
        rope_theta=100000.0, tied_embeddings=False)


register(ArchSpec(
    arch_id="starcoder2-15b", family="lm",
    make_config=starcoder2_15b, make_smoke_config=starcoder2_15b_smoke,
    shapes=LM_SHAPES, source="arXiv:2402.19173; hf",
    notes="pure full attention -> long_500k official cell SKIP(full-attn)"))


# ---------------------------------------------------------------------------
# minicpm-2b [arXiv:2404.06395; hf] - llama-like, WSD schedule (see optim.wsd)
# ---------------------------------------------------------------------------

def minicpm_2b() -> LMConfig:
    return LMConfig(
        name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36,
        n_kv_heads=36, d_ff=5760, vocab=122753, norm="rmsnorm", mlp="swiglu",
        tied_embeddings=True)


def minicpm_2b_smoke() -> LMConfig:
    return LMConfig(
        name="minicpm-2b-smoke", n_layers=2, d_model=144, n_heads=6,
        n_kv_heads=6, d_ff=360, vocab=512, norm="rmsnorm", mlp="swiglu",
        tied_embeddings=True)


register(ArchSpec(
    arch_id="minicpm-2b", family="lm",
    make_config=minicpm_2b, make_smoke_config=minicpm_2b_smoke,
    shapes=LM_SHAPES, source="arXiv:2404.06395; hf",
    notes="vocab 122753 padded to 122768 (x16) for TP sharding; "
          "trains with the WSD schedule (optim.wsd)"))


# ---------------------------------------------------------------------------
# olmo-1b [arXiv:2402.00838; hf] - non-parametric LayerNorm
# ---------------------------------------------------------------------------

def olmo_1b() -> LMConfig:
    return LMConfig(
        name="olmo-1b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=8192, vocab=50304, norm="nonparametric_ln",
        mlp="swiglu", tied_embeddings=True)


def olmo_1b_smoke() -> LMConfig:
    return LMConfig(
        name="olmo-1b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=512, norm="nonparametric_ln",
        mlp="swiglu", tied_embeddings=True)


register(ArchSpec(
    arch_id="olmo-1b", family="lm",
    make_config=olmo_1b, make_smoke_config=olmo_1b_smoke,
    shapes=LM_SHAPES, source="arXiv:2402.00838; hf"))


# ---------------------------------------------------------------------------
# moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B] - MoE 64e top-6
# ---------------------------------------------------------------------------

def moonshot_v1_16b_a3b() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=163840, norm="rmsnorm", mlp="swiglu",
        tied_embeddings=True, n_experts=64, top_k=6)


def moonshot_smoke() -> LMConfig:
    return LMConfig(
        name="moonshot-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=512, norm="rmsnorm", mlp="swiglu",
        tied_embeddings=True, n_experts=8, top_k=2)


register(ArchSpec(
    arch_id="moonshot-v1-16b-a3b", family="lm",
    make_config=moonshot_v1_16b_a3b, make_smoke_config=moonshot_smoke,
    shapes=LM_SHAPES, source="hf:moonshotai/Moonlight-16B-A3B",
    notes="MoE dispatch = T3 hierarchical a2a in monitor mode (§Perf)"))


# ---------------------------------------------------------------------------
# granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base] - 32e top-8
# ---------------------------------------------------------------------------

def granite_moe_1b_a400m() -> LMConfig:
    return LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=512, vocab=49155, norm="rmsnorm", mlp="swiglu",
        tied_embeddings=True, n_experts=32, top_k=8)


def granite_smoke() -> LMConfig:
    return LMConfig(
        name="granite-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=512, norm="rmsnorm", mlp="swiglu",
        tied_embeddings=True, n_experts=8, top_k=4)


register(ArchSpec(
    arch_id="granite-moe-1b-a400m", family="lm",
    make_config=granite_moe_1b_a400m, make_smoke_config=granite_smoke,
    shapes=LM_SHAPES, source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="vocab 49155 padded to 49168 (x16) for TP sharding"))


def padded_vocab(cfg: LMConfig, multiple: int = 16) -> LMConfig:
    """Pad vocab up so the TP axis divides it (noted per-arch above)."""
    v = ((cfg.vocab + multiple - 1) // multiple) * multiple
    return dataclasses.replace(cfg, vocab=v)
