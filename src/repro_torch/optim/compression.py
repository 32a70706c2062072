"""Gradient compression for the expensive (inter-group) links: the port of
``repro.optim.compression``.

Two schemes for the inter-group leg of the gradient sync
(``comms.hierarchical.compressed_hierarchical_psum`` casts to its
``compress_dtype``, bf16 by default):

  * a bf16 cast (2x), lossless enough for gradients in practice;
  * simulated fp8-e4m3 block scaling (4x): a value-faithful emulation in
    fp32 (per-block amax scaling, the mantissa rounded at 2^-3 relative
    resolution, clipped to the e4m3 range), in the JAX package's order of
    operations so that payload and scales agree with it bit for bit.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def fp8_e4m3_sim(x: torch.Tensor, block: int = 128):
    """Returns (the e4m3-rounded values as a bf16 payload [n_blocks, block],
    the fp32 scales [n_blocks, 1]): scale = max(amax / 448, 1e-12) per
    block of ``block`` values (the tail zero-padded)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block).to(torch.float32)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / E4M3_MAX, min=1e-12)
    scaled = blocks / scale
    # e4m3 has 3 mantissa bits: round to nearest at 2^-3 relative resolution
    mag = scaled.abs()
    exp = torch.floor(torch.log2(torch.clamp(mag, min=1e-30)))
    step = torch.exp2(exp - 3)
    q = torch.round(mag / step) * step
    q = torch.where(mag == 0, torch.zeros_like(q),
                    torch.sign(scaled) * torch.clamp(q, 0, E4M3_MAX))
    return q.to(torch.bfloat16), scale.to(torch.float32)


def fp8_e4m3_restore(payload: torch.Tensor, scale: torch.Tensor, shape,
                     size: int) -> torch.Tensor:
    blocks = payload.to(torch.float32) * scale
    return blocks.reshape(-1)[:size].reshape(shape)


def compress_tree_bf16(grads: dict) -> dict:
    return {k: to_bf16(g) for k, g in grads.items()}


def decompress_tree(grads: dict, like: dict) -> dict:
    return {k: g.to(like[k].dtype) for k, g in grads.items()}
