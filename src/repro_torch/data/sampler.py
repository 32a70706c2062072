"""GraphSAGE fanout neighbour sampler (host-side numpy): the port of
``repro.data.sampler``.

The sampling is the JAX package's numpy code, copied (``default_rng``, the
same draws in the same order), so a seed gives the same node ids and blocks
bit for bit; only the blocks' arrays become torch tensors, on the sampler's
device.  For seeds S and fanouts (f1, f2, ...), hop h samples up to f_h
neighbours per frontier node from the CSR; the blocks are static-shape and
consumable by ``models.gnn.sage_forward_blocks``.

Block layout (outer -> inner):
  layer 0 rows: the full sampled node set (seeds + all hop frontiers)
  block[h]: edges from layer-h rows into the first ``n_dst`` rows
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.util import resolve_device


@dataclasses.dataclass
class SampledBatch:
    node_ids: np.ndarray      # [N_total] global ids, seeds first
    feats_idx: np.ndarray     # alias of node_ids (feature gather index)
    blocks: list[dict]        # outer-first consumable blocks
    seeds: np.ndarray


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class NeighborSampler:
    """Sampler over a CSR (``row_offsets`` [V+1], ``col_indices``, numpy or
    tensors, read on the host); ``sample`` puts the blocks on ``device``."""

    def __init__(self, row_offsets, col_indices, fanouts: tuple[int, ...],
                 seed: int = 0, device=None):
        self.ro = _host(row_offsets)
        self.ci = _host(col_indices)
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        self.n = len(self.ro) - 1
        self.device = resolve_device(device)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        """Uniform without-replacement-ish sampling, padded to fanout."""
        src = np.empty((len(nodes), fanout), np.int64)
        valid = np.zeros((len(nodes), fanout), bool)
        for i, v in enumerate(nodes):
            lo, hi = self.ro[v], self.ro[v + 1]
            deg = hi - lo
            if deg <= 0:
                continue
            take = min(fanout, deg)
            if deg <= fanout:
                picks = np.arange(lo, hi)
            else:
                picks = lo + self.rng.choice(deg, size=take, replace=False)
            neigh = self.ci[picks]
            neigh = neigh[neigh < self.n]          # drop padding sentinels
            src[i, :len(neigh)] = neigh
            valid[i, :len(neigh)] = True
        return src, valid

    def sample(self, seeds) -> SampledBatch:
        """Multi-hop expansion. Returns outer-first blocks for the model."""
        seeds_arr = np.asarray(seeds, np.int64)
        # node_ids is built ring by ring so that every layer's node set is a
        # PREFIX of node_ids — blocks can then address dst rows [0, n_dst).
        node_ids = np.array(seeds_arr)
        layer_sizes = [len(node_ids)]
        lut = {int(v): i for i, v in enumerate(node_ids)}
        layers = [seeds_arr]
        edges = []
        for fanout in self.fanouts:
            frontier = layers[-1]
            neigh, valid = self._sample_neighbors(frontier, fanout)
            edges.append((neigh, valid))
            ring = np.unique(neigh[valid])
            new = np.array([v for v in ring if int(v) not in lut], np.int64)
            for v in new:
                lut[int(v)] = len(lut)
            node_ids = np.concatenate([node_ids, new])
            layers.append(node_ids[: len(node_ids)])
            layer_sizes.append(len(node_ids))

        blocks = []
        # hop h: edges target layer-h frontier (rows [0, n_dst))
        for h, fanout in enumerate(self.fanouts):
            neigh, valid = edges[h]
            n_dst = layer_sizes[h]
            src = np.array([[lut.get(int(v), 0) for v in row] for row in neigh],
                           np.int32)
            dst = np.repeat(np.arange(n_dst, dtype=np.int32)[:, None],
                            fanout, axis=1)
            blocks.append({
                "src": torch.from_numpy(src.reshape(-1)).to(self.device),
                "dst": torch.from_numpy(dst.reshape(-1)).to(self.device),
                "valid": torch.from_numpy(valid.reshape(-1)).to(self.device),
                "n_dst": n_dst,
            })
        # the model consumes the outer hop first (features of the full node set)
        return SampledBatch(node_ids=node_ids, feats_idx=node_ids,
                            blocks=blocks[::-1], seeds=seeds_arr)


def static_block_specs(batch_seeds: int, fanouts: tuple[int, ...]):
    """Worst-case static shapes (the JAX package's dry-run input specs).

    Prefix semantics (see ``sample``): hop h's frontier is the full prefix
    s_h, with s_0 = batch and s_{h+1} = s_h * (1 + fanout_h) worst case;
    the hop-h block has s_h * fanout_h edges. Returned outer-first."""
    specs = []
    s = batch_seeds
    for fanout in fanouts:
        specs.append({"n_dst": s, "n_edges": s * fanout})
        s = s * (1 + fanout)
    return specs[::-1], s
