"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any mismatch raises, so the exit code is
non-zero and no result line is printed:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every hand-written kernel from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card: bit for bit
     for the integer kernels, within rtol = atol = 2e-4 for ``cin_layer``
     (3xTF32 against the fp32 plain version, TF32 off) at the full-width
     xDeepFM layer shapes, ragged and split grids included, and two calls
     on the split grid bit-identical; ``frontier_update`` also back to back
     without synchronising (its ticket resets), in the ``out=`` form, and
     refusing aliased outputs; ``spmv_mxu`` at K = 128 to 4,224 (one tile,
     a ragged row tile, two frontier tiles, tiles split by stream-K) in 0/1,
     full-range and all -128 int8, and two split calls bit-identical;
  4. the main path at scale 16: levels equal to the numpy queue BFS;
  5. the main path, ``Graph500Config.ladder("pre-g500", scale=20,
     n_roots=16)``: all roots valid with zero failing checks, both kernels
     launched, and the ``pre-g500-batch`` rung's parents equal to the
     per-root parents;
  6. each kernel at its main-path shape: time (CUDA events), its plain
     version's time and the bound (bytes over the card's memory rate);
     ``frontier_update`` in the engine's ``out=`` form, with the device time
     per launch and the device operations per call (one) from torch.profiler;
  7. a torch.profiler trace of one scale-20 traversal: the device's busy
     and idle share, the device time by kernel, one ``frontier_update``
     launch a level and no memset beside one;
  8. xDeepFM serving at full width (``xdeepfm_full``, fused CIN kernel):
     ``serve_p99`` (B = 512) against the einsum path (probabilities, and
     the pooled CIN features with a tolerance scaled to their size),
     ``serve_bulk`` (B = 262,144, which only the fused kernel fits) with
     each CIN layer held against the plain version on 4,096 rows spread
     over the batch, the last 512 included, likewise scaled, and
     ``retrieval_cand`` (1 query, 1,000,000 candidates); three ``cin_layer``
     launches per forward; ms per step and rows/s; a torch.profiler
     breakdown of one ``serve_p99`` step;
  9. ``multi_source_spmv`` on phase 5's heavy core (K = 61,440) with 128
     frontiers (16 roots x levels 0-7): bit-exact against the plain
     version and ``torch._int_mm``, and ``counts > 0`` equal to the core
     neighbourhoods read from the packed bitmap;
 10. ``cin_layer`` and ``spmv_mxu`` at their path's shapes: time, plain
     time, the library call's time and the bound (``cin_layer``: the
     3xTF32 tensor-core bound it is held to and the fp32 bound); ``cin_layer`` at
     B = 262,144 on N(0, 1) operands also held against the plain version
     on 4,096 rows spread over the batch (rtol = atol = 2e-4); ``spmv_mxu``
     with its share of the byte bound, its stream-K plan and a profile of
     its two launches (F's transpose, the product);
 11. the Fig. 18 ladder at scale 20: ``reference-3.0.0``, ``th2``, ``k`` and
     ``pre-g500-legacy`` through ``pipeline.run`` with the spec checks, all
     roots valid; the parents of ``th2``, ``k`` and ``pre-g500-legacy``
     equal to phase 5's ``pre-g500`` parents; ``core_spmv`` launched once a
     bottom-up level of ``pre-g500-legacy`` (timed and warm-up traversals)
     and no kernel by the reference rungs; per rung hmean TEPS, ms per
     root, levels and the idle share of one traversal;
 12. Graph500 SSSP (δ-stepping) at scale 20, per root and batched: every
     root passes the five SSSP checks, the batch's rows (parents,
     distances, every stats trace) equal the per-root rows; hmean TEPS,
     rounds per root, δ, and a profile of one root; parents and distances
     equal to ``sssp_oracle`` on ``grid_graph(256)`` and on a scale-14
     Kronecker graph built on the card, 2 roots each;
 13. checked execution on phase 5's graph and keys: a persistent parent
     fault on one root through ``pre-g500-batch`` (``check="full"``,
     ``retries=1``, ``fallback=True``): only that root detected, one
     retry, no fallback (the plan is the degraded shape), that root
     quarantined, the other 15 rows equal to phase 5's parents and the
     hmean over them; through the per-root plan one fallback; a clean run
     with recovery armed (no retry, no fallback, all valid); SSSP with a
     parent-offset fault on 4 roots: all quarantined, ``tree_dist``
     counted;
 14. BFS serving through ``pipeline.serve`` on phase 5's graph
     (``ServeConfig(batch_size=8, max_wait_s=0.05, cache_capacity=128,
     check="post", max_requeues=2)``), traces ``serve_steady`` (2 qps,
     Zipf 1.4) and ``serve_burst`` (2,000 qps, Zipf 1.1), 64 queries
     each, the cache reset between them: every answer equal to the
     offline run bit for bit, none failed, both kernels launched while
     serving; latency p50/p99/p99.9, qps, hit rate, occupancy and service
     ms per batch; a faulted engine (a persistent parent fault on the
     burst trace's hottest root): every query for it failed after the
     requeues, every other answer equal to the clean run; an SSSP engine
     on 16 queries equal to the offline SSSP run;
 15. the plan auto-tuner: ``tune.sweep`` at scale 20 under the ``full``
     budget (12 candidates on one card: α/β x ``n_chunks``), 16 roots, 3
     reps, on the card: its ranked table, every candidate accepted and
     bitwise identical to the oracle, both kernels launched during the
     sweep, the winner against the default plan (α 14, β 24, 64 chunks);
     the sweep's table saved to a temporary file (never into the
     repository) and read through ``REPRO_TORCH_TUNED_PLANS``: the
     ``pre-g500-tuned`` rung on phase 5's graph runs the winner, valid;
     ``resolve_serve_plan(scale=20)`` returns the winner, batched; with
     the table missing both fall back to the untuned plan;
 16. the mesh layouts at scale 20 on phase 5's graph and keys, every mesh
     virtual (all its shards on the one card, run in lockstep):
     ``pre-g500-mesh`` through ``pipeline`` on the 1-card mesh, ``("root",)``
     on (4,), ``("group", "member")`` on (2, 2) for both partitions and the
     five exchanges (16 keys for ``hier_or``, 4 for the others) and the
     composed (2, 2, 2): every run valid, its parents sha-equal to phase 5's
     ``pre-g500`` rows, both kernels launched on every vertex-sharded run;
     hmean TEPS, ms per traversal, ``shard_edge_skew`` and the launches of
     each; ``frontier_update`` at the owned-word shape (W_loc = 8,192)
     against its plain version; a profile of one (2, 2) traversal;
 17. sharded SSSP (``hier_min``, ``flat``) on (2, 2), 4 roots, equal to
     phase 12's rows; on (2, 2), a persistent ``exchange``/``zero`` fault
     detected, retried and answered by the single-device fallback (rows
     equal to phase 5's), a ``codec`` and an ``inter_group`` fault detected;
 18. the multi-process launcher on the card: 2 gloo processes x 2 shards at
     scale 18 (W_loc = 2,048), staged through the host; parent digests
     equal to the oracle and an in-process virtual (2, 2) run; the measured
     exchange per level beside ``modeled_wire_bytes``;
 19. the tuner over a virtual mesh of 4 shards of the card:
     ``tune.sweep(20, budget="small", devices=4, n_roots=4, reps=2)``, 15
     candidates, every one accepted bitwise, both kernels launched by the
     timed runs of every vertex-sharded candidate; the ranked table, and
     its entry (``scale20/dev4/cuda``, ``"virtual": true``) written to a
     temporary file through ``REPRO_TORCH_TUNED_PLANS`` and read back;
 20. mesh serving: ``Engine(built, plan=BFSPlan(layout=("group",
     "member"), mesh_shape=(2, 2), partition=p), mesh=<virtual (2, 2)>)``
     for both partitions on 16 queries of phase 14's ``serve_burst``
     trace: every answer equal to the offline run of the same compiled
     plan, every batch launching both kernels, ms a batch; a persistent
     ``exchange``/``zero`` fault re-queued, answered by the single-device
     fallback, equal to the clean batched plan's rows;
 21. the T3 collectives on a virtual (2, 4) mesh: ``psum_spmd``
     hierarchical equal to flat bit for bit on integer-valued fp32, the
     compressed psum within rtol 1e-2, ``all_to_all_spmd`` equal to the
     flat one and an involution, and a data-parallel xDeepFM step (smoke
     config, 8 shards, gradients summed by ``hierarchical_psum``) within
     rtol 1e-5 of the single-shard step;
 22. xDeepFM training at full width (``xdeepfm_full``, TF32 off): one AdamW
     step at B = 512 on the card and on the CPU from the same parameters
     and batch (loss within rtol 1e-5, parameters within atol 1e-6);
     ``launch.train --arch xdeepfm --full --steps 20 --batch 1024`` (B =
     8,192), its loss falling from ~0.69, ``max_memory_allocated``; the
     step at B = 8,192 split into forward+backward and the AdamW update
     (CUDA events), samples/s and a profile of one step; the resume at the
     smoke config (6 steps against 3, a checkpoint and 3 more, bit for
     bit); ``launch.train --arch graph500 --scale 16``, valid;
 23. LM serving at full width, olmo-1b (dense, MHA 16, SwiGLU,
     non-parametric LN; 1.18e9 parameters) and granite-moe-1b-a400m (GQA
     16/8, 32 experts top-8), random weights from ``init_params`` on the
     card: ``make_lm_prefill`` at B = 4, S = 2,048 with ``q_chunk`` 512 (ms,
     tokens/s); greedy ``make_lm_serve_step`` at B = 8 over a 2,048-row
     cache, 8 teacher-forced prompt tokens then 64 generated (ms a token
     against the weight-read bound, and with the KV cache), a profile of one
     decode step (idle share), ``max_memory_allocated``; teacher-forced
     decode against the forward over the first 16 positions within 3e-2 x
     max |logit| (granite at capacity factor 16, so neither form drops);
     each smoke arch's forward on the card against the CPU's, and olmo-1b
     at full width (forward and decode, B = 2, S = 8) against the CPU's,
     each with cuBLAS's reduced-precision bf16 reduction on and off.  These
     cut ``prefill_32k`` (32 x 32,768) and ``decode_32k`` (128 x 32,768),
     whose KV cache alone would take ~550 GB; the widths are not cut;
 24. LM training at full width: olmo-1b at B = 8, S = 1,024 (cut from
     ``train_4k``'s 256 x 4,096) with ``remat=True`` and
     ``AdamW(cosine(3e-4, 5, 20))`` for 20 steps: forward+backward and AdamW
     ms (CUDA events), tokens/s, peak memory, the loss falling from ~ln
     50,304, a profile of one step; ``moe_ffn_monitor`` on a virtual (2, 2)
     ``("group", "member")`` mesh and ``moe_ffn_local_tp`` over 2 x 2 shards
     at granite's layer widths against the dense ``moe_ffn`` (within 5e-2 +
     5e-2 x |dense|), two monitor calls equal bit for bit;
     ``launch.train --arch olmo-1b`` at the smoke config.  The LM path
     launches none of the four kernels (its products are torch matmuls and
     einsums, as the JAX package's are plain ``jnp``); both phases print the
     kernels' launch counts over a step.
 25. GNN training at full width: each arch's smoke forward and one train
     step's loss and gradients on the card against the CPU (within 1e-5 x
     max |out| and of each leaf's largest |gradient|, the loss within 1e-4),
     SAGE on sampled blocks too; then the registered full configs with the
     shape cells' feature dims (``arch_with_dims``), on graphs made on the
     card by the port's generators: ``gat-cora`` on a scale-12 feature graph
     (d_in 1,433, 7 classes), ``graphsage-reddit`` on ``NeighborSampler``
     blocks of 1,024 seeds, fanout (15, 10), from a scale-18 graph (d_in 602,
     41 classes; the sampler's host ms a batch apart), SAGE full-graph at
     ``ogb_products``' widths on a scale-20 graph (d_in 100, 47 classes),
     ``dimenet`` and ``equiformer-v2`` on ``make_molecule_batch(0, 128, 30,
     64)``; the full-width forwards against the CPU where the CPU is quick
     (Equiformer with 2 layers); per path forward+backward and AdamW ms,
     nodes/edges/seeds/graphs per second, peak memory, the loss falling over
     10-20 AdamW steps, whether two steps from one state are equal bit for
     bit, the kernels' launches (none) and a profile of one step; the
     launcher's GNN branch at the smoke configs;
 26. the owner-partitioned SAGE step (``models.gnn_dist``) on a virtual
     (2, 2) mesh of the card on phase 25's scale-20 graph from its initial
     parameters: hierarchical and flat in float32 against the single-device
     step (loss within 1e-4, every parameter within 1e-5 after one AdamW
     step), the bf16 gather (its loss within 5e-2 of the float32 loss,
     relative), ms a step beside the single-device step's and the idle share
     of one hierarchical step.

The kernel JSON's ``launches`` sum the counts of every path that drives a
kernel (phase 5's ``pre-g500`` run, the legacy rung of phase 11, the BFS runs
of phase 13, the serving of phase 14, the sweep and the tuned rung of
phase 15, the mesh runs of phases 16–17, rank 0 of phase 18, the virtual
sweep of phase 19 and the mesh serving of phase 20), each
counted from 0 just before its run and read just after;
``launches_by_path`` lists them.  The last
two lines are the kernel JSON and the result JSON.  Without a
CUDA device, or without the rest of the repository beside it, the script
exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
# No integer rate is published; the 67 TFLOP/s fp32 rate outside the tensor
# cores stands in for the scalar ALUs.
SCALAR_OPS_PER_S = 67e12
FP32_FLOPS_PER_S = 67e12
TF32_TENSOR_FLOPS_PER_S = 495e12
INT8_TENSOR_OPS_PER_S = 1979e12

# cin_layer (3xTF32 on the tensor cores, fp32-level error) against its plain
# version: the tolerance of the JAX package's kernel test (tests/test_kernels.py).
CIN_TOL = 2e-4
CIN_CHECK_ROWS = 4096

SCALE_CHECK = 16
SCALE_MAIN = 20
N_ROOTS = 16
# the roots of phases 11 and 12 (cut these, never N_ROOTS, to save time)
LADDER_ROOTS = 16
SSSP_ROOTS = 16
SSSP_MAX_WEIGHT = 255
SSSP_SEED = 42
# grid_graph(256) takes ~820 δ-stepping rounds: above the default bound of
# 512 (which would cut the traversal short), so its plan raises the bound
GRID_SIDE = 256
GRID_MAX_LEVELS = 2048
SCALE_ORACLE = 14
# phase 13: the root its faults target (an index into phase 5's keys) and
# the SSSP roots of its quarantine leg
FAULT_ROOT_INDEX = 3
FAULT_SSSP_ROOTS = 4
# phase 14: the serving configuration of benchmarks/bfs_serve.py and its two
# traces; cut the query counts, never the graph, to save time
SERVE_CFG = dict(batch_size=8, max_wait_s=0.05, cache_capacity=128, check="post",
                 max_requeues=2)
SERVE_TRACES = (("serve_steady", 2.0, 1.4), ("serve_burst", 2000.0, 1.1))
SERVE_QUERIES = 64
SERVE_SSSP_QUERIES = 16
# phase 15: the sweep the plan auto-tuner runs for a scale-20 table
TUNE_BUDGET = "full"
TUNE_REPS = 3
TUNE_DEFAULT = dict(alpha=14.0, beta=24.0, n_chunks=64)
# phases 16-17: the keys of every (2, 2) exchange but hier_or (which runs all
# N_ROOTS) and of the fault runs, and the SSSP roots held against phase 12
MESH_KEYS = 4
MESH_SSSP_ROOTS = 4
# phase 18: the launcher's graph (W_loc = 2048 over 4 shards) and roots
MP_SCALE = 18
MP_ROOTS = 4
# phase 19: the sweep over a virtual mesh of 4 shards of the card
VSWEEP_DEVICES = 4
VSWEEP_ROOTS = 4
VSWEEP_REPS = 2
# phase 20: the queries of phase 14's serve_burst trace served on (2, 2)
MESH_SERVE_QUERIES = 16
# phase 22: xDeepFM training (launch.train's schedule and batches of 8 x
# TRAIN_BATCH rows), the card-vs-CPU step's batch and the timed steps
TRAIN_STEPS = 20
TRAIN_BATCH = 1024
TRAIN_CHECK_ROWS = 512
TRAIN_TIMED_STEPS = 5
# the card's gradients against the CPU's: float32 sums in another order, so
# each element within GRAD_RTOL of its CPU value plus GRAD_RTOL of its leaf's
# largest |gradient| (an element that cancels has no scale of its own); a
# TF32 product or a wrong backward is off by 1e-3 or more
GRAD_RTOL = 1e-5
TRAIN_GRAPH500_SCALE = 16
# phase 23: LM serving at full width, cut from prefill_32k (32 x 32,768) and
# decode_32k (128 x 32,768): decode_32k's KV cache alone would take ~550 GB
LM_SERVE_ARCHS = ("olmo-1b", "granite-moe-1b-a400m")
PREFILL_BATCH, PREFILL_SEQ, PREFILL_Q_CHUNK, PREFILL_REPS = 4, 2048, 512, 3
DECODE_BATCH, DECODE_S_MAX, DECODE_PROMPT, DECODE_NEW = 8, 2048, 8, 64
# decode against prefill: the first positions, with MoE capacity high enough
# that neither form drops a token (capacity depends on the batch)
DECODE_CHECK_POS = 16
DECODE_CHECK_CAPACITY = 16.0
# the LM tolerances of the JAX package's tests, scaled by max |logit|
# (random-init activations make an absolute tolerance vacuous)
LM_TOL = 3e-2
LM_MOE_TOL = 5e-2
# olmo-1b at full width on the card against the CPU: B x S tokens
FULL_CHECK_SHAPE = (2, 8)
# phase 24: olmo-1b training, cut from train_4k (256 x 4,096)
LM_TRAIN_ARCH = "olmo-1b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 1024, 20
# the sharded MoE dispatch on the card: granite-moe-1b-a400m's layer widths
MOE_CHECK_TOKENS = (8, 64)
MOE_CHECK_CAPACITY = 8.0
# phase 25: the GNN archs' full configs with the shape cells' feature dims
# (arch_with_dims), on graphs made on the card by the port's generators in
# place of the datasets (none is in the repository): Cora's 2,708 nodes by
# 4,096 (scale 12), Reddit's 232,965 by 262,144 (scale 18), ogb-products'
# 2,449,029 nodes and 61,859,140 edges by 1,048,576 and ~31.4M (scale 20:
# one [E, 128] float32 gather takes ~16 GB; scale 21 would take ~32 GB).
# The class counts are Cora's, Reddit's and ogb-products'.
GNN_ARCHS = ("gat-cora", "graphsage-reddit", "dimenet", "equiformer-v2")
GNN_STEPS = 20
# AdamW(cosine(lr, 2, steps)): 3e-3, and 1e-3 for equiformer-v2 (whose loss
# jumped from 1.03 to 7.5 in the first steps at 3e-3 on the card)
GNN_LR = {"equiformer-v2": 1e-3}
GNN_GAT = dict(scale=12, edge_factor=4, n_classes=7)
GNN_SAGE_BLOCKS = dict(scale=18, edge_factor=16, n_classes=41, steps=10)
GNN_SAGE_FULL = dict(scale=20, edge_factor=16, n_classes=47, steps=10)
# Equiformer's full-width forward against the CPU with its layers cut to 2
GNN_CHECK_LAYERS = 2
# card vs CPU: float32 throughout (TF32 off), the segment sums atomic on the
# card, so sums in another order: the tests' forward tolerance vs JAX
GNN_TOL = 1e-5
# phase 26: the virtual mesh, and the bf16 gather's loss against the float32
# loss (tests/test_torch_gnn_dist.py's BF16_VS_F32_REL)
GNN_MESH = (2, 2)
GNN_BF16_VS_F32_REL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rand_words(gen: torch.Generator, shape, density: float, device) -> torch.Tensor:
    """int32 bit-view words whose bits are set with probability ``density``."""
    from repro_torch.kernels.ref import wrap_i32
    bits = torch.rand(*shape, 32, generator=gen, device=device) < density
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    return wrap_i32((bits.to(torch.int64) << shifts).sum(-1))


def assert_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Max |kernel - plain| over the outputs; the tolerance is 0 (bit-exact
    integers), anything else raises."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs diff {err}, tolerance 0)")
    return err


def check_frontier_update(device) -> None:
    from repro_torch.kernels import bitmap_ops, ref
    gen = torch.Generator(device=device).manual_seed(1)
    cases = []
    for w in (1024, 32768):
        for density in (0.01, 0.5):
            cases.append((f"W={w} d={density}", rand_words(gen, (w,), density, device),
                          rand_words(gen, (w,), density, device)))
    ones = torch.full((1024,), -1, dtype=torch.int32, device=device)
    zeros = torch.zeros(1024, dtype=torch.int32, device=device)
    bit31 = torch.full((1024,), -2**31, dtype=torch.int32, device=device)
    cases += [("ones/zeros", ones, zeros), ("ones/ones", ones, ones),
              ("zeros/ones", zeros, ones), ("bit31/zeros", bit31, zeros),
              ("ones/bit31", ones, bit31)]
    for name, nxt, vis in cases:
        got = bitmap_ops.frontier_update(nxt, vis)
        want = ref.frontier_update_ref(nxt, vis)
        torch.cuda.synchronize()
        for g, w_, part in zip(got, want, ("next", "visited", "count")):
            assert_equal(f"frontier_update {name} {part}", g, w_)
    if int(bitmap_ops.frontier_update(ones, zeros)[2]) != 1024 * 32:
        raise AssertionError("frontier_update: all-ones count is not 32768")
    # back to back on one stream, no synchronisation between the launches:
    # each finds the ticket the one before reset.  2^21 words run the
    # grid-stride loop (more than 528 blocks x 256 threads x 4 words).
    n_b2b = 0
    for w in (1024, 2**21):
        ins = [(rand_words(gen, (w,), d, device), rand_words(gen, (w,), 0.1, device))
               for d in (0.3, 0.02, 0.0, 0.6)]
        got = [bitmap_ops.frontier_update(nxt, vis) for nxt, vis in ins]
        torch.cuda.synchronize()
        for (nxt, vis), g in zip(ins, got):
            for g_, w_, part in zip(g, ref.frontier_update_ref(nxt, vis),
                                    ("next", "visited", "count")):
                assert_equal(f"frontier_update back-to-back W={w} {part}", g_, w_)
            n_b2b += 1
    # the engine's form: caller buffers, reused; aliased outputs refused
    w = 32768
    out = (torch.empty(w, dtype=torch.int32, device=device),
           torch.empty(w, dtype=torch.int32, device=device),
           torch.empty((), dtype=torch.int32, device=device))
    for d in (0.5, 0.01):
        nxt, vis = rand_words(gen, (w,), d, device), rand_words(gen, (w,), d, device)
        got = bitmap_ops.frontier_update(nxt, vis, out=out)
        if any(g is not o for g, o in zip(got, out)):
            raise AssertionError("frontier_update(out=) did not return its buffers")
        for g, w_, part in zip(got, ref.frontier_update_ref(nxt, vis),
                               ("next", "visited", "count")):
            assert_equal(f"frontier_update out= d={d} {part}", g, w_)
    refused = 0
    for bad in ((nxt, out[1], out[2]), (out[0], vis, out[2]), (out[0], out[0], out[2])):
        try:
            bitmap_ops.frontier_update(nxt, vis, out=bad)
        except ValueError:
            refused += 1
    if refused != 3:
        raise AssertionError("frontier_update accepted an output aliasing an input")
    log(f"frontier_update: {len(cases)} cases, {n_b2b} back-to-back launches "
        f"(W = 1024, 2^21) and the out= form bit-identical to frontier_update_ref; "
        f"3 aliased outputs refused")


def check_core_spmv(device) -> None:
    from repro_torch.kernels import frontier_spmv, ref
    gen = torch.Generator(device=device).manual_seed(2)
    k = 4096
    n = 0
    for density in (0.001, 0.05):
        a = rand_words(gen, (k, k // 32), density, device)
        f = rand_words(gen, (k // 32,), 0.1, device)
        want = ref.core_spmv_ref(a, f)
        for rpt in (8, 16):
            assert_equal(f"core_spmv K={k} d={density} rows_per_tile={rpt}",
                         frontier_spmv.core_spmv(a, f, rows_per_tile=rpt), want)
            n += 1
    # hand-built: row 0 connects to {5, 70, 4000}, frontier = {70, 4000}
    a = np.zeros((k, k // 32), np.uint32)
    for j in (5, 70, 4000):
        a[0, j // 32] |= np.uint32(1) << np.uint32(j % 32)
    f = np.zeros((k // 32,), np.uint32)
    for j in (70, 4000):
        f[j // 32] |= np.uint32(1) << np.uint32(j % 32)
    from repro_torch.convert import words_to_torch
    out = frontier_spmv.core_spmv(words_to_torch(a, device), words_to_torch(f, device))
    if int(out[0]) != 70 or int(out[1]) != ref.BIG:
        raise AssertionError(f"core_spmv min-neighbour case: got {out[:2].tolist()}")
    log(f"core_spmv: {n + 1} cases at K={k} bit-identical to core_spmv_ref "
        f"(incl. the min-neighbour case)")


def assert_close(name: str, got: torch.Tensor, want: torch.Tensor,
                 scaled: bool = False) -> float:
    """Max |kernel - plain|; raises unless finite and within rtol = CIN_TOL
    and atol = CIN_TOL elementwise.  With ``scaled`` the atol is CIN_TOL *
    max |plain| instead, for outputs far below 1 (the model's own CIN
    activations are ~1e-4 to 1e-8, where an absolute 2e-4 would pass a
    kernel that wrote zeros); an all-zero plain output then raises."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    atol = CIN_TOL
    if scaled:
        atol = CIN_TOL * float(want.abs().max())
        if atol == 0.0:
            raise AssertionError(f"{name}: the plain version is all zero")
    if not torch.allclose(got, want, rtol=CIN_TOL, atol=atol):
        raise AssertionError(f"{name}: differs from its plain version (max abs "
                             f"diff {err}, rtol = {CIN_TOL}, atol = {atol})")
    return err


def spread_rows(b: int, n: int, device, tail: int = 512) -> torch.Tensor:
    """``n`` sorted row indices of a batch of ``b``: ``n - tail`` drawn
    across the batch from a seeded generator, and the last ``tail`` rows
    (the kernel's last blocks)."""
    gen = torch.Generator(device=device).manual_seed(7)
    head = torch.randperm(b - tail, generator=gen, device=device)[: n - tail]
    return torch.cat([head.sort().values, torch.arange(b - tail, b, device=device)])


def cin_operands(gen: torch.Generator, b: int, f0: int, fl: int, h: int, d: int,
                 device):
    """x0, xl ~ N(0, 1); w at the model's init scale sqrt(1 / (F0 Fl))."""
    x0 = torch.randn(b, f0, d, generator=gen, device=device)
    xl = torch.randn(b, fl, d, generator=gen, device=device)
    w = torch.randn(h, f0, fl, generator=gen, device=device).mul_((f0 * fl) ** -0.5)
    return x0, xl, w


def check_cin_layer(device) -> float:
    from repro_torch.kernels import cin, ref
    gen = torch.Generator(device=device).manual_seed(3)
    # the full-width layer shapes (F0 = 39, D = 10, H = 200; Fl = 39 for
    # layer 1 and 200 for layers 2-3) at B = 512 (F0 split over blocks), a
    # ragged B, a ragged last slab (513), B = 7 and 1 (filters split too),
    # the smoke config's shape and H = 70 at D = 3
    cases = [(512, 39, 39, 200, 10), (512, 39, 200, 200, 10),
             (300, 39, 39, 200, 10), (300, 39, 200, 200, 10),
             (513, 39, 200, 200, 10), (7, 39, 39, 200, 10),
             (1, 39, 200, 200, 10), (128, 8, 16, 16, 4), (96, 12, 20, 70, 3)]
    err = 0.0
    for b, f0, fl, h, d in cases:
        x0, xl, w = cin_operands(gen, b, f0, fl, h, d, device)
        plan = cin.cin_plan(b, f0, fl, h, d, sms=cin.sm_count(device))
        err = max(err, assert_close(f"cin_layer B={b} F0={f0} Fl={fl} H={h} D={d} "
                                    f"grid={plan.grid}", cin.cin_layer(x0, xl, w),
                                    ref.cin_layer_ref(x0, xl, w)))
    x0, xl, w = cin_operands(gen, 512, 39, 200, 200, 10, device)
    if not torch.equal(cin.cin_layer(x0, xl, w), cin.cin_layer(x0, xl, w)):
        raise AssertionError("cin_layer: two calls on the split grid differ")
    log(f"cin_layer: {len(cases)} shapes within rtol = atol = {CIN_TOL} of "
        f"cin_layer_ref (max abs err {err}); two calls at B=512 (grid "
        f"{cin.cin_plan(512, 39, 200, 200, 10, sms=cin.sm_count(device)).grid}) "
        f"bit-identical")
    return err


def rand_int8(gen: torch.Generator, shape, full_range: bool, device) -> torch.Tensor:
    lo, hi = (-128, 128) if full_range else (0, 2)
    return torch.randint(lo, hi, shape, generator=gen, device=device,
                         dtype=torch.int16).to(torch.int8)


def check_spmv_mxu(device) -> None:
    from repro_torch.kernels import ref, spmv_mxu
    gen = torch.Generator(device=device).manual_seed(4)
    n = 0
    # (128, 128): one tile, fewer than the SMs; (384, 128): a ragged row
    # tile; (512, 256) and (1024, 256): two frontier tiles; (4224, 128):
    # tiles split over blocks
    for k, r in ((128, 128), (384, 128), (512, 256), (1024, 256), (4224, 128)):
        for values in ("0/1", "full", "all -128"):
            if values == "all -128":
                a = torch.full((k, k), -128, dtype=torch.int8, device=device)
                f = torch.full((k, r), -128, dtype=torch.int8, device=device)
            else:
                a = rand_int8(gen, (k, k), values == "full", device)
                f = rand_int8(gen, (k, r), values == "full", device)
            got = spmv_mxu.spmv_mxu(a, f)
            assert_equal(f"spmv_mxu K={k} R={r} {values}", got, ref.spmv_mxu_ref(a, f))
            if values == "all -128" and not (int(got.min()) == int(got.max())
                                             == k * 128 * 128):
                raise AssertionError("spmv_mxu: the all -128 product is not K * 2^14")
            n += 1
    plan = spmv_mxu.spmv_plan(4224, 128, spmv_mxu.sm_count(device))
    if not plan.split_tiles:
        raise AssertionError("spmv_mxu: the K = 4224 plan splits no tile")
    a = rand_int8(gen, (4224, 4224), True, device)
    f = rand_int8(gen, (4224, 256), True, device)
    first, second = spmv_mxu.spmv_mxu(a, f), spmv_mxu.spmv_mxu(a, f)
    if not torch.equal(first, second):
        raise AssertionError("spmv_mxu: two calls with split tiles differ")
    assert_equal("spmv_mxu K=4224 R=256 vs torch._int_mm", first, torch._int_mm(a, f))
    log(f"spmv_mxu: {n} cases bit-identical to spmv_mxu_ref (0/1, full-range "
        f"int8 and all -128; K = 4224 splits {len(plan.split_tiles)} of "
        f"{plan.tiles} tiles over {plan.blocks} blocks); two calls at K = 4224, "
        f"R = 256 bit-identical and equal to torch._int_mm")


def serve_xdeepfm(device) -> dict:
    """Phase 8: the xDeepFM serving path at full width through the fused
    CIN kernel.  Returns the launch count, the check error and the times."""
    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys
    from repro_torch.train import train_step as TS

    spec = get("xdeepfm")
    cfg = dataclasses.replace(spec.make_config(), use_cin_kernel=True)
    log(f"    {spec.arch_id} ({spec.source}): n_sparse={cfg.n_sparse} "
        f"embed_dim={cfg.embed_dim} cin={cfg.cin_layers} mlp={cfg.mlp_layers} "
        f"rows_per_field={cfg.rows_per_field}; {spec.notes}")
    params = recsys.init_params(cfg, seed=0, device=device)
    serve = TS.make_xdeepfm_serve_step(cfg)
    cfg_plain = dataclasses.replace(cfg, use_cin_kernel=False)
    serve_plain = TS.make_xdeepfm_serve_step(cfg_plain)
    retrieve = TS.make_retrieval_step(cfg)
    b_p99 = spec.shape("serve_p99").dims["batch"]
    b_bulk = spec.shape("serve_bulk").dims["batch"]
    n_cand = spec.shape("retrieval_cand").dims["n_candidates"]
    ids_p99 = recsys_batch(0, 0, b_p99, cfg.n_sparse, cfg.rows_per_field,
                           device=device)["ids"]
    ids_bulk = recsys_batch(0, 1, b_bulk, cfg.n_sparse, cfg.rows_per_field,
                            device=device)["ids"]
    gen = torch.Generator(device=device).manual_seed(5)
    cand = torch.randn(n_cand, cfg.mlp_layers[-1], generator=gen, device=device)
    torch.cuda.synchronize()

    forwards = [0]

    def counted(fn):
        def run():
            forwards[0] += 1
            return fn()
        return run

    ops.reset_launch_counts()
    probs_p99 = counted(lambda: serve(params, ids_p99))()
    p99_ms = time_ms(counted(lambda: serve(params, ids_p99)), 20, 5)
    torch.cuda.reset_peak_memory_stats()
    probs_bulk = counted(lambda: serve(params, ids_bulk))()
    torch.cuda.synchronize()
    bulk_peak = torch.cuda.max_memory_allocated()
    bulk_ms = time_ms(counted(lambda: serve(params, ids_bulk)), 3, 1)
    scores = retrieve(params, ids_p99[:1], cand)
    ret_ms = time_ms(lambda: retrieve(params, ids_p99[:1], cand), 10, 5)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["cin_layer"]
    per_forward = len(cfg.cin_layers)
    if launches != per_forward * forwards[0]:
        raise AssertionError(f"cin_layer launched {launches} times over "
                             f"{forwards[0]} forwards, not {per_forward} per forward")
    log(f"    cin_layer launches {launches} over {forwards[0]} forwards "
        f"({per_forward} per forward)")

    # checks, after the counted window.  The CIN adds ~1e-8 to a logit at
    # the model's init scales, so the probabilities alone cannot see it:
    # the CIN features and layers are held with a tolerance scaled to
    # their own size.
    n = CIN_CHECK_ROWS
    rows = spread_rows(b_bulk, n, device)
    err = assert_close("serve_p99 probabilities: kernel path vs einsum path",
                       probs_p99, serve_plain(params, ids_p99))
    if probs_bulk.shape != (b_bulk,) or not torch.isfinite(probs_bulk).all():
        raise AssertionError("serve_bulk: probabilities not finite or misshapen")
    err = max(err, assert_close(f"serve_bulk probabilities, {n} rows, vs the "
                                f"einsum path", probs_bulk[rows],
                                serve_plain(params, ids_bulk[rows])))
    with torch.inference_mode():
        _, emb = recsys.embed(params, ids_p99, cfg)
        feat = recsys.cin_features(params, emb, cfg)
        feat_plain = recsys.cin_features(params, emb, cfg_plain)
        err = max(err, assert_close("serve_p99 pooled CIN features: kernel path vs "
                                    "einsum path", feat, feat_plain, scaled=True))
        log(f"    serve_p99 pooled CIN features {tuple(feat.shape)}: max |einsum "
            f"path| {float(feat_plain.abs().max()):.6e}, max abs diff "
            f"{float((feat - feat_plain).abs().max()):.6e}")
        _, emb = recsys.embed(params, ids_bulk, cfg)
        xl = emb
        for i, w in enumerate(recsys.cin_weights(params)):
            out = ops.cin_layer(emb, xl, w)
            want = ref.cin_layer_ref(emb[rows], xl[rows], w)
            err = max(err, assert_close(
                f"serve_bulk CIN layer {i + 1} (Fl={xl.shape[1]}), {n} rows",
                out[rows], want, scaled=True))
            log(f"    serve_bulk CIN layer {i + 1}: max |cin_layer_ref| "
                f"{float(want.abs().max()):.6e}, max abs diff "
                f"{float((out[rows] - want).abs().max()):.6e} on {n} rows "
                f"({n - 512} spread over the batch, the last 512)")
            xl = out
        del xl, out, emb, want
        h = recsys.dnn_tower(params, recsys.embed(params, ids_p99[:1], cfg)[1]
                        .reshape(1, -1))[0]
        want_scores = (cand.double() @ h.double()).float()
    if scores.shape != (n_cand,) or not torch.allclose(scores, want_scores,
                                                       rtol=1e-4, atol=1e-4):
        raise AssertionError("retrieval_cand: scores differ from a float64 matvec")
    log(f"    serve_p99  B={b_p99}: {p99_ms:.6f} ms/step, "
        f"{b_p99 / p99_ms * 1e3:.6e} rows/s; probabilities and pooled CIN "
        f"features within {CIN_TOL} of the einsum path")
    log(f"    serve_bulk B={b_bulk}: {bulk_ms:.6f} ms/step, "
        f"{b_bulk / bulk_ms * 1e3:.6e} rows/s, peak device memory "
        f"{bulk_peak / 2**30:.6f} GiB; each CIN layer within {CIN_TOL} of "
        f"cin_layer_ref on {n} rows (atol scaled to the layer)")
    log(f"    retrieval_cand: 1 query x {n_cand} candidates "
        f"{tuple(cand.shape)}: {ret_ms:.6f} ms; scores match a float64 matvec")
    log(f"    max abs err of the CIN checks: {err}")
    log(f"    profile of one serve_p99 step (B={b_p99})")
    profile_window(lambda: serve(params, ids_p99), ("cin_layer_kernel",))
    del params, cand, ids_bulk, probs_bulk
    torch.cuda.empty_cache()
    return dict(launches=launches, err=err, p99_ms=p99_ms, bulk_ms=bulk_ms,
                b_p99=b_p99, b_bulk=b_bulk, f0=cfg.n_sparse, d=cfg.embed_dim,
                cin_layers=cfg.cin_layers)


def dense_core_int8(a_core: torch.Tensor, chunk_rows: int = 4096) -> torch.Tensor:
    """The packed core (int32 bit-view [K, K/32]) as int8 0/1 [K, K]."""
    k, w = a_core.shape
    out = torch.empty((k, w * 32), dtype=torch.int8, device=a_core.device)
    shifts = torch.arange(32, dtype=torch.int32, device=a_core.device)
    for s in range(0, k, chunk_rows):
        # int32 >> is arithmetic: the & 1 drops the copies of bit 31
        bits = (a_core[s:s + chunk_rows, :, None] >> shifts) & 1
        out[s:s + chunk_rows] = bits.reshape(-1, w * 32).to(torch.int8)
    return out


def multi_source_on_core(built, levels: np.ndarray, device) -> dict:
    """Phase 9: ops.multi_source_spmv over the main path's heavy core."""
    from repro_torch.core.heavy import pack_bitmap
    from repro_torch.kernels import ops, ref
    k = built.core.k
    a_core = built.core.a_core
    a8 = dense_core_int8(a_core)
    lev = torch.as_tensor(levels[:, :k], device=device)
    n_levels = 128 // lev.shape[0]
    # column 8 r + l marks the core vertices at level l of root r
    f8 = (lev[:, None, :] == torch.arange(n_levels, device=device)[None, :, None]) \
        .reshape(-1, k).t().contiguous().to(torch.int8)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    counts = ops.multi_source_spmv(a8, f8)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["spmv_mxu"]
    if launches < 1:
        raise AssertionError("spmv_mxu was not launched by multi_source_spmv")
    err = max(assert_equal("multi_source_spmv vs spmv_mxu_ref", counts,
                           ref.spmv_mxu_ref(a8, f8)),
              assert_equal("multi_source_spmv vs torch._int_mm", counts,
                           torch._int_mm(a8, f8)))
    cols = [c for c in range(f8.shape[1]) if int(f8[:, c].sum()) > 0]
    checked = cols[:: max(1, len(cols) // 6)]
    for c in checked:
        fbm = pack_bitmap(f8[:, c] != 0, k // 32)
        reach = ref.core_spmv_ref(a_core, fbm) < ref.BIG
        if not torch.equal(counts[:, c] > 0, reach):
            raise AssertionError(f"multi_source_spmv column {c}: counts > 0 is not "
                                 f"the core neighbourhood of its frontier")
    log(f"    K={k} R={f8.shape[1]} ({lev.shape[0]} roots x levels 0-{n_levels - 1}; "
        f"{len(cols)} non-empty columns): counts bit-identical to spmv_mxu_ref and "
        f"torch._int_mm; counts > 0 equals the packed-bitmap neighbourhood for "
        f"columns {checked}; {launches} spmv_mxu launch; nnz(A8) "
        f"{int(a8.sum(dtype=torch.int64))}, frontier bits {int(f8.sum(dtype=torch.int64))}")
    return dict(a8=a8, f8=f8, launches=launches, err=err)


def time_cin(serving: dict, device) -> dict:
    """Phase 10, cin_layer: per layer shape at serve_p99 and serve_bulk."""
    from repro_torch.kernels import cin, ref
    gen = torch.Generator(device=device).manual_seed(6)
    f0, d, hs = serving["f0"], serving["d"], serving["cin_layers"]
    fls = [f0] + list(hs[:-1])
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, fp32_bound_ms=0.0, library_ms=0.0,
               bulk_ms=0.0, bulk_bound_ms=0.0, bulk_fp32_bound_ms=0.0, err=0.0)
    timed = {}
    for fl, h in zip(fls, hs):
        if (fl, h) not in timed:
            row = {}
            for b in (serving["b_p99"], 4096, serving["b_bulk"]):
                x0, xl, w = cin_operands(gen, b, f0, fl, h, d, device)
                n_bytes = 4 * (b * f0 * d + b * fl * d + h * f0 * fl + b * h * d)
                flops = 2 * b * h * f0 * fl * d
                # held to: three TF32 passes on the tensor cores; beside it,
                # the same flops once on the fp32 cores
                bnd = bound_ms(n_bytes, 3 * flops, TF32_TENSOR_FLOPS_PER_S)
                bnd32 = bound_ms(n_bytes, flops, FP32_FLOPS_PER_S)
                lib = lambda: torch.einsum("hij,bid,bjd->bhd", w, x0, xl)
                if b == serving["b_bulk"]:
                    row["bulk_ms"] = time_ms(lambda: cin.cin_layer(x0, xl, w), 3, 1)
                    row["bulk_bound"], row["bulk_bound32"] = bnd, bnd32
                    rows = spread_rows(b, CIN_CHECK_ROWS, device)
                    row["bulk_err"] = assert_close(
                        f"cin_layer B={b} F0={f0} Fl={fl} H={h} D={d}, "
                        f"{CIN_CHECK_ROWS} rows", cin.cin_layer(x0, xl, w)[rows],
                        ref.cin_layer_ref(x0[rows], xl[rows], w))
                elif b == 4096:
                    row["ms_4096"] = time_ms(lambda: cin.cin_layer(x0, xl, w), 10, 3)
                    row["lib_4096"] = time_ms(lib, 5, 1)
                else:
                    row["ms"] = time_ms(lambda: cin.cin_layer(x0, xl, w), 20, 10)
                    row["plain_ms"] = time_ms(lambda: ref.cin_layer_ref(x0, xl, w), 5, 1)
                    row["lib_ms"] = time_ms(lib, 10, 3)
                    row["bound"], row["bound32"] = bnd, bnd32
                    row["bytes"], row["flops"] = n_bytes, flops
                    row["plan"] = cin.cin_plan(b, f0, fl, h, d, sms=cin.sm_count(device))
                del x0, xl, w
            torch.cuda.empty_cache()
            timed[(fl, h)] = row
            plan = row["plan"]
            log(f"    cin_layer F0={f0} Fl={fl} H={h} D={d}: B={serving['b_p99']} "
                f"(grid {plan.grid}, {plan.warps} warps, {plan.smem_bytes} B shared) "
                f"{row['ms']:.6f} ms (plain {row['plain_ms']:.6f}, library einsum "
                f"{row['lib_ms']:.6f}; 3xTF32 bound {row['bound'][0]:.6f} "
                f"{row['bound'][1]}, {row['bound'][0] / row['ms']:.6f} of it; fp32 "
                f"bound {row['bound32'][0]:.6f}, {row['bound32'][0] / row['ms']:.6f} "
                f"of it; {row['flops'] / row['ms'] / 1e9:.6f} TFLOP/s); B=4096 "
                f"{row['ms_4096']:.6f} ms (library {row['lib_4096']:.6f}); "
                f"B={serving['b_bulk']} {row['bulk_ms']:.6f} ms (3xTF32 bound "
                f"{row['bulk_bound'][0]:.6f}, {row['bulk_bound'][0] / row['bulk_ms']:.6f} "
                f"of it; fp32 bound {row['bulk_bound32'][0]:.6f}, "
                f"{row['bulk_bound32'][0] / row['bulk_ms']:.6f} of it; max abs err "
                f"{row['bulk_err']:.6e} on {CIN_CHECK_ROWS} rows within rtol = atol "
                f"= {CIN_TOL})")
        row = timed[(fl, h)]
        tot["ms"] += row["ms"]
        tot["plain_ms"] += row["plain_ms"]
        tot["library_ms"] += row["lib_ms"]
        tot["bound_ms"] += row["bound"][0]
        tot["fp32_bound_ms"] += row["bound32"][0]
        tot["bound_by"] = max((r["bound"] for r in timed.values()))[1]
        tot["bulk_ms"] += row["bulk_ms"]
        tot["bulk_bound_ms"] += row["bulk_bound"][0]
        tot["bulk_fp32_bound_ms"] += row["bulk_bound32"][0]
        tot["err"] = max(tot["err"], row["bulk_err"])
    for cell, step_ms, cin_ms, bnd, bnd32 in (
            ("serve_p99", serving["p99_ms"], tot["ms"], tot["bound_ms"],
             tot["fp32_bound_ms"]),
            ("serve_bulk", serving["bulk_ms"], tot["bulk_ms"], tot["bulk_bound_ms"],
             tot["bulk_fp32_bound_ms"])):
        log(f"    {cell}: CIN kernels {cin_ms:.6f} ms of a {step_ms:.6f} ms step "
            f"(share {cin_ms / step_ms:.6f}); 3xTF32 bound {bnd:.6f} ms "
            f"({bnd / cin_ms:.6f} of it), fp32 bound {bnd32:.6f} ms "
            f"({bnd32 / cin_ms:.6f} of it)")
    log(f"    library einsum, the forward's three layers at B={serving['b_p99']}: "
        f"{tot['library_ms']:.6f} ms; the kernel {tot['ms']:.6f} ms")
    return tot


def time_cin_splits(serving: dict, device) -> None:
    """Phase 10, cin_layer at serve_p99: the forward's three layers with the
    F0 sum split over 1-8 blocks, beside the split the plan picks."""
    from repro_torch.kernels import cin
    gen = torch.Generator(device=device).manual_seed(8)
    b, f0, d, hs = serving["b_p99"], serving["f0"], serving["d"], serving["cin_layers"]
    layers = [cin_operands(gen, b, f0, fl, h, d, device)
              for fl, h in zip([f0] + list(hs[:-1]), hs)]
    times = {}
    for splits in (1, 2, 3, 4, 5, 8):
        times[splits] = sum(time_ms(lambda: cin.cin_layer(x0, xl, w, splits=splits), 10, 5)
                            for x0, xl, w in layers)
    pick = {cin.cin_plan(b, f0, w.shape[2], w.shape[0], d, sms=cin.sm_count(device)).splits
            for _, _, w in layers}
    log(f"    cin_layer B={b}, the forward's three layers by splits of the F0 sum: "
        + ", ".join(f"{k}: {v:.6f} ms" for k, v in times.items())
        + f"; the plan picks {sorted(pick)}")


def time_spmv(spmv: dict) -> dict:
    """Phase 10, spmv_mxu at the core's shape (the prep launch, F's
    transpose, included in its time)."""
    from repro_torch.kernels import ref, spmv_mxu
    a8, f8 = spmv["a8"], spmv["f8"]
    k, r = f8.shape
    plan = spmv_mxu.spmv_plan(k, r, spmv_mxu.sm_count(a8.device))
    ms = time_ms(lambda: spmv_mxu.spmv_mxu(a8, f8), 10, 3)
    plain = time_ms(lambda: ref.spmv_mxu_ref(a8, f8), 2, 1)
    lib = time_ms(lambda: torch._int_mm(a8, f8), 10, 3)
    bnd = bound_ms(k * k + k * r + 4 * k * r, 2 * k * k * r, INT8_TENSOR_OPS_PER_S)
    log(f"    spmv_mxu K={k} R={r}: {ms:.6f} ms, plain {plain:.6f} ms, "
        f"torch._int_mm {lib:.6f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}; "
        f"{bnd[0] / ms:.6f} of it; A streamed at {k * k / ms / 1e9:.6f} TB/s)")
    log(f"    spmv_mxu plan: {plan.blocks} blocks, {plan.units} units "
        f"({plan.tiles} tiles x {plan.k_steps} k steps, "
        f"{plan.ranges[0][1] - plan.ranges[0][0]}-{plan.ranges[-1][1] - plan.ranges[-1][0]} "
        f"units a block), {len(plan.split_tiles)} split tiles")
    profile_window(lambda: spmv_mxu.spmv_mxu(a8, f8),
                   ("spmv_prep_kernel", "spmv_mxu_kernel"))
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound=bnd)


def check_valid(name: str, run) -> None:
    if not run.all_valid or any(run.check_counts.values()):
        raise AssertionError(f"{name}: validation failed {run.check_counts}")


def check_scale16() -> None:
    from repro_torch.core import pipeline
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.reference import reference_bfs
    cfg = pipeline.Graph500Config.ladder("pre-g500", scale=SCALE_CHECK, n_roots=2,
                                         check="full")
    built = pipeline.build(cfg)
    roots = pipeline.search_keys(cfg, built)
    res = compile_plan(cfg.to_plan(), built).run(roots, check="full")
    check_valid(f"scale {SCALE_CHECK}", res.run)
    deg = built.degree.cpu().numpy().astype(np.int64)
    row_offsets = np.concatenate([[0], np.cumsum(deg)])
    col = built.ev.dst.cpu().numpy()
    for i, r in enumerate(roots):
        _, ref_level = reference_bfs(row_offsets, col, int(r))
        if not np.array_equal(res.level[i], ref_level):
            raise AssertionError(f"scale {SCALE_CHECK} root {r}: levels differ "
                                 f"from the reference BFS")
    log(f"    scale {SCALE_CHECK}: levels of {len(roots)} roots equal the "
        f"reference BFS; traversed edges {res.run.edges}")


def time_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profile_window(fn, kernels: tuple[str, ...]) -> dict | None:
    """Device busy share and device time by kernel over one call of ``fn``
    (after one warm-up call), from torch.profiler's CUDA activity (printed
    as not measured when the profiler records no device activity).  Returns
    the count of device activities, of memsets among them, and the device
    time (us) and launches of each of ``kernels``; None when not measured."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, order = [], {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        order.append((start, e.name))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (end - start), n + 1)
    order.sort()
    # the device operation that follows each memset, by name
    after_memset: dict = {}
    for (_, name), (_, nxt) in zip(order, order[1:]):
        if "memset" in name.lower():
            after_memset[nxt[:70]] = after_memset.get(nxt[:70], 0) + 1
    if not spans:
        log("    device time: not measured (the profiler recorded no CUDA activity)")
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    memsets = sum(n for name, (_, n) in by_name.items() if "memset" in name.lower())
    log(f"    wall {wall_us / 1e3:.6f} ms (host clock, profiler on), device busy "
        f"{busy / 1e3:.6f} ms, idle share {1 - busy / wall_us:.6f}, "
        f"{len(spans)} device activities ({memsets} memsets)")
    if after_memset:
        log("    memsets precede: " + "; ".join(f"x{n} {name}" for name, n in
                                                 after_memset.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (tot, n) in top:
        log(f"    {tot / 1e3:10.6f} ms  x{n:<4d} {name[:110]}")
    stats = dict(activities=len(spans), memsets=memsets, kernels={},
                 wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                 idle_share=1 - busy / wall_us)
    for kernel in kernels:
        hits = [(name, tot, n) for name, (tot, n) in by_name.items() if kernel in name]
        tot, n = sum(t for _, t, _ in hits), sum(c for _, _, c in hits)
        per = f"{tot / n / 1e3:.6f} ms per launch" if n else "not launched"
        log(f"    {kernel}: device {tot / 1e3:.6f} ms over {n} launches ({per})")
        if len(hits) > 1:
            for name, t_, c in hits:
                log(f"      {t_ / 1e3:.6f} ms x{c} {name[:100]}")
        stats["kernels"][kernel] = (tot, n)
        stats.setdefault("memset_before", {})[kernel] = sum(
            c for name, c in after_memset.items() if kernel in name)
    return stats


def time_validation(kernel: str, ev, rows, keys) -> float:
    """Host-clock ms per root of the kernel's five spec checks over
    ``rows`` (synchronised), one batched call after a warm-up call."""
    from repro_torch.core.kernels import validate_result_batch
    parents = torch.stack([r.parent for r in rows])
    levels = torch.stack([r.level for r in rows])
    val = validate_result_batch(kernel, ev, parents, levels, keys)
    torch.cuda.synchronize()
    if not bool(val.ok.all()):
        raise AssertionError(f"{kernel}: validation of the timed rows failed")
    t0 = time.perf_counter()
    validate_result_batch(kernel, ev, parents, levels, keys)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(keys)


def ladder_rungs(built, res_root, roots) -> int:
    """Phase 11: the Fig. 18 ladder's reference and legacy rungs at scale
    20.  Returns the ``core_spmv`` launches of ``pre-g500-legacy``."""
    from repro_torch.core import pipeline
    from repro_torch.core.hybrid_bfs import BOTTOM_UP
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels import ops
    legacy_launches = 0
    summary = []
    # every rung searches from phase 5's first roots, in the input labels
    orig = built.reorder.old_from_new[
        torch.as_tensor(roots[:LADDER_ROOTS], device=built.degree.device).long()]
    for rung in ("reference-3.0.0", "th2", "k", "pre-g500-legacy"):
        cfg = pipeline.Graph500Config.ladder(rung, scale=SCALE_MAIN,
                                             n_roots=LADDER_ROOTS, check="post")
        if cfg.degree_sort:
            # phase 5's graph is this rung's build: same seed, same sort
            b = dataclasses.replace(
                built, core=built.core if cfg.heavy_threshold is not None else None)
        else:
            b = pipeline.build(cfg)
            log(f"    {rung}: construction {b.construction_s:.6f} s (no degree "
                f"sort, no core)")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _, run = pipeline.run(cfg, b, roots=orig)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check_valid(rung, run)
        keys = pipeline.search_keys(cfg, b, orig)
        compiled = compile_plan(cfg.to_plan(), b)
        rows = [compiled.bfs(int(r)) for r in keys]
        levels = [int(r.stats.levels) for r in rows]
        n_bu = [int((r.stats.direction == BOTTOM_UP).sum()) for r in rows]
        if cfg.degree_sort:
            if not np.array_equal(keys, roots[:LADDER_ROOTS]):
                raise AssertionError(f"{rung}: search keys differ from phase 5's")
            parents = torch.stack([r.parent for r in rows]).cpu().numpy()
            if not np.array_equal(parents, res_root.parent[:LADDER_ROOTS]):
                raise AssertionError(f"{rung}: parents differ from pre-g500's")
        if rung == "pre-g500-legacy":
            # the timed traversals and the warm-up of the first root
            want = sum(n_bu) + n_bu[0]
            if launches["core_spmv"] != want or want <= 0:
                raise AssertionError(f"{rung}: core_spmv launched "
                                     f"{launches['core_spmv']} times, not once "
                                     f"for each of the {want} bottom-up levels")
            legacy_launches = launches["core_spmv"]
        elif any(launches.values()):
            raise AssertionError(f"{rung}: the reference engine launched {launches}")
        log(f"    {rung} (engine {cfg.engine}, alpha {cfg.alpha}, beta {cfg.beta}): "
            f"hmean TEPS {run.harmonic_mean_teps:.6e}, mean time/root "
            f"{run.mean_time_s * 1e3:.6f} ms, levels {levels}, bottom-up levels "
            f"{n_bu}, launches {launches}, check_counts {run.check_counts}"
            + ("; parents equal pre-g500's" if cfg.degree_sort else ""))
        if rung == "th2":
            log(f"    validate_batch (the five BFS checks) on th2's rows: "
                f"{time_validation('bfs', b.ev, rows, keys):.6f} ms per root")
        log(f"    profile of one {rung} traversal (root {int(keys[1])})")
        prof = profile_window(lambda: compiled.bfs(int(keys[1])), ("core_spmv_kernel",))
        summary.append((rung, run.harmonic_mean_teps, run.mean_time_s * 1e3,
                        None if prof is None else prof["idle_share"]))
        del rows, compiled
    for rung, teps, ms, idle in summary:
        log(f"    ladder {rung}: hmean TEPS {teps:.6e}, {ms:.6f} ms/root, idle "
            f"share of one traversal {idle}")
    return legacy_launches


def sssp_against_oracle(name: str, el, device, n_roots: int, degree_sort: bool,
                        max_levels: int) -> None:
    """Phase 12: SSSP on the card equal to the host Dijkstra oracle."""
    from repro_torch.core import (build_csr, edge_view, sample_roots,
                                  sssp_oracle, with_edge_weights)
    from repro_torch.core.plan import PreparedGraph, TraversalPlan, compile_plan
    from repro_torch.core.reorder import degree_reorder, relabel_edges
    g = build_csr(el)
    roots = sample_roots(SSSP_SEED, el, n_roots)
    if degree_sort:
        r = degree_reorder(g.degree)
        g = build_csr(relabel_edges(el, r))
        roots = r.new_from_old[roots.long()]
    ev = with_edge_weights(edge_view(g), seed=SSSP_SEED, max_weight=SSSP_MAX_WEIGHT)
    compiled = compile_plan(TraversalPlan(kernel="sssp", batch_roots=False,
                                          max_levels=max_levels),
                            PreparedGraph(ev=ev, degree=g.degree), device=device)
    args = (ev.src.cpu().numpy(), ev.dst.cpu().numpy(), ev.valid.cpu().numpy(),
            ev.weight.cpu().numpy(), g.num_vertices)
    rounds = []
    for root in roots.cpu().numpy():
        res = compiled.bfs(int(root))
        t0 = time.perf_counter()
        p, d = sssp_oracle(*args, int(root))
        oracle_s = time.perf_counter() - t0
        if not (np.array_equal(res.parent.cpu().numpy(), p)
                and np.array_equal(res.level.cpu().numpy(), d)):
            raise AssertionError(f"SSSP on {name}, root {root}: parents or "
                                 f"distances differ from sssp_oracle")
        rounds.append(int(res.stats.levels))
    log(f"    {name}: V={g.num_vertices} nnz={int(g.nnz)} delta {compiled.delta}, "
        f"round bound {compiled.max_rounds}: roots {roots.tolist()} took rounds "
        f"{rounds}, max distance {int(d.max())}; parents and distances equal "
        f"sssp_oracle (its Dijkstra {oracle_s:.3f} s on the host)")


def sssp_phase(device) -> dict:
    """Phase 12: Graph500 SSSP at scale 20, per root and batched.  Returns
    the first roots' keys, parents and distances (on the host)."""
    from repro_torch.core import kronecker, pipeline
    from repro_torch.core.plan import compile_plan
    from repro_torch.data.graphs import grid_graph
    from repro_torch.kernels import ops
    cfg = pipeline.Graph500Config(kernel="sssp", scale=SCALE_MAIN, n_roots=SSSP_ROOTS,
                                  max_weight=SSSP_MAX_WEIGHT, seed=SSSP_SEED,
                                  check="post")
    cfg_b = dataclasses.replace(cfg, batched=True)
    built = pipeline.build(cfg)
    log(f"    construction {built.construction_s:.6f} s: V={built.n_vertices} "
        f"nnz={built.nnz}, weights in [1, {cfg.max_weight}]")
    ops.reset_launch_counts()
    _, run = pipeline.run(cfg, built)
    _, run_b = pipeline.run(cfg_b, built)
    torch.cuda.synchronize()
    check_valid("sssp", run)
    check_valid("sssp batched", run_b)
    keys = pipeline.search_keys(cfg, built)
    per_root = compile_plan(cfg.to_plan(), built)
    rows = [per_root.bfs(int(r)) for r in keys]
    batch = compile_plan(cfg_b.to_plan(), built).bfs(keys)
    for f in ("parent", "level"):
        if not torch.equal(torch.stack([getattr(r, f) for r in rows]), getattr(batch, f)):
            raise AssertionError(f"sssp: batched {f} rows differ from per-root rows")
    for f in batch.stats._fields:
        if not torch.equal(torch.stack([getattr(r.stats, f) for r in rows]),
                           getattr(batch.stats, f)):
            raise AssertionError(f"sssp: batched stats.{f} differ from per-root rows")
    rounds = [int(r.stats.levels) for r in rows]
    log(f"    per root: hmean TEPS {run.harmonic_mean_teps:.6e}, mean time/root "
        f"{run.mean_time_s * 1e3:.6f} ms; batched: hmean TEPS "
        f"{run_b.harmonic_mean_teps:.6e}, {run_b.mean_time_s * 1e3:.6f} ms/root; "
        f"delta {per_root.delta}, round bound {per_root.max_rounds}, rounds per "
        f"root {rounds}; check_counts {run.check_counts}; kernel launches "
        f"{ops.launch_counts()}")
    log("    batched rows (parents, distances, every stats trace) equal the "
        "per-root rows")
    log(f"    validate_sssp_batch (the five SSSP checks): "
        f"{time_validation('sssp', built.ev, rows, keys):.6f} ms per root")
    log(f"    profile of one root's SSSP (root {int(keys[0])}, {rounds[0]} rounds)")
    profile_window(lambda: per_root.bfs(int(keys[0])), ())
    # phase 17 holds the sharded SSSP against these rows
    first = dict(keys=keys[:MESH_SSSP_ROOTS],
                 parent=torch.stack([r.parent for r in rows[:MESH_SSSP_ROOTS]]).cpu(),
                 level=torch.stack([r.level for r in rows[:MESH_SSSP_ROOTS]]).cpu())
    del rows, batch, per_root, built
    torch.cuda.empty_cache()
    sssp_against_oracle(f"grid_graph({GRID_SIDE})", grid_graph(GRID_SIDE, seed=5,
                                                               device=device),
                        device, 2, False, GRID_MAX_LEVELS)
    sssp_against_oracle(f"Kronecker scale {SCALE_ORACLE}",
                        kronecker.generate_edges(SSSP_SEED, SCALE_ORACLE,
                                                 device=device),
                        device, 2, True, 64)
    return first


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checked_execution(cfg_b, built, roots, parents, device) -> dict:
    """Phase 13: a persistent parent fault on one root through the batched
    and the per-root plan (detected, retried, quarantined; the per-root plan
    falls back once), a clean run with recovery armed, and the SSSP kernel
    with a parent-offset fault on every root.  Returns the kernel launches
    of the faulted and clean BFS runs and the weighted graph for phase 14."""
    from repro_torch.core import with_edge_weights
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.plan import PreparedGraph, TraversalPlan, compile_plan
    from repro_torch.core.teps import Graph500Run
    from repro_torch.kernels import ops
    bad_i = FAULT_ROOT_INDEX
    bad = int(roots[bad_i])
    keep = [i for i in range(len(roots)) if i != bad_i]
    fault = FaultSpec("parent", "self", level=1, persistent=True, root=bad)
    log(f"    fault {fault.describe()}")
    plan_b = cfg_b.to_plan()
    launches: dict = {}
    for name, plan, want_fb in (("pre-g500-batch", plan_b, 0),
                                ("per-root", dataclasses.replace(plan_b, batch_roots=False), 1)):
        compiled = compile_plan(plan, built, device=device, fault=fault)
        sync(device)
        ops.reset_launch_counts()
        res = compiled.run(roots, check="full", retries=1, fallback=True)
        sync(device)
        for k, n in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        g = res.run
        log(f"    {name}: check_counts {g.check_counts}, check_failures "
            f"{g.check_failures}, retries {g.retries}, fallbacks {g.fallbacks}, "
            f"quarantined {g.quarantined}, validated {g.validated.count(True)} of "
            f"{len(g.validated)}, hmean TEPS {g.harmonic_mean_teps:.6e} over "
            f"{sum(t > 0 for t in g.teps)} roots")
        if set(g.check_failures) != {bad} or "depth" not in g.check_failures[bad]:
            raise AssertionError(f"{name}: the fault on root {bad} was detected as "
                                 f"{g.check_failures}")
        if (g.retries, g.fallbacks, g.quarantined) != (1, want_fb, [bad]):
            raise AssertionError(f"{name}: retries {g.retries}, fallbacks "
                                 f"{g.fallbacks}, quarantined {g.quarantined}")
        if not np.array_equal(res.parent[keep], parents[keep]):
            raise AssertionError(f"{name}: the {len(keep)} clean rows differ from "
                                 f"phase 5's parents")
        if g.teps[bad_i] != 0.0 or sum(t > 0 for t in g.teps) != len(keep) or \
                g.harmonic_mean_teps != Graph500Run(
                    teps=[g.teps[i] for i in keep]).harmonic_mean_teps:
            raise AssertionError(f"{name}: the hmean is not over the {len(keep)} "
                                 f"clean roots")
        if np.array_equal(res.parent[bad_i], parents[bad_i]):
            raise AssertionError(f"{name}: the quarantined row is not corrupted")
    log(f"    the {len(keep)} clean rows equal phase 5's parents bit for bit")
    ops.reset_launch_counts()
    clean = compile_plan(plan_b, built, device=device).run(
        roots, check="full", retries=2, fallback=True)
    sync(device)
    for k, n in ops.launch_counts().items():
        launches[k] = launches.get(k, 0) + n
    g = clean.run
    if not g.all_valid or g.retries or g.fallbacks or g.quarantined \
            or any(g.check_counts.values()):
        raise AssertionError(f"clean run with recovery armed: {g}")
    log(f"    clean, check='full', retries=2, fallback=True: all valid, retries "
        f"{g.retries}, fallbacks {g.fallbacks}, hmean TEPS "
        f"{g.harmonic_mean_teps:.6e}; launches of the three runs {launches}")
    if launches["frontier_update"] <= 0 or launches["core_spmv"] <= 0:
        raise AssertionError(f"checked execution launched {launches}")

    t0 = time.perf_counter()
    wev = with_edge_weights(built.ev, seed=SSSP_SEED, max_weight=SSSP_MAX_WEIGHT)
    sync(device)
    log(f"    SSSP weight plane on phase 5's graph: {time.perf_counter() - t0:.6f} s")
    weighted = PreparedGraph(ev=wev, degree=built.degree)
    sfault = FaultSpec("parent", "offset", level=1, persistent=True)
    sroots = roots[:FAULT_SSSP_ROOTS]
    run = compile_plan(TraversalPlan(kernel="sssp", batch_roots=True), weighted,
                       device=device, fault=sfault).run(
        sroots, check="post", retries=1, fallback=True).run
    log(f"    SSSP, fault {sfault.describe()}: check_counts {run.check_counts}, "
        f"retries {run.retries}, fallbacks {run.fallbacks}, quarantined "
        f"{run.quarantined}, hmean TEPS {run.harmonic_mean_teps}")
    n = len(sroots)
    if run.check_counts.get("tree_dist") != n or run.quarantined != \
            [int(r) for r in sroots] or (run.retries, run.fallbacks) != (n, 0) \
            or run.harmonic_mean_teps != 0.0:
        raise AssertionError("SSSP: the parent fault was not quarantined on every root")
    return dict(launches=launches, weighted=weighted)


def serve_summary(name: str, report) -> None:
    s = report.summary()
    svc = np.asarray([b.service_s for b in report.batches]) * 1e3
    full = np.asarray([b.service_s for b in report.batches if b.n_pad == 0]) * 1e3
    log(f"    {name}: {s['n_queries']} queries, kinds {s['kinds']}, "
        f"{s['n_batches']} batches; latency p50 {s['latency_p50_s'] * 1e3:.6f} ms, "
        f"p99 {s['latency_p99_s'] * 1e3:.6f} ms, p99.9 "
        f"{s['latency_p999_s'] * 1e3:.6f} ms; qps {s['qps']:.6f}; cache hit rate "
        f"{s['cache']['hit_rate']:.6f}; mean occupancy {s['occupancy_mean']:.6f} "
        f"(histogram {s['occupancy_hist']}); service ms per batch: mean "
        f"{svc.mean():.6f}, median {np.median(svc):.6f}, max {svc.max():.6f}"
        + (f", full batches (8 real roots) {full.mean():.6f}" if full.size else ""))


def check_answers(name: str, report, rows: dict, failed_root=None) -> None:
    """Every answer equals its root's offline row in ``rows``; only
    ``failed_root`` may come back failed, and then every time."""
    for a in report.answers:
        if a.root == failed_root:
            if a.kind != "failed" or a.parent is not None:
                raise AssertionError(f"{name}: root {a.root} answered ({a.kind}) "
                                     f"despite its fault")
            continue
        if a.kind == "failed":
            raise AssertionError(f"{name}: query {a.qid} (root {a.root}) failed")
        want_p, want_l = rows[a.root]
        if not (np.array_equal(a.parent, want_p) and np.array_equal(a.level, want_l)):
            raise AssertionError(f"{name}: query {a.qid} ({a.kind}, root {a.root}) "
                                 f"differs from the offline run")


def offline_rows(compiled, roots) -> dict:
    uniq = sorted({int(r) for r in roots})
    if not uniq:
        return {}
    res = compiled.run(np.asarray(uniq), warmup=False, check="post")
    if not res.run.all_valid:
        raise AssertionError(f"offline run invalid: {res.run.check_counts}")
    return {r: (res.parent[i], res.level[i]) for i, r in enumerate(uniq)}


def serving_phase(cfg_b, built, weighted, device) -> dict:
    """Phase 14: BFS serving through ``pipeline.serve`` on two traces (every
    answer equal to the offline run, the kernels launched), a faulted engine
    (a hot root fails, nothing else changes) and a short SSSP engine."""
    from repro_torch.core import pipeline
    from repro_torch.core.faults import FaultSpec
    from repro_torch.data.query_trace import synth_trace
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine, ServeConfig
    scfg = ServeConfig(**SERVE_CFG)
    t0 = time.perf_counter()
    _, eng = pipeline.serve(cfg_b, scfg, built=built)
    sync(device)
    log(f"    engine up (compile + warm-up batch of root 0) in "
        f"{time.perf_counter() - t0:.6f} s; plan {eng.plan.to_dict()}")
    launches: dict = {}
    reports = {}
    for name, rate, zipf in SERVE_TRACES:
        trace = synth_trace(7, SERVE_QUERIES, built.n_vertices, rate_qps=rate,
                            zipf_s=zipf, degree=built.degree)
        eng.reset_cache()
        sync(device)
        ops.reset_launch_counts()
        reports[name] = eng.serve(trace)
        sync(device)
        got = ops.launch_counts()
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        if got["frontier_update"] <= 0 or got["core_spmv"] <= 0:
            raise AssertionError(f"{name}: serving launched {got}")
        serve_summary(name, reports[name])
        log(f"      launches while serving {got}")
    roots = [a.root for r in reports.values() for a in r.answers]
    rows = offline_rows(eng.compiled, roots)
    for name, report in reports.items():
        check_answers(name, report, rows)
        kinds = report.summary()["kinds"]
        log(f"    {name}: all {len(report.answers)} answers ({kinds}) equal the "
            f"offline run bit for bit")

    trace = synth_trace(7, SERVE_QUERIES, built.n_vertices, rate_qps=SERVE_TRACES[1][1],
                        zipf_s=SERVE_TRACES[1][2], degree=built.degree)
    uniq, n = np.unique(trace.roots, return_counts=True)
    hot = int(uniq[np.argmax(n)])
    fault = FaultSpec("parent", "self", level=1, persistent=True, root=hot)
    feng = Engine(built, plan=eng.plan, config=scfg, fault=fault, device=device)
    report = feng.serve(trace)
    rows.update(offline_rows(eng.compiled, [r for r in uniq if r not in rows]))
    check_answers("faulted engine", report, rows, failed_root=hot)
    failed = [a for a in report.answers if a.kind == "failed"]
    if len(failed) != int(n.max()) or any(a.attempts != scfg.max_requeues + 1
                                          for a in failed):
        raise AssertionError(f"faulted engine: {len(failed)} failed answers for the "
                             f"{int(n.max())} queries of root {hot}")
    s = report.summary()
    log(f"    faulted engine ({fault.describe()}) on serve_burst: kinds {s['kinds']}, "
        f"check_counts {s['check_counts']}, fallback batches "
        f"{s['fallback_batches']}; all {len(failed)} queries of root {hot} failed "
        f"after {scfg.max_requeues} requeues, the other answers equal the clean "
        f"offline run")

    seng = Engine(weighted, config=scfg, kernel="sssp", device=device)
    trace = synth_trace(7, SERVE_SSSP_QUERIES, built.n_vertices, rate_qps=2000.0,
                        zipf_s=1.1, degree=built.degree)
    report = seng.serve(trace)
    check_answers("sssp engine", report,
                  offline_rows(seng.compiled, [a.root for a in report.answers]))
    serve_summary("sssp engine", report)
    log("    sssp engine: every answer (parents and distances) equals the offline "
        "SSSP run")
    return dict(launches=launches)


def tuning_phase(built, run_b, device) -> dict:
    """Phase 15: the plan auto-tuner's sweep on the card (every candidate
    accepted bitwise, both kernels launched), then its table through the
    ``pre-g500-tuned`` rung and the serving plan, and their fallback with
    no table."""
    import os
    import tempfile
    from repro_torch.core import pipeline, tune
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import resolve_serve_plan

    sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = tune.sweep(SCALE_MAIN, budget=TUNE_BUDGET, n_roots=N_ROOTS, reps=TUNE_REPS,
                     device=device.type, log=lambda msg: None)
    sync(device)
    sweep_s = time.perf_counter() - t0
    sweep_launches = ops.launch_counts()
    for line in rep.table().splitlines():
        log(f"    {line}")
    log(f"    sweep of {len(rep.results) + len(rep.skipped)} candidates in "
        f"{sweep_s:.6f} s (graph build, oracle and each candidate's parity pass "
        f"included); launches during the sweep {sweep_launches}")
    if rep.skipped or len(rep.results) != len(tune.enumerate_plans(
            rep.n_devices, tune.BUDGETS[TUNE_BUDGET])):
        raise AssertionError(f"sweep: {[(r.status, r.reason) for r in rep.skipped]}")
    if not all(r.identical for r in rep.results):
        raise AssertionError("sweep: an accepted candidate is not bitwise identical")
    if sweep_launches["frontier_update"] <= 0 or sweep_launches["core_spmv"] <= 0:
        raise AssertionError(f"sweep launched {sweep_launches}")
    win = rep.winner
    default = [r for r in rep.results
               if all(getattr(r.plan, k) == v for k, v in TUNE_DEFAULT.items())][0]
    log(f"    winner alpha {win.plan.alpha:g} beta {win.plan.beta:g} n_chunks "
        f"{win.plan.n_chunks}: {win.per_root_us:.6f} us per root, hmean TEPS "
        f"{win.harmonic_mean_teps:.6e}; default (alpha 14, beta 24, 64 chunks): "
        f"{default.per_root_us:.6f} us per root, hmean TEPS "
        f"{default.harmonic_mean_teps:.6e}; default / winner "
        f"{default.per_root_us / win.per_root_us:.6f}")

    old_env = os.environ.get(tune.TABLE_ENV)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ[tune.TABLE_ENV] = tune.save_tuned(
                rep, os.path.join(tmp, "TUNED_PLANS_torch.json"))
            cfg = pipeline.Graph500Config.ladder(
                "pre-g500-tuned", scale=SCALE_MAIN, n_roots=N_ROOTS, check="full",
                device=device.type)
            if cfg.to_plan() != win.plan:
                raise AssertionError(f"pre-g500-tuned runs {cfg.to_plan()}, the "
                                     f"winner is {win.plan}")
            sync(device)
            ops.reset_launch_counts()
            _, run_t = pipeline.run(cfg, built)
            sync(device)
            tuned_launches = ops.launch_counts()
            check_valid("pre-g500-tuned", run_t)
            if tuned_launches["frontier_update"] <= 0 or tuned_launches["core_spmv"] <= 0:
                raise AssertionError(f"pre-g500-tuned launched {tuned_launches}")
            served = resolve_serve_plan(scale=SCALE_MAIN, device=device.type)
            if served != dataclasses.replace(win.plan, batch_roots=True):
                raise AssertionError(f"resolve_serve_plan(scale={SCALE_MAIN}) gave "
                                     f"{served}")
            log(f"    pre-g500-tuned on phase 5's graph runs the winner: hmean TEPS "
                f"{run_t.harmonic_mean_teps:.6e} (phase 5's pre-g500-batch "
                f"{run_b.harmonic_mean_teps:.6e}), mean time/root "
                f"{run_t.mean_time_s * 1e3:.6f} ms, all_valid {run_t.all_valid}, "
                f"launches {tuned_launches}; resolve_serve_plan(scale={SCALE_MAIN}) "
                f"serves the winner, batched")
            os.environ[tune.TABLE_ENV] = os.path.join(tmp, "missing.json")
            untuned = pipeline.Graph500Config.ladder(
                "pre-g500-batch", device=device.type).to_plan()
            if (cfg.to_plan() != untuned or resolve_serve_plan(
                    scale=SCALE_MAIN, device=device.type) != resolve_serve_plan()):
                raise AssertionError("with no table the tuned plans are not the "
                                     "untuned ones")
            log("    with the table missing, pre-g500-tuned and the serving plan "
                "fall back to the untuned batched plan")
    finally:
        if old_env is None:
            os.environ.pop(tune.TABLE_ENV, None)
        else:
            os.environ[tune.TABLE_ENV] = old_env
    return dict(sweep=sweep_launches, tuned=tuned_launches)


VERTEX = ("group", "member")


def virtual_mesh(shape, names=VERTEX):
    from repro_torch.comms.mesh import make_mesh
    return make_mesh(shape, names, device="cuda", virtual=True)


def mesh_run(name: str, compiled, keys, parents, n_keys: int) -> dict:
    """One checked run of a mesh plan on phase 5's keys: valid, parents
    sha-equal to phase 5's rows, the kernel launches counted from 0 just
    before and read just after.  Returns the run's numbers."""
    from repro_torch.kernels import ops
    from repro_torch.launch.multiprocess import parent_digest
    keys = keys[:n_keys]
    sync(compiled.device)
    ops.reset_launch_counts()
    res = compiled.run(keys, check="full")
    sync(compiled.device)
    launches = ops.launch_counts()
    check_valid(name, res.run)
    got, want = parent_digest(res.parent), parent_digest(parents[:n_keys])
    if got != want:
        raise AssertionError(f"{name}: parents sha {got[:16]} != phase 5's {want[:16]}")
    ms = res.run.mean_time_s * 1e3
    log(f"    {name}: {n_keys} keys, hmean TEPS {res.run.harmonic_mean_teps:.6e}, "
        f"{ms:.6f} ms per traversal, parents sha256 {got[:16]} = phase 5's, "
        f"mesh {res.mesh_axes}, launches frontier_update "
        f"{launches['frontier_update']} core_spmv {launches['core_spmv']}")
    return dict(launches=launches, teps=res.run.harmonic_mean_teps, ms=ms)


def mesh_phase(built, roots, parents, device) -> dict:
    """Phase 16: the mesh layouts at scale 20 on phase 5's graph and keys:
    ``pre-g500-mesh`` through ``pipeline`` on the 1-card mesh, ``("root",)``
    on a virtual (4,) mesh, ``("group", "member")`` on a virtual (2, 2) mesh
    for both partitions and the five exchanges, the composed (2, 2, 2) mesh,
    ``frontier_update`` at the sharded path's shape against its plain version,
    and a profile of one (2, 2) traversal."""
    from repro_torch.core import pipeline
    from repro_torch.core.distributed_bfs import shard_edge_skew, shard_graph
    from repro_torch.core.hybrid_bfs import SHARD_EXCHANGES
    from repro_torch.core.plan import BFSPlan, PreparedGraph, compile_plan
    from repro_torch.kernels import bitmap_ops, ops, ref
    launches = {"frontier_update": 0, "core_spmv": 0}
    vertex_runs = []

    def add(n):
        for k in launches:
            launches[k] += n[k]

    cfg = pipeline.Graph500Config.ladder("pre-g500-mesh", scale=SCALE_MAIN,
                                         n_roots=N_ROOTS, check="full")
    sync(device)
    ops.reset_launch_counts()
    _, run = pipeline.run(cfg, built)
    sync(device)
    n = ops.launch_counts()
    add(n)
    check_valid("pre-g500-mesh", run)
    log(f"    pre-g500-mesh through pipeline (plan {cfg.to_plan().layout}, mesh of "
        f"the {torch.cuda.device_count()} visible card): hmean TEPS "
        f"{run.harmonic_mean_teps:.6e}, {run.mean_time_s * 1e3:.6f} ms per traversal, "
        f"launches {n}")
    add(mesh_run("pre-g500-mesh parents", compile_plan(cfg.to_plan(), built, device=device), roots,
                 parents, N_ROOTS)["launches"])
    add(mesh_run("('root',) on a virtual (4,) mesh",
                 compile_plan(BFSPlan(layout=("root",)), built, device=device,
                              mesh=virtual_mesh((4,), ("root",))),
                 roots, parents, N_ROOTS)["launches"])

    shards = {}
    for part in ("block", "word_cyclic"):
        t0 = time.perf_counter()
        sg = shard_graph(built.ev.src, built.ev.dst, built.ev.valid, built.n_vertices,
                         4, partition=part, device=device)
        sync(device)
        skew = shard_edge_skew(sg)
        shards[part] = sg
        log(f"    shard_graph {part} over 4 shards: {time.perf_counter() - t0:.6f} s, "
            f"W_loc {sg.w_loc}, chunk_size {sg.chunk_size}, edge arrays "
            f"{(sg.src.numel() * 9) / 2**30:.6f} GiB, shard_edge_skew "
            f"max_over_mean {skew['max_over_mean']:.6f} per_shard "
            f"{skew['per_shard_edges']}")
        prepared = PreparedGraph(ev=built.ev, degree=built.degree, core=built.core,
                                 sharded=sg)
        for ex in SHARD_EXCHANGES:
            c = compile_plan(BFSPlan(layout=VERTEX, partition=part, exchange=ex),
                             prepared, device=device, mesh=virtual_mesh((2, 2)))
            r = mesh_run(f"(2, 2) {part} {ex}", c, roots, parents,
                         N_ROOTS if ex == "hier_or" else MESH_KEYS)
            for k in ("frontier_update", "core_spmv"):
                if r["launches"][k] <= 0:
                    raise AssertionError(f"(2, 2) {part} {ex}: {k} was not launched")
            add(r["launches"])
            vertex_runs.append((part, ex, r))
    composed = compile_plan(
        BFSPlan(layout=("root",) + VERTEX), PreparedGraph(
            ev=built.ev, degree=built.degree, core=built.core, sharded=shards["block"]),
        device=device, mesh=virtual_mesh((2, 2, 2), ("root",) + VERTEX))
    r = mesh_run("composed (2, 2, 2)", composed, roots, parents, N_ROOTS)
    if r["launches"]["frontier_update"] <= 0 or r["launches"]["core_spmv"] <= 0:
        raise AssertionError(f"composed: launches {r['launches']}")
    add(r["launches"])

    # frontier_update at the sharded path's shape (the owned words)
    w_loc = shards["block"].w_loc
    gen = torch.Generator(device=device).manual_seed(16)
    found, visited = (rand_words(gen, (w_loc,), 0.05, device),
                      rand_words(gen, (w_loc,), 0.5, device))
    err = max(assert_equal(f"frontier_update W_loc={w_loc} {part}", got, want)
              for got, want, part in zip(bitmap_ops.frontier_update(found, visited),
                                         ref.frontier_update_ref(found, visited),
                                         ("next", "visited", "count")))
    fu_ms = time_ms(lambda: bitmap_ops.frontier_update(found, visited), 30, 20)
    log(f"    frontier_update at the sharded shape W_loc={w_loc}: bit-exact against "
        f"the plain version (max abs err {err}), {fu_ms:.6f} ms per call")

    c = compile_plan(BFSPlan(layout=VERTEX), PreparedGraph(
        ev=built.ev, degree=built.degree, core=built.core, sharded=shards["block"]),
        device=device, mesh=virtual_mesh((2, 2)))
    lv = int(c.bfs([int(roots[1])]).levels[0])
    log(f"    profile of one (2, 2) block hier_or traversal (root 1, {lv} levels)")
    prof = profile_complete(
        lambda: c.bfs([int(roots[1])]), ("frontier_update_kernel", "core_spmv_kernel"),
        lambda p: p["kernels"]["frontier_update_kernel"][1] < 4 * lv)
    if prof is not None:
        log(f"    (2, 2) traversal: idle share {prof['idle_share']:.6f}, device busy "
            f"{prof['busy_ms']:.6f} ms of {prof['wall_ms']:.6f} ms wall")
    return dict(launches=launches, runs=vertex_runs, shards=shards)


def mesh_faults_phase(built, roots, parents, sssp_rows, weighted, shards, device) -> dict:
    """Phase 17: sharded SSSP (``hier_min``, ``flat``) on a virtual (2, 2)
    mesh against phase 12's single-device rows; a persistent exchange fault
    detected, retried and answered by the single-device fallback; a codec
    and an inter-group fault detected."""
    from repro_torch.core.distributed_bfs import shard_graph
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.plan import BFSPlan, PreparedGraph, compile_plan
    from repro_torch.kernels import ops
    launches = {"frontier_update": 0, "core_spmv": 0}
    keys = sssp_rows["keys"]
    t0 = time.perf_counter()
    sgw = shard_graph(weighted.ev.src, weighted.ev.dst, weighted.ev.valid,
                      built.n_vertices, 4, partition="word_cyclic",
                      weight=weighted.ev.weight, device=device)
    log(f"    weighted shard_graph (word_cyclic, 4 shards): "
        f"{time.perf_counter() - t0:.6f} s")
    pw = PreparedGraph(ev=weighted.ev, degree=weighted.degree, sharded=sgw)
    v = built.n_vertices
    for ex in ("hier_min", "flat"):
        c = compile_plan(BFSPlan(layout=VERTEX, kernel="sssp", exchange=ex,
                                 partition="word_cyclic"), pw, device=device,
                         mesh=virtual_mesh((2, 2)))
        sync(device)
        t0 = time.perf_counter()
        res = c.run(keys, check="full")
        check_valid(f"sharded SSSP {ex}", res.run)
        raw = c.bfs(keys)
        for f in ("parent", "level"):
            if not torch.equal(getattr(raw, f)[:, :v].cpu(), sssp_rows[f]):
                raise AssertionError(f"sharded SSSP {ex}: {f} rows differ from phase 12's")
        log(f"    sharded SSSP {ex} on (2, 2) word_cyclic, {len(keys)} roots: parents "
            f"and distances equal phase 12's rows; hmean TEPS "
            f"{res.run.harmonic_mean_teps:.6e}, {res.run.mean_time_s * 1e3:.6f} ms per "
            f"root, rounds {raw.levels.tolist()} ({time.perf_counter() - t0:.6f} s)")

    fkeys = roots[:MESH_KEYS]
    for name, ex, part, fault, recover in (
            ("exchange", "hier_or", "block",
             FaultSpec("exchange", "zero", level=1, persistent=True), True),
            ("codec", "hier_or_packed", "block",
             FaultSpec("codec", "wrong_mode", level=1), False),
            # word_cyclic: group 1 owns words of every frontier
            ("inter_group", "hier_or", "word_cyclic",
             FaultSpec("inter_group", "drop", level=1), False)):
        prepared = PreparedGraph(ev=built.ev, degree=built.degree, core=built.core,
                                 sharded=shards[part])
        c = compile_plan(BFSPlan(layout=VERTEX, exchange=ex, partition=part), prepared,
                         device=device, mesh=virtual_mesh((2, 2)), fault=fault)
        sync(device)
        ops.reset_launch_counts()
        kw = dict(retries=1, fallback=True) if recover else {}
        res = c.run(fkeys, check="full", **kw)
        sync(device)
        for k, n in ops.launch_counts().items():
            if k in launches:
                launches[k] += n
        g = res.run
        log(f"    {fault.describe()} on (2, 2) {part} {ex}: check_counts {g.check_counts}, "
            f"failures {g.check_failures}, retries {g.retries}, fallbacks "
            f"{g.fallbacks}, quarantined {g.quarantined}")
        if not g.check_failures or not g.check_counts.get("sentinel"):
            raise AssertionError(f"{name} fault was not detected")
        if recover:
            n_bad = len(g.check_failures)
            if (g.retries, g.fallbacks, g.quarantined) != (n_bad, n_bad, []) \
                    or not np.array_equal(res.parent, parents[:MESH_KEYS]):
                raise AssertionError(f"{name}: not answered by the fallback")
            log(f"    the {n_bad} failing roots were retried and answered by the "
                f"single-device fallback: rows equal phase 5's parents")
    return dict(launches=launches)


def launcher_phase(device) -> dict:
    """Phase 18: the multi-process launcher on the card, 2 gloo processes x
    2 member shards at scale 18, against an in-process virtual (2, 2) run."""
    from repro_torch.core.plan import BFSPlan, compile_plan
    from repro_torch.core.tune import _build_inputs
    from repro_torch.launch import multiprocess as mp
    t0 = time.perf_counter()
    payload = mp.launch(2, 2, scale=MP_SCALE, n_roots=MP_ROOTS, device="cuda",
                        reps=3, timeout_s=600.0)
    launch_s = time.perf_counter() - t0
    rung = payload["rungs"]["mp_2x2"]
    pg, _, keys, _ = _build_inputs(MP_SCALE, 1, 16, MP_ROOTS, device)
    res = compile_plan(BFSPlan(layout=VERTEX), pg, device=device,
                       mesh=virtual_mesh((2, 2))).run(keys, check="post")
    local = mp.parent_digest(res.parent)
    if not (payload["parents_bitwise_identical"] and rung["identical"]
            and rung["parent_sha256"] == payload["oracle_sha256"] == local):
        raise AssertionError(f"launcher: digests {rung['parent_sha256'][:16]} "
                             f"(oracle {payload['oracle_sha256'][:16]}, in-process "
                             f"virtual (2, 2) {local[:16]})")
    n = rung["kernel_launches"]
    if n["frontier_update"] <= 0:
        raise AssertionError(f"launcher: rank 0 launched {n}")
    log(f"    2 procs x 2 shards at scale {MP_SCALE}, {MP_ROOTS} roots, gloo staged "
        f"through the host: {launch_s:.6f} s with spawn; parents sha256 "
        f"{local[:16]} = oracle = in-process virtual (2, 2); hmean TEPS "
        f"{rung['harmonic_mean_teps']:.6e}, {rung['per_root_us'] / 1e3:.6f} ms per "
        f"root; rank 0 launches {n}")
    exch, wire = rung["exchange_seconds"], rung["wire_bytes"]
    for e, w in zip(exch["per_level"], wire["per_level"]):
        log(f"      level {e['level']}: frontier {e['frontier']}, exchange "
            f"{e['seconds'] * 1e3:.6f} ms measured; modeled inter raw "
            f"{w['inter']['raw']} B, post_sieve {w['inter']['post_sieve']} B, "
            f"post_codec {w['inter']['post_codec']} B, intra {w['intra']['raw']} B")
    log(f"    exchange total {exch['total_seconds'] * 1e3:.6f} ms over {exch['levels']} "
        f"levels; modeled totals {wire['totals']}")
    return dict(launches={k: n[k] for k in ("frontier_update", "core_spmv")})


def virtual_sweep_phase(device) -> dict:
    """Phase 19: the tuner's sweep over a virtual mesh of 4 shards of the
    card (every candidate accepted bitwise, both kernels launched by every
    vertex-sharded candidate's timed runs), its table entry (``dev4``,
    ``"virtual": true``) written to a temporary file and read back."""
    import os
    import tempfile
    from repro_torch.core import tune
    from repro_torch.kernels import ops

    by_plan: dict = {}
    marks = [time.perf_counter()]
    spans: list = []          # (plan, s before its timed runs, s of them)

    def measure(compiled, roots, reps):
        before = ops.launch_counts()
        t_m = time.perf_counter()
        wall = tune._default_measure(compiled, roots, reps)
        spans.append((compiled.plan, t_m - marks[-1], time.perf_counter() - t_m))
        by_plan[tune._plan_sort_key(compiled.plan)] = (
            compiled.plan, {k: n - before[k] for k, n in ops.launch_counts().items()})
        return wall

    sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = tune.sweep(SCALE_MAIN, budget="small", devices=VSWEEP_DEVICES,
                     n_roots=VSWEEP_ROOTS, reps=VSWEEP_REPS, device=device.type,
                     measure=measure, log=lambda msg: marks.append(time.perf_counter()))
    sync(device)
    sweep_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    for line in rep.table().splitlines():
        log(f"    {line}")
    n_plans = len(tune.enumerate_plans(VSWEEP_DEVICES, tune.BUDGETS["small"]))
    if rep.skipped or len(rep.results) != n_plans or not rep.virtual:
        raise AssertionError(f"virtual sweep: {[(r.status, r.reason) for r in rep.skipped]}")
    if not all(r.identical for r in rep.results):
        raise AssertionError("virtual sweep: an accepted candidate is not bitwise identical")
    for plan, got in by_plan.values():
        if "member" in plan.layout and (got["frontier_update"] <= 0 or got["core_spmv"] <= 0):
            raise AssertionError(f"virtual sweep: {plan} launched {got}")
    vertexy = [(p, got) for p, got in by_plan.values() if "member" in p.layout]
    log(f"    build, oracle and first parity pass {spans[0][1]:.3f} s; per candidate, compile and "
        f"parity pass / timed runs (s): " + "; ".join(
            f"{'*'.join(p.layout) or 'single'} {'x'.join(map(str, p.mesh_shape or (1,)))} "
            f"{p.exchange} {p.partition}: {a:.3f} / {b:.3f}" for p, a, b in spans[1:]))
    log(f"    sweep of {n_plans} candidates over a virtual mesh of {VSWEEP_DEVICES} "
        f"shards in {sweep_s:.6f} s (graph build, oracle and parity passes included); "
        f"launches during the sweep {launches}; each of the {len(vertexy)} "
        f"vertex-sharded candidates launched both kernels in its timed runs "
        f"(frontier_update {min(g['frontier_update'] for _, g in vertexy)}-"
        f"{max(g['frontier_update'] for _, g in vertexy)}, core_spmv "
        f"{min(g['core_spmv'] for _, g in vertexy)}-"
        f"{max(g['core_spmv'] for _, g in vertexy)} over {VSWEEP_REPS} reps)")
    old_env = os.environ.get(tune.TABLE_ENV)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ[tune.TABLE_ENV] = tune.save_tuned(
                rep, os.path.join(tmp, "TUNED_PLANS_torch.json"))
            key = f"scale{SCALE_MAIN}/dev{VSWEEP_DEVICES}/{device.type}"
            entry = tune.load_table()["entries"][key]
            if entry.get("virtual") is not True or tune.tuned_plan(
                    SCALE_MAIN, VSWEEP_DEVICES, device.type) != rep.winner.plan:
                raise AssertionError(f"virtual sweep: table entry {key} is {entry}")
            log(f"    table entry {key} written through {tune.TABLE_ENV}: virtual "
                f"{entry['virtual']}, winner {entry['plan']['layout']} "
                f"{entry['plan']['mesh_shape']} {entry['plan']['exchange']} "
                f"{entry['plan']['partition']}, {entry['per_root_us']:.6f} us per root")
    finally:
        if old_env is None:
            os.environ.pop(tune.TABLE_ENV, None)
        else:
            os.environ[tune.TABLE_ENV] = old_env
    return dict(launches=launches, seconds=sweep_s)


def mesh_serving_phase(built, device) -> dict:
    """Phase 20: the serving engine on a virtual (2, 2) mesh of the card for
    both partitions (every answer equal to the offline run of the same
    compiled plan, both kernels launched by every batch), then a persistent
    ``exchange``/``zero`` fault answered by the single-device fallback."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.plan import BFSPlan, compile_plan
    from repro_torch.data.query_trace import synth_trace
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine, ServeConfig

    _, rate, zipf = SERVE_TRACES[1]
    trace = synth_trace(7, MESH_SERVE_QUERIES, built.n_vertices, rate_qps=rate,
                        zipf_s=zipf, degree=built.degree)
    roots = [int(r) for r in trace.roots]
    launches: dict = {}
    per_batch: list = []

    def counted(eng):
        solve = eng.solve_batch

        def solve_counted(padded, n_real, use_fallback):
            sync(device)
            before = ops.launch_counts()
            out = solve(padded, n_real, use_fallback)
            sync(device)
            per_batch.append((use_fallback, {k: n - before[k] for k, n in
                                             ops.launch_counts().items()}))
            return out

        eng.solve_batch = solve_counted
        return eng

    def serve(name, eng):
        per_batch.clear()
        sync(device)
        ops.reset_launch_counts()
        report = counted(eng).serve(trace)
        sync(device)
        for k, n in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        serve_summary(name, report)
        return report

    for part in ("block", "word_cyclic"):
        plan = BFSPlan(layout=VERTEX, mesh_shape=(2, 2), partition=part)
        eng = Engine(built, plan=plan, config=ServeConfig(**SERVE_CFG),
                     mesh=virtual_mesh((2, 2)), device=device)
        report = serve(f"(2, 2) {part}", eng)
        for fb, got in per_batch:
            if got["frontier_update"] <= 0 or got["core_spmv"] <= 0:
                raise AssertionError(f"(2, 2) {part}: a batch launched {got}")
        check_answers(f"(2, 2) {part}", report, offline_rows(eng.compiled, roots))
        svc = np.asarray([b.service_s for b in report.batches]) * 1e3
        log(f"    (2, 2) {part}: every answer equals the offline run of the same "
            f"compiled plan; {len(per_batch)} batches, each launching both kernels "
            f"({[g['frontier_update'] for _, g in per_batch]} frontier_update, "
            f"{[g['core_spmv'] for _, g in per_batch]} core_spmv); {svc.mean():.6f} "
            f"ms a batch")

    fault = FaultSpec("exchange", "zero", level=1, persistent=True)
    feng = Engine(built, plan=BFSPlan(layout=VERTEX, mesh_shape=(2, 2)),
                  config=ServeConfig(**SERVE_CFG), mesh=virtual_mesh((2, 2)),
                  fault=fault, device=device)
    report = serve("(2, 2) exchange fault", feng)
    clean = compile_plan(BFSPlan(layout=(), batch_roots=True), built, device=device)
    check_answers("(2, 2) exchange fault", report, offline_rows(clean, roots))
    kinds = report.summary()["kinds"]
    if "requeue" not in kinds or not any(b.used_fallback for b in report.batches) \
            or not any(b.failed_roots for b in report.batches):
        raise AssertionError(f"exchange fault: kinds {kinds}, no requeue or fallback")
    log(f"    {fault.describe()} on (2, 2): kinds {kinds}, check_counts "
        f"{report.summary()['check_counts']}; the re-queued roots were answered by the "
        f"single-device fallback, every answer equal to the clean batched plan's rows")
    return dict(launches=launches)


def collectives_phase(device) -> dict:
    """Phase 21: the T3 psum and all-to-all on a virtual (2, 4) mesh of the
    card, and a data-parallel xDeepFM step over its 8 shards."""
    from repro_torch.comms import hierarchical as hier
    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models import recsys
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import train_step as TS

    mesh = virtual_mesh((2, 4))
    x = torch.arange(8 * 4096, dtype=torch.float32, device=device).reshape(8, 4096)
    flat = hier.psum_spmd(mesh, hierarchical=False)(x)
    two = hier.psum_spmd(mesh)(x)
    if not (torch.equal(two, flat) and torch.equal(flat[0], x.sum(0))):
        raise AssertionError("hierarchical psum differs from the flat psum on "
                             "integer-valued fp32")
    gen = torch.Generator(device=device).manual_seed(3)
    xf = torch.randn((8, 4096), generator=gen, device=device)
    comp = hier.psum_spmd(mesh, compress=True)(xf)
    ref_f = hier.psum_spmd(mesh, hierarchical=False)(xf)
    err = float((comp - ref_f).abs().max())
    if not torch.allclose(comp, ref_f, rtol=1e-2, atol=5e-2):
        raise AssertionError(f"compressed psum: worst absolute error {err}")
    y = torch.arange(64 * 16 * 8, dtype=torch.float32, device=device).reshape(64 * 16, 8)
    a2a = hier.all_to_all_spmd(mesh)
    once = a2a(y)
    if not (torch.equal(once, hier.all_to_all_spmd(mesh, hierarchical=False)(y))
            and torch.equal(a2a(once), y)):
        raise AssertionError("hierarchical all-to-all differs from the flat one or is "
                             "not an involution")
    log(f"    (2, 4): psum_spmd hierarchical == flat bit for bit on [8, 4096] "
        f"integer-valued fp32; compressed (bf16 inter-group leg) within rtol 1e-2 / "
        f"atol 5e-2 of flat on N(0, 1) (worst absolute error {err:.6f}); all_to_all_spmd "
        f"[1024, 8] equal to the flat one and an involution")

    cfg = get("xdeepfm").make_smoke_config()
    params = recsys.init_params(cfg, seed=3, device=device)
    opt = AdamW(cosine(1e-3, 1, 10))
    batch = recsys_batch(0, 0, TRAIN_CHECK_ROWS, cfg.n_sparse, cfg.rows_per_field,
                         device=device)
    p1, _, l1 = TS.make_xdeepfm_train_step(cfg, opt)(params, opt.init(params), batch)
    p8, _, l8 = TS.make_xdeepfm_dp_train_step(cfg, opt, mesh)(params, opt.init(params),
                                                              batch)
    worst = max(float((p8[k] - p1[k]).abs().max()) for k in p1)
    if not (abs(float(l8) - float(l1)) <= 1e-5 * abs(float(l1)) and all(
            torch.allclose(p8[k], p1[k], rtol=1e-5, atol=1e-7) for k in p1)):
        raise AssertionError(f"data-parallel step: loss {float(l8)} vs {float(l1)}, "
                             f"worst parameter difference {worst}")
    log(f"    data-parallel xDeepFM step (smoke config, {TRAIN_CHECK_ROWS} rows over 8 "
        f"shards, hierarchical_psum of the gradients): loss {float(l8):.9f} vs the "
        f"single-shard step's {float(l1):.9f}, parameters within {worst:.3e} (rtol "
        f"1e-5, atol 1e-7)")
    return {}


def training_phase(device) -> dict:
    """Phase 22: xDeepFM training at full width: one step on the card
    against the CPU, ``launch.train`` for 20 steps at B = 8,192, the step's
    split and idle share, the resume at the smoke config, and the graph500
    branch of the launcher."""
    import tempfile
    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import recsys
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import train_step as TS
    from repro_torch.train.loop import LoopConfig, run_loop

    full = get("xdeepfm").make_config()
    opt = AdamW(cosine(1e-3, 5, TRAIN_STEPS))
    step = TS.make_xdeepfm_train_step(full, opt)

    # (a) one batch's gradients on the card and on the CPU from the same
    # parameters, then the AdamW step from each
    t0 = time.perf_counter()
    p_cpu = recsys.init_params(full, seed=0, device="cpu")
    b_cpu = recsys_batch(0, 0, TRAIN_CHECK_ROWS, full.n_sparse, full.rows_per_field,
                         device="cpu")
    lc, gc = TS.xdeepfm_value_and_grad(p_cpu, b_cpu, full)
    pc, _ = opt.update(gc, opt.init(p_cpu), p_cpu)
    cpu_s = time.perf_counter() - t0
    p_gpu = {k: v.to(device) for k, v in p_cpu.items()}
    del p_cpu
    lg, gg = TS.xdeepfm_value_and_grad(
        p_gpu, {k: v.to(device) for k, v in b_cpu.items()}, full)
    pg, _ = opt.update(gg, opt.init(p_gpu), p_gpu)
    del p_gpu
    grad_rel, grad_bad = {}, []
    for k in gc:
        want, got = gc[k], gg[k].cpu()
        top = float(want.abs().max())
        diff = (got - want).abs()
        grad_rel[k] = float(diff.max()) / top if top else float(diff.max())
        if bool((diff > GRAD_RTOL * want.abs() + GRAD_RTOL * top).any()):
            grad_bad.append(k)
    del gc, gg
    worst = {k: float((pg[k] - pc[k].to(device)).abs().max()) for k in pc}
    del pc, pg
    if abs(float(lg) - float(lc)) > 1e-5 * abs(float(lc)) or grad_bad \
            or max(worst.values()) > 1e-6:
        raise AssertionError(f"full-width step: loss {float(lg)} (card) vs {float(lc)} "
                             f"(CPU); gradients out of tolerance {grad_bad} (max "
                             f"|diff| / max |CPU gradient| per leaf {grad_rel}); "
                             f"parameter differences {worst}")
    log(f"    one batch at full width, B = {TRAIN_CHECK_ROWS}: loss {float(lg):.9f} "
        f"(card) vs {float(lc):.9f} (CPU); gradients within rtol {GRAD_RTOL} + "
        f"{GRAD_RTOL} x the leaf's largest |gradient|, max |diff| / max |gradient| "
        + ", ".join(f"{k} {v:.3e}" for k, v in grad_rel.items())
        + f"; after one AdamW step the parameters within {max(worst.values()):.3e} "
        f"(atol 1e-6; table {worst['table']:.3e}); the CPU half (init included) "
        f"took {cpu_s:.3f} s")

    # (b) the launcher's recsys path: 20 steps at B = 8,192
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    lines: list = []
    t0 = time.perf_counter()
    out = launch_train.main(["--arch", "xdeepfm", "--full", "--steps", str(TRAIN_STEPS),
                             "--batch", str(TRAIN_BATCH)], log=lines.append)
    sync(device)
    launch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    losses = out["losses"]
    for line in lines[1:]:
        log(f"    {line}")
    if not (abs(losses[0] - 0.69) < 0.05 and losses[-1] < losses[0]):
        raise AssertionError(f"launch.train: the loss did not fall from ~0.69: {losses}")
    log(f"    launch.train --arch xdeepfm --full --steps {TRAIN_STEPS} --batch "
        f"{TRAIN_BATCH}: {launch_s:.6f} s in all (parameter init and the first "
        f"step's warm-up included), loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
        f"max_memory_allocated {peak / 2**30:.6f} GiB")

    # (c) the step at B = 8,192, timed by part, and one profiled step
    rows = 8 * TRAIN_BATCH
    params = recsys.init_params(full, seed=0, device=device)
    state = opt.init(params)
    batches = [recsys_batch(0, i, rows, full.n_sparse, full.rows_per_field, device=device)
               for i in range(TRAIN_TIMED_STEPS + 1)]
    params, state, _ = step(params, state, batches[-1])
    # the embedding backward sums each row's gradients in a fixed order: two
    # calls on the same parameters and batch give the same bits
    l1, g1 = TS.xdeepfm_value_and_grad(params, batches[0], full)
    l2, g2 = TS.xdeepfm_value_and_grad(params, batches[0], full)
    differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    if differ or not torch.equal(l1, l2):
        raise AssertionError(f"full-width gradients at B = {rows} differ between two "
                             f"calls: {differ}, loss {float(l1)} vs {float(l2)}")
    del g1, g2
    log(f"    full-width loss and gradients at B = {rows}: two calls on the same "
        f"parameters and batch equal bit for bit ({len(params)} leaves)")
    fb_ms, up_ms = [], []
    for b in batches[:-1]:
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        loss, grads = TS.xdeepfm_value_and_grad(params, b, full)
        e[1].record()
        params, state = opt.update(grads, state, params)
        e[2].record()
        e[2].synchronize()
        del grads
        fb_ms.append(e[0].elapsed_time(e[1]))
        up_ms.append(e[1].elapsed_time(e[2]))
    fb, up = statistics.median(fb_ms), statistics.median(up_ms)
    log(f"    step at B = {rows} (CUDA events, median of {TRAIN_TIMED_STEPS}): "
        f"forward+backward {fb:.6f} ms, AdamW update {up:.6f} ms, step "
        f"{fb + up:.6f} ms, {rows / (fb + up) * 1e3:.6f} samples/s")
    holder = [params, state]

    def one_step():
        holder[0], holder[1], _ = step(holder[0], holder[1], batches[0])

    log(f"    profile of one training step at B = {rows}")
    prof = profile_window(one_step, ())
    del holder, params, state, batches

    # (d) resume at the smoke config: 6 steps straight against 3 + resume 3
    smoke = get("xdeepfm").make_smoke_config()
    sopt = AdamW(cosine(1e-3, 2, 6))
    sstep = TS.make_xdeepfm_train_step(smoke, sopt)
    data = [recsys_batch(0, i, 8 * 4, smoke.n_sparse, smoke.rows_per_field, device=device)
            for i in range(6)]
    p0 = recsys.init_params(smoke, seed=0, device=device)
    quiet = lambda msg: None  # noqa: E731
    straight, s_st, _ = run_loop(LoopConfig(total_steps=6, log_every=1), p0,
                                 sopt.init(p0), sstep, data.__getitem__, log=quiet)
    with tempfile.TemporaryDirectory() as tmp:
        lc3 = LoopConfig(total_steps=3, ckpt_dir=tmp, ckpt_every=3, log_every=1)
        run_loop(lc3, p0, sopt.init(p0), sstep, data.__getitem__, log=quiet)
        msgs: list = []
        resumed, s_re, _ = run_loop(dataclasses.replace(lc3, total_steps=6), p0,
                                    sopt.init(p0), sstep, data.__getitem__,
                                    log=msgs.append)
    diff = max(float((resumed[k] - straight[k]).abs().max()) for k in straight)
    same = all(torch.equal(resumed[k], straight[k]) and torch.equal(s_re.v[k], s_st.v[k])
               for k in straight)
    if not any("resumed from step 3" in m for m in msgs) or not same:
        raise AssertionError(f"resume: parameters differ from the uninterrupted run "
                             f"by {diff} ({msgs})")
    log("    resume at the smoke config on the card: 3 steps, checkpoint, restore, 3 "
        "more: parameters and AdamW state equal to the uninterrupted 6 steps bit for bit")

    # (e) the launcher's graph500 branch
    g_lines: list = []
    g = launch_train.main(["--arch", "graph500", "--scale", str(TRAIN_GRAPH500_SCALE)],
                          log=g_lines.append)
    if not g["valid"] or g["harmonic_mean_teps"] <= 0:
        raise AssertionError(f"launch.train --arch graph500: {g}")
    log(f"    launch.train --arch graph500 --scale {TRAIN_GRAPH500_SCALE}: "
        f"{g_lines[-1].split('] ', 1)[1]} (hmean TEPS {g['harmonic_mean_teps']:.6e})")
    return dict(fb_ms=fb, update_ms=up, peak_gib=peak / 2**30,
                idle=None if prof is None else prof["idle_share"])


def kernel_launches_during(fn) -> dict:
    """The hand-written kernels' launch counts while ``fn`` runs (the LM
    path launches none of them: its products are torch matmuls and einsums,
    as the JAX package's are plain ``jnp``)."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    fn()
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def weight_bytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())


def lm_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (float32, on ``want``'s device)."""
    want = want.float()
    return float((got.float().to(want.device) - want).abs().max() / want.abs().max())


def smoke_forward_card_vs_cpu(device) -> dict:
    """Each smoke arch's forward on the card against the CPU from the same
    parameters and batch (logits within LM_TOL x max |logit|, aux within
    1e-3), with cuBLAS's reduced-precision bf16 reduction on (torch's
    default) and off."""
    from repro_torch.configs import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    lm = ("granite-moe-1b-a400m", "minicpm-2b", "moonshot-v1-16b-a3b", "olmo-1b",
          "starcoder2-15b")
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    errs = {}
    for arch in lm:
        cfg = get(arch).make_smoke_config()
        params = T.init_params(cfg, seed=0, device="cpu")
        toks = lm_batch(0, 0, 2, 64, cfg.vocab, device="cpu")["tokens"]
        with torch.no_grad():
            want, want_aux = T.forward(params, toks, cfg)
            on_card = {k: v.to(device) for k, v in params.items()}
            row = {}
            for reduced in (True, False):
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
                got, aux = T.forward(on_card, toks.to(device), cfg)
                row[reduced] = (lm_rel_err(got, want), abs(float(aux) - float(want_aux)))
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        errs[arch] = row
        log(f"    {arch} smoke forward, card vs CPU: max |diff| / max |logit| "
            f"{row[True][0]:.3e} (bf16 reduced-precision reduction on), "
            f"{row[False][0]:.3e} (off); aux |diff| {row[True][1]:.3e} / {row[False][1]:.3e}")
        if row[flag][0] > LM_TOL or row[flag][1] > 1e-3:
            raise AssertionError(f"{arch}: the card's smoke forward is off the CPU's: {row}")
    return errs


def full_width_card_vs_cpu(device) -> dict:
    """olmo-1b at full width on the card against the CPU from the same
    parameters (made on the card, copied): the forward over B x S tokens
    and S teacher-forced decode steps, with cuBLAS's reduced-precision bf16
    reduction on and off (the decode's B-row products take split-K
    kernels, whose partial sums the flag lets cuBLAS reduce in bf16)."""
    from repro_torch.configs import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    cfg = get("olmo-1b").make_config()
    b, s = FULL_CHECK_SHAPE
    card = T.init_params(cfg, seed=1, device=device)
    cpu = {k: v.cpu() for k, v in card.items()}
    toks = lm_batch(0, 3, b, s, cfg.vocab, device="cpu")["tokens"]

    def run(params, dev):
        with torch.no_grad():
            fwd, _ = T.forward(params, toks.to(dev), cfg)
            cache = T.init_cache(cfg, b, s, device=dev)
            dec = torch.stack([T.decode_step(params, cache, toks[:, t:t + 1].to(dev), t,
                                             cfg)[0] for t in range(s)], 1)
        return fwd.cpu(), dec.cpu()

    t0 = time.perf_counter()
    want_f, want_d = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    row = {}
    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        got_f, got_d = run(card, device)
        row[reduced] = (lm_rel_err(got_f, want_f), lm_rel_err(got_d, want_d))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    log(f"    olmo-1b at full width, B={b} S={s}, card vs CPU (the CPU half {cpu_s:.3f} s): "
        f"forward max |diff| / max |logit| {row[True][0]:.3e} (bf16 reduced-precision "
        f"reduction on) / {row[False][0]:.3e} (off); decode {row[True][1]:.3e} / "
        f"{row[False][1]:.3e}")
    if max(row[flag]) > LM_TOL:
        raise AssertionError(f"olmo-1b at full width: card vs CPU {row}")
    del card, cpu
    return row


def lm_serving_phase(device) -> dict:
    """Phase 23: LM serving at full width (prefill, KV-cache greedy decode,
    decode against prefill) for olmo-1b and granite-moe-1b-a400m, with
    random parameters from ``init_params`` on the card; then each smoke
    arch's forward on the card against the CPU."""
    import dataclasses as dc
    from repro_torch.configs import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    out = {}
    for arch in LM_SERVE_ARCHS:
        cfg = get(arch).make_config()
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        params = T.init_params(cfg, seed=0, device=device)
        sync(device)
        n_par, w_bytes = sum(t.numel() for t in params.values()), weight_bytes(params)
        log(f"    {arch}: {n_par} parameters ({w_bytes / 1e9:.6f} GB; param_count "
            f"{cfg.param_count()}, active {cfg.active_param_count()}), init "
            f"{time.perf_counter() - t0:.3f} s")

        # (a) prefill at B x S with exact query chunks
        prefill = TS.make_lm_prefill(cfg, T.ShardingPolicy(q_chunk=PREFILL_Q_CHUNK))
        toks = lm_batch(0, 0, PREFILL_BATCH, PREFILL_SEQ, cfg.vocab, device=device)["tokens"]
        last = prefill(params, toks)
        if last.shape != (PREFILL_BATCH, cfg.vocab) or not bool(torch.isfinite(last).all()):
            raise AssertionError(f"{arch} prefill: {last.shape}, finite "
                                 f"{bool(torch.isfinite(last).all())}")
        pf_ms = time_ms(lambda: prefill(params, toks), PREFILL_REPS, 1)
        n_tok = PREFILL_BATCH * PREFILL_SEQ
        log(f"    prefill B={PREFILL_BATCH} S={PREFILL_SEQ} q_chunk={PREFILL_Q_CHUNK}: "
            f"{pf_ms:.6f} ms (CUDA events, median of {PREFILL_REPS}), "
            f"{n_tok / pf_ms * 1e3:.6f} tokens/s; max_memory_allocated after init "
            f"and prefill {torch.cuda.max_memory_allocated(device) / 2**30:.6f} GiB")
        del toks, last

        # (b) greedy decode over an S_max cache: a teacher-forced prompt,
        # then generated tokens, each step timed
        step = TS.make_lm_serve_step(cfg)
        cache = T.init_cache(cfg, DECODE_BATCH, DECODE_S_MAX, device=device)
        kv_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        prompt = lm_batch(0, 1, DECODE_BATCH, DECODE_PROMPT, cfg.vocab,
                          device=device)["tokens"]
        tok, times, generated = prompt[:, :1], [], []
        for pos in range(DECODE_PROMPT + DECODE_NEW - 1):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            nxt, cache = step(params, cache, tok, pos)
            e1.record()
            times.append((e0, e1))
            tok = prompt[:, pos + 1:pos + 2] if pos + 1 < DECODE_PROMPT else nxt
            if pos + 1 >= DECODE_PROMPT:
                generated.append(nxt)
        sync(device)
        gen = torch.cat(generated, 1)
        if gen.shape != (DECODE_BATCH, DECODE_NEW) or int(gen.min()) < 0 or \
                int(gen.max()) >= cfg.vocab:
            raise AssertionError(f"{arch} decode: generated {gen.shape}, ids "
                                 f"[{int(gen.min())}, {int(gen.max())}]")
        step_ms = [a.elapsed_time(b) for a, b in times[DECODE_PROMPT:]]
        dec_ms = statistics.median(step_ms)
        w_bound = w_bytes / HBM_BYTES_PER_S * 1e3
        wkv_bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
        log(f"    decode B={DECODE_BATCH} S_max={DECODE_S_MAX} ({DECODE_PROMPT} prompt + "
            f"{DECODE_NEW} generated tokens): {dec_ms:.6f} ms a token (CUDA events, "
            f"median; min {min(step_ms):.6f}, max {max(step_ms):.6f}), "
            f"{DECODE_BATCH / dec_ms * 1e3:.6f} tokens/s; weight-read bound "
            f"{w_bound:.6f} ms ({w_bytes / 1e9:.6f} GB / 3.35 TB/s), with the "
            f"{kv_bytes / 1e9:.6f} GB KV cache {wkv_bound:.6f} ms; first generated "
            f"row {gen[0, :8].tolist()}")
        log(f"    profile of one decode step (pos {DECODE_PROMPT + DECODE_NEW - 1})")
        prof = profile_window(
            lambda: step(params, cache, tok, DECODE_PROMPT + DECODE_NEW - 1), ())
        launched = kernel_launches_during(
            lambda: step(params, cache, tok, DECODE_PROMPT + DECODE_NEW - 1))
        del cache

        # (c) teacher-forced decode against the full forward on the same
        # tokens (MoE: capacity high enough for no drops in either form)
        chk = dc.replace(cfg, capacity_factor=DECODE_CHECK_CAPACITY) if cfg.is_moe else cfg
        toks = lm_batch(0, 2, DECODE_BATCH, DECODE_CHECK_POS, cfg.vocab,
                        device=device)["tokens"]
        with torch.no_grad():
            full, _ = T.forward(params, toks, chk)
            cache = T.init_cache(chk, DECODE_BATCH, DECODE_S_MAX, device=device)
            dec = torch.stack([T.decode_step(params, cache, toks[:, t:t + 1], t, chk)[0]
                               for t in range(DECODE_CHECK_POS)], 1)
        err = lm_rel_err(dec, full)
        del cache, full, dec
        if err > LM_TOL:
            raise AssertionError(f"{arch}: teacher-forced decode is {err:.3e} x max "
                                 f"|logit| off the forward (tolerance {LM_TOL})")
        peak = torch.cuda.max_memory_allocated(device)
        log(f"    teacher-forced decode against the forward, first {DECODE_CHECK_POS} "
            f"positions{' (capacity factor 16)' if cfg.is_moe else ''}: max |diff| / "
            f"max |logit| {err:.3e} (tolerance {LM_TOL}); hand-written kernels launched "
            f"by a decode step {launched}; max_memory_allocated {peak / 2**30:.6f} GiB")
        out[arch] = dict(prefill_ms=pf_ms, prefill_tok_s=n_tok / pf_ms * 1e3,
                         decode_ms=dec_ms, bound_ms=w_bound, peak_gib=peak / 2**30,
                         idle=None if prof is None else prof["idle_share"], err=err)
        del params
    torch.cuda.empty_cache()
    out["smoke"] = smoke_forward_card_vs_cpu(device)
    out["full"] = full_width_card_vs_cpu(device)
    return out


def lm_training_phase(device) -> dict:
    """Phase 24: olmo-1b training at full width (remat, AdamW(cosine(3e-4,
    5, 20))): the loss over 20 steps, forward+backward and AdamW ms, a
    profile of one step; the sharded MoE dispatches on the card against the
    dense one; the launcher's LM branch."""
    from repro_torch.comms.mesh import VertexComm, make_mesh
    from repro_torch.configs import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import train_step as TS

    # (a) training at full width
    cfg = get(LM_TRAIN_ARCH).make_config()
    policy = T.ShardingPolicy(remat=True)
    opt = AdamW(cosine(3e-4, 5, LM_TRAIN_STEPS))
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    params = T.init_params(cfg, seed=0, device=device)
    state = opt.init(params)
    losses, fb_ms, up_ms = [], [], []
    t0 = time.perf_counter()
    for i in range(LM_TRAIN_STEPS):
        batch = lm_batch(0, i, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab, device=device)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        loss, grads = TS.lm_value_and_grad(params, batch, cfg, policy)
        e[1].record()
        params, state = opt.update(grads, state, params)
        e[2].record()
        del grads
        losses.append(loss)
        fb_ms.append(e)
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(v) for v in losses]
    fb = statistics.median(e[0].elapsed_time(e[1]) for e in fb_ms[1:])
    up = statistics.median(e[1].elapsed_time(e[2]) for e in fb_ms[1:])
    n_tok = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    log(f"    {LM_TRAIN_ARCH} B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ}, remat, {LM_TRAIN_STEPS} "
        f"steps in {wall:.3f} s (the first step's warm-up included): forward+backward "
        f"{fb:.6f} ms, AdamW {up:.6f} ms (CUDA events, median of steps 1-"
        f"{LM_TRAIN_STEPS - 1}), {n_tok / (fb + up) * 1e3:.6f} tokens/s, "
        f"max_memory_allocated {peak / 2**30:.6f} GiB")
    log("    loss " + " ".join(f"{v:.4f}" for v in losses))
    if not (abs(losses[0] - math.log(cfg.vocab)) < 1.0 and losses[-1] < losses[0] - 1.0
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{LM_TRAIN_ARCH}: the loss did not fall from "
                             f"~ln({cfg.vocab}) = {math.log(cfg.vocab):.3f}: {losses}")
    holder = [params, state]
    batch = lm_batch(0, 0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab, device=device)
    step = TS.make_lm_train_step(cfg, opt, policy)

    def one_step():
        holder[0], holder[1], _ = step(holder[0], holder[1], batch)

    log(f"    profile of one training step at B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ}")
    prof = profile_window(one_step, ())
    launched = kernel_launches_during(one_step)
    log(f"    hand-written kernels launched by a training step: {launched}")
    del holder, params, state, batch
    torch.cuda.empty_cache()

    # (b) the sharded MoE dispatches at granite-moe-1b-a400m's layer widths
    g = get("granite-moe-1b-a400m").make_config()
    dims = M.MoEDims(g.d_model, g.d_ff, g.n_experts, g.top_k, MOE_CHECK_CAPACITY, g.mlp)
    gen = torch.Generator(device=device).manual_seed(5)
    moe_p = M.init_moe(gen, dims, device=device)
    x = torch.randn(MOE_CHECK_TOKENS + (g.d_model,), generator=gen, device=device) \
        .to(torch.bfloat16)
    with torch.no_grad():
        dense, dense_aux = M.moe_ffn(moe_p, x, dims)
        comm = VertexComm(make_mesh((2, 2), ("group", "member"), device=device,
                                    virtual=True))
        t0 = time.perf_counter()
        outs, auxes = M.moe_ffn_monitor(moe_p, list(x.chunk(comm.n)), dims, comm=comm)
        sync(device)
        mon_s = time.perf_counter() - t0
        mon = torch.cat(outs)
        tp = torch.cat([M.moe_ffn_local_tp(moe_p, xx, dims, model_shards=2)[0]
                        for xx in x.chunk(2)])
        again = torch.cat(M.moe_ffn_monitor(moe_p, list(x.chunk(comm.n)), dims,
                                            comm=comm)[0])
    mon_err = float((mon.float() - dense.float()).abs().max())
    tp_err = float((tp.float() - dense.float()).abs().max())
    top = float(dense.float().abs().max())
    log(f"    MoE dispatch at granite widths (d {g.d_model}, f {g.d_ff}, {g.n_experts} "
        f"experts top-{g.top_k}, {MOE_CHECK_TOKENS[0] * MOE_CHECK_TOKENS[1]} tokens, "
        f"capacity factor {MOE_CHECK_CAPACITY}): monitor_a2a on a virtual (2, 2) mesh "
        f"max |diff| {mon_err:.3e}, local_tp on (2, 2) {tp_err:.3e} against dense "
        f"moe_ffn (max |out| {top:.3e}; tolerance {LM_MOE_TOL} + {LM_MOE_TOL} x |dense|); "
        f"monitor {mon_s * 1e3:.3f} ms (host clock); two monitor calls equal bit for bit "
        f"{torch.equal(mon, again)}")
    for name, got in (("monitor_a2a", mon), ("local_tp", tp)):
        bad = (got.float() - dense.float()).abs() > LM_MOE_TOL * (1 + dense.float().abs())
        if bool(bad.any()):
            raise AssertionError(f"{name} dispatch: {int(bad.sum())} elements off dense")
    if not torch.equal(mon, again):
        raise AssertionError("monitor_a2a: two calls on the same inputs differ")
    del moe_p, x, dense, mon, tp, again

    # (c) the launcher's LM branch at the smoke config
    lines: list = []
    res = launch_train.main(["--arch", LM_TRAIN_ARCH, "--steps", "8"], log=lines.append)
    ls = res["losses"]
    if not (len(ls) == 8 and ls[-1] < ls[0]):
        raise AssertionError(f"launch.train --arch {LM_TRAIN_ARCH}: {ls}")
    log(f"    launch.train --arch {LM_TRAIN_ARCH} --steps 8 (smoke config): loss "
        f"{ls[0]:.4f} -> {ls[-1]:.4f}")
    return dict(fb_ms=fb, update_ms=up, tok_s=n_tok / (fb + up) * 1e3, peak_gib=peak / 2**30,
                losses=losses, idle=None if prof is None else prof["idle_share"])


# ---------------------------------------------------------------------------
# Phases 25-26: the GNN stack
# ---------------------------------------------------------------------------

class EventOpt:
    """An optimizer that records a CUDA event before and after each update,
    so a train step's forward+backward and its update are timed apart."""

    def __init__(self, opt):
        self.opt, self.marks = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out = self.opt.update(grads, state, params)
        e[1].record()
        self.marks.append(e)
        return out


class CaptureGrads:
    """An optimizer whose update hands back the gradients as the state."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return params, grads


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, on the CPU."""
    want = want.detach().float().cpu()
    return float((got.detach().float().cpu() - want).abs().max() /
                 want.abs().max().clamp(min=1e-30))


def gnn_smoke_inputs(arch: str, cfg, device):
    """The port's smoke graph and inputs for ``arch`` on ``device``, made on
    the CPU (so the card and the CPU see the same values): ``(forward,
    make_step, args)`` with ``forward(params, *args)`` and
    ``make_step(opt)`` the arch's train step."""
    from repro_torch.data.graphs import make_feature_graph, make_molecule_batch
    from repro_torch.models import gnn
    from repro_torch.train import train_step as TS
    if arch in ("gat-cora", "graphsage-reddit"):
        g, labels = make_feature_graph(0, 7, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                                       edge_factor=4, device="cpu")
        args = (g.to(device), labels.to(device))
        kind = "gat" if arch == "gat-cora" else "sage"
        fwd = gnn.gat_forward if kind == "gat" else gnn.sage_forward
        return (lambda p, g, y: fwd(p, g, cfg),
                lambda opt: TS.make_gnn_train_step(kind, cfg, opt), args)
    g, species, tri = make_molecule_batch(0, 4, 8, 16, device="cpu")
    if arch == "dimenet":
        tgt = torch.linspace(-1.0, 1.0, 4)
        args = (g.to(device), species.to(device), {k: v.to(device) for k, v in tri.items()},
                tgt.to(device))
        return (lambda p, g, s, t, y: gnn.dimenet_energy(p, g, s, t, cfg, 4),
                lambda opt: TS.make_dimenet_train_step(cfg, opt, 4), args)
    tgt = torch.linspace(-1.0, 1.0, g.n_nodes)
    args = (g.to(device), species.to(device), tgt.to(device))
    return (lambda p, g, s, y: gnn.equiformer_forward(p, g, s, cfg),
            lambda opt: TS.make_equiformer_train_step(cfg, opt), args)


def gnn_smoke_card_vs_cpu(device) -> dict:
    """Each GNN arch's smoke forward and one train step's loss and gradients
    on the card against the CPU's, from the same parameters and inputs
    (forwards within GNN_TOL x max |out|, the loss within 1e-4, each
    gradient leaf within GNN_TOL x its largest |gradient|), and the SAGE
    step on sampled blocks."""
    from repro_torch.configs import get
    from repro_torch.data.graphs import csr_of, make_feature_graph
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.models import gnn
    from repro_torch.train import train_step as TS
    errs = {}
    for arch in GNN_ARCHS:
        cfg = get(arch).make_smoke_config()
        params = gnn.INITS[arch](cfg, seed=0, device="cpu")
        card = {k: v.to(device) for k, v in params.items()}
        fwd, make_step, args_c = gnn_smoke_inputs(arch, cfg, "cpu")
        _, _, args_g = gnn_smoke_inputs(arch, cfg, device)
        with torch.no_grad():
            f_err = scaled_err(fwd(card, *args_g), fwd(params, *args_c))
        _, gc, lc = make_step(CaptureGrads())(params, None, *args_c)
        _, gg, lg = make_step(CaptureGrads())(card, None, *args_g)
        g_err = max(scaled_err(gg[k], gc[k]) for k in gc)
        l_err = abs(float(lg) - float(lc))
        errs[arch] = (f_err, l_err, g_err)
        log(f"    {arch} smoke, card vs CPU: forward max |diff| / max |out| {f_err:.3e}; "
            f"one step: loss |diff| {l_err:.3e}, gradients max |diff| / leaf max {g_err:.3e}")
        if f_err > GNN_TOL or l_err > 1e-4 or g_err > GNN_TOL:
            raise AssertionError(f"{arch}: the card's smoke forward or step is off the "
                                 f"CPU's: {errs[arch]}")
    # GraphSAGE on sampled blocks (the smoke fanouts)
    cfg = get("graphsage-reddit").make_smoke_config()
    g, labels = make_feature_graph(0, 7, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                                   edge_factor=4, device="cpu")
    ro, ci = csr_of(g)
    batch = NeighborSampler(ro, ci, cfg.sample_sizes, seed=0, device="cpu").sample(
        np.arange(16))
    params = gnn.sage_init(cfg, seed=0, device="cpu")
    card = {k: v.to(device) for k, v in params.items()}
    feats = g.node_feat[torch.from_numpy(batch.node_ids)]
    y = labels[torch.from_numpy(batch.seeds)]
    blocks_g = [{k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                 for k, v in b.items()} for b in batch.blocks]
    step = TS.make_sage_block_train_step(cfg, CaptureGrads())
    _, gc, lc = step(params, None, feats, batch.blocks, y)
    _, gg, lg = step(card, None, feats.to(device), blocks_g, y.to(device))
    g_err = max(scaled_err(gg[k], gc[k]) for k in gc)
    log(f"    graphsage-reddit smoke on sampled blocks (16 seeds, fanout "
        f"{cfg.sample_sizes}), card vs CPU: loss |diff| {abs(float(lg) - float(lc)):.3e}, "
        f"gradients {g_err:.3e}")
    if abs(float(lg) - float(lc)) > 1e-4 or g_err > GNN_TOL:
        raise AssertionError("graphsage-reddit blocks: the card's step is off the CPU's")
    return errs


def gnn_train_path(name: str, make_step, params: dict, args_for, steps: int,
                   device, units: dict, lr: float = 3e-3) -> dict:
    """Train ``steps`` AdamW(cosine(lr, 2, steps)) steps of one GNN path
    on the card (``args_for(i)``: step i's inputs, made before its clock
    starts): forward+backward and AdamW ms (CUDA events, median of steps
    1..), ``units`` per second, the peak memory, the loss first -> last
    (finite and falling), two steps from one state equal bit for bit or
    not, the hand-written kernels' launches over a step and a profile of
    one step."""
    from repro_torch.optim import AdamW, cosine
    opt = EventOpt(AdamW(cosine(lr, 2, steps)))
    step = make_step(opt)
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    state = opt.init(params)
    starts, losses = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        args = args_for(i)
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, loss = step(params, state, *args)
        starts.append(e0)
        losses.append(loss)
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    marks = opt.marks[:steps]
    fb = statistics.median(s.elapsed_time(m[0]) for s, m in zip(starts[1:], marks[1:]))
    up = statistics.median(m[0].elapsed_time(m[1]) for m in marks[1:])
    losses = [float(v) for v in losses]
    rates = ", ".join(f"{n / (fb + up) * 1e3:.6f} {u}/s" for u, n in units.items())
    log(f"    {name}: {steps} steps in {wall:.3f} s (the first's warm-up included): "
        f"forward+backward {fb:.6f} ms, AdamW {up:.6f} ms (CUDA events, median of steps "
        f"1-{steps - 1}), {rates}, max_memory_allocated {peak / 2**30:.6f} GiB")
    log(f"    {name} loss " + " ".join(f"{v:.4f}" for v in losses))
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the loss is not finite and falling: {losses}")
    args = args_for(0)
    a = step(params, state, *args)
    b = step(params, state, *args)
    bitwise = torch.equal(a[2], b[2]) and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    log(f"    {name}: two steps from one state equal bit for bit: {bitwise} "
        f"(loss {float(a[2])!r} / {float(b[2])!r})")
    del a, b
    launched = kernel_launches_during(lambda: step(params, state, *args))
    log(f"    {name}: hand-written kernels launched by a step: {launched}")
    if any(launched.values()):
        raise AssertionError(f"{name}: the GNN path launched a Graph500/CIN kernel")
    log(f"    profile of one {name} step")
    prof = profile_window(lambda: step(params, state, *args), ())
    return dict(fb_ms=fb, update_ms=up, peak_gib=peak / 2**30, losses=losses,
                bitwise=bitwise, idle=None if prof is None else prof["idle_share"])


def gnn_training_phase(device) -> dict:
    """Phase 25: the four GNN archs at full width on the card (smoke checks
    against the CPU first), each trained for a few AdamW steps on graphs
    made on the card by the port's generators."""
    from repro_torch.configs import get
    from repro_torch.configs.gnn_archs import arch_with_dims
    from repro_torch.data.graphs import csr_of, make_feature_graph, make_molecule_batch
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.launch import train as launch_train
    from repro_torch.models import gnn
    from repro_torch.train import train_step as TS

    out = {"smoke": gnn_smoke_card_vs_cpu(device)}

    # (a) gat-cora at full_graph_sm's widths
    spec = get("gat-cora")
    cfg = arch_with_dims(spec.make_config(), spec.shape("full_graph_sm").dims["d_feat"],
                         GNN_GAT["n_classes"])
    t0 = time.perf_counter()
    g, labels = make_feature_graph(0, GNN_GAT["scale"], d_feat=cfg.d_in,
                                   n_classes=cfg.n_classes,
                                   edge_factor=GNN_GAT["edge_factor"], device=device)
    sync(device)
    n_valid = int(g.edge_valid.sum())
    log(f"    gat-cora graph: {g.n_nodes} nodes, {n_valid} directed edges "
        f"({g.edge_src.shape[0]} slots), d_in {cfg.d_in}, {cfg.n_classes} classes, made "
        f"in {time.perf_counter() - t0:.3f} s")
    params = gnn.gat_init(cfg, seed=0, device=device)
    cpu_p = {k: v.cpu() for k, v in params.items()}
    with torch.no_grad():
        err = scaled_err(gnn.gat_forward(params, g, cfg),
                         gnn.gat_forward(cpu_p, g.to("cpu"), cfg))
    log(f"    gat-cora full width, card vs CPU forward: max |diff| / max |out| {err:.3e}")
    if err > GNN_TOL:
        raise AssertionError(f"gat-cora at full width: card vs CPU {err}")
    out["gat"] = gnn_train_path(
        "gat-cora", lambda opt: TS.make_gnn_train_step("gat", cfg, opt), params,
        lambda i: (g, labels), GNN_STEPS, device,
        {"nodes": g.n_nodes, "edges": n_valid})
    del g, labels, params, cpu_p
    torch.cuda.empty_cache()

    # (b) graphsage-reddit on sampled blocks at minibatch_lg's widths
    spec = get("graphsage-reddit")
    cell = spec.shape("minibatch_lg").dims
    cfg = arch_with_dims(spec.make_config(), cell["d_feat"], GNN_SAGE_BLOCKS["n_classes"])
    t0 = time.perf_counter()
    g, labels = make_feature_graph(0, GNN_SAGE_BLOCKS["scale"], d_feat=cfg.d_in,
                                   n_classes=cfg.n_classes,
                                   edge_factor=GNN_SAGE_BLOCKS["edge_factor"], device=device)
    ro, ci = csr_of(g)
    sync(device)
    log(f"    graphsage-reddit graph: {g.n_nodes} nodes, {int(ro[-1])} directed edges, "
        f"features {g.node_feat.numel() * 4 / 1e9:.3f} GB, made in "
        f"{time.perf_counter() - t0:.3f} s")
    sampler = NeighborSampler(ro, ci, cell["fanout"], seed=0, device=device)
    order = np.random.default_rng(0).permutation(g.n_nodes)
    batches, host_ms = [], []
    for i in range(GNN_SAGE_BLOCKS["steps"]):
        t0 = time.perf_counter()
        batches.append(sampler.sample(order[i * cell["batch_nodes"]:
                                            (i + 1) * cell["batch_nodes"]]))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    sizes = [len(b.node_ids) for b in batches]
    log(f"    NeighborSampler, {cell['batch_nodes']} seeds, fanout {cell['fanout']}: "
        f"{statistics.median(host_ms):.6f} ms a batch on the host (median of "
        f"{len(host_ms)}; {min(host_ms):.3f}-{max(host_ms):.3f}), {min(sizes)}-{max(sizes)} "
        f"sampled nodes a batch")

    def sage_args(i):
        b = batches[i % len(batches)]
        ids = torch.from_numpy(b.node_ids).to(device)
        return (g.node_feat[ids], b.blocks,
                labels[torch.from_numpy(b.seeds).to(device)])

    params = gnn.sage_init(cfg, seed=0, device=device)
    cpu_p = {k: v.cpu() for k, v in params.items()}
    feats, blocks, _ = sage_args(0)
    with torch.no_grad():
        err = scaled_err(gnn.sage_forward_blocks(params, feats, blocks, cfg),
                         gnn.sage_forward_blocks(
                             cpu_p, feats.cpu(),
                             [{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                               for k, v in b.items()} for b in blocks], cfg))
    log(f"    graphsage-reddit full width, one block batch, card vs CPU forward: "
        f"max |diff| / max |out| {err:.3e}")
    if err > GNN_TOL:
        raise AssertionError(f"graphsage-reddit blocks at full width: card vs CPU {err}")
    out["sage_blocks"] = gnn_train_path(
        "graphsage-reddit (sampled blocks)",
        lambda opt: TS.make_sage_block_train_step(cfg, opt), params, sage_args,
        GNN_SAGE_BLOCKS["steps"], device, {"seeds": cell["batch_nodes"]})
    out["sage_blocks"]["sampler_ms"] = statistics.median(host_ms)
    del g, labels, ro, ci, batches, params, cpu_p, feats, blocks
    torch.cuda.empty_cache()

    # (c) GraphSAGE full-graph at ogb_products' widths
    cell = spec.shape("ogb_products").dims
    cfg = arch_with_dims(spec.make_config(), cell["d_feat"], GNN_SAGE_FULL["n_classes"])
    t0 = time.perf_counter()
    g, labels = make_feature_graph(0, GNN_SAGE_FULL["scale"], d_feat=cfg.d_in,
                                   n_classes=cfg.n_classes,
                                   edge_factor=GNN_SAGE_FULL["edge_factor"], device=device)
    sync(device)
    n_valid = int(g.edge_valid.sum())
    log(f"    ogb_products stand-in: {g.n_nodes} nodes, {n_valid} directed edges "
        f"({g.edge_src.shape[0]} slots), d_in {cfg.d_in}, {cfg.n_classes} classes, made "
        f"in {time.perf_counter() - t0:.3f} s")
    params0 = gnn.sage_init(cfg, seed=0, device=device)
    out["sage_full"] = gnn_train_path(
        "graphsage full graph (ogb_products widths)",
        lambda opt: TS.make_gnn_train_step("sage", cfg, opt), params0,
        lambda i: (g, labels), GNN_SAGE_FULL["steps"], device,
        {"nodes": g.n_nodes, "edges": n_valid})
    out["sage_full_graph"] = dict(cfg=cfg, g=g, labels=labels, params0=params0)

    # (d) dimenet and equiformer-v2 on the molecule cell
    t0 = time.perf_counter()
    mol = get("dimenet").shape("molecule").dims
    g, species, tri = make_molecule_batch(0, mol["batch"], mol["n_nodes"], mol["n_edges"],
                                          device=device)
    n_tri = int(tri["valid"].sum())
    log(f"    molecule batch: {mol['batch']} graphs, {g.n_nodes} atoms, "
        f"{g.edge_src.shape[0]} edges, {n_tri} triplets in {tri['valid'].shape[0]} slots, "
        f"made in {time.perf_counter() - t0:.3f} s (host)")
    gen = torch.Generator(device=device).manual_seed(3)
    e_tgt = torch.randn((mol["batch"],), generator=gen, device=device)
    n_tgt = torch.randn((g.n_nodes,), generator=gen, device=device)
    cpu_g, cpu_s = g.to("cpu"), species.cpu()
    cpu_t = {k: v.cpu() for k, v in tri.items()}
    for arch in ("dimenet", "equiformer-v2"):
        full = get(arch).make_config()
        check = full if arch == "dimenet" else dataclasses.replace(
            full, n_layers=GNN_CHECK_LAYERS)
        p = gnn.INITS[arch](check, seed=1, device=device)
        cpu_p = {k: v.cpu() for k, v in p.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            if arch == "dimenet":
                want = gnn.dimenet_energy(cpu_p, cpu_g, cpu_s, cpu_t, check, mol["batch"])
                got = gnn.dimenet_energy(p, g, species, tri, check, mol["batch"])
            else:
                want = gnn.equiformer_forward(cpu_p, cpu_g, cpu_s, check)
                got = gnn.equiformer_forward(p, g, species, check)
        err = scaled_err(got, want)
        log(f"    {arch} at full width{'' if check is full else f' ({check.n_layers} layers)'}, "
            f"card vs CPU forward: max |diff| / max |out| {err:.3e} (both in "
            f"{time.perf_counter() - t0:.3f} s)")
        if err > GNN_TOL:
            raise AssertionError(f"{arch} at full width: card vs CPU {err}")
        del p, cpu_p
        params = gnn.INITS[arch](full, seed=0, device=device)
        if arch == "dimenet":
            make = partial(TS.make_dimenet_train_step, full, n_graphs=mol["batch"])
            args = (g, species, tri, e_tgt)
        else:
            make = partial(TS.make_equiformer_train_step, full)
            args = (g, species, n_tgt)
        out[arch] = gnn_train_path(arch, make, params, lambda i: args, GNN_STEPS, device,
                                   {"graphs": mol["batch"], "atoms": g.n_nodes},
                                   lr=GNN_LR.get(arch, 3e-3))
        del params
        torch.cuda.empty_cache()

    # (e) the launcher's GNN branch at the smoke configs
    for arch in GNN_ARCHS:
        res = launch_train.main(["--arch", arch, "--steps", "6"], log=lambda m: None)
        ls = res["losses"]
        log(f"    launch.train --arch {arch} --steps 6 (smoke config): loss "
            f"{ls[0]:.4f} -> {ls[-1]:.4f}")
        if not (len(ls) == 6 and ls[-1] < ls[0]):
            raise AssertionError(f"launch.train --arch {arch}: {ls}")
    return out


def gnn_mesh_phase(full: dict, device) -> dict:
    """Phase 26: the owner-partitioned SAGE step on a virtual (2, 2) mesh of
    the card, on phase 25's ogb_products stand-in from its initial
    parameters: hierarchical and flat in float32 against the single-device
    step (loss within 1e-4, every parameter within 1e-5 after one AdamW
    step), and the bf16 gather (its loss within GNN_BF16_VS_F32_REL of the
    float32 loss); ms a step beside the single-device step's, and the idle
    share of one hierarchical step."""
    from repro_torch.models import gnn_dist
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import train_step as TS
    cfg, g, labels, params0 = full["cfg"], full["g"], full["labels"], full["params0"]
    opt = AdamW(cosine(3e-3, 2, GNN_SAGE_FULL["steps"]))

    def host_ms(fn):
        sync(device)
        t0 = time.perf_counter()
        r = fn()
        sync(device)
        return r, (time.perf_counter() - t0) * 1e3

    single = TS.make_gnn_train_step("sage", cfg, opt)
    (want, _, want_loss), _ = host_ms(lambda: single(params0, opt.init(params0), g, labels))
    _, single_ms = host_ms(lambda: single(params0, opt.init(params0), g, labels))
    want_loss = float(want_loss)
    mesh = virtual_mesh(GNN_MESH)
    n_shards = GNN_MESH[0] * GNN_MESH[1]
    t0 = time.perf_counter()
    part = gnn_dist.partition_edges(g.edge_src, g.edge_dst, g.edge_valid, g.n_nodes,
                                    n_shards)
    sync(device)
    per = part[2].view(n_shards, -1).sum(1).tolist()
    log(f"    single-device step {single_ms:.6f} ms (host clock), loss {want_loss:.6f}; "
        f"edges partitioned by owner over {n_shards} shards in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms: {part[0].shape[0] // n_shards} slots "
        f"a shard, valid edges by shard {per} (the degree sort puts the heavy rows "
        f"on shard 0)")
    out = {"single_ms": single_ms}
    for name, hier, dt in (("hierarchical", True, torch.float32),
                           ("flat", False, torch.float32),
                           ("hierarchical bf16", True, torch.bfloat16)):
        step = gnn_dist.make_sage_dist_step(cfg, opt, mesh, g.n_nodes,
                                            hierarchical=hier, gather_dtype=dt)

        def run():
            return step(params0, opt.init(params0), g.node_feat, *part, labels)

        (new, _, loss), _ = host_ms(run)
        _, ms = host_ms(run)
        loss = float(loss)
        if dt == torch.float32:
            p_err = max(float((new[k] - want[k]).abs().max()) for k in want)
            log(f"    {name} on a virtual {GNN_MESH} mesh: {ms:.6f} ms a step (host "
                f"clock), loss {loss:.6f} (|diff| {abs(loss - want_loss):.3e}), parameters "
                f"after one step max |diff| {p_err:.3e}")
            if abs(loss - want_loss) > 1e-4 or p_err > 1e-5:
                raise AssertionError(f"{name}: the mesh step is off the single-device step")
        else:
            rel = abs(loss - want_loss) / want_loss
            log(f"    {name} on a virtual {GNN_MESH} mesh: {ms:.6f} ms a step (host clock), "
                f"loss {loss:.6f}, |diff| / float32 loss {rel:.3e} (bound "
                f"{GNN_BF16_VS_F32_REL})")
            if not math.isfinite(loss) or rel > GNN_BF16_VS_F32_REL:
                raise AssertionError(f"{name}: the bf16 loss is off the float32 loss")
        out[name] = ms
        del new
    step = gnn_dist.make_sage_dist_step(cfg, opt, mesh, g.n_nodes)
    log("    profile of one hierarchical mesh step")
    prof = profile_window(lambda: step(params0, opt.init(params0), g.node_feat, *part,
                                       labels), ())
    out["idle"] = None if prof is None else prof["idle_share"]
    return out


def profile_complete(fn, kernels: tuple[str, ...], short, attempts: int = 3):
    """:func:`profile_window` again while ``short(stats)`` says the trace
    holds fewer launches than the calls made, and nothing else amiss: the
    profiler can drop a device event from a window (one of 50
    ``frontier_update`` launches in one of five chip runs of PR 15).  A
    trace with extra operations is returned at once, for the caller's
    check to fail."""
    for i in range(attempts):
        stats = profile_window(fn, kernels)
        if stats is None or not short(stats) or i == attempts - 1:
            return stats
        log("    the trace is short of the launches made (device events "
            "dropped); profiling again")
    return stats


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, bitmap_ops, frontier_spmv, ops, ref
    from repro_torch.core import pipeline
    from repro_torch.core.heavy import pack_bitmap, padded_bitmap_words
    from repro_torch.core.plan import compile_plan

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info['seconds']:.2f} s) into {_build.build_info['dir']}")
    for name, text in _build.build_info["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    ptxas {name}: {line.strip()}")
            elif name in ("cin_layer", "spmv_mxu") and "Compiling entry" in line:
                log(f"    ptxas {name}: {line.strip()[-90:]}")
    from repro_torch.kernels import cin
    for fl in (39, 200):
        plan = cin.cin_plan(262144, 39, fl, 200, 10, sms=cin.sm_count(device))
        log(f"    cin_layer at Fl={fl}: {plan.warps} warps, {plan.smem_bytes} B of "
            f"dynamic shared memory per block (above the static smem ptxas reports)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[3] kernels against their plain versions on the card "
        f"(torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32})")
    check_frontier_update(device)
    check_core_spmv(device)
    cin_err = check_cin_layer(device)
    check_spmv_mxu(device)

    log(f"[4] main path at scale {SCALE_CHECK}")
    check_scale16()

    log(f"[5] main path: pre-g500 at scale {SCALE_MAIN}, {N_ROOTS} roots")
    cfg = pipeline.Graph500Config.ladder("pre-g500", scale=SCALE_MAIN,
                                         n_roots=N_ROOTS, check="full")
    built = pipeline.build(cfg)
    log(f"    construction {built.construction_s:.6f} s: V={built.n_vertices} "
        f"nnz={built.nnz} K={built.core.k} k_heavy={int(built.core.k_heavy)}")
    ops.reset_launch_counts()
    _, run = pipeline.run(cfg, built)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"    hmean TEPS {run.harmonic_mean_teps:.6e}, mean time/root "
        f"{run.mean_time_s * 1e3:.6f} ms, all_valid {run.all_valid}, "
        f"check_counts {run.check_counts}, launches {launches}")
    check_valid(f"scale {SCALE_MAIN}", run)
    for name in ("frontier_update", "core_spmv"):
        n = launches[name]
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path "
                                 f"(no bottom-up level?)")

    roots = pipeline.search_keys(cfg, built)
    per_root = compile_plan(cfg.to_plan(), built)
    one = per_root.bfs(int(roots[0]))
    n_lvl = int(one.stats.levels)
    dirs = one.stats.direction[:n_lvl].tolist()
    log(f"    root 0: directions {dirs}, frontier sizes "
        f"{one.stats.frontier_size[:n_lvl].tolist()}")
    res_root = per_root.run(roots, check="off")
    cfg_b = pipeline.Graph500Config.ladder("pre-g500-batch", scale=SCALE_MAIN,
                                           n_roots=N_ROOTS, check="full")
    _, run_b = pipeline.run(cfg_b, built)
    res_batch = compile_plan(cfg_b.to_plan(), built).run(roots, check="off")
    if not np.array_equal(res_root.parent, res_batch.parent):
        raise AssertionError("pre-g500-batch parents differ from per-root parents")
    check_valid("pre-g500-batch", run_b)
    log(f"    pre-g500-batch: parents identical to per-root; hmean TEPS "
        f"{run_b.harmonic_mean_teps:.6e}")

    log("[6] kernels at their main-path shapes")
    w = padded_bitmap_words(built.n_vertices)
    level0 = torch.as_tensor(res_root.level[0], device=device)
    bu = [i for i, d in enumerate(dirs) if d == 1][0]
    frontier = pack_bitmap(level0 == bu, w)
    visited = pack_bitmap((level0 >= 0) & (level0 <= bu), w)
    found = pack_bitmap(level0 == bu + 1, w)
    k = built.core.k
    a_core = built.core.a_core
    f_core = frontier[: k // 32]

    fu_err = max(assert_equal(f"frontier_update main-path {part}", got, want)
                 for got, want, part in zip(bitmap_ops.frontier_update(found, visited),
                                            ref.frontier_update_ref(found, visited),
                                            ("next", "visited", "count")))
    cs_err = assert_equal("core_spmv main-path", frontier_spmv.core_spmv(a_core, f_core),
                          ref.core_spmv_ref(a_core, f_core))
    # frontier_update in the engine's form: into reused caller buffers
    fu_out = (torch.empty_like(found), torch.empty_like(visited),
              torch.empty((), dtype=torch.int32, device=device))
    fu_ms = time_ms(lambda: bitmap_ops.frontier_update(found, visited, out=fu_out), 30, 20)
    fu_alloc_ms = time_ms(lambda: bitmap_ops.frontier_update(found, visited), 30, 20)
    fu_plain = time_ms(lambda: ref.frontier_update_ref(found, visited), 10, 5)
    fu_bound = bound_ms(16 * w + 4, 5 * w)
    n_calls = 50
    log(f"    profile of {n_calls} frontier_update calls (out= form)")
    fu_prof = profile_complete(
        lambda: [bitmap_ops.frontier_update(found, visited, out=fu_out)
                 for _ in range(n_calls)], ("frontier_update_kernel",),
        lambda p: (p["kernels"]["frontier_update_kernel"][1] < n_calls
                   and p["activities"] == p["kernels"]["frontier_update_kernel"][1]))
    fu_device_ms = None
    if fu_prof is not None:
        tot, n = fu_prof["kernels"]["frontier_update_kernel"]
        if n != n_calls or fu_prof["activities"] != n_calls:
            raise AssertionError(f"frontier_update: {fu_prof['activities']} device "
                                 f"operations and {n} kernels over {n_calls} calls, "
                                 f"not one each")
        fu_device_ms = tot / n / 1e3
        log(f"    frontier_update: {fu_prof['activities'] / n_calls:.6f} device "
            f"operations per call, device {fu_device_ms:.6f} ms per launch")
    cs_ms = time_ms(lambda: frontier_spmv.core_spmv(a_core, f_core), 20, 5)
    cs_plain = time_ms(lambda: ref.core_spmv_ref(a_core, f_core), 3, 1)
    cs_bound = bound_ms(4 * (k * (k // 32) + k // 32 + k), 5 * k * (k // 32))
    log(f"    frontier_update W={w}: {fu_ms:.6f} ms per wrapper call into out= "
        f"buffers ({fu_alloc_ms:.6f} ms allocating its outputs), device "
        f"{fu_device_ms} ms per launch, plain {fu_plain:.6f} ms, "
        f"bound {fu_bound[0]:.6f} ms ({fu_bound[1]})")
    log(f"    core_spmv K={k} W={k // 32} (bottom-up level {bu}): {cs_ms:.6f} ms, "
        f"plain {cs_plain:.6f} ms, bound {cs_bound[0]:.6f} ms ({cs_bound[1]})")
    log(f"    max abs err vs plain: frontier_update {fu_err}, core_spmv {cs_err} "
        f"(tolerance 0: integer outputs must be bit-exact)")
    log("    library call: none (no single PyTorch call computes either function)")

    log(f"[7] profile of one pre-g500 traversal at scale {SCALE_MAIN} (root 1)")
    lv1 = int(per_root.bfs(int(roots[1])).stats.levels)
    trav = profile_complete(
        lambda: per_root.bfs(int(roots[1])),
        ("frontier_update_kernel", "core_spmv_kernel"),
        lambda p: (p["kernels"]["frontier_update_kernel"][1] < lv1
                   and not p["memset_before"]["frontier_update_kernel"]))
    if trav is not None:
        fu_launches = trav["kernels"]["frontier_update_kernel"][1]
        fu_memsets = trav["memset_before"]["frontier_update_kernel"]
        log(f"    root 1: {lv1} levels, {fu_launches} frontier_update launches, "
            f"{fu_memsets} memsets right before one, {trav['memsets']} memsets in "
            f"all, {trav['activities']} device activities")
        if fu_launches != lv1 or fu_memsets:
            raise AssertionError(f"frontier_update: {fu_launches} launches over "
                                 f"{lv1} levels, {fu_memsets} memsets beside them")

    log("[8] xDeepFM serving at full width (xdeepfm_full, use_cin_kernel=True)")
    serving = serve_xdeepfm(device)
    cin_err = max(cin_err, serving["err"])

    log(f"[9] multi_source_spmv on the scale-{SCALE_MAIN} heavy core")
    spmv = multi_source_on_core(built, res_root.level, device)

    log("[10] cin_layer and spmv_mxu at their path's shapes")
    cin_t = time_cin(serving, device)
    time_cin_splits(serving, device)
    cin_err = max(cin_err, cin_t["err"])
    spmv_t = time_spmv(spmv)
    spmv_launches, spmv_err = spmv["launches"], spmv["err"]
    del spmv

    log(f"[11] the Fig. 18 ladder at scale {SCALE_MAIN}, {LADDER_ROOTS} roots")
    legacy_launches = ladder_rungs(built, res_root, roots)

    log(f"[12] Graph500 SSSP at scale {SCALE_MAIN}, {SSSP_ROOTS} roots")
    sssp_rows = sssp_phase(device)

    log(f"[13] checked execution at scale {SCALE_MAIN} (phase 5's graph and keys)")
    t0 = time.perf_counter()
    checked = checked_execution(cfg_b, built, roots, res_root.parent, device)
    log(f"    phase 13 took {time.perf_counter() - t0:.3f} s")

    log(f"[14] BFS serving at scale {SCALE_MAIN} (pipeline.serve, {SERVE_CFG})")
    t0 = time.perf_counter()
    served = serving_phase(cfg_b, built, checked["weighted"], device)
    log(f"    phase 14 took {time.perf_counter() - t0:.3f} s; the script so far "
        f"{time.perf_counter() - t_start:.3f} s")

    log(f"[15] the plan auto-tuner at scale {SCALE_MAIN} (budget {TUNE_BUDGET}, "
        f"{N_ROOTS} roots, {TUNE_REPS} reps)")
    t0 = time.perf_counter()
    tuned = tuning_phase(built, run_b, device)
    log(f"    phase 15 took {time.perf_counter() - t0:.3f} s; the script "
        f"{time.perf_counter() - t_start:.3f} s")

    log(f"[16] mesh layouts at scale {SCALE_MAIN} on phase 5's graph (virtual "
        f"meshes: every shard on the one card)")
    t0 = time.perf_counter()
    meshed = mesh_phase(built, roots, res_root.parent, device)
    log(f"    phase 16 took {time.perf_counter() - t0:.3f} s")

    log(f"[17] sharded SSSP and exchange faults at scale {SCALE_MAIN}")
    t0 = time.perf_counter()
    mesh_faults = mesh_faults_phase(built, roots, res_root.parent, sssp_rows,
                                    checked["weighted"], meshed.pop("shards"), device)
    log(f"    phase 17 took {time.perf_counter() - t0:.3f} s")

    log(f"[18] the multi-process launcher on the card (scale {MP_SCALE})")
    t0 = time.perf_counter()
    launched = launcher_phase(device)
    log(f"    phase 18 took {time.perf_counter() - t0:.3f} s; the script "
        f"{time.perf_counter() - t_start:.3f} s")

    log(f"[19] the tuner over a virtual mesh of {VSWEEP_DEVICES} shards of the card "
        f"(scale {SCALE_MAIN}, budget small, {VSWEEP_ROOTS} roots, {VSWEEP_REPS} reps)")
    t0 = time.perf_counter()
    vswept = virtual_sweep_phase(device)
    log(f"    phase 19 took {time.perf_counter() - t0:.3f} s")

    log(f"[20] mesh serving at scale {SCALE_MAIN}: a virtual (2, 2) engine, "
        f"{MESH_SERVE_QUERIES} queries of serve_burst")
    t0 = time.perf_counter()
    mesh_served = mesh_serving_phase(built, device)
    log(f"    phase 20 took {time.perf_counter() - t0:.3f} s")

    log("[21] the T3 psum and all-to-all on a virtual (2, 4) mesh of the card")
    t0 = time.perf_counter()
    collectives_phase(device)
    log(f"    phase 21 took {time.perf_counter() - t0:.3f} s")

    log("[22] xDeepFM training at full width (xdeepfm_full)")
    t0 = time.perf_counter()
    training_phase(device)
    log(f"    phase 22 took {time.perf_counter() - t0:.3f} s; the script "
        f"{time.perf_counter() - t_start:.3f} s")

    log("[23] LM serving at full width (olmo-1b, granite-moe-1b-a400m)")
    t0 = time.perf_counter()
    lm_serving_phase(device)
    log(f"    phase 23 took {time.perf_counter() - t0:.3f} s")

    log(f"[24] LM training at full width ({LM_TRAIN_ARCH}) and the MoE dispatch on the card")
    t0 = time.perf_counter()
    lm_training_phase(device)
    log(f"    phase 24 took {time.perf_counter() - t0:.3f} s; the script "
        f"{time.perf_counter() - t_start:.3f} s")

    log("[25] GNN training at full width (gat-cora, graphsage-reddit on sampled blocks "
        "and full-graph, dimenet, equiformer-v2)")
    t0 = time.perf_counter()
    gnn_out = gnn_training_phase(device)
    log(f"    phase 25 took {time.perf_counter() - t0:.3f} s")

    log(f"[26] the owner-partitioned SAGE step on a virtual {GNN_MESH} mesh of the card")
    t0 = time.perf_counter()
    gnn_mesh_phase(gnn_out.pop("sage_full_graph"), device)
    log(f"    phase 26 took {time.perf_counter() - t0:.3f} s; the script "
        f"{time.perf_counter() - t_start:.3f} s")
    by_path = {name: dict(main=launches[name], checked_execution=checked["launches"][name],
                          serving=served["launches"][name],
                          tuning_sweep=tuned["sweep"][name],
                          **{"pre-g500-tuned": tuned["tuned"][name]},
                          mesh_layouts=meshed["launches"][name],
                          mesh_faults=mesh_faults["launches"][name],
                          multiprocess_rank0=launched["launches"][name],
                          virtual_sweep=vswept["launches"][name],
                          mesh_serving=mesh_served["launches"][name])
               for name in ("frontier_update", "core_spmv")}
    by_path["core_spmv"]["pre-g500-legacy"] = legacy_launches

    kernels = [
        dict(name="frontier_update", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier_update.cu",
             replaces="src/repro/kernels/bitmap_ops.py:62",
             launches=sum(by_path["frontier_update"].values()),
             launches_by_path=by_path["frontier_update"], max_abs_err=fu_err,
             ms=fu_ms, plain_ms=fu_plain, bound_ms=fu_bound[0],
             bound_by=fu_bound[1], library_ms=None, device_ms=fu_device_ms),
        dict(name="core_spmv", route="cuda",
             source="src/repro_torch/kernels/csrc/core_spmv.cu",
             replaces="src/repro/kernels/frontier_spmv.py:74",
             launches=sum(by_path["core_spmv"].values()),
             launches_by_path=by_path["core_spmv"], max_abs_err=cs_err,
             ms=cs_ms, plain_ms=cs_plain, bound_ms=cs_bound[0],
             bound_by=cs_bound[1], library_ms=None),
        dict(name="spmv_mxu", route="cuda",
             source="src/repro_torch/kernels/csrc/spmv_mxu.cu",
             replaces="src/repro/kernels/spmv_mxu.py:57",
             launches=spmv_launches, max_abs_err=spmv_err,
             ms=spmv_t["ms"], plain_ms=spmv_t["plain_ms"], bound_ms=spmv_t["bound"][0],
             bound_by=spmv_t["bound"][1], library_ms=spmv_t["library_ms"]),
        # cin_layer: one serve_p99 forward's three layers (B = 512), summed;
        # bulk_* the same at serve_bulk (B = 262,144).  bound_ms is the
        # 3xTF32 tensor-core bound the kernel is held to; fp32_bound_ms the
        # same flops once at the fp32 rate
        dict(name="cin_layer", route="cuda",
             source="src/repro_torch/kernels/csrc/cin_layer.cu",
             replaces="src/repro/kernels/cin.py:64",
             launches=serving["launches"], max_abs_err=cin_err,
             ms=cin_t["ms"], plain_ms=cin_t["plain_ms"], bound_ms=cin_t["bound_ms"],
             bound_by=cin_t["bound_by"], library_ms=cin_t["library_ms"],
             fp32_bound_ms=cin_t["fp32_bound_ms"],
             bulk_ms=cin_t["bulk_ms"], bulk_bound_ms=cin_t["bulk_bound_ms"],
             bulk_fp32_bound_ms=cin_t["bulk_fp32_bound_ms"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
