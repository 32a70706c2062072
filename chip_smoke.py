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
     its two launches (F's transpose, the product).

The last two lines are the kernel JSON and the result JSON.  Without a
CUDA device, or without the rest of the repository beside it, the script
exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
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
        for i, w in enumerate(params.cin):
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
    stats = dict(activities=len(spans), memsets=memsets, kernels={})
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
    fu_prof = profile_window(
        lambda: [bitmap_ops.frontier_update(found, visited, out=fu_out)
                 for _ in range(n_calls)], ("frontier_update_kernel",))
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
    trav = profile_window(lambda: per_root.bfs(int(roots[1])),
                          ("frontier_update_kernel", "core_spmv_kernel"))
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

    kernels = [
        dict(name="frontier_update", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier_update.cu",
             replaces="src/repro/kernels/bitmap_ops.py:62",
             launches=launches["frontier_update"], max_abs_err=fu_err,
             ms=fu_ms, plain_ms=fu_plain, bound_ms=fu_bound[0],
             bound_by=fu_bound[1], library_ms=None, device_ms=fu_device_ms),
        dict(name="core_spmv", route="cuda",
             source="src/repro_torch/kernels/csrc/core_spmv.cu",
             replaces="src/repro/kernels/frontier_spmv.py:74",
             launches=launches["core_spmv"], max_abs_err=cs_err,
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
