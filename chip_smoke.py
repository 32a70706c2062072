"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any mismatch raises, so the exit code is
non-zero and no result line is printed:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every hand-written kernel from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card, bit for bit;
  4. the main path at scale 16: levels equal to the numpy queue BFS;
  5. the main path, ``Graph500Config.ladder("pre-g500", scale=20,
     n_roots=16)``: all roots valid with zero failing checks, both kernels
     launched, and the ``pre-g500-batch`` rung's parents equal to the
     per-root parents;
  6. each kernel at its main-path shape: time (CUDA events), its plain
     version's time and the bound (bytes over the card's memory rate);
  7. a torch.profiler trace of one scale-20 traversal: the device's busy
     and idle share and the device time by kernel.

The last two lines are the kernel JSON and the result JSON.  Without a
CUDA device, or without the rest of the repository beside it, the script
exits non-zero.
"""
from __future__ import annotations

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
    log(f"frontier_update: {len(cases)} cases bit-identical to frontier_update_ref")


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


def profile_traversal(compiled, root: int) -> None:
    """Device busy share and device time by kernel over one traversal,
    from torch.profiler's CUDA activity (printed as not measured when the
    profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    compiled.bfs(root)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compiled.bfs(root)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (end - start), n + 1)
    if not spans:
        log("    device time: not measured (the profiler recorded no CUDA activity)")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    log(f"    wall {wall_us / 1e3:.6f} ms (host clock, profiler on), device busy "
        f"{busy / 1e3:.6f} ms, idle share {1 - busy / wall_us:.6f}, "
        f"{len(spans)} device activities")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (tot, n) in top:
        log(f"    {tot / 1e3:10.6f} ms  x{n:<4d} {name[:110]}")
    for kernel in ("frontier_update_kernel", "core_spmv_kernel"):
        hits = [(tot, n) for name, (tot, n) in by_name.items() if kernel in name]
        tot, n = sum(t for t, _ in hits), sum(c for _, c in hits)
        per = f"{tot / n / 1e3:.6f} ms per launch" if n else "not launched"
        log(f"    {kernel}: device {tot / 1e3:.6f} ms over {n} launches ({per})")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
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
            if "registers" in line or "spill" in line:
                log(f"    ptxas {name}: {line.strip()}")

    log("[3] kernels against their plain versions on the card")
    check_frontier_update(device)
    check_core_spmv(device)

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
    for name, n in launches.items():
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
    fu_ms = time_ms(lambda: bitmap_ops.frontier_update(found, visited), 30, 20)
    fu_plain = time_ms(lambda: ref.frontier_update_ref(found, visited), 10, 5)
    fu_bound = bound_ms(16 * w + 4, 5 * w)
    cs_ms = time_ms(lambda: frontier_spmv.core_spmv(a_core, f_core), 20, 5)
    cs_plain = time_ms(lambda: ref.core_spmv_ref(a_core, f_core), 3, 1)
    cs_bound = bound_ms(4 * (k * (k // 32) + k // 32 + k), 5 * k * (k // 32))
    log(f"    frontier_update W={w}: {fu_ms:.6f} ms, plain {fu_plain:.6f} ms, "
        f"bound {fu_bound[0]:.6f} ms ({fu_bound[1]})")
    log(f"    core_spmv K={k} W={k // 32} (bottom-up level {bu}): {cs_ms:.6f} ms, "
        f"plain {cs_plain:.6f} ms, bound {cs_bound[0]:.6f} ms ({cs_bound[1]})")
    log(f"    max abs err vs plain: frontier_update {fu_err}, core_spmv {cs_err} "
        f"(tolerance 0: integer outputs must be bit-exact)")
    log("    library call: none (no single PyTorch call computes either function)")

    log(f"[7] profile of one pre-g500 traversal at scale {SCALE_MAIN} (root 1)")
    profile_traversal(per_root, int(roots[1]))

    kernels = [
        dict(name="frontier_update", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier_update.cu",
             replaces="src/repro/kernels/bitmap_ops.py:62",
             tpu_source="src/repro/kernels/bitmap_ops.py:62",
             launches=launches["frontier_update"], max_abs_err=fu_err,
             ms=fu_ms, plain_ms=fu_plain, bound_ms=fu_bound[0],
             bound_by=fu_bound[1], library_ms=None),
        dict(name="core_spmv", route="cuda",
             source="src/repro_torch/kernels/csrc/core_spmv.cu",
             replaces="src/repro/kernels/frontier_spmv.py:74",
             tpu_source="src/repro/kernels/frontier_spmv.py:74",
             launches=launches["core_spmv"], max_abs_err=cs_err,
             ms=cs_ms, plain_ms=cs_plain, bound_ms=cs_bound[0],
             bound_by=cs_bound[1], library_ms=None),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
