"""Shape-only dry run of the registry cells on the production meshes, with
H100 rooflines (the port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --jobs 4

Each cell's step (``launch.input_specs``) runs once on the ``meta`` device
under :class:`OpCounter`, a ``TorchDispatchMode`` that counts, per aten op:

  * FLOPs by compute dtype, through ``torch.utils.flop_counter``'s formulas
    (products only: matmuls, convolutions, attention; XLA's ``flops`` also
    counts elementwise operations, so the two packages' counts differ);
  * bytes read plus written: every tensor in and out of the op (XLA's
    "bytes accessed"; views move nothing);
  * the peak of live intermediate bytes: every storage an op creates is live
    until it is freed, so tensors autograd saves for the backward count.

A meta tensor has no data: nothing is allocated and no value is read on the
host, so the 256- and 512-chip cells run in a second or two each on any
machine.  The run goes through the port's own code (the remat recompute
included), and a census (``launch.collective_census``) records the
collectives it issues, beside the ones the cell's shardings imply.

Per-device figures: FLOPs, bytes and temp bytes are the global counts
divided by the chips the cell shards its work over
(``CellPlan.compute_shards``); argument and output bytes are exact, from the
shard shapes of the inputs and outputs; ``hbm_per_device_bytes`` =
arguments + outputs + temp - aliases (outputs written into an input).  The
roofline divides by the constants of ``launch.mesh`` (one NVIDIA H100 SXM5
at 700 W): compute by each dtype's peak, bytes by ``HBM_BW``, link bytes by
``LINK_BW``.  Records go under ``$DRYRUN_OUT`` (``experiments/dryrun_torch``)
with the JAX package's keys, so ``benchmarks/roofline.py`` renders them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.collective_census import Census
from repro_torch.launch.input_specs import build_cell, flatten, leaf_layout

DEFAULT_OUT = "experiments/dryrun_torch"

PER_DEVICE_RULE = ("per-device flops, bytes and temp bytes = global counts / "
                   "compute_shards; argument and output bytes from the shard shapes")

#: compute dtype -> the card's peak (float32 products run with TF32 off)
_PEAKS = {"bfloat16": mesh_lib.PEAK_FLOPS_BF16, "float16": mesh_lib.PEAK_FLOPS_BF16,
          "float32": mesh_lib.PEAK_FLOPS_FP32, "float64": mesh_lib.PEAK_FLOPS_FP32,
          "int8": mesh_lib.PEAK_OPS_INT8}

_META_OPS = {torch.ops.aten.detach.default, torch.ops.aten.alias.default}

_aten = torch.ops.aten
#: flop_counter's formulas, and the same 2 x multiply-adds for the
#: matrix-vector and vector products it has none for
_FLOPS = {**flop_registry,
          _aten.mv: lambda a, b, *_, **__: 2 * a.shape[0] * a.shape[1],
          _aten.addmv: lambda c, a, b, *_, **__: 2 * a.shape[0] * a.shape[1],
          _aten.dot: lambda a, b, *_, **__: 2 * a.shape[0],
          _aten.vdot: lambda a, b, *_, **__: 2 * a.shape[0]}


def tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples (NamedTuples too) and
    dataclasses; anything else is skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op touches of ``t``: its elements, or its storage when that
    is smaller (a broadcast view reads each element once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class OpCounter(TorchDispatchMode):
    """Counts FLOPs by compute dtype, bytes read and written, and the peak
    of live bytes of the storages the ops create (``external`` tensors, the
    step's inputs, are not counted as created)."""

    def __init__(self, external=()):
        super().__init__()
        self.flops = defaultdict(int)
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in tensors(external)}
        self._created = {}

    def _free(self, key, nb) -> None:
        self._created.pop(key, None)
        self.live -= nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pkt = func._overloadpacket
        if pkt not in _FLOPS and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self.ops += 1
        ins = tensors((args, kwargs))
        if pkt in _FLOPS:
            dtype = str(ins[0].dtype).removeprefix("torch.")
            self.flops[dtype] += int(_FLOPS[pkt](*args, **kwargs, out_val=out))
        if func.is_view or func in _META_OPS:
            return out
        outs = tensors(out)
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        seen = {t.untyped_storage()._cdata for t in ins} | self._known
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._created:
                continue
            nb = st.nbytes()
            self._created[key] = nb
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, nb)
        return out

    def created_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree``'s tensors that the run created
        and that are still live."""
        keys = {t.untyped_storage()._cdata for t in tensors(tree)}
        return sum(self._created.get(k, 0) for k in keys)


def count_step(step, args) -> tuple:
    """Run ``step(*args)`` once under an :class:`OpCounter`; returns
    ``(outputs, counter)``."""
    with OpCounter(external=args) as cnt:
        out = step(*args)
    return out, cnt


def compute_seconds(flops_by_dtype: dict) -> float:
    """Sum over the compute dtypes of FLOPs over the card's peak for it."""
    return sum(f / _PEAKS.get(dt, mesh_lib.PEAK_FLOPS_FP32)
               for dt, f in flops_by_dtype.items())


def _leaf_bytes(layout: dict) -> int:
    return sum(math.prod(shard) * _itemsize(dt) for _, dt, shard in layout.values())


def _itemsize(dtype_name: str) -> int:
    return getattr(torch, dtype_name).itemsize


def run_cell(arch: str, shape: str, multi_pod: bool, variant: str = "baseline",
             mesh=None) -> dict:
    """Run one (arch x shape x mesh) cell shape-only; return its record.

    ``mesh`` (default: the production mesh) may be any virtual mesh with the
    production axes, as the tests' small meshes are."""
    from repro_torch.configs import get as get_spec

    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(mesh.shape)
    plan = build_cell(arch, shape, mesh, variant)
    family = get_spec(arch).family
    rec = {
        "arch": arch, "shape": shape, "variant": variant,
        "mesh": "x".join(map(str, mesh.shape)), "chips": chips,
        "skip_reason": plan.skip_reason, "supplementary": plan.supplementary,
        "note": plan.note, "model_flops_global": plan.model_flops_global,
        "family": family, "ok": False, "card": mesh_lib.CARD,
        "constants": mesh_lib.constants(), "compute_shards": plan.compute_shards,
        "lower_s": None, "compile_s": None,
    }
    census = Census()
    t0 = time.perf_counter()
    with census:
        out, cnt = count_step(plan.step, plan.args)
    rec["run_s"] = time.perf_counter() - t0
    if plan.modeled is not None:
        plan.modeled(census)

    shards = plan.compute_shards
    args_layout = leaf_layout(plan.args, plan.in_shardings, mesh)
    out_layout = leaf_layout(out, plan.out_shardings, mesh)
    arg_keys = {t.untyped_storage()._cdata for t in tensors(plan.args)}
    aliased = {p for p, t in flatten(out) if t.untyped_storage()._cdata in arg_keys}
    temp_global = max(cnt.peak - cnt.created_bytes(out), 0)
    mem = {
        "argument_bytes": _leaf_bytes(args_layout),
        "output_bytes": _leaf_bytes(out_layout),
        "temp_bytes": temp_global / shards,
        "alias_bytes": _leaf_bytes({p: out_layout[p] for p in aliased}),
        "code_bytes": 0,
    }
    rec["memory"] = mem
    rec["hbm_per_device_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                                   + mem["temp_bytes"] - mem["alias_bytes"])
    rec["ops"] = cnt.ops
    rec["flops_global"] = float(sum(cnt.flops.values()))
    rec["flops_by_dtype"] = {k: v / shards for k, v in cnt.flops.items()}
    rec["flops_per_device"] = rec["flops_global"] / shards
    rec["bytes_per_device"] = cnt.bytes / shards
    rec["temp_peak_global_bytes"] = cnt.peak
    rec["collectives"] = census.to_json()
    coll = rec["collectives"]
    rec["note"] = " | ".join(x for x in (
        plan.note, PER_DEVICE_RULE,
        "graph500: terms are per BFS level (one level body over every shard)"
        if family == "graph500" else "",
        "owner_gather: JAX's padded per-shard edge blocks (the port's run drops "
        "the padding)" if variant.startswith("owner_gather") else "") if x)

    rec["roofline"] = {
        "compute_s": compute_seconds(rec["flops_by_dtype"]),
        "memory_s": rec["bytes_per_device"] / mesh_lib.HBM_BW,
        "collective_s": coll["total_link_bytes"] / mesh_lib.LINK_BW,
        "collective_s_operand_metric": coll["total_operand_bytes"] / mesh_lib.LINK_BW,
    }
    terms = rec["roofline"]
    rec["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                            key=lambda k: terms[k])
    if rec["flops_per_device"] > 0:
        rec["model_flops_ratio"] = (plan.model_flops_global / chips
                                    / rec["flops_per_device"])
    rec["ok"] = True
    return rec


def markdown_table(records) -> str:
    """The roofline table of ``records`` (the columns of the JAX package's
    ``benchmarks/roofline.py``): the three terms in seconds, the bottleneck,
    the compute term's share of the largest, MODEL / counted FLOPs and the
    HBM residency per device."""
    lines = ["| arch | shape | compute s | memory s | collective s | bottleneck "
             "| roofline frac | MODEL/counted flops | HBM/dev GiB | note |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted((r for r in records if r.get("ok")),
                    key=lambda r: (r["arch"], r["shape"])):
        t = r["roofline"]
        hi = max(t["compute_s"], t["memory_s"], t["collective_s"])
        note = r.get("skip_reason") or ("suppl." if r.get("supplementary") else "")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3g} | {t['memory_s']:.3g} "
            f"| {t['collective_s']:.3g} | {r['bottleneck'].replace('_s', '')} "
            f"| {t['compute_s'] / hi if hi > 0 else 0.0:.2f} "
            f"| {r.get('model_flops_ratio', 0):.2f} "
            f"| {(r.get('hbm_per_device_bytes') or 0) / 2**30:.2f} | {note} |")
    return "\n".join(lines)


def out_path(arch, shape, multi_pod, variant):
    mesh_name = "multipod" if multi_pod else "singlepod"
    d = os.path.join(os.environ.get("DRYRUN_OUT", DEFAULT_OUT), mesh_name)
    os.makedirs(d, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(d, f"{arch}__{shape}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description="shape-only multi-pod dry run (meta device)")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--sweep", action="store_true",
                    help="run every (arch x shape) cell in subprocesses")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.sweep:
        return sweep(args)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape required (or --sweep)")
    path = out_path(args.arch, args.shape, args.multi_pod, args.variant)
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.variant)
    except Exception as e:
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.multi_pod else "16x16",
               "variant": args.variant, "ok": False,
               "error": repr(e), "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if not args.quiet:
        show = {k: rec.get(k) for k in
                ("arch", "shape", "mesh", "ok", "skip_reason", "run_s",
                 "flops_per_device", "bytes_per_device", "bottleneck")}
        print(json.dumps(show))
        if rec.get("ok"):
            print(json.dumps(rec["roofline"]))
        else:
            print(rec.get("error", ""), file=sys.stderr)
    return 0 if rec.get("ok") or rec.get("skip_reason") else 1


def sweep(args):
    from repro_torch.configs import all_cells

    jobs = []
    for multi in (False, True):
        for arch, shape in all_cells():
            path = out_path(arch, shape, multi, args.variant)
            if os.path.exists(path) and not args.force:
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape,
                   "--variant", args.variant, "--quiet"]
            if multi:
                cmd.append("--multi-pod")
            jobs.append((arch, shape, multi, cmd))
    print(f"[sweep] {len(jobs)} cells to run, {args.jobs} at a time")
    procs, failed, idx = [], [], 0
    while idx < len(jobs) or procs:
        while idx < len(jobs) and len(procs) < args.jobs:
            arch, shape, multi, cmd = jobs[idx]
            p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            procs.append((arch, shape, multi, p, time.time()))
            idx += 1
        time.sleep(0.5)
        still = []
        for arch, shape, multi, p, t0 in procs:
            if p.poll() is None:
                still.append((arch, shape, multi, p, t0))
                continue
            tag = f"{arch}/{shape}/{'mp' if multi else 'sp'}"
            dt = time.time() - t0
            if p.returncode == 0:
                print(f"[sweep] OK   {tag} ({dt:.0f}s)")
            else:
                print(f"[sweep] FAIL {tag} ({dt:.0f}s): {p.stderr.read().decode()[-400:]}")
                failed.append(tag)
            p.stderr.close()
        procs = still
    print(f"[sweep] done; {len(failed)} failures")
    for f in failed:
        print("  FAIL", f)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
