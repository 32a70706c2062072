"""Multi-process runtime: the vertex-sharded exchange across real process
boundaries, over ``torch.distributed`` with the gloo backend.

Counterpart of ``repro.launch.multiprocess``:

  * **parent** — picks a localhost rendezvous port, spawns one process per
    monitor group (``--procs N``, each holding ``--devices-per-proc D``
    member shards), writes one log and one pid file per rank, and polls the
    gang: any rank exiting nonzero, or the deadline passing, kills every
    surviving rank before the launch raises (no orphans).  On ``cuda`` it
    builds the kernel libraries once before it spawns, so the workers only
    load them.
  * **workers** — ``init_process_group("gloo",
    init_method="tcp://127.0.0.1:<port>")``, then the existing
    ``compile_plan`` / ``CompiledBFS`` over the process mesh (the ``group``
    axis on the processes, ``comms/mesh.py``), so the inter-group leg of the
    monitor exchange is the leg that crosses processes.  A CUDA tensor
    crosses through the host (gloo takes CPU tensors).  Worker ``r`` runs on
    ``cuda:{r % device_count}``, or on the CPU.
  * **rank 0** — prints one ``MP_BFS_JSON:`` payload (the JAX package's
    keys): the ``Graph500Run`` bookkeeping, the bitwise-parity verdict
    against the in-process single-device oracle, the modeled per-level wire
    bytes and the measured per-level exchange wall-clock
    (:func:`time_exchange_per_level`).

Acceptance is bitwise: without ``--inject`` every rung's parents (and SSSP
distances) must equal the oracle's; an injected fault must instead be
detected by the checks.

    PYTHONPATH=src python -m repro_torch.launch.multiprocess \\
        --procs 2 --devices-per-proc 2 --scale 12 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.multiprocess \\
        --procs 2 --devices-per-proc 2 --scale 10 --device cpu \\
        --inject exchange/zero/1/persistent --check full
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

_MARK = "MP_BFS_JSON:"

_SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the worker exits with this code at bring-up when its rank is named here
#: (the launcher's no-orphans test)
CRASH_ENV = "REPRO_TORCH_MP_CRASH_RANK"

#: torch threads of each worker (the CPU work beside the card is light; on
#: the CPU the workers share the cores)
WORKER_THREADS = 2

#: rung-name suffix per exchange wiring
EXCHANGE_SUFFIX = {"hier_or": "", "hier_or_packed": "_pack",
                   "hier_or_sieve": "_sieve", "hier_gather": "_gather",
                   "hier_min": "_min", "flat": "_flat"}


def rung_name(procs: int, dpp: int, exchange: str, partition: str,
              kernel: str = "bfs") -> str:
    """``mp_<procs>x<dpp>`` plus the exchange and partition suffixes (and a
    kernel prefix for kernels other than BFS)."""
    prefix = "" if kernel == "bfs" else f"{kernel}_"
    return (prefix + f"mp_{procs}x{dpp}" + EXCHANGE_SUFFIX[exchange]
            + ("_cyc" if partition == "word_cyclic" else ""))


def free_port() -> int:
    """An OS-assigned free localhost TCP port for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parent_digest(parent) -> str:
    """sha256 of a parent batch as contiguous int32."""
    import numpy as np

    a = np.ascontiguousarray(np.asarray(parent, dtype=np.int32))
    return hashlib.sha256(a.tobytes()).hexdigest()


def parse_inject(spec: Optional[str]):
    """``site/kind[/level[/persistent]]`` -> :class:`FaultSpec` (or None)."""
    if not spec:
        return None
    from repro_torch.core.faults import FaultSpec

    parts = spec.split("/")
    if len(parts) < 2:
        raise ValueError(f"--inject wants site/kind[/level[/persistent]], "
                         f"got {spec!r}")
    kw = dict(site=parts[0], kind=parts[1])
    if len(parts) > 2:
        kw["level"] = int(parts[2])
    if len(parts) > 3:
        kw["persistent"] = parts[3] == "persistent"
    return FaultSpec(**kw)


# ---------------------------------------------------------------------------
# Measured per-level exchange-leg timing
# ---------------------------------------------------------------------------

def time_exchange_per_level(compiled, level_row, *, reps: int = 3) -> dict:
    """Measured wall-clock of the per-level delta exchange, beside the byte
    model of ``modeled_wire_bytes``.

    A completed ``level`` row recovers each level's delta exactly (the
    vertices with ``level == t``); each level's payload is replayed through
    ``hybrid_bfs._exchange_delta`` over the compiled plan's mesh (across the
    processes under the multi-process runtime) and the min over ``reps`` of
    the host clock, synchronised, is kept.  Every rank calls this in
    lockstep (the exchange is a collective).
    """
    import numpy as np
    import torch

    from repro_torch.comms.mesh import VertexComm
    from repro_torch.core.hybrid_bfs import _exchange_delta

    sg, plan = compiled.graph.sharded, compiled.plan
    if sg is None:
        raise ValueError("exchange timing needs a vertex-sharded plan "
                         "(no ShardedGraph on this CompiledBFS)")
    w_loc, n_dev = sg.w_loc, sg.n_devices
    w_pad = n_dev * w_loc
    comm = VertexComm(compiled.mesh, 0)
    sieve = plan.exchange == "hier_or_sieve"
    level_row = np.asarray(level_row).reshape(-1)

    def words_of(verts):
        words = np.zeros(w_pad, np.uint32)
        np.bitwise_or.at(words, verts // 32,
                         np.uint32(1) << (verts % 32).astype(np.uint32))
        return words

    def on_device(words):
        return torch.from_numpy(words.view(np.int32).copy()).to(comm.device)

    def sync():
        if comm.device.type == "cuda":
            torch.cuda.synchronize(comm.device)

    depth = int(level_row.max()) if level_row.size else 0
    per_level, total = [], 0.0
    for t in range(1, depth + 1):
        verts = np.flatnonzero(level_row == t)
        words = words_of(verts)
        # owner map: block = contiguous W_loc words per shard; word_cyclic =
        # global word j on shard j % P
        view = (words.reshape(w_loc, n_dev).T if plan.partition == "word_cyclic"
                else words.reshape(n_dev, w_loc))
        deltas = [on_device(np.ascontiguousarray(view[d])) for d in comm.local]
        known = None
        if sieve:
            k = on_device(words_of(np.flatnonzero((level_row >= 0) & (level_row < t))))
            known = [k] * len(deltas)

        def once():
            _exchange_delta(comm, deltas, w_loc=w_loc, n_dev=n_dev,
                            exchange=plan.exchange, partition=plan.partition,
                            known=known)
            sync()

        if t == 1:
            once()      # warm-up
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            once()
            best = min(best, time.perf_counter() - t0)
        per_level.append({"level": t, "frontier": int(verts.size), "seconds": best})
        total += best
    return {"exchange": plan.exchange, "partition": plan.partition,
            "reps": reps, "levels": depth, "total_seconds": total,
            "per_level": per_level}


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

def _serialize_run(run) -> dict:
    """JSON-ready Graph500Run (inverse: :func:`_deserialize_run`)."""
    return {
        "teps": list(run.teps), "times_s": list(run.times_s),
        "edges": list(run.edges), "validated": list(run.validated),
        "batched": run.batched, "retries": run.retries,
        "fallbacks": run.fallbacks, "quarantined": list(run.quarantined),
        "check_counts": dict(run.check_counts),
        "check_failures": {str(k): v for k, v in run.check_failures.items()},
    }


def _deserialize_run(d: dict):
    from repro_torch.core.teps import Graph500Run

    run = Graph500Run(teps=list(d["teps"]), times_s=list(d["times_s"]),
                      edges=list(d["edges"]), validated=list(d["validated"]),
                      batched=d["batched"])
    run.retries = d["retries"]
    run.fallbacks = d["fallbacks"]
    run.quarantined = list(d["quarantined"])
    run.check_counts = dict(d["check_counts"])
    run.check_failures = {int(k): list(v) for k, v in d["check_failures"].items()}
    return run


def _worker(args) -> int:
    crash = os.environ.get(CRASH_ENV)
    if crash is not None and int(crash) == args.rank:
        print(f"rank {args.rank}: crashing on purpose ({CRASH_ENV})",
              file=sys.stderr, flush=True)
        return 17

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(WORKER_THREADS)
    rank, dpp = args.rank, args.devices_per_proc
    total = args.procs * dpp

    def log(msg):
        print(f"# rank {rank}: {msg}", file=sys.stderr, flush=True)

    dist.init_process_group("gloo", init_method=f"tcp://{args.coordinator}",
                            rank=rank, world_size=args.procs,
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        if args.device == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device(args.device)
        log(f"initialized: {dist.get_world_size()} processes x {dpp} shards "
            f"= {total}, on {device}")

        from repro_torch.core.bfs_steps import with_edge_weights
        from repro_torch.core.distributed_bfs import modeled_wire_bytes
        from repro_torch.core.plan import BFSPlan, compile_plan
        from repro_torch.core.tune import _build_inputs
        from repro_torch.kernels import ops

        fault = parse_inject(args.inject)
        kernel = args.kernel
        pg, degree, roots, v = _build_inputs(args.scale, args.seed, args.edge_factor,
                                             args.roots, device)
        if kernel == "sssp":
            pg.ev = with_edge_weights(pg.ev, seed=args.seed)

        # the in-process single-device oracle, on every rank
        oracle = compile_plan(BFSPlan(layout=(), batch_roots=True, kernel=kernel), pg,
                              device=device)
        oracle_res = oracle.bfs(roots)
        oracle_parent = oracle_res.parent[:, :v].cpu().numpy()
        oracle_level = oracle_res.level[:, :v].cpu().numpy()
        log(f"single-device {kernel} oracle solved")

        exchanges = [e.strip() for e in args.exchanges.split(",") if e.strip()]
        if kernel == "sssp":
            exchanges = ["hier_min" if e == "hier_or" else e for e in exchanges]
        partitions = [p.strip() for p in args.partitions.split(",") if p.strip()]
        rungs: dict = {}
        all_identical = True
        for partition in partitions:
            for exchange in exchanges:
                name = rung_name(args.procs, dpp, exchange, partition, kernel)
                plan = BFSPlan(layout=("group", "member"), mesh_shape=(args.procs, dpp),
                               exchange=exchange, partition=partition, kernel=kernel)
                compiled = compile_plan(plan, pg, device=device, fault=fault)
                assert compiled.mesh.world == args.procs, \
                    "mesh does not span the worker processes"
                ops.reset_launch_counts()
                result = compiled.run(roots, check=args.check, retries=args.retries,
                                      fallback=args.fallback)
                launches = ops.launch_counts()
                run = result.run
                identical = bool(
                    np.array_equal(result.parent[:, :v], oracle_parent)
                    and (kernel != "sssp"
                         or np.array_equal(result.level[:, :v], oracle_level)))
                all_identical &= identical
                if fault is None and not identical:
                    raise AssertionError(
                        f"{name}: results diverge from the single-device oracle "
                        f"across the process boundary (procs={args.procs} x {dpp})")
                if fault is not None and not run.check_counts:
                    raise AssertionError(f"{name}: fault injected but no check ran: "
                                         f"use --check post|full")
                # the byte model and the replay rebuild per-level BFS deltas
                # from the level row; SSSP rounds pop buckets, not levels
                wire = (modeled_wire_bytes(
                            result.level[0], n_devices=total,
                            w_loc=compiled.graph.sharded.w_loc, group=args.procs,
                            member=dpp, partition=partition)
                        if kernel == "bfs" else None)
                exch_s = (time_exchange_per_level(compiled, result.level[0],
                                                  reps=args.reps)
                          if fault is None and kernel == "bfs" else None)
                rungs[name] = {
                    "mesh": f"{args.procs}x{dpp}",
                    "layer": "multiprocess",
                    "kernel": kernel,
                    "procs": args.procs,
                    "devices_per_proc": dpp,
                    "plan": plan.to_dict(),
                    "wall_us": float(np.sum(run.times_s)) * 1e6,
                    "per_root_us": float(np.mean(run.times_s)) * 1e6,
                    "harmonic_mean_teps": run.harmonic_mean_teps,
                    "n_roots": len(roots),
                    "identical": identical,
                    "parent_sha256": parent_digest(result.parent[:, :v]),
                    "validated": run.all_valid,
                    "check_counts": run.check_counts,
                    "wire_bytes": wire,
                    "exchange_seconds": exch_s,
                    "g500": _serialize_run(run),
                    # this rank's kernel launches during the timed run
                    "kernel_launches": launches,
                }
                it = (f"inter_raw={wire['totals']['inter_raw']}B "
                      f"exch_s={exch_s['total_seconds']:.6f}" if exch_s
                      else f"check_counts={run.check_counts}")
                log(f"{name}: identical={identical} "
                    f"hmean={run.harmonic_mean_teps:.6e} {it}")

        payload = {
            "procs": args.procs,
            "devices_per_proc": dpp,
            "kernel": kernel,
            "scale": args.scale,
            "seed": args.seed,
            "n_roots": len(roots),
            "backend": device.type,
            "jax": None,                    # the port runs no JAX
            "torch": torch.__version__,
            "interpret_mode": device.type == "cpu",
            "check": args.check,
            "inject": args.inject or None,
            "parents_bitwise_identical": all_identical,
            "oracle_sha256": parent_digest(oracle_parent),
            "rungs": rungs,
        }
        if rank == 0:
            print(_MARK + json.dumps(payload), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Parent: spawn, babysit, collect
# ---------------------------------------------------------------------------

def _kill_all(workers) -> None:
    for p in workers:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 5.0
    for p in workers:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            p.kill()
    for p in workers:
        try:
            p.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            pass


def _log_tail(path: str, n: int = 2000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return "<no log>"


def launch(procs: int, devices_per_proc: int, *, scale: int = 12,
           n_roots: int = 8, seed: int = 1, edge_factor: int = 16,
           exchanges: str = "hier_or", partitions: str = "block",
           check: str = "post", retries: int = 0, fallback: bool = False,
           inject: Optional[str] = None, reps: int = 3,
           log_dir: Optional[str] = None, timeout_s: float = 1800.0,
           kernel: str = "bfs", device: str = "cuda") -> dict:
    """Spawn the worker gang, wait, and return rank 0's payload.

    One log and one pid file per rank land in ``log_dir`` (a new temporary
    directory by default).  Any rank exiting nonzero, or ``timeout_s``
    passing, kills every surviving rank (terminate, then kill) before this
    raises.  ``device`` is ``"cuda"`` (worker ``r`` on card ``r % count``;
    the kernels are built here first) or ``"cpu"``.
    """
    log_dir = log_dir or tempfile.mkdtemp(prefix="repro_torch_mp_")
    os.makedirs(log_dir, exist_ok=True)
    if device == "cuda":
        from repro_torch.kernels import _build
        from repro_torch.util import resolve_device

        resolve_device("cuda")
        _build.build_all()
    port = free_port()
    common = [
        sys.executable, "-m", "repro_torch.launch.multiprocess", "--worker",
        "--coordinator", f"127.0.0.1:{port}",
        "--procs", str(procs), "--devices-per-proc", str(devices_per_proc),
        "--scale", str(scale), "--roots", str(n_roots), "--seed", str(seed),
        "--edge-factor", str(edge_factor), "--exchanges", exchanges,
        "--partitions", partitions, "--check", check, "--retries", str(retries),
        "--reps", str(reps), "--kernel", kernel, "--device", device,
        "--timeout", str(timeout_s),
    ]
    if fallback:
        common.append("--fallback")
    if inject:
        common += ["--inject", inject]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])

    workers, logs, log_files = [], [], []
    try:
        for rank in range(procs):
            log_path = os.path.join(log_dir, f"rank{rank}.log")
            lf = open(log_path, "w")
            p = subprocess.Popen(common + ["--rank", str(rank)], env=env,
                                 stdout=lf, stderr=lf, text=True)
            with open(os.path.join(log_dir, f"rank{rank}.pid"), "w") as f:
                f.write(str(p.pid))
            workers.append(p)
            logs.append(log_path)
            log_files.append(lf)

        deadline = time.time() + timeout_s
        while True:
            codes = [p.poll() for p in workers]
            bad = [(i, rc) for i, rc in enumerate(codes) if rc is not None and rc != 0]
            if bad:
                _kill_all(workers)
                tails = "\n".join(f"--- rank {i} (exit {rc}) ---\n{_log_tail(logs[i])}"
                                  for i, rc in bad)
                raise RuntimeError(f"multiprocess worker(s) failed "
                                   f"({procs}x{devices_per_proc}, logs in "
                                   f"{log_dir}):\n{tails}")
            if all(rc == 0 for rc in codes):
                break
            if time.time() > deadline:
                alive = [i for i, rc in enumerate(codes) if rc is None]
                _kill_all(workers)
                raise RuntimeError(
                    f"multiprocess launch timed out after {timeout_s:.0f}s "
                    f"(ranks still running: {alive}; logs in {log_dir}):\n"
                    f"{_log_tail(logs[alive[0]] if alive else logs[0])}")
            time.sleep(0.2)
    finally:
        # whatever path leaves this block, nothing spawned here survives it
        _kill_all(workers)
        for lf in log_files:
            lf.close()

    payload = None
    with open(logs[0]) as f:
        for line in f:
            if line.startswith(_MARK):
                payload = json.loads(line[len(_MARK):])
    if payload is None:
        raise RuntimeError(f"rank 0 exited 0 but printed no payload marker "
                           f"(log: {logs[0]}):\n{_log_tail(logs[0])}")
    payload["log_dir"] = log_dir
    return payload


def run_config(cfg, built=None):
    """:class:`~repro_torch.core.pipeline.Graph500Config` adapter: run the
    config's traversal on ``cfg.procs`` processes and return ``(built,
    Graph500Run)`` like ``pipeline.run``: the parent builds the graph for
    the caller, the workers build it again from the config (same seed, same
    device type, same bits) and rank 0's bookkeeping comes back."""
    from repro_torch.core import pipeline

    built = built or pipeline.build(cfg)
    dpp = cfg.devices_per_proc or 1
    exchange = cfg.exchange
    if cfg.kernel == "sssp" and exchange == "hier_or":
        exchange = "hier_min"
    payload = launch(
        cfg.procs, dpp, scale=cfg.scale, n_roots=cfg.n_roots, seed=cfg.seed,
        edge_factor=cfg.edge_factor, exchanges=exchange, partitions=cfg.partition,
        check=cfg.check, retries=cfg.retries, fallback=cfg.fallback,
        kernel=cfg.kernel, device=cfg.device or "cuda")
    name = rung_name(cfg.procs, dpp, exchange, cfg.partition, cfg.kernel)
    return built, _deserialize_run(payload["rungs"][name]["g500"])


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-process vertex-sharded BFS/SSSP launcher (gloo)")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--roots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--kernel", default="bfs", choices=("bfs", "sssp"))
    ap.add_argument("--exchanges", default="hier_or",
                    help="comma list of exchange wirings to run")
    ap.add_argument("--partitions", default="block",
                    help="comma list of vertex partitions to run")
    ap.add_argument("--check", default="post", choices=("off", "post", "full"))
    ap.add_argument("--retries", type=int, default=0)
    ap.add_argument("--fallback", action="store_true")
    ap.add_argument("--inject", default=None,
                    help="FaultSpec site/kind[/level[/persistent]]")
    ap.add_argument("--reps", type=int, default=3,
                    help="min-over-reps of the exchange timing")
    ap.add_argument("--log-dir", default=None,
                    help="per-rank log/pid directory (default: a temp dir)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="wall-clock deadline of the worker gang")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # worker plumbing, set by the parent
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker:
        return _worker(args)

    payload = launch(
        args.procs, args.devices_per_proc, scale=args.scale, n_roots=args.roots,
        seed=args.seed, edge_factor=args.edge_factor, exchanges=args.exchanges,
        partitions=args.partitions, check=args.check, retries=args.retries,
        fallback=args.fallback, inject=args.inject, reps=args.reps,
        log_dir=args.log_dir, timeout_s=args.timeout, kernel=args.kernel,
        device=args.device)
    for name, rung in payload["rungs"].items():
        exch = rung.get("exchange_seconds")
        extra = (f"exchange_total={exch['total_seconds']:.6f}s levels={exch['levels']}"
                 if exch else f"check_counts={rung['check_counts']}")
        wire = rung.get("wire_bytes")
        raw = f"inter_raw={wire['totals']['inter_raw']}B " if wire else ""
        print(f"# {name}: identical={rung['identical']} "
              f"hmean_TEPS={rung['harmonic_mean_teps']:.6e} {raw}{extra}",
              file=sys.stderr)
    print(_MARK + json.dumps(payload), flush=True)
    if args.inject is None and not payload["parents_bitwise_identical"]:
        print("# FAIL: parents not bitwise-identical to the oracle", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
