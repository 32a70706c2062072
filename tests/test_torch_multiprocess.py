"""The port's multi-process launcher: gloo processes on the CPU.

One gang of 2 processes x 2 member shards runs both partitions at scale 10:
every rung's parent digest must equal the in-worker single-device oracle and
an in-process virtual (2, 2) run.  A worker that dies at bring-up must take
the gang down with it (no orphaned pid), and an ``exchange`` fault injected
across the processes must be detected.  The helpers behave like JAX's.
"""
import importlib
import os
import socket
import time

import numpy as np
import pytest
import torch

from repro_torch.comms.mesh import make_mesh
from repro_torch.core import pipeline
from repro_torch.core.plan import BFSPlan, compile_plan
from repro_torch.core.tune import _build_inputs
from repro_torch.launch import multiprocess as mp

jmp = importlib.import_module("repro.launch.multiprocess")
torch.set_num_threads(2)

SCALE = 10
ROOTS = 4


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def test_helpers_equal_to_jax():
    for args in ((2, 4, "hier_or", "block"), (4, 2, "hier_or_packed", "word_cyclic"),
                 (2, 2, "hier_or_sieve", "block"), (2, 2, "hier_min", "block", "sssp"),
                 (3, 1, "flat", "word_cyclic", "sssp"), (2, 2, "hier_gather", "block")):
        assert mp.rung_name(*args) == jmp.rung_name(*args)
    assert mp.EXCHANGE_SUFFIX == jmp.EXCHANGE_SUFFIX
    for spec in ("exchange/zero/1/persistent", "codec/wrong_mode/2", "sieve/stale",
                 None, ""):
        got, want = mp.parse_inject(spec), jmp.parse_inject(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.site, got.kind, got.level, got.persistent) == \
                (want.site, want.kind, want.level, want.persistent)
    with pytest.raises(ValueError, match="site/kind"):
        mp.parse_inject("exchange")
    port = mp.free_port()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", port))
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert mp.parent_digest(rows) == jmp.parent_digest(rows)


def test_two_procs_equal_in_process_virtual_mesh_both_partitions(tmp_path):
    payload = mp.launch(2, 2, scale=SCALE, n_roots=ROOTS, reps=1,
                        partitions="block,word_cyclic", device="cpu",
                        log_dir=str(tmp_path / "logs"), timeout_s=600.0)
    assert payload["parents_bitwise_identical"] is True
    assert set(payload["rungs"]) == {"mp_2x2", "mp_2x2_cyc"}
    assert payload["backend"] == "cpu" and payload["jax"] is None
    pg, _, roots, v = _build_inputs(SCALE, 1, 16, ROOTS, "cpu")
    for name, part in (("mp_2x2", "block"), ("mp_2x2_cyc", "word_cyclic")):
        rung = payload["rungs"][name]
        assert rung["identical"] and rung["validated"], name
        assert rung["parent_sha256"] == payload["oracle_sha256"], name
        # the in-process virtual (2, 2) mesh lands on the same bits
        res = compile_plan(BFSPlan(layout=("group", "member"), partition=part), pg,
                           device="cpu", mesh=make_mesh((2, 2), ("group", "member"),
                                                        device="cpu", virtual=True)
                           ).run(roots, check="post")
        assert mp.parent_digest(res.parent) == rung["parent_sha256"], name
        # measured exchange seconds beside the modeled bytes
        exch = rung["exchange_seconds"]
        assert exch["levels"] == rung["wire_bytes"]["levels"] > 0
        assert all(lv["seconds"] > 0.0 for lv in exch["per_level"])


def test_worker_crash_kills_gang_no_orphans(tmp_path, monkeypatch):
    log_dir = tmp_path / "logs"
    monkeypatch.setenv(mp.CRASH_ENV, "1")
    with pytest.raises(RuntimeError, match="exit 17"):
        mp.launch(2, 2, scale=8, n_roots=2, device="cpu", log_dir=str(log_dir),
                  timeout_s=600.0)
    pids = [int((log_dir / f"rank{r}.pid").read_text()) for r in range(2)]
    deadline = time.time() + 10.0
    while time.time() < deadline and any(_pid_alive(p) for p in pids):
        time.sleep(0.1)
    assert not [p for p in pids if _pid_alive(p)]


def test_exchange_fault_detected_across_processes(tmp_path):
    payload = mp.launch(2, 2, scale=SCALE, n_roots=2, check="full", device="cpu",
                        inject="exchange/zero/1/persistent",
                        log_dir=str(tmp_path / "logs"), timeout_s=600.0)
    rung = payload["rungs"]["mp_2x2"]
    g500 = rung["g500"]
    assert rung["check_counts"]["sentinel"] > 0 and g500["check_failures"]
    assert rung["validated"] is False and not rung["identical"]


def test_pipeline_run_with_procs_delegates_to_the_launcher(monkeypatch):
    seen = {}

    def fake_launch(procs, dpp, **kw):
        seen.update(procs=procs, dpp=dpp, **kw)
        run = {"teps": [1.0], "times_s": [0.5], "edges": [3], "validated": [True],
               "batched": True, "retries": 0, "fallbacks": 0, "quarantined": [],
               "check_counts": {"root": 0}, "check_failures": {}}
        return {"rungs": {mp.rung_name(procs, dpp, "hier_min", "word_cyclic", "sssp"):
                          {"g500": run}}}

    monkeypatch.setattr(mp, "launch", fake_launch)
    cfg = pipeline.Graph500Config(scale=8, n_roots=1, procs=3, devices_per_proc=2,
                                  kernel="sssp", partition="word_cyclic", device="cpu")
    built, run = pipeline.run(cfg)
    assert built.n_vertices == 256 and run.all_valid and run.teps == [1.0]
    assert (seen["procs"], seen["dpp"], seen["exchanges"], seen["partitions"],
            seen["kernel"], seen["device"]) == (3, 2, "hier_min", "word_cyclic",
                                                "sssp", "cpu")
    with pytest.raises(ValueError, match="neither roots nor mesh"):
        pipeline.run(cfg, roots=[0])
