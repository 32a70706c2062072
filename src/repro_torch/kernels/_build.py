"""Build and load the hand-written CUDA kernels (route: nvcc -> ctypes).

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
The libraries live under ``build/torch_kernels/<hash>/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of every source and of
the compiler flags, so an edited source never loads a stale library.

The build runs at first use, never at import: the CPU tests import every
module of the package on machines without ``nvcc``.  All sources compile in
parallel (one ``nvcc`` process each, started together).  Nothing here falls
back to a plain PyTorch version: a missing compiler or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: Seconds the last build took (0.0 when every library was already built)
#: and the ptxas register/shared-memory report per source.
build_info: dict = {"seconds": None, "ptxas": {}, "dir": None}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    cands += [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += ["/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch cannot be built on this machine")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build_all() -> None:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    build_info["dir"] = str(out_dir)
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, p in procs:
            log, _ = p.communicate()
            (out_dir / f"{src.stem}.log").write_text(log)
            build_info["ptxas"][src.stem] = log
            if p.returncode != 0:
                failed.append(f"{src.name} (exit {p.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            # atomic publish: a concurrent loader never sees a partial file
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (building every
    source on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                _build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_all() -> float:
    """Build (if needed) and load every kernel library; returns seconds."""
    with _lock:
        _build_all()
    for src in _sources():
        library(src.stem)
    return float(build_info["seconds"])


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` is a plain integer that grows by one for every launch that
    the CUDA runtime accepted; a non-zero ``cudaError_t`` from the entry
    point raises instead.
    """

    def __init__(self, lib_name: str, symbol: str, argtypes: list):
        self.lib_name = lib_name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.lib_name), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA launch failed with cudaError_t {err}")
        self.launches += 1
