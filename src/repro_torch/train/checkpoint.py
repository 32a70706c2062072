"""Fault-tolerant checkpointing: the port of ``repro.train.checkpoint``, in
its on-disk format, so each package restores the other's checkpoints.

  * exact resume: restoring mid-run reproduces the uninterrupted run bit
    for bit;
  * elastic: checkpoints hold logical (unsharded) arrays under their pytree
    paths, so they restore onto any device or mesh (``elastic.py``);
  * atomic: written to ``<dir>/.tmp-<step>``, then renamed to
    ``step_<step:010d>``, so a crash mid-save never corrupts the latest;
  * retention: the newest ``keep`` checkpoints are kept.

A checkpoint is ``arrays.npz`` (keys are the pytree paths joined by ``|``)
and ``manifest.json`` (``step``, ``time``, sorted ``keys``, ``shapes``,
``dtypes``, ``extra``).  A tree is nested dicts (keys sorted, as JAX
flattens them; a path-keyed parameter mapping nests its ``/`` paths),
named tuples (``AdamWState``: ``step``, ``m``, ``v``), lists and tensors:
``{"params": ..., "opt": AdamWState(...)}`` gives the keys
``params/table``, ``opt/m/cin/0/w`` and ``opt/step``, as the JAX package
writes them.  bfloat16, which numpy lacks, is stored as a uint16 bit-view
with its name in the manifest, without ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch.optim.optimizer import leaf_order

SEP = "/"

#: torch dtypes numpy has no type for: (manifest name, bit-view int dtype)
_BITVIEW = {torch.bfloat16: ("bfloat16", torch.int16)}
_BY_NAME = {name: (dt, iv) for dt, (name, iv) in _BITVIEW.items()}


def _items(tree: Any):
    """(path, leaf) pairs of ``tree`` in the JAX package's leaf order."""
    if isinstance(tree, torch.Tensor):
        yield "", tree
    elif isinstance(tree, dict):
        for k in leaf_order(tree):
            for sub, leaf in _items(tree[k]):
                yield (str(k) + SEP + sub) if sub else str(k), leaf
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            for sub, leaf in _items(getattr(tree, k)):
                yield (k + SEP + sub) if sub else k, leaf
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for sub, leaf in _items(v):
                yield (str(i) + SEP + sub) if sub else str(i), leaf
    else:
        raise TypeError(f"checkpoint leaves must be tensors, got {type(tree)}")


def _rebuild(tree: Any, leaves: dict, prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    join = (lambda k: prefix + SEP + str(k)) if prefix else str
    if isinstance(tree, torch.Tensor):
        return leaves[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), leaves, join(k))
                            for k in tree._fields))
    return type(tree)(_rebuild(v, leaves, join(i)) for i, v in enumerate(tree))


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array npz stores, the logical dtype's name)."""
    t = t.detach().cpu()
    if t.dtype in _BITVIEW:
        name, iv = _BITVIEW[t.dtype]
        arr = t.view(iv).numpy()
        return arr.view(np.dtype(f"u{arr.itemsize}")), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _BY_NAME:
        dt, iv = _BY_NAME[name]
        return torch.from_numpy(arr.view(np.dtype(f"i{arr.itemsize}")).copy()) \
            .view(iv).view(dt)
    return torch.from_numpy(arr.astype(np.dtype(name)))


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically persist ``tree`` at ``step``. Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {}
    dtypes = {}
    for key, leaf in _items(tree):
        flat[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace(SEP, "|"): v for k, v in flat.items()})
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Any, step: int | None = None,
            device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    takes its ``like`` leaf's dtype and device, or ``device`` when given
    (the elastic path).  Returns ``(tree, manifest)``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = dict(_items(like))
    missing = set(like_leaves) - set(manifest["keys"])
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in like_leaves.items():
            t = _from_numpy(data[key.replace(SEP, "|")], manifest["dtypes"][key])
            out[key] = t.to(device=leaf.device if device is None else device,
                            dtype=leaf.dtype)
    return _rebuild(like, out), manifest
