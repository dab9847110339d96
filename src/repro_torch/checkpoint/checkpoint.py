"""Fault-tolerant checkpointing: atomic and async (the port's copy of
``checkpoint/checkpoint.py``), in the reference's on-disk layout:

    ckpt_dir/
      step_00000123/
        manifest.json          # {"step", "extra", "leaves": {path: {file, shape, dtype}}}
        leaf_00000.npy ...
      step_00000123.COMMITTED  # marker written LAST

A leaf's path joins its dict keys with ``/`` (sorted, as the reference
walks them); the port's params also hold lists (one dict a layer), whose
entries take their index as the key (``layers/0/attn/wq``), and the
manifest lists those list nodes under ``"lists"`` so that ``restore``
rebuilds them. The reference reads only ``"leaves"`` and ``"extra"``: a
port checkpoint restores there with each list as a dict keyed "0", "1",
..., and a reference checkpoint (dicts only) restores here as written.

* atomicity: the step directory is written as ``.tmp`` and renamed, and
  a checkpoint without its COMMITTED marker is ignored;
* async: ``save_async`` copies every leaf to host memory before it
  returns (an in-place update after it cannot reach the file) and writes
  on a background thread;
* leaves numpy cannot hold (bfloat16) raise; nothing is cast quietly;
* ``restore`` puts the leaves on ``device`` (the card unless the caller
  asks for the CPU); re-sharding onto a mesh (``shardings``) waits for
  ROADMAP A17;
* retention: ``gc_keep_last`` prunes old steps, never the newest.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "gc_keep_last",
           "wait_for_pending"]

_pending: list[threading.Thread] = []


def _flatten_with_paths(tree) -> tuple[list, list[str]]:
    """``([(path, leaf)], [paths of list nodes])``: dicts by sorted key,
    lists by index."""
    leaves: list = []
    lists: list[str] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, list):
            lists.append("/".join(path))
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            leaves.append(("/".join(path), t))

    walk(tree, ())
    return leaves, lists


def _unflatten(paths_vals, lists=()):
    tree: dict = {}
    for path, val in paths_vals:
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(t, path):
        if not isinstance(t, dict):
            return t
        t = {k: rebuild(v, f"{path}/{k}" if path else k) for k, v in t.items()}
        if path in lists:
            return [t[str(i)] for i in range(len(t))]
        return t

    return rebuild(tree, "")


def _to_numpy(val) -> np.ndarray:
    """A host copy of ``val``; bfloat16 (which numpy cannot hold) raises."""
    if isinstance(val, torch.Tensor):
        if val.dtype == torch.bfloat16:
            raise TypeError("checkpoint: a bfloat16 leaf has no numpy dtype; cast it "
                            "to float32 before saving")
        return val.detach().cpu().numpy().copy()
    return np.array(val)


def save(ckpt_dir, step: int, tree, extra: dict | None = None) -> Path:
    """Synchronous atomic save of a tree of tensors or arrays."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step_name = f"step_{step:08d}"
    tmp = ckpt_dir / (step_name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves, lists = _flatten_with_paths(tree)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    if lists:
        manifest["lists"] = lists
    for i, (path, val) in enumerate(leaves):
        arr = _to_numpy(val)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][path] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = ckpt_dir / step_name
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic dir rename
    marker = ckpt_dir / (step_name + ".COMMITTED")
    marker.write_text(str(time.time()))        # marker LAST
    return final


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    return _to_numpy(tree)


def save_async(ckpt_dir, step: int, tree, extra: dict | None = None) -> threading.Thread:
    """Copy every leaf to host now; write on a background thread."""
    host_tree = _host_tree(tree)
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree, extra),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_for_pending() -> None:
    for t in list(_pending):
        t.join()
        _pending.remove(t)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for marker in ckpt_dir.glob("step_*.COMMITTED"):
        name = marker.name.replace(".COMMITTED", "")
        if (ckpt_dir / name / "manifest.json").exists():
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir, step: int | None = None, device="cuda", shardings=None):
    """``(tree, extra, step)``: the tree of ``step`` (the latest COMMITTED
    by default) as tensors on ``device``. ``shardings`` (the reference's
    re-sharding onto a mesh) raises: the mesh waits for ROADMAP A17."""
    if shardings is not None:
        raise NotImplementedError("restore onto a mesh (shardings) waits for the "
                                  "mesh layer: ROADMAP A17")
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    pairs = [(path, torch.from_numpy(np.load(d / meta["file"])).to(device))
             for path, meta in manifest["leaves"].items()]
    return _unflatten(pairs, set(manifest.get("lists", ()))), manifest["extra"], step


def gc_keep_last(ckpt_dir, keep: int = 3) -> list[int]:
    """Prune old checkpoints; never removes the newest COMMITTED step."""
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(
        int(m.name.replace(".COMMITTED", "").split("_")[1])
        for m in ckpt_dir.glob("step_*.COMMITTED"))
    removed = []
    for s in steps[:-keep] if keep else steps:
        name = f"step_{s:08d}"
        (ckpt_dir / (name + ".COMMITTED")).unlink(missing_ok=True)
        shutil.rmtree(ckpt_dir / name, ignore_errors=True)
        removed.append(s)
    return removed
