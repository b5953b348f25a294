"""Checkpoints as npz + a JSON manifest, with an async writer (torch
counterpart of repro/checkpoint/store.py, in the same on-disk format, so
that either package loads what the other wrote).

Layout (one directory per step):

    ckpt_dir/step_00000120/
        manifest.json     - tree structure, shapes, dtypes, extra
        shard_host0.npz   - every leaf, full (one host)

A step directory is written as ``step_XXXXXXXX.tmp`` and renamed when
complete, so a partial write never looks valid.  npz cannot hold
bfloat16, so a bfloat16 leaf is stored as its uint16 bit pattern with the
dtype's name in the manifest (float8 leaves likewise as uint8); loading
turns the pattern back into a tensor without ``ml_dtypes``.  Lists in a
tree are stored as dicts keyed "0", "1", ... and load as such, as in the
reference.

``AsyncCheckpointer.save`` copies every leaf to host memory on the calling
thread (so later updates of device tensors cannot leak into it) and
writes the npz on a worker thread, with at most ``max_pending`` saves in
flight.

On a mesh, ``save_checkpoint(..., mesh=, specs=)`` gathers every leaf
whole over the axes its spec names (a collective on every rank) and rank 0
writes it, so the files are the reference's full arrays;
``load_checkpoint(..., mesh=, specs=)`` restores onto any mesh by cutting
each leaf to the rank's block (specs in the checkpoint's own layout, e.g.
``models.convert.specs_to_reference``)."""
from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import from_numpy, to_numpy, tree_map

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "AsyncCheckpointer"]

_SEP = "/"


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + [str(i)])
        else:
            flat[_SEP.join(path)] = node

    rec(tree, [])
    return flat


def _unflatten_from_paths(manifest_tree, flat: Dict[str, Any]):
    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + [k]) for k, v in node.items()}
        return flat[_SEP.join(path)]

    return rec(manifest_tree, [])


def _tree_skeleton(tree):
    if isinstance(tree, dict):
        return {k: _tree_skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _tree_skeleton(v) for i, v in enumerate(tree)}
    return None


def _to_savable(v) -> Tuple[np.ndarray, str]:
    """(array npz can hold, dtype name): tensors through ``to_numpy``;
    numpy arrays of an ml_dtypes type (bfloat16, float8) as bit patterns."""
    if isinstance(v, torch.Tensor):
        return to_numpy(v)
    a = np.asarray(v)
    name = a.dtype.name
    if name == "bfloat16":
        return a.view(np.uint16), name
    if name not in np.sctypeDict and a.dtype.itemsize == 1:  # fp8 family
        return a.view(np.uint8), name
    return a, name


def _spec_paths(specs) -> Dict[str, Any]:
    """path -> spec tuple (a spec is a leaf, unlike a tree's tuples)."""
    flat = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + [str(k)])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                rec(v, path + [str(i)])
        else:
            flat[_SEP.join(path)] = tuple(node)

    rec(specs, [])
    return flat


def _leaf_specs(flat: Dict[str, Any], specs) -> Dict[str, Any]:
    """path -> spec for every leaf of ``flat``; a leaf without a spec, or a
    spec without a leaf, raises (a shard must never pass for a whole array)."""
    flat_s = _spec_paths(specs)
    if set(flat_s) != set(flat):
        raise ValueError(f"the specs do not match the tree: leaves without a spec "
                         f"{sorted(set(flat) - set(flat_s))}, specs without a leaf "
                         f"{sorted(set(flat_s) - set(flat))}")
    return flat_s


def _with_specs(tree, specs, fn):
    flat = _flatten_with_paths(tree)
    flat_s = _leaf_specs(flat, specs)
    flat = {k: fn(v, flat_s[k]) for k, v in flat.items()}
    return _unflatten_from_paths(_tree_skeleton(tree), flat)


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None, mesh=None,
                    specs=None) -> Optional[str]:
    """Synchronous save of a tree of tensors or arrays: npz + manifest,
    published atomically.  Returns the step directory.  With a mesh the
    leaves are rank blocks under ``specs`` (one for every leaf): gathered
    whole on every rank, written by rank 0 (None elsewhere)."""
    if mesh is not None and mesh.size > 1:
        from repro_torch.models.lm import unshard_leaf
        tree = _with_specs(tree, specs, lambda v, sp: v if not sp else unshard_leaf(v, sp, mesh))
        if mesh.rank != 0:
            return None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    saved = {k: _to_savable(v) for k, v in _flatten_with_paths(tree).items()}
    np.savez(os.path.join(tmp, "shard_host0.npz"), **{k: v[0] for k, v in saved.items()})
    manifest = {
        "step": step,
        "tree": _tree_skeleton(tree),
        "dtypes": {k: v[1] for k, v in saved.items()},
        "shapes": {k: list(v[0].shape) for k, v in saved.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, d)
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", n))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, device="cuda", mesh=None,
                    specs=None) -> Tuple[int, Any, dict]:
    """(step, tree of tensors on ``device``, extra) of ``step`` (the latest
    when None).  Leaves are stored whole, so any device takes them; with
    a mesh and ``specs`` (one for every leaf) each leaf is cut to the
    rank's block (the reference's resharding restore)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_host0.npz")) as z:
        flat = {k: from_numpy(z[k], manifest["dtypes"][k], device) for k in z.files}
    if mesh is not None and specs is not None:
        from repro_torch.models.lm import shard_leaf
        flat_s = _leaf_specs(flat, specs)
        flat = {k: shard_leaf(v, flat_s[k], mesh) if flat_s[k] else v for k, v in flat.items()}
    return step, _unflatten_from_paths(manifest["tree"], flat), manifest.get("extra", {})


def _snapshot(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return np.array(v, copy=True)


class AsyncCheckpointer:
    """Background writer with a bounded queue; ``save`` returns once the
    leaves are in host memory."""

    def __init__(self, ckpt_dir: str, max_pending: int = 2):
        self.ckpt_dir = ckpt_dir
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
            except BaseException as e:  # surfaced on the next save / wait
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree, extra: Optional[dict] = None):
        if self._err:
            raise self._err
        self._q.put((step, tree_map(_snapshot, tree), extra))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=10)
