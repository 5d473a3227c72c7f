"""Atomic, async checkpointing of nested trees of tensors (dependency-free).

Layout (one directory per step), the JAX package's own:
    ckpt_dir/step_000100/
        manifest.json      — tree structure, shapes, dtypes, leaf paths
        leaf_00000.npy     — one array per leaf (np.save)
        COMMIT             — written LAST; a checkpoint without it is torn
                             and ignored by `latest_step` (crash safety)

A tree is nested dicts, lists, tuples and NamedTuples of tensors, numpy
arrays or scalars.  Leaves are numbered in the JAX package's pytree order —
dict keys sorted, lists and tuples in order, NamedTuples (`AdamState`)
positionally, `None` holding no leaf — so a directory written by either
package restores into the other.  bfloat16 leaves are stored as their
uint16 bits, with "bfloat16" in the manifest, as JAX stores them.

Properties the tests assert:
  * atomic: a crash mid-save leaves a directory without COMMIT, and
    `latest_step` picks the previous committed step;
  * bit-exact: save/restore round-trips every leaf exactly;
  * device-elastic: leaves are stored as host arrays, and
    `restore(device=...)` puts them on any device;
  * async: `save_async` copies to the host synchronously, then writes on a
    background thread.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "CheckpointManager",
           "tree_flatten", "tree_unflatten", "to_host"]

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree: PyTree) -> tuple[list, list[str]]:
    """(leaves, paths) in the JAX package's pytree order; a path is the
    '/'-joined dict keys, sequence indices and NamedTuple field names
    (`jax.tree_util.tree_flatten_with_path`'s, as the JAX checkpoint
    writes them)."""
    leaves, paths = [], []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif _is_namedtuple(node):
            for name, child in zip(node._fields, node):
                walk(child, path + (name,))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            leaves.append(node)
            paths.append("/".join(path) or "root")
    walk(tree, ())
    return leaves, paths


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """The structure of `like` filled from `leaves` (in `tree_flatten`
    order)."""
    it = iter(leaves)

    def fill(node):
        if node is None:
            return None
        if isinstance(node, dict):
            filled = {k: fill(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(fill(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(fill(c) for c in node)
        return next(it)
    return fill(like)


def _describe(node) -> str:
    """A readable structure string for the manifest (never read back)."""
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(node[k])}"
                               for k in sorted(node)) + "}"
    if _is_namedtuple(node):
        return (f"{type(node).__name__}("
                + ", ".join(_describe(c) for c in node) + ")")
    if isinstance(node, list):
        return "[" + ", ".join(_describe(c) for c in node) + "]"
    if isinstance(node, tuple):
        return "(" + ", ".join(_describe(c) for c in node) + ")"
    return "*"


def _host_leaf(leaf):
    """A leaf as a host numpy array: a tensor is COPIED (a CPU tensor too,
    which `.cpu()` alone would share); bfloat16 stays a CPU tensor, since
    numpy has no such type.  Numpy leaves are taken as they are."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def to_host(tree: PyTree) -> PyTree:
    """Every tensor leaf copied to the host (as a numpy array; bfloat16 as
    a CPU tensor).  What a background writer may read while the caller
    goes on mutating its own tensors in place."""
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [_host_leaf(x) for x in leaves])


def save(ckpt_dir: str | Path, step: int, tree: PyTree) -> Path:
    """Synchronous atomic save."""
    return _write(Path(ckpt_dir), step, to_host(tree))


def _write(ckpt_dir: Path, step: int, host_tree: PyTree) -> Path:
    d = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, paths = tree_flatten(host_tree)
    manifest = {"step": step, "treedef": f"PyTreeDef({_describe(host_tree)})",
                "leaves": []}
    for i, (leaf, p) in enumerate(zip(leaves, paths)):
        fname = f"leaf_{i:05d}.npy"
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            arr = leaf.detach().cpu().view(torch.int16).numpy().view(np.uint16)
            dtype = "bfloat16"
        else:
            arr = (leaf.detach().cpu().numpy()
                   if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
            dtype = arr.dtype.name
            if dtype == "bfloat16":          # a JAX-side (ml_dtypes) array
                arr = arr.view(np.uint16)
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"file": fname, "path": p, "shape": list(arr.shape),
             "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)
    return d


def save_async(ckpt_dir: str | Path, step: int, tree: PyTree
               ) -> threading.Thread:
    """Copy to the host now; write in the background.  Returns the writer
    thread (join() to block; a trainer joins before its next save)."""
    host_tree = to_host(tree)
    t = threading.Thread(target=_write, args=(Path(ckpt_dir), step,
                                              host_tree), daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str | Path) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for p in d.glob("step_*"):
        if (p / "COMMIT").exists():      # torn checkpoints are ignored
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def restore(ckpt_dir: str | Path, step: int, like: PyTree,
            device=None) -> PyTree:
    """Restore into the structure of `like` (a tree whose leaves have
    `.shape`: tensors, numpy arrays).  Leaves come back as numpy arrays
    (bfloat16 ones as CPU tensors); with `device`, as tensors on that
    device — the port's elastic restore."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves_like, _ = tree_flatten(like)
    # Real exceptions, not asserts: these guard against restoring a
    # checkpoint into a mismatched model and must survive `python -O`.
    if len(manifest["leaves"]) != len(leaves_like):
        raise ValueError(
            f"checkpoint {d} has {len(manifest['leaves'])} leaves but "
            f"`like` has {len(leaves_like)} — structure mismatch")
    out = []
    for rec, ref in zip(manifest["leaves"], leaves_like):
        arr = np.load(d / rec["file"])
        if list(arr.shape) != list(_shape(ref)):
            raise ValueError(
                f"checkpoint leaf {rec['path']!r} has shape "
                f"{tuple(arr.shape)} but `like` expects "
                f"{tuple(_shape(ref))} — shape mismatch")
        if rec["dtype"] == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        if device is not None:
            arr = torch.as_tensor(arr).to(device)
        out.append(arr)
    return tree_unflatten(like, out)


class CheckpointManager:
    """Keeps N checkpoints, drives async saves, joins before overlap."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3,
                 save_every: int = 100):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.save_every = save_every
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, tree: PyTree, force: bool = False):
        if not force and (step % self.save_every != 0 or step == 0):
            return False
        if self._pending is not None:
            self._pending.join()
        host_tree = to_host(tree)

        def write_then_gc():
            _write(self.dir, step, host_tree)
            self._gc()          # GC only after this step is committed

        self._pending = threading.Thread(target=write_then_gc, daemon=True)
        self._pending.start()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*")
                       if (p / "COMMIT").exists())
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def latest(self) -> int | None:
        self.wait()
        return latest_step(self.dir)

    def restore_latest(self, like: PyTree, device=None):
        step = self.latest()
        if step is None:
            return None, None
        return step, restore(self.dir, step, like, device)
