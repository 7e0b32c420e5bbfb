"""Checkpointing: atomic, manifest-verified, restart-safe (port of
``repro/ckpt/checkpoint.py``, with the same on-disk layout).

Layout (one directory per step):

    <dir>/step_000000420/
        manifest.json        # tree structure, shapes, dtypes, checksums
        arr_00000.npy ...    # one file per leaf
        _COMMITTED           # written last: partial checkpoints are
                             # ignored by restore (crash-atomicity)

Contract:
  * ``save_checkpoint`` writes into a temp dir and renames — a failure
    mid-save never corrupts the latest good checkpoint;
  * ``restore_checkpoint`` picks the newest COMMITTED step;
  * checksums (crc32 of raw bytes) catch torn writes on restore;
  * ``keep`` pruning bounds disk usage for long runs.

A tree is a nested list, tuple or dict (keys in sorted order) of numpy
arrays, torch tensors or scalars; tensors are saved through
``.detach().cpu().numpy()``.  The manifest's ``treedef`` is a string that
restore never parses, so a checkpoint written by either package restores
through the other's ``restore_checkpoint`` given a ``like_tree`` with the
same leaves in the same order (e.g. a list of numpy arrays).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


class _TreeDef:
    """The container structure of a tree: ``None`` for a leaf, else
    ``(type, keys, children)``; ``unflatten`` rebuilds it around new
    leaves."""

    def __init__(self, node):
        self._node = node

    def unflatten(self, leaves: List[Any]):
        it = iter(leaves)

        def build(node):
            if node is None:
                return next(it)
            kind, keys, children = node
            built = [build(c) for c in children]
            if kind is dict:
                return dict(zip(keys, built))
            return kind(built)

        return build(self._node)

    def __str__(self) -> str:
        def show(node):
            if node is None:
                return "*"
            kind, keys, children = node
            if kind is dict:
                return "{" + ", ".join(f"{k!r}: {show(c)}" for k, c in
                                       zip(keys, children)) + "}"
            body = ", ".join(show(c) for c in children)
            return f"({body},)" if kind is tuple else f"[{body}]"

        return show(self._node)


def _flatten(tree) -> Tuple[list, _TreeDef]:
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(c) for c in node])
        leaves.append(node)
        return None

    return leaves, _TreeDef(walk(tree))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_path(path: str) -> None:
    """fsync a file or directory so the rename-based commit protocol is
    durable across power loss, not just process crash (a rename is only
    persistent once the *directory* entry is synced)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return       # platform without O_RDONLY dir opens: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    extra: Optional[dict] = None) -> str:
    """Atomically save a tree checkpoint.  Returns the final path."""
    leaves, treedef = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": int(step), "treedef": str(treedef),
                "n_leaves": len(leaves), "extra": extra or {},
                "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        with open(os.path.join(tmp, fname), "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "crc32": crc})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # the rename itself is only durable once the parent directory's
    # entry table hits disk
    _fsync_path(ckpt_dir)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_committed_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def _committed_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "_COMMITTED")):
            out.append(int(name[5:]))
    return out


def latest_step(ckpt_dir: str, limit: Optional[int] = None) -> Optional[int]:
    steps = [s for s in _committed_steps(ckpt_dir)
             if limit is None or s <= limit]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like_tree, *,
                       step: Optional[int] = None,
                       verify: bool = True):
    """Restore the newest committed checkpoint into ``like_tree``'s
    structure, each leaf a numpy array of its like leaf's dtype.  Returns
    (tree, step, extra) or (None, None, None).

    With ``step=None`` (the restart path), a torn/corrupt trailing step
    — truncated array file, checksum mismatch, unreadable manifest —
    is *skipped* and restore falls back to the newest older committed
    step that loads cleanly: a crash that slipped a bad step past the
    ``_COMMITTED`` marker (e.g. lost sectors under power failure) must
    degrade to the previous good state, not take the restart down.  If
    every committed step is corrupt the last error propagates.  An
    explicitly requested ``step`` still raises on any corruption.
    """
    if step is not None:
        return _restore_step(ckpt_dir, like_tree, step, verify)
    steps = sorted(_committed_steps(ckpt_dir), reverse=True)
    if not steps:
        return None, None, None
    err: Optional[Exception] = None
    for s in steps:
        try:
            return _restore_step(ckpt_dir, like_tree, s, verify)
        except (OSError, ValueError, KeyError,
                json.JSONDecodeError) as e:
            err = err if err is not None else e
    raise err


def _restore_step(ckpt_dir: str, like_tree, step: int, verify: bool):
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = _flatten(like_tree)
    assert manifest["n_leaves"] == len(leaves), \
        f"checkpoint has {manifest['n_leaves']} leaves, model has " \
        f"{len(leaves)} — architecture mismatch"
    out = []
    for i, (leaf, meta) in enumerate(zip(leaves, manifest["leaves"])):
        fpath = os.path.join(path, meta["file"])
        if verify:
            with open(fpath, "rb") as f:
                crc = zlib.crc32(f.read())
            if crc != meta["crc32"]:
                raise IOError(f"checksum mismatch in {fpath} — torn write")
        arr = np.load(fpath)
        like = _to_numpy(leaf)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != model "
                f"{tuple(like.shape)}")
        out.append(arr.astype(like.dtype))
    return treedef.unflatten(out), step, manifest.get("extra", {})
