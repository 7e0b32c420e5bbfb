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

A tree is a nested list, tuple (a ``NamedTuple`` included, rebuilt by
its fields) or dict of numpy arrays, torch tensors or scalars, flattened
in ``jax.tree.flatten``'s order (``repro_torch.tree``: sorted dict keys,
tuple fields in order).  A tensor's bytes are copied to the host leaf by
leaf; a bfloat16 leaf is written as its bit pattern, as the reference
writes jax's bfloat16.  The manifest's ``treedef`` is a string that
restore never parses, so a checkpoint written by either package restores
through the other's ``restore_checkpoint`` given a ``like_tree`` with the
same leaves in the same order: a training state restores across the two
packages, and a list of numpy arrays will do.  Given tensors, restore
returns tensors, on the like tensors' device or on ``device``.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..tree import flatten


def _write_leaf(path: str, leaf) -> Tuple[list, str, int]:
    """Write one leaf as the ``.npy`` file ``np.save`` would write and
    return its manifest entry: ``(shape, dtype name, crc32 of the file)``.
    Shape and dtype come from the tensor itself; only its bytes cross to
    the host.  A bfloat16 tensor is written as its 16-bit pattern with the
    descr ``'<V2'`` and the dtype name ``"bfloat16"``: the bytes numpy
    writes for jax's ``ml_dtypes.bfloat16`` (the reference's layout)."""
    descr = None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, descr, name = t.view(torch.int16).numpy(), "<V2", "bfloat16"
        else:
            arr = t.numpy()
            name = str(arr.dtype)
    else:
        arr = np.asarray(leaf)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        name = str(arr.dtype)
    header = np.lib.format.header_data_from_array_1_0(arr)
    if descr is not None:
        header["descr"] = descr
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, header)
    data = memoryview(arr.reshape(-1).view(np.uint8))
    with open(path, "wb") as f:
        f.write(buf.getvalue())
        f.write(data)
    crc = zlib.crc32(data, zlib.crc32(buf.getvalue()))
    return list(arr.shape), name, crc


def _read_leaf(fpath: str, meta: dict, like, i: int, device):
    """One leaf of a checkpoint, shaped and typed as ``like``: a tensor on
    ``device`` (default: ``like``'s) when ``like`` is a tensor, else a
    numpy array.  A ``"bfloat16"`` leaf is read through its bit pattern,
    whichever package wrote it."""
    arr = np.load(fpath)
    shape = tuple(like.shape) if hasattr(like, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != model "
                         f"{shape}")
    bf16 = meta.get("dtype") == "bfloat16"
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
        if bf16:
            t = t.view(torch.bfloat16)
        return t.to(device=like.device if device is None else device,
                    dtype=like.dtype)
    if bf16:
        arr = torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).float().numpy()
    dtype = like.dtype if hasattr(like, "dtype") else np.asarray(like).dtype
    return arr.astype(dtype)


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
    leaves, treedef = flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": int(step), "treedef": str(treedef),
                "n_leaves": len(leaves), "extra": extra or {},
                "leaves": []}
    for i, leaf in enumerate(leaves):
        fname = f"arr_{i:05d}.npy"
        shape, dtype, crc = _write_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append({
            "file": fname, "shape": shape, "dtype": dtype, "crc32": crc})
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
                       verify: bool = True, device=None):
    """Restore the newest committed checkpoint into ``like_tree``'s
    structure, each leaf of its like leaf's shape and dtype: a tensor (on
    ``device``, default the like tensor's own) where the like leaf is a
    tensor, else a numpy array.  Returns (tree, step, extra) or (None,
    None, None).

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
        return _restore_step(ckpt_dir, like_tree, step, verify, device)
    steps = sorted(_committed_steps(ckpt_dir), reverse=True)
    if not steps:
        return None, None, None
    err: Optional[Exception] = None
    for s in steps:
        try:
            return _restore_step(ckpt_dir, like_tree, s, verify, device)
        except (OSError, ValueError, KeyError,
                json.JSONDecodeError) as e:
            err = err if err is not None else e
    raise err


def _restore_step(ckpt_dir: str, like_tree, step: int, verify: bool,
                  device):
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = flatten(like_tree)
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
        out.append(_read_leaf(fpath, meta, leaf, i, device))
    return treedef.unflatten(out), step, manifest.get("extra", {})
