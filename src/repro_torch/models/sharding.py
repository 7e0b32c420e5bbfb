"""Sharding vocabulary for the production mesh, the counterpart of
``src/repro/models/sharding.py``.

Logical axes:
  * ``pod``   — outermost data-parallel axis (multi-pod dry-run),
  * ``data``  — within-pod data parallelism,
  * ``model`` — tensor parallelism (heads / FFN / experts / vocab).

The model is sharded with ``torch.distributed``'s ``DTensor``, as GSPMD
shards the reference: a mesh is a ``DeviceMesh`` with dim names
``("data", "model")`` or ``("pod", "data", "model")``; parameters, batches
and decode state are DTensors placed by ``launch/shardings.py``'s spec
tables; and ``shard(x, *axes)``, the counterpart of
``with_sharding_constraint``, redistributes a DTensor to the placements
of ``P(*axes)``.  It is a no-op unless the launcher has activated a
sharding environment with ``sharding_env(mesh)``, and a plain tensor
passes through unchanged, so the same model code runs unsharded on one
device bit for bit.  Axis names not present in the active mesh are
dropped, so one set of annotations serves both meshes.

Inside the environment, plain tensors that meet DTensors (positions,
masks, ``torch.arange``) count as replicated
(``torch.distributed.tensor.experimental.implicit_replication``).

Batch dims shard over ("pod","data"); d_ff / heads / experts / vocab over
"model".  Sequence parallelism for long-context decode shards the KV-cache
sequence axis over "data" (batch=1 leaves it idle) — see
``launch/shardings.py::kv_cache_spec``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"

_state = threading.local()


class P:
    """A partition spec, the counterpart of ``jax.sharding.PartitionSpec``:
    one entry per leading tensor dim, each an axis name, a tuple of axis
    names (the dim sharded over their product, the first name major), or
    None.  Not a tuple, so trees of specs keep each spec a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(("P",) + self.entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self.entries) + ")"


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in mesh_axes(mesh)}
    return {a: int(n) for a, n in zip(mesh_axes(mesh), shape)}


def active_axes() -> Tuple[str, ...]:
    return getattr(_state, "axes", ())


def active_sizes() -> dict:
    return getattr(_state, "sizes", {})


def active_mesh():
    """The ``DeviceMesh`` of the active environment, or None."""
    return getattr(_state, "mesh", None)


@contextmanager
def sharding_env(mesh):
    """Activate sharding annotations for ``mesh`` (launcher-side)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = (active_axes(), active_sizes(), active_mesh())
    _state.axes = mesh_axes(mesh)
    _state.sizes = mesh_sizes(mesh)
    _state.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _state.axes, _state.sizes, _state.mesh = prev


def norm_spec(spec: P) -> Optional[P]:
    """Drop axis names not in the active env; None if env inactive."""
    names = active_axes()
    if not names:
        return None
    return filter_spec(names, spec)


def filter_spec(names, spec: P) -> P:
    """``spec`` with the axis names not in ``names`` dropped."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh dim that tensor dim ``i``'s entry names (a tuple entry names
    several), ``Replicate()`` on the others.  A mesh dim of size 1 is
    ``Replicate()`` whatever the spec names (the same layout, and one
    DTensor's views never refuse)."""
    axes = mesh_axes(mesh)
    sizes = mesh_sizes(mesh)
    out = [Replicate() for _ in axes]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in axes and sizes[a] > 1:
                j = axes.index(a)
                if out[j] != Replicate():
                    raise ValueError(f"{spec}: mesh axis {a!r} shards two "
                                     "tensor dims")
                out[j] = Shard(dim)
    return out


def divisible_spec(spec: P, shape, sizes: Dict[str, int]) -> P:
    """``spec`` with each entry whose mesh-axis product does not divide its
    dim (or that names a dim the tensor lacks) set to None."""
    fixed = []
    for dim, entry in enumerate(spec):
        if entry is None:
            fixed.append(None)
            continue
        prod = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            prod *= sizes.get(a, 1)
        if dim < len(shape) and prod > 0 and shape[dim] % prod == 0:
            fixed.append(entry)
        else:
            fixed.append(None)
    return P(*fixed)


def shard(x, *axes):
    """Redistribute the DTensor ``x`` to ``P(*axes)`` when a sharding env
    is active (``with_sharding_constraint``'s counterpart).

    Each entry of ``axes`` is an axis name, a tuple of names, or None.
    Entries whose mesh-axis product does not divide the array dim are
    dropped (a constraint like "8 heads over 16 chips" would force an
    uneven layout — better to leave the dim unconstrained).  A plain
    tensor, or any tensor outside an env, is returned unchanged.  A
    pending sum (``Partial``) is resolved by the redistribution.
    """
    names = active_axes()
    if not names or not isinstance(x, DTensor):
        return x
    spec = divisible_spec(filter_spec(names, P(*axes)), tuple(x.shape),
                          active_sizes())
    mesh = x.device_mesh
    want = tuple(placements(spec, mesh))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_shape(shape, places, mesh) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of global ``shape`` placed by
    ``places`` on ``mesh``.  The specs shard only dims their axes divide;
    an uneven split is refused."""
    out = list(shape)
    for j, pl in enumerate(places):
        dim = getattr(pl, "dim", None)
        if dim is None:
            continue
        n = mesh.size(j)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"evenly over {n} ({places})")
        out[dim] //= n
    return tuple(out)


def from_shard(local, shape, places, mesh):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (contiguous), built without a collective."""
    shape = torch.Size(shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def zeros(shape, spec: Optional[P], dtype, device):
    """``torch.zeros(shape)``; under an active env with a ``spec``, a
    DTensor placed by it whose shard alone is allocated (a 32 k decode
    cache of 128 sequences is ~220 GB in all, under 1 GB a rank)."""
    mesh = active_mesh()
    if mesh is None or spec is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    spec = divisible_spec(filter_spec(active_axes(), spec), shape,
                          active_sizes())
    places = placements(spec, mesh)
    local = torch.zeros(local_shape(shape, places, mesh), dtype=dtype,
                        device=device)
    return from_shard(local, shape, places, mesh)


def batch_spec(ndim: int) -> P:
    """(batch, ...) sharded over ("pod","data")."""
    return P(BATCH_AXES, *([None] * (ndim - 1)))
