"""Device meshes (port of ``repro/launch/mesh.py``): the ``switch`` mesh
of the sharded fragment fleet, and the model's production meshes.

**The model's meshes** are ``torch.distributed`` ``DeviceMesh``es over
the default process group: the single-pod mesh is (data=16, model=16) =
256 ranks, the multi-pod mesh adds a leading "pod" axis = (2, 16, 16) =
512.  ``make_production_mesh`` and ``make_host_mesh`` are functions
(importing this module touches no process group); the caller starts the
group (``process_group``).  ``AbstractMesh`` carries the names and sizes
alone, for the spec tables (``launch/shardings.py``), as the reference's
``jax.sharding.AbstractMesh`` does.

**The fleet's mesh.**

One Python process drives the whole mesh, as the reference's single
controller does: a mesh is a list of devices along one axis, named
``switch``.  The fleet partitions its fragments over that axis in
contiguous blocks (``shard_frag_bounds``), and every row of a fragment —
its ``L`` UnivMon level rows in every epoch of a window — lives on the
fragment's shard: a fragment's level rows never split.  That row
partition is the port's counterpart of the reference's
``launch/shardings.py`` fleet specs (the stack, row and CSR
PartitionSpecs), which have nothing to port beyond it: each shard packs
and dispatches its own fragments' packets on its own device, and a query
copies only the gathered ``(E, R_g, K)`` estimate slices to the merge
device (``kernels.sketch_query.engine._all_gather_rows``).

A device may appear more than once only when the caller lists the
devices: ``make_switch_mesh(4, devices=["cpu"] * 4)`` for tests on the
CPU, ``devices=[torch.device("cuda", 0)] * 4`` for four shards on one
card.  ``make_switch_mesh(n)`` takes the first ``n`` visible CUDA devices
and raises when there are fewer.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

DeviceLike = Union[str, torch.device]


SWITCH_AXIS = "switch"


@dataclass(frozen=True)
class SwitchMesh:
    """A one-axis device mesh over ``SWITCH_AXIS``: ``devices[s]`` holds
    shard ``s``."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(resolve_device(d) for d in self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        """``{"switch": n}``, as ``jax.sharding.Mesh.shape``."""
        return {SWITCH_AXIS: len(self.devices)}


def make_switch_mesh(n_devices: Optional[int] = None, *,
                     devices: Optional[Sequence[DeviceLike]] = None,
                     ) -> SwitchMesh:
    """A ``("switch",)`` mesh: over ``devices`` as listed (a device may
    repeat), or over the first ``n_devices`` visible CUDA devices (default
    every one).  Raises when fewer CUDA devices are visible than asked
    for: a device is never repeated quietly, and there is no fallback to
    the CPU."""
    if devices is not None:
        if n_devices is not None and int(n_devices) != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             "devices listed")
        return SwitchMesh(tuple(devices))
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise RuntimeError(
            f"make_switch_mesh({n_devices}): {have} CUDA device(s) visible; "
            "list the devices explicitly (devices=[...]) to repeat one")
    return SwitchMesh(tuple(torch.device("cuda", i) for i in range(n)))


def shard_frag_bounds(n_frags: int, n_shards: int) -> List[Tuple[int, int]]:
    """Shard ``s``'s fragment positions ``[lo, hi)`` in fleet order: blocks
    of ``ceil(n_frags / n_shards)``, the last ones short or empty
    (``lo >= hi``), as the reference's ``FleetEpochRunner``
    ``_shard_frag_bounds``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    fps = -(-max(int(n_frags), 1) // int(n_shards))
    return [(s * fps, min((s + 1) * fps, int(n_frags)))
            for s in range(int(n_shards))]


# --- the model's production meshes ------------------------------------------

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks behind them."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self, dim: int) -> int:
        return self.axis_sizes[dim]


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    return AbstractMesh(*(MULTI_POD if multi_pod else SINGLE_POD))


@contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0, *,
                  store=None):
    """The default process group for the block, destroyed on exit.  A
    world of several ranks needs a ``store`` shared by them (a
    ``FileStore``); a world of one uses an in-process ``HashStore``."""
    import torch.distributed as dist

    if store is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs a store")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, world_size=world_size,
                            rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over every rank of the default group
    (its world size must be the shape's product), dims ``names``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for x in shape:
        n *= int(x)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                           f"process group has {dist.get_world_size()}")
    if device_type == "cuda":         # this rank's card, before the mesh
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``: a default group of 256 or 512 ranks."""
    return make_mesh(*(MULTI_POD if multi_pod else SINGLE_POD),
                     device_type=device_type)


def make_host_mesh(device_type: str = "cuda"):
    """A 1-rank (1, 1) mesh (axis names preserved) over a default group of
    world size 1."""
    return make_mesh((1, 1), ("data", "model"), device_type=device_type)


def data_axis_size(mesh) -> int:
    """The product of the batch axes ("pod", "data") present."""
    from ..models.sharding import mesh_sizes

    sizes = mesh_sizes(mesh)
    size = 1
    for name in ("pod", "data"):
        size *= sizes.get(name, 1)
    return size
