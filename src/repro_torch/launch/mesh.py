"""The ``switch`` device mesh of the sharded fragment fleet (port of the
fleet half of ``repro/launch/mesh.py``).

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
