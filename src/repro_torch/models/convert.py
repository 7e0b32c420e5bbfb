"""Weight carry-over between the reference's parameter pytree and the
port's parameters.

The port keeps the reference's layouts (``wq (d, h, dh)``, ``wo (h, dh,
d)``, ``w_gate (d, f)``, the experts' ``(E, D, F)``) and its nesting
(dicts, and the list ``layers``), so the carry-over is a map over the tree
with no transposes: ``from_numpy`` turns a pytree of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``) into tensors on a device, and
``to_numpy`` turns the port's parameters back.  ``flatten`` names each
tensor by its pytree path, ``layers.{i}.attn.wq`` and so on.

A bfloat16 array (``ml_dtypes.bfloat16``, as jax hands it to numpy) is
read through its 16-bit pattern; ``to_numpy`` widens bfloat16 to float32
(exact), since numpy itself has no bfloat16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:          # e.g. a view of a jax buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16
                                                        ).to(device)
    return torch.from_numpy(a).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def from_numpy(tree, device) -> Any:
    """The reference's pytree of numpy arrays -> the port's parameters on
    ``device`` (no transposes)."""
    return _map(lambda a: _tensor(a, device), tree)


def to_numpy(params) -> Any:
    """The port's parameters -> the reference's pytree of numpy arrays."""
    return _map(_array, params)


def flatten(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"layers.0.attn.wq": tensor, ...}``: each leaf by its path."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        return {prefix: params}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
