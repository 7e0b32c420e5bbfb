"""Trees of tensors in ``jax.tree.flatten``'s order (the port's own, for the
checkpoint and the training path).

A tree is a nested dict, list or tuple (a ``NamedTuple`` included) of
leaves: tensors, numpy arrays or scalars.  ``flatten`` lists the leaves in
the order jax gives them, so that checkpoints and the gradient
compressor's coordinate offsets agree between the two packages: a dict's
values by sorted key, a list's or tuple's items (a ``NamedTuple``'s
fields) in order.  ``TreeDef.unflatten`` rebuilds the containers around
new leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple


class TreeDef:
    """The container structure of a tree: ``None`` for a leaf, else
    ``(type, keys, children)``; ``unflatten`` rebuilds it around new
    leaves."""

    def __init__(self, node):
        self._node = node

    def unflatten(self, leaves: List[Any]):
        return _build(self._node, iter(leaves))

    def __str__(self) -> str:
        return _show(self._node)


# The walks below are module functions, not closures that call
# themselves: such a closure is a reference cycle (function -> cell ->
# function) that keeps every leaf it saw alive until the garbage
# collector finds it, gigabytes of tensors at full width.

def _build(node, it):
    if node is None:
        return next(it)
    kind, keys, children = node
    built = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(keys, built))
    if hasattr(kind, "_fields"):                  # a NamedTuple: by field
        return kind(*built)
    return kind(built)


def _show(node) -> str:
    if node is None:
        return "*"
    kind, keys, children = node
    if kind is dict:
        return "{" + ", ".join(f"{k!r}: {_show(c)}" for k, c in
                               zip(keys, children)) + "}"
    body = ", ".join(_show(c) for c in children)
    if kind is list:
        return f"[{body}]"
    name = "" if kind is tuple else kind.__name__
    return f"{name}({body},)"


def _walk(node, leaves: list):
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), None, [_walk(c, leaves) for c in node])
    leaves.append(node)
    return None


def flatten(tree) -> Tuple[list, TreeDef]:
    """``(leaves, treedef)`` with the leaves in ``jax.tree.flatten``'s
    order."""
    leaves: list = []
    return leaves, TreeDef(_walk(tree, leaves))


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf, containers rebuilt."""
    xs, treedef = flatten(tree)
    return treedef.unflatten([fn(x) for x in xs])


def chunks(sizes: Sequence[int],
           size: int) -> List[List[Tuple[int, int, int]]]:
    """The flat range of leaves of ``sizes`` elements, in flatten order, cut
    into chunks of ``size`` elements (the last may be shorter): each chunk a
    list of ``(leaf, lo, hi)`` pieces.  A chunk may span several small
    leaves, and a large leaf several chunks."""
    out, cur, room = [], [], size
    for i, n in enumerate(sizes):
        lo = 0
        while lo < n:
            take = min(n - lo, room)
            cur.append((i, lo, lo + take))
            lo += take
            room -= take
            if room == 0:
                out.append(cur)
                cur, room = [], size
    if cur:
        out.append(cur)
    return out
