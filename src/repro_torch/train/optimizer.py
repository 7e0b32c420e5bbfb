"""AdamW + LR schedules over trees of tensors (port of
``repro/train/optimizer.py``; no ``torch.optim``).

Optimizer state mirrors the parameters: ``OptState(m, v, step)``.  m/v are
float32 whatever the parameter dtype (mixed-precision master moments);
parameters stay in their own dtype (bf16 weights + f32 moments is the
MaxText-style memory layout).  The update is the reference's formula op
for op in f32 and is cast back to the parameter's dtype (round to nearest
even, as XLA casts).  It runs as ``torch._foreach_*`` ops over chunks of
``GROUP`` elements (pieces of leaves, ``tree.chunks``), so its f32
temporaries stay bounded at full width, and it writes the parameters and
moments **in place**: the returned trees hold the same tensors (two
copies of a 3.2 G-parameter model's moments would not fit one card).  ``lr`` may be a device scalar;
nothing is read back to the host.

``wsd_schedule`` is the Warmup-Stable-Decay schedule of MiniCPM
[arXiv:2404.06395] — one of the assigned architectures trains with it.

DTensor parameters (``launch/shardings.py``): the moments take the
parameters' placements (``opt_state_specs``), and, the update being
elementwise, it runs on each rank's local shards, which are plain
tensors the chunked views may cut (a view across a sharded dim of the
DTensor itself is not allowed).  The global gradient norm is a DTensor
reduction, so every shard's squares are summed once however the leaf is
placed, and comes back replicated.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..tree import chunks, flatten, tree_map

# Elements the update processes together.
GROUP = 1 << 28


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def _zeros32(p):
    """f32 zeros of ``p``'s shape (and placements, for a DTensor)."""
    if _is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _local(x):
    """A DTensor's shard on this rank (a plain tensor unchanged)."""
    return x.to_local() if _is_dtensor(x) else x


def adamw_init(params) -> OptState:
    leaves = flatten(params)[0]
    dev = leaves[0].device
    return OptState(
        m=tree_map(_zeros32, params),
        v=tree_map(_zeros32, params),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(g.f32 ** 2))``, summed in leaf order
    (plain and replicated for DTensor gradients)."""
    total = None
    for g in flatten(grads)[0]:
        s = torch.sum(torch.square(g.float()))
        if _is_dtensor(s):
            s = s.full_tensor()
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: OptState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0):
    """One AdamW step with global-norm clipping, in place.  Returns
    ``(params, OptState, grad_norm)``.  ``lr`` may be a device scalar."""
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = _local(state.step) + 1
    lr = _local(lr) if torch.is_tensor(lr) else lr
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)

    tree_p, treedef = flatten(params)
    flat_p = [_local(x) for x in tree_p]
    flat_g = [_local(x) for x in flatten(grads)[0]]
    flat_m = [_local(x) for x in flatten(state.m)[0]]
    flat_v = [_local(x) for x in flatten(state.v)[0]]
    for pieces in chunks([p.numel() for p in flat_p], GROUP):
        p, m, v, g = ([t[i].view(-1)[lo:hi] for i, lo, hi in pieces]
                      for t in (flat_p, flat_m, flat_v, flat_g))
        g = torch._foreach_mul([x.float() for x in g], scale)
        # m = b1 * m + (1 - b1) * g
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        # v = b2 * v + (1 - b2) * g * g
        gg = torch._foreach_mul(g, 1.0 - b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        del g, gg
        # delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        delta = torch._foreach_div(m, bc1)
        torch._foreach_div_(delta, den)
        del den
        pf = [x.float() for x in p]
        torch._foreach_add_(delta, torch._foreach_mul(pf, weight_decay))
        # p = (p - lr * delta).astype(p.dtype)
        torch._foreach_mul_(delta, lr)
        new = torch._foreach_sub(pf, delta)
        del pf, delta
        torch._foreach_copy_(p, new)
    return treedef.unflatten(tree_p), OptState(state.m, state.v, step), gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1.0 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, stable: int, decay: int,
                 min_frac: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (MiniCPM): flat plateau, then fast decay."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup - stable) / max(decay, 1),
                           0.0, 1.0)
        dec = base_lr * torch.pow(min_frac, prog)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, base_lr), dec))
    return lr
