"""Mixture-of-Experts FFN: DeepSeekMoE / OLMoE style routed experts, the
counterpart of ``src/repro/models/moe.py``.

  * token-choice top-k routing with softmax gate,
  * capacity-based dispatch (GShard/Switch style): tokens are scattered
    into per-expert slots of capacity C = round(S*K/E * capacity_factor);
    over-capacity assignments are dropped,
  * shared experts (DeepSeekMoE) run densely on every token.

Tie order: the reference's ``jax.lax.top_k`` puts equal gate
probabilities in ascending expert order.  ``torch.topk`` promises no
order among ties, so ``route_topk`` takes the first k of a stable
descending sort, which gives the reference's order.

The dispatch scatters with ``scatter_add`` and the combine gathers with
``torch.gather`` (each kept slot receives one assignment, so the sums are
those of the reference's ``.at[].add``): both have DTensor strategies
that keep a batch-sharded tensor local.

Expert parallelism: expert-indexed weights (E, D, F) are sharded over the
"model" mesh axis on E.  ``set_impl("ep")`` selects ``moe_ffn_ep``, the
counterpart of the reference's ``shard_map`` path: each model shard
dispatches its replica of the tokens to its own experts and one sum over
"model" combines them.  It engages only under a sharding env whose
"model" axis divides the expert count; otherwise ``moe_ffn`` runs
``moe_ffn_gspmd``, as the reference does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .layers import init_mlp, normal, swiglu
from .sharding import BATCH_AXES, MODEL_AXIS, active_axes, active_sizes, \
    from_shard, shard

# Dispatch implementation: "gspmd" (the baseline: the capacity scatter on
# whatever layout the placements give) or "ep" (local dispatch to the
# model shard's own experts + ONE sum over "model" a layer).
_MOE_IMPL = "gspmd"


def set_impl(name: str) -> None:
    """Select the dispatch ("gspmd" or "ep"); "ep" engages only under a
    sharding env with a "model" axis that divides the expert count."""
    global _MOE_IMPL
    if name not in ("gspmd", "ep"):
        raise ValueError(f"unknown MoE impl {name!r}")
    _MOE_IMPL = name


def get_impl() -> str:
    return _MOE_IMPL


def route_topk(x, router_w, k: int):
    """Softmax gate + top-k.  Returns (weights (B,S,K), experts (B,S,K),
    router probs (B,S,E) for the aux loss)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi, probs


def load_balance_loss(probs, topi, n_experts: int) -> torch.Tensor:
    """Switch-Transformer auxiliary load-balancing loss."""
    # fraction of tokens dispatched to each expert (first choice proxy)
    counts = F.one_hot(topi[..., 0], n_experts).float()
    f = counts.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    return n_experts * torch.sum(f * p)


def moe_ffn(x, p, cfg, capacity_factor: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed-experts FFN.  x: (B, S, D) -> (out, aux_loss).

    Dispatches to the implementation selected by ``set_impl`` ("ep" only
    engages when a mesh with a compatible "model" axis is active).
    """
    if capacity_factor is None:
        capacity_factor = getattr(cfg, "moe_capacity_factor", 1.25)
    if _MOE_IMPL == "ep" and MODEL_AXIS in active_axes():
        tp = active_sizes().get(MODEL_AXIS, 1)
        if tp > 1 and cfg.n_experts % tp == 0:
            return moe_ffn_ep(x, p, cfg, capacity_factor=capacity_factor)
    return moe_ffn_gspmd(x, p, cfg, capacity_factor=capacity_factor)


def _slots(topi, topw, n_experts, cap, k, mine=None):
    """The capacity assignment of (token, choice) pairs: ``(slot, keep,
    w_flat)``, ``slot`` in ``[0, n_experts * cap]`` (the last is the
    overflow slot).  ``mine``: ``(first expert, count)`` of this shard's
    experts (the others are not kept)."""
    b = topi.shape[0]
    tk = topi.shape[1] * k
    e_flat = topi.reshape(b, tk)                       # expert per assignment
    w_flat = topw.reshape(b, tk)
    if mine is not None:
        lo, n = mine
        own = (e_flat >= lo) & (e_flat < lo + n)
        e_flat = torch.where(own, e_flat - lo, n)      # local expert id
        onehot = F.one_hot(e_flat, n + 1)[..., :n]
    else:
        onehot = F.one_hot(e_flat, n_experts)               # (B, TK, E)
    pos = torch.cumsum(onehot, dim=1) - onehot          # pos within expert
    pos = torch.sum(pos * onehot, dim=-1)                    # (B, TK)
    keep = pos < cap
    if mine is not None:
        keep = keep & own
    slot = torch.where(keep, e_flat * cap + pos, n_experts * cap)
    return slot, keep, w_flat


def _dispatch(x, slot, keep, k, n_slots):
    """(B, S, D) tokens into (B, n_slots + 1, D) expert slots (the last the
    overflow slot, holding zeros)."""
    b, s, d = x.shape
    tok_idx = torch.arange(s * k, device=x.device) // k      # (TK,)
    x_rep = x[:, tok_idx]                                    # (B, TK, D)
    vals = x_rep * keep[..., None].to(x.dtype)
    disp = torch.zeros((b, n_slots + 1, d), dtype=x.dtype, device=x.device)
    return disp.scatter_add(1, slot[..., None].expand(b, s * k, d), vals)


def _combine(y_flat, slot, keep, w_flat, k):
    """Each assignment's expert output (``y_flat``: (B, n_slots + 1, D),
    zero in the overflow slot), weighted and summed over its k choices."""
    b, _, d = y_flat.shape
    tk = slot.shape[1]
    y_tok = torch.gather(y_flat, 1, slot[..., None].expand(b, tk, d))
    y_tok = y_tok * (w_flat * keep)[..., None].to(y_flat.dtype)
    return y_tok.reshape(b, tk // k, k, d).sum(dim=2)


def _experts(w):
    """An expert weight (E, ., .) with E alone sharded (over "model"), its
    FSDP shards gathered into a contiguous shard: the einsums' local
    views need one (a plain tensor is returned as it is)."""
    w = shard(w, MODEL_AXIS, None, None)
    return w.contiguous() if isinstance(w, DTensor) else w


def moe_ffn_gspmd(x, p, cfg, capacity_factor: float = 1.25
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch: scatter to (B, E, C, D) expert slots, expert
    SwiGLU, gather back.

    p: {"router": (D, E), "wg"/"wu": (E, D, F), "wd": (E, F, D),
        optional "shared": swiglu params}.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    topw, topi, probs = route_topk(x, p["router"], k)
    aux = load_balance_loss(probs, topi, e)

    cap = int(max(1, round(s * k / e * capacity_factor)))
    slot, keep, w_flat = _slots(topi, topw, e, cap, k)
    disp = _dispatch(x, slot, keep, k, e * cap)
    disp = disp[:, : e * cap].reshape(b, e, cap, d)
    disp = shard(disp, BATCH_AXES, MODEL_AXIS, None, None)

    # Expert SwiGLU: (B, E, C, D) x (E, D, F) — E sharded over "model".
    wg, wu, wd = (_experts(p[n]) for n in ("wg", "wu", "wd"))
    h = F.silu(torch.einsum("becd,edf->becf", disp, wg)) \
        * torch.einsum("becd,edf->becf", disp, wu)
    h = shard(h, BATCH_AXES, MODEL_AXIS, None, None)
    y = torch.einsum("becf,efd->becd", h, wd)
    y = shard(y, BATCH_AXES, MODEL_AXIS, None, None)

    # Combine: gather each assignment's expert output, weight, sum over k.
    y_flat = y.reshape(b, e * cap, d)
    y_flat = torch.cat(
        [y_flat, torch.zeros((b, 1, d), dtype=y.dtype, device=y.device)],
        dim=1)
    out = _combine(y_flat, slot, keep, w_flat, k)

    if "shared" in p:
        out = out + swiglu(x, p["shared"])
    return shard(out, BATCH_AXES, None, None), aux


def moe_ffn_ep(x, p, cfg, capacity_factor: float = 1.25
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism, the counterpart of the reference's
    ``shard_map`` path.

    Activations are batch-sharded over ("pod","data") and REPLICATED over
    "model"; experts are sharded over "model".  So no all-to-all is
    needed: routing and the aux loss run on the DTensors (global means),
    then every model shard locally dispatches its replica of the tokens
    to *its own* E/tp experts, runs them, locally combines, and ONE sum
    over "model" (``Partial`` -> ``Replicate``) adds the per-shard
    partial outputs.  The local tensors are taken with the gradient
    placements of that structure (a pending sum over "model" for the
    tokens and gate weights, over the batch axes for the expert
    weights), so autograd trains through it.
    """
    mesh = x.device_mesh
    axes = mesh.mesh_dim_names
    mi = axes.index(MODEL_AXIS)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tp = mesh.size(mi)
    e_loc = e // tp

    def on(model, batch):
        return [model if a == MODEL_AXIS else
                (batch if a in BATCH_AXES else Replicate()) for a in axes]

    x = x.redistribute(mesh, on(Replicate(), Shard(0)))
    router = p["router"].float()
    topw, topi, probs = route_topk(x, router, k)
    aux = load_balance_loss(probs, topi, e)

    cap = int(max(1, round(s * k / e * capacity_factor)))
    m_id = mesh.get_coordinate()[mi]
    rows = on(Replicate(), Shard(0))
    xl = x.to_local(grad_placements=on(Partial(), Shard(0)))
    wl = topw.redistribute(mesh, rows).to_local(
        grad_placements=on(Partial(), Shard(0)))
    il = topi.redistribute(mesh, rows).to_local()
    ws = [p[n].redistribute(mesh, on(Shard(0), Replicate())).to_local(
        grad_placements=on(Shard(0), Partial())) for n in ("wg", "wu", "wd")]
    slot, keep, w_flat = _slots(il, wl, e_loc, cap, k,
                                mine=(m_id * e_loc, e_loc))
    bl = xl.shape[0]
    disp = _dispatch(xl, slot, keep, k, e_loc * cap)
    disp = disp[:, :e_loc * cap].reshape(bl, e_loc, cap, d)
    h = F.silu(torch.einsum("becd,edf->becf", disp, ws[0])) \
        * torch.einsum("becd,edf->becf", disp, ws[1])
    y = torch.einsum("becf,efd->becd", h, ws[2])
    y_flat = torch.cat(
        [y.reshape(bl, e_loc * cap, d),
         torch.zeros((bl, 1, d), dtype=y.dtype, device=y.device)], dim=1)
    out = _combine(y_flat, slot, keep, w_flat, k)
    # partial sum: only my experts' contributions — combine shards
    out = from_shard(out, x.shape, on(Partial(), Shard(0)), mesh)
    out = out.redistribute(mesh, on(Replicate(), Shard(0)))

    if "shared" in p:
        out = out + swiglu(x, p["shared"])
    return shard(out, BATCH_AXES, None, None), aux


def init_moe(gen, cfg, dtype=torch.bfloat16, device="cpu"):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {
        "router": normal(gen, (d, e), d ** -0.5, torch.float32, device),
        "wg": normal(gen, (e, d, f), d ** -0.5, dtype, device),
        "wu": normal(gen, (e, d, f), d ** -0.5, dtype, device),
        "wd": normal(gen, (e, f, d), f ** -0.5, dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.n_shared_experts * f, dtype,
                               device)
    return p
