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

The reference's expert-parallel path (``moe_ffn_ep``, a ``shard_map`` over
a mesh's "model" axis) engages only under a sharding environment with
such an axis; without one its ``moe_ffn`` runs ``moe_ffn_gspmd``.  The
port runs one model on one card, so ``moe_ffn`` always does the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import init_mlp, normal, swiglu

_MOE_IMPL = "gspmd"


def set_impl(name: str) -> None:
    """Select the dispatch ("gspmd" or "ep").  As in the reference, "ep"
    needs a mesh with a "model" axis, which the port never has, so both
    run ``moe_ffn_gspmd``."""
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
    """Routed-experts FFN.  x: (B, S, D) -> (out, aux_loss)."""
    if capacity_factor is None:
        capacity_factor = getattr(cfg, "moe_capacity_factor", 1.25)
    return moe_ffn_gspmd(x, p, cfg, capacity_factor=capacity_factor)


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
    # Flatten the (token, choice) assignments.
    tk = s * k
    e_flat = topi.reshape(b, tk)                       # expert per assignment
    w_flat = topw.reshape(b, tk)
    onehot = F.one_hot(e_flat, e)                            # (B, TK, E)
    pos = torch.cumsum(onehot, dim=1) - onehot          # pos within expert
    pos = torch.sum(pos * onehot, dim=-1)                    # (B, TK)
    keep = pos < cap
    slot = torch.where(keep, e_flat * cap + pos, e * cap)    # overflow slot

    tok_idx = torch.arange(tk, device=x.device) // k         # (TK,)
    x_rep = x[:, tok_idx]                                    # (B, TK, D)
    b_idx = torch.arange(b, device=x.device)[:, None]

    disp = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    disp.index_put_((b_idx, slot), x_rep * keep[..., None].to(x.dtype),
                    accumulate=True)
    disp = disp[:, : e * cap].reshape(b, e, cap, d)

    # Expert SwiGLU: (B, E, C, D) x (E, D, F).
    h = F.silu(torch.einsum("becd,edf->becf", disp, p["wg"])) \
        * torch.einsum("becd,edf->becf", disp, p["wu"])
    y = torch.einsum("becf,efd->becd", h, p["wd"])

    # Combine: gather each assignment's expert output, weight, sum over k.
    y_flat = y.reshape(b, e * cap, d)
    y_flat = torch.cat(
        [y_flat, torch.zeros((b, 1, d), dtype=y.dtype, device=y.device)],
        dim=1)
    y_tok = y_flat[b_idx, slot]                              # (B, TK, D)
    y_tok = y_tok * (w_flat * keep)[..., None].to(y.dtype)
    out = y_tok.reshape(b, s, k, d).sum(dim=2)

    if "shared" in p:
        out = out + swiglu(x, p["shared"])
    return out, aux


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
