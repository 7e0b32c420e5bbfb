"""Core transformer layers: RMSNorm, RoPE, GQA attention (local/global,
softcap), SwiGLU.  Pure functions over parameter dicts of tensors, the
counterpart of ``src/repro/models/layers.py``.

Attention is einsum + softmax with f32 logits, the reference's masks and
``NEG_INF`` (not ``scaled_dot_product_attention``, which has no softcap).
Train/eval attention runs in Python query chunks so the full (S, S) score
matrix never materializes; local layers slice only the needed key range,
from a 128-aligned ``kv_lo``.

The reference's sharding annotations (``sharding.shard``) and its
``_ATTN_OPT`` policy only constrain layouts on a device mesh; one model on
one card has none, so they have no counterpart here.

Two places where torch and XLA differ are made explicit:

* ``jax.lax.dynamic_update_slice`` clamps its start index to
  ``[0, T - s]``; the decode cache write reproduces the clamp (a write at
  ``cache_len > T - s`` lands at ``T - s``), while the validity mask and
  the positions keep the unclamped ``cache_len``, as in the reference.
* jnp's einsum promotes mixed dtypes (a bf16 cache against f32 queries);
  torch's does not, so ``_einsum`` promotes first.

The decode caches are written in place: the returned cache is the tensor
that was passed in.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -2.0e38


def _einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with jnp's dtype promotion."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in xs))


def normal(gen, shape, scale: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32, then cast: from a
    ``torch.Generator`` on ``device`` (on the card for the card), or from
    a ``numpy.random.Generator`` on the host (the tests' and the pins'
    numpy-seeded weights), copied to ``device``."""
    if isinstance(gen, np.random.Generator):
        x = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32))
        x = x.to(device)
    else:
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding.  x: (B, S, H, dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    pos = positions.to(torch.float32)
    if pos.ndim == 1:
        pos = pos[None, :]                       # (1|B, S)
    ang = pos[..., None] * freq                  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: float):
    """``tanh(logits / cap) * cap``, out of place: tanh's backward reads
    its own output, which an in-place multiply would overwrite."""
    if not cap:
        return logits
    return torch.tanh(logits / cap) * cap


def swiglu(x, p):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def _attend(q, k, v, q_pos, k_pos, window: int, cap: float):
    """Chunked attention core.

    q: (B, C, KV, G, dh); k, v: (B, T, KV, dh).
    q_pos: (C,) or (B, C); k_pos: (T,) absolute key positions.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bckgd,btkd->bckgt", q.float(), k.float()) * scale
    logits = softcap(logits, cap)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]
    mask = qp[:, :, None] >= k_pos[None, None, :]          # causal (B,C,T)
    if window:
        mask &= (qp[:, :, None] - k_pos[None, None, :]) < window
    logits = torch.where(mask[:, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bckgt,btkd->bckgd", probs, v)


def _chunks(s: int, q_chunk: int) -> Tuple[int, int]:
    """The reference's query chunking: ``n`` chunks of ``c`` tokens.  It
    covers only ``n * c`` tokens, and the reference fails at its reshape
    when that is short of ``s`` (e.g. ``s = 2049`` at ``q_chunk = 1024``);
    the port refuses those lengths up front."""
    n = max(s // q_chunk, 1)
    c = s // n
    if n * c != s:
        raise ValueError(
            f"sequence length {s} is not a multiple of its chunk {c} "
            f"(q_chunk={q_chunk}: {n} chunks of {c} cover {n * c} tokens); "
            f"the reference refuses it too")
    return n, c


def attention(x, p, cfg, *, positions, window: int = 0,
              kv_cache: Optional[Tuple] = None,
              cache_len: Optional[int] = None,
              q_chunk: int = 1024):
    """GQA attention block body (no residual/norm).

    Train/prefill (kv_cache=None): returns (out, (k, v)) with this call's
    keys/values for cache building.  Decode (kv_cache=(ck, cv)): x is
    (B, s, D); new k/v are written in place at position ``cache_len`` (a
    Python int, clamped as ``dynamic_update_slice`` clamps); returns
    (out, (ck, cv)).

    ``window``: 0 = global causal, else local band (static per layer).
    ``positions``: an integer tensor on x's device, (s,) or (B, s).
    """
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    k = _einsum("bsd,dhk->bshk", x, p["wk"])
    v = _einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions)
    k = rope(k, positions)

    if kv_cache is not None:
        ck, cv = kv_cache
        t = ck.shape[1]
        if s > t:
            raise ValueError(f"{s} tokens do not fit a cache of {t}")
        start = min(max(cache_len, 0), t - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        k_pos = torch.arange(t, device=x.device)
        valid = k_pos < cache_len + s      # tokens present after this write
        kp = torch.where(valid, k_pos, 2 ** 30)
        qr = q.reshape(b, s, kv, g, dh)
        out = _attend(qr, ck, cv, positions, kp, window, cfg.attn_softcap)
        out = out.reshape(b, s, h, dh)
        return _einsum("bshk,hkd->bsd", out, p["wo"]), (ck, cv)

    # Train / prefill: Python-loop flash-style chunking; local windows
    # slice only the needed key range.
    qr = q.reshape(b, s, kv, g, dh)
    n_chunks, c = _chunks(s, q_chunk)
    outs = []
    for i in range(n_chunks):
        lo_q = i * c
        kv_lo = 0 if not window else (max(0, lo_q - window + 1) // 128) * 128
        kv_hi = lo_q + c
        q_pos = positions[..., lo_q:lo_q + c]
        o = _attend(qr[:, lo_q:lo_q + c], k[:, kv_lo:kv_hi],
                    v[:, kv_lo:kv_hi], q_pos,
                    torch.arange(kv_lo, kv_hi, device=x.device), window,
                    cfg.attn_softcap)
        outs.append(o)
    out = torch.cat(outs, dim=1).reshape(b, s, h, dh)
    return _einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def init_attn(gen, cfg, dtype=torch.bfloat16, device="cpu"):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = d ** -0.5
    return {
        "wq": normal(gen, (d, h, dh), s, dtype, device),
        "wk": normal(gen, (d, kv, dh), s, dtype, device),
        "wv": normal(gen, (d, kv, dh), s, dtype, device),
        "wo": normal(gen, (h, dh, d), (h * dh) ** -0.5, dtype, device),
    }


def init_mlp(gen, d, f, dtype=torch.bfloat16, device="cpu"):
    return {
        "w_gate": normal(gen, (d, f), d ** -0.5, dtype, device),
        "w_up": normal(gen, (d, f), d ** -0.5, dtype, device),
        "w_down": normal(gen, (f, d), f ** -0.5, dtype, device),
    }
