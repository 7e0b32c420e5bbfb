"""Core transformer layers: RMSNorm, RoPE, GQA attention (local/global,
softcap), SwiGLU.  Pure functions over parameter dicts of tensors, the
counterpart of ``src/repro/models/layers.py``.

Attention is einsum + softmax with f32 logits, the reference's masks and
``NEG_INF`` (not ``scaled_dot_product_attention``, which has no softcap).
Train/eval attention runs in Python query chunks so the full (S, S) score
matrix never materializes; local layers slice only the needed key range,
from a 128-aligned ``kv_lo``.

Sharding: activations are annotated batch-over-("pod","data") and
heads/ffn-over-"model" via ``sharding.shard`` (a no-op without an active
sharding env or on plain tensors; annotations whose dims don't divide the
mesh are dropped).  ``set_attn_opt`` selects the reference's optimized
serve-attention layouts (``_ATTN_OPT``).  A sharded (DTensor) decode cache
is written shard by shard and keeps its placements.

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
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from .sharding import BATCH_AXES, MODEL_AXIS, active_sizes, from_shard, \
    shard

NEG_INF = -2.0e38

# Serve-path attention sharding policy.  False (baseline): the layouts
# follow from the parameter/cache placements.  True (the reference's
# optimized policy):
#   * decode (s==1): constrain q to the SAME dim layout as the KV cache
#     (kv-heads over "model", or d_head when kv∤tp) so the logits einsum
#     contracts locally;
#   * prefill (s>1): shard q/out on the SEQUENCE dim over "model"
#     (flash-style SP) so the (S x T) logits stay local.
_ATTN_OPT = False


def set_attn_opt(on: bool) -> None:
    global _ATTN_OPT
    _ATTN_OPT = bool(on)


def _einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with jnp's dtype promotion."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in xs))


def _project(eq: str, x, w):
    """``_einsum(eq, x, w)`` for an activation ``x`` and a weight ``w``.

    On DTensors it runs as GSPMD partitions the reference's projection:
    the weight keeps its "model" placement and is gathered over the batch
    axes (its FSDP shards), the activation is batch-sharded and laid out
    to match the weight's "model" dim (gathered where that dim is not
    one of its own), the einsum runs on the local shards, and the result
    is placed by the same rule (a pending sum over "model" when the
    weight's sharded dim is contracted).  DTensor's own einsum flattens
    (heads, d_head) into one dim and cannot split it back when "model"
    divides d_head but not the head count (gemma2's 8 heads over 16)."""
    if not isinstance(w, DTensor):
        return _einsum(eq, x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    lhs, out = eq.split("->")
    xl_, wl_ = lhs.split(",")
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    batch = [j for j, a in enumerate(names) if a in BATCH_AXES]
    nb = 1
    for j in batch:
        nb *= mesh.size(j)
    b_ok = x.shape[0] % nb == 0
    xp, wp, op, xg, wg = [], [], [], [], []
    for j, a in enumerate(names):
        if j in batch:
            xp.append(Shard(0) if b_ok else Replicate())
            wp.append(Replicate())
            op.append(Shard(out.index(xl_[0])) if b_ok else Replicate())
            xg.append(xp[-1])
            wg.append(Partial() if b_ok else Replicate())
            continue
        pl = w.placements[j]
        letter = wl_[pl.dim] if isinstance(pl, Shard) else None
        wp.append(pl if letter else Replicate())
        wg.append(wp[-1])
        if letter is None:
            xp.append(Replicate())
            xg.append(Replicate())
            op.append(Replicate())
        elif letter in xl_:                    # contracted (or shared)
            xp.append(Shard(xl_.index(letter)))
            xg.append(xp[-1])
            op.append(Shard(out.index(letter)) if letter in out
                      else Partial())
        else:                                  # an output dim of w's
            xp.append(Replicate())
            xg.append(Partial())
            op.append(Shard(out.index(letter)))
    if not isinstance(x, DTensor):
        x = distribute_tensor(x, mesh, [Replicate()] * len(names),
                              src_data_rank=None)
    xl = x.to(dt).redistribute(mesh, xp).to_local(grad_placements=xg)
    wl = w.to(dt).redistribute(mesh, wp).to_local(grad_placements=wg)
    yl = torch.einsum(eq, xl, wl)
    sizes = {c: n for t, sp in ((xl_, x.shape), (wl_, w.shape))
             for c, n in zip(t, sp)}
    return from_shard(yl, [sizes[c] for c in out], op, mesh)


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


def matmul(eq: str, x, w):
    """``x @ w`` for an activation and a 2-D weight; on a DTensor weight
    the same product as ``_project(eq, ...)`` lays it out."""
    return _project(eq, x, w) if isinstance(w, DTensor) else x @ w


def swiglu(x, p):
    h = F.silu(matmul("bsd,df->bsf", x, p["w_gate"])) \
        * matmul("bsd,df->bsf", x, p["w_up"])
    h = shard(h, BATCH_AXES, None, MODEL_AXIS)
    return matmul("bsf,fd->bsd", h, p["w_down"])


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


def _attend_rows(qr, k, v, rows):
    """``rows(q, k, v, lo)`` attends query rows ``[lo, lo + q.shape[1])`` of
    the sequence to all of ``k``/``v``; this runs it on the whole of plain
    tensors, and sequence-parallel over "model" on DTensors: each model
    rank takes a contiguous slice of the query rows (the reference's
    ``_ATTN_OPT`` prefill layout), with the keys and values gathered
    over "model" and the batch sharded over ("pod","data").  DTensor's
    own layout for the d_head-sharded contraction of gemma2 (8 heads
    over 16) reduce-scatters f32 partial score matrices: 68.7 GB a layer
    on one rank at prefill_32k, more than a card holds.  Each row sees
    the key range and mask it sees unsharded."""
    if not (isinstance(qr, DTensor) or isinstance(k, DTensor)
            or isinstance(v, DTensor)):
        return rows(qr, k, v, 0)
    mesh = next(t for t in (qr, k, v) if isinstance(t, DTensor)).device_mesh
    names = mesh.mesh_dim_names
    nb, tp, mi = 1, 1, None
    for j, a in enumerate(names):
        if a in BATCH_AXES:
            nb *= mesh.size(j)
        elif a == MODEL_AXIS:
            tp, mi = mesh.size(j), j
    b_ok = qr.shape[0] % nb == 0
    seq_ok = mi is not None and qr.shape[1] % tp == 0

    def on(model):
        return [model if j == mi else
                (Shard(0) if b_ok and a in BATCH_AXES else Replicate())
                for j, a in enumerate(names)]

    qp = on(Shard(1) if seq_ok else Replicate())
    full = on(Replicate())
    local = []
    for t, want, grad in ((qr, qp, qp), (k, full, on(Partial())),
                          (v, full, on(Partial()))):
        if not isinstance(t, DTensor):
            t = distribute_tensor(t, mesh, [Replicate()] * len(names),
                                  src_data_rank=None)
        local.append(t.redistribute(mesh, want).to_local(
            grad_placements=grad if seq_ok else want))
    n = qr.shape[1] // tp if seq_ok else qr.shape[1]
    lo = mesh.get_coordinate()[mi] * n if seq_ok else 0
    return from_shard(rows(*local, lo).contiguous(),
                      tuple(qr.shape[:-1]) + (v.shape[-1],), qp, mesh)


def _attend_aligned(qr, ck, cv, q_pos, k_pos, window: int, cap: float):
    """``_attend`` for one decode token with ``_ATTN_OPT``: q laid out as
    the cache is (kv-heads, else d_head, over "model"), so the logits
    contract on each rank's own shard, as the reference's constraint
    makes GSPMD do.  A d_head-sharded contraction leaves a pending sum of
    the (B, 1, KV, G, T) logits, summed across "model" before the
    softmax; nothing else crosses ranks."""
    mesh = ck.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index(MODEL_AXIS)
    cpl = ck.placements[mi]
    heads = isinstance(cpl, Shard) and cpl.dim == 2
    rest = [pl if j != mi else None for j, pl in enumerate(ck.placements)]

    def on(model):
        return [model if j == mi else pl for j, pl in enumerate(rest)]

    q = qr.redistribute(mesh, on(Shard(2) if heads else Shard(4)))
    ql, kl, vl = q.to_local(), ck.to_local(), cv.to_local()
    scale = qr.shape[-1] ** -0.5
    logits = torch.einsum("bckgd,btkd->bckgt", ql.float(), kl.float()) * scale
    logits = from_shard(logits, tuple(qr.shape[:-1]) + (ck.shape[1],),
                        on(Shard(2) if heads else Partial()), mesh)
    logits = logits.redistribute(mesh, on(Shard(2) if heads else
                                          Replicate())).to_local()
    logits = softcap(logits, cap)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]
    mask = qp[:, :, None] >= k_pos[None, None, :]
    if window:
        mask &= (qp[:, :, None] - k_pos[None, None, :]) < window
    logits = torch.where(mask[:, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(vl.dtype)
    out = torch.einsum("bckgt,btkd->bckgd", probs, vl).contiguous()
    return from_shard(out, tuple(qr.shape[:-1]) + (cv.shape[-1],),
                      on(Shard(2) if heads else Shard(4)), mesh)


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


def _split_heads(q, kv: int, g: int):
    """(B, S, H, dh) -> (B, S, KV, G, dh).  A DTensor whose heads are
    sharded over a "model" axis that does not divide KV is first gathered
    over it (DTensor cannot split a sharded dim unevenly; the attention
    lays its rows out again anyway)."""
    b, s, _, dh = q.shape
    if isinstance(q, DTensor) and any(
            isinstance(pl, Shard) and pl.dim == 2
            and kv % q.device_mesh.size(j)
            for j, pl in enumerate(q.placements)):
        q = q.redistribute(q.device_mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl
            for pl in q.placements])
    return q.reshape(b, s, kv, g, dh)


def _write_cache(c, start: int, new):
    """``c[:, start:start + s] = new`` in place.  A DTensor cache keeps its
    placements: ``new`` is redistributed to them (replicated along the
    sequence dim) and each rank writes the part of the window its shard
    holds, so a sequence-sharded cache (``long_500k``) takes its write
    on the rank that owns the positions."""
    if not isinstance(c, DTensor):
        if isinstance(new, DTensor):
            new = new.full_tensor()
        c[:, start:start + new.shape[1]] = new
        return
    mesh, places = c.device_mesh, list(c.placements)
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
            for pl in places]
    if isinstance(new, DTensor):
        new = new.redistribute(mesh, want)
    else:
        new = distribute_tensor(new, mesh, want, src_data_rank=None)
    local, nl = c.to_local(), new.to_local()
    off, size = 0, c.shape[1]
    coord = mesh.get_coordinate()
    for j, pl in enumerate(places):
        if isinstance(pl, Shard) and pl.dim == 1:
            size //= mesh.size(j)
            off += coord[j] * size
    s = nl.shape[1]
    lo, hi = max(start, off), min(start + s, off + local.shape[1])
    if lo < hi:
        local[:, lo - off:hi - off] = nl[:, lo - start:hi - start]


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
    q = _project("bsd,dhk->bshk", x, p["wq"])
    k = _project("bsd,dhk->bshk", x, p["wk"])
    v = _project("bsd,dhk->bshk", x, p["wv"])
    q = shard(rope(q, positions), BATCH_AXES, None, MODEL_AXIS, None)
    k = rope(k, positions)

    if kv_cache is not None:
        ck, cv = kv_cache
        t = ck.shape[1]
        if s > t:
            raise ValueError(f"{s} tokens do not fit a cache of {t}")
        if _ATTN_OPT:
            tp = active_sizes().get(MODEL_AXIS, 1)
            kv_e = MODEL_AXIS if tp > 1 and kv % tp == 0 else None
            dh_e = MODEL_AXIS if tp > 1 and kv_e is None \
                and dh % tp == 0 else None
            k = shard(k, BATCH_AXES, None, kv_e, dh_e)
            v = shard(v, BATCH_AXES, None, kv_e, dh_e)
        start = min(max(cache_len, 0), t - s)
        _write_cache(ck, start, k.to(ck.dtype))
        _write_cache(cv, start, v.to(cv.dtype))
        k_pos = torch.arange(t, device=x.device)
        valid = k_pos < cache_len + s      # tokens present after this write
        kp = torch.where(valid, k_pos, 2 ** 30)
        qr = _split_heads(q, kv, g)
        if _ATTN_OPT:
            if s > 1:
                # prefill: flash-style sequence parallelism on q/out
                qr = shard(qr, BATCH_AXES, MODEL_AXIS, None, None, None)
            else:
                # decode: align q with the cache layout -> local contraction
                qr = shard(qr, BATCH_AXES, None, kv_e, None, dh_e)
        if _ATTN_OPT and s == 1 and (kv_e or dh_e):
            out = _attend_aligned(qr, ck, cv, positions, kp, window,
                                  cfg.attn_softcap)
        elif isinstance(qr, DTensor) or isinstance(ck, DTensor):
            out = _attend_rows(qr, ck, cv, lambda ql, kl, vl, lo: _attend(
                ql, kl, vl, positions[..., lo:lo + ql.shape[1]], kp, window,
                cfg.attn_softcap))
        else:
            out = _attend(qr, ck, cv, positions, kp, window, cfg.attn_softcap)
        if _ATTN_OPT and s > 1:
            out = shard(out, BATCH_AXES, MODEL_AXIS, None, None, None)
        out = out.reshape(b, s, h, dh)
        o = _project("bshk,hkd->bsd", out, p["wo"])
        return shard(o, BATCH_AXES, None, None), (ck, cv)

    # Train / prefill: Python-loop flash-style chunking; local windows
    # slice only the needed key range.
    qr = _split_heads(q, kv, g)
    n_chunks, c = _chunks(s, q_chunk)

    def rows(ql, kl, vl, lo):           # query rows [lo, lo + len) of s
        outs = []
        for i in range(n_chunks):
            lo_q = i * c
            a, e = max(lo_q, lo), min(lo_q + c, lo + ql.shape[1])
            if a >= e:
                continue
            kv_lo = 0 if not window else \
                (max(0, lo_q - window + 1) // 128) * 128
            kv_hi = lo_q + c
            outs.append(_attend(
                ql[:, a - lo:e - lo], kl[:, kv_lo:kv_hi], vl[:, kv_lo:kv_hi],
                positions[..., a:e],
                torch.arange(kv_lo, kv_hi, device=x.device), window,
                cfg.attn_softcap))
        return torch.cat(outs, dim=1)

    out = _attend_rows(qr, k, v, rows).reshape(b, s, h, dh)
    o = _project("bshk,hkd->bsd", out, p["wo"])
    return shard(o, BATCH_AXES, None, None), (k, v)


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
