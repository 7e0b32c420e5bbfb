"""Mamba layers: Mamba1 selective scan (falcon-mamba) and Mamba2 SSD-style
(zamba2), the counterpart of ``src/repro/models/mamba.py``.

The diagonal-SSM recurrence  h_t = a_t ⊙ h_{t-1} + u_t  is an associative
scan over the sequence.  The reference's ``jax.lax.associative_scan``
becomes a Hillis-Steele scan in torch ops (``_assoc_scan``: log2(S) rounds
of the same combine, ``(a2 * a1, a2 * u1 + u2)``); the sequence is still
processed in Python-level chunks with the carry folded in by the chunk's
cumulative decay, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import normal
from .sharding import BATCH_AXES, MODEL_AXIS, shard


def _assoc_scan(a, u):
    """Inclusive scan of ``(a, u)`` along axis 1 under the combine
    ``(a1, u1), (a2, u2) -> (a2 * a1, a2 * u1 + u2)``.  ``a`` may be
    broadcastable to ``u`` in its trailing dims."""
    s, off = a.shape[1], 1
    while off < s:
        u = torch.cat([u[:, :off], a[:, off:] * u[:, :-off] + u[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, u


def chunked_diag_scan(a, u, h0=None, chunk: int = 1024):
    """Diagonal recurrence h_t = a_t ⊙ h_{t-1} + u_t along axis 1.

    a, u: (B, S, ...).  Returns (h (B, S, ...), h_last (B, ...)).
    Python-chunked associative scan; carry folded in with cumulative decay.
    """
    s = a.shape[1]
    outs = []
    carry = h0
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        cum_a, h = _assoc_scan(a[:, lo:hi], u[:, lo:hi])
        if carry is not None:
            h = h + cum_a * carry[:, None]
        carry = h[:, -1]
        outs.append(h)
    h_all = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return h_all, carry


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along axis 1.  x: (B, S, C), w: (K, C).

    ``state``: (B, K-1, C) left-context for decode/prefill continuation.
    Returns (y, new_state).
    """
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return y, xp[:, -(k - 1):] if k > 1 else state


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_inner)
    ssm: torch.Tensor    # m1: (B, d_inner, N); m2: (B, H, P, N)


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba-7b)
# ---------------------------------------------------------------------------


def mamba1_block(x, p, cfg, state: Optional[MambaState] = None,
                 chunk: int = 1024):
    """Mamba1 block.  x: (B, S, D) -> (out, new_state)."""
    di, n, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank
    xz = x @ p["in_proj"]                                   # (B,S,2*di)
    xc, z = xz[..., :di], xz[..., di:]
    xc = shard(xc, BATCH_AXES, None, MODEL_AXIS)
    conv_state = state.conv if state is not None else None
    xc, new_conv = _causal_conv(xc, p["conv_w"], conv_state)
    xc = F.silu(xc + p["conv_b"])

    xdbc = xc @ p["x_proj"]                                 # (B,S,dtr+2N)
    dt = F.softplus(xdbc[..., :dtr] @ p["dt_proj"] + p["dt_bias"])
    bmat = xdbc[..., dtr:dtr + n]                           # (B,S,N)
    cmat = xdbc[..., dtr + n:]                              # (B,S,N)
    a = -torch.exp(p["a_log"].float())                      # (di,N)

    dt32 = dt.float()
    decay = torch.exp(dt32[..., None] * a)                  # (B,S,di,N)
    inc = (dt32 * xc.float())[..., None] \
        * bmat.float()[:, :, None, :]                       # (B,S,di,N)
    h0 = state.ssm if state is not None else None
    h, h_last = chunked_diag_scan(decay, inc, h0, chunk=chunk)
    y = torch.einsum("bsdn,bsn->bsd", h, cmat.float())
    y = (y + xc.float() * p["d_skip"]).to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    return shard(out, BATCH_AXES, None, None), MambaState(new_conv, h_last)


def init_mamba1(gen, cfg, dtype=torch.bfloat16, device="cpu"):
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    return {
        "in_proj": normal(gen, (d, 2 * di), d ** -0.5, dtype, device),
        "conv_w": normal(gen, (cfg.d_conv, di), 0.2, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": normal(gen, (di, dtr + 2 * n), di ** -0.5, dtype, device),
        "dt_proj": normal(gen, (dtr, di), dtr ** -0.5, dtype, device),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype,
                              device=device),   # softplus^-1(0.01)
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=device).repeat(di, 1)),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": normal(gen, (di, d), di ** -0.5, dtype, device),
    }


def mamba1_init_state(cfg, batch: int, dtype=torch.bfloat16,
                      device="cpu") -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.d_state),
                        dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# Mamba2 (zamba2): scalar-per-head decay, (H, P, N) state, SSD-style.
# ---------------------------------------------------------------------------


def mamba2_block(x, p, cfg, state: Optional[MambaState] = None,
                 chunk: int = 512):
    """Mamba2 block.  x: (B, S, D) -> (out, new_state).

    Heads H = d_inner / head_dim; per-head scalar decay exp(dt_h * a_h).
    """
    b, s, _ = x.shape
    di, n, hd = cfg.d_inner, cfg.d_state, cfg.head_dim
    nh = di // hd
    zxbcdt = x @ p["in_proj"]                 # (B,S, 2*di + 2*N + nh)
    z = zxbcdt[..., :di]
    xc = zxbcdt[..., di:2 * di]
    bc = zxbcdt[..., 2 * di:2 * di + 2 * n]
    dt = F.softplus(zxbcdt[..., 2 * di + 2 * n:] + p["dt_bias"])
    xc = shard(xc, BATCH_AXES, None, MODEL_AXIS)

    conv_state = state.conv if state is not None else None
    conv_in = torch.cat([xc, bc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], conv_state)
    conv_out = F.silu(conv_out + p["conv_b"])
    xc = conv_out[..., :di]
    bmat = conv_out[..., di:di + n]
    cmat = conv_out[..., di + n:]

    a = -torch.exp(p["a_log"].float())                      # (nh,)
    dt32 = dt.float()                                       # (B,S,nh)
    decay = torch.exp(dt32 * a)                             # (B,S,nh)
    xh = xc.reshape(b, s, nh, hd).float()
    inc = torch.einsum("bsh,bshp,bsn->bshpn", dt32, xh,
                       bmat.float())                        # (B,S,H,P,N)
    h0 = state.ssm if state is not None else None
    h, h_last = chunked_diag_scan(decay[..., None, None], inc, h0,
                                  chunk=chunk)
    y = torch.einsum("bshpn,bsn->bshp", h, cmat.float())
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_gate(y, z, p["norm_w"])
    out = y @ p["out_proj"]
    return shard(out, BATCH_AXES, None, None), MambaState(new_conv, h_last)


def rms_gate(y, z, w, eps=1e-6):
    """Mamba2's gated RMSNorm: norm(y * silu(z)) * w."""
    y = y * F.silu(z)
    dt = y.dtype
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * (1.0 + w.float())).to(dt)


def init_mamba2(gen, cfg, dtype=torch.bfloat16, device="cpu"):
    d, di, n, hd = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.head_dim
    nh = di // hd
    conv_c = di + 2 * n
    return {
        "in_proj": normal(gen, (d, 2 * di + 2 * n + nh), d ** -0.5, dtype,
                          device),
        "conv_w": normal(gen, (cfg.d_conv, conv_c), 0.2, dtype, device),
        "conv_b": torch.zeros((conv_c,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "a_log": torch.zeros((nh,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm_w": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": normal(gen, (di, d), di ** -0.5, dtype, device),
    }


def mamba2_init_state(cfg, batch: int, dtype=torch.bfloat16,
                      device="cpu") -> MambaState:
    nh = cfg.d_inner // cfg.head_dim
    return MambaState(
        conv=torch.zeros(
            (batch, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.d_state),
            dtype=dtype, device=device),
        ssm=torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                        dtype=torch.float32, device=device),
    )
