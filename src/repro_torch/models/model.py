"""Unified decoder covering all 10 assigned architectures, the counterpart
of ``src/repro/models/model.py``.

One parameter dict + three entry points:
  * ``forward(params, tokens, cfg)``            — train/prefill logits,
  * ``prefill(params, tokens, cfg, state)``     — logits + decode state,
  * ``decode_step(params, tok, cfg, state)``    — one token vs cached state.

Families:
  dense   — pre-norm GQA + SwiGLU (granite/minicpm/codeqwen/internvl2
            backbone/musicgen); gemma2 adds local/global alternation,
            logit softcaps and post-norms.
  moe     — dense attention + routed-experts FFN (deepseek-moe, olmoe).
  ssm     — Mamba1 stack, attention-free (falcon-mamba).
  hybrid  — Mamba2 stack with a shared (tied-weights) attention+FFN block
            every ``shared_attn_every`` layers (zamba2).

Modality-frontend stubs (``cfg.embed_inputs``): inputs are precomputed
(B, S, D) embeddings; the embedding table is skipped on input but the LM
head stays.

The parameters are plain nested dicts and lists of tensors with the
reference's pytree layout and names (``layers.{i}.attn.wq`` …; see
``convert.py``), all on one device, which the entry points follow.

``forward(..., remat=True)`` recomputes each layer block in the backward
pass (``torch.utils.checkpoint``, non-reentrant), as the reference wraps
each block in ``jax.checkpoint``.  The reference's ``sp`` option (the
residual stream sharded over a ``model`` mesh axis) has no counterpart:
one model on one card has no mesh axis to shard over.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint
# ``checkpoint`` imports torch._dynamo at its first call.  It is imported
# here instead: that import leaves a reference cycle through a frame of
# ``torch.fx.wrap`` that keeps every frame on the importing stack alive,
# and with them a first train step's tensors, until a full collection.
import torch._dynamo  # noqa: E402,F401

from ..device import resolve_device
from . import layers as L
from . import mamba as M
from . import moe as X


class DecodeState(NamedTuple):
    """Per-layer decode caches + current length.

    ``length`` is a Python int, so no decode step reads a device scalar
    back to the host.  The KV caches are written in place by ``prefill``
    and ``decode_step``; the state they return holds the same tensors."""
    caches: Tuple              # per layer: (k, v) | MambaState | (st, (k, v))
    length: int                # tokens already cached


# ---------------------------------------------------------------------------
# Layer plumbing
# ---------------------------------------------------------------------------


def layer_kinds(cfg) -> Tuple[str, ...]:
    """Per-layer kind: 'attn' | 'moe_attn' | 'mamba1' | 'mamba2' |
    'mamba2+shared'.

    hybrid (zamba2): mamba2 everywhere; a tied shared attention block fires
    every ``shared_attn_every`` layers (its params are stored once under
    params['shared_block']).
    """
    if cfg.family == "dense":
        return tuple("attn" for _ in range(cfg.n_layers))
    if cfg.family == "moe":
        return tuple("moe_attn" for _ in range(cfg.n_layers))
    if cfg.family == "ssm":
        return tuple("mamba1" for _ in range(cfg.n_layers))
    if cfg.family == "hybrid":
        k = max(cfg.shared_attn_every, 1)
        return tuple("mamba2+shared" if (i % k == k - 1) else "mamba2"
                     for i in range(cfg.n_layers))
    raise ValueError(cfg.family)


def local_window_of(cfg, i: int) -> int:
    """gemma2: even layers local (sliding window), odd layers global."""
    if cfg.alt_local_global and cfg.local_window and i % 2 == 0:
        return cfg.local_window
    return 0


def init_params(generator, cfg, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and scales, drawn in
    order from ``generator``: a ``torch.Generator`` on ``device`` (the
    reference's server draws from a seed the same way; the values are the
    port's own), or a ``numpy.random.Generator``, whose draws are made on
    the host and copied (numpy-seeded weights, as the tests carry into
    both packages).  ``device`` defaults to the card."""
    dev = resolve_device(device)
    g = generator
    params: Dict[str, Any] = {
        "embed": L.normal(g, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                          dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "lm_head": L.normal(g, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5,
                            dtype, dev),
        "layers": [],
    }

    def norm():
        return torch.zeros((cfg.d_model,), dtype=dtype, device=dev)

    for kind in layer_kinds(cfg):
        lp: Dict[str, Any] = {"ln1": norm()}
        if kind == "attn":
            lp["attn"] = L.init_attn(g, cfg, dtype, dev)
            lp["ln2"] = norm()
            lp["mlp"] = L.init_mlp(g, cfg.d_model, cfg.d_ff, dtype, dev)
            if cfg.name.startswith("gemma2"):
                lp["post_ln1"] = norm()
                lp["post_ln2"] = norm()
        elif kind == "moe_attn":
            lp["attn"] = L.init_attn(g, cfg, dtype, dev)
            lp["ln2"] = norm()
            lp["moe"] = X.init_moe(g, cfg, dtype, dev)
        elif kind == "mamba1":
            lp["mamba"] = M.init_mamba1(g, cfg, dtype, dev)
        else:  # mamba2 / mamba2+shared
            lp["mamba"] = M.init_mamba2(g, cfg, dtype, dev)
        params["layers"].append(lp)
    if cfg.family == "hybrid":
        params["shared_block"] = {
            "ln1": norm(),
            "attn": L.init_attn(g, cfg, dtype, dev),
            "ln2": norm(),
            "mlp": L.init_mlp(g, cfg.d_model, cfg.d_ff, dtype, dev),
        }
    return params


def _attn_mlp_block(x, lp, cfg, *, positions, window, kv_cache, cache_len,
                    gemma2: bool, moe: bool):
    """Pre-norm attention + FFN residual block. Returns (x, new_cache, aux)."""
    h = L.rms_norm(x, lp["ln1"], cfg.eps)
    a, new_cache = L.attention(h, lp["attn"], cfg, positions=positions,
                               window=window, kv_cache=kv_cache,
                               cache_len=cache_len)
    if gemma2:
        a = L.rms_norm(a, lp["post_ln1"], cfg.eps)
    x = x + a
    h = L.rms_norm(x, lp["ln2"], cfg.eps)
    aux = None
    if moe:
        f, aux = X.moe_ffn(h, lp["moe"], cfg)
    else:
        f = L.swiglu(h, lp["mlp"])
    if gemma2:
        f = L.rms_norm(f, lp["post_ln2"], cfg.eps)
    return x + f, new_cache, aux


def _backbone(params, x, cfg, *, positions, caches=None, cache_len=None,
              remat: bool = False):
    """Run the layer stack.  caches: per-layer decode caches (or None).
    ``remat``: recompute each block in the backward pass (train/eval
    forward only, as in the reference).

    Returns (hidden, new_caches, total_aux_loss).
    """
    kinds = layer_kinds(cfg)
    gemma2 = cfg.name.startswith("gemma2")
    decode = caches is not None
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(fn, *args, **kw):
        if remat and not decode:
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return fn(*args, **kw)

    def attn_block(xi, lpi, *, window, moe, cache):
        return block(_attn_mlp_block, xi, lpi, cfg, positions=positions,
                     window=window, kv_cache=cache, cache_len=cache_len,
                     gemma2=gemma2, moe=moe)

    def mamba_layer(xi, lpi, *, v2, cache):
        h = L.rms_norm(xi, lpi["ln1"], cfg.eps)
        fn = M.mamba2_block if v2 else M.mamba1_block
        y, st = fn(h, lpi["mamba"], cfg, state=cache)
        return xi + y, st

    def mamba_block(xi, lpi, *, v2, cache):
        return block(mamba_layer, xi, lpi, v2=v2, cache=cache)

    for i, (kind, lp) in enumerate(zip(kinds, params["layers"])):
        cache = caches[i] if decode else None
        if kind in ("attn", "moe_attn"):
            x, nc, aux = attn_block(x, lp, window=local_window_of(cfg, i),
                                    moe=(kind == "moe_attn"), cache=cache)
            if aux is not None:
                aux_total = aux_total + aux
            new_caches.append(nc)
        elif kind == "mamba1":
            x, st = mamba_block(x, lp, v2=False, cache=cache)
            new_caches.append(st)
        else:  # mamba2 (+shared)
            shared_cache = None
            if kind == "mamba2+shared" and decode:
                cache, shared_cache = cache  # (MambaState, (k, v))
            x, st = mamba_block(x, lp, v2=True, cache=cache)
            if kind == "mamba2+shared":
                x, sc, _ = attn_block(x, params["shared_block"], window=0,
                                      moe=False, cache=shared_cache)
                new_caches.append((st, sc))
            else:
                new_caches.append(st)
    return x, tuple(new_caches), aux_total


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def embed(params, tokens, cfg):
    """tokens: (B, S) integer ids, or (B, S, D) precomputed embeddings."""
    table = params["embed"]
    if cfg.embed_inputs and tokens.ndim == 3:
        return tokens.to(table.dtype)
    x = table[tokens]
    if cfg.name.startswith("gemma2"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(params, x, cfg):
    """Final norm + LM head, f32 logits (B, S, V)."""
    x = L.rms_norm(x, params["final_norm"], cfg.eps)
    logits = x.float() @ params["lm_head"].float()
    return L.softcap(logits, cfg.final_softcap)


def _positions(start: int, s: int, device) -> torch.Tensor:
    return torch.arange(start, start + s, device=device)


def forward(params, tokens, cfg, *, positions: Optional[torch.Tensor] = None,
            remat: bool = False):
    """Train/eval forward: full-sequence logits (B, S, V) + aux loss.
    ``remat``: recompute each layer block in the backward pass."""
    s = tokens.shape[1]
    dev = params["embed"].device
    if positions is None:
        positions = _positions(0, s, dev)
    x = embed(params, tokens, cfg)
    x, _, aux = _backbone(params, x, cfg, positions=positions, remat=remat)
    return unembed(params, x, cfg), aux


def init_decode_state(params, cfg, batch: int, max_len: int,
                      dtype=torch.bfloat16) -> DecodeState:
    """Allocate decode caches on the parameters' device: KV (B, T, KV, dh)
    / MambaState per layer."""
    dev = params["embed"].device
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)

    def kv():
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    caches = []
    for kind in layer_kinds(cfg):
        if kind in ("attn", "moe_attn"):
            caches.append(kv())
        elif kind == "mamba1":
            caches.append(M.mamba1_init_state(cfg, batch, dtype, dev))
        elif kind == "mamba2+shared":
            caches.append((M.mamba2_init_state(cfg, batch, dtype, dev), kv()))
        else:
            caches.append(M.mamba2_init_state(cfg, batch, dtype, dev))
    return DecodeState(tuple(caches), 0)


def prefill(params, tokens, cfg, state: DecodeState):
    """Prefill the decode state with a prompt.  Returns (logits, state).

    Attention layers write tokens into their caches at ``state.length``;
    mamba layers fold the prompt into their recurrent state.
    """
    s = tokens.shape[1]
    positions = _positions(state.length, s, params["embed"].device)
    x = embed(params, tokens, cfg)
    x, caches, _ = _backbone(params, x, cfg, positions=positions,
                             caches=state.caches, cache_len=state.length)
    return unembed(params, x, cfg), DecodeState(caches, state.length + s)


def decode_step(params, tok, cfg, state: DecodeState):
    """One decode step.  tok: (B,) integer ids (or (B, 1, D) embedded).

    Returns (logits (B, V), new state).
    """
    if tok.ndim == 1:
        tok = tok[:, None]
    positions = _positions(state.length, 1, params["embed"].device)
    x = embed(params, tok, cfg)
    x, caches, _ = _backbone(params, x, cfg, positions=positions,
                             caches=state.caches, cache_len=state.length)
    logits = unembed(params, x, cfg)
    return logits[:, 0], DecodeState(caches, state.length + 1)
