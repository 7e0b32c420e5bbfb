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
each block in ``jax.checkpoint``.  ``forward(..., sp=True)`` is the
reference's Megatron-style sequence parallelism: under a sharding env
(``models/sharding.py``) the residual stream between blocks is sharded
over the ``model`` axis on the sequence dim.  Parameters may be
DTensors placed by ``launch/shardings.py``; with plain tensors and no env
every path is the unsharded one.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
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
from .sharding import BATCH_AXES, MODEL_AXIS, from_shard, shard
from .sharding import zeros as sharded_zeros


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
    # (sp: the sequence is gathered at the FFN's first projection)
    h = shard(L.rms_norm(x, lp["ln2"], cfg.eps), BATCH_AXES, None, None)
    aux = None
    if moe:
        f, aux = X.moe_ffn(h, lp["moe"], cfg)
    else:
        # the row-parallel sum taken here, as GSPMD takes it: with sp a
        # pending sum would reach the backward's weight-gradient matmuls
        # sequence-sharded, a layout DTensor plans very slowly
        f = shard(L.swiglu(h, lp["mlp"]), BATCH_AXES, None, None)
    if gemma2:
        f = L.rms_norm(f, lp["post_ln2"], cfg.eps)
    return x + f, new_cache, aux


def _backbone(params, x, cfg, *, positions, caches=None, cache_len=None,
              remat: bool = False, sp: bool = False):
    """Run the layer stack.  caches: per-layer decode caches (or None).
    ``remat``: recompute each block in the backward pass (train/eval
    forward only, as in the reference).

    ``sp``: Megatron-style sequence parallelism — the inter-block residual
    stream is sharded over the *model* axis on the sequence dim, so saved
    activations cost (B·S·D)/(dp·tp) per layer instead of (B·S·D)/dp.
    The redistributions gather it at each block's first projection and
    scatter it after its last.

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

    def sp_shard(t):
        # Without sp the residual is laid out batch-sharded and replicated
        # at each block boundary: DTensor would otherwise carry the row-
        # parallel matmuls' pending sums on into the next block, where
        # GSPMD sums them at once.  (A no-op without an env.)
        if sp:
            return shard(t, BATCH_AXES, MODEL_AXIS, None)
        return shard(t, BATCH_AXES, None, None)

    def attn_layer(xi, lpi, **kw):
        xi, nc, aux = _attn_mlp_block(xi, lpi, cfg, **kw)
        return sp_shard(xi), nc, aux

    def attn_block(xi, lpi, *, window, moe, cache):
        return block(attn_layer, xi, lpi, positions=positions,
                     window=window, kv_cache=cache, cache_len=cache_len,
                     gemma2=gemma2, moe=moe)

    def mamba_layer(xi, lpi, *, v2, cache):
        h = shard(L.rms_norm(xi, lpi["ln1"], cfg.eps), BATCH_AXES, None,
                  None)
        fn = M.mamba2_block if v2 else M.mamba1_block
        y, st = fn(h, lpi["mamba"], cfg, state=cache)
        return sp_shard(xi + y), st

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
        x = tokens.to(table.dtype)
    else:
        x = _lookup(table, tokens) if isinstance(table, DTensor) \
            else table[tokens]
        if cfg.name.startswith("gemma2"):
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return shard(x, BATCH_AXES, None, None)


def _lookup(table, tokens):
    """``table[tokens]`` for a DTensor table: its FSDP shards gathered,
    each rank looks up the ids in its own vocab slice ("model"; the others
    give zero rows) for its own batch rows, and the rows' pending sum over
    "model" is left to ``shard``.  Every op stays on the rank's shard, in
    the backward too (DTensor's own masked lookup cannot take the
    backward's pending sum)."""
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    nb = 1
    for j, a in enumerate(names):
        if a in BATCH_AXES:
            nb *= mesh.size(j)
    b_ok = tokens.shape[0] % nb == 0
    split = [j for j, pl in enumerate(table.placements)
             if isinstance(pl, Shard) and pl.dim == 0 and names[j]
             not in BATCH_AXES]
    want_t = [Shard(0) if j in split else Replicate()
              for j in range(len(names))]
    grad_t = [Shard(0) if j in split else
              (Partial() if b_ok and a in BATCH_AXES else Replicate())
              for j, a in enumerate(names)]
    rows_pl = [Shard(0) if b_ok and a in BATCH_AXES else Replicate()
               for a in names]
    tl = table.redistribute(mesh, want_t).to_local(grad_placements=grad_t)
    tok = tokens.redistribute(mesh, rows_pl) if isinstance(
        tokens, DTensor) else distribute_tensor(tokens, mesh, rows_pl,
                                                src_data_rank=None)
    tok = tok.to_local()
    n, off = tl.shape[0], 0
    coord = mesh.get_coordinate()
    for j in split:
        off += coord[j] * n
    idx = tok.long() - off
    mine = (idx >= 0) & (idx < n)
    rows = tl[idx.clamp(0, n - 1)] * mine[..., None].to(tl.dtype)
    out = [Partial() if j in split else pl for j, pl in enumerate(rows_pl)]
    return from_shard(rows, tuple(tokens.shape) + (table.shape[1],), out,
                      mesh)


def unembed(params, x, cfg):
    """Final norm + LM head, f32 logits (B, S, V)."""
    x = shard(L.rms_norm(x, params["final_norm"], cfg.eps), BATCH_AXES, None,
              None)
    logits = L.matmul("bsd,dv->bsv", x.float(), params["lm_head"].float())
    logits = L.softcap(logits, cfg.final_softcap)
    return shard(logits, BATCH_AXES, None, MODEL_AXIS)


def _positions(start: int, s: int, device) -> torch.Tensor:
    return torch.arange(start, start + s, device=device)


def forward(params, tokens, cfg, *, positions: Optional[torch.Tensor] = None,
            remat: bool = False, sp: bool = False):
    """Train/eval forward: full-sequence logits (B, S, V) + aux loss.
    ``remat``: recompute each layer block in the backward pass; ``sp``:
    sequence-parallel residuals (a no-op without a sharding env)."""
    s = tokens.shape[1]
    dev = params["embed"].device
    if positions is None:
        positions = _positions(0, s, dev)
    x = embed(params, tokens, cfg)
    x, _, aux = _backbone(params, x, cfg, positions=positions, remat=remat,
                          sp=sp)
    return unembed(params, x, cfg), aux


def init_decode_state(params, cfg, batch: int, max_len: int,
                      dtype=torch.bfloat16, specs=None) -> DecodeState:
    """Allocate decode caches on the parameters' device: KV (B, T, KV, dh)
    / MambaState per layer.  ``specs``: a spec tree of the state's
    structure (``launch/shardings.py::decode_state_specs``); under a
    sharding env each cache is then a DTensor placed by it, of which only
    this rank's shard is allocated."""
    dev = params["embed"].device
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    spec_caches = specs.caches if specs is not None else None

    def spec(i, *path):
        s = spec_caches[i] if spec_caches is not None else None
        for k in path:
            s = s[k] if s is not None else None
        return s

    def kv(i, *path):
        return (sharded_zeros(shape, spec(i, *path, 0), dtype, dev),
                sharded_zeros(shape, spec(i, *path, 1), dtype, dev))

    def mamba(i, init, *path):
        st = init(cfg, batch, dtype, "meta")
        return M.MambaState(*(
            sharded_zeros(t.shape, spec(i, *path, j), t.dtype, dev)
            for j, t in enumerate(st)))

    caches = []
    for i, kind in enumerate(layer_kinds(cfg)):
        if kind in ("attn", "moe_attn"):
            caches.append(kv(i))
        elif kind == "mamba1":
            caches.append(mamba(i, M.mamba1_init_state))
        elif kind == "mamba2+shared":
            caches.append((mamba(i, M.mamba2_init_state, 0), kv(i, 1)))
        else:
            caches.append(mamba(i, M.mamba2_init_state))
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
