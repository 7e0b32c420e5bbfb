"""Parameter / batch / cache partition specs for the production meshes,
the counterpart of ``src/repro/launch/shardings.py`` (its fleet specs
excepted: the fleet's ``switch`` mesh is one process, ``launch/mesh.py``).

Policy (the reference's baseline):
  * tensor parallelism over "model": attention heads (or d_head when the
    head count doesn't divide the axis), FFN width, experts, mamba
    d_inner, vocab;
  * FSDP over "data": every parameter's largest remaining dim is sharded
    over the data axis when divisible (ZeRO-3-style; DTensor inserts the
    all-gathers);
  * batch over ("pod","data"); decode KV caches shard batch over "data"
    and kv-heads (or d_head) over "model"; for ``long_500k`` (batch=1)
    the cache's sequence axis shards over "data".

All helpers return specs (``models.sharding.P``) with axis names
filtered to the given mesh, so a (1,1) host mesh yields fully-replicated
specs.  A mesh is a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``
(names and sizes, no ranks), so the tables need no process group.

A parameter's spec is chosen by substrings of its path written as
``jax.tree_util.keystr`` writes it (``['layers'][0]['attn']['wq']``), so
every leaf of every arch matches as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models import model as MDL
from ..models.mamba import MambaState
from ..models.sharding import (P, divisible_spec, filter_spec, from_shard,
                               local_shape, mesh_axes, mesh_sizes, placements)
from ..tree import flatten

BATCH = ("pod", "data")


def _axis(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def _filter(mesh, spec: P) -> P:
    return filter_spec(mesh_axes(mesh), spec)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _param_spec(path: str, shape: Tuple[int, ...], mesh,
                fsdp: bool = True) -> P:
    """Baseline TP+FSDP spec for one parameter leaf."""
    m = _axis(mesh, "model")
    d = _axis(mesh, "data")
    entries: list = [None] * len(shape)

    # --- tensor-parallel dim ------------------------------------------------
    tp_dim = None
    if "embed" in path or "lm_head" in path:
        # vocab dim over model (embed: (V, D) dim0; lm_head: (D, V) dim1)
        tp_dim = 0 if "embed" in path else 1
    elif any(k in path for k in ("wq", "wk", "wv")):
        tp_dim = 1 if shape[1] % m == 0 else (
            2 if len(shape) > 2 and shape[2] % m == 0 else None)
    elif "wo" in path:
        tp_dim = 0 if shape[0] % m == 0 else (
            1 if shape[1] % m == 0 else None)
    elif any(k in path for k in ("wg", "wu", "wd", "router")) \
            and len(shape) == 3:
        tp_dim = 0                     # experts over model
    elif "router" in path:
        tp_dim = 1                     # (D, E)
    elif any(k in path for k in ("w_gate", "w_up")):
        tp_dim = 1                     # (D, F)
    elif "w_down" in path:
        tp_dim = 0                     # (F, D)
    elif "in_proj" in path or "x_proj" in path or "dt_proj" in path:
        tp_dim = 1                     # (D, k*d_inner)
    elif "out_proj" in path:
        tp_dim = 0                     # (d_inner, D)
    elif "a_log" in path and len(shape) == 2:
        tp_dim = 0                     # mamba1 a_log: (d_inner, N)
    elif any(k in path for k in ("a_log", "d_skip", "conv", "dt_bias",
                                 "norm_w")):
        # conv_w: (K, C) — channels over model; 1-D per-channel vectors
        tp_dim = len(shape) - 1
    if tp_dim is not None and shape[tp_dim] % m == 0 and m > 1:
        entries[tp_dim] = "model"
    else:
        tp_dim = None

    # --- FSDP dim over "data" -----------------------------------------------
    if fsdp and d > 1 and _prod(shape) >= (1 << 16):
        cands = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in cands:
            if i != tp_dim and entries[i] is None and shape[i] % d == 0 \
                    and shape[i] >= d:
                entries[i] = "data"
                break
    return _filter(mesh, P(*entries))


def keystr_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` in flatten order, each path as
    ``jax.tree_util.keystr`` writes it: ``['key']`` for a dict key,
    ``[i]`` for a list or tuple index, ``.name`` for a NamedTuple
    field."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += keystr_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        out = []
        for i, v in enumerate(tree):
            key = f".{fields[i]}" if fields else f"[{i}]"
            out += keystr_paths(v, prefix + key)
        return out
    return [(prefix, tree)]


def param_specs(params, cfg, mesh, fsdp: bool = True):
    """Tree of specs matching ``params`` (tensors or meta tensors)."""
    leaves, treedef = flatten(params)
    specs = [_param_spec(path, tuple(leaf.shape), mesh, fsdp=fsdp)
             for path, leaf in keystr_paths(params)]
    assert len(specs) == len(leaves)
    return treedef.unflatten(specs)


def param_shardings(params, cfg, mesh, fsdp: bool = True):
    return tree_shardings(param_specs(params, cfg, mesh, fsdp=fsdp), mesh)


def batch_spec(mesh) -> P:
    return _filter(mesh, P(BATCH))


def div_spec(mesh, shape: Tuple[int, ...], spec: P) -> P:
    """Drop spec entries whose mesh-axis product doesn't divide the dim."""
    return divisible_spec(_filter(mesh, spec), shape, mesh_sizes(mesh))


def batch_specs_of(batch, mesh):
    """Tree of specs for a batch: dim 0 over ("pod","data") where it
    divides."""
    leaves, treedef = flatten(batch)
    return treedef.unflatten([
        div_spec(mesh, tuple(x.shape),
                 P(BATCH, *([None] * (len(x.shape) - 1)))) for x in leaves])


def batch_shardings(batch, mesh):
    return tree_shardings(batch_specs_of(batch, mesh), mesh)


def kv_cache_spec(cfg, batch: int, mesh, *, seq_shard: bool = False) -> P:
    """(B, T, KV, DH) cache spec.  seq_shard: shard T over "data"
    (sequence parallelism for batch=1 long-context)."""
    m = _axis(mesh, "model")
    d = _axis(mesh, "data")
    kv_e = "model" if cfg.n_kv_heads % m == 0 else None
    dh_e = "model" if (kv_e is None and cfg.d_head % m == 0) else None
    if seq_shard:
        return _filter(mesh, P(None, "data", kv_e, dh_e))
    b_e = BATCH if batch % (d * _axis(mesh, "pod")) == 0 else (
        "data" if batch % d == 0 else None)
    return _filter(mesh, P(b_e, None, kv_e, dh_e))


def mamba_state_spec(cfg, batch: int, mesh) -> MambaState:
    """Specs for MambaState(conv (B,K-1,C), ssm (B,di,N)|(B,H,P,N))."""
    m = _axis(mesh, "model")
    d = _axis(mesh, "data")
    b_e = "data" if batch % d == 0 and d > 1 else None
    conv_c = cfg.d_inner + (2 * cfg.d_state if cfg.ssm_version == 2 else 0)
    conv = P(b_e, None, "model" if conv_c % m == 0 else None)
    if cfg.ssm_version == 2:
        nh = cfg.d_inner // cfg.head_dim
        ssm = P(b_e, "model" if nh % m == 0 else None, None, None)
    else:
        ssm = P(b_e, "model" if cfg.d_inner % m == 0 else None, None)
    return MambaState(conv=_filter(mesh, conv), ssm=_filter(mesh, ssm))


def decode_state_specs(cfg, batch: int, mesh, *, seq_shard: bool = False):
    """Spec tree matching ``MDL.init_decode_state``'s structure."""
    kinds = MDL.layer_kinds(cfg)
    caches = []
    kv = kv_cache_spec(cfg, batch, mesh, seq_shard=seq_shard)
    for kind in kinds:
        if kind in ("attn", "moe_attn"):
            caches.append((kv, kv))
        elif kind == "mamba1":
            caches.append(mamba_state_spec(cfg, batch, mesh))
        elif kind == "mamba2+shared":
            caches.append((mamba_state_spec(cfg, batch, mesh), (kv, kv)))
        else:
            caches.append(mamba_state_spec(cfg, batch, mesh))
    return MDL.DecodeState(tuple(caches), P())


def tree_shardings(spec_tree, mesh):
    """Each spec of the tree as its DTensor placements on ``mesh`` (the
    counterpart of a ``NamedSharding``)."""
    specs, treedef = flatten(spec_tree)
    return treedef.unflatten([tuple(placements(s, mesh)) for s in specs])


def opt_state_specs(pspecs, mesh):
    """AdamW moments follow the parameter specs; step is replicated."""
    from ..train.optimizer import OptState
    return OptState(m=pspecs, v=pspecs, step=P())


def place(tree, specs, mesh):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` placed by its spec
    in ``specs`` (a tree of the same structure), the counterpart of
    ``jax.device_put(tree, shardings)``.  Every rank holds the same full
    tensors (the same seed), so each keeps its own shard and nothing
    crosses ranks.  Leaves that are not tensors (a decode state's length)
    are kept."""
    xs, treedef = flatten(tree)
    ss = flatten(specs)[0]
    if len(xs) != len(ss):
        raise ValueError(f"{len(xs)} leaves against {len(ss)} specs")
    return treedef.unflatten([
        distribute_tensor(x, mesh, placements(_filter(mesh, s), mesh),
                          src_data_rank=None)
        if isinstance(x, torch.Tensor) and not isinstance(x, DTensor) else x
        for x, s in zip(xs, ss)])


def empty_placed(tree, specs, mesh, device, fill=None):
    """A DTensor for every tensor of ``tree`` (meta tensors giving the
    shapes and dtypes) whose shard alone is allocated on ``device``,
    filled with ``fill`` (a callable on the shard) or left empty: rank
    0's own shards of a model too large for one card, with no full tensor
    anywhere.  Leaves that are not tensors are kept."""
    xs, treedef = flatten(tree)
    ss = flatten(specs)[0]
    out = []
    for x, s in zip(xs, ss):
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        places = placements(_filter(mesh, s), mesh)
        local = torch.empty(local_shape(x.shape, places, mesh),
                            dtype=x.dtype, device=device)
        if fill is not None:
            fill(local)
        out.append(from_shard(local, x.shape, places, mesh))
    return treedef.unflatten(out)


def _canon(spec):
    return [None if e is None else ([e] if isinstance(e, str) else list(e))
            for e in spec]


def spec_tables(cfg, mesh) -> dict:
    """Every spec table of one arch on one mesh as JSON-able lists of
    ``[keystr path, [entry, ...]]`` (an entry None or a list of axis
    names): ``param_specs`` with FSDP on and off, ``decode_state_specs``
    for ``decode_32k`` (and ``long_500k`` with ``seq_shard`` for the archs
    in ``LONG_CONTEXT_OK``), the batch specs of every shape, and
    ``opt_state_specs``.  ``scripts/reference_pins.py sharding`` builds
    the same from the reference's tables."""
    from ..configs import LONG_CONTEXT_OK, SHAPES
    from ..data.pipeline import batch_specs

    def rows(tree):
        return [[path, _canon(s)] for path, s in keystr_paths(tree)]

    params = MDL.init_params(None, cfg, device="meta")
    pspecs = param_specs(params, cfg, mesh, fsdp=True)
    out = {"params fsdp": rows(pspecs),
           "params": rows(param_specs(params, cfg, mesh, fsdp=False)),
           "opt": rows(opt_state_specs(pspecs, mesh))}
    for name in ("decode_32k", "long_500k"):
        if name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
            continue
        out[name] = rows(decode_state_specs(
            cfg, SHAPES[name].global_batch, mesh,
            seq_shard=name == "long_500k"))
    for name, shape in SHAPES.items():
        out[f"batch {name}"] = rows(batch_specs_of(batch_specs(cfg, shape),
                                                   mesh))
    return out
