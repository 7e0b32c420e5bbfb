"""Data pipeline: deterministic synthetic LM streams + file-backed shards
(the port's own copy of ``repro/data/pipeline.py``: host numpy, the same
batches bit for bit).

Two sources behind one iterator interface:

  * ``SyntheticLM`` — deterministic Zipf-over-vocab token stream, seeded by
    (seed, step, host): reproducible across restarts (checkpoint stores
    only the step), infinitely long, zero I/O.  The Zipf exponent gives the
    token histogram a realistic heavy tail, which matters for the DiSketch
    telemetry examples (heavy-hitter queries over the token stream).
  * ``ShardedTokenFiles`` — memory-mapped uint16/uint32 token shards with a
    deterministic shard->host assignment, sequential reads, and skip-ahead
    recovery (straggler mitigation drops a slow shard by advancing the
    cursor — see runtime/fault_tolerance.py).

Batches are host-local numpy arrays: each host produces its slice of the
global batch (``global_batch // n_hosts``); the training launcher copies a
batch to the card.  The reference's ``batch_specs`` (``jax.ShapeDtypeStruct``
stand-ins for its dry run) waits for the port of the dry run.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def _mix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclass
class SyntheticLM:
    """Deterministic synthetic token stream."""

    vocab: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    alpha: float = 1.05       # Zipf exponent over the vocab
    host_id: int = 0

    def __post_init__(self):
        # Zipf CDF over the vocab (permuted so "hot" ids are spread out).
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-self.alpha)
        self._cdf = np.cumsum(p / p.sum())
        rng = np.random.RandomState(self.seed ^ 0x5EED)
        self._perm = rng.permutation(self.vocab).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        b, s = self.batch_per_host, self.seq_len
        # Weyl-sequence stream offset, wrapping mod 2^64 by construction.
        # The product is taken in Python ints: numpy uint64 *scalar*
        # multiplies raise RuntimeWarning on the intended wraparound.
        base = (self.seed << 40) + (self.host_id << 32) + step
        off = np.uint64((base * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
        n = b * (s + 1)
        u = _mix64(np.arange(n, dtype=np.uint64) + off)
        u = (u >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        ids = self._perm[np.searchsorted(self._cdf, u).clip(0, self.vocab - 1)]
        ids = ids.reshape(b, s + 1).astype(np.int32)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class ShardedTokenFiles:
    """Memory-mapped token shards with deterministic host assignment.

    Shard files are flat arrays of token ids (uint16 if vocab < 65536 else
    uint32).  ``write_shards`` builds them (used by tests/examples to
    create a tiny on-disk corpus).
    """

    def __init__(self, shard_dir: str, seq_len: int, batch_per_host: int,
                 host_id: int = 0, n_hosts: int = 1, dtype=np.uint16):
        self.seq_len = seq_len
        self.batch_per_host = batch_per_host
        self.dtype = dtype
        names = sorted(f for f in os.listdir(shard_dir)
                       if f.endswith(".tok"))
        mine = [n for i, n in enumerate(names) if i % n_hosts == host_id]
        if not mine:
            mine = names[:1]
        self._mm = [np.memmap(os.path.join(shard_dir, n), dtype=dtype,
                              mode="r") for n in mine]
        self._shard = 0
        self._off = 0

    @staticmethod
    def write_shards(shard_dir: str, tokens: np.ndarray, n_shards: int,
                     dtype=np.uint16) -> List[str]:
        os.makedirs(shard_dir, exist_ok=True)
        parts = np.array_split(tokens.astype(dtype), n_shards)
        out = []
        for i, part in enumerate(parts):
            path = os.path.join(shard_dir, f"shard_{i:05d}.tok")
            part.tofile(path)
            out.append(path)
        return out

    def state(self) -> Tuple[int, int]:
        return (self._shard, self._off)

    def restore(self, state: Tuple[int, int]) -> None:
        self._shard, self._off = state

    def skip_shard(self) -> None:
        """Straggler mitigation hook: abandon the current shard."""
        self._shard = (self._shard + 1) % len(self._mm)
        self._off = 0

    def batch(self) -> Dict[str, np.ndarray]:
        b, s = self.batch_per_host, self.seq_len
        need = b * (s + 1)
        chunks = []
        while need > 0:
            mm = self._mm[self._shard]
            take = min(need, len(mm) - self._off)
            if take <= 0:
                self.skip_shard()
                continue
            chunks.append(np.asarray(mm[self._off:self._off + take]))
            self._off += take
            need -= take
            if self._off >= len(mm):
                self.skip_shard()
        ids = np.concatenate(chunks).astype(np.int32).reshape(b, s + 1)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def __iter__(self):
        while True:
            yield self.batch()


def make_batch_iterator(cfg, shape, *, seed: int = 0, host_id: int = 0,
                        n_hosts: int = 1,
                        shard_dir: Optional[str] = None):
    """Batch iterator for (arch cfg, ShapeConfig)."""
    bph = max(shape.global_batch // n_hosts, 1)
    if shard_dir:
        return iter(ShardedTokenFiles(shard_dir, shape.seq_len, bph,
                                      host_id=host_id, n_hosts=n_hosts))
    return iter(SyntheticLM(cfg.vocab, shape.seq_len, bph, seed=seed,
                            host_id=host_id))


def batch_specs(cfg, shape, dtype=None):
    """Stand-ins for the global batch (dry-run inputs): ``meta`` tensors of
    the batch's shapes and dtypes, where the reference returns
    ``jax.ShapeDtypeStruct``s.

    Frontend-stub archs (``cfg.embed_inputs``: InternViT patches / EnCodec
    frames) receive precomputed (B, S, D) bf16 embeddings instead of token
    ids, per the brief; labels stay token ids (the backbone's LM head).
    ``dtype``: the ids' dtype (int32, as the reference's).
    """
    import torch

    dtype = torch.int32 if dtype is None else dtype
    b, s = shape.global_batch, shape.seq_len
    if cfg.embed_inputs:
        tok = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
    else:
        tok = torch.empty((b, s), dtype=dtype, device="meta")
    if shape.kind == "train":
        return {"tokens": tok,
                "labels": torch.empty((b, s), dtype=dtype, device="meta")}
    return {"tokens": tok}
