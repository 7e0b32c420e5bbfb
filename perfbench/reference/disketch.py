"""Plain numpy reference of the DiSketch fleet at the §6.1 setting.

It follows the paper (arXiv:2503.13515) and imports nothing of the
program: from the per-switch packet streams alone it recomputes, window
by window,

* each fragment's hash seeds from ``(switch, epoch, role)`` and, for
  UnivMon, each level's mixed seeds;
* the §4.1 subepoch assignment (subepoch = bit slice of the timestamp, a
  flow is counted in the subepoch its key hashes to) and the counters of
  every (epoch, fragment, level) row, as exact integers;
* the §4.2 PEB of every (epoch, fragment) from its level-0 row (Eq. 4
  averaged over subepochs, Eq. 5) and the Eq. 6 subepoch counts, frozen
  for a window and replayed epoch by epoch at its end;
* §4.3 window queries: each on-path fragment's estimate scaled to the
  epoch (x n), the median across the path's fragments (the fragment
  merge), summed over the window's epochs;
* the §6.2 UnivMon G-sum (top-down Y-recursion over the ``k_heavy``
  largest estimates of each level, ties to the lower candidate index) and
  the entropy ``log2(total) - G / total``.

``precision="bf16"`` is the control: the same computation with every
stored value (counters, PEBs, estimates, sums) rounded to bfloat16, the
step below the program's float32 counters.  A sound comparison must fail
it.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .hashing import hash_mod, hash_pow2, hash_sign, level_of

ROLE_COL, ROLE_SIGN, ROLE_SUB = 0x1000, 0x2000, 0x3000
N_MAX = 1 << 10          # Eq. 6's cap on subepochs


def frag_seed(frag_id: int, epoch: int, role: int, base_seed: int = 0) -> int:
    return (frag_id * 1_000_003 + epoch * 7919 + role + base_seed) \
        & 0x7FFFFFFF


def level_seed_mix(seed: int, level: int) -> int:
    return (seed ^ (level * 0x9E3779B9)) & 0x7FFFFFFF


def to_bf16(x) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), as float64."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


class Fleet:
    """One fragment per switch, each a single Count Sketch row (UnivMon:
    ``n_levels`` rows), sized to the switch's memory."""

    def __init__(self, cfg: dict, precision: str = "exact"):
        if precision not in ("exact", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.kind = cfg["kind"]
        if self.kind not in ("cs", "um"):
            raise ValueError(f"the reference has no {self.kind!r} fleet")
        self.precision = precision
        self.mems = [int(m) for m in cfg["memories_bytes"]]
        self.n_frags = len(self.mems)
        self.L = int(cfg["n_levels"]) if self.kind == "um" else 1
        self.level_seed = int(cfg.get("level_seed", 7777))
        cb = int(cfg["counter_bytes"])
        self.widths = [max((m // cb) // self.L, 4) for m in self.mems]
        self.rho = float(cfg["rho_target"])
        self.log2_te = int(cfg["log2_te"])
        self.window = int(cfg["window"])
        # filled by ingest: (epoch, frag) -> (L, n, w) counters and n
        self.counters: Dict[Tuple[int, int], np.ndarray] = {}
        self.n_at: Dict[Tuple[int, int], int] = {}
        self.pebs: List[List[float]] = []
        self.n_log: List[List[int]] = []

    def _round(self, x):
        return to_bf16(x) if self.precision == "bf16" else x

    # -- update ---------------------------------------------------------

    def cell(self, f: int, epoch: int, n: int, keys: np.ndarray,
             ts: np.ndarray, levels: int) -> np.ndarray:
        """Counters of fragment ``f`` in ``epoch`` at ``n`` subepochs, for
        its first ``levels`` level rows: ``(levels, n, w)``."""
        w = self.widths[f]
        col0 = frag_seed(f, epoch, ROLE_COL)
        sgn0 = frag_seed(f, epoch, ROLE_SIGN)
        sub_seed = frag_seed(f, epoch, ROLE_SUB)
        shift = self.log2_te - (n.bit_length() - 1)
        sub_pkt = (ts >> shift) & (n - 1)
        keep = sub_pkt == hash_pow2(keys, sub_seed, n)
        k, s = keys[keep], sub_pkt[keep]
        lvl = (level_of(k, self.level_seed, self.L) if self.kind == "um"
               else np.zeros(len(k), np.int64))
        out = np.zeros((levels, n, w), np.int64)
        for lv in range(levels):
            m = lvl >= lv
            col_seed, sgn_seed = col0, sgn0
            if self.kind == "um":
                col_seed = level_seed_mix(col0, lv)
                sgn_seed = level_seed_mix(sgn0, lv)
            flat = s[m] * w + hash_mod(k[m], col_seed, w)
            out[lv] = np.bincount(flat, weights=hash_sign(k[m], sgn_seed),
                                  minlength=n * w).astype(np.int64
                                                          ).reshape(n, w)
        return out

    def peb(self, level0: np.ndarray) -> float:
        """Eq. 4 over each subepoch row, averaged (Eq. 5)."""
        w = level0.shape[-1]
        if self.precision == "bf16":
            c = level0.astype(np.float32)
            rows = np.sqrt((c * c).sum(axis=-1, dtype=np.float32)
                           / np.float32(w))
            return float(to_bf16(rows.mean(dtype=np.float32)))
        c = level0.astype(np.float64)
        return float(np.sqrt((c * c).sum(axis=-1) / w).mean())

    def next_n(self, n: int, peb: float) -> int:
        """Eq. 6."""
        if peb > 2.0 * self.rho:
            return min(2 * n, N_MAX)
        if peb < self.rho / 2.0:
            return max(1, n // 2)
        return n

    def ingest(self, streams: Sequence[dict],
               keep: Optional[Iterable[int]] = None,
               on_window=None) -> None:
        """One pass over ``streams[e][sw] = (keys, ts, ...)``, window by
        window from n = 1 everywhere.  All level rows of the epochs in
        ``keep`` (default every epoch) are kept in ``counters``; other
        epochs compute only the level-0 rows their PEBs need.
        ``on_window(epochs)`` is called after each window, so a caller can
        compare and drop its counters."""
        n_epochs = len(streams)
        keep = set(range(n_epochs) if keep is None else keep)
        ns = [1] * self.n_frags
        empty = (np.zeros(0, np.uint32), np.zeros(0, np.int64))
        for e0 in range(0, n_epochs, self.window):
            eps = list(range(e0, min(e0 + self.window, n_epochs)))
            window_pebs = []
            for e in eps:
                pebs = []
                for f in range(self.n_frags):
                    keys, ts = streams[e].get(f, empty)[:2]
                    c = self._round(self.cell(
                        f, e, ns[f], np.asarray(keys, np.uint32),
                        np.asarray(ts, np.int64),
                        self.L if e in keep else 1))
                    pebs.append(self.peb(c[0]))
                    self.n_at[(e, f)] = ns[f]
                    if e in keep:
                        self.counters[(e, f)] = c
                window_pebs.append(pebs)
            for pebs in window_pebs:       # Eq. 6 replayed in order
                ns = [self.next_n(n, p) for n, p in zip(ns, pebs)]
                self.pebs.append(pebs)
                self.n_log.append(list(ns))
            if on_window is not None:
                on_window(eps)

    # -- queries --------------------------------------------------------

    def estimates(self, keys: np.ndarray, path_mat: np.ndarray,
                  epochs: Sequence[int], level: int = 0) -> np.ndarray:
        """§4.3 window estimates with the fragment merge: per epoch the
        median over each key's on-path fragments of counter x sign x n,
        summed over ``epochs``."""
        keys = np.asarray(keys, np.uint32)
        out = np.zeros(len(keys))
        hops = (path_mat >= 0).sum(axis=1)
        for e in epochs:
            raw = np.full(path_mat.shape, np.inf)
            for j in range(path_mat.shape[1]):
                for f in np.unique(path_mat[:, j]):
                    if f < 0:
                        continue
                    sel = path_mat[:, j] == f
                    f = int(f)
                    c = self.counters[(e, f)][level]
                    n = self.n_at[(e, f)]
                    col_seed = frag_seed(f, e, ROLE_COL)
                    sgn_seed = frag_seed(f, e, ROLE_SIGN)
                    if self.kind == "um":
                        col_seed = level_seed_mix(col_seed, level)
                        sgn_seed = level_seed_mix(sgn_seed, level)
                    k = keys[sel]
                    sub = hash_pow2(k, frag_seed(f, e, ROLE_SUB), n)
                    col = hash_mod(k, col_seed, c.shape[-1])
                    raw[sel, j] = c[sub, col] * hash_sign(k, sgn_seed) * n
            srt = np.sort(raw, axis=1)          # +inf pads sort last
            rows = np.arange(len(keys))
            lo = srt[rows, np.maximum(hops - 1, 0) // 2]
            hi = srt[rows, hops // 2]
            med = self._round(0.5 * (lo + hi))
            out = self._round(out + np.where(hops > 0, med, 0.0))
        return out

    def entropy(self, keys: np.ndarray, path_mat: np.ndarray,
                epochs: Sequence[int], total: float,
                k_heavy: int) -> float:
        """§6.2 entropy (bits) over the candidate flows and their paths.
        Candidates are taken path by path, paths in the order they first
        appear and flows in their own order within a path; top-k ties go
        to the earlier candidate."""
        _, first, inv = np.unique(path_mat, axis=0, return_index=True,
                                  return_inverse=True)
        rank = np.argsort(np.argsort(first))
        order = np.argsort(rank[inv.ravel()], kind="stable")
        keys = np.asarray(keys, np.uint32)[order]
        path_mat = path_mat[order]
        lvl = level_of(keys, self.level_seed, self.L)
        ests = np.zeros((self.L, len(keys)))
        for lv in range(self.L):
            m = lvl >= lv
            if m.any():
                ests[lv, m] = self.estimates(keys[m], path_mat[m], epochs,
                                             level=lv)
        y = 0.0
        for lv in range(self.L - 1, -1, -1):
            est = np.where(lvl >= lv, np.maximum(ests[lv], 1.0), -np.inf)
            idx = np.argsort(-est, kind="stable")[:k_heavy]
            vals = est[idx]
            valid = vals > -np.inf
            x = np.where(valid, vals, 1.0)
            g = np.where(valid, x * np.log2(x), 0.0)
            if self.precision == "bf16":
                g = to_bf16(g)
            if lv < self.L - 1:
                g = g * (1.0 - 2.0 * ((lvl[idx] >= lv + 1) & valid))
                y = 2.0 * y
            y = float(self._round(y + self._round(g.sum())))
        if total <= 0:
            return 0.0
        return float(np.log2(total) - y / total)


Reference = Fleet
