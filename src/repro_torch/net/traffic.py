"""Synthetic traffic matching the paper's workload statistics (port of
``repro/net/traffic.py``: the Fat-Tree and §6.3 linear-path generators
and the heterogeneity generators).

The paper replays the CAIDA equinix-nyc backbone trace (~2M packets, ~200K
flows over ~5 s), mapping IPs uniformly at random to hosts.  The
generator reproduces its macro statistics: Zipf flow sizes, uniform host
mapping with src != dst, and bursty per-flow arrivals.  All randomness
comes from a seeded ``numpy.random.RandomState``, so a seed gives the same
trace as the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
from scipy import stats

from ..core.hashing import mix32
from .topology import Topology, path_lengths, path_tuples


def unique_keys(n: int, seed: int) -> np.ndarray:
    """n distinct uint32 flow ids (mix32 is a bijection on uint32)."""
    base = np.arange(n, dtype=np.uint32) + np.uint32((seed * 0x9E3779B9)
                                                     & 0xFFFFFFFF)
    return mix32(base)


@dataclass
class Workload:
    """A generated trace plus its routing, ready for replay."""

    keys: np.ndarray           # (n_flows,) uint32 unique flow ids
    sizes: np.ndarray          # (n_flows,) ground-truth packet counts
    path_mat: np.ndarray       # (n_flows, 5) switch ids, -1 padded
    pkt_flow: np.ndarray       # (P,) flow index of each packet
    pkt_ts: np.ndarray         # (P,) int64 timestamps
    log2_te: int               # log2 of epoch duration (time units)
    n_epochs: int

    @property
    def pkt_keys(self) -> np.ndarray:
        return self.keys[self.pkt_flow]

    @property
    def path_len(self) -> np.ndarray:
        return path_lengths(self.path_mat)

    @property
    def paths(self) -> List[Tuple[int, ...]]:
        return path_tuples(self.path_mat)

    @property
    def duration(self) -> int:
        """The trace's span in time units: ``n_epochs`` epochs of
        ``2**log2_te``."""
        return self.n_epochs << self.log2_te


def zipf_sizes(n_flows: int, total_packets: int, alpha: float,
               rng: np.random.RandomState,
               max_flow_frac: float = 0.02) -> np.ndarray:
    """Heavy-tailed flow sizes; ``max_flow_frac`` caps the largest flow's
    share of traffic (backbone traces have no single dominating flow)."""
    ranks = np.arange(1, n_flows + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    if max_flow_frac is not None:
        p = np.minimum(p, max_flow_frac)
        p /= p.sum()
    sizes = np.maximum(1, np.round(p * total_packets)).astype(np.int64)
    rng.shuffle(sizes)
    return sizes


def _bursty_timestamps(sizes: np.ndarray, duration: int, burstiness: float,
                       rng: np.random.RandomState, n_epochs: int,
                       burst_width: float = 0.25,
                       pkts_per_burst: int = 8,
                       arrival: str = "paced") -> Tuple[np.ndarray, np.ndarray]:
    """Per-flow packet timestamps: each flow is active over a random
    sub-window placed cyclically; ``arrival`` is ``"paced"`` (evenly
    spaced with a random phase) or ``"poisson"``; a ``burstiness``
    fraction of packets clusters into bursts ``burst_width`` epochs wide."""
    n_flows = len(sizes)
    start_f = rng.rand(n_flows)
    dur_f = 0.1 + 0.9 * rng.beta(1.5, 1.5, size=n_flows)
    # Elephants persist over the whole slice; only mice churn.
    persistent = sizes >= 2 * max(n_epochs, 1)
    dur_f = np.where(persistent, 1.0, dur_f)
    pkt_flow = np.repeat(np.arange(n_flows), sizes)
    p = len(pkt_flow)
    if arrival == "paced":
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        idx_in_flow = np.arange(p) - starts[pkt_flow]
        phase = rng.rand(n_flows)
        u = (idx_in_flow + phase[pkt_flow] +
             0.25 * rng.randn(p)) / sizes[pkt_flow]
    else:
        u = rng.rand(p)
    frac = start_f[pkt_flow] + u * dur_f[pkt_flow]
    if burstiness > 0:
        n_bursts = np.maximum(1, sizes // pkts_per_burst)
        burst_id = (rng.rand(p) * n_bursts[pkt_flow]).astype(np.int64)
        center_u = mix32((pkt_flow * 131 + burst_id).astype(np.uint32)
                         ).astype(np.float64) / 2.0**32
        center = start_f[pkt_flow] + center_u * dur_f[pkt_flow]
        jitter = rng.rand(p) * (burst_width / max(n_epochs, 1))
        bursty = rng.rand(p) < burstiness
        frac = np.where(bursty, center + jitter, frac)
    frac = np.mod(frac, 1.0)
    ts = np.minimum((frac * duration).astype(np.int64), duration - 1)
    return pkt_flow, ts


def gen_workload(topo: Topology, n_flows: int = 50_000,
                 total_packets: int = 500_000, alpha: float = 1.1,
                 n_epochs: int = 32, log2_te: int = 16,
                 burstiness: float = 0.3, seed: int = 0,
                 arrival: str = "paced",
                 max_flow_frac: float = 0.02) -> Workload:
    rng = np.random.RandomState(seed)
    sizes = zipf_sizes(n_flows, total_packets, alpha, rng,
                       max_flow_frac=max_flow_frac)
    keys = unique_keys(n_flows, seed + 1)
    src = rng.randint(0, topo.n_hosts, size=n_flows)
    dst = rng.randint(0, topo.n_hosts, size=n_flows)
    same = src == dst  # paper: omit flows mapping to the same host
    dst[same] = (dst[same] + 1 + rng.randint(0, topo.n_hosts - 1,
                                             size=same.sum())) % topo.n_hosts
    path_mat = topo.paths(src, dst, keys)
    duration = n_epochs << log2_te
    pkt_flow, pkt_ts = _bursty_timestamps(sizes, duration, burstiness,
                                          rng, n_epochs, arrival=arrival)
    return Workload(keys, sizes, path_mat, pkt_flow, pkt_ts, log2_te,
                    n_epochs)


def linear_path_workload(n_hops: int, eval_flows: int, eval_packets: int,
                         bg_packets_per_hop: Sequence[int],
                         alpha: float = 1.1, n_epochs: int = 32,
                         log2_te: int = 16, burstiness: float = 0.3,
                         seed: int = 0, arrival: str = "paced") -> Workload:
    """§6.3 setup (Fig. 15): one n-hop path; evaluation flows traverse all
    hops, per-hop background flows cross a single switch."""
    rng = np.random.RandomState(seed)
    all_sizes, all_paths = [], []
    sizes_e = zipf_sizes(eval_flows, eval_packets, alpha, rng)
    all_sizes.append(sizes_e)
    all_paths += [tuple(range(n_hops))] * eval_flows
    for hop, bg in enumerate(bg_packets_per_hop):
        n_bg = max(int(eval_flows * bg / max(eval_packets, 1)), 16)
        all_sizes.append(zipf_sizes(n_bg, int(bg), alpha, rng))
        all_paths += [(hop,)] * n_bg
    sizes = np.concatenate(all_sizes)
    n_flows = len(sizes)
    keys = unique_keys(n_flows, seed + 1)
    path_mat = np.full((n_flows, 5), -1, dtype=np.int64)
    for i, p in enumerate(all_paths):
        path_mat[i, :len(p)] = p
    duration = n_epochs << log2_te
    pkt_flow, pkt_ts = _bursty_timestamps(sizes, duration, burstiness,
                                          rng, n_epochs, arrival=arrival)
    return Workload(keys, sizes, path_mat, pkt_flow, pkt_ts, log2_te,
                    n_epochs)


def gini_memories(n: int, base_bytes: int, gini: float,
                  rng: np.random.RandomState) -> np.ndarray:
    """Lognormal memory sizes with a given Gini index, mean = base (§6)."""
    if gini <= 0:
        return np.full(n, base_bytes, dtype=np.int64)
    sigma = np.sqrt(2.0) * stats.norm.ppf((gini + 1.0) / 2.0)
    x = rng.lognormal(mean=0.0, sigma=sigma, size=n)
    x = x / x.mean() * base_bytes
    return np.maximum(x.astype(np.int64), 64)


def cov_list(n: int, total: float, cov: float,
             rng: np.random.RandomState) -> np.ndarray:
    """Pseudo-random positive list with given coefficient of variation and
    fixed sum (§6.3 heterogeneity sweeps)."""
    if cov <= 0:
        x = np.full(n, 1.0)
    else:
        sigma = np.sqrt(np.log1p(cov * cov))
        x = rng.lognormal(mean=0.0, sigma=sigma, size=n)
        # Rescale empirically toward the target CoV (small-n correction).
        for _ in range(8):
            cur = x.std() / x.mean()
            if cur < 1e-9:
                break
            x = x.mean() + (x - x.mean()) * (cov / cur)
            x = np.maximum(x, 1e-3 * x.mean())
    return x / x.sum() * total


def gini_index(x: np.ndarray) -> float:
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = len(x)
    if n == 0 or x.sum() == 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)
