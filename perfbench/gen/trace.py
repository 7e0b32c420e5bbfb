"""The §6.1 trace generator, the benchmark's own copy.

A copy of the program's generator (``net/topology.py::FatTree``,
``net/traffic.py::gen_workload`` and ``gini_memories``, and the per-switch
split of ``net/simulator.py::Replayer``), so that a later change to the
program cannot move the traffic it is measured on.  The paper replays the
CAIDA equinix-nyc backbone trace (~2 M packets, ~200 k flows); this
reproduces its macro statistics: Zipf flow sizes with the largest flow
capped, uniform host pairs (src != dst), ECMP paths chosen by a hash of
the flow key, and bursty per-flow arrivals.  Every draw comes from a
``numpy.random.RandomState`` seeded by the run's seed, so one seed gives
one trace.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..reference.hashing import hash_mod, mix32


class FatTree:
    """The k-ary fat-tree.  k = 4: edge switches 0-7, aggregation 8-15,
    core 16-19, two hosts per edge switch.  A path is 1 hop (same edge),
    3 (same pod) or 5 (across pods)."""

    def __init__(self, k: int = 4):
        self.k = k
        self.edge_per_pod = self.agg_per_pod = self.hosts_per_edge = k // 2
        n_edge = k * self.edge_per_pod
        n_agg = k * self.agg_per_pod
        self.agg0, self.core0 = n_edge, n_edge + n_agg
        self.n_switches = n_edge + n_agg + (k // 2) ** 2
        self.n_hosts = n_edge * self.hosts_per_edge

    def paths(self, src: np.ndarray, dst: np.ndarray,
              keys: np.ndarray) -> np.ndarray:
        """``(n, 5)`` switch ids of each flow's path, -1 padded."""
        k2 = self.k // 2
        e_s = src // self.hosts_per_edge
        e_d = dst // self.hosts_per_edge
        pod_s = e_s // self.edge_per_pod
        pod_d = e_d // self.edge_per_pod
        agg_choice = hash_mod(keys, 11, k2)
        core_choice = hash_mod(keys, 13, k2)
        agg_s = self.agg0 + pod_s * self.agg_per_pod + agg_choice
        core = self.core0 + agg_choice * k2 + core_choice
        agg_d = self.agg0 + pod_d * self.agg_per_pod + agg_choice
        out = np.full((len(src), 5), -1, dtype=np.int64)
        same_edge = e_s == e_d
        same_pod = (pod_s == pod_d) & ~same_edge
        cross = ~same_edge & ~same_pod
        out[~cross, 0] = e_s[~cross]
        out[same_pod, 1] = agg_s[same_pod]
        out[same_pod, 2] = e_d[same_pod]
        out[cross, 0] = e_s[cross]
        out[cross, 1] = agg_s[cross]
        out[cross, 2] = core[cross]
        out[cross, 3] = agg_d[cross]
        out[cross, 4] = e_d[cross]
        return out


@dataclass
class Trace:
    """A generated trace, its routing and its per-switch split."""

    keys: np.ndarray       # (F,) uint32 distinct flow ids
    sizes: np.ndarray      # (F,) packets of each flow
    path_mat: np.ndarray   # (F, 5) switch ids, -1 padded
    pkt_flow: np.ndarray   # (P,) flow of each packet
    pkt_ts: np.ndarray     # (P,) int64 timestamps
    log2_te: int
    n_epochs: int
    #: streams[e][sw] = (keys uint32, ts int64, single_hop bool) of the
    #: packets crossing switch sw in epoch e, in time-stable order.
    streams: List[dict]

    @property
    def path_len(self) -> np.ndarray:
        return (self.path_mat >= 0).sum(axis=1)

    def paths(self) -> List[Tuple[int, ...]]:
        return [tuple(int(s) for s in row if s >= 0) for row in self.path_mat]

    def events(self, epochs=None) -> int:
        """Packet-switch events in ``epochs`` (default all)."""
        es = range(self.n_epochs) if epochs is None else epochs
        return sum(len(s[0]) for e in es for s in self.streams[e].values())

    def packets_in(self, epochs) -> int:
        """Packets whose timestamp falls in ``epochs``."""
        ep = self.pkt_ts >> self.log2_te
        return int(np.isin(ep, np.asarray(list(epochs))).sum())


def unique_keys(n: int, seed: int) -> np.ndarray:
    base = np.arange(n, dtype=np.uint32) + np.uint32((seed * 0x9E3779B9)
                                                     & 0xFFFFFFFF)
    return mix32(base)


def zipf_sizes(n_flows: int, total_packets: int, alpha: float,
               rng: np.random.RandomState,
               max_flow_frac: float) -> np.ndarray:
    p = np.arange(1, n_flows + 1, dtype=np.float64) ** (-alpha)
    p /= p.sum()
    p = np.minimum(p, max_flow_frac)
    p /= p.sum()
    sizes = np.maximum(1, np.round(p * total_packets)).astype(np.int64)
    rng.shuffle(sizes)
    return sizes


def _bursty_timestamps(sizes, duration, burstiness, rng, n_epochs,
                       arrival, burst_width=0.25, pkts_per_burst=8):
    n_flows = len(sizes)
    start_f = rng.rand(n_flows)
    dur_f = 0.1 + 0.9 * rng.beta(1.5, 1.5, size=n_flows)
    dur_f = np.where(sizes >= 2 * max(n_epochs, 1), 1.0, dur_f)
    pkt_flow = np.repeat(np.arange(n_flows), sizes)
    p = len(pkt_flow)
    if arrival == "paced":
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        idx_in_flow = np.arange(p) - starts[pkt_flow]
        phase = rng.rand(n_flows)
        u = (idx_in_flow + phase[pkt_flow] +
             0.25 * rng.randn(p)) / sizes[pkt_flow]
    elif arrival == "poisson":
        u = rng.rand(p)
    else:
        raise ValueError(f"unknown arrival {arrival!r}")
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


def split_streams(path_mat, pkt_flow, pkt_ts, keys, log2_te, n_epochs,
                  n_switches) -> List[dict]:
    """Per epoch and switch, the packets whose flow's path crosses the
    switch (``Replayer.__init__``'s split): keys, timestamps and the
    single-hop flag of each, stable in packet order within an epoch."""
    pkt_keys = keys[pkt_flow]
    single_hop_flow = (path_mat >= 0).sum(axis=1) == 1
    epoch_of = (pkt_ts >> log2_te).astype(np.int64)
    streams: List[dict] = [{} for _ in range(n_epochs)]
    for sw in range(n_switches):
        pkt_sel = (path_mat == sw).any(axis=1)[pkt_flow]
        if not pkt_sel.any():
            continue
        idx = np.nonzero(pkt_sel)[0]
        e = epoch_of[idx]
        order = np.argsort(e, kind="stable")
        idx = idx[order]
        bounds = np.searchsorted(e[order], np.arange(n_epochs + 1))
        for ep in range(n_epochs):
            lo, hi = bounds[ep], bounds[ep + 1]
            if lo == hi:
                continue
            sl = idx[lo:hi]
            streams[ep][sw] = (pkt_keys[sl], pkt_ts[sl],
                               single_hop_flow[pkt_flow[sl]])
    return streams


def make_trace(spec: dict, seed: int) -> Trace:
    """The trace a configuration's ``trace`` block describes, from
    ``seed`` (any non-negative integer; the generator takes it mod 2^32)."""
    if spec.get("topology", "fattree") != "fattree":
        raise ValueError(f"unknown topology {spec.get('topology')!r}")
    topo = FatTree(int(spec.get("k", 4)))
    seed = int(seed) % (1 << 32)
    rng = np.random.RandomState(seed)
    n_flows, n_epochs = int(spec["n_flows"]), int(spec["n_epochs"])
    log2_te = int(spec["log2_te"])
    sizes = zipf_sizes(n_flows, int(spec["total_packets"]),
                       float(spec["alpha"]), rng,
                       float(spec["max_flow_frac"]))
    keys = unique_keys(n_flows, seed + 1)
    src = rng.randint(0, topo.n_hosts, size=n_flows)
    dst = rng.randint(0, topo.n_hosts, size=n_flows)
    same = src == dst          # the paper omits flows within one host
    dst[same] = (dst[same] + 1 + rng.randint(0, topo.n_hosts - 1,
                                             size=same.sum())) % topo.n_hosts
    path_mat = topo.paths(src, dst, keys)
    pkt_flow, pkt_ts = _bursty_timestamps(
        sizes, n_epochs << log2_te, float(spec["burstiness"]), rng,
        n_epochs, spec.get("arrival", "paced"))
    streams = split_streams(path_mat, pkt_flow, pkt_ts, keys, log2_te,
                            n_epochs, topo.n_switches)
    return Trace(keys, sizes, path_mat, pkt_flow, pkt_ts, log2_te, n_epochs,
                 streams)


def make(cfg: dict, seed: int) -> Trace:
    """A configuration's inputs: the trace of its ``trace`` block."""
    return make_trace(cfg["trace"], seed)


def gini_memories(n: int, base_bytes: int, gini: float,
                  rng: np.random.RandomState) -> np.ndarray:
    """Lognormal per-switch memories with Gini index ``gini`` and mean
    ``base_bytes`` (§6).  The configurations hold its output for seed 101
    as fixed numbers; this is kept to show where they come from."""
    from scipy import stats

    if gini <= 0:
        return np.full(n, base_bytes, dtype=np.int64)
    sigma = np.sqrt(2.0) * stats.norm.ppf((gini + 1.0) / 2.0)
    x = rng.lognormal(mean=0.0, sigma=sigma, size=n)
    x = x / x.mean() * base_bytes
    return np.maximum(x.astype(np.int64), 64)
