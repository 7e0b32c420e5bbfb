"""Datacenter topology (paper §6): the k-ary Fat-Tree with ECMP (port of
``repro/net/topology.py``'s ``FatTree``).

The paper's 20-switch Fat-Tree is the standard k=4 fat-tree: 4 pods x
(2 edge + 2 agg) + 4 cores, 16 hosts.  Paths are 1 hop (same edge), 3 hops
(same pod) or 5 hops (cross-pod), ECMP-selected by flow-key hash, so the
controller can recompute them at query time (§4.3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..core import hashing as H


@dataclass
class Topology:
    name: str
    n_switches: int
    n_hosts: int
    core_ids: Tuple[int, ...]

    def paths(self, src: np.ndarray, dst: np.ndarray,
              keys: np.ndarray) -> np.ndarray:
        """Vectorized ECMP path computation -> (n, 5) switch ids, -1 pad."""
        raise NotImplementedError


class FatTree(Topology):
    """k-ary fat-tree. k=4: 8 edge (0-7), 8 agg (8-15), 4 core (16-19)."""

    def __init__(self, k: int = 4):
        self.k = k
        pods = k
        self.edge_per_pod = k // 2
        self.agg_per_pod = k // 2
        self.hosts_per_edge = k // 2
        n_edge = pods * self.edge_per_pod
        n_agg = pods * self.agg_per_pod
        n_core = (k // 2) ** 2
        self.edge0, self.agg0, self.core0 = 0, n_edge, n_edge + n_agg
        super().__init__(
            name=f"fattree-k{k}",
            n_switches=n_edge + n_agg + n_core,
            n_hosts=n_edge * self.hosts_per_edge,
            core_ids=tuple(range(n_edge + n_agg, n_edge + n_agg + n_core)))

    def paths(self, src: np.ndarray, dst: np.ndarray,
              keys: np.ndarray) -> np.ndarray:
        src = np.asarray(src)
        dst = np.asarray(dst)
        keys = np.asarray(keys, dtype=np.uint32)
        n = len(src)
        k2 = self.k // 2
        e_s = src // self.hosts_per_edge
        e_d = dst // self.hosts_per_edge
        pod_s = e_s // self.edge_per_pod
        pod_d = e_d // self.edge_per_pod
        # ECMP hash choices (recomputable from the flow key).
        agg_choice = H.hash_mod(keys, 11, k2)      # which agg in src pod
        core_choice = H.hash_mod(keys, 13, k2)     # which core above it
        agg_s = self.agg0 + pod_s * self.agg_per_pod + agg_choice
        core = self.core0 + agg_choice * k2 + core_choice
        # Core c attaches to agg index (c // k2) in every pod.
        agg_d = self.agg0 + pod_d * self.agg_per_pod + agg_choice
        out = np.full((n, 5), -1, dtype=np.int64)
        same_edge = e_s == e_d
        same_pod = (pod_s == pod_d) & ~same_edge
        cross = ~same_edge & ~same_pod
        out[same_edge, 0] = (self.edge0 + e_s)[same_edge]
        out[same_pod, 0] = (self.edge0 + e_s)[same_pod]
        out[same_pod, 1] = agg_s[same_pod]
        out[same_pod, 2] = (self.edge0 + e_d)[same_pod]
        out[cross, 0] = (self.edge0 + e_s)[cross]
        out[cross, 1] = agg_s[cross]
        out[cross, 2] = core[cross]
        out[cross, 3] = agg_d[cross]
        out[cross, 4] = (self.edge0 + e_d)[cross]
        return out


def path_tuples(path_mat: np.ndarray) -> List[Tuple[int, ...]]:
    return [tuple(int(s) for s in row if s >= 0) for row in path_mat]


def path_lengths(path_mat: np.ndarray) -> np.ndarray:
    return (path_mat >= 0).sum(axis=1)


def core_on_path(path_mat: np.ndarray, core_ids: Tuple[int, ...]) -> np.ndarray:
    """The core switch on each path (or -1): used by the aggregated
    baseline."""
    is_core = np.isin(path_mat, np.asarray(core_ids))
    any_core = is_core.any(axis=1)
    first = np.where(is_core, path_mat, -1).max(axis=1)
    return np.where(any_core, first, -1)
