"""DiSketch gradient compression: the paper's spatiotemporal disaggregation
applied to the gradient stream (FetchSGD-style), the port of
``repro/train/compress.py``.

Mapping of the paper's concepts onto training:

  * stream element  — one gradient coordinate (key = its offset in the
                      flattened parameters, value = gradient entry); a
                      step's gradient is the "traffic" of one subepoch,
  * fragment        — ``depth`` Count-Sketch rows of width ``width``,
  * subepoch        — coordinate j is sketched only at steps where
                      ``step % n_sub == hash(j) % n_sub`` (§4.1's temporal
                      sampling); untouched coordinates accumulate in the
                      error-feedback residual until their subepoch arrives,
  * central query   — the sketch is queried per coordinate with the
                      median-of-rows Count-Sketch estimator; the top-k
                      coordinates are applied and leave the residual.

The result is the reference's, computed another way.  The reference
flattens every gradient into one D-long vector and builds a ``(depth, D)``
stack of row estimates; at gemma2-2b's D = 3 204 165 888 that is over
100 GB.  The port walks the coordinates in chunks of at most ``CHUNK``
(a chunk may span several small leaves) and never builds a D-long index
or estimate:

  1. sketch pass: ``acc = residual + grad`` (f32), the active coordinates
     added into the ``(depth, width)`` sketch by ``index_add_``;
  2. two selection passes: the estimates are recomputed chunk by chunk
     and the exact k-th largest ``|est|`` is found by a radix select on
     its f32 bit pattern (a 16-bit digit, then a 15-bit one; the counts
     are ``index_add_`` histograms on the device, with zeros spread over
     spare buckets so no one counter takes every inactive coordinate);
  3. apply pass: the estimates once more; the kept ones are written into
     the gradients (in their dtype) and ``acc - kept`` into the residual,
     both **in place**.

Traps of the reference kept on purpose: the hash is uint32 arithmetic
(carried in int64 with masks, ``core/hashing.py``'s idiom); a
coordinate's key is the low 32 bits of its int64 offset in
``jax.tree.flatten`` order (``repro_torch.tree``); ``jnp.median`` of an
even number of rows is the midpoint of the two middle ones; the threshold
is exactly the k-th largest ``|est|`` over all D coordinates (inactive
ones count as 0) and ``|est| >= thresh`` keeps ties, so more than k may
be kept.  Nothing is read back to the host.

Data parallelism (``axis_names``): under a sharding env
(``models.sharding.sharding_env``) whose mesh has the named axes, each
rank passes its own (rank-local) gradients, and the ``(depth, width)``
sketch is summed over the ranks of those mesh dims before the estimates,
as the reference's ``psum`` does inside ``shard_map``: every rank then
recovers the same top-k of the summed sketch.  Without an env, or
without those axes in it, ``axis_names`` does nothing, as the
reference's ``psum`` over absent names would not be traced.
"""
from __future__ import annotations

from typing import Any, Iterator, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.hashing import hash_u32_torch
from ..tree import chunks, flatten, tree_map

_MASK32 = 0xFFFFFFFF
# Coordinates a pass handles at once: bounds its temporaries (~100 bytes a
# coordinate: int64 keys and hashes, the row estimates and their sort).
CHUNK = 1 << 26
# Spare histogram buckets the selection spreads zeros (and, in its second
# pass, coordinates outside the chosen bucket) over.
_SPREAD = 1024


class CompressorState(NamedTuple):
    residual: Any          # error-feedback tree (f32)


class DisketchCompressor:
    """Count-Sketch gradient compressor with temporal subepoching.

    Parameters
    ----------
    width:      columns per sketch row.
    depth:      sketch rows.
    n_sub:      subepochs per sketching epoch (power of two).  1 = plain
                FetchSGD.  Coordinate j participates at steps where
                ``step % n_sub == hash(j) % n_sub``.
    k_frac:     fraction of coordinates recovered per step (top-k).
    axis_names: data-parallel mesh axes to sum the sketch over (each rank
                passes its own gradients), or None.
    """

    def __init__(self, width: int = 1 << 18, depth: int = 4,
                 n_sub: int = 1, k_frac: float = 0.01,
                 axis_names=None, seed: int = 0):
        assert n_sub & (n_sub - 1) == 0, "n_sub must be a power of two"
        self.width = width
        self.depth = depth
        self.n_sub = n_sub
        self.k_frac = k_frac
        self.axis_names = axis_names
        self.seed = seed
        self.kept = None                # set by ``apply``

    # -- hashing (uint32 in int64, as core.hashing) ------------------------

    def _hash(self, idx, seed: int):
        return hash_u32_torch(idx, seed)

    def _col_sign(self, idx, row_seed: int):
        h = self._hash(idx, row_seed)
        col = h % self.width
        sgn = 1.0 - 2.0 * (h >> 31).float()
        return col, sgn

    def _row_seed(self, r) -> int:
        return self.seed * 1009 + 101 + 7919 * r

    def _active(self, idx, cur):
        """Coordinates whose subepoch is ``cur`` (all when n_sub == 1)."""
        if self.n_sub == 1:
            return torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        return (self._hash(idx, self.seed * 31 + 5) & (self.n_sub - 1)) \
            == cur

    def k_of(self, d: int) -> int:
        """Coordinates recovered a step out of ``d``."""
        return max(int(d * self.k_frac / self.n_sub), 1)

    # -- state ----------------------------------------------------------------

    def init(self, params) -> CompressorState:
        return CompressorState(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    # -- sketch / unsketch ----------------------------------------------------

    def sketch(self, vec, idx, active, out=None):
        """Sketch the active coords of ``vec`` (keys ``idx``) -> (depth,
        width) f32; added into ``out`` when given."""
        sk = out if out is not None else torch.zeros(
            (self.depth, self.width), dtype=torch.float32, device=vec.device)
        v = torch.where(active, vec, 0.0)
        for r in range(self.depth):
            col, sgn = self._col_sign(idx, self._row_seed(r))
            sk[r].index_add_(0, col, v * sgn)
        return sk

    def estimate(self, sk, idx):
        """Median-of-rows Count-Sketch point estimates (``jnp.median``'s
        midpoint of the two middle rows when ``depth`` is even)."""
        ests = []
        for r in range(self.depth):
            col, sgn = self._col_sign(idx, self._row_seed(r))
            ests.append(sk[r][col] * sgn)
        s = torch.sort(torch.stack(ests, dim=-1), dim=-1).values
        lo, hi = (self.depth - 1) // 2, self.depth // 2
        return (s[..., lo] + s[..., hi]) * 0.5

    # -- the compressor -------------------------------------------------------

    @staticmethod
    def _keys(start: int, n: int, device) -> torch.Tensor:
        """The keys of the ``n`` coordinates from flat offset ``start``:
        the low 32 bits of the int64 offsets (``idx.astype(uint32)``)."""
        return torch.arange(start, start + n, dtype=torch.int64,
                            device=device) & _MASK32

    def _passes(self, grads, resid, cur) -> Iterator[tuple]:
        """Per chunk: ``(acc, idx, active, pieces)``, ``acc`` the f32
        ``residual + grad`` of the chunk's coordinates."""
        dev = grads[0].device
        for c, pieces in enumerate(chunks([g.numel() for g in grads],
                                          CHUNK)):
            parts = [resid[i].view(-1)[lo:hi] + grads[i].view(-1)[lo:hi]
                     .float() for i, lo, hi in pieces]
            acc = parts[0] if len(parts) == 1 else torch.cat(parts)
            idx = self._keys(c * CHUNK, acc.numel(), dev)
            yield acc, idx, self._active(idx, cur), pieces

    def _magnitudes(self, sk, grads, resid, cur) -> Iterator[torch.Tensor]:
        for _, idx, active, _ in self._passes(grads, resid, cur):
            yield torch.where(active, self.estimate(sk, idx), 0.0).abs()

    def kth_largest(self, k: int, mags) -> torch.Tensor:
        """The k-th largest value (counted with multiplicity) of the
        non-negative f32 chunks that ``mags()`` yields, as a 0-d f32 device
        tensor: a radix select on the bit patterns, two passes."""
        out = None
        for digit_bits, shift in ((16, 15), (15, 0)):
            nb = 1 << digit_bits
            hist = None
            for a in mags():
                bits = a.view(torch.int32)
                if hist is None:              # the first chunk is the longest
                    hist = torch.zeros(nb + _SPREAD, dtype=torch.int64,
                                       device=a.device)
                    lanes = torch.arange(a.numel(), device=a.device) \
                        % _SPREAD + nb
                if shift:                             # top 16 bits
                    dig = torch.where(bits == 0, lanes[:a.numel()],
                                      bits >> shift)
                else:                                 # low 15, chosen bucket
                    dig = torch.where(((bits >> 15) == b1) & (bits != 0),
                                      bits & 0x7FFF, lanes[:a.numel()])
                hist.index_add_(0, dig, torch.ones(
                    (), dtype=torch.int64, device=a.device).expand(a.numel()))
            if shift:
                zeros = hist[nb:].sum()
                hist = hist[:nb].clone()
                hist[0] += zeros
                b1, k2 = self._select(hist, k)
            else:
                hist = hist[:nb].clone()
                hist[0] += torch.where(b1 == 0, zeros, 0)
                b2, _ = self._select(hist, k2)
                out = ((b1 << 15) | b2).to(torch.int32).view(torch.float32)
        return out

    @staticmethod
    def _select(hist, k):
        """The bucket holding the k-th largest entry, and the rank of that
        entry within its bucket."""
        cum = hist.flip(0).cumsum(0).flip(0)      # entries at bucket >= b
        b = (cum >= k).sum() - 1
        above = torch.cat([cum, cum.new_zeros(1)])[b + 1]
        return b, k - above

    def _sum_over_axes(self, sk) -> None:
        """Sum the sketch in place over the ranks of the ``axis_names``
        mesh dims of the active env (one all-reduce a dim)."""
        if not self.axis_names:
            return
        from ..models.sharding import active_axes, active_mesh

        mesh = active_mesh()
        names = [a for a in self.axis_names if a in active_axes()]
        if mesh is None or not names:
            return
        for a in names:
            if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
                dist.all_reduce(sk, group=mesh.get_group(a))

    @torch.no_grad()
    def apply(self, grads, state: CompressorState, step):
        """grads -> (compressed-and-recovered grads, new state).  The
        gradients and the residual are overwritten in place; the returned
        trees hold the same tensors.  ``self.kept`` becomes (coordinates
        kept, those of them whose ``|est|`` is the threshold), 0-d device
        tensors: the threshold being the exact k-th largest, ``kept >= k``
        and ``kept - tied < k``."""
        flat_g, treedef = flatten(grads)
        if any(isinstance(g, DTensor) for g in flat_g):
            raise TypeError("the compressor takes each rank's own "
                            "(data-parallel) gradients as plain tensors, "
                            "not DTensors; name the data axes in "
                            "axis_names")
        flat_g = [g if g.is_contiguous() else g.contiguous() for g in flat_g]
        resid = flatten(state.residual)[0]
        dev = flat_g[0].device
        k = self.k_of(sum(g.numel() for g in flat_g))
        cur = step % self.n_sub

        sk = torch.zeros((self.depth, self.width), dtype=torch.float32,
                         device=dev)
        for acc, idx, active, _ in self._passes(flat_g, resid, cur):
            self.sketch(acc, idx, active, out=sk)
        self._sum_over_axes(sk)
        thresh = self.kth_largest(
            k, lambda: self._magnitudes(sk, flat_g, resid, cur))

        kept = torch.zeros((), dtype=torch.int64, device=dev)
        tied = torch.zeros((), dtype=torch.int64, device=dev)
        for acc, idx, active, pieces in self._passes(flat_g, resid, cur):
            est = torch.where(active, self.estimate(sk, idx), 0.0)
            keep = (est.abs() >= thresh) & active
            kept += keep.sum()
            tied += (keep & (est.abs() == thresh)).sum()
            out = torch.where(keep, est, 0.0)
            left = acc - out
            o = 0
            for i, lo, hi in pieces:
                resid[i].view(-1)[lo:hi].copy_(left[o:o + hi - lo])
                flat_g[i].view(-1)[lo:hi].copy_(out[o:o + hi - lo])
                o += hi - lo
        self.kept = (kept, tied)
        return treedef.unflatten(flat_g), state
