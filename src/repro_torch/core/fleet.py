"""Fleet execution engine: one batched device dispatch per network epoch,
or per multi-epoch *window* (port of ``repro/core/fleet.py``).

Every switch's epoch stream is packed into one flat blk-aligned CSR
stream (``pack_csr``), and all (epoch, fragment[, level]) rows are updated
by ``fleet_update_ragged`` — one launch per distinct subepoch count
(``dispatch_ragged_grouped``).  The counters stay on the device: the
overflow peak and the §4.2 PEBs are computed there.

* ``run_epoch`` (per-epoch control, the paper's own loop) dispatches one
  epoch and copies only each fragment's live ``[:n, :width]`` block to the
  host, as the int64 ``EpochRecords`` the record plane reads; the padded
  ``(n_rows, n_sub_max, width_max)`` stack never exists.  With
  ``layout="dense"`` (cs/cms, per-epoch only) the epoch goes through the
  reference's dense rectangle and ``fleet_update`` instead; that stack
  lives on the device for the one epoch and is freed.
* ``run_window`` keeps the window's ``(E, R_g, n_g, w_g)`` row groups
  resident: they answer point and window queries on the device
  (``kernels.sketch_query``) until the record plane asks for a host copy:
  once per window, one int64 array per row group (``WindowRecords``).

UnivMon levels are virtual fragment rows of the parameter table, and the
per-key level id and §4.4 single-hop flag ride the high bits of the
packed timestamp (``fold_packet_flags``), exactly as in the reference, so
counters are bit-identical to it for cs, cms and um, with or without
mitigation.

Not ported yet: device meshes, churn (dead/lost fragments), XOR parity
and the export hooks.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.sketch_update import fleet as FK
from ..kernels.sketch_update.kernel import (LVL_FIELD_MASK, LVL_SHIFT,
                                            SH_SHIFT, check_output_peak)
from . import equalize
from . import hashing as H
from .fragment import (EpochRecords, FragmentConfig, _ROLE_COL, _ROLE_SIGN,
                       _ROLE_SUB, frag_seed, level_seed_mix)

#: A window's counters as row groups: ``(rows, counters)`` with ``rows``
#: the group's row indices within an epoch and ``counters`` its
#: ``(E, R_g, n_sub_g, width_g)`` f32 tensor.
StackGroups = List[Tuple[np.ndarray, torch.Tensor]]


@dataclass
class FleetPacket:
    """One epoch's packets for the whole fleet, packed fragment-major:
    ``offsets[f] : offsets[f+1]`` is fragment ``frag_order[f]``'s segment
    of ``keys``/``values``/``ts``."""

    keys: np.ndarray           # (P,) uint32
    values: np.ndarray         # (P,) int64
    ts: np.ndarray             # (P,) int64
    offsets: np.ndarray        # (n_frags + 1,) int64 segment offsets
    frag_order: Tuple[int, ...]
    single_hop: Optional[np.ndarray] = None  # (P,) bool, §4.4 flag

    @property
    def n_frags(self) -> int:
        return len(self.frag_order)

    def seg_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def select(self, idx: np.ndarray) -> "FleetPacket":
        """Sub-packet with only the fragments at ``frag_order`` positions
        ``idx`` (the n_sub-grouped dispatch packs each group apart)."""
        segs = [(int(self.offsets[i]), int(self.offsets[i + 1]))
                for i in idx]

        def cat(arr):
            return np.concatenate([arr[lo:hi] for lo, hi in segs])

        offs = np.concatenate([[0], np.cumsum([hi - lo
                                               for lo, hi in segs])])
        return FleetPacket(cat(self.keys), cat(self.values), cat(self.ts),
                           offs.astype(np.int64),
                           tuple(self.frag_order[i] for i in idx),
                           None if self.single_hop is None
                           else cat(self.single_hop))

    def densify(self, blk: int = 256) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
        """``(n_frags, p_max)`` keys/vals/ts rectangles, value-0 padded,
        with ``p_max`` the hottest segment rounded up to a power of two
        (>= blk) and then to a ``blk`` multiple.  A transient, not cached:
        under skewed loads it is far larger than the packed form."""
        lens = self.seg_lengths()
        p_max = max(int(lens.max(initial=0)), blk)
        p_max = 1 << int(np.ceil(np.log2(p_max)))
        p_max += (-p_max) % blk
        f = self.n_frags
        keys = np.zeros((f, p_max), np.uint32)
        vals = np.zeros((f, p_max), np.float32)
        ts = np.zeros((f, p_max), np.uint32)
        for i in range(f):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            keys[i, :hi - lo] = self.keys[lo:hi]
            vals[i, :hi - lo] = self.values[lo:hi]
            ts[i, :hi - lo] = self.ts[lo:hi]
        return keys, vals, ts


def pack_streams(streams: Dict[int, "SwitchStream"],
                 frag_order: Sequence[int]) -> FleetPacket:
    """Concatenate per-switch streams into a fragment-major FleetPacket;
    the §4.4 ``single_hop`` flags ride along when any stream has them."""
    ks, vs, tss, shs, offs = [], [], [], [], [0]
    any_sh = any(st is not None and st.single_hop is not None
                 for st in streams.values())
    for sw in frag_order:
        st = streams.get(sw)
        n = 0 if st is None else len(st.keys)
        if n:
            ks.append(np.asarray(st.keys, np.uint32))
            vs.append(np.asarray(st.values, np.int64))
            tss.append(np.asarray(st.ts, np.int64))
            if any_sh:
                shs.append(np.zeros(n, bool) if st.single_hop is None
                           else np.asarray(st.single_hop, bool))
        offs.append(offs[-1] + n)
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return FleetPacket(cat(ks, np.uint32), cat(vs, np.int64),
                       cat(tss, np.int64), np.asarray(offs, np.int64),
                       tuple(frag_order),
                       cat(shs, bool) if any_sh else None)


def fold_packet_flags(packet: FleetPacket, log2_te: int, *,
                      n_levels: int = 1, level_seed: int = 0,
                      mitigation: bool = False) -> FleetPacket:
    """Fold per-packet UnivMon/§4.4 metadata into the high ts bits: ts is
    masked to its low ``log2_te`` bits, the key's level id goes to bits
    ``[LVL_SHIFT, LVL_SHIFT+5)`` and the single-hop flag to bit
    ``SH_SHIFT``.  Returns the packet unchanged when neither is active."""
    if n_levels <= 1 and not mitigation:
        return packet
    ts = np.asarray(packet.ts, np.int64) & ((1 << log2_te) - 1)
    if n_levels > 1:
        lvl = H.level_of(np.asarray(packet.keys, np.uint32), level_seed,
                         n_levels).astype(np.int64)
        ts = ts | (lvl << LVL_SHIFT)
    if mitigation and packet.single_hop is not None:
        ts = ts | (np.asarray(packet.single_hop, np.int64) << SH_SHIFT)
    return replace(packet, ts=ts)


def _bucket_blocks(nb: int, floor: int = 32) -> int:
    """Round a block count up to a shape bucket: exact below ``floor``,
    then 16 buckets per octave (padded blocks <= 6.25%)."""
    if nb <= floor:
        return nb
    q = 1 << max(int(nb - 1).bit_length() - 5, 0)
    return -(-nb // q) * q


def pack_csr(packets: Sequence[FleetPacket], blk: int = 256,
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate E epochs' packets into one flat CSR stream whose rows
    are (epoch, fragment) pairs, epoch-major.  Each row's segment is padded
    to a ``blk`` boundary with value-0 packets and owns at least one block.

    Returns ``(keys, vals, ts, block_frag)``: ``(n_blocks * blk,)``
    uint32/float32/uint32 streams and the non-decreasing ``(n_blocks,)``
    int32 block->row map (trailing bucket-padding blocks map to the last
    row).
    """
    if not packets:
        raise ValueError("pack_csr needs at least one packet")
    n_rows = sum(p.n_frags for p in packets)
    lens = (np.concatenate([p.seg_lengths() for p in packets])
            .astype(np.int64))
    nblk = np.maximum(1, -(-lens // blk))
    row_blk_off = np.concatenate([[0], np.cumsum(nblk)])
    nb_live = int(row_blk_off[-1])
    nb = _bucket_blocks(nb_live)
    p_tot = nb * blk
    keys = np.zeros(p_tot, np.uint32)
    vals = np.zeros(p_tot, np.float32)
    ts = np.zeros(p_tot, np.uint32)
    src_keys = np.concatenate([p.keys for p in packets])
    src_vals = np.concatenate([p.values for p in packets])
    src_ts = np.concatenate([p.ts for p in packets])
    row_src_off = np.concatenate([[0], np.cumsum(lens)])
    dst = (np.arange(len(src_keys), dtype=np.int64)
           - np.repeat(row_src_off[:-1], lens)
           + np.repeat(row_blk_off[:-1] * blk, lens))
    keys[dst] = src_keys
    vals[dst] = src_vals
    ts[dst] = src_ts
    block_frag = np.full(nb, max(n_rows - 1, 0), np.int32)
    block_frag[:nb_live] = np.repeat(np.arange(n_rows, dtype=np.int32),
                                     nblk)
    return keys, vals, ts, block_frag


def build_params(fragments: Dict[int, FragmentConfig], epoch: int,
                 ns: Dict[int, int],
                 frag_order: Sequence[int]) -> np.ndarray:
    """Per-row int32 parameter table: one row per fragment, or, for
    UnivMon, ``n_levels`` virtual rows per fragment with level-mixed
    column/sign seeds and their ``PARAM_LEVEL``."""
    n_levels = max((cfg.n_levels for cfg in fragments.values()
                    if cfg.kind == "um"), default=1)
    params = np.zeros((len(frag_order) * n_levels, FK.N_PARAMS), np.int32)
    for i, sw in enumerate(frag_order):
        cfg = fragments[sw]
        n = int(ns[sw])
        if n < 1 or n & (n - 1):
            raise ValueError(f"n_sub must be a power of two, got {n}")
        col = frag_seed(cfg.frag_id, epoch, _ROLE_COL, cfg.base_seed)
        sgn = frag_seed(cfg.frag_id, epoch, _ROLE_SIGN, cfg.base_seed)
        sub = frag_seed(cfg.frag_id, epoch, _ROLE_SUB, cfg.base_seed)
        for lvl in range(n_levels):
            r = i * n_levels + lvl
            if cfg.kind == "um":
                params[r, FK.PARAM_COL_SEED] = level_seed_mix(col, lvl)
                params[r, FK.PARAM_SIGN_SEED] = level_seed_mix(sgn, lvl)
            else:
                params[r, FK.PARAM_COL_SEED] = col
                params[r, FK.PARAM_SIGN_SEED] = sgn
            params[r, FK.PARAM_SUB_SEED] = sub
            params[r, FK.PARAM_WIDTH] = cfg.width
            params[r, FK.PARAM_N_SUB] = n
            params[r, FK.PARAM_LOG2_N_SUB] = n.bit_length() - 1
            params[r, FK.PARAM_LEVEL] = lvl
            params[r, FK.PARAM_MIT] = int(cfg.mitigation)
    return params


def dispatch_ragged_grouped(params: np.ndarray,
                            packets: Sequence[FleetPacket], *, log2_te: int,
                            signed: bool, blk: int = 256, n_levels: int = 1,
                            with_mitigation: bool = False,
                            device=None) -> StackGroups:
    """Ragged CSR dispatch with fragments grouped by subepoch count: one
    ``fleet_update_ragged`` launch per distinct ``n_sub``, each sized to
    its group's ``(n_sub, width)`` ceiling, so no row pays another row's
    subepoch count in output.  Counters are bit-identical to one
    ungrouped launch.

    ``params`` rows are (epoch, fragment[, level]), epoch-major, with
    ``n_sub``/``width`` frozen across the window.  Returns the window's
    row groups on ``device`` (default ``cuda``): ``(rows, counters)`` per
    group, in ascending ``n_sub``, with ``rows`` the group's row indices
    within an epoch and ``counters`` its ``(E, R_g, n_sub_g, width_g)``
    f32 output.  Nothing is padded to the fleet-wide ceiling.
    """
    dev = resolve_device(device)
    e_count = len(packets)
    n_frags = packets[0].n_frags
    L = n_levels
    n_rows = params.shape[0]
    if n_rows != e_count * n_frags * L:
        raise ValueError(f"{n_rows} param rows for {e_count} epochs x "
                         f"{n_frags} fragments x {L} levels")
    nsub_f = params[:n_frags * L:L, FK.PARAM_N_SUB].astype(np.int64)
    width_f = params[:n_frags * L:L, FK.PARAM_WIDTH].astype(np.int64)
    for col, ref in ((FK.PARAM_N_SUB, nsub_f), (FK.PARAM_WIDTH, width_f)):
        if not (params[:, col].reshape(e_count, n_frags, L)
                == ref[None, :, None]).all():
            raise ValueError("grouped dispatch requires ns and widths "
                             "frozen across the window")
    groups: StackGroups = []
    for n_g in np.unique(nsub_f):
        frag_idx = np.flatnonzero(nsub_f == n_g)
        w_g = int(width_f[frag_idx].max())
        # all L level rows of each group fragment — within an epoch, and
        # epoch-major across the window, aligned with the packet rows
        # pack_csr emits for the selected segments
        rows = (frag_idx[:, None] * L + np.arange(L)[None, :]).ravel()
        all_rows = (np.arange(e_count)[:, None] * n_frags * L
                    + rows[None, :]).ravel()
        keys, vals, ts, block_frag = pack_csr(
            [p.select(frag_idx) for p in packets], blk)
        out_g = FK.fleet_update_ragged(
            keys, vals, ts, params[all_rows], block_frag, n_sub_max=int(n_g),
            width_max=w_g, log2_te=log2_te, signed=signed, blk=blk,
            n_levels=L, with_mitigation=with_mitigation, device=dev)
        groups.append((rows, out_g.reshape(e_count, len(rows), int(n_g),
                                           w_g)))
    return groups


class _WindowBuffer:
    """Counters of one epoch window, held as row groups.

    ``device()`` returns the groups of ``dispatch_ragged_grouped`` as they
    came: ``(rows, counters)`` with ``counters`` a ``(E, R_g, n_g, w_g)``
    f32 tensor sized to its own group's ceiling.  One stack padded to the
    fleet-wide ``(n_sub_max, width_max)`` would hold
    ``E * R * n_sub_max * width_max`` counters, and the §4.2 control
    spreads ``n`` far: at the §6.1 setting with window 8 one 3728-wide
    fragment reaches n = 256 beside 123974-wide ones, 20 GB padded
    against ~0.1 GB in groups.

    The first ``host()`` call copies the groups to the host, group by
    group, each as one int64 ``(E, R_g, n_g, w_g)`` array, and releases
    the device groups; the padded ``(E, R, n_sub_max, width_max)`` array
    is built only when ``dense_host()`` is asked for it.
    """

    def __init__(self, groups: StackGroups, shape: Tuple[int, ...]):
        self._groups: Optional[StackGroups] = groups
        self._shape = shape
        self._host: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None

    @property
    def resident(self) -> bool:
        """True while the counters have not been copied to the host."""
        return self._groups is not None

    def device(self) -> Optional[StackGroups]:
        return self._groups

    def dense_host(self) -> np.ndarray:
        """A dense ``(E, R, n_sub_max, width_max)`` f32 host copy that
        leaves the device groups in place."""
        out = np.zeros(self._shape, np.float32)
        for rows, counters in self._groups:
            _, _, n, w = counters.shape
            out[:, rows, :n, :w] = counters.cpu().numpy()
        return out

    def host(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The window's row groups on the host: ``(rows, counters)`` with
        ``counters`` an int64 ``(E, R_g, n_g, w_g)`` array, copied once."""
        if self._host is None:
            self._host = [(rows, c.to(torch.int64).cpu().numpy())
                          for rows, c in self._groups]
            self._groups = None
        return self._host

    @property
    def host_bytes(self) -> int:
        """Bytes of the host copy (0 while the window is resident)."""
        return sum(c.nbytes for _, c in self._host or ())

    def host_epoch(self, e_idx: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One epoch's row groups on the host: ``(rows, (R_g, n_g, w_g)
        view)`` pairs."""
        return [(rows, c[e_idx]) for rows, c in self.host()]


class WindowRecords(Mapping):
    """Lazy ``{switch: EpochRecords}`` view over one epoch of a window:
    touching a record makes the window's host copy (shared through
    ``_WindowBuffer``, one array per row group) and builds counters as
    views of the fragment's own group."""

    def __init__(self, buf: _WindowBuffer, e_idx: int, epoch: int,
                 fragments: Dict[int, FragmentConfig],
                 frag_order: Tuple[int, ...], n_arr: np.ndarray,
                 n_levels: int = 1):
        self._buf = buf
        self._e = e_idx
        self._epoch = epoch
        self._fragments = fragments
        self._order = frag_order
        self._n = n_arr
        self._levels = n_levels
        self._recs: Optional[Dict[int, EpochRecords]] = None

    def _materialize(self) -> Dict[int, EpochRecords]:
        if self._recs is None:
            # row -> (its group, position in the group)
            groups = self._buf.host_epoch(self._e)
            blocks = [block for _, block in groups]
            where = {}
            for g, (rows, _) in enumerate(groups):
                where.update((int(r), (g, j)) for j, r in enumerate(rows))
            L = self._levels
            self._recs = {}
            for i, sw in enumerate(self._order):
                cfg = self._fragments[sw]
                n = int(self._n[i])
                # A fragment's L level rows share its n and width, so they
                # sit in one group: a view where the group lists them
                # together in level order, else a copy of those rows.
                locs = [where[i * L + l] for l in range(L)]
                g, j = locs[0]
                if locs == [(g, j + l) for l in range(L)]:
                    counters = blocks[g][j:j + L, :n, :cfg.width]
                else:
                    counters = np.stack([blocks[g][j, :n, :cfg.width]
                                         for g, j in locs])
                if cfg.kind != "um":
                    counters = counters[0]
                self._recs[sw] = EpochRecords(
                    cfg.frag_id, self._epoch, n, counters, cfg.kind,
                    cfg.mitigation, cfg.base_seed)
        return self._recs

    def __getitem__(self, sw: int) -> EpochRecords:
        return self._materialize()[sw]

    def __iter__(self):
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, sw) -> bool:      # avoid materializing on `in`
        return sw in self._fragments


class FleetEpochRunner:
    """Batched replacement for the per-switch loop.

    Holds the fleet's static configuration, packs each epoch's or
    window's streams into the ragged CSR layout (``layout="dense"`` keeps
    the reference's rectangle, cs/cms per-epoch only), dispatches the
    update kernels on ``device`` (default ``cuda``), and returns records
    and PEBs.  Window stacks stay on the device for the device query
    plane; ``keep_stacked=True`` also keeps each ``run_epoch``'s counters
    there (as a one-epoch window), so ``point_query``/``window_query``
    cover per-epoch runs too.  UnivMon fleets run every level as a
    virtual fragment row (homogeneous ``n_levels``/``level_seed``); §4.4
    mitigation rides a per-row param flag and the folded single-hop ts
    bit.
    """

    def __init__(self, fragments: Dict[int, FragmentConfig], log2_te: int,
                 *, blk: int = 256, device=None, layout: str = "ragged",
                 keep_stacked: bool = False,
                 parity_groups: Optional[Sequence[Sequence[int]]] = None,
                 mesh=None):
        if layout not in ("ragged", "dense"):
            raise ValueError(f"unknown layout {layout!r}")
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported yet")
        if parity_groups is not None:
            raise NotImplementedError("XOR parity groups are not ported yet")
        kinds = {cfg.kind for cfg in fragments.values()}
        if kinds - {"cs", "cms", "um"} or len(kinds) > 1:
            raise ValueError(
                f"fleet backend supports a homogeneous cs, cms or um "
                f"fleet, got {sorted(kinds)}")
        self.fragments = fragments
        self.kind = next(iter(kinds)) if kinds else "cms"
        self.mitigation = any(cfg.mitigation for cfg in fragments.values())
        if self.kind == "um":
            levels = {cfg.n_levels for cfg in fragments.values()}
            seeds = {cfg.level_seed for cfg in fragments.values()}
            if len(levels) > 1 or len(seeds) > 1:
                raise ValueError(
                    "fleet backend requires a homogeneous UnivMon fleet "
                    f"(one n_levels/level_seed), got n_levels="
                    f"{sorted(levels)}, level_seed={sorted(seeds)}")
            self.n_levels = levels.pop()
            self.level_seed = seeds.pop()
            if self.n_levels > LVL_FIELD_MASK + 1:
                raise ValueError(
                    f"fleet UnivMon supports n_levels <= "
                    f"{LVL_FIELD_MASK + 1}, got {self.n_levels}")
            if log2_te > LVL_SHIFT:
                raise ValueError(
                    f"fleet UnivMon requires log2_te <= {LVL_SHIFT} (the "
                    f"level id rides the high ts bits), got {log2_te}")
        else:
            self.n_levels = 1
            self.level_seed = 0
        if self.mitigation and log2_te > SH_SHIFT:
            raise ValueError(
                f"fleet §4.4 mitigation requires log2_te <= {SH_SHIFT}, "
                f"got {log2_te}")
        if layout == "dense" and (self.n_levels > 1 or self.mitigation):
            raise ValueError(
                "layout='dense' (the reference's oracle rectangle) supports "
                "cs/cms without mitigation only; use the default "
                "layout='ragged'")
        self.log2_te = log2_te
        self.blk = blk
        self.layout = layout
        self.keep_stacked = keep_stacked
        self.device = resolve_device(device)
        self.frag_order: Tuple[int, ...] = tuple(sorted(fragments))
        self.widths = np.array([fragments[sw].width
                                for sw in self.frag_order], np.int64)
        # UnivMon level of each row (n_levels rows per fragment).
        self.row_levels = np.tile(np.arange(self.n_levels),
                                  len(self.frag_order))
        self._params_log: Dict[int, np.ndarray] = {}
        # epoch -> (window buffer, epoch index within the window)
        self._window_bufs: Dict[int, Tuple[_WindowBuffer, int]] = {}

    @classmethod
    def from_window(cls, fragments: Dict[int, FragmentConfig], log2_te: int,
                    epoch0: int, ns: Dict[int, int],
                    params_by_epoch: Sequence[np.ndarray], stack: np.ndarray,
                    *, device=None) -> "FleetEpochRunner":
        """A runner holding one already-computed window, built from numpy
        alone: the fragment settings, the frozen ``ns``, the per-epoch
        parameter tables and the ``(E, R, S, W)`` counter stack (e.g. the
        JAX reference's).  The tables must be the ones ``build_params``
        derives from the settings — anything else would pair counters
        with the wrong hashes — and the stack goes to ``device``."""
        runner = cls(fragments, log2_te, device=device)
        stack = np.asarray(stack)
        e_count = len(params_by_epoch)
        for e, p in enumerate(params_by_epoch):
            want = build_params(fragments, epoch0 + e, ns, runner.frag_order)
            if not np.array_equal(np.asarray(p, np.int32), want):
                raise ValueError(f"parameter table of epoch {epoch0 + e} "
                                 "does not match the fragment settings")
        n_rows = len(runner.frag_order) * runner.n_levels
        if stack.ndim != 4 or stack.shape[:2] != (e_count, n_rows):
            raise ValueError(f"stack {stack.shape} is not ({e_count}, "
                             f"{n_rows}, n_sub_max, width_max)")
        n_row = np.asarray(params_by_epoch[0])[:, FK.PARAM_N_SUB]
        w_row = np.asarray(params_by_epoch[0])[:, FK.PARAM_WIDTH]
        groups: StackGroups = []
        for n in np.unique(n_row):
            rows = np.flatnonzero(n_row == n)
            part = stack[:, rows, :n, :w_row[rows].max()]
            groups.append((rows, torch.from_numpy(np.require(
                part.astype(np.float32), requirements=("C", "W"))
            ).to(runner.device)))
        runner._register_window(epoch0, list(params_by_epoch), groups,
                                stack.shape)
        return runner

    def _check_input_mass(self, packets: Sequence[FleetPacket]) -> None:
        # Signed (cs, um) counters can cancel, hiding an inexact
        # intermediate, so bound the only sound input-side quantity: each
        # fragment's total |value| mass.  Unsigned cms counters are
        # covered by the output peak check.
        if self.kind not in ("cs", "um"):
            return
        for packet in packets:
            if not len(packet.values):
                continue
            cum = np.concatenate([[0], np.cumsum(np.abs(packet.values))])
            seg_mass = cum[packet.offsets[1:]] - cum[packet.offsets[:-1]]
            if seg_mass.max(initial=0) >= 2 ** 24:
                raise OverflowError(
                    f"per-fragment |value| mass {seg_mass.max():.3g} "
                    "exceeds the f32 exact-integer range (2^24); shorten "
                    "the epoch")

    def _dispatch(self, params: np.ndarray,
                  packets: Sequence[FleetPacket]) -> StackGroups:
        """The update launches over the param table's rows; returns the
        window's row groups on the device."""
        if self.layout == "dense":
            if len(packets) != 1:
                raise ValueError("dense layout is per-epoch only; window "
                                 "dispatch requires layout='ragged'")
            return self._dispatch_dense(params, packets[0])
        # The cached epoch packets are shared across systems: folding
        # returns new packets and leaves them untouched.
        packets = [fold_packet_flags(p, self.log2_te,
                                     n_levels=self.n_levels,
                                     level_seed=self.level_seed,
                                     mitigation=self.mitigation)
                   for p in packets]
        return dispatch_ragged_grouped(
            params, packets, log2_te=self.log2_te,
            signed=self.kind in ("cs", "um"), blk=self.blk,
            n_levels=self.n_levels, with_mitigation=self.mitigation,
            device=self.device)

    def _dispatch_dense(self, params: np.ndarray,
                        packet: FleetPacket) -> StackGroups:
        """One epoch through the dense rectangle (kernel B3), cut into the
        row groups the ragged dispatch returns; the padded stack is freed
        when this returns."""
        n_row = params[:, FK.PARAM_N_SUB].astype(np.int64)
        w_row = params[:, FK.PARAM_WIDTH].astype(np.int64)
        keys, vals, ts = packet.densify(self.blk)
        stack = FK.fleet_update(
            keys, vals, ts, params, n_sub_max=int(n_row.max(initial=1)),
            width_max=int(w_row.max(initial=4)), log2_te=self.log2_te,
            signed=self.kind in ("cs", "um"), blk=self.blk,
            device=self.device)
        groups: StackGroups = []
        for n in np.unique(n_row):
            rows = np.flatnonzero(n_row == n)
            idx = torch.as_tensor(rows, device=stack.device)
            groups.append((rows, stack[idx, :n, :w_row[rows].max()][None]))
        return groups

    def _check_peak(self, groups: StackGroups) -> None:
        """The f32 exact-integer contract on every counter, one pass per
        group on the device and one scalar to the host."""
        peaks = [torch.maximum(hi, -lo) for lo, hi in
                 (torch.aminmax(c) for _, c in groups if c.numel())]
        if peaks:
            check_output_peak(float(torch.stack(peaks).max()))

    def _register_window(self, epoch0: int, params_by_epoch: List[np.ndarray],
                         groups: StackGroups, shape: Tuple[int, ...]
                         ) -> _WindowBuffer:
        buf = _WindowBuffer(groups, shape)
        for e, params in enumerate(params_by_epoch):
            self._window_bufs[epoch0 + e] = (buf, e)
            self._params_log[epoch0 + e] = params
        return buf

    def _window_pebs(self, groups: StackGroups, n_arr: np.ndarray,
                     e_count: int) -> np.ndarray:
        """§4.2 PEBs of every (epoch, fragment) from the level-0 rows,
        computed on the device group by group: ``(E, n_frags)``."""
        L = self.n_levels
        pebs = np.zeros((e_count, len(self.frag_order)))
        for rows, counters in groups:
            frag = rows[::L] // L        # level-0 row of each fragment
            for e in range(e_count):
                pebs[e, frag] = equalize.peb_fleet_device(
                    counters[e, ::L], n_arr[frag], self.widths[frag],
                    self.kind).cpu().numpy()
        return pebs

    def run_epoch(self, epoch: int, ns: Dict[int, int],
                  streams: Dict[int, "SwitchStream"],
                  packet: Optional[FleetPacket] = None,
                  ) -> Tuple[Dict[int, EpochRecords], Dict[int, float]]:
        """One epoch, ``ns`` per fragment: the update launches, the peak and
        the PEBs on the device, then each fragment's live ``[:n, :width]``
        block (``[:L, :n, :width]`` for UnivMon) copied to the host as its
        int64 record.  ``packet`` (a prepacked ``FleetPacket``) skips
        packing ``streams``."""
        if packet is None:
            packet = pack_streams(streams, self.frag_order)
        if packet.frag_order != self.frag_order:
            raise ValueError("packet fragment order differs from the "
                             "fleet's")
        self._check_input_mass([packet])
        L = self.n_levels
        params = build_params(self.fragments, epoch, ns, self.frag_order)
        n_arr = params[::L, FK.PARAM_N_SUB].astype(np.int64)
        groups = self._dispatch(params, [packet])
        self._check_peak(groups)
        pebs_arr = self._window_pebs(groups, n_arr, 1)[0]
        recs: Dict[int, EpochRecords] = {}
        for rows, counters in groups:
            for j in range(0, len(rows), L):
                i = int(rows[j]) // L
                cfg = self.fragments[self.frag_order[i]]
                n = int(n_arr[i])
                c = counters[0, j:j + L, :n, :cfg.width].cpu().numpy()
                recs[self.frag_order[i]] = EpochRecords(
                    cfg.frag_id, epoch, n,
                    c.astype(np.int64) if cfg.kind == "um"
                    else c[0].astype(np.int64),
                    cfg.kind, cfg.mitigation, cfg.base_seed)
        # A reprocessed epoch drops any earlier retention of it: a stale
        # buffer would answer queries with the previous run's counters.
        self._window_bufs.pop(epoch, None)
        self._params_log.pop(epoch, None)
        if self.keep_stacked:
            self._register_window(
                epoch, [params], groups,
                (1, len(params), int(n_arr.max(initial=1)),
                 int(self.widths.max(initial=4))))
        pebs = {sw: float(pebs_arr[i]) for i, sw in enumerate(self.frag_order)}
        return {sw: recs[sw] for sw in self.frag_order}, pebs

    def run_window(self, epoch0: int, ns: Dict[int, int],
                   packets: Sequence[FleetPacket],
                   ) -> Tuple[List[WindowRecords], List[Dict[int, float]]]:
        """Epoch-window super-dispatch: E epochs x F fragments, ``ns``
        frozen for the window.  Only the overflow peak (one scalar) and
        the PEBs leave the device here; the counters stay resident until
        the record plane asks for them."""
        e_count = len(packets)
        if e_count < 1:
            raise ValueError("run_window needs at least one epoch")
        for packet in packets:
            if packet.frag_order != self.frag_order:
                raise ValueError("packet fragment order differs from the "
                                 "fleet's")
        self._check_input_mass(packets)
        n_frags = len(self.frag_order)
        L = self.n_levels
        rows_per_epoch = n_frags * L
        params_by_epoch = [build_params(self.fragments, epoch0 + e, ns,
                                        self.frag_order)
                           for e in range(e_count)]
        params = np.concatenate(params_by_epoch)
        n_arr = params[:rows_per_epoch:L, FK.PARAM_N_SUB].astype(np.int64)
        groups = self._dispatch(params, packets)
        self._check_peak(groups)
        pebs_all = self._window_pebs(groups, n_arr, e_count)
        buf = self._register_window(
            epoch0, params_by_epoch, groups,
            (e_count, rows_per_epoch, int(n_arr.max(initial=1)),
             int(self.widths.max(initial=4))))
        # snapshot the config dict: records keep this window's widths
        frags_now = dict(self.fragments)
        recs_list = [WindowRecords(buf, e, epoch0 + e, frags_now,
                                   self.frag_order, n_arr, n_levels=L)
                     for e in range(e_count)]
        pebs_list = [{sw: float(pebs_all[e, i])
                      for i, sw in enumerate(self.frag_order)}
                     for e in range(e_count)]
        return recs_list, pebs_list

    def point_query(self, epoch: int, keys: np.ndarray,
                    path: Optional[Sequence[int]] = None, level: int = 0,
                    single_hop: bool = False,
                    failures: str = "mask") -> np.ndarray:
        """Batched epoch point query — ``window_query`` of one epoch."""
        return self.window_query([epoch], keys, path=path, level=level,
                                 single_hop=single_hop, failures=failures)

    def has_device_window(self, epochs: Sequence[int]) -> bool:
        """True when every epoch's window stack is still on the device, so
        ``window_query`` transfers only the ``(K,)`` estimates."""
        return all(e in self._window_bufs
                   and self._window_bufs[e][0].resident for e in epochs)

    def _row_sel(self, path: Optional[Sequence[int]],
                 level: int) -> Optional[np.ndarray]:
        """(n_rows_per_epoch,) bool row mask: the §4.3 on-path fragments
        intersected with the UnivMon level rows; None when every row
        participates."""
        if path is None and self.n_levels == 1:
            return None
        sel = np.ones(len(self.frag_order) * self.n_levels, bool)
        if path is not None:
            on_path = set(path)
            sel &= np.repeat(np.array([sw in on_path
                                       for sw in self.frag_order]),
                             self.n_levels)
        if self.n_levels > 1:
            sel &= self.row_levels == level
        return sel

    def _route_epochs(self, epochs: Sequence[int]):
        """Split queried epochs between the device and host paths:
        ``(device_groups, host_epochs)``, each device entry a
        ``(row groups, epochs)`` pair over one resident window buffer
        (the groups cut to the queried epochs)."""
        missing = [e for e in epochs if e not in self._window_bufs]
        if missing:
            raise KeyError(f"epochs {missing} not retained (process them "
                           "with run_window, or construct with "
                           "keep_stacked=True for per-epoch runs)")
        host_epochs: List[int] = []
        by_buf: Dict[int, Tuple[_WindowBuffer, List[int]]] = {}
        for e in epochs:
            buf = self._window_bufs[e][0]
            if buf.resident:
                by_buf.setdefault(id(buf), (buf, []))[1].append(e)
            else:
                host_epochs.append(e)
        device_groups = []
        for buf, es in by_buf.values():
            groups = buf.device()
            idx = [self._window_bufs[e][1] for e in es]
            if groups and idx != list(range(groups[0][1].shape[0])):
                sel = torch.as_tensor(idx, device=groups[0][1].device)
                groups = [(rows, c[sel]) for rows, c in groups]
            device_groups.append((groups, es))
        return device_groups, host_epochs

    def _host_groups(self, epoch: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One retained epoch's counters on the host, as its window's row
        groups (the window's host copy is made on first use)."""
        buf, e_idx = self._window_bufs[epoch]
        return buf.host_epoch(e_idx)

    def _liveness_sels(self, epochs: Sequence[int],
                       failures: str) -> List[int]:
        """Churn-policy front end of the query entry points.  No churn is
        ported yet, so every policy sees every fragment live and no epoch
        is blind (no extrapolation scale)."""
        if failures not in ("oblivious", "mask", "recover"):
            raise ValueError(f"unknown failures policy {failures!r}; "
                             "expected 'oblivious', 'mask' or 'recover'")
        return list(epochs)

    def window_query(self, epochs: Sequence[int], keys: np.ndarray,
                     path: Optional[Sequence[int]] = None, level: int = 0,
                     single_hop: bool = False,
                     failures: str = "mask") -> np.ndarray:
        """Batched point query summed over a window (O_Q = Sum(O)): the
        fleet twin of ``query_window(merge="fragment")``.

        Epochs whose window stack is resident are answered on the device
        (only the ``(K,)`` estimates come back); epochs whose window the
        record plane has copied to the host go through the numpy oracle
        ``query.fleet_query_window``.  ``level`` picks the UnivMon level
        rows (0 = frequency); ``single_hop`` applies the §4.4
        second-subepoch average on mitigation rows.
        """
        from . import query as Q

        keys = np.asarray(keys, np.uint32)
        sel = self._row_sel(path, level)
        epochs = self._liveness_sels(epochs, failures)
        device_groups, host_epochs = self._route_epochs(epochs)
        out = np.zeros(len(keys))
        for groups, es in device_groups:
            out += Q.fleet_query_window_device(
                groups, [self._params_log[e] for e in es], keys, self.kind,
                frag_sel=sel, single_hop=single_hop)
        if host_epochs:
            out += Q.fleet_query_window(
                [self._host_groups(e) for e in host_epochs],
                [self._params_log[e] for e in host_epochs],
                None, keys, self.kind, frag_sel=sel,
                single_hop=single_hop)
        return out

    def um_level_window_query(self, epochs: Sequence[int], keys: np.ndarray,
                              path: Optional[Sequence[int]] = None,
                              failures: str = "mask") -> np.ndarray:
        """All ``n_levels`` UnivMon Count-Sketch window estimates for a key
        batch: the per-level inputs of the §6.2 G-sum / entropy
        estimators, as ``(n_levels, K)`` float64 ``merge="fragment"``
        window estimates (level ``l``'s row means something only for keys
        with ``level_of(key) >= l``; the G-sum masks the rest).

        Resident window epochs are answered by one batched gather/merge
        over the window's row groups (``kernels.sketch_query
        .um_window_query_device``); epochs whose window the record plane
        has copied to the host go through ``query.fleet_query_window``
        level by level on its host groups.  ``failures`` is validated as in ``window_query``; no churn
        is ported, so every fragment is live.
        """
        from ..kernels.sketch_query import um_window_query_device
        from . import query as Q

        if self.kind != "um":
            raise ValueError("um_level_window_query needs a UnivMon fleet, "
                             f"this one is {self.kind!r}")
        keys = np.asarray(keys, np.uint32)
        frag_sel = None
        if path is not None:
            on_path = set(path)
            frag_sel = np.array([sw in on_path for sw in self.frag_order])
        epochs = self._liveness_sels(epochs, failures)
        device_groups, host_epochs = self._route_epochs(epochs)
        out = np.zeros((self.n_levels, len(keys)))
        for groups, es in device_groups:
            out += um_window_query_device(
                groups, [self._params_log[e] for e in es], keys,
                self.n_levels, frag_sel=frag_sel)
        if host_epochs:
            stacks = [self._host_groups(e) for e in host_epochs]
            params = [self._params_log[e] for e in host_epochs]
            for level in range(self.n_levels):
                out[level] += Q.fleet_query_window(
                    stacks, params, None, keys, "um",
                    frag_sel=self._row_sel(path, level))
        return out
