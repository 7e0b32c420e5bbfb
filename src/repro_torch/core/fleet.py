"""Fleet execution engine: one batched device dispatch per network epoch,
or per multi-epoch *window* (port of ``repro/core/fleet.py``).

Every switch's epoch stream is laid out in one flat blk-aligned CSR
stream on its row group's device (``csr_streams``: the raw packets are
staged once a device and the CSR scatter lays each group's stream out
there, folding each key's UnivMon level as it goes), and all
(epoch, fragment[, level]) rows are updated by ``fleet_update_ragged`` —
one launch per distinct subepoch count (``dispatch_ragged_grouped``).
The counters stay on the device: the overflow peak and the §4.2 PEBs are
computed there.

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
packed timestamp, exactly as in the reference (``fold_packet_flags``):
the CSR scatter hashes the level, and only a §4.4 mitigation fleet has
the host fold its flag, with the level, so
counters are bit-identical to it for cs, cms and um, with or without
mitigation.

Churn (§6): a dead switch keeps forwarding but its sketch resource is
reclaimed, so its packets become value-0 no-ops in the update
(``mask_fragment_values``) and its rows come out exactly zero; a switch
that dies inside a window also loses the counters of its earlier epochs
in that window (*lost* cells), which XOR parity over a group of
fragments (``parity_groups``) can reconstruct (``recover``).  A liveness
registry per epoch masks dead and lost cells from the queries
(``failures="mask"``) and scales blind epochs.

The durable export plane (``runtime.export``) reads a window's cells as
their live blocks (``cell_counters``), holds them back until their export
messages arrive (``mark_unexported``, a liveness domain of its own) and
patches them back in place (``deliver_cell``), on the resident groups or
the host copy alike.

A device mesh (``mesh=``, ``launch.mesh.make_switch_mesh``) shards the
fleet over contiguous fragment blocks: each shard packs its own
fragments' packets, dispatches them on its own device, and keeps its row
groups there; the peak, the PEBs, XOR parity (groups must be shard-local)
and lost-cell zeros stay on the rows' device, and a query copies only the
gathered ``(E, R_g, K)`` estimate slices to the merge device
(``self.device``, the mesh's first).  Rows keep their global indices, so
everything downstream reads a sharded window as an unsharded one, and
the counters and estimates are bit-identical to the single-device
fleet's.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..kernels.sketch_update import fleet as FK
from ..kernels.sketch_update.kernel import (LVL_FIELD_MASK, LVL_SHIFT,
                                            SH_SHIFT, check_output_peak)
from ..launch.mesh import shard_frag_bounds
from . import equalize
from . import hashing as H
from .fragment import (EpochRecords, FragmentConfig, _ROLE_COL, _ROLE_SIGN,
                       _ROLE_SUB, frag_seed, level_seed_mix)

#: A window's counters as row groups: ``(rows, counters)`` with ``rows``
#: the group's row indices within an epoch and ``counters`` its
#: ``(E, R_g, n_sub_g, width_g)`` f32 tensor.
StackGroups = List[Tuple[np.ndarray, torch.Tensor]]

#: Keys a device window query gathers at once, bounding its ``(E, R, K)``
#: temporaries.
QUERY_CHUNK = 1 << 16


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
        ``idx``: the reference's per-group packing, kept as the oracle of
        ``csr_streams`` (the dispatch selects nothing itself)."""
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


def mask_fragment_values(packet: FleetPacket,
                         positions: Sequence[int]) -> FleetPacket:
    """Mask fragments out of a packed epoch by zeroing their segments'
    values: value-0 packets are no-ops of the update kernels (as the blk
    padding is), so a masked fragment's counters come out exactly zero
    while the offsets and packet count stay as they were.  ``positions``
    are ``frag_order`` positions (a dead switch keeps *forwarding*; only
    its reclaimed sketch stops counting).  Keys and ts are shared with the
    input; only ``values`` is copied."""
    if not len(positions):
        return packet
    vals = np.array(packet.values, copy=True)
    for i in positions:
        vals[int(packet.offsets[i]):int(packet.offsets[i + 1])] = 0
    return replace(packet, values=vals)


def parity_groups_chunked(frag_order: Sequence[int],
                          group_size: int) -> List[List[int]]:
    """Disjoint XOR-parity groups from chunks of the fleet order (the last
    group may be smaller): one lost fragment per group and epoch can be
    rebuilt exactly; the size trades parity memory (about one fragment
    per group) against the chance of a double loss."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    order = list(frag_order)
    return [order[i:i + group_size]
            for i in range(0, len(order), group_size)]


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
    row).  The reference's packer, kept as the oracle of ``csr_streams``,
    which builds every stream the dispatch runs.
    """
    if not packets:
        raise ValueError("pack_csr needs at least one packet")
    lens = (np.concatenate([p.seg_lengths() for p in packets])
            .astype(np.int64))
    row_blk_off, block_frag = _csr_layout(lens, blk)
    p_tot = len(block_frag) * blk
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
    return keys, vals, ts, block_frag


def _csr_layout(lens: np.ndarray, blk: int) -> Tuple[np.ndarray,
                                                     np.ndarray]:
    """Where ``pack_csr`` puts packet rows of ``lens`` packets: each row
    padded to a ``blk`` boundary and owning at least one block.  Returns
    ``(row_blk_off, block_frag)``: each row's first block (and the total
    last) and the int32 block -> row map, bucket padding included."""
    nblk = np.maximum(1, -(-lens // blk))
    row_blk_off = np.concatenate([[0], np.cumsum(nblk)])
    n_rows, nb_live = len(lens), int(row_blk_off[-1])
    block_frag = np.full(_bucket_blocks(nb_live), max(n_rows - 1, 0),
                         np.int32)
    block_frag[:nb_live] = np.repeat(np.arange(n_rows, dtype=np.int32),
                                     nblk)
    return row_blk_off, block_frag


def stage_packets(packets: Sequence[FleetPacket], pin: bool = False,
                  frags: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """E epochs' packets of fragment positions ``frags`` = ``(lo, hi)``
    (default all) as they lie, epoch-major and fragment-major, in one
    ``(3, P)`` int32 host tensor (page-locked with ``pin``): the keys'
    uint32 bits, the values as float32 bits and the ts as uint32 bits,
    cast as ``pack_csr``'s assignments cast them.  The stream that
    ``csr_row_tables`` with the same ``frags`` indexes."""
    lo, hi = frags or (0, packets[0].n_frags)
    cuts = [(int(p.offsets[lo]), int(p.offsets[hi])) for p in packets]
    buf = torch.empty((3, sum(b - a for a, b in cuts)), dtype=torch.int32,
                      pin_memory=pin)
    a = buf.numpy()
    for i, (field, dtype) in enumerate((("keys", np.uint32),
                                        ("values", np.float32),
                                        ("ts", np.uint32))):
        np.concatenate([getattr(p, field)[c0:c1]
                        for p, (c0, c1) in zip(packets, cuts)],
                       out=a[i].view(dtype), casting="unsafe")
    return buf


def csr_row_tables(packets: Sequence[FleetPacket], idx: np.ndarray,
                   blk: int = 256,
                   frags: Optional[Tuple[int, int]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The layout ``pack_csr`` gives the packets' fragments ``idx``
    (``FleetPacket.select``), over the packets as ``stage_packets(packets,
    frags=frags)`` lays them out (``idx`` within ``frags``), without
    copying a packet: ``(rows, block_frag)``, with ``rows`` the ``(3, R)``
    int64 source offset, length and first block of each (epoch, fragment)
    packet row, epoch-major, and ``block_frag`` ``pack_csr``'s own int32
    block map, bucket padding included."""
    lo, hi = frags or (0, packets[0].n_frags)
    offs = np.stack([np.asarray(p.offsets, np.int64) for p in packets])
    sizes = offs[:, hi] - offs[:, lo]
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]]) - offs[:, lo]
    src_off = (base[:, None] + offs[:, idx]).ravel()
    lens = (offs[:, idx + 1] - offs[:, idx]).ravel()
    row_blk_off, block_frag = _csr_layout(lens, blk)
    return np.stack([src_off, lens, row_blk_off[:-1]]), block_frag


def csr_streams(packets: Sequence[FleetPacket],
                groups: Sequence[Tuple[torch.device, np.ndarray]],
                blk: int = 256, *, log2_te: int = 0, n_levels: int = 1,
                level_seed: int = 0
                ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                np.ndarray]]:
    """B1's stream of each row group, built on the group's device, a card
    or the CPU alike.  For each distinct device, the span of fragment
    positions its groups cover (``stage_packets``) and its groups' row
    tables (``csr_row_tables``) are copied once into host buffers,
    page-locked on a card, and uploaded once; each group's stream is then
    gathered there by ``csr_scatter`` (the CUDA kernel on a card, its plain
    version on the CPU), one call a group in its own ``fleet.pack_csr``
    span, whose ``launches`` counts the kernel's launches (0 on the
    CPU).  With ``n_levels > 1`` the packets come unfolded and the
    scatter folds each key's UnivMon level into its ts
    (``fold_packet_flags`` without §4.4), each group's packets a
    ``folded`` count of the same span (0 without levels).

    ``groups`` are ``(device, frag_idx)`` pairs.  Returns per group
    ``(keys, vals, ts, block_frag)``: int32, float32 and int32 tensors on
    its device holding the bits ``pack_csr`` gives the packets folded by
    ``fold_packet_flags`` (``log2_te``, ``n_levels``, ``level_seed``) and
    cut to ``frag_idx`` by ``FleetPacket.select``, and its int32
    ``block_frag`` on the host."""
    devs = [torch.device(d) for d, _ in groups]
    out = [None] * len(groups)
    for dev in dict.fromkeys(devs):
        mine = [j for j, d in enumerate(devs) if d == dev]
        span = (min(int(groups[j][1].min()) for j in mine),
                max(int(groups[j][1].max()) for j in mine) + 1)
        pin = dev.type == "cuda"
        with obs.span("fleet.pack_csr"):
            staged = stage_packets(packets, pin=pin, frags=span)
            tabs = [csr_row_tables(packets, groups[j][1], blk, span)
                    for j in mine]
            parts = [x.ravel() for tab in tabs for x in tab]
            table = torch.empty(sum(map(len, parts)), dtype=torch.int64,
                                pin_memory=pin)
            np.concatenate(parts, out=table.numpy())
        with obs.span("fleet.upload"):
            s = staged.to(dev, non_blocking=True)
            t = table.to(dev, non_blocking=True).split(
                [len(x) for x in parts])
            obs.add("bytes", staged.nbytes + table.nbytes)
        for k, j in enumerate(mine):
            with obs.span("fleet.pack_csr"):
                n0 = FK.csr_scatter.launches
                keys, vals, ts = FK.csr_scatter(
                    s[0], s[1].view(torch.float32), s[2],
                    t[2 * k].view(3, -1), t[2 * k + 1], blk=blk,
                    log2_te=log2_te, n_levels=n_levels,
                    level_seed=level_seed)
                obs.add("launches", FK.csr_scatter.launches - n0)
                obs.add("folded",
                        int(tabs[k][0][1].sum()) if n_levels > 1 else 0)
            out[j] = (keys, vals, ts, tabs[k][1])
    return out


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
                            level_seed: int = 0,
                            with_mitigation: bool = False,
                            device=None,
                            shards: Optional[Sequence[Tuple[Tuple[int, int],
                                                            object]]] = None,
                            ) -> StackGroups:
    """Ragged CSR dispatch with fragments grouped by subepoch count: one
    ``fleet_update_ragged`` launch per distinct ``n_sub``, each sized to
    its group's ``(n_sub, width)`` ceiling, so no row pays another row's
    subepoch count in output.  Counters are bit-identical to one
    ungrouped launch.

    ``params`` rows are (epoch, fragment[, level]), epoch-major, with
    ``n_sub``/``width`` frozen across the window.  ``shards`` lists
    ``((lo, hi), device)`` blocks of fragment positions (a device mesh's;
    default one block of every fragment on ``device``, itself ``cuda`` by
    default): a group never spans two blocks, and each block packs and
    launches its own groups on its own device.  Every group has its stream
    built on its device by ``csr_streams`` (each device's span of
    fragments is staged and uploaded once a window).

    ``packets`` come unfolded: the scatter folds each key's UnivMon level
    (``n_levels``, ``level_seed``) into its ts.  §4.4's single-hop bit is
    a per-packet flag no hash recomputes, so with mitigation the host
    folds every packet (``fold_packet_flags``) and the scatter copies.
    The host's folding is one ``fleet.fold_flags`` span a call, empty
    without mitigation.
    Returns the window's row groups: ``(rows, counters)`` per group, block
    by block in ascending
    ``n_sub``, with ``rows`` the group's row indices within an epoch and
    ``counters`` its ``(E, R_g, n_sub_g, width_g)`` f32 output on its
    block's device.  Nothing is padded to the fleet-wide ceiling.
    """
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
    plan = []
    for (lo, hi), dev in shards or [((0, n_frags), device)]:
        dev = resolve_device(dev)
        for n_g in np.unique(nsub_f[lo:hi]):
            plan.append((dev, int(n_g),
                         lo + np.flatnonzero(nsub_f[lo:hi] == n_g)))
    # The cached epoch packets are shared across systems: folding returns
    # new packets and leaves them untouched.
    with obs.span("fleet.fold_flags"):
        if with_mitigation:
            packets = [fold_packet_flags(p, log2_te, n_levels=L,
                                         level_seed=level_seed,
                                         mitigation=True)
                       for p in packets]
    streams = csr_streams(packets, [(dev, idx) for dev, _, idx in plan],
                          blk, log2_te=log2_te,
                          n_levels=1 if with_mitigation else L,
                          level_seed=level_seed)
    groups: StackGroups = []
    for (dev, n_g, frag_idx), (keys, vals, ts, block_frag) in zip(plan,
                                                                  streams):
        w_g = int(width_f[frag_idx].max())
        # all L level rows of each group fragment — within an epoch, and
        # epoch-major across the window, aligned with the stream's packet
        # rows
        rows = (frag_idx[:, None] * L + np.arange(L)[None, :]).ravel()
        all_rows = (np.arange(e_count)[:, None] * n_frags * L
                    + rows[None, :]).ravel()
        out_g = FK.fleet_update_ragged(
            keys, vals, ts, params[all_rows], block_frag,
            n_sub_max=n_g, width_max=w_g, log2_te=log2_te, signed=signed,
            blk=blk, n_levels=L, with_mitigation=with_mitigation,
            device=dev)
        groups.append((rows, out_g.reshape(e_count, len(rows), n_g, w_g)))
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
    is built only when ``dense_host()`` is asked for it.  ``block`` reads
    and ``patch`` writes a fragment's rows in whichever copy holds them.
    """

    def __init__(self, groups: StackGroups, shape: Tuple[int, ...]):
        self._groups: Optional[StackGroups] = groups
        self._shape = shape
        self._host: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
        # row -> (its group, its position in the group)
        self._where = {int(r): (g, j) for g, (rows, _) in enumerate(groups)
                       for j, r in enumerate(rows)}

    def _locate(self, row: int, n_rows: int) -> Tuple[int, int]:
        g, j = self._where[int(row)]
        if any(self._where.get(int(row) + k) != (g, j + k)
               for k in range(n_rows)):
            raise ValueError(f"rows {row}..{row + n_rows - 1} are not "
                             "contiguous in one group")
        return g, j

    def block(self, e_idx, row: int, n_rows: int, n: int,
              w: int) -> torch.Tensor:
        """Rows ``[row, row + n_rows)`` of one epoch (or of the epochs
        ``e_idx`` slices), cut to ``[:n, :w]``: a view of the resident f32
        group, or of the host int64 copy."""
        g, j = self._locate(row, n_rows)
        if self.resident:
            return self._groups[g][1][e_idx, j:j + n_rows, :n, :w]
        return torch.from_numpy(self._host[g][1][e_idx, j:j + n_rows, :n, :w])

    def patch(self, e_idx: int, row: int, counters: torch.Tensor) -> None:
        """Overwrite the ``[:n, :w]`` block of rows ``[row, row + l)`` of
        one epoch with exact integer ``(l, n, w)`` counters (XOR-parity
        recovery): in the resident group, or in the host copy *in place*,
        so the record views already handed out see the reconstruction.
        The group's padding beyond ``(n, w)`` stays zero."""
        l, n, w = counters.shape
        g, j = self._locate(row, l)
        if self.resident:
            c = self._groups[g][1]
            c[e_idx, j:j + l, :n, :w] = counters.to(c.device, c.dtype)
        else:
            self._host[g][1][e_idx, j:j + l, :n, :w] = \
                counters.to(torch.int64).cpu().numpy()

    def zero(self, e_idx: int, row: int, n_rows: int, n: int, w: int) -> None:
        """Zero the ``[:n, :w]`` block of rows ``[row, row + n_rows)`` of
        one epoch in place, in whichever copy holds them: nothing crosses
        between devices."""
        g, j = self._locate(row, n_rows)
        if self.resident:
            self._groups[g][1][e_idx, j:j + n_rows, :n, :w] = 0
        else:
            self._host[g][1][e_idx, j:j + n_rows, :n, :w] = 0

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
    update kernels on ``device`` (default ``cuda``), or shard by shard on
    the devices of a ``mesh`` (``launch.mesh.SwitchMesh``; ragged only,
    parity groups shard-local), and returns records and PEBs.  Window
    stacks stay on the device for the device query plane;
    ``keep_stacked=True`` also keeps each ``run_epoch``'s counters there
    (as a one-epoch window), so ``point_query``/``window_query`` cover
    per-epoch runs too.  UnivMon fleets run every level as a
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
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both: the mesh "
                             "names the devices")
        # merges, the G-sum and the query's estimates run here
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices[0])
        self.frag_order: Tuple[int, ...] = tuple(sorted(fragments))
        self.widths = np.array([fragments[sw].width
                                for sw in self.frag_order], np.int64)
        # UnivMon level of each row (n_levels rows per fragment).
        self.row_levels = np.tile(np.arange(self.n_levels),
                                  len(self.frag_order))
        self._params_log: Dict[int, np.ndarray] = {}
        # epoch -> (window buffer, epoch index within the window)
        self._window_bufs: Dict[int, Tuple[_WindowBuffer, int]] = {}
        # --- liveness under churn ---------------------------------------
        # epoch -> (n_rows,) bool row liveness; no entry: every row live.
        self._row_live: Dict[int, np.ndarray] = {}
        # epoch -> (n_rows,) bool rows that exported a record, for the
        # per-epoch runs with dead switches (they export none, so not even
        # an oblivious merge sees them, as on the record plane).
        self._recorded: Dict[int, np.ndarray] = {}
        # epoch -> frag_order positions whose counters were lost (sketched,
        # then reclaimed before the window's export): masked, and
        # recoverable from parity while one per group.
        self._lost: Dict[int, set] = {}
        # epoch -> frag_order positions staged by the export plane and not
        # delivered yet (``runtime.export``): zeroed and masked like dead
        # cells, but in their own domain (in flight, not reclaimed), and
        # live again once delivered (``deliver_cell``).
        self._unexported: Dict[int, set] = {}
        # epoch -> per-group int32 XOR parity on the device: each member's
        # (L, n_i, w_i) block flattened, zero-padded to the group's
        # longest member, taken before the lost cells are zeroed.
        self._parity: Dict[int, List[torch.Tensor]] = {}
        self._frag_pos = {sw: i for i, sw in enumerate(self.frag_order)}
        self.parity_groups: Optional[List[np.ndarray]] = None
        self._group_of: Dict[int, int] = {}
        if parity_groups is not None:
            self.parity_groups = []
            for gi, group in enumerate(parity_groups):
                idx = []
                for sw in group:
                    if sw not in self._frag_pos:
                        raise ValueError(
                            f"parity group switch {sw} is not in the fleet")
                    i = self._frag_pos[sw]
                    if i in self._group_of:
                        raise ValueError(
                            f"switch {sw} appears in more than one parity "
                            "group")
                    self._group_of[i] = gi
                    idx.append(i)
                self.parity_groups.append(np.asarray(idx, np.int64))
        # --- device-mesh sharding ---------------------------------------
        # Contiguous fragment blocks over the mesh's "switch" axis: shard s
        # packs, dispatches and keeps the rows of fragments
        # _shard_frag_bounds[s] on mesh.devices[s].
        self.mesh = mesh
        self.n_shards = 1
        self._frags_per_shard: Optional[int] = None
        self._shard_frag_bounds: Optional[List[Tuple[int, int]]] = None
        self._shards = None     # dispatch_ragged_grouped's shard blocks
        if mesh is not None:
            if layout == "dense":
                raise ValueError(
                    "mesh sharding requires layout='ragged' (the dense "
                    "rectangle is a single-device oracle)")
            self.n_shards = len(mesh.devices)
            self._shard_frag_bounds = shard_frag_bounds(
                len(self.frag_order), self.n_shards)
            self._shards = list(zip(self._shard_frag_bounds, mesh.devices))
            self._frags_per_shard = (self._shard_frag_bounds[0][1]
                                     - self._shard_frag_bounds[0][0])
            for gi, g in enumerate(self.parity_groups or ()):
                shards = {int(i) // self._frags_per_shard for i in g}
                if len(shards) > 1:
                    raise ValueError(
                        f"parity group {gi} spans mesh shards "
                        f"{sorted(shards)}: XOR recovery reads whole "
                        "group rows, so groups must be shard-local "
                        "under a device mesh")
        # What the last window query could observe (``_liveness_sels``):
        # queried epochs, those with a live on-path row, and the scale.
        self.last_observability: Optional[Dict] = None

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
        with obs.span("fleet.mass_check"):
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
        # dispatch_ragged_grouped folds the levels and §4.4's flags.
        return dispatch_ragged_grouped(
            params, packets, log2_te=self.log2_te,
            signed=self.kind in ("cs", "um"), blk=self.blk,
            n_levels=self.n_levels, level_seed=self.level_seed,
            with_mitigation=self.mitigation, device=self.device,
            shards=self._shards)

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
        group on its device and one scalar per device to the host."""
        by_dev: Dict[torch.device, List[torch.Tensor]] = {}
        for _, c in groups:
            if c.numel():
                lo, hi = torch.aminmax(c)
                by_dev.setdefault(c.device, []).append(torch.maximum(hi, -lo))
        if by_dev:
            with obs.span("fleet.peak.wait"):
                check_output_peak(max(float(torch.stack(p).max())
                                      for p in by_dev.values()))

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
        with obs.span("fleet.pebs"):
            for rows, counters in groups:
                frag = rows[::L] // L        # level-0 row of each fragment
                for e in range(e_count):
                    peb = equalize.peb_fleet_device(
                        counters[e, ::L], n_arr[frag], self.widths[frag],
                        self.kind)
                    with obs.span("fleet.pebs.wait"):
                        pebs[e, frag] = peb.cpu().numpy()
        return pebs

    def refresh_widths(self) -> None:
        """Recompute the cached widths after a resize replaced a
        ``FragmentConfig``.  Past epochs keep theirs: queries read the hash
        moduli from the per-epoch parameter tables."""
        self.widths = np.array([self.fragments[sw].width
                                for sw in self.frag_order], np.int64)

    def _set_liveness(self, epoch: int, invalid: set, lost: set) -> None:
        """Record one processed epoch's dead and lost switches, dropping
        what a previous run of the epoch left."""
        self._lost.pop(epoch, None)
        self._parity.pop(epoch, None)
        self._recorded.pop(epoch, None)
        self._unexported.pop(epoch, None)
        if not invalid:
            self._row_live.pop(epoch, None)
            return
        L = self.n_levels
        live = np.ones(len(self.frag_order) * L, bool)
        for sw in invalid:
            i = self._frag_pos[sw]
            live[i * L:(i + 1) * L] = False
        self._row_live[epoch] = live
        if lost:
            self._lost[epoch] = {self._frag_pos[sw] for sw in lost}

    def run_epoch(self, epoch: int, ns: Dict[int, int],
                  streams: Dict[int, "SwitchStream"],
                  packet: Optional[FleetPacket] = None,
                  dead: Optional[Sequence[int]] = None,
                  ) -> Tuple[Dict[int, EpochRecords], Dict[int, float]]:
        """One epoch, ``ns`` per fragment: the update launches, the peak and
        the PEBs on the device, then each fragment's live ``[:n, :width]``
        block (``[:L, :n, :width]`` for UnivMon) copied to the host as its
        int64 record.  ``packet`` (a prepacked ``FleetPacket``) skips
        packing ``streams``.  ``dead`` switches hold no sketch memory: their
        packets are value-0 no-ops, so their rows come out zero, and they
        get no record and no PEB (as the loop backend skips them)."""
        if packet is None:
            packet = pack_streams(streams, self.frag_order)
        if packet.frag_order != self.frag_order:
            raise ValueError("packet fragment order differs from the "
                             "fleet's")
        dead_set = set(dead or ()) & set(self.frag_order)
        if dead_set:
            packet = self._mask_dead([packet], [dead_set])[0]
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
                if self.frag_order[i] in dead_set:
                    continue
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
        self._set_liveness(epoch, dead_set, set())
        if dead_set:
            self._recorded[epoch] = self._row_live[epoch]
        if self.keep_stacked:
            self._register_window(
                epoch, [params], groups,
                (1, len(params), int(n_arr.max(initial=1)),
                 int(self.widths.max(initial=4))))
        pebs = {sw: float(pebs_arr[i]) for i, sw in enumerate(self.frag_order)
                if sw not in dead_set}
        return {sw: recs[sw] for sw in self.frag_order if sw in recs}, pebs

    def run_window(self, epoch0: int, ns: Dict[int, int],
                   packets: Sequence[FleetPacket],
                   dead_by_epoch: Optional[Sequence[Sequence[int]]] = None,
                   lost_by_epoch: Optional[Sequence[Sequence[int]]] = None,
                   ) -> Tuple[List[WindowRecords], List[Dict[int, float]]]:
        """Epoch-window super-dispatch: E epochs x F fragments, ``ns``
        frozen for the window.  Only the overflow peak (one scalar) and
        the PEBs leave the device here; the counters stay resident until
        the record plane asks for them.

        Churn, as one switch set per epoch: ``dead_by_epoch`` switches hold
        no sketch memory in that epoch (value-0 packets, zero rows, masked,
        no PEB); ``lost_by_epoch`` switches sketched the epoch but their
        counters were reclaimed before the window's export.  In that order:
        the PEBs and the parity of every group come from the counters as
        dispatched, then the lost rows are zeroed, then the liveness of
        each epoch is recorded."""
        e_count = len(packets)
        if e_count < 1:
            raise ValueError("run_window needs at least one epoch")
        for packet in packets:
            if packet.frag_order != self.frag_order:
                raise ValueError("packet fragment order differs from the "
                                 "fleet's")
        fleet_set = set(self.frag_order)
        dead_sets = ([set(d) & fleet_set for d in dead_by_epoch]
                     if dead_by_epoch is not None else [set()] * e_count)
        lost_sets = ([set(d) & fleet_set for d in lost_by_epoch]
                     if lost_by_epoch is not None else [set()] * e_count)
        if len(dead_sets) != e_count or len(lost_sets) != e_count:
            raise ValueError("dead_by_epoch and lost_by_epoch need one set "
                             f"per epoch of the window ({e_count})")
        if any(dead_sets):
            packets = self._mask_dead(packets, dead_sets)
        self._check_input_mass(packets)
        n_frags = len(self.frag_order)
        L = self.n_levels
        rows_per_epoch = n_frags * L
        with obs.span("fleet.build_params"):
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
        parity_by_epoch = None
        if self.parity_groups is not None:
            with obs.span("fleet.parity"):
                parity_by_epoch = self._window_parity(
                    buf, params_by_epoch[0], e_count)
                obs.add("bytes", sum(p.nbytes for p in parity_by_epoch[0])
                        * e_count)
        if any(lost_sets):
            with obs.span("fleet.lose",
                          cells=sum(len(lost) for lost in lost_sets)):
                for e, lost in enumerate(lost_sets):
                    for sw in lost:
                        i = self._frag_pos[sw]
                        buf.zero(e, i * L, L,
                                 *self._block_shape(params_by_epoch[0], i))
        # snapshot the config dict: records keep this window's widths
        frags_now = dict(self.fragments)
        recs_list = [WindowRecords(buf, e, epoch0 + e, frags_now,
                                   self.frag_order, n_arr, n_levels=L)
                     for e in range(e_count)]
        pebs_list = [{sw: float(pebs_all[e, i])
                      for i, sw in enumerate(self.frag_order)
                      if sw not in dead_sets[e]}
                     for e in range(e_count)]
        for e in range(e_count):
            self._set_liveness(epoch0 + e, dead_sets[e] | lost_sets[e],
                               lost_sets[e])
            if parity_by_epoch is not None:
                self._parity[epoch0 + e] = parity_by_epoch[e]
        return recs_list, pebs_list

    def _mask_dead(self, packets: Sequence[FleetPacket],
                   dead_sets: Sequence[set]) -> List[FleetPacket]:
        """Each epoch's packets with its dead switches' segments masked
        (``mask_fragment_values``), in a span counting the packets."""
        out = []
        with obs.span("fleet.mask"):
            for p, dead in zip(packets, dead_sets):
                pos = sorted(self._frag_pos[sw] for sw in dead)
                out.append(mask_fragment_values(p, pos))
                obs.add("packets", int(p.seg_lengths()[pos].sum()))
        return out

    def _block_shape(self, params: np.ndarray, i: int) -> Tuple[int, int]:
        """Fragment ``i``'s live ``(n, width)`` in an epoch's table."""
        r = i * self.n_levels
        return int(params[r, FK.PARAM_N_SUB]), int(params[r, FK.PARAM_WIDTH])

    def _window_parity(self, buf: _WindowBuffer, params: np.ndarray,
                       e_count: int) -> List[List[torch.Tensor]]:
        """Per-epoch, per-group XOR parity over the members' live blocks:
        ``[epoch][group] -> (max_i L * n_i * w_i,)`` int32 on the device,
        each member's ``(L, n_i, w_i)`` block flattened and zero-padded to
        the group's longest.  Counters are exact integers below 2^24, so
        the f32 -> int32 cast is exact, and XOR neither rounds nor
        overflows; dead members' rows are zeros and XOR away.  A group's
        members live on one device (shard-local under a mesh), and so does
        its parity."""
        L = self.n_levels
        per_group = []
        for members in self.parity_groups:
            blocks = [buf.block(slice(None), int(i) * L, L,
                                *self._block_shape(params, int(i)))
                      .to(torch.int32).reshape(e_count, -1)
                      for i in members]
            acc = torch.zeros((e_count, max(b.shape[1] for b in blocks)),
                              dtype=torch.int32, device=blocks[0].device)
            for b in blocks:
                acc[:, :b.shape[1]] ^= b
            per_group.append(acc)
        return [[acc[e] for acc in per_group] for e in range(e_count)]

    def frag_live(self, epoch: int) -> Optional[np.ndarray]:
        """(n_frags,) bool fragment liveness of a processed epoch, or None
        when no failure touched it (every fragment live)."""
        live = self._row_live.get(epoch)
        return None if live is None else live[::self.n_levels]

    def is_live(self, sw: int, epoch: int) -> bool:
        """Is switch ``sw``'s cell of ``epoch`` a genuine observation (not
        dead, not lost, or recovered since)?"""
        live = self.frag_live(epoch)
        return live is None or bool(live[self._frag_pos[sw]])

    def recoverable(self, epochs: Optional[Sequence[int]] = None,
                    ) -> Dict[int, List[int]]:
        """The lost cells XOR parity can rebuild: ``{epoch: [switch]}``.
        A lost cell is recoverable when its fragment is in a parity group,
        the epoch's parity was taken, and no other member of the group is
        lost in that epoch (dead members hold zeros and do not block)."""
        out: Dict[int, List[int]] = {}
        for e in (sorted(self._lost) if epochs is None else epochs):
            lost = self._lost.get(e)
            if not lost or e not in self._parity:
                continue
            for i in sorted(lost):
                gi = self._group_of.get(i)
                if gi is None:
                    continue
                if any(j != i and j in lost for j in self.parity_groups[gi]):
                    continue
                out.setdefault(e, []).append(self.frag_order[i])
        return out

    def recover(self, epochs: Optional[Sequence[int]] = None,
                ) -> Dict[int, List[int]]:
        """Rebuild every recoverable lost cell from XOR parity and patch it
        into the window, in place: for fragment ``i`` of group ``G`` at
        epoch ``e``, ``C_i = parity[e][G] ^ (the other members' blocks)``,
        cropped to ``(L, n_i, w_i)`` — bit-identical to the counters before
        the loss.  Recovered rows become live again, for the device plane
        and for the record views.  Returns what was recovered,
        ``{epoch: [switch]}``; the other lost cells stay masked."""
        recovered: Dict[int, List[int]] = {}
        todo = self.recoverable(epochs)
        if not todo:
            return recovered
        L = self.n_levels
        with obs.span("fleet.recover"):
            for e, sws in todo.items():
                buf, e_idx = self._window_bufs[e]
                params = self._params_log[e]
                patches = []
                for sw in sws:
                    i = self._frag_pos[sw]
                    members = self.parity_groups[self._group_of[i]]
                    acc = self._parity[e][self._group_of[i]].clone()
                    for j in members:
                        if j != i:
                            b = buf.block(e_idx, int(j) * L, L,
                                          *self._block_shape(params, int(j)))
                            b = b.to(acc.device, torch.int32).reshape(-1)
                            acc[:b.numel()] ^= b
                    n, w = self._block_shape(params, i)
                    patches.append((i, acc[:L * n * w].reshape(L, n, w)))
                for i, counters in patches:
                    buf.patch(e_idx, i * L, counters)
                    self._row_live[e][i * L:(i + 1) * L] = True
                    self._lost[e].discard(i)
                    recovered.setdefault(e, []).append(self.frag_order[i])
            obs.add("cells", sum(len(sws) for sws in recovered.values()))
        return recovered

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
                groups = [(rows, c[torch.as_tensor(idx, device=c.device)])
                          for rows, c in groups]
            device_groups.append((groups, es))
        return device_groups, host_epochs

    def _host_groups(self, epoch: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One retained epoch's counters on the host, as its window's row
        groups (the window's host copy is made on first use)."""
        buf, e_idx = self._window_bufs[epoch]
        return buf.host_epoch(e_idx)

    def _liveness_sels(self, epochs: Sequence[int],
                       base: Optional[np.ndarray], failures: str):
        """Churn front end of the window query entry points: intersect the
        structural row selection ``base`` with each epoch's liveness, drop
        the blind epochs (no live selected row) and return ``(epochs,
        sel_by_epoch, scale)``.

        ``sel_by_epoch`` is None when no failure touched a queried epoch;
        ``scale`` is the blind-epoch extrapolation E / E_observable.
        ``"recover"`` first rebuilds the recoverable lost cells, then
        masks.  ``"oblivious"`` keeps the dead and lost rows, but not the
        dead switches of per-epoch runs, which exported no record, and
        scales nothing.  Raises ``ValueError`` for an unknown policy, or
        when every epoch is blind under ``"mask"``."""
        if failures not in ("oblivious", "mask", "recover"):
            raise ValueError(f"unknown failures policy {failures!r}; "
                             "expected 'oblivious', 'mask' or 'recover'")
        epochs = list(epochs)
        if failures == "recover":
            self.recover(epochs)
            failures = "mask"
        rows = self._recorded if failures == "oblivious" else self._row_live
        if not any(e in rows for e in epochs):
            self.last_observability = {
                "epochs": len(epochs), "observable_epochs": len(epochs),
                "scale": 1.0}
            return epochs, None, 1.0
        n_rows = len(self.frag_order) * self.n_levels
        base_arr = np.ones(n_rows, bool) if base is None else base
        sel_by_e = {e: base_arr & rows[e] if e in rows else base_arr
                    for e in epochs}
        if failures == "oblivious":
            # an epoch with no recorded on-path row adds nothing
            self.last_observability = {
                "epochs": len(epochs), "observable_epochs": len(epochs),
                "scale": 1.0}
            return [e for e in epochs if sel_by_e[e].any()], sel_by_e, 1.0
        obs = [e for e in epochs if sel_by_e[e].any()]
        if not obs:
            raise ValueError(
                "window query: no epoch in the window has a live on-path "
                "fragment; the flow is unobservable under the failure "
                "schedule")
        scale = len(epochs) / len(obs)
        self.last_observability = {
            "epochs": len(epochs), "observable_epochs": len(obs),
            "scale": scale}
        return obs, sel_by_e, scale

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

        ``failures`` is the churn policy: ``"mask"`` keeps each epoch's
        live on-path rows only and extrapolates the blind epochs (no live
        on-path row) from the others by E / E_observable; ``"recover"``
        first rebuilds the recoverable lost cells from parity
        (``recover``), then masks; ``"oblivious"`` ignores liveness, so
        the dead rows' zeros enter the min/median.  Without failures in
        the queried epochs the three agree.
        """
        keys = np.asarray(keys, np.uint32)
        return self.window_query_groups(
            epochs, keys, [(path, np.arange(len(keys)))], level=level,
            single_hop=single_hop, failures=failures)

    def window_query_groups(self, epochs: Sequence[int], keys: np.ndarray,
                            groups: Sequence[Tuple[Optional[Sequence[int]],
                                                   np.ndarray]],
                            level: int = 0, single_hop: bool = False,
                            failures: str = "mask") -> np.ndarray:
        """``window_query`` for several paths at once: ``groups`` lists
        ``(path, idxs)``, the keys ``keys[idxs]`` travelling ``path``.
        Each resident window is answered by one gather over its row
        groups for ``QUERY_CHUNK`` keys at a time, whatever their paths:
        each key merges the live rows of its own path (§4.3 Step 1), an
        epoch blind to that path adds nothing, and the E / E_observable
        scale is the path's.  Returns ``(len(keys),)`` estimates, those
        ``window_query`` gives each group (0 for keys in no group)."""
        from . import query as Q

        keys = np.asarray(keys, np.uint32)
        epochs = list(epochs)
        with obs.span("fleet.liveness"):
            if failures == "recover":
                self.recover(epochs)
                failures = "mask"
            col = {e: i for i, e in enumerate(epochs)}
            n_rows = len(self.frag_order) * self.n_levels
            # (G, E, R): the rows each group's keys merge in each epoch
            table = np.zeros((len(groups), len(epochs), n_rows), bool)
            scales = np.ones(len(groups))
            for g, (path, _) in enumerate(groups):
                base = self._row_sel(path, level)
                es, sel_by_e, scales[g] = self._liveness_sels(epochs, base,
                                                              failures)
                for e in es:
                    table[g, col[e]] = (sel_by_e[e] if sel_by_e is not None
                                        else True if base is None else base)
                if failures != "oblivious" and not table[g].any():
                    raise ValueError(f"window query: path {path} selects "
                                     "no row of the fleet")
            order = np.concatenate([np.asarray(i, np.int64)
                                    for _, i in groups]
                                   or [np.zeros(0, np.int64)])
            gid = np.repeat(np.arange(len(groups)),
                            [len(i) for _, i in groups])
            ks = keys[order]
            est = np.zeros(len(ks))
            device_groups, host_epochs = self._route_epochs(
                [e for e in epochs if table[:, col[e]].any()])
        for stack, es in device_groups:
            sel = table[:, [col[e] for e in es]]
            params = [self._params_log[e] for e in es]
            for s in range(0, len(ks), QUERY_CHUNK):
                sl = slice(s, s + QUERY_CHUNK)
                est[sl] += Q.fleet_query_window_device(
                    stack, params, ks[sl], self.kind, frag_sel=sel,
                    single_hop=single_hop, key_group=gid[sl])
        for g in range(len(groups)) if host_epochs else ():
            hs = [e for e in host_epochs if table[g, col[e]].any()]
            if hs:
                mine = gid == g
                est[mine] += Q.fleet_query_window(
                    [self._host_groups(e) for e in hs],
                    [self._params_log[e] for e in hs], None, ks[mine],
                    self.kind, frag_sel=[table[g, col[e]] for e in hs],
                    single_hop=single_hop)
        out = np.zeros(len(keys))
        out[order] = est * scales[gid]
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
        level by level on its host groups.  ``failures`` is the churn
        policy of ``window_query``; liveness is per fragment, so a dead
        switch masks all its level rows at once.
        """
        from ..kernels.sketch_query import um_window_query_device
        from . import query as Q

        if self.kind != "um":
            raise ValueError("um_level_window_query needs a UnivMon fleet, "
                             f"this one is {self.kind!r}")
        keys = np.asarray(keys, np.uint32)
        L = self.n_levels
        with obs.span("fleet.liveness"):
            frag_sel = None
            if path is not None:
                on_path = set(path)
                frag_sel = np.array([sw in on_path
                                     for sw in self.frag_order])
            # liveness in row space, projected back to fragments for the
            # device: a fragment's level rows are all live or all masked
            row_base = None if frag_sel is None else np.repeat(frag_sel, L)
            epochs, row_sel_by_e, scale = self._liveness_sels(
                epochs, row_base, failures)
            device_groups, host_epochs = self._route_epochs(epochs)
        out = np.zeros((L, len(keys)))
        for groups, es in device_groups:
            sel = frag_sel if row_sel_by_e is None else \
                np.stack([row_sel_by_e[e][::L] for e in es])
            out += um_window_query_device(
                groups, [self._params_log[e] for e in es], keys, L,
                frag_sel=sel)
        if host_epochs:
            stacks = [self._host_groups(e) for e in host_epochs]
            params = [self._params_log[e] for e in host_epochs]
            for level in range(L):
                sel = self._row_sel(path, level) if row_sel_by_e is None \
                    else [row_sel_by_e[e] & (self.row_levels == level)
                          for e in host_epochs]
                out[level] += Q.fleet_query_window(
                    stacks, params, None, keys, "um", frag_sel=sel)
        return out * scale if scale != 1.0 else out

    def cell_counters(self, epoch: int, sw: int) -> np.ndarray:
        """One (epoch, switch) cell of a retained window as an exact int32
        ``(n_levels, n, width)`` copy: the switch's live block at that
        epoch's ``n`` and width, read through ``_WindowBuffer.block`` from
        the resident group or the host copy (the reference pads it to the
        window's ``(n_sub_max, width_max)``).  Counters are exact integers
        below 2^24, so the cast is exact."""
        if epoch not in self._window_bufs:
            raise KeyError(f"epoch {epoch} has no retained window")
        buf, e_idx = self._window_bufs[epoch]
        i = self._frag_pos[sw]
        L = self.n_levels
        block = buf.block(e_idx, i * L, L,
                          *self._block_shape(self._params_log[epoch], i))
        return block.to(torch.int32).cpu().numpy()

    # -- export-plane cell hooks (runtime/export.py) -------------------------
    # The durable export plane holds each (epoch, switch) cell of a retained
    # window back (zeroed and masked, in its own liveness domain) until its
    # export message arrives, then patches the delivered payload back in
    # place, so late arrivals sharpen every later query through the
    # ordinary ``failures="mask"`` machinery.  Both work on the cell's live
    # ``(L, n, width)`` block, never on a padded one.

    def _own_row_live(self, epoch: int) -> np.ndarray:
        """The epoch's row liveness, as an array of its own: a per-epoch
        run with dead switches shares it with ``_recorded``, which must
        not change when a cell is held back or delivered."""
        live = self._row_live.get(epoch)
        if live is None:
            live = np.ones(len(self.frag_order) * self.n_levels, bool)
        elif live is self._recorded.get(epoch):
            live = live.copy()
        self._row_live[epoch] = live
        return live

    def mark_unexported(self, epoch: int, sws: Sequence[int]) -> None:
        """Hold (epoch, switch) cells back from the query plane: zero each
        switch's live block in the window and mask its rows.  Deliberately
        not the ``_lost`` domain, which is parity's: a held cell is in
        flight, not reclaimed.  The zeros are made where the window lives,
        so no cell crosses between devices."""
        if epoch not in self._window_bufs:
            raise KeyError(f"epoch {epoch} has no retained window")
        buf, e_idx = self._window_bufs[epoch]
        params = self._params_log[epoch]
        L = self.n_levels
        live = self._own_row_live(epoch)
        pend = self._unexported.setdefault(epoch, set())
        for sw in sws:
            i = self._frag_pos[sw]
            buf.zero(e_idx, i * L, L, *self._block_shape(params, i))
            live[i * L:(i + 1) * L] = False
            pend.add(i)

    def deliver_cell(self, epoch: int, sw: int, counters: np.ndarray) -> None:
        """Patch one delivered cell's exact integer ``(L, n, width)``
        counters back into the window and mark its rows live: the inverse
        of ``mark_unexported``.  Once every row of the epoch is live again
        its liveness entry goes, which restores the fast path with no
        failures."""
        if epoch not in self._window_bufs:
            raise KeyError(f"epoch {epoch} has no retained window")
        buf, e_idx = self._window_bufs[epoch]
        i = self._frag_pos[sw]
        L = self.n_levels
        want = (L,) + self._block_shape(self._params_log[epoch], i)
        counters = torch.as_tensor(np.asarray(counters))
        if tuple(counters.shape) != want:
            raise ValueError(f"cell ({epoch}, {sw}) payload has shape "
                             f"{tuple(counters.shape)}, its live block is "
                             f"{want}")
        buf.patch(e_idx, i * L, counters)
        pend = self._unexported.get(epoch)
        if pend is not None:
            pend.discard(i)
            if not pend:
                del self._unexported[epoch]
        if epoch in self._row_live:
            live = self._own_row_live(epoch)
            live[i * L:(i + 1) * L] = True
            if live.all():
                del self._row_live[epoch]
