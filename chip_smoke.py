#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in this checkout
(B1 ragged fleet update, B2 single-fragment update, B3 dense fleet
update), holds each against its plain PyTorch version on the card, also
on timed stress cases (a heavy hitter beside uniform keys, a 10^6-packet
row, fractional values; an n = 256 group for B1 and B3; a UnivMon level
row and a §4.4 row of 2^20 packets for B2), then
drives these paths through the user entry points at the paper's §6.1
full-scale setting:

* the fleet window path, cs and cms: ``DiSketchSystem`` +
  ``Replayer.run(system, window=8)`` + ``query_flows(merge="fragment")``
  on the device (B1); then one record of window 8 is touched, which copies
  that window to the host as its row groups, and queried with the default
  subepoch merge;
* the per-epoch path, cs and cms: ``calibrate_rho_target``, then
  ``DiSketchSystem`` + ``Replayer.run(system)`` epoch by epoch with the
  default ragged layout (B1) and with ``layout="dense"`` (B3), the
  loop-of-kernels baseline ``fleet_update_loop`` on one epoch (B2), and
  ``query_flows`` with the default subepoch merge for DiSketch and DISCO;
* UnivMon (16 levels, 320 level rows) on both: the window-8 replay (B1)
  and ``query_entropy(merge="fragment")`` on the device (the all-levels
  gather/merge and the G-sum); the per-epoch replay (B1), the B2 loop over
  one epoch's level rows, and ``query_entropy`` with both merges for
  DiSketch and the subepoch merge for DISCO;
* ``AggregatedSystem`` for cs, cms and um on the core switches.

Each path runs with the kernels' launch counters set to 0 just before it
and read just after, and the script checks that it went through its
kernels, that the dense, ragged and loop counters are bit-identical, and
that the answers are right: the RMSEs and entropies are pinned to the JAX
reference's values at this setting.

It imports nothing of JAX or of the JAX package.  It exits non-zero, and
prints no result, when CUDA is unavailable or the port's sources are
missing.  The last line of its output is the JSON result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# §6.1 full-scale scenario (benchmarks/common.py::fat_tree_scenario with
# quick=False, memories_for at 128 KB and Gini 0.4).
N_FLOWS, N_PACKETS, N_EPOCHS, LOG2_TE, SEED = 200_000, 2_000_000, 32, 16, 1
BASE_MEM, GINI, WINDOW = 128 * 1024, 0.4, 8
# rho_target per kind: the JAX reference's calibrate_rho_target (median
# probe-epoch PEB at n = 1 on the epoch n_epochs // 2 streams) evaluated
# once on a CPU at exactly this setting (UnivMon with n_levels=16 and the
# network-wide level_seed 7777: 63.30671088217913).
RHO = {"cs": 15.67, "cms": 1.0, "um": 63.31}
N_LEVELS, LEVEL_SEED = 16, 7777
# Answers pinned at this setting, each computed once on a CPU by the JAX
# reference's numpy paths (no Pallas) with the RHO above and the same
# workload, by scripts/reference_pins.py (which also gives RHO["um"]); the
# smoke holds the port to them within PIN_RTOL, and the UnivMon entropies
# of the device plane (f32 merge and G-sum) within PIN_RTOL_F32.
PIN_RTOL, PIN_RTOL_F32 = 1e-6, 1e-5
# RMSE of all 5-hop flows.  Per-epoch: the reference's loop backend
# (DiSketchSystem and DiscoSystem, Replayer.run, query_flows with the
# subepoch and the fragment merge).  Window 8: the reference's
# process_epoch with ns frozen for each window of 8 and Eq. 6 replayed in
# order at its end, then query_window(merge="fragment") per path group.
RMSE_PIN = {
    ("cs", "window 8"): 0.5982554646551216,
    ("cs", "subepoch"): 0.7363271811200329,
    ("cs", "fragment"): 0.5977069010872829,
    ("cs", "disco"): 0.6668421139659481,
    ("cms", "window 8"): 19.071132705491884,
    ("cms", "subepoch"): 1.1747041468698007,
    ("cms", "fragment"): 2.348328296754005,
    ("cms", "disco"): 0.07074468967211545,
}
# The reference's AggregatedSystem (depth 4, each core switch's memory;
# UnivMon with 16 levels), Replayer.run, then query_flows of the 5-hop
# flows at their core switch over the 32 epochs: RMSE.
AGG_RMSE_PIN = {"cs": 22.397749911646983, "cms": 2.0436255854263385,
                "um": 294.4489068656193}
# UnivMon entropy in bits of all 200 000 flows (n_levels 16).  Per-epoch
# control, over the first ENTROPY_EPOCHS epochs: the reference's loop
# backend's query_entropy, subepoch merge with k_heavy 1024 for DiSketch
# and DISCO, and the fragment merge with k_heavy = every key (a cutoff that
# does not bind, so no tie among equal estimates can select other keys
# than the device's stable order).  Window 8: the emulation above for
# UnivMon, um_gsum_window's per-level estimates (merge="fragment") over the
# 32 epochs, combined by um_gsum_combine with k_heavy = every key, and by
# the reference's device G-sum (_um_gsum_jit: lax.top_k, ties to the lower
# index) with the default k_heavy 1024, the cutoff query_entropy uses.
ENTROPY_EPOCHS = 8
ENTROPY_PIN = {
    "disketch subepoch": 10.810002453514972,
    "disco subepoch": 10.884638574135062,
    "disketch fragment": 10.880950946975236,
    "window 8 fragment": 11.471188325072735,
    "window 8 fragment k_heavy 1024": 11.503352649492847,
}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core
# 32-bit operations/s (the kernel's hashing is uint32 integer work).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# uint32 operations per (packet, level) pair the kernel cannot avoid:
# column hash (avalanche + seeding + limb product, 17), subepoch hash
# (11), sign hash (11), packet subepoch and compare (4), level test (3).
OPS_PER_PAIR = 46


def _log(msg: str) -> None:
    print(msg, flush=True)


def _pinned(what: str, got: float, want: float, rtol: float) -> None:
    """Fail unless ``got`` is the pinned reference value to ``rtol``."""
    rel = abs(got - want) / abs(want)
    if not rel <= rtol:
        raise AssertionError(f"{what}: {got!r} against the reference's "
                             f"{want!r} (relative {rel:.3g} > {rtol})")


def _phase(fn, *args):
    """Run one phase of the smoke and log its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    _log(f"phase   {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: its launches (a kernel's zero fill
    and kernel) captured once in a CUDA graph and the graph replayed
    between CUDA events, so the host's launch path (Python, ctypes, the
    allocator) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _time_ms(graph.replay, reps=reps)
    del graph
    return ms


def _packet_bytes(n_slots: int, n_live: int) -> int:
    """Bytes an update kernel must read from a packet array: every slot's
    value (4 B), and the key and timestamp (8 B) of live packets only, as
    the kernels skip value-0 padding once its value is read."""
    return 4 * n_slots + 8 * n_live


def _profiled(fn, name: str):
    """One call of ``fn`` (after one warm-up call) under torch.profiler:
    ``(wall ms, device ms of the kernels whose name holds name, their
    launches)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    ks = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    return (wall_ms, sum(e.self_device_time_total for e in ks) / 1e3,
            sum(e.count for e in ks))


def _counters():
    """The launch counters of the port's three kernel wrappers."""
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.kernels.sketch_update import ops

    return {"fleet_ragged": FK.fleet_update_ragged,
            "sketch_update": ops.sketch_update,
            "fleet_dense": FK.fleet_update}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _random_csr(rng, n_prow, n_levels, n_sub_choices, widths, blk=256,
                log2_te=LOG2_TE, mean_pkts=20_000):
    """A random ragged CSR case: Zipf segment lengths with empty rows,
    random seeds, per-row n_sub/width, random full 32-bit ts words."""
    from repro_torch.kernels.sketch_update import fleet as FK

    lens = np.minimum(rng.zipf(1.5, n_prow) * (mean_pkts // 4),
                      20 * mean_pkts)
    lens[rng.random(n_prow) < 0.2] = 0
    nblk = np.maximum(1, -(-lens // blk))
    nb = int(nblk.sum())
    keys = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64
                        ).astype(np.uint32)
    ts = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64).astype(np.uint32)
    vals = np.zeros(nb * blk, np.float32)
    starts = np.concatenate([[0], np.cumsum(nblk)]) * blk
    for r in range(n_prow):
        vals[starts[r]:starts[r] + lens[r]] = rng.integers(1, 4, lens[r])
    block_frag = np.repeat(np.arange(n_prow, dtype=np.int32), nblk)
    rows = n_prow * n_levels
    params = np.zeros((rows, FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (rows, 3))
    n_sub = np.repeat(rng.choice(n_sub_choices, n_prow), n_levels)
    params[:, FK.PARAM_WIDTH] = np.repeat(rng.choice(widths, n_prow),
                                          n_levels)
    params[:, FK.PARAM_N_SUB] = n_sub
    params[:, FK.PARAM_LOG2_N_SUB] = np.log2(n_sub).astype(np.int32)
    params[:, FK.PARAM_LEVEL] = np.tile(np.arange(n_levels), n_prow)
    params[:, FK.PARAM_MIT] = rng.random(rows) < 0.5
    return (keys, vals, ts, params, block_frag), dict(
        n_sub_max=int(n_sub.max()),
        width_max=int(params[:, FK.PARAM_WIDTH].max()), blk=blk,
        log2_te=log2_te, n_levels=n_levels)


def _to_device(args, dev):
    """Kernel inputs as the wrapper's device tensors (uint32 words as
    int32 bit patterns)."""
    import torch

    keys, vals, ts, params, block_frag = args
    return (torch.from_numpy(keys.view(np.int32).copy()).to(dev),
            torch.from_numpy(vals).to(dev),
            torch.from_numpy(ts.view(np.int32).copy()).to(dev),
            torch.from_numpy(params).to(dev),
            torch.from_numpy(block_frag).to(dev))


def _stress_rows(rng):
    """The stress cases of B1 and B3 (B2 takes the single-row ones), as
    ``{name: (per-row key arrays, widths, n_sub)}``.  A heavy hitter (one
    key on half of a 2^20-packet row: its counter is an exact integer near
    10^6, below 2^24) and a row of uniform keys of the same size, timed
    side by side for the atomics' same-address contention; a single row
    of ~10^6 Zipf(1.1) keys as in the trace (the old one-CTA-per-row
    grid's worst case); a window-shaped n = 256 group (16 narrow rows of ~15 000 packets); and
    a row of 2^16 packets on 16 keys with fractional values
    (``_stress_values``), whose adds to one counter are not integers."""
    n = 1 << 20

    def uniform(m):
        return rng.integers(0, 2 ** 32, m, dtype=np.uint64).astype(np.uint32)

    heavy = uniform(n)
    heavy[rng.random(n) < 0.5] = np.uint32(0x9E3779B9)
    zipf = ((rng.zipf(1.1, 1_000_003) % N_FLOWS).astype(np.uint32)
            * np.uint32(2654435761))
    return {
        "heavy hitter": ([heavy], [123974], 1),
        "uniform keys": ([uniform(n)], [123974], 1),
        "long row 1e6": ([zipf], [123974], 1),
        "n=256 group": ([uniform(int(m)) for m in
                         rng.integers(10_000, 20_000, 16)],
                        [3728, 7748] * 8, 256),
        "fractional values": ([uniform(16)[rng.integers(0, 16, 1 << 16)]],
                              [3728], 1),
    }


def _stress_values(rng, name, m):
    """A stress row's packet values: 1 to 3, or for the fractional case
    multiples of 1/4 up to 7/4 (dyadic, so every sum is exact in f32 in any
    order and the kernels must still equal their plain versions)."""
    if name == "fractional values":
        return rng.integers(1, 8, m) / 4
    return rng.integers(1, 4, m)


def _stress_params(rng, widths, n_sub):
    from repro_torch.kernels.sketch_update import fleet as FK

    params = np.zeros((len(widths), FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (len(widths), 3))
    params[:, FK.PARAM_WIDTH] = widths
    params[:, FK.PARAM_N_SUB] = n_sub
    params[:, FK.PARAM_LOG2_N_SUB] = int(n_sub).bit_length() - 1
    return params


def _stress_timing(name, kernel, plain, targs, kw, times):
    """Hold a stress case to its plain version (``torch.equal``) and time
    the kernel's device work on it (``_graph_ms``)."""
    import torch

    got, want = kernel(*targs, **kw), plain(*targs, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel.__name__} differs from its plain "
                             f"version on case {name!r}")
    times[name] = _graph_ms(lambda: kernel(*targs, **kw))
    peak = float(want.abs().max())
    del got, want
    return err, peak


def kernel_phase(dev) -> float:
    """The update kernel against its plain version on the card: skewed and
    empty rows, widths up to 262144, n_sub 1..64, UnivMon with 16 levels,
    §4.4 mitigation, and the stress cases of ``_stress_rows``, which are
    also timed.  Returns the largest absolute difference (0 when
    equal)."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    rng = np.random.default_rng(7)
    cases = [
        ("cs wide", True, False, dict(
            n_prow=24, n_levels=1, n_sub_choices=[1, 2, 4, 8],
            widths=[3728, 65536, 65537, 123974, 262144])),
        ("cms n_sub<=64", False, False, dict(
            n_prow=32, n_levels=1, n_sub_choices=[1, 2, 16, 32, 64],
            widths=[1000, 8335, 33815])),
        ("cs mitigation", True, True, dict(
            n_prow=20, n_levels=1, n_sub_choices=[1, 2, 4, 16],
            widths=[3728, 26102, 72248])),
        ("um 16 levels + mitigation", True, True, dict(
            n_prow=10, n_levels=16, n_sub_choices=[1, 2, 4, 8],
            widths=[233, 1638, 7748])),
    ]
    worst = 0.0
    for name, signed, mit, spec in cases:
        args, kw = _random_csr(rng, **spec)
        targs = _to_device(args, dev)
        got = FK.fleet_update_ragged(*targs, signed=signed,
                                     with_mitigation=mit, **kw)
        plain = FK.fleet_update_ragged_ref(*targs, signed=signed,
                                           with_mitigation=mit, **kw)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        ok = torch.equal(got, plain)
        _log(f"kernel  fleet_ragged  {name:28s} rows={args[3].shape[0]:4d} "
             f"packets={int((args[1] != 0).sum()):8d} "
             f"out={tuple(got.shape)} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError(f"fleet_ragged differs from its plain "
                                 f"version on case {name!r}")
    times = {}
    for name, (row_keys, widths, n_sub) in _stress_rows(rng).items():
        blk = 256
        nblk = [-(-len(k) // blk) for k in row_keys]
        keys = np.zeros(sum(nblk) * blk, np.uint32)
        vals = np.zeros(len(keys), np.float32)
        offs = np.concatenate([[0], np.cumsum(nblk)]) * blk
        for r, k in enumerate(row_keys):
            keys[offs[r]:offs[r] + len(k)] = k
            vals[offs[r]:offs[r] + len(k)] = _stress_values(rng, name,
                                                            len(k))
        ts = rng.integers(0, 2 ** 32, len(keys), dtype=np.uint64
                          ).astype(np.uint32)
        block_frag = np.repeat(np.arange(len(row_keys), dtype=np.int32),
                               nblk)
        params = _stress_params(rng, widths, n_sub)
        kw = dict(n_sub_max=n_sub, width_max=max(widths), log2_te=LOG2_TE,
                  signed=True, blk=blk, n_levels=1, with_mitigation=False)
        err, peak = _stress_timing(
            name, FK._launch, FK.fleet_update_ragged_ref,
            _to_device((keys, vals, ts, params, block_frag), dev), kw, times)
        worst = max(worst, err)
        _log(f"kernel  fleet_ragged  {name:28s} rows={len(row_keys):4d} "
             f"packets={int((vals != 0).sum()):8d} largest |counter| "
             f"{peak} equal=True max_abs_err={err} kernel "
             f"{times[name]:.4f} ms")
    _log(f"kernel  fleet_ragged  heavy hitter / uniform keys: "
         f"{times['heavy hitter'] / times['uniform keys']:.3f}")
    return worst


def _b2_stress_rows(rng, dev):
    """B2's stress rows on the card, ``{name: ((keys, vals, ts), ops._launch
    keywords)}``: the single-row cases of ``_stress_rows``, a UnivMon
    level-3 row and a §4.4 row of 2^20 uniform keys; each padded with
    value-0 packets to a multiple of 256, random full 32-bit ts words."""
    rows = {name: (row_keys[0], widths[0], 1, 0, False)
            for name, (row_keys, widths, _) in _stress_rows(rng).items()
            if len(row_keys) == 1}
    n = 1 << 20
    uniform = rng.integers(0, 2 ** 32, (2, n), dtype=np.uint64
                           ).astype(np.uint32)
    rows["um level 3 row"] = (uniform[0], 7748, 4, 3, False)
    rows["§4.4 row"] = (uniform[1], 26102, 16, 0, True)
    out = {}
    for name, (keys, width, n_sub, level, mit) in rows.items():
        p = -(-len(keys) // 256) * 256
        vals = np.zeros(p, np.float32)
        vals[:len(keys)] = _stress_values(rng, name, len(keys))
        ts = rng.integers(0, 2 ** 32, p, dtype=np.uint64).astype(np.uint32)
        targs = _to_device((np.pad(keys, (0, p - len(keys))), vals, ts,
                            np.zeros(0, np.int32), np.zeros(0, np.int32)),
                           dev)[:3]
        out[name] = targs, dict(width=width, n_sub=n_sub, log2_te=LOG2_TE,
                                col_seed=int(rng.integers(2 ** 31)),
                                sign_seed=int(rng.integers(2 ** 31)),
                                sub_seed=int(rng.integers(2 ** 31)),
                                signed=True, level=level, mitigation=mit)
    return out


def kernel_phase_single(dev) -> float:
    """B2 against its plain version on the card: widths up to 262144
    (above the 65536 hash wrap), n_sub 1..256, cs and cms, a UnivMon level
    row and a §4.4 row, packet counts that are not blk multiples; then
    the single-row stress cases of ``_stress_rows`` and a level row and a
    §4.4 row of 2^20 packets, each also timed."""
    import torch

    from repro_torch.kernels.sketch_update import ops
    from repro_torch.kernels.sketch_update.ref import sketch_update_ref

    rng = np.random.default_rng(11)
    cases = [  # width, n_sub, level, mitigation, signed, packets
        (123974, 1, 0, False, True, 300_001),
        (262144, 8, 0, False, True, 200_003),
        (65537, 32, 0, False, False, 100_019),
        (3728, 256, 0, False, False, 150_000),
        (7748, 4, 3, False, True, 90_007),
        (26102, 16, 0, True, True, 120_011),
        (1000, 2, 0, False, True, 777),
    ]
    worst = 0.0
    for width, n_sub, level, mit, signed, n in cases:
        keys = (rng.zipf(1.3, n) % 50_000).astype(np.uint32) \
            * np.uint32(2654435761)
        ts = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        vals = rng.integers(1, 4, n).astype(np.float32)
        kw = dict(width=width, n_sub=n_sub, log2_te=LOG2_TE,
                  col_seed=int(rng.integers(2 ** 31)),
                  sign_seed=int(rng.integers(2 ** 31)),
                  sub_seed=int(rng.integers(2 ** 31)), level=level,
                  mitigation=mit, signed=signed, device=dev)
        got = ops.sketch_update(keys, vals, ts, **kw)
        plain = ops.sketch_update(keys, vals, ts, backend="ref", **kw)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        worst = max(worst, err)
        ok = torch.equal(got, plain)
        _log(f"kernel  sketch_update width={width:6d} n_sub={n_sub:3d} "
             f"level={level} mit={int(mit)} signed={int(signed)} "
             f"packets={n:6d} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError(f"sketch_update differs from its plain "
                                 f"version at width={width} n_sub={n_sub}")
    times = {}
    for name, (targs, kw) in _b2_stress_rows(rng, dev).items():
        err, peak = _stress_timing(name, ops._launch, sketch_update_ref,
                                   targs, kw, times)
        worst = max(worst, err)
        _log(f"kernel  sketch_update {name:28s} width={kw['width']:6d} "
             f"n_sub={kw['n_sub']:3d} packets="
             f"{int((targs[1] != 0).sum()):8d} "
             f"largest |counter| {peak} equal=True max_abs_err={err} "
             f"kernel {times[name]:.4f} ms")
    _log(f"kernel  sketch_update heavy hitter / uniform keys: "
         f"{times['heavy hitter'] / times['uniform keys']:.3f}")
    return worst


def kernel_phase_dense(dev) -> float:
    """B3 against its plain version on the card: random rectangles with
    heterogeneous widths (one above 65536) and n_sub, empty rows, and the
    stress cases of ``_stress_rows``, which are also timed."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    rng = np.random.default_rng(13)
    worst = 0.0
    for signed, n_frags, p_max, n_choices in ((True, 20, 32768, [1, 2, 8]),
                                              (False, 16, 8192,
                                               [1, 4, 64, 256])):
        keys = rng.integers(0, 2 ** 32, (n_frags, p_max),
                            dtype=np.uint64).astype(np.uint32)
        ts = rng.integers(0, 2 ** 32, (n_frags, p_max),
                          dtype=np.uint64).astype(np.uint32)
        lens = rng.integers(0, p_max, n_frags)
        lens[0] = 0
        vals = ((np.arange(p_max)[None, :] < lens[:, None])
                * rng.integers(1, 4, (n_frags, p_max))).astype(np.float32)
        params = np.zeros((n_frags, FK.N_PARAMS), np.int32)
        params[:, :3] = rng.integers(0, 2 ** 31, (n_frags, 3))
        n_sub = rng.choice(n_choices, n_frags)
        params[:, FK.PARAM_WIDTH] = rng.choice(
            [233, 3728, 33815, 70001, 123974], n_frags)
        params[:, FK.PARAM_N_SUB] = n_sub
        params[:, FK.PARAM_LOG2_N_SUB] = np.log2(n_sub).astype(np.int32)
        kw = dict(n_sub_max=int(n_sub.max()),
                  width_max=int(params[:, FK.PARAM_WIDTH].max()),
                  log2_te=LOG2_TE, signed=signed)
        targs = _to_device((keys, vals, ts, params,
                            np.zeros(0, np.int32)), dev)[:4]
        got = FK.fleet_update(*targs, **kw)
        plain = FK.fleet_update_ref(*targs, **kw)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        worst = max(worst, err)
        ok = torch.equal(got, plain)
        _log(f"kernel  fleet_dense   {'cs' if signed else 'cms':3s} "
             f"{n_frags}x{p_max} n_sub {sorted(set(n_sub.tolist()))} "
             f"out={tuple(got.shape)} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError("fleet_dense differs from its plain version")
        del got, plain
    times = {}
    for name, (row_keys, widths, n_sub) in _stress_rows(rng).items():
        p_max = -(-max(len(k) for k in row_keys) // 256) * 256
        keys = np.zeros((len(row_keys), p_max), np.uint32)
        vals = np.zeros(keys.shape, np.float32)
        for r, k in enumerate(row_keys):
            keys[r, :len(k)] = k
            vals[r, :len(k)] = _stress_values(rng, name, len(k))
        ts = rng.integers(0, 2 ** 32, keys.shape, dtype=np.uint64
                          ).astype(np.uint32)
        params = _stress_params(rng, widths, n_sub)
        kw = dict(n_sub_max=n_sub, width_max=max(widths), log2_te=LOG2_TE,
                  signed=True)
        err, peak = _stress_timing(
            name, FK._launch_dense, FK.fleet_update_ref,
            _to_device((keys, vals, ts, params, np.zeros(0, np.int32)),
                       dev)[:4], kw, times)
        worst = max(worst, err)
        _log(f"kernel  fleet_dense   {name:28s} {len(row_keys)}x{p_max} "
             f"packets={int((vals != 0).sum()):8d} largest |counter| "
             f"{peak} equal=True max_abs_err={err} kernel "
             f"{times[name]:.4f} ms")
    _log(f"kernel  fleet_dense   heavy hitter / uniform keys: "
         f"{times['heavy hitter'] / times['uniform keys']:.3f}")
    return worst


def _window_groups(fleet, rep, e0, n_epochs=WINDOW):
    """The grouped launches of the ``n_epochs`` epochs from ``e0`` (a
    window, or one epoch of the per-epoch path) exactly as the fleet
    runner makes them: ``[(args, kw)]`` per distinct n_sub."""
    from repro_torch.core.fleet import fold_packet_flags, pack_csr
    from repro_torch.kernels.sketch_update import fleet as FK

    es = [e for e in range(e0, e0 + n_epochs) if e in fleet._params_log]
    params = np.concatenate([fleet._params_log[e] for e in es])
    packets = [fold_packet_flags(rep.epoch_packet(e, fleet.frag_order),
                                 fleet.log2_te, n_levels=fleet.n_levels,
                                 level_seed=fleet.level_seed,
                                 mitigation=fleet.mitigation) for e in es]
    n_frags, L = len(fleet.frag_order), fleet.n_levels
    nsub_f = params[:n_frags * L:L, FK.PARAM_N_SUB]
    width_f = params[:n_frags * L:L, FK.PARAM_WIDTH]
    groups = []
    for n in np.unique(nsub_f):
        idx = np.flatnonzero(nsub_f == n)
        rows = ((np.arange(len(es))[:, None] * n_frags + idx[None, :])
                .ravel()[:, None] * L + np.arange(L)[None, :]).ravel()
        keys, vals, ts, bf = pack_csr([p.select(idx) for p in packets],
                                      fleet.blk)
        groups.append(((keys, vals, ts, params[rows], bf), dict(
            n_sub_max=int(n), width_max=int(width_f[idx].max()),
            log2_te=fleet.log2_te, signed=fleet.kind in ("cs", "um"),
            blk=fleet.blk, n_levels=L, with_mitigation=fleet.mitigation)))
    return groups


def _smallest_path(fleet, e0, paths):
    """The path whose rows span the least ``n_sub x width`` in window
    ``e0``, and a host copy of just its rows (every level's, for UnivMon,
    fragment-major): ``(path, (E, len, S, W) array, row indices)``."""
    groups = fleet._window_bufs[e0][0].device()
    where = {int(r): (c, j) for rows, c in groups for j, r in enumerate(rows)}
    L = fleet.n_levels
    pos = {sw: i * L for i, sw in enumerate(fleet.frag_order)}

    def span(path):
        cs = [where[pos[sw]][0] for sw in path]
        return max(c.shape[2] for c in cs) * max(c.shape[3] for c in cs)

    path = min(sorted(set(paths)), key=span)
    rows = np.array([pos[sw] + l for sw in path for l in range(L)])
    parts = [where[r][0][:, where[r][1]] for r in rows]
    dense = np.zeros((parts[0].shape[0], len(rows),
                      max(p.shape[1] for p in parts),
                      max(p.shape[2] for p in parts)), np.float32)
    for i, p in enumerate(parts):
        dense[:, i, :p.shape[1], :p.shape[2]] = p.cpu().numpy()
    return path, dense, rows


def build_scenario() -> dict:
    """The §6.1 workload, its replayer and the per-switch memories, shared
    by both paths (data made anew from the seeds in every run)."""
    from repro_torch.net.simulator import Replayer
    from repro_torch.net.topology import FatTree
    from repro_torch.net.traffic import gen_workload, gini_memories

    t0 = time.perf_counter()
    topo = FatTree(4)
    wl = gen_workload(topo, n_flows=N_FLOWS, total_packets=N_PACKETS,
                      n_epochs=N_EPOCHS, log2_te=LOG2_TE, burstiness=0.2,
                      seed=SEED)
    rep = Replayer(wl, topo.n_switches)
    mems = gini_memories(topo.n_switches, BASE_MEM, GINI,
                         np.random.RandomState(SEED + 100))
    mems = {sw: int(m) for sw, m in enumerate(mems)}
    widths = [m // 4 for m in mems.values()]
    events = sum(len(st.keys) for e in range(N_EPOCHS)
                 for st in rep.epoch_stream(e).values())
    _log(f"main    workload: FatTree(4) {topo.n_switches} switches, "
         f"{len(wl.keys)} flows, {len(wl.pkt_ts)} packets, {N_EPOCHS} "
         f"epochs, {events} packet-switch events ({events / N_EPOCHS:.0f} "
         f"per epoch), widths {min(widths)}..{max(widths)}; built in "
         f"{time.perf_counter() - t0:.1f} s")
    sel = wl.path_len == 5
    return dict(wl=wl, rep=rep, mems=mems, events=events,
                keys=wl.keys[sel], truth=wl.sizes[sel],
                paths=[p for p, s in zip(wl.paths, sel) if s])


def main_path(dev, sc):
    """The fleet window path at the §6.1 setting, cs then cms.  Returns a
    dict of what the kernel line needs."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.core.query import fleet_query_window, path_groups
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse

    rep, mems, events = sc["rep"], sc["mems"], sc["events"]
    keys, truth, paths = sc["keys"], sc["truth"], sc["paths"]
    epochs = list(range(N_EPOCHS))
    n_windows = -(-N_EPOCHS // WINDOW)
    result = {"launches": 0, "max_abs_err": 0.0}
    for kind in ("cs", "cms"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                                log2_te=LOG2_TE)
        fleet = system.fleet
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts()
        h0 = time.perf_counter()
        start.record()
        rep.run(system, window=WINDOW)          # <- the window path
        end.record()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - h0
        counts = read_counts()
        launches = counts["fleet_ragged"]
        assert counts["sketch_update"] == counts["fleet_dense"] == 0, counts
        result["launches"] += launches
        window_ms = start.elapsed_time(end) / n_windows
        expected = sum(len(np.unique(fleet._params_log[e0][:, FK.PARAM_N_SUB]))
                       for e0 in range(0, N_EPOCHS, WINDOW))
        assert launches > 0, "the main path launched no kernel"
        assert launches == expected, (launches, expected)
        bufs = list({id(b): b for b, _ in fleet._window_bufs.values()
                     }.values())
        assert all(b.resident and b._host is None
                   and all(c.is_cuda for _, c in b.device())
                   for b in bufs), "a window stack left the device"
        stack_bytes = sum(c.numel() * 4 for b in bufs for _, c in b.device())
        shapes = [[tuple(c.shape) for _, c in b.device()] for b in bufs]

        # one window's counters against the plain version on the card,
        # group by group (the runner keeps them as these groups)
        e0 = WINDOW
        buf = fleet._window_bufs[e0][0]
        groups = _window_groups(fleet, rep, e0)
        err = 0.0
        plain_host = []
        for (args, kw), (_, got) in zip(groups, buf.device()):
            plain = FK.fleet_update_ragged_ref(*_to_device(args, dev), **kw)
            got = got.reshape(plain.shape)
            err = max(err, float((got - plain).abs().max()))
            assert torch.equal(got, plain), f"{kind}: window stack != plain"
            if kind == "cs":            # for the host copy's check below
                plain_host.append(plain.cpu().numpy())
            del plain
        result["max_abs_err"] = max(result["max_abs_err"], err)

        # queries: all 5-hop flows over the 32 epochs, on the device
        q0 = time.perf_counter()
        est = system.query_flows(keys, paths, epochs, merge="fragment")
        torch.cuda.synchronize()
        q_s = time.perf_counter() - q0
        assert est.shape == keys.shape and np.isfinite(est).all()
        err_rmse = rmse(est, truth)
        _pinned(f"{kind} window 8 RMSE", err_rmse, RMSE_PIN[(kind, "window 8")],
                PIN_RTOL)
        # ... and, per window, the path group whose rows are the smallest
        # against the numpy oracle on a host copy of just those rows (the
        # buffers themselves stay resident)
        for w0 in range(0, N_EPOCHS, WINDOW):
            es = list(range(w0, min(w0 + WINDOW, N_EPOCHS)))
            path, dense, rows = _smallest_path(fleet, w0, paths)
            kk = keys[[p == path for p in paths]]
            host_est = fleet_query_window(
                list(dense), [fleet._params_log[e][rows] for e in es], None,
                kk, kind)
            np.testing.assert_allclose(fleet.window_query(es, kk, path=path),
                                       host_est, rtol=1e-6, atol=1e-6)
        assert all(b._host is None for b in bufs)
        peak = torch.cuda.max_memory_allocated()
        n_by_window = [sorted(set(fleet._params_log[w0][:, FK.PARAM_N_SUB]
                                  .tolist()))
                       for w0 in range(0, N_EPOCHS, WINDOW)]
        _log(f"main    {kind}: rho_target={RHO[kind]} launches={launches} "
             f"(grouped launches expected {expected}) window={WINDOW} "
             f"update {window_ms:.2f} ms/window (CUDA events; "
             f"{events / (window_ms * n_windows / 1e3):.4g} packet-switch "
             f"events/s; host {run_s:.2f} s total) stack {stack_bytes} B "
             f"on device in {len(bufs)} windows, peak device memory "
             f"{peak} B; n_sub per window {n_by_window}; group shapes "
             f"{shapes}; window {e0} counters == plain version (max_abs_err "
             f"{err}); query of {len(keys)} 5-hop flows {q_s:.2f} s, RMSE "
             f"{err_rmse!r} (the reference's, pinned); device == host "
             f"oracle in every window; window stacks never copied to the "
             f"host")
        if kind == "cs":
            result["timing"] = kernel_timing(
                _window_groups(system.fleet, rep, WINDOW), dev)
            host_copy(system, keys, paths, plain_host)
        del system, fleet, bufs, buf, plain_host
    profile_replay(mems, rep)
    return result


def host_copy(system, keys, paths, plain_host):
    """The record plane on a replayed window: touch one record
    of window 8, which copies that window to the host as its row groups;
    check the copy against the plain version's counters (``plain_host``,
    one array per group) and that every record is a view of its group;
    query the window with the default subepoch merge; and hold the fleet's
    host query branch, which reads the groups, to the device answer it
    gave before the copy."""
    fleet = system.fleet
    buf = fleet._window_bufs[WINDOW][0]
    es = list(range(WINDOW, 2 * WINDOW))
    path, _, _ = _smallest_path(fleet, WINDOW, paths)
    kk = keys[[p == path for p in paths]]
    before = fleet.window_query(es, kk, path=path)
    group_bytes = sum(c.numel() * 8 for _, c in buf.device())
    padded_bytes = int(np.prod(buf._shape)) * 8
    h0 = time.perf_counter()
    system.records[WINDOW][fleet.frag_order[0]]   # <- touches one record
    copy_s = time.perf_counter() - h0
    assert not buf.resident and buf.host_bytes == group_bytes
    for (_, c), p in zip(buf.host(), plain_host):
        assert np.array_equal(c, p.reshape(c.shape).astype(np.int64)), \
            "host copy != plain version"
    for e in es:
        for sw in fleet.frag_order:
            assert any(np.shares_memory(system.records[e][sw].counters, c)
                       for _, c in buf.host()), "a record is not a view"
    n_q = min(4096, len(keys))
    q0 = time.perf_counter()
    est = system.query_flows(keys[:n_q], paths[:n_q], es)   # subepoch merge
    q_s = time.perf_counter() - q0
    assert est.shape == (n_q,) and np.isfinite(est).all()
    np.testing.assert_allclose(fleet.window_query(es, kk, path=path), before,
                               rtol=1e-6, atol=1e-6)
    _log(f"c5      cs window {WINDOW}: touching one record copied the window "
         f"to the host as {len(buf.host())} row groups, {buf.host_bytes} B "
         f"int64 (the padded (E, R, n_sub_max, width_max) copy "
         f"{buf._shape}: {padded_bytes} B) in {copy_s:.3f} s; copy == the "
         f"plain version; records are views of their groups; subepoch-merge "
         f"query of {n_q} 5-hop flows over epochs {es[0]}-{es[-1]} "
         f"{q_s:.2f} s; host window_query == the device's before the copy")


def _n_trajectory(n_log):
    """How many fragments run at each subepoch count, epoch by epoch, with
    runs of equal epochs merged: ``e0-e1 {n: fragments}``."""
    runs = []
    for e, ns in enumerate(n_log):
        hist = dict(sorted(zip(*np.unique(list(ns.values()),
                                          return_counts=True))))
        hist = {int(k): int(v) for k, v in hist.items()}
        if runs and runs[-1][2] == hist:
            runs[-1][1] = e
        else:
            runs.append([e, e, hist])
    return "; ".join(f"{a}-{b} {h}" for a, b, h in runs)


def _epoch_ns(system, e):
    """The ``ns`` that epoch ``e`` ran at (Eq. 6 after epoch e - 1)."""
    return system.n_log[e - 1] if e else {sw: 1 for sw in system.ns}


def _replay(rep, system):
    """``Replayer.run(system)`` with the launch counters reset just
    before and read just after; returns (counts, host s, device ms)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    h0 = time.perf_counter()
    start.record()
    rep.run(system)                              # <- the per-epoch path
    end.record()
    torch.cuda.synchronize()
    return read_counts(), time.perf_counter() - h0, start.elapsed_time(end)


def _sampled_epoch(system, rep, dev):
    """The epoch of a per-epoch replay of ``system`` that ran the most
    subepochs (the earliest on a tie), as the B2 loop and B3 take it:
    ``(epoch, packet, dense rectangle, parameter table, kernel keywords,
    rectangle and table on the card)``."""
    from repro_torch.core.fleet import build_params

    fleet = system.fleet
    e = max(range(N_EPOCHS),
            key=lambda e: (max(_epoch_ns(system, e).values()), -e))
    ns = _epoch_ns(system, e)
    params = build_params(fleet.fragments, e, ns, fleet.frag_order)
    packet = rep.epoch_packet(e, fleet.frag_order)
    rect = packet.densify(fleet.blk)
    kw = dict(n_sub_max=max(ns.values()), width_max=int(fleet.widths.max()),
              log2_te=LOG2_TE, signed=fleet.kind == "cs")
    trect = _to_device(rect + (params, np.zeros(0, np.int32)), dev)[:4]
    return e, packet, rect, params, kw, trect


def epoch_path(dev, sc):
    """The per-epoch path at the §6.1 setting, cs then cms: calibration,
    the ragged (B1) and dense (B3) replays, the B2 loop on the epoch with
    the most subepochs, and subepoch-merge queries for DiSketch and
    DISCO.  Returns what the kernel line needs."""
    import torch

    from repro_torch.core.disketch import (DiscoSystem, DiSketchSystem,
                                           calibrate_rho_target)
    from repro_torch.core.fleet import dispatch_ragged_grouped
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse

    rep, mems, events = sc["rep"], sc["mems"], sc["events"]
    keys, truth, paths = sc["keys"], sc["truth"], sc["paths"]
    epochs = list(range(N_EPOCHS))
    res = {"ragged": 0, "dense": 0, "loop": 0, "max_abs_err": 0.0}
    for kind in ("cs", "cms"):
        c0 = time.perf_counter()
        rho = calibrate_rho_target(mems, kind,
                                   rep.epoch_stream(N_EPOCHS // 2), LOG2_TE)
        assert abs(rho - RHO[kind]) <= 0.005, (kind, rho, RHO[kind])
        _log(f"epoch   {kind}: calibrate_rho_target = {rho!r} (the "
             f"reference's {RHO[kind]} to its rounding) in "
             f"{time.perf_counter() - c0:.2f} s")

        # ragged (B1); keep_stacked keeps each epoch's groups on the card
        # so the device query plane can be held to the record plane below
        torch.cuda.reset_peak_memory_stats()
        system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                                log2_te=LOG2_TE,
                                fleet_kwargs={"keep_stacked": True})
        counts, host_s, dev_ms = _replay(rep, system)
        peak = torch.cuda.max_memory_allocated()
        expected = sum(len(set(_epoch_ns(system, e).values()))
                       for e in epochs)
        assert counts["fleet_ragged"] == expected > 0, (counts, expected)
        assert counts["fleet_dense"] == counts["sketch_update"] == 0, counts
        res["ragged"] += counts["fleet_ragged"]
        _log(f"epoch   {kind} ragged: launches {counts} (expected "
             f"{expected}: one per distinct n per epoch); update "
             f"{dev_ms / N_EPOCHS:.3f} ms/epoch on the device timeline "
             f"(CUDA events; {events / (dev_ms / 1e3):.4g} packet-switch "
             f"events/s), host {host_s:.2f} s for {N_EPOCHS} epochs; peak "
             f"device memory {peak} B")
        _log(f"epoch   {kind} n after each epoch (epochs: {{n: "
             f"fragments}}): {_n_trajectory(system.n_log)}")

        # dense (B3): records and n trajectory bit-identical to ragged
        torch.cuda.reset_peak_memory_stats()
        dense = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                               log2_te=LOG2_TE,
                               fleet_kwargs={"layout": "dense"})
        counts_d, host_d, dev_ms_d = _replay(rep, dense)
        peak_d = torch.cuda.max_memory_allocated()
        assert counts_d["fleet_dense"] == N_EPOCHS, counts_d
        assert counts_d["fleet_ragged"] == counts_d["sketch_update"] == 0
        res["dense"] += counts_d["fleet_dense"]
        assert dense.n_log == system.n_log, "dense n trajectory != ragged"
        for e in epochs:
            for sw in mems:
                a, b = dense.records[e][sw], system.records[e][sw]
                assert a.n == b.n and np.array_equal(a.counters, b.counters), \
                    f"{kind}: dense record ({e}, {sw}) != ragged"
        assert not dense.fleet._window_bufs
        _log(f"epoch   {kind} dense: launches {counts_d}; update "
             f"{dev_ms_d / N_EPOCHS:.3f} ms/epoch on the device timeline, "
             f"host {host_d:.2f} s; peak device memory {peak_d} B; records "
             f"and n trajectory == ragged in all {N_EPOCHS} epochs")

        # B2 loop on the epoch with the most subepochs
        e_star, packet, rect, params, kw, trect = _sampled_epoch(
            system, rep, dev)
        fleet = system.fleet
        reset_counts()
        loop = FK.fleet_update_loop(*trect, device=dev, **kw)  # <- B2 path
        torch.cuda.synchronize()
        counts_l = read_counts()
        assert counts_l["sketch_update"] == len(params) > 0, counts_l
        assert counts_l["fleet_ragged"] == counts_l["fleet_dense"] == 0
        res["loop"] += counts_l["sketch_update"]
        b3 = FK.fleet_update(*trect, **kw)
        plain = FK.fleet_update_ref(*trect, **kw)
        loop_plain = FK.fleet_update_loop(*trect, backend="ref", device=dev,
                                          **kw)
        torch.cuda.synchronize()
        err = max(float((loop - loop_plain).abs().max()),
                  float((b3 - plain).abs().max()))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        assert torch.equal(loop, loop_plain), "B2 loop != its plain version"
        assert torch.equal(b3, plain), "B3 != its plain version"
        assert torch.equal(loop, b3), "B2 loop != B3 on the sampled epoch"
        groups = dispatch_ragged_grouped(params, [packet], log2_te=LOG2_TE,
                                         signed=kind == "cs", blk=fleet.blk,
                                         device=dev)
        for rows, c in groups:
            idx = torch.as_tensor(rows, device=dev)
            part = b3[idx, :c.shape[2], :c.shape[3]]
            assert torch.equal(c[0], part), "B1 groups != B3 on the epoch"
        for i, sw in enumerate(fleet.frag_order):
            rec = system.records[e_star][sw]
            assert np.array_equal(
                rec.counters, loop[i, :rec.n, :rec.counters.shape[1]]
                .cpu().numpy().astype(np.int64)), "record != B2 loop"
        res.setdefault("timing", {})[kind] = dict(
            epoch=e_star, trect=trect, kw=kw, params=params,
            live=int((rect[1] != 0).sum()),
            ragged=_window_groups(fleet, rep, e_star, n_epochs=1))
        _log(f"epoch   {kind} B2 loop on epoch {e_star} (n_sub_max "
             f"{kw['n_sub_max']}, {len(params)} rows, rectangle "
             f"{rect[0].shape}): launches {counts_l}; == its plain version, "
             f"== B3 (== its plain version), == the {len(groups)} grouped "
             f"B1 launches, == the ragged run's records")
        del loop, loop_plain, b3, plain, groups

        # queries: the subepoch merge on the records, for DiSketch and DISCO
        q0 = time.perf_counter()
        est = system.query_flows(keys, paths, epochs)
        q_s = time.perf_counter() - q0
        assert est.shape == keys.shape and np.isfinite(est).all()
        frag_dev = system.query_flows(keys, paths, epochs, merge="fragment")
        assert system.fleet.has_device_window(epochs)
        frag_rec = dense.query_flows(keys, paths, epochs, merge="fragment")
        np.testing.assert_allclose(frag_dev, frag_rec, rtol=1e-6, atol=1e-6)
        disco = DiscoSystem(mems, kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE)
        counts_o, host_o, _ = _replay(rep, disco)
        assert counts_o["fleet_ragged"] == N_EPOCHS, counts_o
        res["ragged"] += counts_o["fleet_ragged"]
        q1 = time.perf_counter()
        est_o = disco.query_flows(keys, paths, epochs)
        q_o = time.perf_counter() - q1
        assert est_o.shape == keys.shape and np.isfinite(est_o).all()
        for merge, got in (("subepoch", est), ("fragment", frag_dev),
                           ("disco", est_o)):
            _pinned(f"{kind} per-epoch {merge} RMSE", rmse(got, truth),
                    RMSE_PIN[(kind, merge)], PIN_RTOL)
        _log(f"epoch   {kind} queries (all {len(keys)} 5-hop flows, "
             f"{N_EPOCHS} epochs, subepoch merge): DiSketch RMSE {rmse(est, truth):.4f} in "
             f"{q_s:.2f} s; DISCO RMSE {rmse(est_o, truth):.4f} in "
             f"{q_o:.2f} s (DISCO replay {host_o:.2f} s, launches "
             f"{counts_o}); fragment merge: RMSE {rmse(frag_dev, truth):.4f}"
             f" on the device == the record plane (1e-6); all three RMSEs "
             f"the reference's (pinned)")
        del system, dense, disco, fleet
        torch.cuda.empty_cache()
    profile_replay(mems, rep, window=1)
    return res


def _gsum_stable_f64(ests, lvl, k_heavy=1024):
    """The top-down G-sum of ``core.query.um_gsum_combine`` for the entropy
    ``g``, in float64, selecting as the device does: the ``k_heavy``
    largest estimates with ties broken by the lower index (the host
    combine's ``np.argsort`` is not stable)."""
    y = 0.0
    top = ests.shape[0] - 1
    for l in range(top, -1, -1):
        idx = np.flatnonzero(lvl >= l)
        est = np.maximum(ests[l, idx], 1.0)
        order = np.argsort(-est, kind="stable")[:k_heavy]
        gv = est[order] * np.log2(est[order])
        in_next = (lvl[idx][order] >= l + 1).astype(np.float64)
        y = float(gv.sum()) if l == top else \
            2.0 * y + float(((1.0 - 2.0 * in_next) * gv).sum())
    return y


def univmon_window(dev, sc):
    """UnivMon on the fleet window path at the §6.1 setting (16 levels: 320
    level rows): the replay (B1 over every level row), one window's level
    groups against the plain version, ``query_entropy(merge="fragment")``
    of all flows over the 32 epochs on the device, its per-level estimates
    against the host per-level query on a few path groups, and the device
    G-sum against the float64 combine.  Returns what the kernel line
    needs."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem, _g_entropy
    from repro_torch.core.hashing import level_of
    from repro_torch.core.query import fleet_query_window, path_groups
    from repro_torch.core.sketches import true_entropy
    from repro_torch.kernels.sketch_query import um_gsum_device
    from repro_torch.kernels.sketch_update import fleet as FK

    wl, rep, mems, events = sc["wl"], sc["rep"], sc["mems"], sc["events"]
    epochs = list(range(N_EPOCHS))
    n_windows = -(-N_EPOCHS // WINDOW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system = DiSketchSystem(mems, "um", rho_target=RHO["um"],
                            log2_te=LOG2_TE, n_levels=N_LEVELS)
    fleet = system.fleet
    assert fleet.level_seed == LEVEL_SEED
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    h0 = time.perf_counter()
    start.record()
    rep.run(system, window=WINDOW)          # <- the UnivMon window path
    end.record()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - h0
    counts = read_counts()
    launches = counts["fleet_ragged"]
    expected = sum(len(np.unique(fleet._params_log[e0][:, FK.PARAM_N_SUB]))
                   for e0 in range(0, N_EPOCHS, WINDOW))
    assert launches == expected > 0, (counts, expected)
    assert counts["sketch_update"] == counts["fleet_dense"] == 0, counts
    window_ms = start.elapsed_time(end) / n_windows
    bufs = list({id(b): b for b, _ in fleet._window_bufs.values()}.values())
    assert all(b.resident and b._host is None
               and all(c.is_cuda for _, c in b.device()) for b in bufs)
    stack_bytes = sum(c.numel() * 4 for b in bufs for _, c in b.device())
    rows = len(fleet.frag_order) * N_LEVELS
    peak_replay = torch.cuda.max_memory_allocated()

    # window 8's level-row groups against the plain version
    err = 0.0
    for (args, kw), (_, got) in zip(_window_groups(fleet, rep, WINDOW),
                                    fleet._window_bufs[WINDOW][0].device()):
        plain = FK.fleet_update_ragged_ref(*_to_device(args, dev), **kw)
        got = got.reshape(plain.shape)
        err = max(err, float((got - plain).abs().max()))
        assert torch.equal(got, plain), "um window groups != plain version"
        del plain

    # entropy of all flows over the 32 epochs, on the device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = float(len(wl.pkt_ts))
    truth = true_entropy(wl.sizes)
    q0 = time.perf_counter()
    ent = system.query_entropy(wl.keys, wl.paths, epochs, total,
                               n_levels=N_LEVELS, level_seed=LEVEL_SEED,
                               merge="fragment")
    q_s = time.perf_counter() - q0
    _pinned("um window 8 entropy (fragment merge)", ent,
            ENTROPY_PIN["window 8 fragment k_heavy 1024"], PIN_RTOL_F32)
    # the same per-level estimates, whose G-sum gave ``ent``; the device
    # G-sum against the float64 combine with the device's selection
    by_path = path_groups(wl.paths)
    q1 = time.perf_counter()
    ests = np.concatenate([fleet.um_level_window_query(
        epochs, wl.keys[i], path=p) for p, i in by_path.items()], axis=1)
    ests_s = time.perf_counter() - q1
    lvl = np.concatenate([level_of(wl.keys[i], LEVEL_SEED, N_LEVELS)
                          for i in by_path.values()])
    assert ests.shape == (N_LEVELS, len(wl.keys))
    s_dev = um_gsum_device(ests, lvl, _g_entropy, device=dev)
    assert np.log2(total) - s_dev / total == ent
    s_host = _gsum_stable_f64(ests, lvl)
    gsum_rel = abs(s_dev - s_host) / abs(s_host)
    assert gsum_rel <= 1e-5, (s_dev, s_host)
    s_all = um_gsum_device(ests, lvl, _g_entropy, k_heavy=len(wl.keys),
                           device=dev)
    ent_all = float(np.log2(total) - s_all / total)
    _pinned("um window 8 entropy (fragment merge, k_heavy = every key)",
            ent_all, ENTROPY_PIN["window 8 fragment"], PIN_RTOL_F32)
    # per window, a 5-, a 3- and a 1-hop path group: the device (L, K)
    # estimates against the host per-level query on a copy of those rows
    checked = 0
    for w0 in range(0, N_EPOCHS, WINDOW):
        es = list(range(w0, min(w0 + WINDOW, N_EPOCHS)))
        for hops in (5, 3, 1):
            path, dense, prow = _smallest_path(
                fleet, w0, [p for p in by_path if len(p) == hops])
            kk = wl.keys[by_path[path]]
            got = fleet.um_level_window_query(es, kk, path=path)
            params = [fleet._params_log[e][prow] for e in es]
            for l in range(N_LEVELS):
                host = fleet_query_window(
                    list(dense), params, None, kk, "um",
                    frag_sel=np.arange(len(prow)) % N_LEVELS == l)
                np.testing.assert_allclose(got[l], host, rtol=1e-6,
                                           atol=1e-6)
            checked += len(kk)
    assert all(b.resident and b._host is None for b in bufs), \
        "a UnivMon window left the device"
    peak_query = torch.cuda.max_memory_allocated()
    timing = kernel_timing(_window_groups(fleet, rep, WINDOW), dev)
    n_by_window = [sorted(set(fleet._params_log[w0][:, FK.PARAM_N_SUB]
                              .tolist()))
                   for w0 in range(0, N_EPOCHS, WINDOW)]
    _log(f"univmon window {WINDOW}: rho_target={RHO['um']} n_levels="
         f"{N_LEVELS} ({rows} level rows) launches={launches} (expected "
         f"{expected}); update {window_ms:.2f} ms/window (CUDA events; "
         f"{events / (window_ms * n_windows / 1e3):.4g} packet-switch "
         f"events/s; host {run_s:.2f} s total); resident {stack_bytes} B "
         f"in {len(bufs)} windows, peak device memory {peak_replay} B in the "
         f"replay, {peak_query} B in the queries; n_sub per "
         f"window {n_by_window}; window {WINDOW} level groups == plain "
         f"version (max_abs_err {err})")
    _log(f"univmon entropy of {len(wl.keys)} flows over {N_EPOCHS} epochs, "
         f"fragment merge on the device: {ent!r} bits (true "
         f"{truth!r}; |error| {abs(ent - truth):.4f}; the reference's, "
         f"pinned) in {q_s:.2f} s "
         f"(per-level estimates {ests_s:.2f} s); k_heavy = every key: "
         f"{ent_all!r} (the reference's, pinned); device G-sum {s_dev!r} "
         f"against the float64 combine {s_host!r} (relative {gsum_rel:.3g});"
         f" device (L, K) == host per-level query for {checked} keys of "
         f"12 path groups; windows stayed on the device")
    _timing_line(f"fleet_ragged one um window ({timing['groups']} launches, "
                 f"{N_LEVELS} levels)", timing)
    del system, fleet, bufs
    profile_replay(mems, rep, kind="um")
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err)


def univmon_epoch(dev, sc):
    """UnivMon on the per-epoch path at the §6.1 setting: calibration, the
    ragged replay (B1, groups kept on the card), the B2 loop over the 320
    level rows of the epoch with the most subepochs against B1, the
    records and the plain version, and ``query_entropy`` with both merges
    for DiSketch and the subepoch merge for DISCO.  Returns what the
    kernel line needs."""
    import torch

    from repro_torch.core.disketch import (DiscoSystem, DiSketchSystem,
                                           calibrate_rho_target)
    from repro_torch.core.fleet import build_params, fold_packet_flags
    from repro_torch.core.sketches import true_entropy
    from repro_torch.kernels.sketch_update import fleet as FK

    wl, rep, mems, events = sc["wl"], sc["rep"], sc["mems"], sc["events"]
    c0 = time.perf_counter()
    rho = calibrate_rho_target(mems, "um", rep.epoch_stream(N_EPOCHS // 2),
                               LOG2_TE, n_levels=N_LEVELS)
    assert abs(rho - RHO["um"]) <= 0.005, (rho, RHO["um"])
    cal_s = time.perf_counter() - c0
    torch.cuda.reset_peak_memory_stats()
    system = DiSketchSystem(mems, "um", rho_target=RHO["um"],
                            log2_te=LOG2_TE, n_levels=N_LEVELS,
                            fleet_kwargs={"keep_stacked": True})
    counts, host_s, dev_ms = _replay(rep, system)
    peak = torch.cuda.max_memory_allocated()
    expected = sum(len(set(_epoch_ns(system, e).values()))
                   for e in range(N_EPOCHS))
    assert counts["fleet_ragged"] == expected > 0, (counts, expected)
    assert counts["fleet_dense"] == counts["sketch_update"] == 0, counts
    fleet = system.fleet
    L = N_LEVELS

    # B2 loop over the level rows of the epoch with the most subepochs
    e_star = max(range(N_EPOCHS),
                 key=lambda e: (max(_epoch_ns(system, e).values()), -e))
    ns = _epoch_ns(system, e_star)
    params = build_params(fleet.fragments, e_star, ns, fleet.frag_order)
    assert np.array_equal(params, fleet._params_log[e_star])
    packet = fold_packet_flags(rep.epoch_packet(e_star, fleet.frag_order),
                               LOG2_TE, n_levels=L, level_seed=LEVEL_SEED)
    rect = packet.densify(fleet.blk)
    kw = dict(n_sub_max=max(ns.values()), width_max=int(fleet.widths.max()),
              log2_te=LOG2_TE, signed=True)
    trect = _to_device(rect + (params, np.zeros(0, np.int32)), dev)[:4]
    reset_counts()
    loop = FK.fleet_update_loop(*trect, device=dev, **kw)   # <- B2 path
    torch.cuda.synchronize()
    counts_l = read_counts()
    assert counts_l["sketch_update"] == len(params) == len(
        fleet.frag_order) * L, counts_l
    loop_plain = FK.fleet_update_loop(*trect, backend="ref", device=dev,
                                      **kw)
    torch.cuda.synchronize()
    err = float((loop - loop_plain).abs().max())
    assert torch.equal(loop, loop_plain), "um B2 loop != its plain version"
    for rows, c in fleet._window_bufs[e_star][0].device():
        part = loop[torch.as_tensor(rows, device=dev), :c.shape[2],
                    :c.shape[3]]
        assert torch.equal(c[0], part), "um B1 groups != the B2 loop"
    for i, sw in enumerate(fleet.frag_order):
        rec = system.records[e_star][sw]
        assert np.array_equal(rec.counters, loop[i * L:(i + 1) * L, :rec.n,
                              :rec.counters.shape[2]].cpu().numpy()
                              .astype(np.int64)), "um record != B2 loop"
    del loop, loop_plain

    # entropy: the subepoch merge on the records and the fragment merge on
    # the device, over the first ENTROPY_EPOCHS epochs
    es = list(range(ENTROPY_EPOCHS))
    in_es = (wl.pkt_ts >> LOG2_TE) < ENTROPY_EPOCHS
    total = float(in_es.sum())
    truth = true_entropy(np.bincount(wl.pkt_flow[in_es],
                                     minlength=len(wl.keys)))
    q0 = time.perf_counter()
    ent_sub = system.query_entropy(wl.keys, wl.paths, es, total,
                                   n_levels=L, level_seed=LEVEL_SEED)
    q_sub = time.perf_counter() - q0
    _pinned("um per-epoch entropy (subepoch merge)", ent_sub,
            ENTROPY_PIN["disketch subepoch"], PIN_RTOL)
    assert fleet.has_device_window(es)
    q1 = time.perf_counter()
    ent_frag = system.query_entropy(wl.keys, wl.paths, es, total,
                                    n_levels=L, level_seed=LEVEL_SEED,
                                    merge="fragment", k_heavy=len(wl.keys))
    q_frag = time.perf_counter() - q1
    _pinned("um per-epoch entropy (fragment merge on the device, k_heavy = "
            "every key)", ent_frag, ENTROPY_PIN["disketch fragment"],
            PIN_RTOL_F32)
    disco = DiscoSystem(mems, "um", rho_target=RHO["um"], log2_te=LOG2_TE,
                        n_levels=L)
    counts_o, host_o, _ = _replay(rep, disco)
    assert counts_o["fleet_ragged"] == N_EPOCHS, counts_o
    q2 = time.perf_counter()
    ent_disco = disco.query_entropy(wl.keys, wl.paths, es, total,
                                    n_levels=L, level_seed=LEVEL_SEED)
    q_disco = time.perf_counter() - q2
    _pinned("um DISCO entropy (subepoch merge)", ent_disco,
            ENTROPY_PIN["disco subepoch"], PIN_RTOL)
    _log(f"univmon per-epoch: calibrate_rho_target = {rho!r} in "
         f"{cal_s:.2f} s; launches {counts} (expected {expected}); update "
         f"{dev_ms / N_EPOCHS:.3f} ms/epoch on the device timeline, host "
         f"{host_s:.2f} s; peak device memory {peak} B; n after each epoch "
         f"{_n_trajectory(system.n_log)}")
    _log(f"univmon per-epoch B2 loop on epoch {e_star} ({len(params)} level "
         f"rows, rectangle {rect[0].shape}): launches {counts_l}; == its "
         f"plain version, == the replay's B1 groups, == the records")
    _log(f"univmon per-epoch entropy of {len(wl.keys)} flows over epochs "
         f"0-{ENTROPY_EPOCHS - 1} (true {truth!r}): subepoch merge "
         f"{ent_sub!r} in {q_sub:.2f} s; fragment merge on the device "
         f"(k_heavy = every key) {ent_frag!r} in {q_frag:.2f} s; DISCO "
         f"{ent_disco!r} in {q_disco:.2f} s (replay {host_o:.2f} s, "
         f"launches {counts_o}); all three the reference's (pinned)")
    del system, disco, fleet
    torch.cuda.empty_cache()
    return dict(ragged=counts["fleet_ragged"] + counts_o["fleet_ragged"],
                loop=counts_l["sketch_update"], max_abs_err=err)


def aggregated_phase(dev, sc):
    """The aggregated baselines (``AggregatedSystem``: a depth-4 sketch on
    each core switch, int64 counters on the card) for cs, cms and um,
    replayed epoch by epoch and queried for the 5-hop flows at their core
    switch, as the comparison the disaggregated systems are held to."""
    import torch

    from repro_torch.core.disketch import AggregatedSystem
    from repro_torch.net.simulator import rmse
    from repro_torch.net.topology import FatTree, core_on_path

    wl, rep, mems = sc["wl"], sc["rep"], sc["mems"]
    topo = FatTree(4)
    sel = wl.path_len == 5
    core = core_on_path(wl.path_mat[sel], topo.core_ids)
    epochs = list(range(N_EPOCHS))
    for kind in ("cs", "cms", "um"):
        agg = AggregatedSystem({sw: mems[sw] for sw in topo.core_ids}, kind,
                               depth=4, n_levels=N_LEVELS, device=dev)
        h0 = time.perf_counter()
        rep.run(agg)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - h0
        assert all(c.is_cuda for cs in agg.counters.values()
                   for c in cs.values())
        q0 = time.perf_counter()
        est = agg.query_flows(sc["keys"], core, epochs)
        q_s = time.perf_counter() - q0
        err = rmse(est, sc["truth"])
        _pinned(f"aggregated {kind} RMSE", err, AGG_RMSE_PIN[kind], PIN_RTOL)
        _log(f"aggregated {kind}: depth 4 on {len(topo.core_ids)} core "
             f"switches, replay {run_s:.2f} s, query of {len(core)} 5-hop "
             f"flows {q_s:.2f} s, RMSE {err!r} (the reference's, pinned)")


def _b2_rows(params, signed):
    """``ops._launch`` keywords of the B2 loop's launches, one per row of
    an epoch's parameter table."""
    from repro_torch.kernels.sketch_update import fleet as FK

    return [dict(width=int(p[FK.PARAM_WIDTH]), n_sub=int(p[FK.PARAM_N_SUB]),
                 log2_te=LOG2_TE, col_seed=int(p[FK.PARAM_COL_SEED]),
                 sign_seed=int(p[FK.PARAM_SIGN_SEED]),
                 sub_seed=int(p[FK.PARAM_SUB_SEED]), signed=signed,
                 level=0, mitigation=False) for p in params]


def _b2_loop(t, launch):
    """The B2 loop on a sampled epoch (``t``, an ``epoch_path`` timing
    entry): one ``launch`` (``ops._launch`` or the plain version) per
    parameter row."""
    keys, vals, ts, _ = t["trect"]
    rows = _b2_rows(t["params"], t["kw"]["signed"])

    def run():
        for r, a in enumerate(rows):
            launch(keys[r], vals[r], ts[r], **a)
    return run


def epoch_kernel_timing(res, dev):
    """Times of B2 (the loop, one launch per row) and B3 at the shapes of
    the sampled cs epoch, with their plain versions and bounds.  B2's loop
    is timed eagerly (``ms``), under torch.profiler (its kernels' own
    device time) and from a CUDA graph (``device_ms``; also on the sampled
    cms epoch)."""
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.kernels.sketch_update import ops
    from repro_torch.kernels.sketch_update.ref import sketch_update_ref

    t = res["timing"]["cs"]
    keys, vals, ts, params = t["trect"]
    kw = t["kw"]
    n_frags, p_max = keys.shape
    out = {"fleet_ragged": kernel_timing(t["ragged"], dev)}
    # B3: one launch over the rectangle
    ms = _time_ms(lambda: FK._launch_dense(keys, vals, ts, params, **kw))
    device_ms = _graph_ms(lambda: FK._launch_dense(keys, vals, ts, params,
                                                   **kw))
    plain_ms = _time_ms(lambda: FK.fleet_update_ref(keys, vals, ts, params,
                                                    **kw), reps=3, warmup=1)
    out_bytes = n_frags * kw["n_sub_max"] * kw["width_max"] * 4
    in_bytes = _packet_bytes(n_frags * p_max, t["live"]) + params.numel() * 4
    bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_s = OPS_PER_PAIR * t["live"] / OPS_PER_S
    out["fleet_dense"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="bytes" if bytes_s >= ops_s else "operations")
    # B2: one launch per parameter row, as the loop makes them
    rows = _b2_rows(t["params"], kw["signed"])
    grid = ops.single_geometry(p_max)
    loop_kernel = _b2_loop(t, ops._launch)
    ms = _time_ms(loop_kernel, reps=5, warmup=1)
    wall_ms, kern_ms, n_k = _profiled(loop_kernel, "sketch_update_kernel")
    _log(f"timing  sketch_update loop: {len(rows)} launches of {grid} CTAs "
         f"({len(rows) * grid} in all); loop {ms:.3f} ms (CUDA events); "
         f"under torch.profiler the loop's wall {wall_ms:.3f} ms, its {n_k} "
         f"kernels {kern_ms:.3f} ms on the device "
         f"({1e3 * kern_ms / max(n_k, 1):.2f} us each)")
    for kind in ("cs", "cms"):
        graph = [_graph_ms(_b2_loop(res["timing"][kind], ops._launch))
                 for _ in range(2)]
        _log(f"timing  sketch_update {kind} epoch "
             f"{res['timing'][kind]['epoch']} loop of "
             f"{len(res['timing'][kind]['params'])} launches, device (zero "
             f"fills + kernels, CUDA graph, two timings): {graph[0]:.4f}, "
             f"{graph[1]:.4f} ms")
        if kind == "cs":
            device_ms = graph[0]
    loop_plain = _b2_loop(t, sketch_update_ref)
    plain_ms = _time_ms(loop_plain, reps=2, warmup=1)
    live_rows = (vals != 0).sum(dim=1).tolist()
    bytes_s = sum(_packet_bytes(p_max, n) + a["n_sub"] * a["width"] * 4
                  for a, n in zip(rows, live_rows)) / HBM_BYTES_PER_S
    out["sketch_update"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="bytes" if bytes_s >= ops_s else "operations")
    for name, v in out.items():
        shape = (f"{v['groups']} grouped launches" if name == "fleet_ragged"
                 else f"{n_frags}x{p_max} rectangle, n_sub_max "
                      f"{kw['n_sub_max']}")
        _timing_line(f"{name} cs epoch {t['epoch']} ({shape})", v)
    return out


def profile_replay(mems, rep, window=WINDOW, kind="cs"):
    """One more replay (same inputs as the path it repeats) under
    torch.profiler: the device's busy share of the replay's wall time, the
    kernels that fill it, and the torch ops that take host time.  What the
    profiler does not see (numpy packing, Python) is the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.disketch import DiSketchSystem

    system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE, n_levels=N_LEVELS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        rep.run(system, window=window)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - h0
    events = prof.key_averages()
    # Device activity (kernels, copies) is counted from the device's own
    # events: a host op's device time repeats what its kernels took, and
    # the profiler's activity-buffer bookkeeping is not the program's.
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("Activity Buffer")]
    on_host = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    top_dev = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:5]
    top_cpu = sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:5]
    torch_cpu_ms = sum(e.self_cpu_time_total for e in on_host) / 1e3
    what = (f"{-(-N_EPOCHS // window)} windows of {window}" if window > 1
            else f"{N_EPOCHS} epochs, per-epoch control")
    _log(f"profile {kind} replay, {what}: wall "
         f"{wall_s * 1e3:.1f} ms, device busy {device_ms:.3f} ms "
         f"({100 * device_ms / (wall_s * 1e3):.2f}% of wall), torch ops on "
         f"the host {torch_cpu_ms:.1f} ms, the rest numpy/Python")
    update = [e for e in on_dev if "fleet_ragged_kernel" in e.key
              or "fleet_dense_kernel" in e.key]
    update_ms = sum(e.self_device_time_total for e in update) / 1e3
    _log(f"profile   update kernels {update_ms:.3f} ms on the device in "
         f"{sum(e.count for e in update)} launches "
         f"({100 * update_ms / (wall_s * 1e3):.3f}% of wall)")
    for e in top_dev:
        _log(f"profile   device {e.self_device_time_total / 1e3:9.3f} ms "
             f"x{e.count:<5d} {e.key[:90]}")
    for e in top_cpu:
        _log(f"profile   host   {e.self_cpu_time_total / 1e3:9.3f} ms "
             f"x{e.count:<5d} {e.key[:90]}")


def kernel_timing(groups, dev):
    """Times of B1's grouped launches (a window's or an epoch's) at the main
    path's shapes, inputs already validated and on the card: ``ms``, CUDA
    events over back-to-back calls of each launch path (its zero fill,
    ctypes call and kernel, host included), summed over the launches;
    ``device_ms``, the device time of all their zero fills and kernels
    (``_graph_ms``); the plain version's time; the bound for the same work;
    and how hard the heaviest counters contend (``_heaviest_counters``)."""
    from repro_torch.kernels.sketch_update import fleet as FK

    launches = [(_to_device(args, dev), kw) for args, kw in groups]

    def run():
        for targs, kw in launches:
            FK._launch(*targs, **kw)

    ms = sum(_time_ms(lambda: FK._launch(*targs, **kw))
             for targs, kw in launches)
    device_ms = _graph_ms(run)
    plain_ms = bound_bytes_s = bound_ops_s = 0.0
    for (args, kw), (targs, _) in zip(groups, launches):
        plain_ms += _time_ms(lambda: FK.fleet_update_ragged_ref(*targs, **kw),
                             reps=3, warmup=1)
        keys, vals, _, params, bf = args
        live = int((vals != 0).sum())
        out_bytes = params.shape[0] * kw["n_sub_max"] * kw["width_max"] * 4
        in_bytes = _packet_bytes(len(keys), live) + params.nbytes + bf.nbytes
        bound_bytes_s += (in_bytes + out_bytes) / HBM_BYTES_PER_S
        pairs = _passing_pairs(vals, args[2], kw["n_levels"])
        bound_ops_s += OPS_PER_PAIR * pairs / OPS_PER_S
    bound_by = "bytes" if bound_bytes_s >= bound_ops_s else "operations"
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=1e3 * max(bound_bytes_s, bound_ops_s),
                bound_by=bound_by, groups=len(groups),
                contention=_heaviest_counters(launches))


def _passing_pairs(vals, ts, n_levels):
    """The (packet, level row) pairs that pass B1's level test: a live
    packet once for cs and cms, and for UnivMon once per level up to its
    own (its level id rides the ts bits from LVL_SHIFT)."""
    from repro_torch.kernels.sketch_update.kernel import (LVL_FIELD_MASK,
                                                          LVL_SHIFT)

    live = vals != 0
    if n_levels == 1:
        return int(live.sum())
    lvl = (ts[live] >> LVL_SHIFT) & LVL_FIELD_MASK
    return int((lvl.astype(np.int64) + 1).sum())


def _heaviest_counters(launches):
    """How many of the trace's adds land on one counter, the same-address
    atomics that serialise in L2: every row's monitored packets counted per
    counter (the plain version with every live value 1, unsigned).  Returns
    the most hits on one counter and the heaviest counter's share of its
    row's monitored packets (largest and median over the rows that have
    any)."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    most, shares = 0, []
    for (keys, vals, ts, params, bf), kw in launches:
        hits = FK.fleet_update_ragged_ref(
            keys, (vals != 0).float(), ts, params, bf,
            **dict(kw, signed=False)).flatten(1)
        top, total = hits.max(dim=1).values, hits.sum(dim=1)
        some = total > 0
        most = max(most, int(top.max()))
        shares += (top[some] / total[some]).tolist()
        del hits
    torch.cuda.synchronize()
    return dict(most_hits=most, share_max=max(shares),
                share_median=float(np.median(shares)))


def _timing_line(what, v):
    """One kernel's timing line of the log."""
    c = v.get("contention")
    hot = (f"; heaviest counter {c['most_hits']} hits, "
           f"{100 * c['share_max']:.2f}% of its row's monitored packets "
           f"(median over rows {100 * c['share_median']:.2f}%)" if c else "")
    device = (f", device {v['device_ms']:.4f} ms (zero fill + kernel, CUDA "
              f"graph)" if v.get("device_ms") is not None else "")
    _log(f"timing  {what}: eager {v['ms']:.4f} ms (CUDA events, host "
         f"included){device}, plain version {v['plain_ms']:.3f} ms, bound "
         f"{v['bound_ms']:.4f} ms ({v['bound_by']}){hot}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    try:
        t0 = time.perf_counter()
        smi = _nvidia_smi()
        _log(f"gpu     {smi}")
        dev = torch.device("cuda")
        b0 = time.perf_counter()
        built = build.build_all()
        _log(f"build   {len(built)} librar{'y' if len(built) == 1 else 'ies'}"
             f" in {time.perf_counter() - b0:.1f} s (parallel nvcc, sm_90a)")
        for name, info in built.items():
            _log(f"build   {name}: {info['seconds']:.1f} s")
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    _log(f"ptxas   {line.strip()}")
        worst = {"fleet_ragged": _phase(kernel_phase, dev),
                 "sketch_update": _phase(kernel_phase_single, dev),
                 "fleet_dense": _phase(kernel_phase_dense, dev)}
        sc = _phase(build_scenario)
        res = _phase(main_path, dev, sc)
        timing = res["timing"]
        _timing_line(f"fleet_ragged one cs window ({timing['groups']} "
                     f"launches)", timing)
        ep = _phase(epoch_path, dev, sc)
        ep_timing = _phase(epoch_kernel_timing, ep, dev)
        um_w = _phase(univmon_window, dev, sc)
        um_e = _phase(univmon_epoch, dev, sc)
        _phase(aggregated_phase, dev, sc)
        src = "src/repro_torch/kernels/sketch_update/csrc/"
        ref = "src/repro/kernels/sketch_update/"
        entries = [
            ("fleet_ragged", "fleet.py:297",
             res["launches"] + ep["ragged"] + um_w["launches"] + um_e["ragged"],
             max(worst["fleet_ragged"], res["max_abs_err"],
                 um_w["max_abs_err"]), timing),
            ("sketch_update", "kernel.py:419", ep["loop"] + um_e["loop"],
             max(worst["sketch_update"], ep["max_abs_err"],
                 um_e["max_abs_err"]), ep_timing["sketch_update"]),
            ("fleet_dense", "fleet.py:160", ep["dense"],
             max(worst["fleet_dense"], ep["max_abs_err"]),
             ep_timing["fleet_dense"]),
        ]
        line = {"kernels": [{
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": ref + replaces, "launches": launches,
            "max_abs_err": err, "ms": t["ms"],
            "device_ms": t.get("device_ms"), "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        } for name, replaces, launches, err, t in entries]}
        _log(json.dumps(line))
        _log(f"gpu     {smi}")
        _log(f"done    in {time.perf_counter() - t0:.1f} s")
    except Exception:                  # any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
