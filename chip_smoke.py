#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, then
drives the fleet window path through the user entry points at the
paper's §6.1 full-scale setting (``DiSketchSystem(backend="fleet")`` +
``Replayer.run(system, window=8)`` + ``query_flows(merge="fragment")``)
and checks that it went through the kernels, kept every window stack on
the device, and answered correctly.

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
# once on a CPU at exactly this setting.
RHO = {"cs": 15.67, "cms": 1.0}
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


def kernel_phase(dev) -> float:
    """The update kernel against its plain version on the card: skewed and
    empty rows, widths up to 262144, n_sub 1..64, UnivMon with 16 levels,
    §4.4 mitigation.  Returns the largest absolute difference (0 when
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
    return worst


def _window_groups(fleet, rep, e0):
    """The grouped launches of window ``e0`` exactly as the fleet runner
    makes them: ``[(args, kw)]`` per distinct n_sub."""
    from repro_torch.core.fleet import fold_packet_flags, pack_csr
    from repro_torch.kernels.sketch_update import fleet as FK

    es = [e for e in range(e0, e0 + WINDOW) if e in fleet._params_log]
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
    ``e0``, and a host copy of just its rows: ``(path, (E, len, S, W)
    array, row indices)``."""
    groups = fleet._window_bufs[e0][0].device()
    where = {int(r): (c, j) for rows, c in groups for j, r in enumerate(rows)}
    pos = {sw: i for i, sw in enumerate(fleet.frag_order)}

    def span(path):
        cs = [where[pos[sw]][0] for sw in path]
        return max(c.shape[2] for c in cs) * max(c.shape[3] for c in cs)

    path = min(sorted(set(paths)), key=span)
    rows = np.array([pos[sw] for sw in path])
    parts = [where[r][0][:, where[r][1]] for r in rows]
    dense = np.zeros((parts[0].shape[0], len(rows),
                      max(p.shape[1] for p in parts),
                      max(p.shape[2] for p in parts)), np.float32)
    for i, p in enumerate(parts):
        dense[:, i, :p.shape[1], :p.shape[2]] = p.cpu().numpy()
    return path, dense, rows


def main_path(dev):
    """The fleet window path at the §6.1 setting, cs then cms.  Returns a
    dict of what the kernel line needs."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.core.query import fleet_query_window
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import Replayer, rmse
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
    keys, truth = wl.keys[sel], wl.sizes[sel]
    paths = [p for p, s in zip(wl.paths, sel) if s]
    epochs = list(range(N_EPOCHS))
    n_windows = -(-N_EPOCHS // WINDOW)
    result = {"launches": 0, "max_abs_err": 0.0}
    for kind in ("cs", "cms"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                                log2_te=LOG2_TE, backend="fleet")
        fleet = system.fleet
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        FK.fleet_update_ragged.launches = 0
        h0 = time.perf_counter()
        start.record()
        rep.run(system, window=WINDOW)          # <- the main path
        end.record()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - h0
        launches = FK.fleet_update_ragged.launches
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
        for (args, kw), (_, got) in zip(groups, buf.device()):
            plain = FK.fleet_update_ragged_ref(*_to_device(args, dev), **kw)
            got = got.reshape(plain.shape)
            err = max(err, float((got - plain).abs().max()))
            assert torch.equal(got, plain), f"{kind}: window stack != plain"
            del plain
        result["max_abs_err"] = max(result["max_abs_err"], err)

        # queries: all 5-hop flows over the 32 epochs, on the device
        q0 = time.perf_counter()
        est = system.query_flows(keys, paths, epochs, merge="fragment")
        torch.cuda.synchronize()
        q_s = time.perf_counter() - q0
        assert est.shape == keys.shape and np.isfinite(est).all()
        err_rmse = rmse(est, truth)
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
             f"{err_rmse:.4f}; device == host oracle in every window; "
             f"window stacks never copied to the host")
        if kind == "cs":
            result["timing"] = kernel_timing(system, rep, dev)
        del system, fleet, bufs, buf
    profile_replay(mems, rep)
    return result


def profile_replay(mems, rep):
    """One more cs replay (same inputs as the main path) under
    torch.profiler: the device's busy share of the replay's wall time, the
    kernels that fill it, and the torch ops that take host time.  What the
    profiler does not see (numpy packing, Python) is the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.disketch import DiSketchSystem

    system = DiSketchSystem(mems, "cs", rho_target=RHO["cs"],
                            log2_te=LOG2_TE, backend="fleet")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        rep.run(system, window=WINDOW)
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
    _log(f"profile cs replay, {-(-N_EPOCHS // WINDOW)} windows: wall "
         f"{wall_s * 1e3:.1f} ms, device busy {device_ms:.3f} ms "
         f"({100 * device_ms / (wall_s * 1e3):.2f}% of wall), torch ops on "
         f"the host {torch_cpu_ms:.1f} ms, the rest numpy/Python")
    for e in top_dev:
        _log(f"profile   device {e.self_device_time_total / 1e3:9.3f} ms "
             f"x{e.count:<5d} {e.key[:90]}")
    for e in top_cpu:
        _log(f"profile   host   {e.self_cpu_time_total / 1e3:9.3f} ms "
             f"x{e.count:<5d} {e.key[:90]}")


def kernel_timing(system, rep, dev):
    """Times of one window's grouped launches at the main path's shapes:
    the kernel (its launch path, inputs already validated and on the
    card), its plain version, and the bound for the same work."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    groups = _window_groups(system.fleet, rep, WINDOW)
    ms = plain_ms = bound_bytes_s = bound_ops_s = 0.0
    for args, kw in groups:
        targs = _to_device(args, dev)
        ms += _time_ms(lambda: FK._launch(*targs, **kw))
        plain_ms += _time_ms(lambda: FK.fleet_update_ragged_ref(*targs, **kw),
                             reps=3, warmup=1)
        keys, vals, _, params, bf = args
        out_bytes = params.shape[0] * kw["n_sub_max"] * kw["width_max"] * 4
        in_bytes = 12 * len(keys) + params.nbytes + bf.nbytes
        bound_bytes_s += (in_bytes + out_bytes) / HBM_BYTES_PER_S
        pairs = int((vals != 0).sum()) * kw["n_levels"]
        bound_ops_s += OPS_PER_PAIR * pairs / OPS_PER_S
    bound_by = "bytes" if bound_bytes_s >= bound_ops_s else "operations"
    return dict(ms=ms, plain_ms=plain_ms,
                bound_ms=1e3 * max(bound_bytes_s, bound_ops_s),
                bound_by=bound_by, groups=len(groups))


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
        from repro_torch.kernels.sketch_update import fleet as FK
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
        worst = kernel_phase(dev)
        res = main_path(dev)
        timing = res["timing"]
        _log(f"timing  fleet_ragged one cs window ({timing['groups']} "
             f"launches): kernel {timing['ms']:.3f} ms, plain version "
             f"{timing['plain_ms']:.3f} ms, bound {timing['bound_ms']:.3f} ms "
             f"({timing['bound_by']})")
        line = {"kernels": [{
            "name": "fleet_ragged",
            "route": "cuda",
            "source": "src/repro_torch/kernels/sketch_update/csrc/"
                      "fleet_ragged.cu",
            "replaces": "src/repro/kernels/sketch_update/fleet.py:297",
            "launches": res["launches"],
            "max_abs_err": max(worst, res["max_abs_err"]),
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,
        }]}
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
