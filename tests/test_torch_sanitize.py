"""The port's runtime sanitizers (``repro_torch.sanitize``), armed with
``REPRO_SANITIZE=1``: the counterpart of ``tests/test_sanitizers.py``.

Two invariants, each with a positive control that shows the sanitizer can
fire:

  * device residency — ``transfer_guard()`` wraps the query plane's device
    compute; armed, every op that would make the host wait for a card
    raises (on the CPU through the guard's dispatch mode; on a card also
    through the CUDA sync debug mode, which ``chip_smoke.py``'s
    ``sanitize`` phase holds).  A churned heterogeneous fleet's window,
    path-grouped and UnivMon queries run clean under it, bit-equal to the
    disarmed run and to the reference's jnp engine on the same window;
  * load stability — ``kernels.build.load`` notes one ``build.<name>``
    count per cache miss, and a steady-state replay with its queries
    loads nothing.

The reference's engine runs in a child interpreter: importing it here
would trip a jax DeprecationWarning that jax then caches (see
``tests/test_torch_slice.py``).
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import sanitize as RS
from repro_torch import sanitize
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.core.query import um_fleet_query_window_device
from repro_torch.kernels import build
from repro_torch.kernels import sketch_query as SQ
from repro_torch.kernels.sketch_update import kernel as KK
from repro_torch.launch.mesh import make_switch_mesh
from repro_torch.net.simulator import FailureSchedule, Replayer
from repro_torch.net.traffic import cov_list, linear_path_workload
from torch_threads import one_thread  # noqa: F401

N_HOPS = 5
N_LEVELS = 4
SRC = Path(__file__).resolve().parents[1] / "src"


def _workload(seed=1, n_epochs=4):
    rng = np.random.RandomState(seed)
    widths = np.maximum(cov_list(N_HOPS, 1280, 1.2, rng).astype(int), 4)
    mems = {h: int(w) * 4 for h, w in enumerate(widths)}
    loads = np.maximum(cov_list(N_HOPS, 30_000, 0.9, rng).astype(int), 16)
    wl = linear_path_workload(N_HOPS, eval_flows=100, eval_packets=800,
                              bg_packets_per_hop=loads, n_epochs=n_epochs,
                              seed=seed)
    return wl, mems


def _system(wl, mems, kind, shards=1):
    kw = dict(mesh=make_switch_mesh(shards, devices=["cpu"] * shards)) \
        if shards > 1 else dict(device="cpu")
    if kind == "um":
        kw.update(n_levels=N_LEVELS, mems={h: m * N_LEVELS
                                           for h, m in mems.items()})
    return DiSketchSystem(kw.pop("mems", mems), kind, rho_target=4.0,
                          log2_te=wl.log2_te, mitigation=kind == "cs",
                          **kw)


# -- arming -----------------------------------------------------------------

@pytest.mark.parametrize("value", ["", "0", " 0 ", "1", "yes", None])
def test_enabled_parses_as_the_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(sanitize._ENV, raising=False)
    else:
        monkeypatch.setenv(sanitize._ENV, value)
    assert sanitize._ENV == RS._ENV
    assert sanitize.enabled() == RS.enabled()
    assert sanitize.enabled() == (value in ("1", "yes"))


def test_disarmed_is_a_null_context(monkeypatch):
    monkeypatch.delenv(sanitize._ENV, raising=False)
    assert not sanitize.enabled()
    x = torch.arange(16.0)
    with sanitize.transfer_guard():      # nothing enforced
        assert x[x > 3].sum().item() == sum(range(4, 16))
        assert float(x[5]) == 5.0


@pytest.mark.parametrize("leak", ["item", "float", "bool", "mask",
                                  "mask_write", "nonzero", "masked_select",
                                  "unique"])
def test_armed_guard_catches_host_syncs(monkeypatch, leak):
    """Positive controls: each op that would make the host wait for a
    card raises inside the armed guard, on the CPU too; the explicit exit
    after the guard is legal."""
    monkeypatch.setenv(sanitize._ENV, "1")
    x = torch.arange(16.0)
    ops = {"item": lambda: x.sum().item(), "float": lambda: float(x[3]),
           "bool": lambda: bool(x[1] > 0), "mask": lambda: x[x > 3],
           "mask_write": lambda: x.clone().__setitem__(x > 3, 0.0),
           "nonzero": lambda: torch.nonzero(x),
           "masked_select": lambda: x.masked_select(x > 2),
           "unique": lambda: torch.unique(x)}
    with pytest.raises(sanitize.HostSyncError):
        with sanitize.transfer_guard():
            ops[leak]()
    # device compute is allowed; the copy out after the guard is the exit
    with sanitize.transfer_guard():
        y = torch.where(x > 3, x * 2, float("inf")).sort().values[:4]
    assert y.cpu().numpy().tolist() == [8.0, 10.0, 12.0, 14.0]


def test_guard_nests_and_restores_the_sync_debug_mode(monkeypatch):
    """The CUDA half of the guard, with the card's sync debug mode faked:
    armed, the mode is "error" (2); every exit, an exception's too, puts
    back the mode found on entry, and guards nest."""
    monkeypatch.setenv(sanitize._ENV, "1")
    mode = [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])

    def set_mode(m):
        mode[0] = {"default": 0, "warn": 1, "error": 2}.get(m, m)

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    x = torch.ones(3)
    with sanitize.transfer_guard():
        assert mode[0] == 2
        with sanitize.transfer_guard():
            assert mode[0] == 2
        assert mode[0] == 2
        with pytest.raises(sanitize.HostSyncError):
            x.sum().item()
    assert mode[0] == 1
    with pytest.raises(ValueError):
        with sanitize.transfer_guard():
            raise ValueError("inside the guard")
    assert mode[0] == 1
    assert x.sum().item() == 3.0             # the dispatch mode is gone
    # a card whose mode cannot be set: the armed guard raises, no fallback
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: None)
    with pytest.raises(RuntimeError, match="sync debug mode"):
        with sanitize.transfer_guard():
            pass


# -- the query plane under the armed guard ------------------------------------

_REF_ENGINE = """
import sys, warnings
import numpy as np
# jax 0.9 deprecates the jax.experimental.shard_map import the engine
# makes; this interpreter only runs the engine, so the warning is moot.
warnings.filterwarnings("ignore", category=DeprecationWarning)
import jax.numpy as jnp
from repro.core.query import um_fleet_query_window_device
from repro.kernels.sketch_query.engine import (fleet_window_query_device,
                                               um_gsum_device)


def g_entropy(x):
    return x * jnp.log2(jnp.maximum(x, 1.0))


for line in sys.stdin:
    op, src, dst = line.split()
    d = np.load(src)
    if op == "fleet":
        out = fleet_window_query_device(
            d["stack"], list(d["params"]), d["keys"], str(d["kind"]),
            frag_sel=d["sel"], single_hop=bool(d["single_hop"]))
    elif op == "um":
        out = um_fleet_query_window_device(
            d["stack"], list(d["params"]), d["keys"], int(d["n_levels"]),
            frag_sel=d["sel"])
    else:
        out = np.float64(um_gsum_device(d["ests"], d["lvl"], g_entropy,
                                        k_heavy=int(d["k_heavy"])))
    np.save(dst, out)
    print("done", flush=True)
"""


@pytest.fixture(scope="module")
def reference_engine(tmp_path_factory):
    """The reference's ``fleet_window_query_device`` (op ``"fleet"``),
    ``core.query.um_fleet_query_window_device`` (op ``"um"``) and
    ``um_gsum_device`` (op ``"gsum"``) in one child interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    tmp = tmp_path_factory.mktemp("ref_sanitize_engine")
    calls = [0]

    def run(op, **arrays):
        calls[0] += 1
        src, dst = tmp / f"in{calls[0]}.npz", tmp / f"out{calls[0]}.npy"
        np.savez(src, **arrays)
        child.stdin.write(f"{op} {src} {dst}\n")
        child.stdin.flush()
        assert child.stdout.readline().strip() == "done", \
            "the reference engine's interpreter failed"
        return np.load(dst)

    with subprocess.Popen([sys.executable, "-c", _REF_ENGINE], env=env,
                          stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                          text=True) as child:
        yield run
        child.stdin.close()
        assert child.wait(timeout=60) == 0


def _dense(groups):
    """A window's row groups as one zero-padded ``(E, R, S, W)`` array."""
    groups = [(np.asarray(r), c.cpu().numpy()) for r, c in groups]
    e = groups[0][1].shape[0]
    n_rows = sum(len(r) for r, _ in groups)
    s = max(c.shape[2] for _, c in groups)
    w = max(c.shape[3] for _, c in groups)
    out = np.zeros((e, n_rows, s, w), np.float32)
    for rows, c in groups:
        out[:, rows, :c.shape[2], :c.shape[3]] = c
    return out


class _Recorder:
    """Wraps one of ``kernels.sketch_query``'s entry points (the name the
    fleet and the system import at call time): every call's arguments,
    whether the guard was armed, and its result."""

    def __init__(self, monkeypatch, name):
        self.fn, self.calls = getattr(SQ, name), []
        monkeypatch.setattr(SQ, name, self)

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append((args, kw, sanitize.enabled(), out))
        return out


def _queries(system, wl):
    """The query plane of one replayed system: window, path-restricted
    point and per-path (``key_group``) queries; UnivMon's per-level
    estimates and entropy with the device G-sum."""
    keys, epochs = wl.keys[:65], list(range(wl.n_epochs))
    # every path but the single hop of a switch that goes down: it is
    # blind once it is down
    paths = wl.paths
    live = [i for i, p in enumerate(paths) if p not in ((0,), (3,))]
    keys_l, paths_l = wl.keys[live], [paths[i] for i in live]
    if system.kind == "um":
        fleet = system.fleet
        return [fleet.um_level_window_query(epochs, keys),
                fleet.um_level_window_query(epochs, keys, path=(1, 2)),
                np.float64(system.query_entropy(
                    keys_l, paths_l, epochs, float(len(wl.pkt_ts)),
                    n_levels=N_LEVELS, level_seed=fleet.level_seed,
                    merge="fragment"))]
    return [system.fleet.window_query(epochs, keys),
            system.fleet.point_query(0, keys, path=(2,)),
            system.query_flows(keys_l, paths_l, epochs, merge="fragment")]


def _check_against_reference(reference_engine, recorders):
    """Every armed engine call against the reference's engine on the same
    window: bit-equal estimates (per key group for ``key_group`` calls;
    the reference has no such argument, so each group is its own call over
    the epochs it selects), the G-sum within the f32 rounding of two
    ``log2``s (``tests/test_torch_univmon.py``'s 1e-6)."""
    n = 0
    for args, kw, armed, out in recorders["fleet_window_query_device"].calls:
        if not armed:
            continue
        groups, params, keys, kind = args
        stack, params = _dense(groups), np.stack(params)
        sel = kw.get("frag_sel")
        kg = kw.get("key_group")
        jobs = ([(np.arange(len(keys)), sel, np.arange(len(params)))]
                if kg is None else
                [(np.flatnonzero(kg == g), sel[g],
                  np.flatnonzero(sel[g].any(axis=1))) for g in np.unique(kg)])
        for idx, s, es in jobs:
            s = np.ones(stack.shape[1], bool) if s is None else s
            s = s[es] if s.ndim == 2 else s
            if not len(es):
                assert not out[idx].any()
                continue
            want = reference_engine(
                "fleet", stack=stack[es], params=params[es], keys=keys[idx],
                kind=kind, sel=s, single_hop=kw.get("single_hop", False))
            np.testing.assert_array_equal(out[idx], want)
        n += 1
    for args, kw, armed, out in recorders["um_window_query_device"].calls:
        if armed:
            groups, params, keys, n_levels = args
            sel = kw.get("frag_sel")
            sel = np.ones(len(params[0]) // n_levels, bool) \
                if sel is None else sel
            want = reference_engine("um", stack=_dense(groups),
                                    params=np.stack(params), keys=keys,
                                    n_levels=n_levels, sel=sel)
            np.testing.assert_array_equal(out, want)
            n += 1
    for args, kw, armed, out in recorders["um_gsum_device"].calls:
        if armed:
            ests, lvl = args[:2]
            want = reference_engine("gsum", ests=ests, lvl=lvl,
                                    k_heavy=kw.get("k_heavy", 1024))
            assert out == pytest.approx(float(want), rel=1e-6)
            n += 1
    return n


@pytest.mark.parametrize("kind,shards", [("cs", 1), ("cms", 1), ("um", 1),
                                         ("cs", 2), ("um", 2)])
def test_query_plane_clean_under_armed_guard(monkeypatch, reference_engine,
                                             kind, shards):
    """The device query plane of a churned heterogeneous fleet (switch 3
    down from epoch 2, window 4; cs with §4.4 mitigation) runs under the
    armed guard without tripping it, on one CPU device and on a 2-shard
    CPU mesh, and gives the disarmed run's answers bit for bit and the
    reference engine's on the same windows."""
    wl, mems = _workload()
    system = _system(wl, mems, kind, shards)
    Replayer(wl, N_HOPS).run(system, window=4,
                             failures=FailureSchedule(N_HOPS,
                                                      downs={3: (2, None)}))
    assert system.fleet.has_device_window(range(wl.n_epochs))
    recorders = {name: _Recorder(monkeypatch, name) for name in (
        "fleet_window_query_device", "um_window_query_device",
        "um_gsum_device")}
    monkeypatch.setenv(sanitize._ENV, "1")
    armed = _queries(system, wl)
    monkeypatch.setenv(sanitize._ENV, "0")
    disarmed = _queries(system, wl)
    for a, b in zip(armed, disarmed):
        np.testing.assert_array_equal(a, b)
        assert np.isfinite(a).all()
    calls = sum(len(r.calls) for r in recorders.values())
    assert calls and all(len(r.calls) % 2 == 0 for r in recorders.values())
    if kind != "um":
        assert any(kw.get("key_group") is not None for _, kw, _, _ in
                   recorders["fleet_window_query_device"].calls)
    assert _check_against_reference(reference_engine, recorders) \
        == calls // 2
    if shards > 1:
        twin = _system(wl, mems, kind)
        Replayer(wl, N_HOPS).run(twin, window=4, failures=FailureSchedule(
            N_HOPS, downs={3: (2, None)}))
        for a, b in zip(armed, _queries(twin, wl)):
            np.testing.assert_array_equal(a, b)


def test_um_fleet_query_window_device_matches_reference(reference_engine):
    """G2: the thin re-export equals the reference's
    ``core.query.um_fleet_query_window_device`` on a UnivMon window (its
    row groups here, the padded stack there), with and without an
    (E, F) fragment mask."""
    wl, mems = _workload(seed=3)
    system = _system(wl, mems, "um")
    Replayer(wl, N_HOPS).run(system, window=4)
    fleet = system.fleet
    es = list(range(4))
    groups = fleet._window_bufs[0][0].device()
    params = [fleet._params_log[e] for e in es]
    keys = wl.keys
    n_frags = len(fleet.frag_order)
    rng = np.random.RandomState(5)
    sel = rng.rand(len(es), n_frags) < 0.6
    sel[np.arange(len(es)), rng.randint(0, n_frags, len(es))] = True
    for s in (np.ones(n_frags, bool), sel):
        got = um_fleet_query_window_device(groups, params, keys, N_LEVELS,
                                           frag_sel=s)
        want = reference_engine("um", stack=_dense(groups),
                                params=np.stack(params), keys=keys,
                                n_levels=N_LEVELS, sel=s)
        assert got.shape == (N_LEVELS, len(keys))
        np.testing.assert_array_equal(got, want)


def test_engine_uploads_nothing_inside_the_guard(monkeypatch):
    """The engine's stages: every host array goes to the device before the
    guard is entered (one pass over the row groups), none inside it.  On a
    card an upload inside the guard is a synchronising pageable copy,
    which the sync debug mode refuses; here every ``torch.as_tensor`` or
    ``torch.tensor`` call made while the guard's dispatch mode is active
    is caught by a wrapper."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    seen = []
    for name in ("as_tensor", "tensor"):
        def wrapped(*args, _fn=getattr(torch, name), **kw):
            seen.append(isinstance(_get_current_dispatch_mode(),
                                   sanitize._host_sync_mode()))
            return _fn(*args, **kw)
        monkeypatch.setattr(torch, name, wrapped)
    monkeypatch.setenv(sanitize._ENV, "1")
    wl, mems = _workload()
    for kind in ("cs", "um"):
        system = _system(wl, mems, kind, shards=2)
        Replayer(wl, N_HOPS).run(system, window=4, failures=FailureSchedule(
            N_HOPS, downs={3: (2, None)}))
        seen.clear()
        _queries(system, wl)
        assert seen and not any(seen), \
            f"{kind}: {sum(seen)} of {len(seen)} uploads inside the guard"


# -- the load counter ---------------------------------------------------------

def test_load_counter_positive_control(monkeypatch):
    """The counter can fire: after ``build.load.cache_clear()`` the first
    load of a library notes ``build.<name>`` once and later loads, also
    through ``kernel_lib`` (which keeps no cache of its own), note nothing.
    The loader is stubbed (no ``nvcc`` here): ``build_all`` builds nothing
    and the "library" is an object with a launch function."""
    def fake_cdll(path):
        return types.SimpleNamespace(path=path, fleet_ragged_launch=(
            types.SimpleNamespace(argtypes=None, restype=None)))

    monkeypatch.setattr(build, "build_all", lambda names=None: {})
    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(
        CDLL=fake_cdll))
    build.load.cache_clear()
    try:
        snap = sanitize.trace_snapshot()
        lib = KK.kernel_lib("fleet_ragged", int, float)
        assert sanitize.traces_since(snap) == {"build.fleet_ragged": 1}
        assert lib.fleet_ragged_launch.argtypes == [int, float]
        snap = sanitize.trace_snapshot()
        assert build.load("fleet_ragged") is lib
        assert KK.kernel_lib("fleet_ragged", int, float) is lib
        assert sanitize.traces_since(snap) == {}
        build.load.cache_clear()
        assert KK.kernel_lib("fleet_ragged", int, float) is not lib
        assert sanitize.traces_since(snap) == {"build.fleet_ragged": 1}
    finally:
        build.load.cache_clear()      # drop the stubs from the cache


def _replay_and_query(wl, mems):
    sched = FailureSchedule(N_HOPS, downs={3: (2, None), 0: (3, None)})
    system = _system(wl, mems, "cs")
    Replayer(wl, N_HOPS).run(system, window=4, failures=sched)
    return _queries(system, wl)


def test_steady_state_replay_loads_nothing(monkeypatch):
    """A second identical multi-window replay (heterogeneous widths, two
    switches down mid-replay, window super-dispatch) with its window,
    point and per-path queries under the armed guard loads no library,
    and computes the same answers."""
    monkeypatch.setenv(sanitize._ENV, "1")
    wl, mems = _workload(n_epochs=8)
    warm = _replay_and_query(wl, mems)
    snap = sanitize.trace_snapshot()
    second = _replay_and_query(wl, mems)
    assert sanitize.traces_since(snap) == {}
    for a, b in zip(warm, second):
        np.testing.assert_array_equal(a, b)
