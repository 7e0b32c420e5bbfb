"""The JAX reference's answers at chip_smoke.py's §6.1 setting: the values
the smoke pins (``RHO["um"]``, ``RMSE_PIN``, ``AGG_RMSE_PIN``,
``ENTROPY_PIN``, ``CHURN_PIN``, ``CONTROL_PIN``, ``EXPORT_PIN``,
``CHAOS_PIN``; and ``SERVE_PIN``, see below), computed on the CPU by
the reference's numpy paths (the loop backend, ``process_epoch``,
``query_window``) and, for the window-8 entropy at k_heavy 1024, its jnp
device G-sum.

    PYTHONPATH=src python scripts/reference_pins.py [SECTION ...]

SECTIONs: rho, aggregated, rmse_epoch, rmse_window, um_epoch, um_window,
churn, control, export, chaos, serve, train, sharding (default: all).  Prints one ``name
value`` line per result, then one JSON object.  All sections take a few minutes at this
full-scale setting; ``churn`` alone took 31.8 s (wall) on an 8-core x86
CPU, ``control`` under 45 s, ``export`` under 30 s, ``chaos`` under 60 s.

The ``churn`` section runs the smoke's failure schedule
(``churn_schedule``: 5 of 20 switches die at epoch 17 and return at 25,
beside seeded resource pressure).  Its per-epoch values come from the
reference's loop backend through ``Replayer.run(failures=...)``.  Its
window-8 values come from ``ChurnWindowEmulation``, the window path built
from the reference's parts, since the reference's fleet backend cannot
run on a CPU under this jax: ``process_epoch`` with ``ns`` and the widths
frozen per window, dead cells empty and lost cells zeroed after their
PEBs, the reference's own ``apply_event`` and ``_apply_pending_resizes``
on a loop-backend system for the control, and ``query_window(merge=
"fragment")`` for the answers.  ``tests/test_torch_churn.py`` holds the
port to the same emulation at a small size.

The ``control`` section runs the reference's ``VersionedControlPlane``
around its loop backend over the smoke's lossy channels (``lossy_ctrl``):
cs and cms in windows of 8 with no churn, and cs per epoch under
``churn_schedule``.  ``tests/test_torch_control.py`` holds the port's
plane to the same oracle at a small size.

The ``export`` section runs the reference's ``DurableExportPlane`` around
its loop backend over the smoke's lossy export channels
(``lossy_export``), driven window by window through ``run_window`` as the
``control`` section is: cs with checkpoints and a collector crash after
the second window, then a drain (``EXPORT_PIN``'s ``stats()`` and
``crash()`` report); cms with every message of one switch dropped.  A
message's fate depends on ``(seed, frag, epoch, seq)`` alone, so these
protocol values are those of any backend that stages the same cells at
the same rounds.  ``tests/test_torch_export.py`` holds the port's plane
to the same oracle at a small size.

The ``chaos`` section runs the reference's ``ChaosHarness`` around its
``VersionedControlPlane`` around its ``DurableExportPlane`` around
``ChurnWindowEmulation(export=True)``, driven window by window through
``run_window``: cs over lossless channels, then cs and cms under
``churn_schedule`` with ``lossy_ctrl``, ``lossy_export`` and a collector
crash every 2 dispatches.  The emulation is a system the reference's
planes wrap: the control plane hands each window the agents' applied
configs, and the dead and lost cells stay out of ``records``, so the
export plane stages the live cells only, as the port's fleet does.
``tests/test_torch_chaos.py`` holds the port's harness to the same oracle
at a small size.

The ``serve`` section is the model serving path's pin (``SERVE_PIN``):
gemma2-2b at full width cut to ``SERVE_LAYERS`` layers, f32 weights drawn
from ``numpy.random.default_rng(SERVE_SEED)`` by the port's
``init_params`` and carried into the reference's pytree, and the
reference's ``prefill`` of a fixed prompt into an f32 cache; the pin is
the top-8 token ids and values of the last position's logits.  The port's
own prefill on this CPU is printed beside it for comparison.  It peaks
at about 10 GB of host memory (1.34 G parameters, in numpy and in jax),
takes 30 to 40 s on an 8-core x86 CPU, and needs no workload.

The ``train`` section is the training path's pin (``TRAIN_PIN``): the
same 2-layer full-width gemma2-2b and f32 weights as ``serve``, then
``TRAIN_STEPS`` steps of the reference's jitted ``make_train_step`` (remat
on, no compressor) on ``SyntheticLM(seed=TRAIN_SEED)`` batches of
``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, under the launcher's cosine
schedule for ``TRAIN_STEPS`` steps at ``TRAIN_LR``; the pin is each
step's loss and grad norm, the updated ``final_norm`` at
``TRAIN_NORM_AT`` and its L2 norm, and its AdamW moment m at
``TRAIN_NORM_AT``.  The port's own steps on this CPU are
run after the reference's (one state at a time) and printed beside them.
It peaks at about 27 GB of host memory (1.34 G parameters with their
gradients and f32 moments) and needs no workload.
"""
import functools
import hashlib
import json
import sys
import tempfile

import numpy as np

from repro.core import equalize as REQ
from repro.core import query as RQ
from repro.core.disketch import (AggregatedSystem, DiscoSystem,
                                 DiSketchSystem, SwitchStream,
                                 _g_entropy, calibrate_rho_target)
from repro.core.fragment import FragmentConfig, process_epoch
from repro.core.hashing import level_of
from repro.core.sketches import true_entropy
from repro.net.channel import LossyChannel
from repro.net.simulator import (ComposedSchedule, FailureSchedule,
                                 Replayer, ResourcePressure, rmse)
from repro.net.topology import FatTree, core_on_path
from repro.net.traffic import gen_workload, gini_memories
from repro.runtime.chaos import ChaosHarness
from repro.runtime.control import VersionedControlPlane
from repro.runtime.export import DurableExportPlane

# chip_smoke.py's setting
N_FLOWS, N_PACKETS, N_EPOCHS, LOG2_TE, SEED = 200_000, 2_000_000, 32, 16, 1
BASE_MEM, GINI, WINDOW = 128 * 1024, 0.4, 8
RHO = {"cs": 15.67, "cms": 1.0, "um": 63.31}
N_LEVELS, LEVEL_SEED, ENTROPY_EPOCHS = 16, 7777, 8
SECTIONS = ("rho", "aggregated", "rmse_epoch", "rmse_window", "um_epoch",
            "um_window", "churn", "control", "export", "chaos", "serve",
            "train", "sharding")
# the churn phase: the window that holds the deaths, and the parity groups
CHURN_EPOCHS, PARITY_GROUP = range(16, 24), 5
# the export phase: protocol rounds after each window dispatch, the
# checkpoint cadence in rounds, the window after which the collector
# crashes, and the switch whose export messages the drop run loses
EXPORT_STEPS, EXPORT_CKPT_EVERY, EXPORT_CRASH_AFTER = 8, 10, 8
EXPORT_VICTIM = 16
# the chaos phase's runs: (name, kind, lossy channels and churn_schedule(),
# export rounds after each dispatch, a collector crash every N dispatches)
CHAOS_RUNS = (("lossless cs", "cs", False, 4, 0),
              ("cs", "cs", True, 6, 2), ("cms", "cms", True, 6, 2))
CHAOS_MAX_RETRIES = 12
# the serve phase's pin: layers kept of gemma2-2b, the weights' seed, the
# prompt's length and seed, and how many of the last logits are pinned
SERVE_LAYERS, SERVE_SEED, SERVE_PROMPT, SERVE_TOP = 2, 11, 16, 8
# the train phase's pin: steps, batch, sequence, data seed, learning rate,
# and the final_norm entries pinned
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED, TRAIN_LR = 2, 1, 64, 5, 3e-4
TRAIN_NORM_AT = tuple(range(0, 2304, 144))

out = {}


def save(name, value):
    out[name] = value
    print(name, repr(value), flush=True)


def window_records(rep, mems, kind, **frag_kw):
    """The fleet window path emulated from the reference's parts: each
    window of 8 runs ``process_epoch`` with the n frozen at its start, and
    Eq. 6 is replayed in epoch order at its end."""
    frags = {sw: FragmentConfig(sw, kind, m, **frag_kw)
             for sw, m in mems.items()}
    empty = SwitchStream(np.zeros(0, np.uint32), np.zeros(0, np.int64),
                         np.zeros(0, np.int64))
    ns = {sw: 1 for sw in mems}
    records = {}
    for e0 in range(0, N_EPOCHS, WINDOW):
        frozen, pebs_by_epoch = dict(ns), []
        for e in range(e0, min(e0 + WINDOW, N_EPOCHS)):
            records[e], pebs = {}, {}
            for sw, cfg in frags.items():
                st = rep.epoch_stream(e).get(sw, empty)
                rec = process_epoch(cfg, e, frozen[sw], st.keys, st.values,
                                    st.ts, e << LOG2_TE, LOG2_TE,
                                    single_hop=st.single_hop)
                records[e][sw] = rec
                pebs[sw] = REQ.peb_epoch(rec)
            pebs_by_epoch.append(pebs)
        for pebs in pebs_by_epoch:
            for sw, peb in pebs.items():
                ns[sw] = REQ.next_n(ns[sw], peb, RHO[kind])
    return records


def churn_schedule(n_switches=20):
    """chip_smoke.py's churn: a quarter of the switches die at epoch 17
    (window offset 1) and return at 25, beside seeded resource pressure."""
    return ComposedSchedule([
        FailureSchedule.random(n_switches, 0.25, down_epoch=17, up_epoch=25,
                               seed=3),
        ResourcePressure(n_switches, horizon=N_EPOCHS, seed=5)])


def lossy_ctrl():
    """The smoke's control channels: directives lose 40%, duplicate 20%
    and reorder 30% of copies; ACKs lose 20% and duplicate 20%; both
    delay 0 or 1 extra round."""
    return (LossyChannel(p_drop=0.4, p_dup=0.2, p_reorder=0.3, delay=(0, 1),
                         seed=17),
            LossyChannel(p_drop=0.2, p_dup=0.2, delay=(0, 1), seed=18))


def lossy_export():
    """The smoke's export channels (the reference tests' ``lossy()``):
    data messages lose 30%, duplicate 20% and reorder 30% of copies and
    take 0 to 2 extra rounds; ACKs lose 15%, duplicate 20% and take 0 or
    1 extra round."""
    return (LossyChannel(p_drop=0.3, p_dup=0.2, p_reorder=0.3, delay=(0, 2),
                         seed=9),
            LossyChannel(p_drop=0.15, p_dup=0.2, delay=(0, 1), seed=10))


class DropSwitch(LossyChannel):
    """A lossless channel that drops every message of one switch."""

    def __init__(self, victim, **kw):
        super().__init__(**kw)
        self._victim = victim

    def send(self, msg, now):
        if msg.frag == self._victim:
            self.n_sent += 1
            self.n_dropped += 1
            return
        super().send(msg, now)


def n_log_digest(n_log):
    """A short digest of an n trajectory (one {switch: n} per epoch)."""
    rows = [[[int(sw), int(n)] for sw, n in sorted(d.items())]
            for d in n_log]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]


def json_digest(obj):
    """A short digest of a JSON-able object (the control plane's
    ``clamp_log``)."""
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()[:16]


class ChurnWindowEmulation:
    """The reference's fleet window path, built from its own parts, as a
    system the reference's planes can wrap.

    ``ctl`` is a reference ``DiSketchSystem(backend="loop")`` (or
    ``DiscoSystem``) that carries the control: its ``apply_event``,
    ``_apply_pending_resizes`` and Eq. 6 run in the order of the
    reference's fleet ``run_window`` (``core/disketch.py:296-341``).  Each
    ``run_window`` runs ``process_epoch`` at the ``ns`` and widths frozen
    at the window's start, after its first epoch's events: under a
    ``VersionedControlPlane`` those are the agents' applied configs, the
    plane's ``_frozen_ns``.  A dead cell sketches nothing (the fleet masks
    its packets to value 0), a lost cell is zeroed after its PEB is taken,
    and resizes inside a window wait for the next dispatch.  ``saved``
    keeps the lost cells' counters, which parity recovery gives back.

    With ``export=True`` the dead and lost cells are kept out of
    ``records``, so a ``DurableExportPlane`` around the
    emulation stages only the live cells, as the fleet's plane does
    (``frag_live``): the protocol depends only on which cells were staged
    and when.  Its queries then support ``"mask"`` only.

    The planes see ``fleet = None`` and take their loop-backend branches
    (records popped and reinserted), so ``Replayer.run`` would run the
    emulation epoch by epoch: drive it window by window through
    ``run_window`` (``replay`` does)."""

    fleet = None
    backend = "fleet"
    # what the planes read of the system, forwarded to ``ctl``
    _FORWARDED = frozenset((
        "records", "fragments", "ns", "dead", "clamp_log", "apply_event",
        "n_log", "peb_log", "_peb_width", "_last_pebs", "_dead_at",
        "subepoching", "rho_target"))

    def __init__(self, mems, kind, rho, log2_te, parity_groups=None,
                 subepoching=True, export=False, **sys_kw):
        self.kind = kind
        self.log2_te = log2_te
        self.parity_groups = parity_groups
        self.export = export
        self.ctl = (DiSketchSystem if subepoching else DiscoSystem)(
            mems, kind, rho_target=rho, log2_te=log2_te, **sys_kw)
        self.lost, self.saved, self.ns_by_window = {}, {}, {}
        self.last_observability = None

    @classmethod
    def replay(cls, streams_of, mems, kind, rho, log2_te, n_epochs, window,
               schedule, **kw):
        """An emulation run over ``n_epochs`` in windows of ``window``,
        ``schedule`` advanced epoch by epoch."""
        em = cls(mems, kind, rho, log2_te, **kw)
        for e0 in range(0, n_epochs, window):
            eps = range(e0, min(e0 + window, n_epochs))
            em.run_window(e0, [streams_of(e) for e in eps],
                          events_by_epoch=[schedule.advance(e) for e in eps])
        return em

    def __getattr__(self, name):
        if name in ChurnWindowEmulation._FORWARDED:
            return getattr(self.ctl, name)
        raise AttributeError(name)

    @property
    def control_external(self):
        return self.ctl.control_external

    @control_external.setter
    def control_external(self, value):
        self.ctl.control_external = value

    def run_epoch(self, epoch, streams, packet=None, events=None):
        """One epoch as the fleet's per-epoch path runs it: a window of one
        whose dead switches keep no record."""
        self.run_window(epoch, [streams], events_by_epoch=[events or ()])
        for sw in self.ctl._dead_at.get(epoch, ()):
            self.ctl.records[epoch].pop(sw, None)

    def run_window(self, epoch0, streams_list, packets=None,
                   events_by_epoch=None):
        ctl, log2_te = self.ctl, self.log2_te
        empty = SwitchStream(np.zeros(0, np.uint32), np.zeros(0, np.int64),
                             np.zeros(0, np.int64))
        eps = list(range(epoch0, epoch0 + len(streams_list)))
        events = (list(events_by_epoch) if events_by_epoch
                  else [()] * len(eps))
        ctl._apply_pending_resizes()
        for ev in events[0]:
            ctl.apply_event(ev)
        frozen = (dict(ctl.ns) if ctl.subepoching
                  else {sw: 1 for sw in ctl.fragments})
        frags = dict(ctl.fragments)
        self.ns_by_window[epoch0] = frozen
        dead_sets, fail_pts = [frozenset(ctl.dead)], []
        for k in range(1, len(eps)):
            for ev in events[k]:
                if ev.kind == "fail" and ev.switch not in ctl.dead:
                    fail_pts.append((k, ev.switch))
                ctl.apply_event(ev, defer_resize=True)
            dead_sets.append(frozenset(ctl.dead))
        lost_sets = [set() for _ in eps]
        for k, sw in fail_pts:
            for k2 in range(k):
                if sw not in dead_sets[k2]:
                    lost_sets[k2].add(sw)
        window_pebs = []
        for k, e in enumerate(eps):
            recs, pebs = {}, {}
            for sw, cfg in frags.items():
                dead = sw in dead_sets[k]
                st = empty if dead else streams_list[k].get(sw, empty)
                rec = process_epoch(cfg, e, frozen[sw], st.keys, st.values,
                                    st.ts, e << log2_te, log2_te,
                                    single_hop=st.single_hop)
                if not dead:
                    pebs[sw] = REQ.peb_epoch(rec)
                if sw in lost_sets[k]:
                    self.saved[(e, sw)] = rec.counters.copy()
                    rec.counters[...] = 0
                if not (self.export and (dead or sw in lost_sets[k])):
                    recs[sw] = rec
            if lost_sets[k]:
                self.lost[e] = set(lost_sets[k])
            ctl.records[e] = recs
            window_pebs.append(pebs)
        # the reference's run_window tail: Eq. 6 replayed in order
        for k, e in enumerate(eps):
            if dead_sets[k]:
                ctl._dead_at[e] = dead_sets[k]
            else:
                ctl._dead_at.pop(e, None)
            ctl.peb_log.append(window_pebs[k])
            for sw in window_pebs[k]:
                ctl._peb_width[sw] = ctl.fragments[sw].width
            if ctl.subepoching and not ctl.control_external:
                for sw, peb in window_pebs[k].items():
                    ctl.ns[sw] = REQ.next_n(ctl.ns[sw], peb, ctl.rho_target)
            ctl.n_log.append(dict(ctl.ns))

    def recoverable(self):
        """``{epoch: [switch]}``: lost cells alone in their parity group."""
        out = {}
        for e in sorted(self.lost):
            for sw in sorted(self.lost[e]):
                group = next((g for g in self.parity_groups or ()
                              if sw in g), None)
                if group is not None and not any(
                        o != sw and o in self.lost[e] for o in group):
                    out.setdefault(e, []).append(sw)
        return out

    def recover(self):
        """Give the recoverable lost cells their counters back."""
        done = self.recoverable()
        for e, sws in done.items():
            for sw in sws:
                self.ctl.records[e][sw].counters[...] = self.saved[(e, sw)]
                self.lost[e].discard(sw)
        return done

    def valid(self, sw, e):
        return (sw in self.ctl.records.get(e, ())
                and sw not in self.ctl._dead_at.get(e, frozenset())
                and sw not in self.lost.get(e, ()))

    def observability(self, epochs):
        """The fleet's ``observability``: per epoch, the cells that are
        genuine observations now (not dead, not lost, not held back by a
        pending export)."""
        epochs = list(epochs)
        per_epoch = {e: sum(1 for sw in self.ctl.records.get(e, {})
                            if self.valid(sw, e)) for e in epochs}
        obs, scale = RQ.window_observability(
            [[None] * per_epoch[e] for e in epochs])
        return {"epochs": len(epochs), "observable_epochs": obs,
                "scale": scale, "observable_cells": sum(per_epoch.values()),
                "total_cells": len(self.ctl.fragments) * len(epochs),
                "per_epoch": per_epoch,
                "config_clamps": list(self.ctl.clamp_log)}

    def query_flows(self, keys, paths, epochs, merge="subepoch",
                    failures="mask"):
        """``query_flows`` with the system's signature."""
        self.last_observability = self.observability(epochs)
        return self.query(np.asarray(keys, np.uint32), paths, epochs,
                          failures, merge=merge)

    def query(self, keys, paths, epochs, failures, merge="fragment"):
        """``query_flows`` of the fleet under ``failures``: per path group,
        ``query_window`` over the on-path records (all of them under
        "oblivious"; the valid ones, scaled by E / E_observable, under
        "mask"; "recover" recovers first)."""
        if failures != "mask" and self.export:
            raise ValueError("a held-back window is emulated under "
                             "failures='mask' only")
        if failures == "recover":
            self.recover()
            failures = "mask"
        out = np.zeros(len(keys))
        for path, idxs in path_groups(paths).items():
            recs = [[self.ctl.records[e][sw] for sw in path
                     if failures == "oblivious" or self.valid(sw, e)]
                    for e in epochs]
            scale = 1.0
            if failures != "oblivious":
                n_obs, scale = RQ.window_observability(recs)
                if not n_obs:
                    raise ValueError(f"path {path} is unobservable")
            out[idxs] = RQ.query_window(
                recs, keys[idxs], self.kind,
                single_hop=np.full(len(idxs), len(path) == 1),
                level=0 if self.kind == "um" else None, merge=merge) * scale
        return out


def path_groups(paths):
    groups = {}
    for i, p in enumerate(paths):
        groups.setdefault(tuple(p), []).append(i)
    return {p: np.asarray(i) for p, i in groups.items()}


def _abstract_mesh(sizes, names):
    """AbstractMesh across JAX versions (as tests/test_sharding_specs.py
    builds it)."""
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(tuple(sizes), tuple(names))


SHARDING_MESHES = {"single": ((16, 16), ("data", "model")),
                   "multi": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def reference_param_shapes(arch):
    """``jax.eval_shape`` of the reference's bf16 parameters of ``arch``
    (kept: every table of both meshes starts from it)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model as RM

    return jax.eval_shape(lambda: RM.init_params(
        jax.random.PRNGKey(0), get_config(arch), dtype=jnp.bfloat16))


def reference_spec_tables(arch, mesh_kind):
    """The reference's spec tables of ``arch`` on a production mesh, in
    the form of the port's ``launch/shardings.py::spec_tables``: each leaf
    ``[jax.tree_util.keystr(path), [entry, ...]]``."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import LONG_CONTEXT_OK, SHAPES, get_config
    from repro.data.pipeline import batch_specs
    from repro.launch import shardings as SH

    mesh = _abstract_mesh(*SHARDING_MESHES[mesh_kind])
    cfg = get_config(arch)

    def canon(spec):
        return [None if e is None else ([e] if isinstance(e, str)
                                        else list(e)) for e in spec]

    def rows(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))
        return [[jax.tree_util.keystr(p), canon(x)] for p, x in flat]

    params = reference_param_shapes(arch)
    pspecs = SH.param_specs(params, cfg, mesh, fsdp=True)
    out = {"params fsdp": rows(pspecs),
           "params": rows(SH.param_specs(params, cfg, mesh, fsdp=False)),
           "opt": rows(SH.opt_state_specs(pspecs, mesh))}
    for name in ("decode_32k", "long_500k"):
        if name == "long_500k" and arch not in LONG_CONTEXT_OK:
            continue
        out[name] = rows(SH.decode_state_specs(
            cfg, SHAPES[name].global_batch, mesh,
            seq_shard=name == "long_500k"))
    for name, shape in SHAPES.items():
        batch = batch_specs(cfg, shape)
        out[f"batch {name}"] = rows({k: SH.div_spec(
            mesh, tuple(v.shape), P(SH.BATCH, *([None] * (len(v.shape) - 1))))
            for k, v in batch.items()})
    return out


def sharding():
    """SHARDING_PIN: a digest of every spec table of each arch on both
    production meshes (AbstractMesh: no devices needed)."""
    from repro.configs import list_configs

    pin = {}
    for arch in list_configs():
        for mk in SHARDING_MESHES:
            pin[f"{arch} {mk}"] = json_digest(reference_spec_tables(arch, mk))
    save("sharding pin", pin)


def main(sections):
    if "serve" in sections:
        serve()
    if "train" in sections:
        train()
    if "sharding" in sections:
        sharding()
    if set(sections) <= {"serve", "train", "sharding"}:
        print(json.dumps(out))
        return
    topo = FatTree(4)
    wl = gen_workload(topo, n_flows=N_FLOWS, total_packets=N_PACKETS,
                      n_epochs=N_EPOCHS, log2_te=LOG2_TE, burstiness=0.2,
                      seed=SEED)
    rep = Replayer(wl, topo.n_switches)
    mems = {sw: int(m) for sw, m in enumerate(gini_memories(
        topo.n_switches, BASE_MEM, GINI, np.random.RandomState(SEED + 100)))}
    sel = wl.path_len == 5
    keys, truth = wl.keys[sel], wl.sizes[sel]
    paths = [p for p, s in zip(wl.paths, sel) if s]
    epochs = list(range(N_EPOCHS))
    um_kw = dict(n_levels=N_LEVELS)

    if "rho" in sections:
        save("rho um", calibrate_rho_target(
            mems, "um", rep.epoch_stream(N_EPOCHS // 2), LOG2_TE, **um_kw))
    if "aggregated" in sections:
        core = core_on_path(wl.path_mat[sel], topo.core_ids)
        for kind in ("cs", "cms", "um"):
            agg = AggregatedSystem({sw: mems[sw] for sw in topo.core_ids},
                                   kind, depth=4)
            rep.run(agg)
            save(f"aggregated {kind}",
                 rmse(agg.query_flows(keys, core, epochs), truth))
    if "rmse_epoch" in sections:
        for kind in ("cs", "cms"):
            s = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                               log2_te=LOG2_TE)
            rep.run(s)
            for merge in ("subepoch", "fragment"):
                save(f"{kind} {merge}", rmse(
                    s.query_flows(keys, paths, epochs, merge=merge), truth))
            d = DiscoSystem(mems, kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE)
            rep.run(d)
            save(f"{kind} disco",
                 rmse(d.query_flows(keys, paths, epochs), truth))
    if "rmse_window" in sections:
        for kind in ("cs", "cms"):
            records = window_records(rep, mems, kind)
            est = np.zeros(len(keys))
            for path, idxs in path_groups(paths).items():
                recs = [[records[e][sw] for sw in path] for e in epochs]
                est[idxs] = RQ.query_window(
                    recs, keys[idxs], kind,
                    single_hop=np.full(len(idxs), False), level=None,
                    merge="fragment")
            save(f"{kind} window {WINDOW}", rmse(est, truth))
    if "um_epoch" in sections:
        es = list(range(ENTROPY_EPOCHS))
        in_es = (wl.pkt_ts >> LOG2_TE) < ENTROPY_EPOCHS
        total = float(in_es.sum())
        save(f"true entropy, epochs 0-{ENTROPY_EPOCHS - 1}", true_entropy(
            np.bincount(wl.pkt_flow[in_es], minlength=len(wl.keys))))
        q_kw = dict(n_levels=N_LEVELS, level_seed=LEVEL_SEED)
        s = DiSketchSystem(mems, "um", rho_target=RHO["um"],
                           log2_te=LOG2_TE, **um_kw)
        rep.run(s)
        save("disketch subepoch",
             s.query_entropy(wl.keys, wl.paths, es, total, **q_kw))
        save("disketch fragment", s.query_entropy(
            wl.keys, wl.paths, es, total, merge="fragment",
            k_heavy=len(wl.keys), **q_kw))
        d = DiscoSystem(mems, "um", rho_target=RHO["um"], log2_te=LOG2_TE,
                        **um_kw)
        rep.run(d)
        save("disco subepoch",
             d.query_entropy(wl.keys, wl.paths, es, total, **q_kw))
    if "um_window" in sections:
        from repro.kernels.sketch_query import um_gsum_device

        records = window_records(rep, mems, "um", **um_kw)
        total = float(len(wl.pkt_ts))
        save(f"true entropy, epochs 0-{N_EPOCHS - 1}",
             true_entropy(wl.sizes))
        # um_gsum_window's per-level estimates, in path-group order
        ests, lvls = [], []
        for path, idxs in path_groups(wl.paths).items():
            kk = wl.keys[idxs]
            recs = [[records[e][sw] for sw in path] for e in epochs]
            lvl = level_of(kk, LEVEL_SEED, N_LEVELS)
            est = np.zeros((N_LEVELS, len(kk)))
            for l in range(N_LEVELS):
                m = lvl >= l
                if m.any():
                    est[l, m] = RQ.query_window(recs, kk[m], "um", level=l,
                                                merge="fragment")
            ests.append(est)
            lvls.append(lvl)
        ests, lvl = np.concatenate(ests, axis=1), np.concatenate(lvls)

        def entropy(s):
            return float(np.log2(total) - s / total)

        g = lambda x: x * np.log2(np.maximum(x, 1.0))    # noqa: E731
        save("window 8 fragment", entropy(
            RQ.um_gsum_combine(ests, lvl, g, k_heavy=len(wl.keys))))
        # k_heavy 1024 binds: lax.top_k's order (ties to the lower index)
        save("window 8 fragment k_heavy 1024", entropy(
            um_gsum_device(ests, lvl, _g_entropy, k_heavy=1024)))
    if "churn" in sections:
        churn(wl, rep, mems, keys, truth, paths, epochs)
    if "control" in sections:
        control(wl, rep, mems, keys, truth, paths, epochs)
    if "export" in sections:
        export(rep, mems)
    if "chaos" in sections:
        chaos(rep, mems, keys, truth, paths, epochs)
    print(json.dumps(out))


def truth_over(wl, es):
    """The 5-hop flows' true sizes over the epochs ``es``."""
    in_es = np.isin(wl.pkt_ts >> LOG2_TE, list(es))
    return np.bincount(wl.pkt_flow[in_es],
                       minlength=len(wl.keys))[wl.path_len == 5]


def churn(wl, rep, mems, keys, truth, paths, epochs):
    """The churn phase's pins: per-epoch cs on the loop backend, window 8
    (cs and cms, parity groups of 5) on ``ChurnWindowEmulation``."""
    es = list(CHURN_EPOCHS)
    truth_es = truth_over(wl, es)
    s = DiSketchSystem(mems, "cs", rho_target=RHO["cs"], log2_te=LOG2_TE)
    rep.run(s, failures=churn_schedule())
    save("churn epoch dead_at", {int(e): sorted(int(x) for x in d)
                                 for e, d in sorted(s._dead_at.items())})
    save("churn epoch cs n_log", n_log_digest(s.n_log))
    save("churn epoch cs clamps", len(s.clamp_log))
    for failures in ("mask", "oblivious"):
        save(f"churn epoch cs {failures}", rmse(s.query_flows(
            keys, paths, es, failures=failures), truth_es))
    groups = [list(range(i, i + PARITY_GROUP))
              for i in range(0, len(mems), PARITY_GROUP)]
    for kind in ("cs", "cms"):
        em = ChurnWindowEmulation.replay(
            rep.epoch_stream, mems, kind, RHO[kind], LOG2_TE, N_EPOCHS,
            WINDOW, churn_schedule(), parity_groups=groups)
        save(f"churn window {kind} n_log", n_log_digest(em.ctl.n_log))
        save(f"churn window {kind} lost",
             {int(e): sorted(int(x) for x in sws)
              for e, sws in sorted(em.lost.items())})
        save(f"churn window {kind} recoverable",
             {int(e): [int(x) for x in sws]
              for e, sws in em.recoverable().items()})
        for failures in ("oblivious", "mask", "recover"):
            save(f"churn window {kind} {failures}", rmse(em.query(
                keys, paths, epochs, failures), truth))
        if kind == "cs":
            # the record plane (subepoch merge) of the churn window, after
            # "recover": its dead cells hold zero records, which "oblivious"
            # merges and "mask" drops
            for failures in ("mask", "oblivious"):
                save(f"churn window cs records {failures}", rmse(em.query(
                    keys, paths, es, failures, merge="subepoch"), truth_es))


def control(wl, rep, mems, keys, truth, paths, epochs):
    """The control phase's pins: the reference's plane around its loop
    backend, over ``lossy_ctrl``'s channels."""
    def plane(kind, channels=None):
        return VersionedControlPlane(
            DiSketchSystem(mems, kind, rho_target=RHO[kind], log2_te=LOG2_TE),
            *(lossy_ctrl() if channels is None else channels))

    for kind, channels in (("cs", ()), ("cs", None), ("cms", None)):
        name = f"control window {kind}" + (" lossless" if channels == ()
                                           else "")
        p = plane(kind, channels)
        # run_window is called directly: Replayer.run would run a system
        # without a fleet epoch by epoch whatever the window, and the
        # plane would react every epoch.  Called directly, the loop
        # backend runs the window's epochs with ns unchanged (external
        # control) and _post_dispatch walks the window's PEBs once: the
        # fleet window path's semantics.
        for e0 in range(0, N_EPOCHS, WINDOW):
            p.run_window(e0, [rep.epoch_stream(e) for e in
                              range(e0, min(e0 + WINDOW, N_EPOCHS))])
        save(f"{name} applied", n_log_digest(p.applied_log))
        save(f"{name} stale", p.stale_epochs())
        save(f"{name} stats", p.stats())
        save(f"{name} rmse", rmse(p.query_flows(keys, paths, epochs,
                                                merge="fragment"), truth))
    # per epoch under churn, through the reference's own Replayer.run
    es = list(CHURN_EPOCHS)
    p = plane("cs")
    rep.run(p, failures=churn_schedule())
    save("control epoch cs applied", n_log_digest(p.applied_log))
    save("control epoch cs clamps", p.clamp_log)
    save("control epoch cs clamps digest", json_digest(p.clamp_log))
    save("control epoch cs stats", p.stats())
    save("control epoch cs stale", p.stale_epochs())
    est = p.query_flows(keys, paths, es, failures="mask")
    save("control epoch cs stale_config",
         p.last_observability["stale_config"])
    save("control epoch cs rmse", rmse(est, truth_over(wl, es)))


def export(rep, mems):
    """The export phase's pins: the reference's plane around its loop
    backend over ``lossy_export``'s channels, window by window (its
    ``Replayer.run`` would stage and step once an epoch)."""
    def windows(p, after=None):
        for e0 in range(0, N_EPOCHS, WINDOW):
            p.run_window(e0, [rep.epoch_stream(e) for e in
                              range(e0, min(e0 + WINDOW, N_EPOCHS))])
            if after is not None and e0 == EXPORT_CRASH_AFTER:
                after(p)

    crashes = []
    with tempfile.TemporaryDirectory() as d:
        p = DurableExportPlane(
            DiSketchSystem(mems, "cs", rho_target=RHO["cs"],
                           log2_te=LOG2_TE), *lossy_export(),
            max_retries=12, ckpt_dir=d, ckpt_every=EXPORT_CKPT_EVERY,
            ckpt_keep=2, steps_per_dispatch=EXPORT_STEPS)
        windows(p, after=lambda p: crashes.append(p.crash()))
        p.drain()
        crash = dict(crashes[0])
        restaged = crash.pop("restaged")
        save("export crash", dict(crash, n_restaged=len(restaged),
                                  restaged=json_digest(restaged)))
        save("export stats", p.stats())
        save("export checkpoints", p._ckpt_step)
    p = DurableExportPlane(
        DiSketchSystem(mems, "cms", rho_target=RHO["cms"], log2_te=LOG2_TE),
        DropSwitch(EXPORT_VICTIM, seed=4), max_retries=2,
        steps_per_dispatch=EXPORT_STEPS)
    windows(p)
    p.drain()
    save("export drop lost", sorted(p.lost_cells()))
    save("export drop stats", p.stats())


def chaos(rep, mems, keys, truth, paths, epochs):
    """The chaos phase's pins: the reference's ``ChaosHarness`` around its
    ``VersionedControlPlane`` around its ``DurableExportPlane`` around
    ``ChurnWindowEmulation(export=True)``, driven window by window
    through ``run_window`` (its ``Replayer.run`` would dispatch a
    fleet-less system once an epoch, and the harness counts dispatches
    for its crashes and its stale ledger).  The lossless run has no
    schedule; the lossy runs take ``churn_schedule()``, ``lossy_ctrl()``
    and ``lossy_export()``."""
    for name, kind, lossy, steps, crash_every in CHAOS_RUNS:
        em = ChurnWindowEmulation(mems, kind, RHO[kind], LOG2_TE, export=True)
        export_ch, ctrl_ch = (lossy_export(), lossy_ctrl()) if lossy else \
            ((), ())
        h = ChaosHarness(VersionedControlPlane(DurableExportPlane(
            em, *export_ch, max_retries=CHAOS_MAX_RETRIES,
            steps_per_dispatch=0), *ctrl_ch),
            steps_per_dispatch=steps, crash_every=crash_every)
        schedule = churn_schedule() if lossy else None
        for e0 in range(0, N_EPOCHS, WINDOW):
            es = range(e0, min(e0 + WINDOW, N_EPOCHS))
            h.run_window(e0, [rep.epoch_stream(e) for e in es],
                         events_by_epoch=None if schedule is None else
                         [schedule.advance(e) for e in es])
        save(f"chaos {name} report", json.loads(json.dumps(h.finish())))
        save(f"chaos {name} crash_log", json_digest(h.crash_log))
        save(f"chaos {name} n_log", n_log_digest(em.n_log))
        save(f"chaos {name} rmse", rmse(h.query_flows(
            keys, paths, epochs, merge="fragment", failures="mask"), truth))


def serve():
    """The serve phase's pin: the reference's prefill of a fixed prompt
    through full-width gemma2-2b cut to ``SERVE_LAYERS`` layers, from
    numpy-seeded f32 weights; the top-``SERVE_TOP`` ids and values of the
    last position's logits."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config
    from repro.models import model as RM
    from repro_torch.models import convert
    from repro_torch.models import model as PM

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=SERVE_LAYERS)
    params = PM.init_params(np.random.default_rng(SERVE_SEED), cfg,
                            dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(SERVE_SEED + 1).integers(
        0, cfg.vocab, (1, SERVE_PROMPT)).astype(np.int32)
    state = PM.init_decode_state(params, cfg, 1, SERVE_PROMPT,
                                 dtype=torch.float32)
    port = PM.prefill(params, torch.from_numpy(prompt).long(), cfg,
                      state)[0][0, -1].double().numpy()
    rp = jax.tree.map(jnp.asarray, convert.to_numpy(params))
    del params
    state = RM.init_decode_state(rp, cfg, 1, SERVE_PROMPT, dtype=jnp.float32)
    logits, _ = RM.prefill(rp, jnp.asarray(prompt), cfg, state)
    last = np.asarray(logits[0, -1], np.float64)
    top = np.argsort(-last, kind="stable")[:SERVE_TOP]
    save("serve top ids", [int(i) for i in top])
    save("serve top logits", [float(last[i]) for i in top])
    # the port on this CPU, for comparison (the smoke holds the card's)
    save("serve port top ids equal",
         np.argsort(-port, kind="stable")[:SERVE_TOP].tolist() == top.tolist())
    save("serve port top logits, max relative error",
         float(np.max(np.abs(port[top] - last[top]) / np.abs(last[top]))))


def train():
    """The train phase's pin: the reference's jitted train step, twice,
    through full-width gemma2-2b cut to ``SERVE_LAYERS`` layers from the
    serve pin's f32 weights; then the port's step on this CPU."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLM
    from repro.train import optimizer as RO
    from repro.train import train_step as RT
    from repro_torch.models import convert
    from repro_torch.models import model as PM
    from repro_torch.train import optimizer as PO
    from repro_torch.train import train_step as PT

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=SERVE_LAYERS)
    params = PM.init_params(np.random.default_rng(SERVE_SEED), cfg,
                            dtype=torch.float32, device="cpu")
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=TRAIN_SEED)
    state = RT.init_train_state(jax.tree.map(
        lambda a: jnp.array(a, copy=True), convert.to_numpy(params)))
    del params
    step = jax.jit(RT.make_train_step(
        cfg, RO.cosine_schedule(TRAIN_LR, TRAIN_STEPS // 10, TRAIN_STEPS),
        sp=False), donate_argnums=0)
    ref = []
    for s in range(TRAIN_STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                data.batch(s).items()})
        ref.append((float(m["loss"]), float(m["grad_norm"])))
        save(f"train loss {s}", ref[-1][0])
        save(f"train grad_norm {s}", ref[-1][1])
    norm = np.asarray(state.params["final_norm"], np.float64)
    moment = np.asarray(state.opt.m["final_norm"], np.float64)
    del state, step
    save("train final_norm", [float(norm[i]) for i in TRAIN_NORM_AT])
    save("train final_norm l2", float(np.linalg.norm(norm)))
    save("train final_norm m", [float(moment[i]) for i in TRAIN_NORM_AT])
    # the port on this CPU, for comparison (the smoke holds the card's)
    params = PM.init_params(np.random.default_rng(SERVE_SEED), cfg,
                            dtype=torch.float32, device="cpu")
    pstate = PT.init_train_state(params)
    del params
    pstep = PT.make_train_step(cfg, PO.cosine_schedule(
        TRAIN_LR, TRAIN_STEPS // 10, TRAIN_STEPS))
    rel = 0.0
    for s in range(TRAIN_STEPS):
        b = {k: torch.from_numpy(v).long() for k, v in
             data.batch(s).items()}
        pstate, m = pstep(pstate, b)
        rel = max(rel, abs(float(m["loss"]) - ref[s][0]) / ref[s][0],
                  abs(float(m["grad_norm"]) - ref[s][1]) / ref[s][1])
    got = pstate.params["final_norm"].double().numpy()
    err = np.abs(got - norm) / np.abs(norm).max()
    at = list(TRAIN_NORM_AT)
    save("train port loss and grad_norm, max relative error", rel)
    save("train port final_norm at TRAIN_NORM_AT, max error over max "
         "|final_norm|, and the L2 relative error", [
             float(err[at].max()), float(np.linalg.norm(got[at] - norm[at])
                                         / np.linalg.norm(norm[at]))])
    m = pstate.opt.m["final_norm"].double().numpy()
    save("train port final_norm m at TRAIN_NORM_AT, max error over max "
         "|m|", float(np.abs(m[at] - moment[at]).max()
                      / np.abs(moment[at]).max()))
    save("train port final_norm l2, relative error",
         abs(float(np.linalg.norm(got)) - float(np.linalg.norm(norm)))
         / float(np.linalg.norm(norm)))
    # all 2304 entries: Adam moves an entry whose gradient cancels to the
    # eps scale by a step its rounding decides; count those off by > 1e-5
    save("train port final_norm, entries off by > 1e-5 of max, and the "
         "worst (index, error over max)",
         [int((err > 1e-5).sum()), int(err.argmax()), float(err.max())])


if __name__ == "__main__":
    chosen = sys.argv[1:] or SECTIONS
    unknown = set(chosen) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; "
                         f"choose from {SECTIONS}")
    main(chosen)
