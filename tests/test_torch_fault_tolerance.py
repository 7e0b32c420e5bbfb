"""The training side of the port's fault tolerance
(``repro_torch.runtime.fault_tolerance``) against the JAX package's.

Each scenario of the reference's ``tests/test_fault_tolerance.py`` is a
function of the module under test; it runs through both packages, makes
the reference's assertions on each, and the two runs must agree exactly:
equal ``MeshPlan``s, quarantine sets, raised errors and
``SupervisorReport``s (steps, restarts, final mesh, event log), and the
same save/restore calls in the same order.  The module is pure Python and
numpy, so nothing here is approximate.
"""
import dataclasses

import pytest

from repro.runtime import fault_tolerance as RF
from repro_torch.runtime import fault_tolerance as PF

MODULES = {"reference": RF, "port": PF}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _plan(p):
    return (p.shape, p.axis_names, p.hosts, p.n_devices)


def heartbeat(F):
    clk = Clock()
    mon = F.HeartbeatMonitor(4, timeout_s=10, clock=clk)
    clk.t = 5
    for h in [0, 1, 3]:
        mon.beat(h)
    clk.t = 12
    assert mon.failed_hosts() == {2}
    assert mon.healthy_hosts() == [0, 1, 3]
    out = [mon.failed_hosts(), mon.healthy_hosts()]
    mon.beat(2)
    assert mon.failed_hosts() == set()
    with pytest.raises(ValueError, match="out of range"):
        mon.beat(4)
    return out


def elastic_drops_rows(F):
    em = F.ElasticMesh(pod=2, data=4, model=16, devices_per_host=4)
    assert em.hosts_per_row == 4 and em.n_hosts == 32
    plans = [em.plan(range(32)),
             em.plan([h for h in range(32) if h != 17]),
             em.plan([h for h in range(32) if h not in (1, 17)])]
    assert [p.shape for p in plans] == [(2, 4, 16), (7, 16), (6, 16)]
    assert 17 not in plans[1].hosts
    return [_plan(p) for p in plans]


def elastic_partial_pod_and_single_row(F):
    em = F.ElasticMesh(pod=2, data=2, model=4, devices_per_host=4)
    flat = em.plan([h for h in range(em.n_hosts) if h != 3])
    assert flat.shape == (3, 4) and flat.axis_names == ("data", "model")
    one = em.plan([2])
    assert one.shape == (1, 4) and one.hosts == (2,)
    return [_plan(flat), _plan(one), em.row_of_host(3)]


def elastic_no_rows_raises(F):
    em = F.ElasticMesh(pod=1, data=2, model=8, devices_per_host=4)
    msgs = []
    for healthy in ([0], []):
        with pytest.raises(RuntimeError) as e:
            em.plan(healthy)
        msgs.append(str(e.value))
    return msgs


def straggler_policies(F):
    out = []
    pol = F.StragglerPolicy(threshold=1.5, patience=1)
    out.append(pol.observe({0: 9.0, 1: 9.0, 2: 1.0, 3: 1.0, 4: 1.0}))
    out.append(pol.observe({0: 9.0, 1: 9.0, 2: 4.0, 3: 1.0, 4: 1.0}))
    assert out == [{0, 1}, {2}]
    pol = F.StragglerPolicy(threshold=1.5, patience=1)
    out += [pol.observe({0: 9.0, 1: 1.0, 2: 1.0}), pol.observe({0: 9.0})]
    pol = F.StragglerPolicy(threshold=1.5, patience=2)
    slow = {0: 5.0, 1: 1.0, 2: 1.0}
    out.append(pol.observe(slow))
    pol.readmit(0)
    out += [pol.observe(slow), pol.observe(slow)]
    assert out[-1] == {0}
    pol = F.StragglerPolicy(threshold=1.5, patience=3)
    for t in ({0: 1.0, 1: 1.0, 2: 9.9}, {0: 1.0, 1: 1.0, 2: 1.0},
              {0: 1.0, 1: 1.0, 2: 9.9}, {0: 1.0, 1: 1.0, 2: 9.9}):
        out.append(pol.observe(t))
    assert pol.quarantined == set()
    return out


def _report(rep):
    return dataclasses.astuple(rep)


def supervisor_restart_loop(F):
    clk = Clock()
    em = F.ElasticMesh(pod=1, data=4, model=4, devices_per_host=4)
    mon = F.HeartbeatMonitor(em.n_hosts, timeout_s=10, clock=clk)
    sup = F.TrainingSupervisor(em, mon, ckpt_every=10, max_restarts=3)
    saved, calls, fail_at = {"step": 0}, [], {25}

    def step_fn(step, plan):
        calls.append(("step", step, plan.shape))
        if step in fail_at:
            fail_at.discard(step)
            clk.t += 100                     # host 1 dies: stops beating
            for h in range(em.n_hosts):
                if h != 1:
                    mon.beat(h)
            raise RuntimeError("collective timeout")

    def save_fn(step):
        calls.append(("save", step))
        saved["step"] = step

    def restore_fn():
        calls.append(("restore", saved["step"]))
        return saved["step"]

    rep = sup.run(40, step_fn, save_fn, restore_fn)
    assert rep.steps_done == 40 and rep.restarts == 1
    assert rep.final_mesh == (3, 4)
    assert any("re-meshing" in e for e in rep.events)
    return _report(rep), calls


def supervisor_straggler_path(F):
    em = F.ElasticMesh(pod=1, data=4, model=4, devices_per_host=4)
    mon = F.HeartbeatMonitor(em.n_hosts, timeout_s=1e9, clock=Clock())
    sup = F.TrainingSupervisor(em, mon, ckpt_every=100)
    pol = F.StragglerPolicy(threshold=1.5, patience=2)
    saves = []

    def timings(step):
        return {h: (4.0 if h == 2 and step < 10 else 1.0)
                for h in range(em.n_hosts)}

    rep = sup.run(20, lambda s, p: None, saves.append, lambda: 0,
                  straggler=pol, timings_fn=timings)
    assert 2 in pol.quarantined and rep.final_mesh == (3, 4)
    return _report(rep), saves, pol.quarantined


def supervisor_budget_exhaustion(F):
    em = F.ElasticMesh(pod=1, data=4, model=4, devices_per_host=4)
    mon = F.HeartbeatMonitor(em.n_hosts, timeout_s=1e9, clock=Clock())
    sup = F.TrainingSupervisor(em, mon, ckpt_every=10, max_restarts=2)
    tries = []

    def step_fn(step, plan):
        tries.append(step)
        raise RuntimeError("collective timeout")

    with pytest.raises(RuntimeError, match="collective timeout"):
        sup.run(40, step_fn, lambda s: None, lambda: 0)
    return tries


SCENARIOS = [heartbeat, elastic_drops_rows,
             elastic_partial_pod_and_single_row, elastic_no_rows_raises,
             straggler_policies, supervisor_restart_loop,
             supervisor_straggler_path, supervisor_budget_exhaustion]


@pytest.mark.parametrize("package", sorted(MODULES))
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_holds(scenario, package):
    scenario(MODULES[package])


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_equals_reference(scenario):
    assert scenario(PF) == scenario(RF)


def test_port_exports_the_reference_names():
    from repro_torch import runtime
    for name in ("HeartbeatMonitor", "MeshPlan", "ElasticMesh",
                 "StragglerPolicy", "SupervisorReport", "TrainingSupervisor"):
        assert getattr(runtime, name) is getattr(PF, name)
        assert hasattr(RF, name)
