"""Versioned control plane: §6 re-equalization over a lossy channel (port
of ``repro/runtime/control.py``).

``DiSketchSystem`` on its own is an *oracle* control loop: it updates every
fragment's subepoch count in the same host call that observes its PEB, so
directives take effect at once, reliably, and with perfect knowledge of
each switch's residual memory.  Real control channels drop, duplicate,
delay and reorder, and residual memory changes under the controller
(``net.simulator.ResourcePressure``).  This module splits the loop into its
two halves with a ``net.channel.LossyChannel`` between them:

* **Controller** (``VersionedControlPlane``) — observes the PEBs as they
  ride the export path (modelled reliable), computes the Eq. 6 / §6
  intent as the oracle would, and issues monotonically *versioned*
  ``ConfigDirective``s (the switch's n, the width the controller believes
  it has, rho_target) with capped exponential retransmission until they
  are acknowledged.
* **Switch agent** (``SwitchConfigAgent``) — applies the highest directive
  version it has seen (duplicates and stale reorders are no-ops),
  **clamps** the directed n against its *actual* residual width (Eq. 4
  goes as ~1/width, so n is rescaled by believed / actual and rounded to a
  power of two), and ACKs the config it applied.  While its width differs
  from the one its config assumed, it beacons unsolicited NACKs, so the
  controller learns of pressure it never commanded.
* **Reconciliation** — a clamped ACK or a NACK is a divergence report: the
  controller adopts the actual width, converges n against the
  width-corrected PEB (``equalize.converge_n``), and issues a corrective
  directive that carries the right width.  Every dispatch that runs under
  a config other than the controller's intent is a **stale-config
  epoch**, stamped into ``observability``.

The wrapped system runs with ``control_external = True``: it stops
applying Eq. 6 / §6 itself, so ``system.ns`` — and so ``n_log`` and the
parameter tables every query path reads — hold what the switches
*applied*, never the controller's possibly undelivered intent.  A lossy
control channel can make configs stale, but it cannot corrupt counters or
queries.

With lossless channels and the default ``steps_per_dispatch=2``, a
directive issued after dispatch d is applied before dispatch d + 1: the
plane is bit-identical to the oracle loop on a run without churn.

The plane is host Python; the dispatches it wraps run the system's own
kernels.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Set

from ..core import equalize
from ..net.channel import LossyChannel


def _pow2_clamp(x: float) -> int:
    """Nearest power of two in [1, N_MAX] (subepoch counts are pow2)."""
    if not (x > 1.0) or not math.isfinite(x):
        return 1
    e = int(round(math.log2(x)))
    return max(1, min(1 << max(e, 0), equalize.N_MAX))


@dataclass(frozen=True)
class ConfigDirective:
    """One versioned control command to one switch.

    ``version`` is the monotone config epoch: agents apply the highest
    version seen, so duplicated or reordered deliveries are harmless.
    ``width`` is the width the *controller believes* the switch has; the
    agent clamps against its actual width when they differ.  ``seq`` is
    the retransmission attempt: the channel draws a fate per (switch,
    version, seq), so a retry is a second chance.
    """
    switch: int
    version: int
    n_sub: int
    width: int
    rho_target: float
    seq: int = 0

    # the channel's fate identity (net.channel._msg_key reads frag/epoch/seq)
    @property
    def frag(self) -> int:
        return self.switch

    @property
    def epoch(self) -> int:
        return self.version


@dataclass(frozen=True)
class ConfigAck:
    """Switch -> controller: the config *actually applied*.

    Also the unsolicited NACK: ``clamped`` is True while the switch's
    actual width differs from the width its config assumed.  ``seq`` is a
    per-agent monotone counter: every (re-)ACK draws a fresh channel fate,
    and the controller drops reordered stale ACKs by it.
    """
    switch: int
    version: int
    n_applied: int
    width: int
    clamped: bool
    seq: int

    @property
    def frag(self) -> int:
        return self.switch

    @property
    def epoch(self) -> int:
        return self.version


class SwitchConfigAgent:
    """Switch-side config state machine.

    Holds the fragment's applied subepoch count ``n`` and the config
    version it came from.  ``on_directive`` applies highest-version-wins
    with the residual-memory clamp; anything else (a duplicate, a stale
    reorder) re-ACKs the current state, so a lost ACK is repaired in time.
    """

    def __init__(self, switch: int, n0: int, width0: int):
        self.switch = int(switch)
        self.version = 0
        self.n = int(n0)
        # the width the applied config assumed; a different actual width
        # starts the NACK beacon
        self.assumed_width = int(width0)
        self._ack_seq = 0
        self.n_applied_directives = 0
        self.n_stale_dropped = 0
        self.n_clamped = 0

    def on_directive(self, d: ConfigDirective,
                     actual_width: int) -> ConfigAck:
        if d.version > self.version:
            self.version = d.version
            n = int(d.n_sub)
            if d.width != actual_width:
                # the directive was computed for d.width columns; Eq. 4
                # goes as ~1/width, so rescale n by believed / actual
                n = _pow2_clamp(d.n_sub * d.width / actual_width)
                self.n_clamped += 1
            self.n = n
            self.assumed_width = int(d.width)
            self.n_applied_directives += 1
        else:
            self.n_stale_dropped += 1
        return self.ack(actual_width)

    def ack(self, actual_width: int) -> ConfigAck:
        """The applied state, as a fresh-fated ACK/NACK message."""
        self._ack_seq += 1
        return ConfigAck(self.switch, self.version, self.n,
                         int(actual_width),
                         int(actual_width) != self.assumed_width,
                         self._ack_seq)

    def local_sync(self, n: int, width: int) -> None:
        """A state change the switch made itself (a recover restarts the
        fragment at n_0 = 1): adopt it as the applied config and stop
        treating the width as diverged.  The rejoin beacon rides the
        reliable boot path, not the lossy channel."""
        self.n = int(n)
        self.assumed_width = int(width)


@dataclass
class _CtrlEntry:
    """Controller-side bookkeeping of one switch."""
    version: int = 0            # highest directive version issued
    directed_n: int = 1         # the n the newest directive commands
    believed_width: int = 0     # the width the controller believes
    acked_version: int = 0
    acked_n: int = 1
    acked_seq: int = 0
    attempts: int = 0
    next_send: int = 0
    outstanding: Optional[ConfigDirective] = None


class VersionedControlPlane:
    """Controller and lossy control channel around a ``DiSketchSystem``.

    Duck-typed as the system it wraps (``run_epoch``, ``run_window``,
    ``query_flows``, ``query_entropy``, ``fleet``, ``fragments``,
    ``records``, ``kind``, ``backend``), so ``Replayer.run(plane,
    window=E, failures=schedule)`` drives it unchanged.

    Parameters
    ----------
    inner : DiSketchSystem, or an object carrying one as ``.system``
        Must be a subepoching system (DISCO has no control loop).
    channel, ack_channel : LossyChannel
        The directive and the ACK/NACK paths (default: lossless).
    steps_per_dispatch : int
        Protocol rounds after each dispatch.  The default 2 is just
        enough for a lossless directive to land before the next dispatch
        (sent at round +1, delivered at +2): the oracle-identical
        setting.  0 leaves time to ``step``/``drain``.
    max_retries, backoff0, backoff_max :
        Directive retransmission (capped exponential backoff).
    nack_interval : int
        Least rounds between a switch's unsolicited divergence NACKs.
    """

    def __init__(self, inner, channel: Optional[LossyChannel] = None,
                 ack_channel: Optional[LossyChannel] = None, *,
                 steps_per_dispatch: int = 2, max_retries: int = 8,
                 backoff0: int = 1, backoff_max: int = 8,
                 nack_interval: int = 2):
        system = getattr(inner, "system", inner)
        if not getattr(system, "subepoching", False):
            raise ValueError(
                "VersionedControlPlane needs a subepoching system; "
                f"{getattr(system, 'name', type(system).__name__)!r} has "
                "no Eq. 6 control loop to distribute")
        if max_retries < 0 or backoff0 < 1 or backoff_max < backoff0:
            raise ValueError("need max_retries >= 0 and "
                             "1 <= backoff0 <= backoff_max")
        self.inner = inner
        self.system = system
        self.system.control_external = True
        self.channel = channel if channel is not None else LossyChannel()
        self.ack_channel = (ack_channel if ack_channel is not None
                            else LossyChannel())
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.max_retries = int(max_retries)
        self.backoff0 = int(backoff0)
        self.backoff_max = int(backoff_max)
        self.nack_interval = max(1, int(nack_interval))
        self.rho = float(system.rho_target)
        self.agents: Dict[int, SwitchConfigAgent] = {}
        self.entries: Dict[int, _CtrlEntry] = {}
        for sw, cfg in system.fragments.items():
            n0, w0 = int(system.ns[sw]), int(cfg.width)
            self.agents[sw] = SwitchConfigAgent(sw, n0, w0)
            self.entries[sw] = _CtrlEntry(directed_n=n0, believed_width=w0,
                                          acked_n=n0)
        self.now = 0
        self._known_dead: Set[int] = set(system.dead)
        self._next_nack: Dict[int, int] = {sw: 0 for sw in self.agents}
        # per dispatch: the config the switches ran (mirrors n_log) and
        # the controller's intent standing when the next dispatch runs
        self.applied_log: List[Dict[int, int]] = []
        self.intent_log: List[Dict[int, int]] = []
        # epoch -> switches that ran a config other than the intent
        self._epoch_stale: Dict[int, List[int]] = {}
        # controller-side clamp reconciliations (intended vs adopted)
        self.clamp_log: List[Dict] = []
        self.n_directives = 0
        self.n_acks_rx = 0
        self.n_stale_acks = 0
        self.n_nacks_tx = 0
        self.last_observability: Optional[dict] = None

    # -- the system's face -------------------------------------------------

    @property
    def fleet(self):
        return self.inner.fleet

    @property
    def fragments(self):
        return self.inner.fragments

    @property
    def records(self):
        return self.inner.records

    @property
    def kind(self):
        return self.inner.kind

    @property
    def backend(self):
        return self.system.backend

    # -- dispatches --------------------------------------------------------

    def run_epoch(self, epoch: int, streams, packet=None, events=None
                  ) -> None:
        self._pre_dispatch([epoch])
        frozen = self._frozen_ns(events)
        self.inner.run_epoch(epoch, streams, packet=packet, events=events)
        self._post_dispatch(1, frozen)

    def run_window(self, epoch0: int, streams_list, packets=None,
                   events_by_epoch=None) -> None:
        self._pre_dispatch(range(epoch0, epoch0 + len(streams_list)))
        frozen = self._frozen_ns(
            events_by_epoch[0] if events_by_epoch else None)
        self.inner.run_window(epoch0, streams_list, packets=packets,
                              events_by_epoch=events_by_epoch)
        self._post_dispatch(len(streams_list), frozen)

    def _frozen_ns(self, first_events) -> Dict[int, int]:
        """The per-switch config this dispatch runs: the agents' applied n,
        and n_0 = 1 for a recover in its first epoch (it restarts the
        fragment before ``ns`` is frozen).  A recover later in a window
        lands after the freeze, so the dispatch keeps the old n."""
        frozen = {sw: a.n for sw, a in self.agents.items()}
        for ev in (first_events or ()):
            if (getattr(ev, "kind", None) == "recover"
                    and ev.switch in self.system.dead):
                frozen[ev.switch] = 1
        return frozen

    def _pre_dispatch(self, epochs: Sequence[int]) -> None:
        """Load every agent's applied config into the system, and record
        the epochs about to run stale (applied != intent)."""
        stale = sorted(sw for sw, a in self.agents.items()
                       if sw not in self.system.dead
                       and a.n != self.entries[sw].directed_n)
        if stale:
            for e in epochs:
                self._epoch_stale[int(e)] = stale
        for sw, agent in self.agents.items():
            self.system.ns[sw] = agent.n

    def _post_dispatch(self, n_epochs: int,
                       frozen: Dict[int, int]) -> None:
        """Observe the dispatch (its PEBs ride the export path), compute
        the Eq. 6 / §6 intent, issue directives, run the protocol
        rounds."""
        # switch-local changes (a recover resets its fragment to n_0 = 1
        # inside the dispatch): sync the agent and the controller's belief
        for sw, agent in self.agents.items():
            n_actual = int(self.system.ns[sw])
            if n_actual != agent.n:
                w = int(self.system.fragments[sw].width)
                agent.local_sync(n_actual, w)
                ent = self.entries[sw]
                ent.directed_n = n_actual
                ent.believed_width = w
                ent.outstanding = None
        self.applied_log.append(dict(frozen))
        new_dead = set(self.system.dead) - self._known_dead
        self._known_dead = set(self.system.dead)
        for sw in new_dead:
            self.entries[sw].outstanding = None   # the directive is moot
        # a directive that spent its retry budget is re-issued under a
        # fresh version (and budget): staleness is bounded by the retry
        # latency, never permanent
        for sw, ent in self.entries.items():
            if (sw not in self.system.dead and ent.outstanding is not None
                    and ent.attempts > self.max_retries):
                self._direct(sw, ent.directed_n)
        # the Eq. 6 intent: walk the dispatch's per-epoch PEBs from the
        # config it ran, as the oracle does
        base = self.system.n_log[-1]
        windows = self.system.peb_log[-n_epochs:]
        intent: Dict[int, int] = {}
        for sw in self.agents:
            if sw in self.system.dead:
                continue
            n = int(base.get(sw, self.agents[sw].n))
            for pebs in windows:
                if sw in pebs:
                    n = equalize.next_n(n, pebs[sw], self.rho)
            intent[sw] = n
        if new_dead:
            # §6 re-equalization: the survivors jump to their converged
            # setting in one control step (the oracle's
            # _reequalize_survivors, issued over the wire), against the
            # *believed* width; the switch clamps
            last = self.system._last_pebs()
            for sw in list(intent):
                peb = last.get(sw)
                w_obs = self.system._peb_width.get(sw)
                if peb is None or peb <= 0 or w_obs is None:
                    continue
                w_bel = self.entries[sw].believed_width
                intent[sw] = equalize.converge_n(
                    intent[sw], peb * (w_obs / w_bel), self.rho)
        for sw, n in intent.items():
            if n != self.entries[sw].directed_n:
                self._direct(sw, n)
        for _ in range(self.steps_per_dispatch):
            self.step()
        # logged after the rounds, since reconciliation may revise the
        # intent: this is the intent standing when the next dispatch runs
        self.intent_log.append({sw: self.entries[sw].directed_n
                                for sw in self.agents})

    def _direct(self, sw: int, n: int,
                width: Optional[int] = None) -> None:
        ent = self.entries[sw]
        if width is not None:
            ent.believed_width = int(width)
        ent.version += 1
        ent.directed_n = int(n)
        ent.outstanding = ConfigDirective(sw, ent.version, int(n),
                                          ent.believed_width, self.rho)
        ent.attempts = 0
        ent.next_send = self.now
        self.n_directives += 1

    # -- protocol rounds ---------------------------------------------------

    def step(self) -> None:
        """One control round: send the due directives, deliver them to the
        agents (which ACK), beacon width-divergence NACKs, deliver the ACKs
        and reconcile."""
        self.now += 1
        for sw in sorted(self.entries):
            ent = self.entries[sw]
            if (ent.outstanding is None or ent.next_send > self.now
                    or ent.attempts > self.max_retries):
                continue
            self.channel.send(replace(ent.outstanding, seq=ent.attempts),
                              self.now)
            ent.attempts += 1
            ent.next_send = self.now + min(
                self.backoff0 * (1 << (ent.attempts - 1)), self.backoff_max)
        for d in self.channel.deliver(self.now):
            agent = self.agents[d.switch]
            w = int(self.system.fragments[d.switch].width)
            self.ack_channel.send(agent.on_directive(d, w), self.now)
        for sw, agent in self.agents.items():
            if sw in self.system.dead or self.now < self._next_nack[sw]:
                continue
            w = int(self.system.fragments[sw].width)
            if w != agent.assumed_width:
                self.ack_channel.send(agent.ack(w), self.now)
                self.n_nacks_tx += 1
                self._next_nack[sw] = self.now + self.nack_interval
        for ack in self.ack_channel.deliver(self.now):
            self._reconcile(ack)

    def _reconcile(self, ack: ConfigAck) -> None:
        """Fold one ACK/NACK into the controller's state; on divergence,
        converge against the width-corrected PEB and adopt the switch's
        clamped config or issue a corrective directive."""
        self.n_acks_rx += 1
        ent = self.entries[ack.switch]
        if ack.seq <= ent.acked_seq:
            self.n_stale_acks += 1      # a reordered stale ACK
            return
        ent.acked_seq = ack.seq
        ent.acked_version = max(ent.acked_version, ack.version)
        ent.acked_n = ack.n_applied
        w_actual = int(ack.width)
        diverged = w_actual != ent.believed_width or ack.clamped
        ent.believed_width = w_actual
        if (ent.outstanding is not None and ack.version >= ent.version
                and ack.n_applied == ent.directed_n):
            ent.outstanding = None      # delivered and applied verbatim
        if not diverged:
            return
        # the residual width is not what the config assumed: converge
        # again against the corrected Eq. 4 bound
        peb = self.system._last_pebs().get(ack.switch)
        w_obs = self.system._peb_width.get(ack.switch)
        if peb is not None and peb > 0 and w_obs:
            n_target = equalize.converge_n(
                ack.n_applied, peb * (w_obs / w_actual), self.rho)
        else:
            n_target = ack.n_applied
        # issue the corrective directive unless a retransmission with
        # budget left already carries this n: an agent behind on versions
        # with a spent outstanding directive would otherwise beacon
        # forever with nothing in flight to stop it
        if (n_target != ent.directed_n or ack.version >= ent.version
                or ent.outstanding is None
                or ent.attempts > self.max_retries):
            if n_target != ent.directed_n:
                self.clamp_log.append({
                    "switch": ack.switch, "at_round": self.now,
                    "n_intended": ent.directed_n, "n_applied": ack.n_applied,
                    "n_reconciled": n_target, "width_actual": w_actual})
            # the corrective directive carries the actual width, which
            # stops the agent's NACK beacon once applied
            self._direct(ack.switch, n_target, width=w_actual)

    def _quiescent(self) -> bool:
        if self.channel.pending() or self.ack_channel.pending():
            return False
        if any(ent.outstanding is not None
               and ent.attempts <= self.max_retries
               for ent in self.entries.values()):
            return False
        return not any(
            sw not in self.system.dead
            and int(self.system.fragments[sw].width) != a.assumed_width
            for sw, a in self.agents.items())

    def drain(self, max_rounds: int = 10_000) -> int:
        """Run control rounds until every directive is settled, both
        channels are empty and no agent beacons divergence; returns the
        round.  Raises if the plane does not quiesce (a directive/clamp
        ping-pong is a fault, not a steady state)."""
        for _ in range(max_rounds):
            if self._quiescent():
                return self.now
            self.step()
        stuck = {sw: ent.outstanding for sw, ent in self.entries.items()
                 if ent.outstanding is not None}
        raise RuntimeError(
            f"control plane failed to drain within {max_rounds} rounds "
            f"(channel={self.channel.stats()}, outstanding={stuck})")

    # -- staleness accounting ----------------------------------------------

    def stale_epochs(self) -> List[int]:
        """Epochs that ran under a config other than the controller's
        intent at dispatch time (each lasted as long as the directive's
        latency)."""
        return sorted(self._epoch_stale)

    def version_lag(self) -> Dict[int, int]:
        """Per switch: how many directive versions the controller is ahead
        of the last acknowledged one."""
        return {sw: ent.version - ent.acked_version
                for sw, ent in self.entries.items()}

    def observability(self, epochs: Sequence[int]) -> dict:
        eset = {int(e) for e in epochs}
        out = dict(self.inner.observability(epochs))
        stale = sorted(e for e in self._epoch_stale if e in eset)
        out["stale_config"] = stale
        out["n_stale_config"] = len(stale)
        out["stale_config_switches"] = {e: list(self._epoch_stale[e])
                                        for e in stale}
        out["config_version_lag"] = self.version_lag()
        out["config_clamps"] = (list(self.system.clamp_log)
                                + list(self.clamp_log))
        return out

    def query_flows(self, keys, paths, epochs, **kw):
        self.last_observability = self.observability(epochs)
        return self.inner.query_flows(keys, paths, epochs, **kw)

    def query_entropy(self, keys, paths, epochs, total, **kw):
        self.last_observability = self.observability(epochs)
        return self.inner.query_entropy(keys, paths, epochs, total, **kw)

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        out = {
            "now": self.now,
            "n_directives": self.n_directives,
            "n_acks_rx": self.n_acks_rx,
            "n_stale_acks": self.n_stale_acks,
            "n_nacks_tx": self.n_nacks_tx,
            "n_outstanding": sum(1 for e in self.entries.values()
                                 if e.outstanding is not None),
            "n_stale_epochs": len(self._epoch_stale),
            "n_clamps": len(self.clamp_log),
            "max_version_lag": max(self.version_lag().values(), default=0),
            "channel": self.channel.stats(),
            "ack_channel": self.ack_channel.stats(),
        }
        inner_stats = getattr(self.inner, "stats", None)
        if callable(inner_stats):
            out["export"] = inner_stats()
        return out
