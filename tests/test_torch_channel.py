"""The port's lossy channel (``repro_torch.net.channel``) against the JAX
package's (``repro.net.channel``).

Both are host numpy: each message's fate comes from a generator seeded
with ``(channel seed, frag, epoch, seq)``, and the port takes its draws in
the reference's order.  So the same sends, on the same rounds, must give
the same deliveries in the same order, the same in-flight queue and the
same counters, exactly.
"""
from dataclasses import dataclass

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.net.channel import LossyChannel as RChannel
from repro.net.channel import _msg_key as r_msg_key
from repro_torch.net.channel import LossyChannel, _msg_key


@dataclass(frozen=True)
class Msg:
    frag: int
    epoch: int
    seq: int
    tag: int


def traffic(seed, n_msgs=120, n_rounds=40):
    """Seeded sends: ``{round: [Msg]}`` over ``n_rounds`` rounds, with
    repeated (frag, epoch) identities and retransmission seqs."""
    rng = np.random.default_rng(seed)
    sends = {}
    for tag in range(n_msgs):
        msg = Msg(int(rng.integers(0, 8)), int(rng.integers(0, 6)),
                  int(rng.integers(0, 4)), tag)
        sends.setdefault(int(rng.integers(0, n_rounds)), []).append(msg)
    return sends


def replay(channel, sends, n_rounds):
    """Send and deliver round by round; returns ``[(round, [tags])]``,
    the in-flight queue at the horizon, and the counters."""
    log = []
    for now in range(n_rounds):
        for msg in sends.get(now, ()):
            channel.send(msg, now)
        log.append((now, [m.tag for m in channel.deliver(now)]))
    inflight = [(r, m.tag) for r, m in channel.undelivered()]
    return log, inflight, channel.stats()


def assert_same(kw, sends, n_rounds):
    got = replay(LossyChannel(**kw), sends, n_rounds)
    want = replay(RChannel(**kw), sends, n_rounds)
    assert got == want


@pytest.mark.parametrize("delay", [(0, 0), (0, 1), (1, 3)],
                         ids=["d00", "d01", "d13"])
@pytest.mark.parametrize("p_reorder", [0.0, 0.3, 1.0],
                         ids=["r0", "r03", "r1"])
@pytest.mark.parametrize("p_drop,p_dup", [(0.0, 0.0), (0.4, 0.2),
                                          (0.2, 0.5), (1.0, 0.0)],
                         ids=["lossless", "d04u02", "d02u05", "blackhole"])
def test_channel_matches_reference(p_drop, p_dup, p_reorder, delay):
    kw = dict(p_drop=p_drop, p_dup=p_dup, p_reorder=p_reorder, delay=delay,
              seed=17)
    sends = traffic(seed=int(100 * p_drop + 10 * p_dup + 7 * p_reorder)
                    + delay[1])
    # the horizon stops early enough that some messages stay in flight
    assert_same(kw, sends, n_rounds=38)


@settings(deadline=None, max_examples=40)
@given(st.floats(0.0, 1.0), st.floats(0.0, 1.0), st.floats(0.0, 1.0),
       st.integers(0, 3), st.integers(0, 3), st.integers(0, 2 ** 32 - 1),
       st.integers(0, 2 ** 16))
def test_channel_matches_reference_property(p_drop, p_dup, p_reorder, lo,
                                            span, seed, traffic_seed):
    kw = dict(p_drop=p_drop, p_dup=p_dup, p_reorder=p_reorder,
              delay=(lo, lo + span), seed=seed)
    assert_same(kw, traffic(traffic_seed, n_msgs=60, n_rounds=20), 24)


def test_fate_is_order_independent_and_clear_counts_the_wire():
    sends = traffic(5, n_msgs=30, n_rounds=1)[0]
    kw = dict(p_drop=0.3, p_dup=0.3, p_reorder=0.5, delay=(0, 2), seed=4)
    a, b, r = LossyChannel(**kw), LossyChannel(**kw), RChannel(**kw)
    for msg in sends:
        a.send(msg, 0)
        r.send(msg, 0)
    for msg in reversed(sends):
        b.send(msg, 0)
    # the same messages in another order: the same fates and rounds
    assert sorted((t, m.tag) for t, m in a.undelivered()) == \
        sorted((t, m.tag) for t, m in b.undelivered())
    assert a.stats() == b.stats() == r.stats()
    assert a.clear() == r.clear() == a.stats()["n_sent"] \
        - a.stats()["n_dropped"] + a.stats()["n_dup"]
    assert a.pending() == 0 and a.deliver(100) == []


def test_msg_key_matches_reference():
    for msg in (Msg(3, 9, 2, 0), object(), 7):
        assert _msg_key(msg) == r_msg_key(msg)


@pytest.mark.parametrize("kw", [
    dict(p_drop=-0.1), dict(p_drop=1.5), dict(p_dup=2.0),
    dict(p_reorder=-1e-9), dict(delay=(-1, 0)), dict(delay=(3, 2))],
    ids=["drop<0", "drop>1", "dup>1", "reorder<0", "delay<0",
         "delay-inverted"])
def test_channel_validation_errors(kw):
    with pytest.raises(ValueError) as want:
        RChannel(**kw)
    with pytest.raises(ValueError) as got:
        LossyChannel(**kw)
    assert str(got.value) == str(want.value)
