"""The failover of every group at once, on both packages, on the CPU:
the node that leads all of them stops and the survivors' node-down
election triggers (with the suspicion sweep beside them) re-elect the
fleet, on ``ra_tpu`` and on ``ra_tpu_torch`` (its coordinators on
``device="cpu"``). A survivor of the reference arms one
``threading.Timer`` a followed group; the port's arms them all on one
timer thread, with the same delays and ``armed`` stamps, and closes it
in ``stop()``.

The scenarios live in ``tests/failover_cases.py``, which
``chip_smoke.py`` also runs on the card. Waits are on state.
"""

import pytest
import torch

import failover_cases as FC
import lane_cases as L
from torch_batch import PACKAGES, clear_both

torch.set_num_threads(1)

GROUPS = 64


@pytest.fixture
def both_clear():
    clear_both()
    yield
    clear_both()


@pytest.mark.parametrize("name", PACKAGES)
def test_every_group_fails_over_when_the_leader_node_stops(name, both_clear):
    """(a) 64 groups x 3, all led by node 0, which stops: both packages
    lead every group again on the survivors, through the node-down
    triggers or the sweep, and hold every acknowledged write on both
    survivors; the port's survivors add at most one thread each."""
    lane = L.Lane(name)
    rec = FC.leader_failover(lane, groups=GROUPS, seed=12)
    seen = {k: v for k, v in rec.items()
            if k not in ("states", "expect", "leaders")}
    assert rec["states"] == [rec["expect"]] * 2
    assert sorted(set(rec["leaders"])) <= [1, 2]
    assert sum(rec["elected_by"].values()) == GROUPS
    assert set(rec["elected_by"]) <= {"trigger", "sweep"}, seen
    # each survivor armed a trigger for every group it followed, and
    # each was delivered, none refused
    assert rec["armed"] == 2 * GROUPS, seen
    assert rec["delivered"]["trigger"] == 2 * GROUPS, seen
    assert rec["shed"] == 0, seen
    assert rec["term"] >= 2, seen
    assert rec["detect_s"] is not None and rec["first_trigger_s"] is not None
    grown = rec["peak_threads"] - rec["threads_before"]
    if lane.torch:
        assert grown <= 2, seen
    else:
        assert grown >= GROUPS, seen


@pytest.mark.parametrize("name", PACKAGES)
def test_node_down_triggers_keep_their_delays_and_armed_stamps(
        name, both_clear):
    """(b) a follower of 64 groups whose leader node is seen down: the
    port's call starts one thread where the reference's starts one a
    group; on both, each delay is drawn as election_timeout_s * (1 +
    random.random()) in group order, lies in [T, 2T), and every trigger
    carries the detection time as its armed stamp, waits its delay and
    opens a round, also those that found the follower's lane full."""
    lane = L.Lane(name)
    T = 1.0
    rec = FC.node_down_triggers(lane, groups=GROUPS, election_timeout_s=T,
                                ring_slots=16)
    if lane.torch:
        assert rec["new_threads"] == ["ra-timers"]
        # one producer: once its 16-slot lane is full, the triggers
        # ride the overflow queue (the later ones without trying the
        # lane, to keep their order), never shed
        assert rec["counters"]["ingress_ring_full"] >= 1, rec["counters"]
        assert rec["counters"]["ingress_overflow_msgs"] >= GROUPS - 16
    else:
        # a lane a Timer thread: none fills
        assert len(rec["new_threads"]) == GROUPS
        assert rec["counters"]["ingress_overflow_msgs"] == 0
    assert all(T <= d < 2 * T for d in rec["want"])
    assert rec["armed"] == [rec["detected_at"]]
    assert rec["early"] == []
    # delivered within half an election timeout after its delay: a draw
    # other than the reference's would miss by more
    assert rec["late_s"] < 0.5 * T, rec["late_s"]
    # nothing heard from the leader: every trigger opened a round
    assert rec["roles"] == [lane.C.R_PRE_VOTE]
    assert rec["rounds"] == GROUPS
    assert rec["alive_after_stop"] == []


@pytest.mark.parametrize("name", PACKAGES)
def test_trigger_is_dropped_when_the_leader_is_heard_during_the_delay(
        name, both_clear):
    """(c) the leader commits to the follower after the detection and
    before the triggers are due: the staleness guard drops every
    trigger, so no group opens a round and all stay followers."""
    lane = L.Lane(name)
    T = 2.0
    rec = FC.node_down_triggers(lane, groups=GROUPS, election_timeout_s=T,
                                contact=True)
    assert rec["contact_s"] < T, "contact came after the triggers were due"
    assert rec["armed"] == [rec["detected_at"]]
    assert rec["early"] == []
    assert rec["roles"] == [lane.C.R_FOLLOWER]
    assert rec["rounds"] == 0


def test_stop_before_the_deadlines_delivers_nothing(both_clear):
    """(d) on the port: stop() right after the triggers were armed
    closes the timer thread, and no trigger is delivered."""
    rec = FC.node_down_triggers(L.Lane("ra_tpu_torch"), groups=GROUPS,
                                stop_early=True)
    assert rec["new_threads"] == ["ra-timers"]
    assert rec["delivered_after_stop"] == 0
    assert rec["alive_after_stop"] == []
