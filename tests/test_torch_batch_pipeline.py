"""The coordinator-level cases of ``test_pipeline.py`` and
``test_command_plane.py`` on both packages, on the CPU.

Each case runs with ``ra_tpu``'s ``BatchCoordinator``s and again with
``ra_tpu_torch``'s on ``device="cpu"`` (``torch_batch.on_both``): the
stepping drivers with and without ingress rings, an fsync failure and a
torn WAL write injected during the pipelined handoff, an election storm
wider than an ingress lane, and the egress sender thread. Since PR 9
also four full-lane cases of ``test_command_plane.py`` (a client command
rejected with a gate, lossy traffic shed, a peer batch shedding only its
lossy subset, a drainer's own publish diverted) and two single-member
cases of ``test_pipeline.py`` (a stale election trigger dropped, a rare
message processed once), each hand-stepped on one coordinator: their
replies, counters and states must be equal. Cooperatively
stepped clusters must end in equal device state, field for field; the
started clusters under injected faults in equal machine states and
member tables (which member leads after a fault, and how many noops the
churn appended, are races there).
"""

import threading
import time

import pytest

from torch_batch import (await_, close_storage, device_state, on_both,
                         wal_log, wal_storage)

# every field but the leader's optimistic next_index (moved at send time)
COOPERATIVE = (
    "current_term", "voted_for", "commit_index", "last_applied",
    "last_index", "last_term", "written_index", "snapshot_index",
    "snapshot_term", "role", "leader_slot", "self_slot", "machine_version",
    "match_index", "voting", "active", "votes", "pre_votes", "term_suffix",
    "unknown_lo", "unknown_hi", "pre_vote_token",
)
# what a fault's leadership churn leaves alone
STRUCTURAL = ("self_slot", "machine_version", "voting", "active")


def stepper(coords, pipelined):
    """One pass of the cooperative driver: stage every coordinator then
    finish every one, or one ``step_once`` each."""
    if pipelined:
        def step():
            worked = False
            for c in coords:
                worked = c.step_stage() or worked
            for c in coords:
                worked = c.step_finish() or worked
            return worked
    else:
        def step():
            worked = False
            for c in coords:
                worked = c.step_once() or worked
            return worked
    return step


def drive(step, cond, timeout=20.0):
    await_(lambda: (step(), cond())[1], timeout, "the cooperative drive")


def drivers(pkg, tmp, pipelined, rings):
    tag = f"eq{int(pipelined)}{int(rings)}"
    reg = pkg.transport.NodeRegistry()
    coords = [pkg.coord(f"{tag}{i}", capacity=8, num_peers=3, nodes=reg,
                        rings=rings) for i in range(3)]
    ids = [("eg", f"{tag}{i}") for i in range(3)]
    for c in coords:
        c.add_group("eg", f"{tag}cl", ids, pkg.adder())
    step = stepper(coords, pipelined)
    try:
        coords[0].deliver(ids[0], pkg.election(), None)
        drive(step, lambda: coords[0].by_name["eg"].role == pkg.C.R_LEADER)
        for _ in range(5):
            coords[0].deliver(ids[0], pkg.command(1, reply_mode="noreply"), None)
        drive(step, lambda: all(c.by_name["eg"].machine_state == 5
                                for c in coords))
        while step():
            pass
        get = coords[0].counters.get
        return {
            "states": [c.by_name["eg"].machine_state for c in coords],
            "rings_used": get("ingress_ring_msgs") > 0
            and get("ingress_ring_drains") > 0,
            "overlap": get("pipeline_overlap_ns") > 0,
            "device": device_state(pkg, coords, ["eg"], fields=COOPERATIVE),
        }
    finally:
        for c in coords:
            c.stop()


class WalCluster:
    """Three started, pipelined, WAL-backed coordinators hosting one
    group, each WAL and segment writer scoped for failpoints by node."""

    def __init__(self, pkg, tmp, tag, pipeline=True):
        self.pkg = pkg
        self.names = [f"{tag}{i}" for i in range(3)]
        self.coords, self.storage = [], []
        for n in self.names:
            c = pkg.coord(n, capacity=8, num_peers=3, pipeline=pipeline,
                          election_timeout_s=0.15, detector_poll_s=0.05,
                          tick_interval_s=0.2)
            self.storage.append(wal_storage(pkg, tmp, n, c, scope=n))
            self.coords.append(c)
        self.ids = [("wg", n) for n in self.names]
        for c, st in zip(self.coords, self.storage):
            c.add_group("wg", f"{tag}cl", self.ids, pkg.adder(),
                        log=wal_log(pkg, st, "wg"))
            c.start()
        self.coords[0].deliver(self.ids[0], pkg.election(), None)
        self.leader()

    def _leader(self):
        for sid, c in zip(self.ids, self.coords):
            if c.by_name["wg"].role == self.pkg.C.R_LEADER:
                return sid
        return None

    def leader(self):
        return await_(self._leader, what="leader")

    def wal(self, node):
        return self.storage[self.names.index(node)][1]

    def states(self):
        return [c.by_name["wg"].machine_state for c in self.coords]

    def commit_n(self, n, start=0):
        """Commit ``n`` increments through whatever leader is current
        (at least once: a retried command may apply twice)."""
        total = start
        deadline = time.monotonic() + 40
        while total < start + n and time.monotonic() < deadline:
            try:
                r, _ = self.pkg.api.process_command(
                    self.leader(), 1, timeout=5, retry_on_timeout=True)
                total = max(total, r)
            except Exception:  # noqa: BLE001 (mid-heal redirect or maybe)
                time.sleep(0.05)
        assert total >= start + n, f"stalled at {total}"
        return total

    def stop(self):
        for c in self.coords:
            c.stop()
        close_storage(self.storage)


def wal_fault(pkg, tmp, fault, pipeline):
    """A failpoint fired in one node's WAL while commands stream: the
    failed batch is never acked, commits keep flowing on the quorum,
    ``reopen()`` heals, and every replica converges."""
    tag = {"fsync": "pf", "torn": "pt"}[fault] + ("p" if pipeline else "s")
    cl = WalCluster(pkg, tmp, tag, pipeline=pipeline)
    try:
        total = cl.commit_n(2)
        leader = cl.leader()[1]
        if fault == "fsync":  # the leader's WAL: the worst case for acks
            victim = leader
            pkg.faults.arm("wal.fsync", ("raise", "eio"), ("one_shot",),
                           scope=victim)
        else:  # a follower's
            victim = cl.names[1] if leader == cl.names[2] else cl.names[2]
            pkg.faults.arm("wal.write", ("torn", 0.4), ("one_shot",),
                           scope=victim)
        total = cl.commit_n(6, start=total)
        fired = cl.wal(victim).counter.get("failures") >= 1
        await_(lambda: cl.wal(victim).reopen(), timeout=20, what="wal reopen")
        final = cl.commit_n(2, start=total)
        await_(lambda: set(cl.states()) == {final}, what="replicas converge")
        return {
            "fired": fired, "at_least_10": final >= 10,
            "rings_used": sum(c.counters.get("ingress_ring_msgs")
                              for c in cl.coords) > 0,
            "members": [c.by_name["wg"].members for c in cl.coords],
            "device": device_state(pkg, cl.coords, ["wg"], fields=STRUCTURAL),
        }
    finally:
        cl.stop()


def election_storm(pkg, tmp):
    """256 groups elected at once through 64-slot ingress lanes: the
    rare-path fan-out batches per destination, so nothing is shed."""
    reg = pkg.transport.NodeRegistry()
    groups = 256
    coords = [pkg.coord(f"st{i}", capacity=groups, num_peers=3, nodes=reg,
                        idle_sleep_s=0, ingress_ring_slots=64)
              for i in range(3)]
    members = lambda g: [(f"g{g}", f"st{i}") for i in range(3)]  # noqa: E731
    names = [f"g{g}" for g in range(groups)]
    try:
        for c in coords:
            c.add_groups([(f"g{g}", f"stcl{g}", members(g), pkg.adder(), None)
                          for g in range(groups)])
        coords[0].deliver_many([((n, "st0"), pkg.election(), None)
                                for n in names])
        step = stepper(coords, True)
        idle = 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and idle < 100:
            idle = 0 if step() else idle + 1
        return {
            "elected": sum(coords[0].by_name[n].role == pkg.C.R_LEADER
                           for n in names),
            "dropped": [c.transport.dropped for c in coords],
            "device": device_state(pkg, coords, names, fields=COOPERATIVE),
        }
    finally:
        for c in coords:
            c.stop()


def egress_sender(pkg, tmp):
    """On a started pipelined cluster the AER and ack fan-out leaves
    through the sender thread, not the step loop."""
    coords = [pkg.coord(f"es{i}", capacity=4, num_peers=3,
                        election_timeout_s=0.15, detector_poll_s=0.05,
                        tick_interval_s=0.2) for i in range(3)]
    ids = [("sg", f"es{i}") for i in range(3)]
    try:
        for c in coords:
            c.add_group("sg", "escl", ids, pkg.adder())
            c.start()
        coords[0].deliver(ids[0], pkg.election(), None)
        leader = await_(lambda: next(
            (ids[i] for i, c in enumerate(coords)
             if c.by_name["sg"].role == pkg.C.R_LEADER), None), what="leader")
        replies = [pkg.api.process_command(leader, 1, timeout=10)[0]
                   for _ in range(10)]
        await_(lambda: all(c.by_name["sg"].machine_state == 10 for c in coords),
               what="replicas converge")
        return {
            "replies": replies,
            "sender_used": sum(c.counters.get("egress_thread_batches")
                               for c in coords) > 0
            and sum(c.counters.get("egress_thread_msgs") for c in coords) > 0,
            "device": device_state(pkg, coords, ["sg"]),
        }
    finally:
        for c in coords:
            c.stop()


@pytest.mark.parametrize("rings", [True, False])
@pytest.mark.parametrize("pipelined", [False, True])
def test_drivers_commit_identically_with_and_without_rings(tmp_path, pipelined,
                                                           rings):
    out = on_both(drivers, tmp_path, pipelined=pipelined, rings=rings)
    assert out["states"] == [5, 5, 5] and out["overlap"] == pipelined
    if rings:
        assert out["rings_used"]


@pytest.mark.parametrize("pipeline", [True, False])
def test_fsync_failure_during_pipelined_handoff(tmp_path, pipeline):
    out = on_both(wal_fault, tmp_path, fault="fsync", pipeline=pipeline)
    assert out["fired"] and out["at_least_10"] and out["rings_used"]


def test_torn_write_during_pipelined_handoff(tmp_path):
    out = on_both(wal_fault, tmp_path, fault="torn", pipeline=True)
    assert out["fired"] and out["at_least_10"]


def test_election_storm_wider_than_lane_fully_elects(tmp_path):
    out = on_both(election_storm, tmp_path)
    assert out["elected"] == 256 and out["dropped"] == [0, 0, 0]


def test_egress_sender_thread_ships_the_fanout(tmp_path):
    out = on_both(egress_sender, tmp_path)
    assert out["replies"] == list(range(1, 11)) and out["sender_used"]


# -- single-coordinator cases, hand-stepped -------------------------------------


def single(pkg, name, slots=None, **kw):
    """An unstarted one-member coordinator hosting group ``<name>g``."""
    if slots is not None:
        kw["ingress_ring_slots"] = slots
    c = pkg.coord(name, capacity=4, num_peers=1, idle_sleep_s=0,
                  nodes=pkg.transport.NodeRegistry(), **kw)
    sid = (f"{name}g", name)
    c.add_group(sid[0], f"{name}cl", [sid], pkg.adder())
    return c, sid


def elect_single(pkg, c, sid):
    c.deliver(sid, pkg.election(), None)
    for _ in range(50):
        c.step_once()
        if c.by_name[sid[0]].role == pkg.C.R_LEADER:
            return
    raise AssertionError("no leader")


def fill_lane(pkg, c, sid, n=8):
    for _ in range(n):
        assert c.deliver(sid, pkg.command(1, reply_mode="noreply"), None)


def full_ring_rejects(pkg, tmp):
    """test_full_ring_rejects_client_command_with_gate."""
    c, sid = single(pkg, "fr0", slots=8)
    try:
        elect_single(pkg, c, sid)
        base = c.counters.get("commands_rejected")
        fill_lane(pkg, c, sid)
        fut = pkg.api.Future()
        assert c.deliver(sid, pkg.command(1, fut), None)  # rejected, not lost
        assert fut.done() and fut.value[:2] == ("reject", "overloaded")
        gate = fut.value[2]
        assert isinstance(gate, threading.Event) and not gate.is_set()
        rejected = c.counters.get("commands_rejected") - base
        full = c.counters.get("ingress_ring_full")
        c.step_once()
        woken = gate.is_set()
        for _ in range(20):
            c.step_once()
        assert woken and rejected == 1 and full >= 1
        assert c.by_name[sid[0]].machine_state == 8
        return {"reply": fut.value[:2], "rejected": rejected, "full": full,
                "state": c.by_name[sid[0]].machine_state}
    finally:
        c.stop()


def full_ring_sheds_lossy(pkg, tmp):
    """test_full_ring_drops_lossy_protocol_traffic_counted."""
    c, sid = single(pkg, "lp0", slots=8)
    try:
        fill_lane(pkg, c, sid)
        base = c.counters.get("ingress_ring_full")
        ok = c.deliver(sid, pkg.protocol.HeartbeatReply(term=1, query_index=0),
                       (sid[0], "peer"))
        assert ok is False
        assert c.counters.get("ingress_ring_full") == base + 1
        return {"delivered": ok, "full": c.counters.get("ingress_ring_full")}
    finally:
        c.stop()


def full_lane_peer_batch(pkg, tmp):
    """test_full_lane_peer_batch_sheds_only_lossy_subset."""
    c, sid = single(pkg, "ob0", slots=8)
    try:
        elect_single(pkg, c, sid)
        fill_lane(pkg, c, sid)
        shed = c.ingest_batch([
            (sid[0], (sid[0], "peer"),
             pkg.protocol.HeartbeatReply(term=1, query_index=0)),
            (sid[0], None, pkg.command(1, reply_mode="noreply")),
        ])
        overflow = c.counters.get("ingress_overflow_msgs")
        assert shed == 1 and overflow == 1  # only the heartbeat sheds
        for _ in range(20):
            c.step_once()
        assert c.by_name[sid[0]].machine_state == 9
        assert len(c._overflow_q) == 0
        return {"shed": shed, "overflow": overflow,
                "state": c.by_name[sid[0]].machine_state}
    finally:
        c.stop()


def drainer_self_publish(pkg, tmp):
    """test_drainer_self_publish_diverts_to_internal_queue."""
    c, sid = single(pkg, "dq0", slots=8)
    try:
        elect_single(pkg, c, sid)
        fill_lane(pkg, c, sid)
        ident = threading.get_ident()
        c._drainer_idents.add(ident)
        try:
            item = (c._R_CMD, sid[0], pkg.protocol.Command(
                kind=pkg.protocol.USR, data=1, internal=True))
            assert c._publish_blocking(item)  # returns at once
            assert list(c._internal_q) == [item]
        finally:
            c._drainer_idents.discard(ident)
        for _ in range(20):
            c.step_once()
        assert c.by_name[sid[0]].machine_state == 9  # 8 ring + 1 internal
        return {"state": c.by_name[sid[0]].machine_state}
    finally:
        c.stop()


def stale_election_dropped(pkg, tmp):
    """test_stale_election_timeout_is_dropped: a trigger armed before
    the group's last contact is ignored; an unstamped one acts."""
    c, sid = single(pkg, "se0", detector_poll_s=10.0,
                    election_timeout_s=100.0)
    try:
        g = c.by_name[sid[0]]
        c.deliver(sid, pkg.protocol.ElectionTimeout(
            armed_at=g.last_contact - 1.0), None)
        for _ in range(20):
            if not c.step_once():
                break
        assert g.role == pkg.C.R_FOLLOWER and g.term == 0
        after_stale = (g.role, g.term)
        elect_single(pkg, c, sid)
        return {"after_stale": after_stale, "elected": (g.role, g.term)}
    finally:
        c.stop()


def rare_once(pkg, tmp):
    """test_rare_messages_processed_exactly_once: one ElectionTimeout
    runs one election."""
    c, sid = single(pkg, "ro0")
    try:
        g = c.by_name[sid[0]]
        c.deliver(sid, pkg.election(), None)
        c.step_once()
        assert not c._pending_rare, "dispatching pass left its rares parked"
        for _ in range(10):
            c.step_once()
        assert g.role == pkg.C.R_LEADER
        assert g.term == 1, f"one timeout ran {g.term} elections"
        return {"role": g.role, "term": g.term}
    finally:
        c.stop()


@pytest.mark.parametrize("flow", [full_ring_rejects, full_ring_sheds_lossy,
                                  full_lane_peer_batch, drainer_self_publish,
                                  stale_election_dropped, rare_once])
def test_single_coordinator_case_on_both_packages(tmp_path, flow):
    on_both(flow, tmp_path)
