"""The failover of every group at once, on both packages, on the CPU:
the node that leads all of them stops and the survivors' node-down
election triggers (with the suspicion sweep beside them) re-elect the
fleet, on ``ra_tpu`` and on ``ra_tpu_torch`` (its coordinators on
``device="cpu"``). A survivor of the reference arms one
``threading.Timer`` a followed group; the port's arms them all on one
timer thread, with the same delays and ``armed`` stamps, and closes it
in ``stop()``.

After the failover, the stopped node restarts from its own storage,
and then it is lost for good and replaced in every group by a fresh
node that joins as a non-voter and is promoted once caught up; one
hand-stepped group shows that the joining non-voter, in the slot the
leaver left, counts in no quorum before its promotion.

The scenarios live in ``tests/failover_cases.py``, which
``chip_smoke.py`` also runs on the card. Waits are on state.
"""

import importlib

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


def _restart(name, tmp_path):
    """fail_over then restart_rejoin at 64 groups x 3 on one package,
    WAL-backed, a meta store a node."""
    lane = L.Lane(name)
    names = [f"rr{i}" for i in range(3)]
    disk = FC.Disk(lane, str(tmp_path / name), names, GROUPS)
    third = [v % 97 + 1 for v in range(GROUPS)]

    def then(coords, totals):
        return FC.restart_rejoin(lane, coords, disk, totals, third)

    try:
        rec = FC.leader_failover(
            lane, prefix="rr", groups=GROUPS, seed=15, logs=disk.open_all,
            metas=[disk.open_meta(i) for i in range(3)], then=then)
    finally:
        disk.close_all()
    return lane, rec


def test_stopped_leader_node_restarts_from_disk_and_rejoins(tmp_path,
                                                            both_clear):
    """(e) after (a) with WAL-backed logs and a meta store a node, node
    0 comes back from its own WAL, segments and meta store on both
    packages: every group's replica on node 0 follows the survivors'
    leader at its total, none sits below the term its meta store held,
    no group of it votes or opens a pre-vote round while the leaders
    are live, no survivor's term moves, and one more command a group
    reaches all three replicas. What the disk holds is deterministic,
    so the two packages recover the same tails, read back the same
    terms and votes, and end with the same machine states."""
    recs = {}
    for name in PACKAGES:
        lane, rec = _restart(name, tmp_path)
        rr = rec["then"]
        seen = {k: v for k, v in rr.items()
                if k not in ("states", "expect", "leaders", "meta",
                             "recovered")}
        assert rr["states"] == [rr["expect"]] * 3, seen
        assert sorted(set(rr["leaders"])) <= [1, 2], seen
        assert rr["below_meta"] == 0, seen
        assert rr["term"] >= rr["meta_term"] >= 1, seen
        assert rr["votes"] == {"granted": 0, "candidate": 0}, seen
        assert rr["pre_vote_rounds"] == 0, seen
        assert rr["survivor_term_after"] == rr["survivor_term_before"], seen
        assert rr["first_aer_s"] is not None, seen
        assert (rr["close_s"] <= rr["reopen_s"] <= rr["logs_s"]
                <= rr["add_groups_s"] <= rr["started_s"] <= rr["recover_s"]
                <= rr["settled_s"]), seen
        # the elections on node 0 before its stop persisted each
        # group's term and self-vote
        node0 = ("rr0",)
        assert all(v is not None and tuple(v[1:]) == node0
                   for _t, v in rr["meta"]), rr["meta"]
        recs[name] = {k: rr[k] for k in ("recovered", "meta", "states")}
    assert recs["ra_tpu"] == recs["ra_tpu_torch"]


def _sync_order(name, tmp_path, groups=GROUPS):
    """Three hand-stepped coordinators on a ManualClock, each with a
    meta store that records its fdatasyncs and which groups' records
    are stored but not yet synced, and a send hook that notes every
    vote request or reply that leaves while its group's term and vote
    are not yet durable. Every group is elected on node 0, then node 1
    takes every group over by one ``TimeoutNow`` each (one rare pass).
    Returns the fdatasyncs by node in each of the two elections, the
    steps they took and the early messages."""
    lane = L.Lane(name)
    FileMeta = importlib.import_module(f"{name}.log.meta_store").FileMeta
    P = lane.protocol
    votes = (P.RequestVoteRpc, P.RequestVoteResult)

    class RecordingMeta(FileMeta):
        def __init__(self, path):
            self.pending, self.fsyncs = set(), 0
            super().__init__(path)

        def store(self, uid, key, value):
            super().store(uid, key, value)
            self.pending.add(uid)

        def store_sync(self, uid, key, value):
            super().store_sync(uid, key, value)
            self.fsyncs += 1
            self.pending.clear()  # one fdatasync covers every record

        def sync(self):
            self.fsyncs += bool(self._dirty)
            super().sync()
            self.pending.clear()

    clock = L.ManualClock()
    names = [f"so{i}" for i in range(3)]
    gname = [f"g{g}" for g in range(groups)]
    metas = [RecordingMeta(str(tmp_path / name / n / "meta.dat"))
             for n in names]
    coords = [lane.coord(n, capacity=groups, num_peers=3, clock=clock,
                         meta=m) for n, m in zip(names, metas)]
    early = []

    def watch(c, meta):
        send = c._send_batch

        def spy(node_name, msgs):
            for to, msg, frm in msgs:
                if isinstance(msg, votes) and f"cl{frm[0][1:]}_{frm[0]}" \
                        in meta.pending:
                    early.append((c.name, frm[0], type(msg).__name__))
            return send(node_name, msgs)

        c._send_batch = spy

    rec = {}
    try:
        for c, m in zip(coords, metas):
            c.add_groups([(n, f"cl{g}", [(n, x) for x in names],
                           lane.adder()) for g, n in enumerate(gname)])
            watch(c, m)
        for i, (target, msg) in enumerate((
                (0, P.ElectionTimeout), (1, P.TimeoutNow))):
            f0, s0 = [m.fsyncs for m in metas], [c.steps for c in coords]
            for n in gname:
                coords[target].deliver((n, names[target]), msg(), None)
            by = coords[target].by_name
            L.step_until(coords, lambda: all(
                by[n].role == lane.C.R_LEADER for n in gname),
                what=f"leaders on node {target}")
            rec[i] = {"fsyncs": [m.fsyncs - f for m, f in zip(metas, f0)],
                      "steps": [c.steps - s for c, s in zip(coords, s0)]}
    finally:
        for c in coords:
            c.stop()
        for m in metas:
            m.close()
    rec["early"] = early
    return rec


@pytest.mark.parametrize("name", PACKAGES)
def test_term_and_vote_are_durable_before_any_vote_message_leaves(
        name, tmp_path, both_clear):
    """(f) the meta store's rule, on a node's pre-vote election and on
    a forced takeover (TimeoutNow) of every group: no vote request or
    reply leaves before its group's term and vote are synced. The
    reference syncs once a group; the port once for each pass that
    changed a term or vote, so fewer times than its steps."""
    rec = _sync_order(name, tmp_path)
    assert rec["early"] == [], rec["early"][:5]
    for i in (0, 1):
        fs, steps = rec[i]["fsyncs"], rec[i]["steps"]
        # the candidate's and at least one voter's term and vote moved
        # in every group
        assert fs[i] >= 1 and sum(1 for f in fs if f) >= 2, rec
        if name == "ra_tpu":
            assert set(fs) <= {0, GROUPS}, rec
        else:
            assert all(f <= s < GROUPS for f, s in zip(fs, steps)), rec


def _replace(name, tmp_path):
    """fail_over, restart_rejoin, then replace_node at 64 groups x 3 on
    one package, WAL-backed, a meta store a node (node 3's too)."""
    lane = L.Lane(name)
    names = [f"rp{i}" for i in range(4)]
    disk = FC.Disk(lane, str(tmp_path / name), names, GROUPS)
    rng = [v % 89 + 1 for v in range(GROUPS)]
    third, fourth = rng, [v % 31 + 2 for v in range(GROUPS)]

    def then(coords, totals):
        rr = FC.restart_rejoin(lane, coords, disk, totals, third)
        return FC.replace_node(lane, coords, disk, rr["expect"], fourth,
                               names[3], api_sample=16, clients=8)

    try:
        rec = FC.leader_failover(
            lane, prefix="rp", groups=GROUPS, seed=16, logs=disk.open_all,
            metas=[disk.open_meta(i) for i in range(3)], then=then)
    finally:
        disk.close_all()
    return lane, rec


def test_lost_node_is_replaced_by_a_fresh_node_in_every_group(tmp_path,
                                                              both_clear):
    """(g) after (a) and (e), node 0 is lost for good and replaced on
    both packages: it is shrunk out of every group through the group's
    leader (16 groups through ``api.remove_member``), a fresh node 3
    joins every group as a non-voter (16 through ``api.add_member``), is
    caught up by append with no install and promoted, and one more
    command a group reaches nodes 1, 2 and 3. Every reply is ``ok``, no
    table names node 0, every group has three voters on every live
    node, the device's active and voting rows equal the host tables, no
    survivor's term moves, and the port adds no thread a group. The
    member sets, replies and machine states are equal on both
    packages."""
    recs = {}
    for name in PACKAGES:
        lane, rec = _replace(name, tmp_path)
        rp = rec["then"]
        seen = {k: v for k, v in rp.items()
                if k not in ("states", "expect", "leaders", "members")}
        assert rp["states"] == [rp["expect"]] * 3, seen
        assert rp["replies"] == {"shrink": {"ok": GROUPS},
                                 "grow": {"ok": GROUPS},
                                 "write": {"ok": GROUPS}}, seen
        assert rp["named_node0"] == [0, 0, 0], seen
        voters = [sorted([("rp1", "voter"), ("rp2", "voter"),
                          ("rp3", "voter")])] * GROUPS
        assert rp["members"] == [voters] * 3, seen
        assert rp["row_mismatches"] == [0, 0, 0], seen
        assert rp["survivor_term_after"] == rp["survivor_term_before"], seen
        assert rp["snapshot_chunks"] == 0, seen
        assert rp["first_aer_s"] is not None, seen
        assert (rp["stop_s"] <= rp["shrink_sent_s"] <= rp["shrink_acked_s"]
                <= rp["shrink_done_s"] <= rp["logs_s"] <= rp["add_groups_s"]
                <= rp["started_s"] <= rp["grow_sent_s"] <= rp["first_aer_s"]
                <= rp["replace_s"] <= rp["settled_s"]), seen
        assert rp["grow_sent_s"] <= rp["grow_acked_s"] <= rp["settled_s"]
        # three changes a group (leave, join, promotion), each written to
        # the device on each node that held the group then: one write a
        # change on the reference, one a pass on the port
        rows = rp["member_rows"]
        assert rows["calls"] == [3 * GROUPS] * 3, seen
        if lane.torch:
            assert all(0 < f < 3 * GROUPS for f in rows["flushes"]), seen
            assert rp["peak_threads"] - rp["threads_before"] <= 16, seen
        recs[name] = {k: rp[k] for k in ("members", "replies", "states",
                                         "row_mismatches", "named_node0")}
    assert recs["ra_tpu"] == recs["ra_tpu_torch"]


def test_reused_slot_counts_in_no_quorum_before_its_promotion(both_clear):
    """(h) one group, hand-stepped: node 3 joins as a non-voter into the
    slot node 0 left on the leader, which still holds node 0's last
    match there; with node 2 cut off, the leader's commit index never
    passes what nodes 1 and 2 alone hold until node 3 is promoted, and
    the new commands then commit through node 3. The records of both
    packages are equal."""
    recs = {}
    for name in PACKAGES:
        rec = FC.reused_slot(L.Lane(name))
        seen = rec["seen"]
        early = [s for s in seen if not s[2] and s[0] > s[1]]
        assert early == [], early
        # the promotion let the commands commit past node 2's match
        assert seen[-1][2] and seen[-1][0] > seen[-1][1], seen[-3:]
        assert rec["row_at_join"]["active"] == 1, rec
        assert rec["row_at_join"]["voting"] == 0, rec
        assert set(rec["replies"]) == {"ok"}, rec["replies"]
        assert rec["states"] == [20, 20], rec
        recs[name] = rec
    assert recs["ra_tpu"] == recs["ra_tpu_torch"]
