"""The command-lane scenarios of ``tests/test_command_lane.py`` and the
mailbox-pack corpus of ``tests/test_native_runtime.py``, written once for
any package with the reference's module layout (``ra_tpu`` or
``ra_tpu_torch``) and any device.

``tests/test_torch_command_lane.py`` runs them on both packages on the
CPU; ``chip_smoke.py`` (phase lane) runs them on the card and holds each
record against the port's CPU record of the same interleaving. So this
module imports no package statically: ``Lane(name, device)`` imports
one by name. It uses numpy and the standard library only.

Deterministic scenarios drive unstarted coordinators by hand
(``step_once``, one fixed order) on a ``ManualClock`` that moves only
where a scenario moves it (the original's ``time.sleep`` of a tick
becomes an ``advance``), so their records hold integers that must be
equal, exactly: every reply, the counters the original asserts, machine
states, roles, terms, log tails and the group's ``ROW`` fields. Each
scenario also makes the original's own assertions. The watchdog and the
retry after a reject run on the wall clock (started coordinators, or a
pump thread) and make only the original's assertions.
"""

import importlib
import random
import threading
import time

import numpy as np

MODES = ("auto", "always", "never")

# GroupState fields of the group's row in a record (tests/torch_batch.py
# STABLE: the fields two runs of one interleaving must end with)
ROW = (
    "current_term", "voted_for", "commit_index", "last_index", "last_term",
    "written_index", "snapshot_index", "snapshot_term", "role",
    "leader_slot", "self_slot", "machine_version", "match_index",
    "voting", "active", "term_suffix",
)


class ManualClock:
    """The coordinator's clock seam, moved only by ``advance``."""

    __slots__ = ("now",)

    def __init__(self, start: float = 1000.0):
        self.now = start

    def monotonic(self) -> float:
        return self.now

    def monotonic_ns(self) -> int:
        return int(self.now * 1e9)

    def time(self) -> float:
        return 1_600_000_000.0 + self.now

    def sleep(self, seconds: float) -> None:
        raise RuntimeError("a hand-stepped scenario never sleeps")

    def advance(self, seconds: float) -> None:
        self.now += seconds


class Lane:
    """One package's modules as the scenarios use them; its coordinators
    on ``device`` (the port's only; ``None`` means ``"cpu"``)."""

    def __init__(self, name: str, device=None):
        def mod(sub):
            return importlib.import_module(f"{name}.{sub}")

        self.name = name
        self.torch = name == "ra_tpu_torch"
        self.device = device
        self.api = mod("api")
        self.C = mod("ops.consensus")
        self.protocol = mod("protocol")
        self.faults = mod("faults")
        self.leaderboard = mod("leaderboard")
        self.SimpleMachine = mod("machine").SimpleMachine
        self.DictKv = mod("kv_harness").DictKv
        self.BatchCoordinator = mod("runtime.coordinator").BatchCoordinator

    def coord(self, *args, **kw):
        if self.torch:
            kw.setdefault("device", self.device or "cpu")
        return self.BatchCoordinator(*args, **kw)

    def adder(self):
        return self.SimpleMachine(lambda c, s: s + c, 0)

    def command(self, data, fut=None, reply_mode="await_consensus", **kw):
        p = self.protocol
        return p.Command(kind=p.USR, data=data, reply_mode=reply_mode,
                         from_ref=fut, **kw)

    def fields(self, coord) -> dict:
        """Every GroupState field of a coordinator, as numpy arrays."""
        with coord._state_lock:
            if self.torch:
                return self.C.state_to_numpy(coord.state)
            return {k: np.asarray(v) for k, v in coord.state._asdict().items()}


def plain(x):
    """A reply as a comparable value: a reject's gate waiter (a
    ``threading.Event``) becomes its type name."""
    if isinstance(x, (tuple, list)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, threading.Event):
        return "Event"
    return x


def step_all(coords, rounds=1):
    for _ in range(rounds):
        for c in coords:
            c.step_once()


def step_until(coords, cond, rounds=200, what="condition"):
    for _ in range(rounds):
        if cond():
            return
        for c in coords:
            c.step_once()
    if not cond():
        raise AssertionError(f"never reached: {what}")


def mk_cluster(lane, prefix, mode, clock, n=3, **kw):
    """Unstarted coordinators on ``clock`` (``None``: the wall clock):
    one group ``g`` across n nodes. Returns (coords, ids)."""
    names = [f"{prefix}{i}" for i in range(n)]
    if clock is not None:
        kw["clock"] = clock
    coords = [
        lane.coord(nm, capacity=8, num_peers=n, active_set=mode,
                   election_timeout_s=0.05, **kw)
        for nm in names
    ]
    ids = [("g", nm) for nm in names]
    for c in coords:
        c.add_group("g", "cl", ids, lane.adder())
    return coords, ids


def elect(lane, coords, ids, i=0):
    coords[i].deliver(ids[i], lane.protocol.ElectionTimeout(), None)
    step_until(coords, lambda: coords[i].by_name["g"].role == lane.C.R_LEADER,
               what=f"{ids[i]} leads")
    # settle the term noop so later appends start from a committed floor
    g = coords[i].by_name["g"]
    step_until(coords, lambda: g.last_applied >= g.noop_index,
               what="noop committed")


def record(lane, coords, counters=(), group="g"):
    """Per coordinator (by position): the host view of the group, its
    log tail, the named counters and the group's device row."""
    out = []
    for c in coords:
        g = c.by_name[group]
        st = lane.fields(c)
        out.append({
            "host": (g.role, g.term, g.leader_slot, g.last_applied,
                     g.machine_state, g.noop_index,
                     tuple(g.log.last_index_term()), sorted(g.pending_replies),
                     list(g.next_index), list(g.match_hint)),
            "counters": {k: c.counters.get(k) for k in counters},
            "row": {f: st[f][g.gid].tolist() for f in ROW},
        })
    return out


def close(coords):
    for c in coords:
        c.transport.unblock_all()
        c.stop()


# -- the round-5 wedge, pinned ------------------------------------------------


def deposed_leader_redirect(lane, mode, prefix="dw"):
    """test_deposed_leader_redirects_pending_commands: a leader accepts
    a command, is deposed by a higher-term election before it commits,
    and the client's future resolves "maybe" at once."""
    C = lane.C
    clock = ManualClock()
    coords, ids = mk_cluster(lane, f"{prefix}_{mode[:2]}", mode, clock)
    try:
        elect(lane, coords, ids, 0)
        # cut the leader's outbound links: the command is appended but
        # replicated to nobody, so it can never commit
        for o in (1, 2):
            coords[0].transport.block(coords[0].name, coords[o].name)
        fut = lane.api.Future()
        coords[0].deliver(ids[0], lane.command(7, fut), None)
        coords[0].step_once()  # append + AER send; no follower steps
        g0 = coords[0].by_name["g"]
        assert g0.pending_replies, "command was not accepted as pending"
        assert not fut.done()
        coords[1].deliver(ids[1], lane.protocol.ElectionTimeout(), None)
        step_until(
            [coords[1], coords[2]],
            lambda: coords[1].by_name["g"].role == C.R_LEADER
            or coords[2].by_name["g"].role == C.R_LEADER,
            what="majority re-elects",
        )
        step_until(coords, fut.done, what="pending future resolved")
        out = fut.value
        assert out[0] == "maybe", out
        assert coords[0].by_name["g"].role != C.R_LEADER
        assert not g0.pending_replies
        assert coords[0].counters.get("pending_redirected") >= 1
        return {"reply": plain(out),
                "groups": record(lane, coords, ("pending_redirected",))}
    finally:
        close(coords)


def truncated_redirect(lane, mode, prefix="tr"):
    """test_truncated_pending_command_redirects: the deposed leader's
    uncommitted suffix is overwritten by the new leader's log, and its
    future redirects at truncation time."""
    C = lane.C
    clock = ManualClock()
    coords, ids = mk_cluster(lane, f"{prefix}_{mode[:2]}", mode, clock)
    try:
        elect(lane, coords, ids, 0)
        for o in (1, 2):
            coords[0].transport.block(coords[0].name, coords[o].name)
            coords[o].transport.block(coords[o].name, coords[0].name)
        fut = lane.api.Future()
        coords[0].deliver(ids[0], lane.command(9, fut), None)
        coords[0].step_once()
        g0 = coords[0].by_name["g"]
        doomed_idx = min(g0.pending_replies)
        coords[1].deliver(ids[1], lane.protocol.ElectionTimeout(), None)
        step_until(
            coords,
            lambda: coords[1].by_name["g"].role == C.R_LEADER
            or coords[2].by_name["g"].role == C.R_LEADER,
            what="majority re-elects",
        )
        new_leader = (coords[1] if coords[1].by_name["g"].role == C.R_LEADER
                      else coords[2])
        fut2 = lane.api.Future()
        new_leader.deliver(("g", new_leader.name), lane.command(11, fut2),
                           None)
        step_until(coords, fut2.done, what="new leader commits")
        assert fut2.value[0] == "ok"
        # heal new leader -> old leader only, and rewind next_index to
        # the divergence point by hand (the detector's resync probe does
        # this in production; manual stepping runs without it)
        for o in (1, 2):
            coords[o].transport.unblock_all()
        gN = new_leader.by_name["g"]
        slot0 = gN.slot_of(ids[0])
        gN.next_index[slot0] = doomed_idx
        gN.commit_sent[slot0] = -1
        new_leader._send_aers({gN.gid})
        step_until(coords, fut.done, what="old pending future resolved")
        assert fut.value[0] == "redirect", fut.value
        assert (g0.log.fetch_term(doomed_idx) != 1
                or doomed_idx not in g0.pending_replies)
        assert coords[0].counters.get("pending_redirected") >= 1
        return {"replies": (plain(fut.value), plain(fut2.value)),
                "doomed_idx": doomed_idx,
                "new_leader": new_leader.name[-1],
                "groups": record(lane, coords, ("pending_redirected",))}
    finally:
        close(coords)


# -- admission window ---------------------------------------------------------


def admission_reject(lane, mode="auto", prefix="adm"):
    """test_admission_rejects_past_backlog: commands past the backlog
    cap are rejected ("reject", "overloaded"); followers never step."""
    clock = ManualClock()
    coords, ids = mk_cluster(lane, prefix, mode, clock,
                             max_command_backlog=4)
    try:
        elect(lane, coords, ids, 0)
        g = coords[0].by_name["g"]
        base_backlog = g.log.next_index() - 1 - g.last_applied
        futs = [lane.api.Future() for _ in range(10)]
        for f in futs:
            coords[0].deliver(ids[0], lane.command(1, f), None)
        coords[0].step_once()  # followers never step: no commits
        rejected = [f for f in futs
                    if f.done() and f.value[:2] == ("reject", "overloaded")]
        accepted = 4 - base_backlog
        assert len(rejected) == 10 - accepted, [f.value for f in futs
                                                if f.done()]
        assert coords[0].counters.get("commands_rejected") == len(rejected)
        assert g.log.next_index() - 1 - g.last_applied <= 4
        return {"replies": [plain(f.value) if f.done() else None
                            for f in futs],
                "groups": record(lane, coords, ("commands_rejected",))}
    finally:
        close(coords)


def admission_drops_ackfree(lane, mode="auto", prefix="admn"):
    """test_admission_drops_ackfree_commands_counted: noreply commands
    past the window are dropped and counted."""
    clock = ManualClock()
    coords, ids = mk_cluster(lane, prefix, mode, clock,
                             max_command_backlog=4)
    try:
        elect(lane, coords, ids, 0)
        for _ in range(10):
            coords[0].deliver(ids[0], lane.command(1, reply_mode="noreply"),
                              None)
        coords[0].step_once()
        assert coords[0].counters.get("commands_dropped_overload") >= 6
        return {"groups": record(lane, coords,
                                 ("commands_dropped_overload",))}
    finally:
        close(coords)


def internal_never_shed(lane, mode="auto", prefix="admi"):
    """test_admission_never_sheds_internal_commands: a full window never
    sheds a machine-internal command."""
    clock = ManualClock()
    coords, ids = mk_cluster(lane, prefix, mode, clock,
                             max_command_backlog=4)
    try:
        elect(lane, coords, ids, 0)
        g = coords[0].by_name["g"]
        for _ in range(10):
            coords[0].deliver(ids[0], lane.command(1, reply_mode="noreply"),
                              None)
        coords[0].step_once()
        assert g.log.next_index() - 1 - g.last_applied >= 4
        li_before = g.log.last_index_term()[0]
        coords[0].deliver(
            ids[0], lane.command(("timeout", "t1"), reply_mode="noreply",
                                 internal=True), None)
        coords[0].step_once()
        assert g.log.last_index_term()[0] == li_before + 1
        return {"li_before": li_before,
                "groups": record(lane, coords,
                                 ("commands_dropped_overload",))}
    finally:
        close(coords)


def retry_after_reject(lane, prefix="admr"):
    """test_process_command_retries_after_reject (wall clock: a pump
    thread steps the cluster while the client waits): a rejected write
    is retried and completes once the backlog drains."""
    coords, ids = mk_cluster(lane, prefix, "auto", None,
                             max_command_backlog=2)
    try:
        elect(lane, coords, ids, 0)
        for _ in range(4):
            coords[0].deliver(ids[0], lane.command(1, reply_mode="noreply"),
                              None)
        coords[0].step_once()
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                step_all(coords)
                time.sleep(0.002)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            reply, _ = lane.api.process_command(ids[0], 5, timeout=10)
        finally:
            stop.set()
            t.join(timeout=5)
        return reply
    finally:
        close(coords)


# -- pipeline window ------------------------------------------------------------


def pipeline_window(lane, mode="auto", prefix="pw"):
    """test_pipeline_window_bounds_inflight_and_stale_resend: a peer that
    stops acking stalls at match + window; once silent for a tick (the
    clock moved 0.08 s past a 0.05 s tick) the leader rewinds
    next_index to match + 1."""
    clock = ManualClock()
    coords, ids = mk_cluster(lane, prefix, mode, clock, max_pipeline_count=8,
                             tick_interval_s=0.05, aer_batch_size=8)
    try:
        elect(lane, coords, ids, 0)
        g = coords[0].by_name["g"]
        for o in (1, 2):
            coords[0].transport.block(coords[0].name, coords[o].name)
        mh = list(g.match_hint)
        for _ in range(40):
            coords[0].deliver(ids[0], lane.command(1, reply_mode="noreply"),
                              None)
            coords[0].step_once()
        for s in range(len(g.members)):
            if s != g.self_slot:
                assert g.next_index[s] <= mh[s] + 8 + 8, (s, g.next_index, mh)
        stalled = list(g.next_index)
        clock.advance(0.08)
        coords[0].deliver(ids[0], lane.command(1, reply_mode="noreply"), None)
        coords[0].step_once()
        assert coords[0].counters.get("stale_peer_resends") >= 1
        assert all(
            g.next_index[s] <= g.match_hint[s] + 1 + 8
            for s in range(len(g.members)) if s != g.self_slot
        ), (g.next_index, g.match_hint)
        return {"match_before": mh, "stalled": stalled,
                "groups": record(lane, coords, ("stale_peer_resends",))}
    finally:
        close(coords)


# -- watchdog -------------------------------------------------------------------


def watchdog(lane, mode, prefix="wd"):
    """test_watchdog_bounds_wedged_lane (wall clock, started
    coordinators): a leader partitioned from its followers accepts a
    command that can never commit; the watchdog detects the wedge,
    attempts recovery and answers the client "maybe" well inside a
    client-scale timeout. Returns the verdict and the two counters."""
    C = lane.C
    names = [f"{prefix}_{mode[:2]}{i}" for i in range(3)]
    coords = [
        lane.coord(nm, capacity=8, num_peers=3, active_set=mode,
                   election_timeout_s=0.05, detector_poll_s=0.02,
                   tick_interval_s=0.05, command_deadline_s=0.3)
        for nm in names
    ]
    ids = [("g", nm) for nm in names]
    try:
        for c in coords:
            c.add_group("g", "cl", ids, lane.DictKv())
            c.start()
        coords[0].deliver(ids[0], lane.protocol.ElectionTimeout(), None)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if coords[0].by_name["g"].role == C.R_LEADER:
                break
            time.sleep(0.01)
        assert coords[0].by_name["g"].role == C.R_LEADER
        for o in (1, 2):
            coords[0].transport.block(names[0], names[o])
            coords[o].transport.block(names[o], names[0])
        fut = lane.api.Future()
        coords[0].deliver(ids[0], lane.command(("put", "k", 1), fut), None)
        out = fut.result(timeout=5)
        assert out[0] == "maybe", out
        wedges = coords[0].counters.get("lane_wedges")
        recoveries = coords[0].counters.get("lane_recoveries")
        assert wedges >= 1
        assert recoveries >= 1
        return {"verdict": out[0], "lane_wedges": wedges,
                "lane_recoveries": recoveries}
    finally:
        close(coords)


# -- election-duel damping --------------------------------------------------------


def vote_grant_resets_contact(lane, mode="auto", prefix="vg"):
    """test_vote_grant_resets_suspicion_clock: granting a (pre-)vote
    refreshes last_contact."""
    clock = ManualClock()
    coords, ids = mk_cluster(lane, prefix, mode, clock)
    try:
        g1 = coords[1].by_name["g"]
        g1.last_contact = clock.monotonic() - 100.0  # long-stale
        before = g1.last_contact
        coords[0].deliver(ids[0], lane.protocol.ElectionTimeout(), None)
        step_until(coords,
                   lambda: coords[0].by_name["g"].role == lane.C.R_LEADER,
                   what="leader elected")
        assert g1.last_contact > before + 50.0
        return {"contact_after": g1.last_contact - before,
                "groups": record(lane, coords)}
    finally:
        close(coords)


# scenarios whose records must be equal across packages and devices
DETERMINISTIC = {
    "deposed_leader_redirect": deposed_leader_redirect,
    "truncated_redirect": truncated_redirect,
    "admission_reject": admission_reject,
    "admission_drops_ackfree": admission_drops_ackfree,
    "pipeline_window": pipeline_window,
    "vote_grant_resets_contact": vote_grant_resets_contact,
    "internal_never_shed": internal_never_shed,
}
# the ones taking a mode, as the original parametrises them
MODED = ("deposed_leader_redirect", "truncated_redirect")


# -- the mailbox-pack corpus (tests/test_native_runtime.py) ----------------------


def pack_corpus(protocol, rng, cap):
    """Random AER and AER-reply corpora over distinct mailbox columns,
    built from ``protocol``'s message classes."""
    k_aer = rng.randint(0, cap // 2)
    k_rep = rng.randint(0, cap - k_aer)
    cols = rng.sample(range(cap), k_aer + k_rep)
    aer_i, rep_i = cols[:k_aer], cols[k_aer:]
    aer_m = []
    for _ in range(k_aer):
        ents = tuple(
            protocol.Entry(j, rng.randint(1, 9),
                           protocol.Command(protocol.USR, j))
            for j in range(rng.randint(0, 3))
        )
        aer_m.append(protocol.AppendEntriesRpc(
            term=rng.randint(1, 100), leader_id=("a", "n"),
            prev_log_index=rng.randint(0, 1 << 20),
            prev_log_term=rng.randint(0, 99),
            leader_commit=rng.randint(0, 1 << 20), entries=ents,
        ))
    rep_m = [
        protocol.AppendEntriesReply(
            term=rng.randint(1, 100), success=rng.random() < 0.5,
            next_index=rng.randint(0, 1 << 20),
            last_index=rng.randint(0, 1 << 20),
            last_term=rng.randint(0, 99),
        )
        for _ in range(k_rep)
    ]
    aer_s = [rng.randrange(1) for _ in range(k_aer)]
    rep_s = [rng.randrange(1) for _ in range(k_rep)]
    return aer_i, aer_m, aer_s, rep_i, rep_m, rep_s


PACK_SEED = 0xBEEF
PACK_TRIALS = 30


def pack_fuzz(lane, c_nat, c_off, cap, buffer=None):
    """The fuzz of test_pack_hot_parity_fuzz: ``c_nat`` (native pack on)
    packs each of ``PACK_TRIALS`` seeded corpora into ``buffer(nrows,
    cap)`` (default: a zeroed numpy array), ``c_off`` into a zeroed
    numpy array through the Python stores; the two must be equal byte
    for byte. Returns the Python-store mailboxes."""
    nrows = c_nat._NROWS
    make = buffer or (lambda r, w: np.zeros((r, w), np.int32))
    rng = random.Random(PACK_SEED)
    out = []
    for trial in range(PACK_TRIALS):
        corpus = pack_corpus(lane.protocol, rng, cap)
        p_nat = make(nrows, cap)
        p_nat[...] = 0
        p_off = np.zeros((nrows, cap), np.int32)
        c_nat._pack_hot(p_nat, *corpus)
        c_off._pack_hot(p_off, *corpus)
        if p_nat.tobytes() != p_off.tobytes():
            raise AssertionError(f"native pack differs, trial {trial}")
        out.append(p_off)
    return out
