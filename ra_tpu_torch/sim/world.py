"""SimWorld: a whole cluster under one deterministic event loop.

FoundationDB-style simulation for the pure ``Server`` cores: every
concurrency source the threaded runtime has — actor mailboxes, timer
wheels, WAL completion threads, snapshot sender threads, the network —
is replaced by ONE seeded run queue over virtual time
(``SimScheduler``). The effect executor here mirrors
``runtime/proc.py``'s ``_execute`` decision-for-decision (append
front-enqueue order, leader-only machine timers, snapshot
backoff/retry, peer-disconnected marking), so a schedule that breaks an
invariant here is evidence against the same contracts the threaded
runtime runs — minus thread interleavings, plus total reproducibility:

    execution == f(Schedule)          (the determinism invariant, §19)

Safety oracles run continuously, on every replica at every applied
index, via a ``RecordingMachine`` wrapper: cross-replica state digests
(state-machine safety: equal states at equal index) plus the workload's
own invariant (``sim/workloads.py``). Violations are collected, never
raised, so a failing run still produces its full trace for the shrinker.

What is NOT simulated, by choice: the WAL/segment disk stack (logs are
``MemoryLog(auto_written=False)`` with write->written modeled as a
scheduled event), the failure detector (election timers re-arm on
leader contact instead — classic Raft, same safety envelope), and
crash-restarts are clean (pending write completions are flushed before
the rebuild; torn-write crashes stay with the disk-fault soak lane).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import pickle
import random
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ra_tpu_torch import counters as ra_counters
from ra_tpu_torch import effects as fx
from ra_tpu_torch.counters import SESSION_FIELDS, SIM_FIELDS
from ra_tpu_torch.log.memory import MemoryLog
from ra_tpu_torch.log.meta import InMemoryMeta
from ra_tpu_torch.machine import Machine, normalize_apply_result
from ra_tpu_torch.protocol import (
    CHUNK_INIT,
    CHUNK_LAST,
    CHUNK_PRE,
    USR,
    AppendEntriesRpc,
    Command,
    DownEvent,
    ElectionTimeout,
    FromPeer,
    HeartbeatRpc,
    InstallSnapshotAck,
    InstallSnapshotResult,
    InstallSnapshotRpc,
    LogEvent,
    ServerId,
    Tick,
)
from ra_tpu_torch.server import (
    AWAIT_CONDITION,
    FOLLOWER,
    LEADER,
    RECEIVE_SNAPSHOT,
    ConditionTimeout,
    Server,
    ServerConfig,
    status_kind,
)
from ra_tpu_torch.sim.clock import SkewedClock, VirtualClock
from ra_tpu_torch.sim.scheduler import SimScheduler
from ra_tpu_torch.sim.schedule import Schedule
from ra_tpu_torch.sim.transport import SimNetwork
from ra_tpu_torch.sim.workloads import invariant_for, make_machine


# Planted misclassification bug (docs/INTERNALS.md §21, exercised by
# tests/test_sim.py): treat a space-class write failure like a torn
# frame — poison the node and let "recovery" truncate the durable
# tail. Since every replica runs the same byte accounting over the
# same log, they all truncate the same committed (acked) entry, and
# the acked-writes-survive oracle fires deterministically.
SIM_BUG_SPACE_AS_POISON = False


def _fp(state: Any) -> str:
    """Stable state fingerprint. Pickle is deterministic here because
    the sim itself is: both runs build identical structures in
    identical insertion order."""
    return hashlib.sha1(pickle.dumps(state)).hexdigest()[:16]


class RecordingMachine(Machine):
    """Delegating wrapper that feeds every apply to the world's oracles
    (digest recording + workload invariant). ``which_module`` returns
    self so recording survives versioned dispatch."""

    def __init__(self, inner: Machine, world: "SimWorld", node_name: str):
        self.inner = inner
        self.world = world
        self.node_name = node_name

    def init(self, config):
        return self.inner.init(config)

    def apply(self, meta, cmd, state):
        st, reply, effs = normalize_apply_result(
            self.inner.apply(meta, cmd, state)
        )
        self.world.record_apply(self.node_name, meta["index"], cmd,
                                state, st, effs)
        return st, reply, effs

    def state_enter(self, role, state):
        return self.inner.state_enter(role, state)

    def tick(self, time_ms, state):
        return self.inner.tick(time_ms, state)

    def snapshot_installed(self, meta, state, old_meta, old_state):
        self.world.record_install(self.node_name, meta.index, state)
        return self.inner.snapshot_installed(meta, state, old_meta, old_state)

    def overview(self, state):
        return self.inner.overview(state)

    def live_indexes(self, state):
        return self.inner.live_indexes(state)

    def version(self):
        return self.inner.version()

    def which_module(self, version):
        return self

    def snapshot_module(self):
        return self.inner.snapshot_module()


class SimNode:
    """One cluster member: durable log+meta, a rebuildable ``Server``
    core, and the deterministic effect shell (the sim counterpart of
    ``ServerProc``)."""

    def __init__(self, world: "SimWorld", idx: int) -> None:
        self.world = world
        self.name = f"n{idx}"
        self.sid: ServerId = ("srv", self.name)
        # per-node clock view: rate-skewed when the schedule asks for
        # clock skew (the adversary the lease drift epsilon absorbs)
        rate = world.clock_rates.get(self.name, 0.0)
        self.clock = (
            SkewedClock(world.clock, rate) if rate else world.clock
        )
        # durable across crash-restarts (the actor backend restarts over
        # its WAL/meta the same way: runtime/node.py restart path)
        self.log = MemoryLog(auto_written=False)
        self.meta = InMemoryMeta()
        self.server: Optional[Server] = None
        self.running = False
        self.mailbox: deque = deque()  # (msg, )
        self._draining = False
        self.election_ref: Optional[int] = None
        self.condition_ref: Optional[int] = None
        self.tick_ref: Optional[int] = None
        self.machine_timers: Dict[Any, int] = {}
        self.snap_retry: Dict[ServerId, int] = {}
        self.senders: Dict[ServerId, Dict[str, Any]] = {}
        # disk-space model (schedule.disk_budget_bytes): deterministic
        # byte accounting over durable writes; exhausted writes park
        # until disk_heal (the sim storage_degraded episode)
        self.disk_used = 0
        self.space_degraded = False
        self._parked: List[Any] = []

    # -- lifecycle -----------------------------------------------------------

    def _build_server(self) -> None:
        w = self.world
        cfg = ServerConfig(
            server_id=self.sid,
            uid=f"uid_{self.name}",
            cluster_name="sim",
            machine=RecordingMachine(w.make_machine(self.name), w, self.name),
            initial_members=w.members,
            counters_enabled=False,
            check_quorum_window_s=w.check_quorum_s,
            clock=self.clock,
            # clock-bound leases (docs/INTERNALS.md §20): the server's
            # promise window must equal the sim's election timer base
            # (arm_election randomizes upward only), and the drift
            # epsilon is widened to cover the schedule's rate-skew
            # bound — with that covered, any stale consistent read the
            # kvread oracle sees is a genuine lease-math violation
            lease=w.lease,
            election_timeout_s=w.election_ms / 1000.0,
            lease_drift_epsilon_s=w.lease_drift_eps_s,
        )
        self.server = Server(cfg, self.log, self.meta)

    def start(self) -> None:
        self._build_server()
        self.running = True
        self.world.net.attach(self.name, self._net_deliver)
        self._schedule_tick()
        if self.server.is_voter_self():
            self.arm_election()

    def crash(self) -> None:
        w = self.world
        self.running = False
        self.mailbox.clear()
        w.net.detach(self.name)
        w.sched.cancel(self.election_ref)
        self.election_ref = None
        w.sched.cancel(self.condition_ref)
        self.condition_ref = None
        w.sched.cancel(self.tick_ref)
        self.tick_ref = None
        for ref in self.machine_timers.values():
            w.sched.cancel(ref)
        self.machine_timers.clear()
        for ref in self.snap_retry.values():
            w.sched.cancel(ref)
        self.snap_retry.clear()
        self.senders.clear()
        # leader-local runtime state (monitors) dies with the proc; the
        # machine's state_enter re-issues them on the next leader
        for watchers in w.monitors.values():
            watchers.discard(self.name)

    def boot(self) -> None:
        # clean-crash model: everything appended had its write
        # completion flushed before the rebuild (torn-tail crashes are
        # the disk-fault soak lane's job, not the sim's) — unless the
        # disk is exhausted, in which case those writes stay parked:
        # they were never durable and must not confirm across a reboot
        w0 = self.world
        for evt in self.log.pending_written_events():
            if w0.disk_budget and not SIM_BUG_SPACE_AS_POISON:
                cost = self._evt_bytes(evt)
                if (self.space_degraded
                        or self.disk_used + cost > w0.disk_budget):
                    self.space_degraded = True
                    self._parked.append(evt)
                    continue
                self.disk_used += cost
            self.log.handle_event(evt)
        self._build_server()
        self.server.recover()
        self.running = True
        w = self.world
        w.net.attach(self.name, self._net_deliver)
        w.trace("boot", w.clock.now_ms, self.name, self.server.role)
        self._schedule_tick()
        if self.server.role == FOLLOWER and self.server.is_voter_self():
            self.arm_election()

    # -- event sources ----------------------------------------------------------

    def _net_deliver(self, to: ServerId, msg: Any, from_sid: ServerId) -> None:
        self.post(FromPeer(from_sid, msg))

    def _schedule_tick(self) -> None:
        w = self.world
        if not self.running or w.clock.now_ms >= w.end_ms:
            return

        def fire() -> None:
            self.tick_ref = None
            if self.running:
                self.post(Tick(now_ms=int(w.clock.time() * 1000)))
                self._schedule_tick()

        self.tick_ref = w.sched.after_ms(w.tick_ms, fire)

    def arm_election(self, immediate: bool = False) -> None:
        w = self.world
        w.sched.cancel(self.election_ref)
        self.election_ref = None
        if not self.running or w.clock.now_ms >= w.end_ms:
            return
        delay = 0 if immediate else int(
            w.election_ms * (1.0 + w.rng.random())
        )

        def fire() -> None:
            self.election_ref = None
            if self.running:
                w.trace("etimo", w.clock.now_ms, self.name)
                self.post(ElectionTimeout())
                # a losing round leaves the role unchanged (a pre-vote
                # swallowed by a partition emits no state transition),
                # so the retry must be armed here; winning cancels it
                # via state_enter(LEADER)
                self.arm_election()

        self.election_ref = w.sched.after_ms(delay, fire)

    # -- mailbox -------------------------------------------------------------------

    def post(self, msg: Any, front: bool = False) -> None:
        if not self.running:
            return
        if front:
            self.mailbox.appendleft(msg)
        else:
            self.mailbox.append(msg)
        if not self._draining:
            self._drain()

    def _drain(self) -> None:
        self._draining = True
        try:
            while self.mailbox and self.running:
                msg = self.mailbox.popleft()
                self.world.count_step()
                self._execute(self._handle(msg))
            if self.running:
                self._flush_wal()
        finally:
            self._draining = False

    def _flush_wal(self) -> None:
        """Write->written as a scheduled event: durability has latency
        and is schedulable (and therefore reorderable) like everything
        else. Under a disk budget, writes that would exceed it fail
        space-class: parked (never confirmed) until disk_heal — the
        sim's storage_degraded episode."""
        w = self.world
        for evt in self.log.pending_written_events():
            if w.disk_budget:
                cost = self._evt_bytes(evt)
                if self.space_degraded or self.disk_used + cost > w.disk_budget:
                    if self._on_disk_full(evt) == "poisoned":
                        return  # log truncated: remaining evts are stale
                    continue
                self.disk_used += cost

            def deliver(evt=evt) -> None:
                if self.running:
                    w.trace("wal", w.clock.now_ms, self.name, evt[1],
                            str(evt[2]))
                    self.post(LogEvent(evt))

            w.sched.after_ms(w.wal_ms, deliver)

    def _evt_bytes(self, evt: Any) -> int:
        """Deterministic frame cost of one ("written", term, seq) batch:
        a fixed header plus the pickled command payload per entry —
        identical across replicas because replicated logs are."""
        cost = 0
        for idx in evt[2]:
            e = self.log.fetch(idx)
            if e is not None:
                cost += 32 + len(pickle.dumps(e.cmd))
        return cost

    def _on_disk_full(self, evt: Any) -> str:
        w = self.world
        if SIM_BUG_SPACE_AS_POISON:
            # the misclassification under test: ENOSPC handled like a
            # torn frame — poison-restart, and "recovery" truncates the
            # durable tail (discarding a committed, possibly acked,
            # entry). The clean path below provably never does this.
            last, _t = self.log.last_written()
            w.trace("disk_poison", w.clock.now_ms, self.name, last)
            if last > 0:
                self.log.set_last_index(last - 1)
            self.crash()
            self.boot()
            return "poisoned"
        if not self.space_degraded:
            self.space_degraded = True
            w.trace("disk_full", w.clock.now_ms, self.name, self.disk_used)
            w.ctr.incr("sim_disk_exhaustions")
        self._parked.append(evt)
        w.ctr.incr("sim_disk_parked_writes")
        return "parked"

    def disk_heal(self) -> None:
        """Operator freed space: exit degraded, confirm every parked
        write (stale ones — overwritten since — are filtered by the
        log's term check, exactly like late WAL notifications)."""
        w = self.world
        self.space_degraded = False
        self.disk_used = 0
        parked, self._parked = self._parked, []
        if parked:
            w.trace("disk_heal", w.clock.now_ms, self.name, len(parked))
        for evt in parked:
            def deliver(evt=evt) -> None:
                if self.running:
                    w.trace("wal", w.clock.now_ms, self.name, evt[1],
                            str(evt[2]))
                    self.post(LogEvent(evt))

            w.sched.after_ms(w.wal_ms, deliver)

    # -- message routing (the sim ServerProc._on_batch) -----------------------------

    def _handle(self, msg: Any) -> List[fx.Effect]:
        server = self.server
        if isinstance(msg, FromPeer):
            inner = msg.msg
            # mid-transfer chunk acks/results are sender-plane traffic,
            # consumed by the active sender, not the consensus core
            if isinstance(inner, InstallSnapshotAck) and msg.peer in self.senders:
                self._sender_ack(msg.peer, inner)
                return []
            if (
                isinstance(inner, InstallSnapshotResult)
                and msg.peer in self.senders
            ):
                self.senders.pop(msg.peer, None)
                return server.handle(inner, from_peer=msg.peer)
            if isinstance(inner, InstallSnapshotAck):
                return []  # stale ack, no transfer in progress
            self._note_contact(msg)
            return server.handle(msg)
        if isinstance(msg, tuple) and msg and msg[0] == "__snap_fail__":
            _, to = msg
            if self.senders.pop(to, None) is None:
                return []
            return server.handle(("snapshot_sender_down", to, "failed"))
        if isinstance(msg, Tick) and server.role == LEADER:
            # reconnect probing (proc.py does the same per tick): peers
            # marked disconnected by refused sends retry once reachable
            for sid, p in server.peers().items():
                if p.status == "disconnected" and self.world.net.proc_alive(sid):
                    p.status = "normal"
        return server.handle(msg)

    def _note_contact(self, msg: FromPeer) -> None:
        """Leader contact postpones the election timer (classic Raft
        re-arm; the threaded runtime cancels and leans on its failure
        detector instead — same safety envelope, no detector thread).
        Stale traffic from a dead sender is not liveness evidence."""
        if not isinstance(
            msg.msg, (AppendEntriesRpc, InstallSnapshotRpc, HeartbeatRpc)
        ):
            return
        if self.server.role in (
            FOLLOWER, AWAIT_CONDITION, RECEIVE_SNAPSHOT
        ) and self.world.net.proc_alive(msg.peer):
            self.arm_election()

    # -- effect executor (mirrors ServerProc._execute) ---------------------------------

    def _execute(self, effects: List[fx.Effect]) -> None:
        w = self.world
        server = self.server
        appends: List[Command] = []
        for eff in effects:
            if isinstance(eff, fx.SendRpc):
                ok = w.net.send(self.sid, eff.to, eff.msg)
                if not ok:
                    peer = server.cluster.get(eff.to)
                    if peer is not None and peer.status == "normal":
                        peer.status = "disconnected"
            elif isinstance(eff, fx.SendVoteRequests):
                for to, rpc in eff.requests:
                    w.net.send(self.sid, to, rpc)
            elif isinstance(eff, fx.NextEvent):
                self.post(eff.msg, front=True)
            elif isinstance(eff, fx.Reply):
                w.record_reply(eff.from_ref, eff.reply)
            elif isinstance(eff, fx.Notify):
                w.notifications.append((eff.who, self.sid, list(eff.correlations)))
            elif isinstance(eff, fx.SendMsg):
                w.client_msgs.append((self.name, eff.to, eff.msg))
            elif isinstance(eff, fx.RecordLeader):
                w.leaderboard[eff.cluster_name] = (eff.leader, eff.members)
            elif isinstance(eff, fx.SendSnapshot):
                self._start_snapshot_sender(eff.to)
            elif isinstance(eff, fx.StateEnter):
                self._on_state_enter(eff.role)
            elif isinstance(eff, fx.StopServer):
                w.trace("stop", w.clock.now_ms, self.name)
                self.crash()
            elif isinstance(eff, fx.StartSnapshotRetryTimer):
                self._arm_snap_retry(eff.to, eff.delay_ms)
            elif isinstance(eff, fx.Timer):
                self._machine_timer(eff)
            elif isinstance(eff, fx.ModCall):
                try:
                    eff.fn(*eff.args)
                except Exception:  # noqa: BLE001
                    pass
            elif isinstance(eff, fx.BgWork):
                # background work runs inline: determinism over fidelity
                try:
                    eff.fn()
                except Exception as e:  # noqa: BLE001
                    if eff.err_fn is not None:
                        eff.err_fn(e)
            elif isinstance(eff, fx.Monitor):
                w.monitors.setdefault((eff.kind, eff.target), set()).add(self.name)
            elif isinstance(eff, fx.Demonitor):
                watchers = w.monitors.get((eff.kind, eff.target))
                if watchers is not None:
                    watchers.discard(self.name)
            elif isinstance(eff, fx.LogRead):
                entries = server.log.sparse_read(list(eff.indexes))
                out = eff.fn(entries)
                if out is not None:
                    self.post(out)
            elif isinstance(eff, fx.Aux):
                self.post(("aux", "cast", eff.cmd, None))
            elif isinstance(eff, fx.Append):
                if server.role == LEADER:
                    appends.append(Command(
                        kind=USR, data=eff.cmd, reply_mode=eff.reply_mode,
                        from_ref=eff.from_ref, internal=True,
                    ))
            elif isinstance(eff, fx.TryAppend):
                appends.append(Command(
                    kind=USR, data=eff.cmd, reply_mode=eff.reply_mode,
                    from_ref=(
                        eff.from_ref if server.role == LEADER else None
                    ),
                    internal=True,
                ))
        for cmd in reversed(appends):
            self.post(cmd, front=True)

    def _on_state_enter(self, role: str) -> None:
        w = self.world
        w.trace("state", w.clock.now_ms, self.name, role,
                self.server.current_term)
        if role != AWAIT_CONDITION and self.condition_ref is not None:
            w.sched.cancel(self.condition_ref)
            self.condition_ref = None
        if role == LEADER:
            w.sched.cancel(self.election_ref)
            self.election_ref = None
        else:
            # follower/pre_vote/candidate/await_condition/receive_
            # snapshot all keep an election pending; a live leader's
            # traffic re-arms it before it fires
            self.arm_election()
        if role == AWAIT_CONDITION:
            # the hold must expire even when the condition's trigger is
            # lost to the network (proc.py arms the same timer): the
            # generation-tagged ConditionTimeout runs the Condition's
            # timeout path — repeated catch-up reply, fall back to
            # follower — instead of wedging until the end of time
            cond = self.server.condition
            dur_ms = w.cond_timeout_ms
            if cond is not None and cond.timeout_duration_ms is not None:
                dur_ms = cond.timeout_duration_ms
            gen = self.server.condition_generation
            w.sched.cancel(self.condition_ref)
            self.condition_ref = None
            if self.running and w.clock.now_ms < w.end_ms:

                def fire(gen: int = gen) -> None:
                    self.condition_ref = None
                    if self.running:
                        w.trace("ctimo", w.clock.now_ms, self.name, gen)
                        self.post(ConditionTimeout(generation=gen))

                self.condition_ref = w.sched.after_ms(dur_ms, fire)

    # -- machine timers --------------------------------------------------------------

    def _machine_timer(self, eff: fx.Timer) -> None:
        w = self.world
        old = self.machine_timers.pop(eff.name, None)
        w.sched.cancel(old)
        if eff.ms is None:
            return

        def fire() -> None:
            self.machine_timers.pop(eff.name, None)
            if self.running and self.server.role == LEADER:
                w.trace("mtimer", w.clock.now_ms, self.name, repr(eff.name))
                self.post(Command(kind=USR, data=("timeout", eff.name),
                                  internal=True))

        self.machine_timers[eff.name] = w.sched.after_ms(int(eff.ms), fire)

    # -- snapshot transfer (the sim SnapshotSender) ------------------------------------

    def _start_snapshot_sender(self, to: ServerId) -> None:
        w = self.world
        if to in self.senders:
            return
        w.sched.cancel(self.snap_retry.pop(to, None))
        peer = self.server.cluster.get(to)
        if peer is not None and status_kind(peer.status) == "snapshot_backoff":
            peer.status = ("sending_snapshot", peer.status[1])
        got = self.server.log.read_snapshot()
        if got is None:
            if peer is not None and status_kind(peer.status) == "sending_snapshot":
                peer.status = "normal"
            return
        meta, state = got
        live = (
            self.server.log.sparse_read(list(meta.live_indexes))
            if meta.live_indexes
            else []
        )
        # stop-and-wait chunk plan: INIT (acked) -> optional PRE with
        # sparse live entries (acked) -> LAST carrying the state as one
        # direct-object chunk (answered by InstallSnapshotResult).
        # deepcopy mirrors the pickle round-trip of the real sender —
        # receiver state must never alias the sender's.
        chunks: List[Tuple[int, str, Any]] = [(0, CHUNK_INIT, b"")]
        no = 1
        if live:
            chunks.append((no, CHUNK_PRE, live))
            no += 1
        chunks.append((no, CHUNK_LAST, copy.deepcopy(state)))
        sender = {
            "to": to, "meta": meta, "chunks": chunks, "i": 0,
            "term": self.server.current_term, "gen": 0,
        }
        self.senders[to] = sender
        w.trace("snap", w.clock.now_ms, self.name, to[1], meta.index)
        self._send_chunk(sender)

    def _send_chunk(self, sender: Dict[str, Any]) -> None:
        w = self.world
        to = sender["to"]
        no, phase, data = sender["chunks"][sender["i"]]
        w.net.send(self.sid, to, InstallSnapshotRpc(
            term=sender["term"], leader_id=self.server.id,
            meta=sender["meta"], chunk_no=no, chunk_phase=phase, data=data,
        ))
        sender["gen"] += 1
        gen = sender["gen"]

        def watchdog() -> None:
            s = self.senders.get(to)
            if self.running and s is sender and s["gen"] == gen:
                # no ack/result within the window: dropped chunk or
                # blocked return path — fail into backoff+retry
                self.post(("__snap_fail__", to))

        w.sched.after_ms(w.snap_ack_timeout_ms, watchdog)

    def _sender_ack(self, peer: ServerId, ack: InstallSnapshotAck) -> None:
        sender = self.senders[peer]
        no, _phase, _data = sender["chunks"][sender["i"]]
        if ack.chunk_no < no:
            return  # duplicate ack of an older chunk
        sender["i"] += 1
        if sender["i"] < len(sender["chunks"]):
            self._send_chunk(sender)
        # else: LAST is in flight; its watchdog covers the result

    def _arm_snap_retry(self, to: ServerId, delay_ms: int) -> None:
        w = self.world
        w.sched.cancel(self.snap_retry.pop(to, None))

        def fire() -> None:
            self.snap_retry.pop(to, None)
            if self.running:
                self.post(("snapshot_retry_timeout", to))

        self.snap_retry[to] = w.sched.after_ms(int(delay_ms), fire)


@dataclasses.dataclass
class SimResult:
    schedule: Schedule  # ops materialized: replayable as-is
    violations: List[str]
    trace_text: str
    final: Dict[str, Tuple[int, str]]  # node -> (last_applied, state fp)
    steps: int
    virtual_ms: int
    replies: Dict[int, List[Any]]
    client_msgs: List[Tuple[str, Any, Any]]

    @property
    def ok(self) -> bool:
        return not self.violations


class SimWorld:
    # timing model (virtual ms). Constants, not config: schedules must
    # stay comparable across runs and sessions.
    tick_ms = 60
    election_ms = 150  # base; arm() randomizes to [1x, 2x)
    wal_ms = 1
    snap_ack_timeout_ms = 400
    cond_timeout_ms = 500  # default await_condition hold (proc.py: 30s)
    check_quorum_s = 0.9
    MAX_STEPS = 5_000_000

    def __init__(self, sched_in: Schedule) -> None:
        self.schedule_in = sched_in
        self.clock = VirtualClock()
        self.sched = SimScheduler(self.clock)
        # election-jitter stream, decorrelated from net/ops/nemesis
        self.rng = random.Random((sched_in.seed << 2) ^ 0x454C45)  # "ELE"
        self.end_ms = sched_in.horizon_ms + sched_in.settle_ms
        self.members = tuple(
            ("srv", f"n{i}") for i in range(sched_in.nodes)
        )
        self.ctr = ra_counters.registry().new(("sim", "plane"), SIM_FIELDS)
        # lease plane (docs/INTERNALS.md §20): per-node clock RATE skew
        # drawn from its own seed stream, bounded by the schedule; the
        # drift epsilon covers 2x the bound over both promise windows
        self.lease = sched_in.lease
        skew = sched_in.skew_ppm * 1e-6
        skew_rng = random.Random((sched_in.seed << 3) ^ 0x534B57)  # "SKW"
        self.clock_rates = {
            f"n{i}": (skew_rng.uniform(-skew, skew) if skew else 0.0)
            for i in range(sched_in.nodes)
        }
        self.lease_drift_eps_s = 0.002 + 4.0 * skew * (self.election_ms / 1000.0)
        # kvread stale-read oracle state: acked write floor (raft index
        # of the highest acked put), per-read floors at invocation, and
        # which client refs were seq writes
        self._acked_floor = -1
        self._read_floor: Dict[int, int] = {}
        self._seq_write_refs: Set[int] = set()
        # acked-writes-survive oracle (§21): raft index -> state fp at
        # the apply that was acked; any later apply at that index with
        # a different fp means a confirmed write was destroyed
        self._acked_fp: Dict[int, str] = {}
        self.disk_budget = sched_in.disk_budget_bytes
        self._old_leader: Optional[str] = None
        self._session_ctr = (
            ra_counters.registry().new(("session", "sim"), SESSION_FIELDS)
            if sched_in.workload == "session"
            else None
        )
        self.invariant = invariant_for(sched_in.workload)
        self.inv_tracker: Dict[str, Dict[str, Any]] = {}
        self._checked_to: Dict[str, int] = {}  # node -> highest oracle-checked index
        self.trace_lines: List[str] = []
        self.violations: List[str] = []
        self.replies: Dict[int, List[Any]] = {}
        self.notifications: List[Any] = []
        self.client_msgs: List[Tuple[str, Any, Any]] = []
        self.monitors: Dict[Tuple[str, Any], Set[str]] = {}
        self.leaderboard: Dict[str, Any] = {}
        self.digests: Dict[str, Dict[int, str]] = {}
        self.steps = 0
        self._op_i = 0
        self.net = SimNetwork(
            self.sched, sched_in.seed,
            drop_p=sched_in.drop_p, dup_p=sched_in.dup_p,
            delay_p=sched_in.delay_p, delay_ms_max=sched_in.delay_ms_max,
            ctr=self.ctr, trace=self._trace_net,
        )
        self.nodes: Dict[str, SimNode] = {}
        for i in range(sched_in.nodes):
            node = SimNode(self, i)
            self.nodes[node.name] = node
            self.digests[node.name] = {}
        self.planner = None
        self._nem_seen = 0
        if sched_in.nemesis:
            from ra_tpu_torch.nemesis import (
                NemesisContext,
                Planner,
                standard_dimensions,
            )

            ctx = NemesisContext(
                peers=lambda: list(self.nodes),
                members=lambda: list(self.nodes),
                block=self.net.block,
                unblock_all=self.net.unblock_all,
                restart=self.restart,
            )
            self.planner = Planner(
                ctx, sched_in.seed, "sim",
                standard_dimensions(partitions=True, oneway=True,
                                    restarts=True),
            )

    # -- factories -------------------------------------------------------------

    def make_machine(self, node_name: str):
        # the counter-carrying instance lives on n0 only: apply runs on
        # every replica, a shared vector would count everything x nodes
        ctr = self._session_ctr if node_name == "n0" else None
        return make_machine(self.schedule_in.workload, ctr=ctr)

    # -- tracing / recording ----------------------------------------------------

    def trace(self, *fields: Any) -> None:
        self.trace_lines.append(" ".join(str(f) for f in fields))

    def _trace_net(self, kind: str, seq: int, frm: str, to: str,
                   msgkind: str, *extra: Any) -> None:
        self.trace("net", self.clock.now_ms, kind, f"#{seq}",
                   f"{frm}->{to}", msgkind, *extra)

    def count_step(self) -> None:
        self.steps += 1
        if self.steps > self.MAX_STEPS:
            raise RuntimeError("sim storm: step budget exhausted")

    def violation(self, msg: str) -> None:
        if len(self.violations) < 32:
            self.violations.append(msg)

    def record_apply(self, node_name: str, index: int, cmd: Any,
                     pre: Any, post: Any, effs: Any) -> None:
        fp = _fp(post)
        self.trace("apply", self.clock.now_ms, node_name, index, fp[:8])
        want = self._acked_fp.get(index)
        if want is not None and fp != want:
            self.violation(
                f"acked write lost: index {index} re-applied on "
                f"{node_name} as {fp}, acked state was {want}"
            )
        mine = self.digests[node_name]
        prev = mine.get(index)
        if prev is not None and prev != fp:
            # a restart replays the log from the snapshot; a
            # deterministic machine must land on the identical state
            self.violation(
                f"replay divergence on {node_name} at index {index}: "
                f"{prev} -> {fp}"
            )
        mine[index] = fp
        # state-machine safety, checked at the earliest possible moment:
        # two replicas that applied the same index must hold equal state
        for other, d in self.digests.items():
            if other != node_name and d.get(index, fp) != fp:
                self.violation(
                    f"state divergence at index {index}: "
                    f"{node_name}={fp} vs {other}={d[index]}"
                )
        # replayed indexes (crash-restart re-applying below the old
        # last_applied) were already oracle-checked on first apply; the
        # stateful invariant trackers (e.g. fencing-token high-water)
        # must not see the history twice
        if index <= self._checked_to.get(node_name, 0):
            return
        self._checked_to[node_name] = index
        if self.invariant is not None:
            tracker = self.inv_tracker.setdefault(node_name, {})
            msg = self.invariant(cmd, pre, post, effs, tracker)
            if msg:
                self.violation(f"[{node_name} @idx {index}] {msg}")

    def record_install(self, node_name: str, index: int, state: Any) -> None:
        fp = _fp(state)
        self.trace("install", self.clock.now_ms, node_name, index, fp[:8])
        self.digests[node_name][index] = fp
        for other, d in self.digests.items():
            if other != node_name and d.get(index, fp) != fp:
                self.violation(
                    f"snapshot/state divergence at index {index}: "
                    f"{node_name}={fp} vs {other}={d[index]}"
                )

    def record_reply(self, from_ref: Any, reply: Any) -> None:
        if not (isinstance(from_ref, tuple) and len(from_ref) == 2):
            return
        kind, i = from_ref
        if kind == "cli":
            self.replies.setdefault(i, []).append(reply)
            if (i in self._seq_write_refs
                    and isinstance(reply, tuple) and reply
                    and reply[0] == "ok"):
                # KvMachine's put reply carries the applied raft index:
                # the monotone sequence the read oracle floors against
                idx = reply[1][1] if isinstance(reply[1], tuple) else -1
                if idx > self._acked_floor:
                    self._acked_floor = idx
                if idx >= 0 and idx not in self._acked_fp:
                    for d in self.digests.values():
                        if idx in d:
                            self._acked_fp[idx] = d[idx]
                            break
        elif kind == "rd":
            self.replies.setdefault(i, []).append(reply)
            floor = self._read_floor.pop(i, None)
            if (floor is None or not isinstance(reply, tuple) or not reply
                    or reply[0] != "ok"):
                return  # redirects/timeouts carry no linearizability claim
            self.trace("readok", self.clock.now_ms, i, reply[1], floor)
            if reply[1] < floor:
                # the lease's whole claim: a consistent read invoked
                # after a write was acked must observe it
                self.violation(
                    f"stale consistent read rd/{i}: observed seq index "
                    f"{reply[1]} < acked floor {floor} at invocation"
                )

    # -- nemesis callbacks ---------------------------------------------------------

    def restart(self, node_name: str) -> None:
        node = self.nodes[node_name]
        self.trace("restart", self.clock.now_ms, node_name)
        node.crash()
        node.boot()

    # -- op injection ------------------------------------------------------------------

    def current_leader(self) -> Optional[SimNode]:
        best = None
        for name in sorted(self.nodes):
            node = self.nodes[name]
            if node.running and node.server.role == LEADER:
                if best is None or node.server.current_term > best.server.current_term:
                    best = node
        return best

    def _inject(self, t_ms: int, op: Tuple[Any, ...]) -> None:
        kind = op[0]
        if kind == "cmd":
            self._op_i += 1
            i = self._op_i
            target = self.current_leader()
            if target is None:
                for name in sorted(self.nodes):
                    if self.nodes[name].running:
                        target = self.nodes[name]
                        break
            if target is None:
                return
            if (isinstance(op[1], tuple) and len(op[1]) >= 2
                    and op[1][0] == "put" and op[1][1] == "seq"):
                self._seq_write_refs.add(i)
            self.trace("cmd", t_ms, i, target.name, repr(op[1]))
            target.post(Command(kind=USR, data=op[1],
                                reply_mode="await_consensus",
                                from_ref=("cli", i)))
        elif kind == "read":
            # consistent read (docs/INTERNALS.md §20). Targets a node
            # directly — including non-leaders, which drop it — so a
            # deposed leader still inside its lease window answers and
            # is held to the acked-write floor captured right here.
            tgt = op[1]
            if tgt == "leader":
                node = self.current_leader()
            elif tgt == "old":
                node = self.nodes.get(self._old_leader or "")
            else:
                node = self.nodes.get(f"n{int(tgt) % len(self.nodes)}")
            if node is None or not node.running:
                return
            self._op_i += 1
            i = self._op_i
            self._read_floor[i] = self._acked_floor
            self.trace("read", t_ms, i, node.name, self._acked_floor)
            from ra_tpu_torch.sim.workloads import read_seq_index

            node.post(("consistent_query", read_seq_index, ("rd", i)))
        elif kind == "isolate" and op[1] == "leader":
            target = self.current_leader()
            if target is None:
                return
            self._old_leader = target.name
            for other in self.nodes:
                if other != target.name:
                    self.net.block(target.name, other)
                    self.net.block(other, target.name)
            self.trace("isolate", t_ms, target.name)
        elif kind == "etimo":
            # deterministic election trigger: the first running voter
            # that is not the old leader campaigns NOW (the server's
            # own stickiness standing guard still applies)
            for name in sorted(self.nodes):
                if name != self._old_leader and self.nodes[name].running:
                    self.trace("etimo_op", t_ms, name)
                    self.nodes[name].post(ElectionTimeout())
                    break
        elif kind == "unblock":
            self.trace("unblock", t_ms)
            self.net.unblock_all()
        elif kind == "down":
            target = op[1]
            watchers = sorted(self.monitors.get(("process", target), ()))
            self.trace("cdown", t_ms, target, ",".join(watchers) or "-")
            for w in watchers:
                node = self.nodes[w]
                if node.running:
                    node.post(DownEvent(target, "sim_down"))
        elif kind == "nem" and self.planner is not None:
            self.planner.step(op[1])
            sched = self.planner.schedule
            while self._nem_seen < len(sched):
                op_i, name, verb, detail = sched[self._nem_seen]
                self._nem_seen += 1
                self.trace("nem", t_ms, op_i, name, verb, detail)

    def _heal(self) -> None:
        self.trace("heal", self.clock.now_ms)
        if self.planner is not None:
            self.planner.heal_all("horizon")
            sched = self.planner.schedule
            while self._nem_seen < len(sched):
                op_i, name, verb, detail = sched[self._nem_seen]
                self._nem_seen += 1
                self.trace("nem", self.clock.now_ms, op_i, name, verb, detail)
        self.net.unblock_all()
        for name in sorted(self.nodes):
            if not self.nodes[name].running:
                self.nodes[name].boot()
        for name in sorted(self.nodes):
            node = self.nodes[name]
            if node.space_degraded or node._parked:
                node.disk_heal()

    # -- run ---------------------------------------------------------------------------

    def run(self) -> SimResult:
        sched_in = self.schedule_in
        ops = sched_in.resolve_ops()
        for t_ms, op in ops:
            self.sched.after_ms(t_ms, lambda t=t_ms, op=op: self._inject(t, op))
        # at the horizon every fault heals and crashed nodes reboot; the
        # settle window is for convergence (elections, snapshot
        # catch-up, lease expiries)
        self.sched.after_ms(sched_in.horizon_ms, self._heal)
        for name in sorted(self.nodes):
            self.nodes[name].start()
        while self.sched.run_next():
            pass
        self.ctr.incr("sim_schedules_run")
        if self.violations:
            self.ctr.incr("sim_schedules_failed")
        self.ctr.incr("sim_steps_executed", self.steps)
        self.ctr.incr("sim_virtual_ms", self.clock.now_ms)
        # acked-writes-survive oracle (§21), end-of-run form: after the
        # horizon heal + settle, every surviving replica's state must
        # reflect the highest acked seq write. A space failure handled
        # as poison truncates the durable tail on every replica (same
        # byte accounting, same log), and the acked index silently
        # vanishes — invisible to the per-apply oracles because meta's
        # last_applied stays above the truncated entry, so nothing ever
        # re-applies at that index.
        if self.disk_budget and self._acked_floor >= 0:
            for name in sorted(self.nodes):
                node = self.nodes[name]
                if not node.running:
                    continue
                st = node.server.machine_state
                got = st.get("seq") if isinstance(st, dict) else None
                at = got[0] if got else -1
                if at < self._acked_floor:
                    self.violation(
                        f"acked write lost on {name}: seq last written at "
                        f"index {at} < acked floor {self._acked_floor}"
                    )
        final = {
            name: (node.server.last_applied, _fp(node.server.machine_state))
            for name, node in self.nodes.items()
            if node.running
        }
        for name in sorted(final):
            self.trace("final", name, final[name][0], final[name][1])
        return SimResult(
            schedule=sched_in.with_ops(ops),
            violations=list(self.violations),
            trace_text="\n".join(self.trace_lines) + "\n",
            final=final,
            steps=self.steps,
            virtual_ms=self.clock.now_ms,
            replies=dict(self.replies),
            client_msgs=list(self.client_msgs),
        )


def run_schedule(sched: Schedule) -> SimResult:
    """Run one schedule to completion under a fresh world."""
    return SimWorld(sched).run()
