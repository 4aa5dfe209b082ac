"""ServerProc: the runtime shell around one consensus core.

The counterpart of the reference's ``ra_server_proc`` gen_statem
(``src/ra_server_proc.erl``): owns the mailbox, realises effects
(sends, replies, vote fan-out, snapshot sender, timers, monitors,
leaderboard records, background work), manages election/tick timers, and
batches client commands per mailbox drain (the reference's low-priority
command queue + AER batching play this role).

Election liveness follows the reference's no-idle-heartbeats design
(reference: docs/internals/INTERNALS.md:290-327): followers arm a
randomized election timer only on leader-down evidence (node failure
detector, leader proc DOWN) and disarm it on any contact from the
leader; pre-vote/candidate states keep a timer armed to retry stalled
elections.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ra_tpu_torch import effects as fx
from ra_tpu_torch import leaderboard
from ra_tpu_torch.protocol import (
    AppendEntriesRpc,
    CHUNK_INIT,
    CHUNK_LAST,
    CHUNK_NEXT,
    CHUNK_PRE,
    Command,
    DownEvent,
    ElectionTimeout,
    FromPeer,
    HeartbeatRpc,
    InstallSnapshotAck,
    InstallSnapshotResult,
    InstallSnapshotRpc,
    LogEvent,
    NodeEvent,
    ServerId,
    Tick,
    USR,
)
from ra_tpu_torch.server import (
    AWAIT_CONDITION,
    CANDIDATE,
    ConditionTimeout,
    FOLLOWER,
    LEADER,
    PRE_VOTE,
    RECEIVE_SNAPSHOT,
    Server,
)


class SnapshotSender:
    """Chunked snapshot sender to one peer (the reference spawns a
    transient process per transfer: src/ra_server_proc.erl:1691-1735).

    The snapshot payload (meta, body source, live entries) is captured
    on the owning proc thread *before* this thread starts — the log is
    single-owner and must not be read concurrently. Preferred body
    source is ``chunk_iter``, a byte-chunk iterator reading the
    already-serialized body straight FROM DISK (the fd was opened at
    capture time, so the stream survives snapshot pruning) — peak sender
    memory is O(chunk), matching the reference's begin_read/read_chunk
    protocol (src/ra_snapshot.erl:135-210). ``state_obj`` is the
    fallback for memory-backed logs: pickled in one blob on this
    thread."""

    def __init__(
        self,
        proc: "ServerProc",
        to: ServerId,
        meta,
        state_obj,
        live_entries: list,
        term: int,
        chunk_size: int,
        chunk_iter=None,
    ):
        self.proc = proc
        self.to = to
        self.meta = meta
        self.state_obj = state_obj
        self.chunk_iter = chunk_iter
        self.chunk_size = chunk_size
        self.live_entries = live_entries
        self.term = term
        self.acks: "threading.Condition" = threading.Condition()
        self.last_ack: int = -1
        # receiver-paced credit window (docs/INTERNALS.md §21): highest
        # chunk_no the receiver has authorized = last ack's chunk_no +
        # its granted credits. Old-format acks default credits=1, which
        # reproduces stop-and-wait exactly.
        self.window_until: int = 0
        self.result: Optional[InstallSnapshotResult] = None
        self.thread = threading.Thread(
            target=self._run, name=f"ra-snap-send-{to[0]}", daemon=True
        )

    def start(self) -> None:
        self.thread.start()

    def on_ack(self, ack: InstallSnapshotAck) -> None:
        with self.acks:
            self.last_ack = max(self.last_ack, ack.chunk_no)
            credits = max(0, getattr(ack, "credits", 1))
            self.window_until = max(self.window_until, ack.chunk_no + credits)
            self.acks.notify()

    def on_result(self, res: InstallSnapshotResult) -> None:
        with self.acks:
            self.result = res
            self.acks.notify()

    def _await_ack(self, chunk_no: int, timeout: float) -> str:
        """-> "ack" | "result" (terminal reply: stop streaming) |
        "timeout". Wall clock on purpose (clock-seam audit, INTERNALS
        §19): this blocks a real Condition on a real sender thread —
        paths the simulation plane never runs."""
        deadline = time.monotonic() + timeout
        with self.acks:
            while True:
                if self.result is not None:
                    return "result"
                if self.last_ack >= chunk_no:
                    return "ack"
                left = deadline - time.monotonic()
                if left <= 0:
                    return "timeout"
                self.acks.wait(timeout=left)

    def _acquire_credit(self, no: int, timeout: float, send) -> str:
        """Block until the receiver's credit window covers chunk ``no``
        -> "ok" | "result" | "timeout". Credits ride acks, and a
        storage-blocked receiver grants 0 — with no chunks in flight it
        would never ack again, so starvation is probed by re-sending an
        already-acked chunk number (a duplicate the receiver re-acks
        with its CURRENT grant, without appending). Starvation past the
        ack timeout fails the transfer into the existing
        backoff-and-retry machinery (docs/INTERNALS.md §21)."""
        deadline = time.monotonic() + timeout
        while True:
            with self.acks:
                if self.result is not None:
                    return "result"
                if self.window_until >= no:
                    return "ok"
                left = deadline - time.monotonic()
                if left <= 0:
                    return "timeout"
                starved = not self.acks.wait(timeout=min(0.5, left))
                probe_no = self.last_ack
            if starved and probe_no >= 0:
                # outside the lock: transports may deliver inline
                count = getattr(self.proc.server, "_c", None)
                if count is not None:
                    count("snapshot_credit_waits")
                send(probe_no, CHUNK_NEXT)

    def _run(self) -> None:
        proc = self.proc
        try:
            if self.chunk_iter is not None:
                chunk_src = self.chunk_iter  # lazy reads from disk
            else:
                # memory-backed fallback: serialization happens HERE,
                # off the consensus threads — the state object was
                # captured immutably by the owning thread
                import pickle

                blob = pickle.dumps(self.state_obj)
                cs = self.chunk_size
                chunk_src = iter(
                    [blob[o : o + cs] for o in range(0, max(len(blob), 1), cs)]
                    or [b""]
                )
            timeout = proc.snapshot_ack_timeout_s

            def send(no, phase, data=b""):
                proc.transport.send(
                    self.to,
                    InstallSnapshotRpc(
                        term=self.term, leader_id=proc.server.id, meta=self.meta,
                        chunk_no=no, chunk_phase=phase, data=data,
                    ),
                    from_sid=proc.server.id,
                )

            def finish_on(status) -> bool:
                if status == "timeout":
                    proc.enqueue(("snapshot_send_failed", self.to))
                    return True
                if status == "result":
                    # terminal reply mid-transfer (e.g. stale term):
                    # surface it and stop streaming
                    proc.enqueue(("snapshot_send_done", self.to, self.result))
                    return True
                return False

            send(0, CHUNK_INIT)
            if finish_on(self._await_ack(0, timeout)):
                return
            no = 1
            if self.live_entries:
                send(no, CHUNK_PRE, self.live_entries)
                if finish_on(self._await_ack(no, timeout)):
                    return
                no += 1
            # body chunks stream under the receiver-granted credit
            # window (in-flight <= credits; old acks grant 1, which IS
            # stop-and-wait) — a one-chunk lookahead tags the final
            # chunk CHUNK_LAST while holding at most two chunks in
            # memory
            pending = next(chunk_src, b"")
            for chunk in chunk_src:
                if finish_on(self._acquire_credit(no, timeout, send)):
                    return
                send(no, CHUNK_NEXT, pending)
                no += 1
                pending = chunk
            if finish_on(self._acquire_credit(no, timeout, send)):
                return
            send(no, CHUNK_LAST, pending)
            # final result arrives as InstallSnapshotResult; wait for it
            deadline = time.monotonic() + timeout
            with self.acks:
                while self.result is None and time.monotonic() < deadline:
                    self.acks.wait(timeout=0.1)
            if self.result is None:
                proc.enqueue(("snapshot_send_failed", self.to))
            else:
                proc.enqueue(("snapshot_send_done", self.to, self.result))
        except Exception:  # noqa: BLE001
            proc.enqueue(("snapshot_send_failed", self.to))


class ServerProc:
    def __init__(self, node, server: Server):
        self.node = node
        self.server = server
        self.transport = node.transport
        self.timers = node.timers
        self.clock = getattr(node, "clock", None)
        if self.clock is None:
            from ra_tpu_torch.runtime.clock import WALL

            self.clock = WALL
        self.name = server.id[0]
        self.actor = node.scheduler.actor(self.name, self._on_batch)
        self.tick_interval_s = node.tick_interval_s
        self.election_timeout_s = node.election_timeout_s
        self.snapshot_ack_timeout_s = 120.0
        # default await_condition hold before the condition's timeout
        # path runs (reference: ?DEFAULT_AWAIT_CONDITION_TIMEOUT 30 s,
        # src/ra_server_proc.erl:69); a Condition can override per-hold
        self.await_condition_timeout_s = getattr(
            node, "await_condition_timeout_s", 30.0
        )
        self._election_ref: Optional[int] = None
        self._condition_ref: Optional[int] = None
        self._tick_ref: Optional[int] = None
        self.last_leader_contact: float = self.clock.monotonic()
        # commit-rate gauge (reference: ra_li leaky integrator driving the
        # commit_rate overview gauge)
        from ra_tpu_torch.li import LeakyIntegrator

        self._commit_rate = LeakyIntegrator()
        # seed with the recovered commit index so the first sample
        # measures new traffic, not the entire recovered history
        self._last_commit_sample = (self.clock.monotonic(), server.commit_index)
        self._senders: Dict[ServerId, SnapshotSender] = {}
        self._snap_retry: Dict[ServerId, Any] = {}  # peer -> retry timer ref
        self._machine_timers: Dict[Any, int] = {}
        # buffered low-priority commands (reference: ra_ets_queue)
        from collections import deque as _deque

        self._low_q = _deque()
        self._stale_h = None  # lazy follower_read_staleness histogram
        self.running = True
        self._set_tick_timer()
        # a server that starts without evidence of a LIVE leader must arm
        # an election timer, or a restarted ex-leader (leader_id == self,
        # excluded from every suspicion check) wedges the whole cluster:
        # the behind followers lose pre-votes against its longer log and
        # IT never stands (reference: servers arm a state timeout on
        # entering follower after recovery). First AER contact disarms.
        if (
            server.role == FOLLOWER
            and server.is_voter_self()
            and (server.leader_id is None or server.leader_id == server.id)
        ):
            self.arm_election_timer()
        self._update_state_table()

    # ------------------------------------------------------------------

    def enqueue(self, msg: Any, front: bool = False) -> None:
        self.actor.send(msg, front=front)

    def _stop_self(self) -> None:
        try:
            self.node.stop_server(self.name)
        except Exception:  # noqa: BLE001 — already stopped is fine
            pass

    def kill(self) -> None:
        self.running = False
        self.timers.cancel(self._tick_ref)
        self.timers.cancel(self._election_ref)
        self.actor.kill()

    # ------------------------------------------------------------------

    # max low-priority commands appended per drain (reference:
    # ?FLUSH_COMMANDS_SIZE, src/ra_server.hrl:34)
    FLUSH_COMMANDS_SIZE = 16

    def _on_batch(self, batch: List[Any]) -> None:
        server = self.server
        i = 0
        n = len(batch)
        while i < n:
            msg = batch[i]
            # coalesce consecutive client commands into one core call;
            # low-priority commands are set aside and drained in bounded
            # slices after normal traffic (reference: ra_ets_queue lane,
            # src/ra_server_proc.erl:507-530)
            if isinstance(msg, Command) and server.role == LEADER:
                cmds = [msg]
                while i + 1 < n and isinstance(batch[i + 1], Command):
                    i += 1
                    cmds.append(batch[i])
                low = [c for c in cmds if c.priority == "low"]
                if low:
                    self._low_q.extend(low)
                    cmds = [c for c in cmds if c.priority != "low"]
                effects = (
                    server.handle(cmds if len(cmds) > 1 else cmds[0])
                    if cmds
                    else []
                )
            elif isinstance(msg, tuple) and msg and msg[0] == "flush_low":
                effects = []  # drain happens below once per batch
            elif isinstance(msg, tuple) and msg and msg[0] in (
                "snapshot_send_done",
                "snapshot_send_failed",
            ):
                effects = self._handle_sender_event(msg)
            elif isinstance(msg, tuple) and msg and msg[0] == "reclaim_storage":
                self._reclaim_storage()
                effects = []
            elif isinstance(msg, tuple) and msg and msg[0] in (
                "local_query",
                "leader_query",
                "state_query",
                "consistent_query",
            ):
                effects = self._handle_query(msg)
            elif isinstance(msg, FromPeer) and isinstance(
                msg.msg, (InstallSnapshotAck, InstallSnapshotResult)
            ) and msg.peer in self._senders:
                sender = self._senders[msg.peer]
                if isinstance(msg.msg, InstallSnapshotAck):
                    sender.on_ack(msg.msg)
                else:
                    sender.on_result(msg.msg)
                effects = []
            else:
                if isinstance(msg, FromPeer):
                    self._note_contact(msg)
                elif isinstance(msg, Tick):
                    self._sample_commit_rate()
                    if server.role == LEADER:
                        # reconnect probing: peers marked disconnected by
                        # failed sends are retried once reachable again
                        # (the reference flips status on nodeup; proc
                        # restarts on a live node need the same)
                        for sid, p in server.peers().items():
                            if p.status == "disconnected" and self.transport.proc_alive(sid):
                                p.status = "normal"
                effects = server.handle(msg)
            self._execute(effects)
            i += 1
        if self._low_q and server.role == LEADER:
            take = [
                self._low_q.popleft()
                for _ in range(min(self.FLUSH_COMMANDS_SIZE, len(self._low_q)))
            ]
            self._execute(server.handle(take if len(take) > 1 else take[0]))
            if self._low_q:
                # keep the actor hot until the lane drains (dedicated
                # sentinel: a synthetic Tick would run the full leader
                # tick and skew the commit-rate gauge per slice)
                self.enqueue(("flush_low",))
        self._update_state_table()

    def _note_contact(self, msg: FromPeer) -> None:
        """A message from a live leader disarms the election timer. A
        stale in-flight message from an already-dead sender is NOT
        liveness evidence — without this check a dead leader's last AERs
        can cancel the armed timer and leave the cluster leaderless."""
        if not isinstance(msg.msg, (AppendEntriesRpc, InstallSnapshotRpc, HeartbeatRpc)):
            return
        self.last_leader_contact = self.clock.monotonic()
        if (
            self.server.role in (FOLLOWER, AWAIT_CONDITION, RECEIVE_SNAPSHOT)
            and self._election_ref is not None
            and self.transport.proc_alive(msg.peer)
        ):
            self.timers.cancel(self._election_ref)
            self._election_ref = None

    def _handle_query(self, msg) -> List[fx.Effect]:
        """Queries served at the proc layer (reference: ra_server_proc
        query/5 handling — local/leader direct, consistent via the core's
        heartbeat round)."""
        server = self.server
        kind = msg[0]
        if kind == "consistent_query":
            _, fn, fut = msg
            if server.role == LEADER:
                return server.handle(("consistent_query", fn, fut))
            self._reply(fut, ("redirect", server.leader_id))
            return []
        if kind == "local_query":
            # ("local_query", fn, fut) or a 4-tuple carrying the
            # caller's max_staleness_s bound: the bounded form only
            # answers when the leader-stamped freshness floor proves
            # local state is recent enough (docs/INTERNALS.md §20);
            # otherwise ("stale", bound, leader_hint) so the caller can
            # retry against the leader
            fn, fut = msg[1], msg[2]
            if len(msg) > 3 and msg[3] is not None:
                staleness = server.read_staleness_s()
                self._staleness_hist().record_seconds(
                    min(staleness, 3600.0)
                )
                if staleness > msg[3]:
                    server._c("read_stale_rejected")
                    self._reply(fut, ("stale", staleness, server.leader_id))
                    return []
                server._c("read_local_bounded")
            self._reply(fut, ("ok", fn(server.machine_state), server.leader_id))
            return []
        _, fn, fut = msg
        if kind == "state_query":
            self._reply(fut, ("ok", fn(server), server.leader_id))
        elif kind == "leader_query":
            if server.role == LEADER:
                self._reply(fut, ("ok", fn(server.machine_state), server.id))
            else:
                self._reply(fut, ("redirect", server.leader_id))
        return []

    def _staleness_hist(self):
        if self._stale_h is None:
            from ra_tpu_torch import obs as _obs

            self._stale_h = _obs.staleness_hist(self.server.id[1])
        return self._stale_h

    def _reclaim_storage(self) -> None:
        """Emergency reclamation on the owning thread (storage-pressure
        plane, docs/INTERNALS.md §21): force a machine snapshot at the
        applied index — bypassing min_snapshot_interval — which
        truncates memtables, retires segments, prunes superseded
        snapshots/checkpoints, and schedules minor-driven compaction;
        then run one explicit major compaction pass. Best-effort: a
        snapshot write that itself hits ENOSPC leaves the log exactly
        as it was."""
        srv = self.server
        try:
            idx = srv.last_applied
            snap = srv.log.snapshot_index_term()
            if idx > (snap[0] if snap else 0):
                mac = srv.machine.which_module(srv.effective_machine_version)
                srv.log.force_snapshot(
                    idx, tuple(srv.members()), srv.effective_machine_version,
                    srv.machine_state,
                    live_indexes=tuple(mac.live_indexes(srv.machine_state)),
                )
                if srv.log.snapshot_index_term() != snap:
                    srv._c("snapshots_written")
                    srv._c("releases")
            srv.log.major_compaction()
        except Exception:  # noqa: BLE001 — reclamation must never kill
            pass  # the proc; the watermark tick just retries

    def _handle_sender_event(self, msg) -> List[fx.Effect]:
        if msg[0] == "snapshot_send_done":
            _, to, result = msg
            self._senders.pop(to, None)
            return self.server.handle(result, from_peer=to)
        _, to = msg
        self._senders.pop(to, None)
        # exponential backoff instead of an immediate pipeline retry
        # (reference: snapshot_sender_exponential_backoff)
        return self.server.handle(("snapshot_sender_down", to, "failed"))

    # ------------------------------------------------------------------
    # effect executor (reference: handle_effects src/ra_server_proc.erl:1530)

    def _execute(self, effects: List[fx.Effect]) -> None:
        # machine append effects are collected and front-enqueued as one
        # ordered block after the loop — per-effect appendleft would
        # reverse their relative order vs the reference's in-order
        # next_event realisation (src/ra_server_proc.erl:1604-1615)
        appends: List[Command] = []
        for eff in effects:
            if isinstance(eff, fx.SendRpc):
                ok = self.transport.send(eff.to, eff.msg, from_sid=self.server.id)
                if not ok:
                    peer = self.server.cluster.get(eff.to)
                    if peer is not None and peer.status == "normal":
                        peer.status = "disconnected"
            elif isinstance(eff, fx.SendVoteRequests):
                for to, rpc in eff.requests:
                    self.transport.send(to, rpc, from_sid=self.server.id)
            elif isinstance(eff, fx.NextEvent):
                m = eff.msg
                self.enqueue(m, front=True)
            elif isinstance(eff, fx.Reply):
                self._reply(eff.from_ref, eff.reply)
            elif isinstance(eff, fx.Notify):
                self.node.notify_client(eff.who, self.server.id, list(eff.correlations))
            elif isinstance(eff, fx.SendMsg):
                self.node.send_msg(eff.to, eff.msg, eff.options)
            elif isinstance(eff, fx.RecordLeader):
                leaderboard.record(eff.cluster_name, eff.leader, eff.members)
            elif isinstance(eff, fx.SendSnapshot):
                self._start_snapshot_sender(eff.to)
            elif isinstance(eff, fx.StateEnter):
                self._on_state_enter(eff.role)
            elif isinstance(eff, fx.StopServer):
                # the server's own removal committed: terminate off the
                # actor thread (stop_server joins this actor); the
                # proc-down broadcast lets the rest of the cluster elect
                threading.Thread(
                    target=self._stop_self, name=f"ra-stop-{self.name}",
                    daemon=True,
                ).start()
            elif isinstance(eff, fx.StartSnapshotRetryTimer):
                self._arm_snapshot_retry(eff.to, eff.delay_ms)
            elif isinstance(eff, fx.Timer):
                self._machine_timer(eff)
            elif isinstance(eff, fx.ModCall):
                try:
                    eff.fn(*eff.args)
                except Exception:  # noqa: BLE001
                    pass
            elif isinstance(eff, fx.BgWork):
                self.node.submit_bg(eff, key=self.server.cfg.uid)
            elif isinstance(eff, fx.Monitor):
                self.node.monitors.add(self.server.id, eff.kind, eff.target, eff.component)
            elif isinstance(eff, fx.Demonitor):
                self.node.monitors.remove(self.server.id, eff.kind, eff.target)
            elif isinstance(eff, fx.LogRead):
                entries = self.server.log.sparse_read(list(eff.indexes))
                out = eff.fn(entries)
                if out is not None:
                    self.enqueue(out)
            elif isinstance(eff, fx.Aux):
                self.enqueue(("aux", "cast", eff.cmd, None))
            elif isinstance(eff, fx.Append):
                # leader-only machine append, re-entering as a command
                # (reference: {append, ...} -> next_event,
                # src/ra_server_proc.erl:1604-1609)
                if self.server.role == LEADER:
                    appends.append(Command(
                        kind=USR, data=eff.cmd, reply_mode=eff.reply_mode,
                        from_ref=eff.from_ref, internal=True,
                    ))
            elif isinstance(eff, fx.TryAppend):
                # attempted in ANY raft state; a non-leader's command
                # routing redirects it (reference:
                # src/ra_server_proc.erl:1610-1615). Only the leader's
                # copy carries the reply ref — every replica realises
                # this effect, and a follower's redirect must not race
                # the leader's ok on the same future
                appends.append(Command(
                    kind=USR, data=eff.cmd, reply_mode=eff.reply_mode,
                    from_ref=(
                        eff.from_ref if self.server.role == LEADER else None
                    ),
                    internal=True,
                ))
        # front-enqueue in reverse so the mailbox reads in emission order
        for cmd in reversed(appends):
            self.enqueue(cmd, front=True)

    def _reply(self, from_ref: Any, reply: Any) -> None:
        setter = getattr(from_ref, "set_result", None)
        if setter is not None:
            setter(reply)
        elif callable(from_ref):
            from_ref(reply)

    # ------------------------------------------------------------------
    # timers

    def _set_tick_timer(self) -> None:
        if not self.running:
            return
        self._tick_ref = self.timers.after(self.tick_interval_s, self._on_tick)

    def _on_tick(self) -> None:
        if not self.running:
            return
        self.enqueue(Tick(now_ms=int(self.clock.time() * 1000)))
        self._set_tick_timer()

    def _sample_commit_rate(self) -> None:
        """Runs on the actor thread (single-owner server state)."""
        now = self.clock.monotonic()
        prev_t, prev_ci = self._last_commit_sample
        ci = self.server.commit_index
        rate = self._commit_rate.sample(max(0, ci - prev_ci), now - prev_t)
        self._last_commit_sample = (now, ci)
        if self.server.counter is not None:
            # round, don't truncate: sub-1/s rates must not read as idle
            self.server.counter.put("commit_rate", int(round(rate)))

    def arm_election_timer(self, immediate: bool = False) -> None:
        from ra_tpu_torch.runtime.timers import randomized_election_timeout

        if not self.running:
            return
        self.timers.cancel(self._election_ref)
        delay = 0.0 if immediate else randomized_election_timeout(self.election_timeout_s)
        self._election_ref = self.timers.after(delay, self._on_election_timeout)

    def _on_election_timeout(self) -> None:
        self._election_ref = None
        if self.running:
            self.enqueue(ElectionTimeout())

    def _on_condition_timeout(self, generation: int) -> None:
        self._condition_ref = None
        if self.running:
            self.enqueue(ConditionTimeout(generation=generation))

    def _on_state_enter(self, role: str) -> None:
        if role != LEADER and self._low_q:
            # leadership lost with lows still buffered: drop them —
            # replaying them under a later term would double-apply
            # commands the client already resent to the new leader
            # (pipeline commands are at-most-once; clients track
            # correlations). A buffered command with a reply future must
            # hear the redirect, not hang until timeout.
            leader = self.server.leader_id
            for cmd in self._low_q:
                fut = getattr(cmd, "from_ref", None)
                if fut is not None:
                    self._reply(fut, ("redirect", leader))
            self._low_q.clear()
        if role != AWAIT_CONDITION and self._condition_ref is not None:
            self.timers.cancel(self._condition_ref)
            self._condition_ref = None
        if role in (PRE_VOTE, CANDIDATE):
            self.arm_election_timer()  # retry a stalled election round
        elif role == AWAIT_CONDITION:
            # the condition timer runs the Condition's timeout path
            # (repeating a catch-up failure reply, falling back to
            # leader); the election timer is armed ONLY with leaderless
            # evidence — a transferring ex-leader or a holding follower
            # whose leader is alive must not start disruptive pre-votes
            # (the failure detector arms it if the leader dies later)
            leader = self.server.leader_id
            if (
                leader is not None
                and leader != self.server.id
                and not self.transport.proc_alive(leader)
                and self.server.is_voter_self()
            ):
                self.arm_election_timer()
            else:
                self.timers.cancel(self._election_ref)
                self._election_ref = None
            cond = self.server.condition
            dur_s = self.await_condition_timeout_s
            if cond is not None and cond.timeout_duration_ms is not None:
                dur_s = cond.timeout_duration_ms / 1000.0
            gen = self.server.condition_generation
            self.timers.cancel(self._condition_ref)
            self._condition_ref = self.timers.after(
                dur_s, lambda: self._on_condition_timeout(gen)
            )
        elif role == LEADER:
            self.timers.cancel(self._election_ref)
            self._election_ref = None
        elif role == FOLLOWER:
            # reverting to follower on a stale message from a dead leader
            # must keep an election pending, or the cluster livelocks
            leader = self.server.leader_id
            if (
                leader is not None
                and leader != self.server.id
                and not self.transport.proc_alive(leader)
                and self.server.is_voter_self()
            ):
                self.arm_election_timer()
            else:
                self.timers.cancel(self._election_ref)
                self._election_ref = None

    def _machine_timer(self, eff: fx.Timer) -> None:
        old = self._machine_timers.pop(eff.name, None)
        self.timers.cancel(old)
        if eff.ms is None:
            return

        def fire():
            self._machine_timers.pop(eff.name, None)
            if self.running and self.server.role == LEADER:
                from ra_tpu_torch.protocol import USR

                self.enqueue(Command(kind=USR, data=("timeout", eff.name),
                                     internal=True))

        self._machine_timers[eff.name] = self.timers.after(eff.ms / 1000.0, fire)

    # ------------------------------------------------------------------

    def _arm_snapshot_retry(self, to: ServerId, delay_ms: int) -> None:
        old = self._snap_retry.pop(to, None)
        self.timers.cancel(old)

        def fire():
            self._snap_retry.pop(to, None)
            if self.running:
                self.enqueue(("snapshot_retry_timeout", to))

        self._snap_retry[to] = self.timers.after(delay_ms / 1000.0, fire)

    def _start_snapshot_sender(self, to: ServerId) -> None:
        from ra_tpu_torch.server import status_kind

        if to in self._senders:
            return
        old = self._snap_retry.pop(to, None)
        self.timers.cancel(old)
        peer = self.server.cluster.get(to)
        # a retry emits SendSnapshot while the peer still carries its
        # snapshot_backoff count; the send flips it to sending_snapshot
        # WITH the count so another death keeps backing off
        if peer is not None and status_kind(peer.status) == "snapshot_backoff":
            peer.status = ("sending_snapshot", peer.status[1])
        # capture the payload here, on the proc thread: the log is
        # single-owner and must not be read from the sender thread.
        # Prefer the disk-streaming reader (no decode, no blob) and fall
        # back to the whole-state read for memory-backed logs
        chunk_size = self.node.config.snapshot_chunk_size
        state = None
        chunk_iter = None
        stream = self.server.log.begin_snapshot_read(chunk_size)
        if stream is not None:
            meta, chunk_iter = stream
        else:
            got = self.server.log.read_snapshot()
            if got is None:
                if peer is not None and status_kind(peer.status) == "sending_snapshot":
                    peer.status = "normal"
                return
            meta, state = got
        live_entries = (
            self.server.log.sparse_read(list(meta.live_indexes))
            if meta.live_indexes
            else []
        )
        sender = SnapshotSender(
            self, to, meta, state, live_entries, self.server.current_term,
            chunk_size, chunk_iter=chunk_iter,
        )
        self._senders[to] = sender
        sender.start()

    def _update_state_table(self) -> None:
        self.node.ra_state[self.server.cfg.uid] = (
            self.name,
            self.server.role,
            self.server.leader_id,
        )

    # ------------------------------------------------------------------
    # failure-detector input

    def on_monitor_down(self, target, info, component: str) -> None:
        """Dispatch a monitor DOWN to the registered component
        (reference: ra_monitors routes DOWNs to machine / aux /
        snapshot_sender, src/ra_monitors.erl:10-22)."""
        if component == "aux":
            self.enqueue(("aux", "cast", ("down", target, info), None))
        elif component == "snapshot_sender":
            # treat like a failed transfer to that peer: backoff/retry
            if target in self._senders:
                self.enqueue(("snapshot_send_failed", target))
        else:  # "machine" (default): the down builtin via consensus
            self.enqueue(DownEvent(target, info))

    def on_node_event(self, node_name: str, status: str) -> None:
        """Called (via mailbox) when the failure detector flips a node."""
        srv = self.server
        if status == "down":
            leader = srv.leader_id
            if (
                srv.role in (FOLLOWER, AWAIT_CONDITION)
                and leader is not None
                and leader[1] == node_name
                and srv.is_voter_self()
            ):
                self.arm_election_timer()
        if srv.role == LEADER:
            self.enqueue(NodeEvent(node_name, status))
