"""Wire protocol records.

Capability parity with the reference's protocol record definitions
(reference: ``src/ra.hrl:122-211``): AppendEntries carries full prev-idx/
term matching info; the AppendEntries *reply* carries the follower's
``next_index`` hint plus its ``last_index``/``last_term`` (a deliberate
deviation from vanilla Raft the reference relies on for stale-reply
detection); pre-vote carries a token and version info; install-snapshot is
chunked with an ``(num, phase)`` chunk state.

These records double as the schema for the TPU batch backend: every fixed-
width field here becomes a column in the device-resident RPC batch arrays
(see ra_tpu_torch.ops.consensus).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

ServerId = Tuple[str, str]  # (cluster-unique server name, node name)


class Entry(NamedTuple):
    # NamedTuple, not dataclass: entries/commands are created on the
    # per-command hot path (frozen-dataclass __init__ costs ~4x more).
    # NOTE: this changed the pickle format of durable records pre-1.0 —
    # WAL/segment files written by earlier revisions do not unpickle
    index: int
    term: int
    cmd: Any  # Command


# -- commands stored in the log -------------------------------------------

USR = "usr"  # user machine command
NOOP = "noop"  # leader-election noop (carries machine version)
RA_JOIN = "ra_join"
RA_LEAVE = "ra_leave"
RA_CLUSTER_CHANGE = "ra_cluster_change"


class Command(NamedTuple):
    kind: str  # one of the constants above
    data: Any = None
    # reply mode: "after_log_append" | "await_consensus" | "noreply"
    # | ("notify", corr, caller)
    reply_mode: Any = "noreply"
    # caller ref for synchronous replies (opaque to the core)
    from_ref: Any = None
    machine_version: int = 0  # only meaningful for NOOP
    # "normal" | "low": low-priority commands are buffered behind normal
    # traffic and drained in bounded slices (reference: ra_ets_queue +
    # FLUSH_COMMANDS_SIZE, src/ra_server_proc.erl:160,507-530)
    priority: str = "normal"
    # machine-internal must-deliver commands (timer fires, Append/
    # TryAppend effects): fired exactly once with no retry path, so the
    # admission window must never shed them (client commands are
    # rejected/dropped instead — they have a caller or owe no ack)
    internal: bool = False
    # optional submit timestamp (time.monotonic_ns at client submit).
    # Commands carrying one are eligible for commit-latency stage
    # sampling (obs.COMMIT_STAGES); None opts out — internal commands
    # and bare constructions never pay the sampling cost
    ts: Any = None


# -- snapshot metadata -----------------------------------------------------


def strip_entry_refs(entries: "Tuple[Entry, ...]") -> "Tuple[Entry, ...]":
    """Drop process-ephemeral fields from entries about to cross a
    process boundary (replication / snapshot pre-chunks): reply handles
    (the leader keeps them in its pending-reply table; remote copies
    never need them) and the volatile submit timestamp (``ts`` is a
    LOCAL monotonic stamp — another machine's clock base makes it
    meaningless, and latency sampling must never compare across)."""
    out = []
    changed = False
    for e in entries:
        cmd = e.cmd
        if isinstance(cmd, Command) and (
            cmd.from_ref is not None or cmd.ts is not None
        ):
            out.append(
                Entry(e.index, e.term, cmd._replace(from_ref=None, ts=None))
            )
            changed = True
        else:
            out.append(e)
    return tuple(out) if changed else entries


def sanitize_for_wire(msg: Any) -> Any:
    """Make a protocol message safe to serialize across processes."""
    if isinstance(msg, Command) and msg.ts is not None:
        # the submit stamp is time.monotonic_ns() on the SENDING
        # machine; a remote leader comparing it against its own clock
        # base would record garbage submit_append samples — remote
        # commands simply opt out of commit-stage sampling
        return msg._replace(ts=None)
    if isinstance(msg, AppendEntriesRpc) and msg.entries:
        stripped = strip_entry_refs(msg.entries)
        if stripped is not msg.entries:
            return dataclasses.replace(msg, entries=stripped)
    if isinstance(msg, InstallSnapshotRpc) and msg.chunk_phase == CHUNK_PRE:
        data = msg.data
        if isinstance(data, (list, tuple)):
            return dataclasses.replace(
                msg, data=list(strip_entry_refs(tuple(data)))
            )
    return msg


# encode memo for the fan-out hot shape: ONE Command object rides to
# thousands of groups (the pipelined wave), and every group's log would
# re-pickle it. Keyed by id() and validated by identity — safe because
# the memo holds a strong reference, so a live entry's id cannot be
# reused by another object. Bounded FIFO; commands are immutable once
# submitted (NamedTuple), which is what makes the cache sound.
_ENC_MEMO: dict = {}
_ENC_ORDER: list = []


def encode_cmd(cmd: Any) -> bytes:
    """Serialize a log command for durable storage. Client reply handles
    (``from_ref``) are process-ephemeral — replies are never re-issued
    after a restart (same rule as the reference, INTERNALS.md:91-106) —
    so they are stripped before pickling, as is the volatile submit
    timestamp (``ts``): a monotonic stamp is meaningless across a
    restart, and stripping keeps identical payloads byte-identical on
    disk regardless of when they were submitted."""
    import pickle

    if isinstance(cmd, Command):
        if cmd.from_ref is not None or cmd.ts is not None:
            # never memoize stamped/reply-carrying commands: the memo
            # holds its key object strongly (that is what makes id()
            # keying sound), and pinning retired reply handles would
            # extend "process-ephemeral" arbitrarily. The fan-out hot
            # shape this cache exists for is a bare noreply Command;
            # per-run dedup of stamped ones is Log._bulk_insert's memo.
            return pickle.dumps(cmd._replace(from_ref=None, ts=None))
        key = id(cmd)
        hit = _ENC_MEMO.get(key)
        if hit is not None and hit[0] is cmd:
            return hit[1]
        out = pickle.dumps(cmd)
        _ENC_MEMO[key] = (cmd, out)
        _ENC_ORDER.append(key)
        if len(_ENC_ORDER) > 128:
            try:
                _ENC_MEMO.pop(_ENC_ORDER.pop(0), None)
            except IndexError:
                pass  # concurrent eviction: bound is approximate
        return out
    return pickle.dumps(cmd)


@dataclasses.dataclass(frozen=True)
class SnapshotMeta:
    index: int
    term: int
    cluster: Tuple[ServerId, ...]
    machine_version: int
    # sparse live indexes above `index` that must be retained in the log
    live_indexes: Tuple[int, ...] = ()


# -- RPCs ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AppendEntriesRpc:
    term: int
    leader_id: ServerId
    prev_log_index: int
    prev_log_term: int
    leader_commit: int
    entries: Tuple[Entry, ...] = ()
    # leader-computed hint: every entry in this batch is a plain USR
    # command (no noops/cluster changes). Lets the receiver skip the
    # per-entry specials/cluster scan on the write hot path; False is
    # always safe (receiver scans).
    plain_usr: bool = False
    # leader wall-clock stamp taken while leader_commit was current
    # (staleness-bounded follower reads, docs/INTERNALS.md §20). 0.0
    # when the sender runs lease-off — receivers then never advance
    # their freshness floor and bounded local reads stay conservative.
    commit_ts: float = 0.0


@dataclasses.dataclass(frozen=True)
class AppendEntriesReply:
    term: int
    success: bool
    # follower's expectation/bookkeeping (reference: src/ra.hrl:131-143)
    next_index: int
    last_index: int
    last_term: int


@dataclasses.dataclass(frozen=True)
class RequestVoteRpc:
    term: int
    candidate_id: ServerId
    last_log_index: int
    last_log_term: int
    # leadership-transfer (TimeoutNow) and force_shrink candidacies set
    # this so voters skip leader stickiness (§20): the old leader
    # revoked its lease before soliciting the vote, so deposing it
    # early is safe. Ordinary elections leave it False.
    force: bool = False


@dataclasses.dataclass(frozen=True)
class RequestVoteResult:
    term: int
    vote_granted: bool


@dataclasses.dataclass(frozen=True)
class PreVoteRpc:
    term: int
    token: Any
    candidate_id: ServerId
    version: int  # protocol version
    machine_version: int
    last_log_index: int
    last_log_term: int


@dataclasses.dataclass(frozen=True)
class PreVoteResult:
    term: int
    token: Any
    vote_granted: bool


# chunk phases for snapshot transfer
CHUNK_INIT = "init"  # first chunk of meta negotiation
CHUNK_PRE = "pre"  # sparse live entries preceding the snapshot body
CHUNK_NEXT = "next"
CHUNK_LAST = "last"


@dataclasses.dataclass(frozen=True)
class InstallSnapshotRpc:
    term: int
    leader_id: ServerId
    meta: SnapshotMeta
    chunk_no: int
    chunk_phase: str  # CHUNK_*
    data: Any = b""


@dataclasses.dataclass(frozen=True)
class InstallSnapshotResult:
    """Terminal reply: transfer complete (or stale-term rejection)."""

    term: int
    last_index: int
    last_term: int


@dataclasses.dataclass(frozen=True)
class InstallSnapshotAck:
    """Mid-transfer chunk ack consumed by the sender, not the consensus
    core."""

    term: int
    chunk_no: int
    # receiver-paced flow control (docs/INTERNALS.md §21): how many
    # further chunks the receiver is prepared to accept beyond
    # ``chunk_no``. Storage-blocked receivers grant 0 (the sender backs
    # off and retries instead of spooling onto a full disk). Default 1
    # keeps old-format acks (and pickled peers) on stop-and-wait.
    credits: int = 1


@dataclasses.dataclass(frozen=True)
class HeartbeatRpc:
    term: int
    leader_id: ServerId
    query_index: int


@dataclasses.dataclass(frozen=True)
class HeartbeatReply:
    term: int
    query_index: int


@dataclasses.dataclass(frozen=True)
class InfoRpc:
    """Peer-capability probe (reference: #info_rpc{} src/ra.hrl:202) —
    the leader discovers followers' supported machine versions to gate
    upgrade strategies."""

    term: int
    leader_id: ServerId


@dataclasses.dataclass(frozen=True)
class InfoReply:
    term: int
    machine_version: int


# Peer protocol traffic the transport contract allows to drop: every
# type here is periodically retried/resent by its sender (AER resend
# windows, election retry timers, heartbeat ticks), so a full ingress
# lane sheds it with a counter instead of blocking the producer
# (docs/INTERNALS.md §16 backpressure table). Everything NOT listed —
# client commands (they reject through the admission path), log
# events, snapshot chunks, queries — must never be silently dropped.
LOSSY_PROTOCOL_TYPES = frozenset((
    AppendEntriesRpc, AppendEntriesReply,
    RequestVoteRpc, RequestVoteResult,
    PreVoteRpc, PreVoteResult,
    HeartbeatRpc, HeartbeatReply,
))

# Client-visible admission reject reply: ``("reject", "overloaded")``,
# optionally extended with a third element — a ``threading.Event`` the
# server sets when the admission window (or a full ingress lane)
# releases, so ``api.process_command`` parks on the release instead of
# sleeping a fixed backoff. The gate is process-local (never pickled:
# rejects are generated by the node the client called).
REJECT_OVERLOADED = ("reject", "overloaded")

# Storage-degraded admission reject (docs/INTERNALS.md §21): the node's
# WAL hit a space-class failure (ENOSPC/EDQUOT) or the hard disk
# watermark pre-empted admission. Same shape and gate semantics as
# REJECT_OVERLOADED — the third element's Event opens when the probe
# write succeeds (or the watermark clears), so parked clients resume
# the moment storage recovers.
REJECT_NOSPACE = ("reject", "nospace")


# -- events delivered to the server core (non-peer messages) ---------------


@dataclasses.dataclass(frozen=True)
class ElectionTimeout:
    # detector-fired timeouts stamp the monotonic time the suspicion
    # was CONFIRMED; the handler drops the trigger when the group has
    # seen contact (or restarted its election window) since — a delayed
    # delivery (e.g. behind a long jit compile in the pipelined loop)
    # must not act on a stale observation and depose a fresh leader.
    # 0.0 (explicit operator/test triggers) always acts.
    armed_at: float = 0.0


@dataclasses.dataclass(frozen=True)
class TimeoutNow:
    """Leadership-transfer trigger: the target starts an election
    immediately, skipping pre-vote (Raft §3.10). Sent leader->target
    over the wire, so it lives with the protocol records."""


@dataclasses.dataclass(frozen=True)
class Tick:
    now_ms: int = 0


@dataclasses.dataclass(frozen=True)
class LogEvent:
    """Event from the log/WAL subsystem (written confirmations etc.)."""

    evt: Any


@dataclasses.dataclass(frozen=True)
class NodeEvent:
    node: str
    status: str  # "up" | "down"


@dataclasses.dataclass(frozen=True)
class DownEvent:
    """A monitored process/actor went down."""

    target: Any
    info: Any = None


@dataclasses.dataclass(frozen=True)
class FromPeer:
    """Envelope: message `msg` received from peer `peer`."""

    peer: ServerId
    msg: Any


# Ring item class codes — the flat tagged-item layout (docs/INTERNALS.md
# §18). Producers stamp one per published ring item so the native
# drain-classify pass (ra_tpu_torch.native.classify) can partition a drained
# burst with the GIL released; the Python routing half walks the
# partitions. RC_CMD_LOW / RC_CMDS_LOW carry the producer-side priority
# split that the classify loop would otherwise compute per item.
RC_MSG, RC_CMD, RC_CMD_LOW, RC_CMDS, RC_CMDS_LOW, RC_BATCH = range(6)
