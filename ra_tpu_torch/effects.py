"""Effects returned by the pure consensus core and by user machines.

The core never performs I/O: every transition returns
``(next_role, state, effects)`` and the runtime realises the effects —
the same contract as the reference (reference: ``src/ra_machine.erl:
131-159`` for the machine-effect vocabulary and ``src/ra_server_proc.erl:
1530-1861`` for the executor). Effects here are plain dataclasses so the
batch coordinator can serialize them out of a device step cheaply.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ra_tpu_torch.protocol import ServerId


class Effect:
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class SendRpc(Effect):
    to: ServerId
    msg: Any


@dataclasses.dataclass(frozen=True)
class SendVoteRequests(Effect):
    # [(peer, RequestVoteRpc | PreVoteRpc)] — realised as parallel calls
    requests: Tuple[Tuple[ServerId, Any], ...]


@dataclasses.dataclass(frozen=True)
class SendSnapshot(Effect):
    to: ServerId
    # runtime spawns a chunked sender for this peer
    meta: Any = None


@dataclasses.dataclass(frozen=True)
class Reply(Effect):
    from_ref: Any
    reply: Any


@dataclasses.dataclass(frozen=True)
class Notify(Effect):
    """Deliver applied-notifications: who -> list of correlations."""

    who: Any
    correlations: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class SendMsg(Effect):
    """Machine effect: send an arbitrary message to a pid/actor.

    options: subset of {"ra_event", "cast", "local"} (reference:
    src/ra_machine.erl send_msg options).
    """

    to: Any
    msg: Any
    options: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ModCall(Effect):
    fn: Callable
    args: Tuple[Any, ...] = ()


@dataclasses.dataclass(frozen=True)
class Monitor(Effect):
    kind: str  # "process" | "node"
    target: Any
    component: str = "machine"  # machine | snapshot_sender | aux


@dataclasses.dataclass(frozen=True)
class Demonitor(Effect):
    kind: str
    target: Any
    component: str = "machine"


@dataclasses.dataclass(frozen=True)
class Append(Effect):
    """Machine effect: append ``cmd`` as a NEW user command to the raft
    log — leader-only, silently dropped elsewhere (reference:
    ``{append, Cmd}`` / ``{append, Cmd, ReplyMode}``,
    src/ra_machine.erl:131-159, realised as a next_event command,
    src/ra_server_proc.erl:1604-1609)."""

    cmd: Any
    reply_mode: Any = "noreply"
    from_ref: Any = None


@dataclasses.dataclass(frozen=True)
class TryAppend(Effect):
    """Like :class:`Append` but attempted in ANY raft state — a
    non-leader routes it like any client command (redirect/drop)
    (reference: ``{try_append, Cmd, ReplyMode}``,
    src/ra_server_proc.erl:1610-1615)."""

    cmd: Any
    reply_mode: Any = "noreply"
    from_ref: Any = None


@dataclasses.dataclass(frozen=True)
class Timer(Effect):
    """Machine timer: deliver {timeout, name} to apply after ms (None
    cancels)."""

    name: Any
    ms: Optional[int]


@dataclasses.dataclass(frozen=True)
class LogRead(Effect):
    """Machine effect: read log indexes and feed them back via fn."""

    indexes: Tuple[int, ...]
    fn: Callable[[Sequence[Any]], Any]


@dataclasses.dataclass(frozen=True)
class ReleaseCursor(Effect):
    index: int
    machine_state: Any
    # optional gating conditions (reference: conditional release
    # cursors, src/ra_server.erl:2455-2479): ("written", idx) defers
    # until the log's durable watermark covers idx; "no_snapshot_sends"
    # defers while any peer is mid-snapshot-transfer. Unmet conditions
    # stash the cursor; it re-fires when they become true.
    conditions: Tuple[Any, ...] = ()


@dataclasses.dataclass(frozen=True)
class StartSnapshotRetryTimer(Effect):
    """Arm a retry for a peer whose snapshot sender died (reference:
    start_snapshot_retry_timer, src/ra_server.erl:204, exponential
    5000*2^(n-1) ms capped at 60 s)."""

    to: Any
    delay_ms: int


@dataclasses.dataclass(frozen=True)
class Checkpoint(Effect):
    index: int
    machine_state: Any


@dataclasses.dataclass(frozen=True)
class Aux(Effect):
    cmd: Any


@dataclasses.dataclass(frozen=True)
class NextEvent(Effect):
    """Re-inject a message into the server's own event loop."""

    msg: Any


@dataclasses.dataclass(frozen=True)
class RecordLeader(Effect):
    """Leader identity changed — update leaderboard/registry."""

    cluster_name: str
    leader: Optional[ServerId]
    members: Tuple[ServerId, ...]


@dataclasses.dataclass(frozen=True)
class BgWork(Effect):
    """Run fn on the server's background worker (snapshot write,
    compaction...); err_fn is called with the exception on failure."""

    fn: Callable[[], Any]
    err_fn: Optional[Callable[[BaseException], None]] = None


@dataclasses.dataclass(frozen=True)
class StateEnter(Effect):
    """Marker: role changed (runtime triggers machine state_enter)."""

    role: str


@dataclasses.dataclass(frozen=True)
class StopServer(Effect):
    """The server asked to be terminated (its own removal committed —
    reference: handle_leader returning {stop,...}). The runtime stops
    the proc; the resulting proc-down signal is what lets the remaining
    members arm elections."""


@dataclasses.dataclass(frozen=True)
class GarbageCollection(Effect):
    pass


EffectList = List[Effect]
