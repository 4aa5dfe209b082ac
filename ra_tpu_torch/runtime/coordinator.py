"""Batch coordinator: many raft groups stepped together on the device.

The framework's north-star execution backend (``server_impl =
"tpu_batch"``): instead of one actor per group, one coordinator owns the
consensus decision state of *all* its groups as device arrays
(``ra_tpu_torch.ops.consensus.GroupState``) and advances them in fused steps —
one ``consensus_step`` call classifies up to one inbound message per
group and runs every group's quorum scan at once.

Division of labor (keeps host<->device traffic to one egress struct per
step):

- **device (authoritative)**: current_term, voted_for, role, votes,
  match_index, commit_index, log-tail bookkeeping + recent-term ring;
- **host (authoritative)**: log *contents* (WAL/memtable/segments),
  machine apply, client replies, outbound AER construction with its own
  ``next_index`` bookkeeping (host routes every inbound reply anyway, so
  both sides update their own variables from the same messages — no
  gathers needed);
- **rare paths** (election initiation, deep-backfill term lookups) run
  host-side against the post-step egress mirror, re-entering the device
  via scatters (``set_roles``/``record_appended``) and mailbox term
  overrides.

The coordinator registers in the node registry and speaks the same
transport/protocol as per-group ServerProcs, so batch-backed and
actor-backed members interoperate in one cluster. Replies leaving a step
are batched per destination node — thousands of groups' traffic rides
single transport hops.

Snapshot install/send for batch-backed groups is fully implemented:
``_receive_snapshot_chunk`` runs the 4-phase chunked accept (init/pre/
next/last) host-side and scatters the new floor to the device;
``_start_snapshot_sender`` spools + streams outbound transfers through
the shared ``SnapshotSender`` (see ``ra_tpu_torch/runtime/proc.py``); batch-
and actor-backed members interoperate in either direction.

This is the PyTorch port of ``ra_tpu.runtime.coordinator``: the host
logic is the reference's, line for line, and every tensor operation goes
through one ``DeviceSeam`` (``runtime/device.py``) on the explicit
``device`` the coordinator is built with (``"cuda"`` by default, which
raises when CUDA is absent; tests pass ``"cpu"``). With ``mesh=`` (a
sequence of N devices, repeats allowed) the group axis is cut into N
equal slices, one per device (``ShardedSeam``), each stepped by the
full-width step: on CUDA one step-kernel launch a slice. As in the
reference, a sharded coordinator never takes the active set.
"""

from __future__ import annotations

import logging
import pickle
import random
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ra_tpu_torch import effects as fx
from ra_tpu_torch import faults
from ra_tpu_torch import leaderboard
from ra_tpu_torch import native as _native
from ra_tpu_torch.log.api import LogApi
from ra_tpu_torch.log.log import Log
from ra_tpu_torch.log.memory import MemoryLog
from ra_tpu_torch.log.snapshot import SNAPSHOT
from ra_tpu_torch.machine import Machine, normalize_apply_result
from ra_tpu_torch.ops import consensus as C
from ra_tpu_torch.runtime.device import DeviceSeam, ShardedSeam
from ra_tpu_torch.runtime.timers import TimerService
from ra_tpu_torch.protocol import (
    AppendEntriesReply,
    AppendEntriesRpc,
    CHUNK_INIT,
    CHUNK_LAST,
    CHUNK_NEXT,
    CHUNK_PRE,
    Command,
    ElectionTimeout,
    TimeoutNow,
    Entry,
    FromPeer,
    HeartbeatReply,
    HeartbeatRpc,
    InstallSnapshotAck,
    InstallSnapshotResult,
    InstallSnapshotRpc,
    LOSSY_PROTOCOL_TYPES,
    NOOP,
    RC_BATCH,
    RC_CMD,
    RC_CMD_LOW,
    RC_CMDS,
    RC_CMDS_LOW,
    RC_MSG,
    REJECT_NOSPACE,
    SnapshotMeta,
    REJECT_OVERLOADED,
    PreVoteResult,
    PreVoteRpc,
    RA_CLUSTER_CHANGE,
    RA_JOIN,
    RA_LEAVE,
    RequestVoteResult,
    RequestVoteRpc,
    ServerId,
    USR,
)
from ra_tpu_torch.runtime.transport import InProcTransport, NodeRegistry, registry as node_registry

logger = logging.getLogger("ra_tpu_torch")

MSG_OF_TYPE = {
    AppendEntriesRpc: C.MSG_AER,
    AppendEntriesReply: C.MSG_AER_REPLY,
    RequestVoteRpc: C.MSG_VOTE_REQ,
    RequestVoteResult: C.MSG_VOTE_REPLY,
    PreVoteRpc: C.MSG_PREVOTE_REQ,
    PreVoteResult: C.MSG_PREVOTE_REPLY,
}

_NATIVE_PATHS = frozenset(("pack", "classify", "egress"))


def parse_native(spec) -> frozenset:
    """Parse a ``--native`` spec into the set of enabled native
    hot-loop paths: ``"auto"``/``"on"``/``True`` enable all three,
    ``"off"``/``"none"``/``False`` none, anything else a comma list
    over {pack, classify, egress} (docs/INTERNALS.md §18)."""
    if spec is True or spec in ("auto", "on", "all"):
        return _NATIVE_PATHS
    if not spec or spec in ("off", "none"):
        return frozenset()
    parts = frozenset(p.strip() for p in str(spec).split(",") if p.strip())
    unknown = parts - _NATIVE_PATHS
    if unknown:
        raise ValueError(f"unknown native paths {sorted(unknown)}")
    return parts


class GroupHost:
    """Host-side companion of one device-resident group."""

    __slots__ = (
        "gid", "name", "cluster_name", "members", "self_slot", "log",
        "machine", "machine_state", "last_applied", "role", "term",
        "leader_slot", "next_index", "commit_sent", "pending_replies",
        "inbox", "host_term_hint", "election_ref", "effective_machine_version",
        "pending_ack", "snap_accept", "snap_senders", "pre_vote_token",
        "voter_status", "cluster_change_permitted", "cluster_index",
        "pending_queries", "machine_timers", "has_tick", "snap_floor",
        "noop_index", "noop_committed", "query_seq", "cluster_history",
        "last_ack", "aux_state", "aux_inited", "last_contact", "low_q",
        "specials", "last_ok_sent", "fresh_tail", "match_hint", "lat",
        "_clock", "fresh_anchor", "fresh_ts", "lease_contact",
    )

    def __init__(self, gid, name, cluster_name, members, self_slot, log, machine,
                 clock=None):
        from ra_tpu_torch.runtime.clock import WALL

        self._clock = clock or WALL
        self.gid = gid
        self.name = name
        self.cluster_name = cluster_name
        self.members: List[ServerId] = list(members)
        self.self_slot = self_slot
        self.log: LogApi = log
        self.machine: Machine = machine
        self.machine_state = machine.init({"name": cluster_name})
        self.effective_machine_version = 0
        self.last_applied = 0
        self.role = C.R_FOLLOWER
        self.term = 0
        self.leader_slot = -1
        self.next_index = [1] * len(self.members)
        self.commit_sent = [0] * len(self.members)
        self.pending_replies: Dict[int, Any] = {}
        self.inbox: deque = deque()
        self.host_term_hint: Optional[Tuple[int, int]] = None
        self.election_ref = None
        # deferred AER ack awaiting WAL durability: (leader_sid, up_to_idx)
        self.pending_ack: Optional[Tuple[ServerId, int]] = None
        # inbound snapshot transfer state / outbound senders per peer
        self.snap_accept: Optional[Dict[str, Any]] = None
        self.snap_senders: Dict[ServerId, Any] = {}
        # host mirror of the device pre-vote round token (incremented in
        # lockstep with every set_roles(R_PRE_VOTE) scatter)
        self.pre_vote_token = 0
        # membership: voter status per slot ("voter" | ("nonvoter", tgt));
        # tombstoned slots hold None in self.members. One cluster change
        # in flight at a time (Raft one-at-a-time rule).
        self.voter_status: Dict[int, Any] = {
            i: "voter" for i in range(len(self.members))
        }
        self.cluster_change_permitted = True
        self.cluster_index = 0  # log index of the latest cluster change
        # consistent queries awaiting a leadership-confirmation quorum:
        # [{"qi": idx, "fn": fn, "fut": fut, "acks": set()}]
        self.pending_queries: List[Dict[str, Any]] = []
        self.machine_timers: Dict[Any, Any] = {}
        # a versioned container may delegate tick to its modules: check
        # the effective module as well as the container itself
        self.has_tick = (
            type(machine).tick is not Machine.tick
            or type(machine.which_module(machine.version())).tick
            is not Machine.tick
        )
        self.snap_floor = 0  # device-known snapshot floor (host mirror)
        # current-term-commit gate: a new leader may neither change
        # membership nor serve linearizable reads until its own noop has
        # committed (Raft read-index rule; reference: post_election
        # noop + cluster_change_permitted, src/ra_server.erl:4028-4064)
        self.noop_index = 0
        self.noop_committed = True  # groups start pre-election
        self.query_seq = 0
        # rollback snapshots for write-time cluster adoption: an
        # uncommitted change adopted from a dead leader must be undone
        # when a new leader truncates that suffix.
        # [(entry_index, members_copy, voter_status_copy), ...]
        self.cluster_history: List[Tuple[int, List, Dict[int, Any]]] = []
        # per-slot monotonic time of the last AER ack (leader-side);
        # drives the periodic resync of silent peers
        self.last_ack: Dict[int, float] = {}
        # aux machine state (initialized lazily on first aux message)
        self.aux_state: Any = None
        self.aux_inited = False
        # monotonic time of the last leader contact (AER / heartbeat /
        # snapshot chunk). The leader's silent-peer resync probe runs
        # every 2 ticks, so on this backend "no contact for several
        # ticks" is a reliable leaderless signal — the detector uses it
        # to retry elections after partition heals (a stalled pre-vote
        # or a deposed-leader cluster would otherwise wedge forever)
        self.last_contact = self._clock.monotonic()
        # buffered low-priority commands, drained in bounded slices
        # after normal traffic (reference: ra_ets_queue lane,
        # src/ra_server_proc.erl:507-530)
        self.low_q: deque = deque()
        # ascending log indexes holding non-USR commands (noops, cluster
        # changes). Tracked at append/write time so the apply loop can
        # take the batched fast path without scanning every entry; kept
        # exhaustive by the truncation/snapshot paths.
        self.specials: List[int] = []
        # last success ack shipped to a leader: (sid, term, last_index,
        # monotonic time). An identical re-ack within one tick interval
        # is suppressed — the pipeline's commit-sync AER round otherwise
        # triggers a reply that tells the leader nothing new. The time
        # bound keeps the leader's silent-peer resync probe honest: a
        # probe after 2 quiet ticks always gets a fresh ack.
        self.last_ok_sent: Optional[Tuple[ServerId, int, int, float]] = None
        # entries appended by THIS step's _handle_commands, passed
        # through to _send_aers so the steady-state AER build skips the
        # log re-read: (first_idx, prev_term, term, [Entry, ...]).
        # Valid only within one step; _send_aers always clears it.
        self.fresh_tail: Optional[Tuple[int, int, int, list]] = None
        # leader-side CONFIRMED replication point per slot (from AER
        # success replies) — the host mirror the pipeline window is
        # enforced against (next_index advances optimistically at send
        # time; match_hint only on acks, mirroring the reference's
        # match_index in its Next - Match <= ?MAX_PIPELINE_COUNT gate,
        # src/ra_server.erl:2308-2329)
        self.match_hint: List[int] = [0] * len(self.members)
        # in-flight commit-latency sample (obs.COMMIT_STAGES): at most
        # one per group, [idx, t_submit, t_append, t_durable, t_commit]
        # in monotonic ns. Only sampled groups (gid & lat_mask == 0)
        # for commands carrying a submit ts ever allocate one.
        self.lat: Optional[list] = None
        # staleness-bounded follower reads (docs/INTERNALS.md §20):
        # fresh_ts is the newest leader wall-clock stamp whose commit
        # point this replica has fully applied; fresh_anchor holds a
        # (leader_commit, commit_ts) pair still waiting for apply to
        # catch up. lease_contact is the leader-contact stamp backing
        # the stickiness promise (AER/heartbeat/snapshot only — NOT
        # the election-suspicion last_contact, which also restarts on
        # role changes and vote grants).
        self.fresh_anchor: Tuple[int, float] = (0, 0.0)
        self.fresh_ts = 0.0
        self.lease_contact = 0.0

    def slot_of(self, sid: ServerId) -> int:
        try:
            return self.members.index(sid)
        except ValueError:
            return -1

    def sid_of(self, slot: int) -> Optional[ServerId]:
        if 0 <= slot < len(self.members):
            return self.members[slot]
        return None


class _ThreadPool:
    """``n`` daemon threads running submitted callables in order,
    started at the first ``submit``; ``close()`` drops the callables
    not yet started (a running one finishes on its own)."""

    def __init__(self, n: int, name: str) -> None:
        self._n = n
        self._name = name
        self._jobs: deque = deque()
        self._cv = threading.Condition()
        self._threads: List[threading.Thread] = []
        self._closed = False

    def submit(self, fn: Callable[[], Any]) -> bool:
        """Queue ``fn``; False (and nothing queued) once closed."""
        with self._cv:
            if self._closed:
                return False
            self._jobs.append(fn)
            if not self._threads:
                for i in range(self._n):
                    t = threading.Thread(target=self._run, daemon=True,
                                         name=f"{self._name}-{i}")
                    t.start()
                    self._threads.append(t)
            self._cv.notify()
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                fn = self._jobs.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001
                logger.exception("%s: job crashed", self._name)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._jobs.clear()
            self._cv.notify_all()


class BatchCoordinator:
    """Hosts up to ``capacity`` groups on one node, device-stepped."""

    def __init__(
        self,
        node_name: str,
        capacity: int = 1024,
        num_peers: int = 3,
        suffix_k: int = 32,
        nodes: Optional[NodeRegistry] = None,
        aer_batch_size: int = 128,
        election_timeout_s: float = 0.15,
        detector_poll_s: float = 0.1,
        meta=None,
        idle_sleep_s: float = 0.0005,
        tick_interval_s: float = 1.0,
        send_msg_cb=None,
        mesh=None,
        active_set: str = "auto",
        max_pipeline_count: int = 4096,
        max_command_backlog: int = 4096,
        command_deadline_s: float = 5.0,
        pipeline: bool = True,
        rings: bool = True,
        ingress_ring_slots: int = 8192,
        egress_async: bool = True,
        native: str = "auto",
        clock=None,
        lease: bool = False,
        lease_safety_factor: float = 0.8,
        lease_drift_epsilon_s: float = 0.002,
        device=None,
    ):
        from ra_tpu_torch.runtime.clock import WALL

        # behavioral clock seam (docs/INTERNALS.md §19): election/resync
        # windows, contact stamps and the tick cadence read this clock;
        # the monotonic_ns() latency-histogram stamps below intentionally
        # stay on the wall clock (they measure real host time and the
        # simulation plane never drives this backend)
        self.clock = clock or WALL
        self.name = node_name
        self.capacity = capacity
        self.P = num_peers
        self.aer_batch_size = aer_batch_size
        self.election_timeout_s = election_timeout_s
        self.meta = meta
        self.idle_sleep_s = idle_sleep_s
        self.tick_interval_s = tick_interval_s
        self.send_msg_cb = send_msg_cb
        # flow control: per-peer AER pipeline window (reference:
        # ?MAX_PIPELINE_COUNT, src/ra_server.hrl:8), per-group client
        # admission window against apply progress, and the command-lane
        # watchdog deadline (accepted command with no commit progress
        # for this long -> detected wedge, recovery, bounded failure)
        self.max_pipeline_count = max_pipeline_count
        self.max_command_backlog = max_command_backlog
        self.command_deadline_s = command_deadline_s
        from ra_tpu_torch import counters as _counters
        from ra_tpu_torch import health as _health
        from ra_tpu_torch import obs as _obs
        from ra_tpu_torch.li import LeakyIntegrator

        self.counters = _counters.new(
            ("coordinator", node_name), _counters.COORDINATOR_FIELDS
        )
        # wave-phase + commit-stage histograms (docs/INTERNALS.md §13)
        # and the flight recorder; per-node histogram names so batch-
        # and actor-backed members on one node share a commit family
        self._wave_h = _obs.wave_hists(node_name)
        self._commit_h = _obs.commit_hists(node_name)
        self._obs_rec = _obs.flight_recorder()
        # wave-phase trace spans land here when tracing is enabled
        # (profile_wave --trace / api.dump_trace); one attribute check
        # per step while disabled
        self._trace = _obs.trace_buffer()
        # per-group health scanner (docs/INTERNALS.md §14): fed once
        # per tick from the detector thread with ONE device fetch over
        # the existing mirrors — never from the step loop
        self._health = _health.register(
            node_name, backend="tpu_batch", capacity=max(64, capacity)
        )
        # storage-pressure plane (docs/INTERNALS.md §21): the harness /
        # embedding application drives enter/exit from its WAL-failure
        # classification and watermark accounting; the coordinator
        # consults it at admission and when granting snapshot credits
        from ra_tpu_torch.pressure import StoragePressure

        self.pressure = StoragePressure(node_name)
        self.snapshot_credit_window = 4
        self._hslots: List[int] = []  # gid -> scanner slot
        # commit-latency sampling mask: groups with gid & mask == 0 are
        # eligible (bounds hot-path cost to ~1/64 of groups); _lat_gids
        # tracks the gids with a sample in flight so per-step sweeps
        # (the durable-watermark check) cost nothing when none is
        self._lat_mask = 63
        self._lat_gids: set = set()
        # aggregate commit-rate gauge over all groups (the batch-backend
        # analog of the per-proc ra_li integrator), sampled per tick
        self._commit_li = LeakyIntegrator()
        self._commit_li_prev: Optional[Tuple[float, int]] = None
        # activity-scaled stepping: "auto" runs the fused step over a
        # compact gather of just the groups with pending device work
        # whenever they number at most capacity/4 (power-of-two padded
        # sub-batches), falling back to the full-width step at
        # saturation; "always"/"never" pin a path (tests/bench). Step
        # cost then scales with ACTIVITY, not capacity — a lone commit
        # round trip at 10k-group capacity no longer pays ~10 full-width
        # steps (the reference's per-group process wakes only on
        # messages: src/ra_server_proc.erl:457-530).
        if active_set not in ("auto", "always", "never"):
            raise ValueError(f"unknown active_set mode {active_set!r}")
        self.active_set = active_set

        # multi-device: cut the GROUP axis of all consensus state into
        # equal slices over the mesh's devices (replica axis P rides
        # along whole). Every group's decision math is independent, so
        # each slice steps alone with no communication; the seam routes
        # host scatters to their slice by group id. The reference shards
        # over a jax.sharding.Mesh; here a mesh is a device sequence.
        self._sharded = mesh is not None
        if self._sharded:
            if device is not None:
                raise ValueError("pass device or mesh, not both")
            self._dev = ShardedSeam(mesh)
        else:
            self._dev = DeviceSeam(device)
        self.device = self._dev.device
        # groups not yet registered must never act: inactive rows
        self.state = self._dev.init_state(capacity, num_peers, suffix_k)
        self.groups: List[Optional[GroupHost]] = [None] * capacity
        self.by_name: Dict[str, GroupHost] = {}
        self.n_groups = 0

        # async command plane (docs/INTERNALS.md §16): per-producer-
        # thread lock-free SPSC ingress rings, drained in one batched
        # multi-lane pass by the step thread. No sender ever contends
        # with the step loop; the step thread blocks on _wake (an
        # Event set by every publish / WAL notify / egress realisation)
        # instead of 50 ms timed polls. rings=False swaps in the
        # lock+deque control implementation (the --rings=off A/B).
        from ra_tpu_torch.rings import IngressRings, LockedLanes, WaitGate

        self._wake = threading.Event()
        ring_cls = IngressRings if rings else LockedLanes
        self.rings = rings
        self._rings = ring_cls(lane_slots=ingress_ring_slots,
                               wake=self._wake)
        # ring-full backpressure gate: opened on every drain that freed
        # space; ring-full-rejected clients wait on it instead of
        # sleeping (the ingress analog of the per-group admission gate)
        self._ring_gate = WaitGate()
        # admission-window gate: opened whenever apply progress releases
        # window room; admission-rejected clients park a waiter on it
        # (api.process_command) instead of a fixed 10 ms sleep poll
        self._adm_gate = WaitGate()
        # idents of the threads that DRAIN the rings (step + egress loop
        # threads, plus whichever thread is inside a cooperative step_*
        # call): a full-ring publish from one of these must divert to
        # _internal_q — gate-waiting would deadlock on itself
        self._drainer_idents: set = set()
        # reusable drain scratch (step-thread only)
        self._drain_buf: List = []
        # must-deliver self-publishes from the coordinator's own step/
        # egress threads (machine Append/Aux effects): a blocking ring
        # publish from the drainer thread would deadlock, so they ride
        # this state-lock-guarded queue into the next drain instead
        self._internal_q: deque = deque()
        # must-deliver overflow from FOREIGN threads (peer coordinator
        # step/egress/WAL threads, detector timers) whose publish hit a
        # full lane: never dropped, and never gate-waited either — a
        # peer's drainer thread parked on OUR ring gate while we park
        # on ITS gate is a distributed deadlock. Tiny leaf lock (never
        # nested inside any other), folded first by _drain_classify so
        # overflow items keep their arrival seniority.
        self._overflow_q: deque = deque()
        self._overflow_codes: deque = deque()  # RC_* sidecar, in step
        self._overflow_lock = threading.Lock()
        # native hot-loop runtime switches (docs/INTERNALS.md §18):
        # requested paths resolved against what actually loaded. Every
        # native path keeps the byte-identical Python fallback and
        # routes around itself while ANY failpoint is armed, so the
        # nemesis plane always exercises the Python fault seams.
        paths = parse_native(native)
        eps = _native.entry_points() if paths else {}
        self.native = native
        self._nat_pack = "pack" in paths and eps.get("pack", False)
        self._nat_classify = "classify" in paths and eps.get("classify", False)
        self._nat_egress = "egress" in paths and eps.get("egress", False)
        self._drain_codes = bytearray()  # classify sidecar scratch
        self._low_dirty: set = set()  # gids with buffered low-priority cmds
        # staged device scatters, coalesced ACROSS passes (the host half
        # of the double-buffered staging): appended runs per gid as
        # [[lo, hi, term], ...] chronological, durable watermarks as
        # gid -> max idx. Ingest-only passes fold straight into these;
        # the next dispatching pass consumes them with zero re-merging.
        self._staged_app: Dict[int, List[List[int]]] = {}
        self._staged_written: Dict[int, int] = {}
        # pre-zeroed full-width mailbox buffer staged in the pipeline
        # overlap window (dispatch packs into it with no take/zero cost)
        self._spare_mbox: Optional[np.ndarray] = None
        # prezero only while full-width steps are the live shape (the
        # active-set sub path zeroes tiny buffers — not worth staging)
        self._prezero_useful = False
        # dedicated egress sender thread (started pipelined loop only):
        # AER/ack fan-out hands (node, msgs) batches to a bounded ring
        # consumed off the step loop; overflow falls back to inline send
        self._egress_async = egress_async
        self._egress_on = False
        self._egress_wake = threading.Event()
        self._egress_rings = ring_cls(lane_slots=4096,
                                      wake=self._egress_wake)
        self._sender_thread: Optional[threading.Thread] = None
        # clock-bound leader leases, vectorized over the group axis
        # (docs/INTERNALS.md §20): per-slot oldest-outstanding-send
        # stamps and credited ack bases, folded into a (G,) expiry
        # column by _lease_refresh over just the dirty gids. Off by
        # default — leader stickiness changes election behavior.
        from ra_tpu_torch.lease import LeaseConfig

        self.lease_cfg = LeaseConfig(
            enabled=lease, election_timeout_s=election_timeout_s,
            safety_factor=lease_safety_factor,
            drift_epsilon_s=lease_drift_epsilon_s,
        )
        self._lease_sent = np.zeros((capacity, num_peers), np.float64)
        self._lease_basis = np.zeros((capacity, num_peers), np.float64)
        self._lease_expiry = np.zeros(capacity, np.float64)
        self._lease_voters = np.zeros((capacity, num_peers), bool)
        self._lease_quorum = np.zeros(capacity, np.int64)
        self._lease_self = np.zeros(capacity, np.int64)
        self._lease_renew_t = np.zeros(capacity, np.float64)
        self._lease_dirty: set = set()
        self._stale_h = None  # lazy follower_read_staleness histogram
        # role transitions queued by rare paths, applied as ONE scatter
        # at the start of the next step (an election storm over many
        # groups must not pay one jitted scatter per group)
        self._pending_roles: List[Tuple[int, int]] = []
        self._hot: set = set()  # gids with queued inbox msgs / term hints
        self._applied_np = np.zeros(capacity, np.int64)  # last_applied mirror
        # mailbox pack buffers, double-buffered (docs/INTERNALS.md §15):
        # a build hands out one buffer (pinned on CUDA) for upload; the
        # buffer returns to the pool only after that step's egress sync
        # (DeviceSeam.realise) proves the device consumed it. The
        # sequential loop cycles one buffer; the pipelined loop keeps
        # one in flight while the next step packs the other — the pool
        # is bounded by the single-outstanding-ticket cap.
        self._mbox_pool: List[np.ndarray] = []
        # guards self.state (donated buffers!) between the step thread and
        # add_group callers
        self._state_lock = threading.Lock()
        # snapshot installs a rare-message pass writes to the device at
        # its end, by gid (None outside a pass): one scatter for the
        # pass, not three a group
        self._install_rows: Optional[Dict[int, Tuple[int, ...]]] = None
        # member rows (active, voting) a pass changed, by gid, written to
        # the device in one scatter before the next step and at the end
        # of every realised pass: one scatter a pass, not one a group a
        # membership change
        self._member_rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        self.registry = nodes or node_registry()
        self.transport = InProcTransport(node_name, self.registry)
        self.running = True
        self.registry.register(node_name, self)
        self.steps = 0
        self.sub_steps = 0  # steps taken on the active-set (sub) path
        self.msgs_processed = 0

        # pipelined wave loop (docs/INTERNALS.md §15): the threaded run
        # loop splits each step into host staging (ingress drain + pack
        # + device dispatch, step thread) and realisation (egress sync
        # + process + AER fan-out, egress thread), overlapping step
        # N+1's staging with step N's device compute / egress sync.
        # ``step_once`` (tests, cooperative bench driver) is always the
        # sequential two-halves-inline form; callers must not mix it
        # with a STARTED pipelined loop (ticket order would invert).
        self.pipeline = pipeline
        self._pipe_cv = threading.Condition()
        self._pipe_q: deque = deque()
        self._pipe_inflight = 0  # tickets dispatched but not finished
        self._egress_thread: Optional[threading.Thread] = None
        # work drained by ingest-only passes (a ticket still in
        # flight): rares park here until the next dispatching pass
        # picks them up (appended/written runs go straight to the
        # staged scatter dicts, their canonical form; AER fan-out
        # never parks — ingest passes ship it immediately)
        self._pending_rare: List[Tuple] = []
        # outstanding ticket of the cooperative pipelined driver form
        self._coop_ticket: Optional[BatchCoordinator._StepTicket] = None
        self._step_thread = threading.Thread(
            target=self._run, name=f"ra-batch-{node_name}", daemon=True
        )
        self._node_status: Dict[str, bool] = {}
        self._detector_poll_s = detector_poll_s
        self._detector = threading.Thread(
            target=self._detect_loop, name=f"ra-batch-det-{node_name}", daemon=True
        )
        # node-down election triggers share one timer thread, started
        # at the first node-down and closed by stop(): a timer thread a
        # followed group started thousands at full width
        self._down_timers: Optional[TimerService] = None
        self._down_lock = threading.Lock()
        # snapshot threads (the reference streams a transfer on a thread
        # of its own and writes a release cursor's snapshot inline on the
        # apply path: at 10240 queues x 3 the first started thousands of
        # threads and the second held a node's step for minutes):
        # transfers run on a bounded pool, release-cursor snapshots on
        # writer threads, each started at its first job, closed by stop()
        self._snap_send = _ThreadPool(self.SNAPSHOT_SENDERS,
                                      f"ra-snap-send-{node_name}")
        self._snap_cv = threading.Condition()
        self._snap_jobs: Dict[int, Tuple] = {}  # gid -> (g, meta, state)
        self._snap_busy: set = set()  # gids being written
        self._snap_due: Dict[int, int] = {}  # gid -> newest index handed out
        self._snap_writers: List[threading.Thread] = []
        self._snap_closed = False
        self._started = False

    # -- node-registry interface (same duck type as RaNode) ---------------

    @property
    def procs(self) -> Dict[str, Any]:
        return self.by_name

    # ring item tags: generic message | single command | bulk command
    # fan-out | per-node batch of (name, from_sid, msg) triples
    _R_MSG, _R_CMD, _R_CMDS, _R_BATCH = 0, 1, 2, 3

    def deliver(self, to: ServerId, msg: Any, from_sid: Optional[ServerId]) -> bool:
        """Lock-free ingress: publish onto this thread's SPSC lane. A
        full lane backpressures explicitly (docs/INTERNALS.md §16):
        client commands owing a reply reject through the admission
        path with a gate waiter, ack-free commands drop counted
        (at-most-once contract), lossy peer protocol traffic drops
        counted (transport contract), and must-deliver control
        messages (log events, internal commands, queries) ride the
        overflow queue — never a silent drop, and never a block (the
        caller may be a peer coordinator's drainer thread; parking it
        on our gate while we park on its gate would deadlock)."""
        name = to[0]
        if name not in self.by_name:
            return False
        if type(msg) is Command:
            # the RC_* class code rides a sidecar slot next to the item
            # (the flat tagged-item layout): the priority split is paid
            # once at the producer so the native drain-classify never
            # touches the object
            code = RC_CMD_LOW if msg.priority == "low" else RC_CMD
            if msg.internal and self._overflow_q:
                # older must-deliver work is parked on the overflow
                # queue: a lane publish would overtake it (the queue
                # folds after the lane drain) — keep arrival order
                return self._publish_overflow((self._R_CMD, name, msg), code)
            if self._rings.publish((self._R_CMD, name, msg), code):
                return True
            return self._ring_full_cmd(name, msg, code)
        if type(msg) not in LOSSY_PROTOCOL_TYPES and self._overflow_q:
            return self._publish_overflow(
                (self._R_MSG, name, from_sid, msg), RC_MSG)
        if self._rings.publish((self._R_MSG, name, from_sid, msg), RC_MSG):
            return True
        self.counters.incr("ingress_ring_full")
        if type(msg) in LOSSY_PROTOCOL_TYPES:
            return False  # lossy peer traffic: counted drop
        return self._publish_overflow((self._R_MSG, name, from_sid, msg), RC_MSG)

    def _ring_full_cmd(self, name: str, msg: Command,
                       code: int = RC_CMD) -> bool:
        self.counters.incr("ingress_ring_full")
        if msg.internal:
            # machine-internal must-deliver (timer fires, Append
            # effects): overflow queue, never shed
            return self._publish_overflow((self._R_CMD, name, msg), code)
        if msg.from_ref is not None:
            # explicit backpressure: the command was NEVER enqueued, so
            # a retry is exactly-once safe; the gate waiter wakes the
            # client on the next drain instead of a sleep loop
            self.counters.incr("commands_rejected")
            self._reply(
                msg.from_ref,
                REJECT_OVERLOADED + (self._ring_gate.waiter(),),
            )
            return True
        self.counters.incr("commands_dropped_overload")
        return False

    def _publish_blocking(self, item, code: int = RC_MSG) -> bool:
        """Bounded-wait publish for must-deliver BULK CLIENT traffic
        (deliver_commands / deliver_many — the producers there are
        client/driver threads, where waiting IS the backpressure): wait
        on the ring gate (opened by every space-freeing drain) and
        retry. A drainer thread (step/egress loop, or a cooperative
        step_* call) must never gate-wait on itself — its must-deliver
        traffic rides ``_internal_q`` into its own next drain instead.
        Never used for traffic that may originate on ANOTHER
        coordinator's drainer thread (see _publish_overflow)."""
        if threading.get_ident() in self._drainer_idents:
            # caller holds the state lock (every drainer publish comes
            # from inside a locked stage/realise half)
            self._internal_q.append(item)
            return True
        for _ in range(4):
            if not self.running:
                return False
            if self._rings.publish(item, code):
                return True
            self._ring_gate.waiter().wait(0.05)
        # still full after the bounded wait: in cooperative (non-
        # started) mode the only drainer may be THIS thread between
        # step_* calls — spinning here would livelock until an external
        # stop(). Fall back to the overflow queue: delivered on the
        # next drain, never spun on, never shed.
        return self._publish_overflow(item, code)

    def _publish_overflow(self, item, code: int = RC_MSG) -> bool:
        """Non-blocking must-deliver fallback for a full lane: park the
        item on the overflow queue the next _drain_classify folds FIRST
        (arrival seniority kept). Used for traffic whose producer may
        be a peer coordinator's drainer thread or a timer — blocking
        those risks distributed deadlock, dropping violates the
        must-deliver contract. Unbounded, but only ever fed by the
        low-rate control/ack trickle that outlived a full lane."""
        if threading.get_ident() in self._drainer_idents:
            self._internal_q.append(item)
            return True
        with self._overflow_lock:
            self._overflow_q.append(item)
            self._overflow_codes.append(code)
        self.counters.incr("ingress_overflow_msgs")
        if not self._wake.is_set():
            self._wake.set()
        return True

    def _deliver_internal(self, name: str, msg) -> None:
        """Self-delivery from the step/egress threads (machine effects
        re-entering the command queue). Caller holds the state lock;
        the queue is drained by the next _drain_and_dispatch."""
        if type(msg) is Command:
            self._internal_q.append((self._R_CMD, name, msg))
        else:
            self._internal_q.append((self._R_MSG, name, None, msg))

    def deliver_commands(self, names, cmd: Command) -> None:
        """Bulk ingress for ONE command fanned to many groups (the
        pipelined-bench shape: one wave = the same no-op command to
        every group leader). One ring slot for the whole wave; the
        per-group regrouping runs at drain time on the step thread,
        off every client lock. ``names`` must not be mutated after the
        call. Blocks (gate-paced) when the lane is full — the bulk
        producer is the natural place to absorb backpressure."""
        code = RC_CMDS_LOW if cmd.priority == "low" else RC_CMDS
        self._publish_bulk((self._R_CMDS, names, cmd), code)

    def wal_notify(self, uid: str, evt) -> None:
        """Log-event entry point for WAL / segment-writer notify
        callbacks. ``written`` events take the decoupled durable-ack
        path — handled on the CALLING (WAL writer) thread so a durable
        batch advances watermarks, releases deferred AER acks, and
        queues the device written-scatter without waiting for a step-
        loop pass. Everything else rides normal ingress ordering."""
        if type(evt) is tuple and evt and evt[0] == "written":
            self.wal_notify_many([(uid, evt)])
        else:
            self.deliver((uid, self.name), ("log_event", evt), None)

    def wal_notify_many(self, items) -> None:
        """Bulk durable-watermark delivery from one WAL flush (wire as
        ``wal.notify_many``): one state-lock round for the whole
        batch's written events. The durable-ack decoupling invariant
        (docs/INTERNALS.md §15): everything this touches — the log's
        written watermark, ``pending_ack``, ``last_ok_sent``, the
        pending-scatter queue — is guarded by the state lock, and the
        ack it emits is exactly the ack the step-loop path would have
        emitted one wave later."""
        route_out: Dict[str, List] = {}
        staged = False
        with self._state_lock:
            by_get = self.by_name.get
            sw = self._staged_written
            for uid, evt in items:
                g = by_get(uid)
                if g is None:
                    continue
                if not (type(evt) is tuple and evt and evt[0] == "written"):
                    self.deliver((uid, self.name), ("log_event", evt), None)
                    continue
                g.log.handle_event(evt)
                wi, wt = g.log.last_written()
                # the device learns the durable watermark at the next
                # dispatch (the staged written scatter drives the
                # quorum scan)
                if sw.get(g.gid, 0) < wi:
                    sw[g.gid] = wi
                staged = True
                if g.pending_ack is not None and wi >= g.pending_ack[1]:
                    leader_sid, cover = g.pending_ack
                    g.pending_ack = None
                    ack = min(wi, cover)
                    at = g.log.fetch_term(ack)
                    out = route_out.get(leader_sid[1])
                    if out is None:
                        route_out[leader_sid[1]] = out = []
                    out.append(
                        (leader_sid,
                         AppendEntriesReply(g.term, True, ack + 1, ack,
                                            at if at is not None else wt),
                         (g.name, self.name))
                    )
        for node_name, msgs in route_out.items():
            self._send_batch(node_name, msgs)
        # wake the step thread only when the staged watermark is
        # actionable NOW: with a ticket in flight the idle predicate
        # ignores staged work (an ingest-only pass cannot scatter it),
        # so an unconditional set here woke the loop for nothing — the
        # spurious wakeups BENCH_THREADED recorded. When the in-flight
        # ticket realises, the egress thread's own _have_work check
        # sees the staged state and wakes the loop (its inflight
        # decrement precedes that check, so no release is ever missed).
        if staged and self._have_work() and not self._wake.is_set():
            self._wake.set()

    def deliver_many(self, msgs) -> None:
        """Batch ingress: ONE ring slot for many ``(to_sid, msg,
        from_sid)`` triples (unknown group names are dropped at drain,
        as in ``deliver``). Blocks gate-paced when the lane is full."""
        triples = [(to[0], frm, m) for to, m, frm in msgs]
        self._publish_bulk((self._R_BATCH, triples), RC_BATCH)

    def _publish_bulk(self, item, code: int = RC_MSG) -> None:
        """Bulk client publish: keep arrival order (never overtake
        parked overflow work — the overflow queue folds after the lane
        drain) WITHOUT giving up pacing. While overflow is pending,
        gate-wait a bounded window for the drain to clear it; only if
        it persists does the wave park on the overflow queue too —
        producers stay paced at the gate cadence instead of appending
        unbounded waves at line rate (the failure mode an unconditional
        divert would reintroduce under exactly the overload the bounded
        rings exist for)."""
        if self._overflow_q:
            ident = threading.get_ident()
            for _ in range(4):
                if ident in self._drainer_idents or not self.running:
                    break
                self._ring_gate.waiter().wait(0.05)
                if not self._overflow_q:
                    break
            if self._overflow_q:
                self._publish_overflow(item, code)
                return
        if not self._rings.publish(item, code):
            self.counters.incr("ingress_ring_full")
            self._publish_blocking(item, code)

    def ingest_batch(self, triples) -> int:
        """Peer-coordinator bulk ingress (the _send_batch fast path):
        pre-normalized ``(name, from_sid, msg)`` triples, one ring slot
        per per-node batch. On a full lane the batch SPLITS by the
        backpressure table: lossy protocol traffic is shed (returns the
        shed count for the sender's drop accounting), everything else —
        snapshot chunks/acks, TimeoutNow, client commands, log events —
        rides the overflow queue (must-deliver: a batch-level drop
        would stall a snapshot transfer for its whole ack timeout and
        silently swallow leadership transfers). Returns the number of
        messages dropped (0 = everything delivered)."""
        if not self._overflow_q:
            # (while older must-deliver work is parked on the overflow
            # queue, a lane publish would overtake it — divert below)
            if self._rings.publish((self._R_BATCH, triples), RC_BATCH):
                return 0
            self.counters.incr("ingress_ring_full")
        must = [t for t in triples if type(t[2]) not in LOSSY_PROTOCOL_TYPES]
        if must:
            self._publish_overflow((self._R_BATCH, must), RC_BATCH)
        if len(must) == len(triples):
            return 0
        # lossy remainder is order-insensitive (sender-retried): it may
        # still ride the lane; shed only what the lane cannot take
        lossy = [t for t in triples if type(t[2]) in LOSSY_PROTOCOL_TYPES]
        if self._rings.publish((self._R_BATCH, lossy), RC_BATCH):
            return 0
        return len(lossy)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._step_thread.start()
            self._detector.start()

    def stop(self) -> None:
        self.running = False
        self._egress_on = False  # late sends go inline, not to a dead ring
        if self._started:
            self._wake.set()
            self._egress_wake.set()
            with self._pipe_cv:
                self._pipe_cv.notify_all()
            self._step_thread.join(timeout=5)
            if self._egress_thread is not None:
                self._egress_thread.join(timeout=5)
            if self._sender_thread is not None:
                self._sender_thread.join(timeout=5)
                # a publisher that read _egress_on before stop() flipped
                # it can land a batch AFTER the sender's final drain:
                # ship the residue inline so queued acks still leave
                out: List = []
                if self._egress_rings.drain(out):
                    for node_name, msgs in out:
                        try:
                            self._send_batch_inline(node_name, msgs)
                        except Exception:  # noqa: BLE001 — best effort
                            pass
            # join the detector too: a straggling health scan sitting in
            # a device fetch at interpreter exit can crash the XLA
            # runtime's C++ teardown
            self._detector.join(timeout=5)
        with self._down_lock:
            timers, self._down_timers = self._down_timers, None
        if timers is not None:
            timers.close()  # triggers not yet due are dropped
        self._snap_send.close()  # transfers not yet started are dropped
        with self._snap_cv:
            self._snap_closed = True
            self._snap_cv.notify_all()
        for t in self._snap_writers:
            t.join(timeout=30)  # the snapshots handed out are written
        from ra_tpu_torch import counters as _counters
        from ra_tpu_torch import health as _health

        _counters.delete(("coordinator", self.name))
        _health.unregister(self.name)
        self.pressure.delete()
        for g in self.groups:
            if g is not None:
                for t in g.machine_timers.values():
                    t.cancel()
                g.machine_timers.clear()
        self.registry.unregister(self.name)

    def add_group(
        self,
        name: str,
        cluster_name: str,
        members: List[ServerId],
        machine: Machine,
        log: Optional[LogApi] = None,
    ) -> ServerId:
        return self.add_groups([(name, cluster_name, members, machine, log)])[0]

    def add_groups(self, specs) -> List[ServerId]:
        """Bulk group registration: ONE set of device scatters for the
        whole batch. ``specs`` rows are ``(name, cluster_name, members,
        machine[, log])``. Registering 10k groups one scatter-set at a
        time was minutes of un-jitted dispatch; this is 5 scatters
        total."""
        specs = list(specs)
        # validate EVERYTHING before mutating: a mid-batch error must
        # not leave half-registered groups with inactive device rows
        if self.n_groups + len(specs) > self.capacity:
            raise RuntimeError("coordinator at capacity")
        for spec in specs:
            name, _cl, members = spec[0], spec[1], spec[2]
            if len(members) > self.P:
                raise ValueError(
                    f"group has {len(members)} members; capacity is {self.P}"
                )
            if (name, self.name) not in members:
                raise ValueError(
                    "members must include this coordinator's server id"
                )
        sids: List[ServerId] = []
        hosts: List[Tuple[str, GroupHost]] = []
        rows: List[Tuple[int, np.ndarray, int, int, int]] = []
        for k, spec in enumerate(specs):
            name, cluster_name, members, machine = spec[:4]
            log = spec[4] if len(spec) > 4 else None
            sid = (name, self.name)
            gid = self.n_groups + k
            g = GroupHost(
                gid, name, cluster_name, members, members.index(sid),
                log or MemoryLog(auto_written=True), machine,
                clock=self.clock,
            )
            # restart safety: reload the durable term/vote so this
            # member cannot re-vote in a term it already voted in
            term0, voted_slot = 0, -1
            if self.meta is not None:
                uid = f"{cluster_name}_{name}"
                term0 = int(self.meta.fetch(uid, "current_term", 0))
                voted_sid = self.meta.fetch(uid, "voted_for", None)
                if voted_sid is not None:
                    voted_slot = g.slot_of(tuple(voted_sid))
                    if voted_slot < 0:
                        # we voted this term for a sid not in the
                        # current member table (e.g. removed since):
                        # seed an out-of-range slot so free_to_vote
                        # stays False for the rest of the term — never
                        # degrade to "never voted" (-1), which would
                        # allow a second grant
                        voted_slot = self.P
                g.term = term0
            active = np.zeros(self.P, dtype=bool)
            active[: len(members)] = True
            li, lt = g.log.last_index_term()
            snap0 = g.log.snapshot_index_term()
            sidx, sterm = snap0 if snap0 else (0, 0)
            if snap0 is not None:
                # cold restart onto a snapshot-bearing log: entries at or
                # below the floor are gone, so the machine state MUST be
                # restored from the capture (replay-from-1 would raise on
                # the missing prefix); apply resumes above the floor
                got = g.log.read_snapshot()
                if got is not None:
                    meta0, state_obj = got
                    g.machine_state = state_obj
                    g.effective_machine_version = meta0.machine_version
                    g.last_applied = meta0.index
                    g.snap_floor = meta0.index
                    self._applied_np[gid] = meta0.index
            fi = sidx + 1
            if li >= fi:
                # a pre-populated log (cold restart with a persistent
                # log): seed the specials index so the batched apply
                # fast path stays sound
                g.specials = [
                    e.index for e in g.log.fetch_range(fi, li)
                    if type(e.cmd) is not Command or e.cmd.kind != USR
                ]
            rows.append((gid, active, g.self_slot, term0, voted_slot,
                         li, lt, sidx, sterm))
            hosts.append((name, g))
            sids.append(sid)
            if self.lease_cfg.enabled:
                self._lease_sync(g)
        if rows:
            dev = self._dev
            gids = np.array([r[0] for r in rows], np.int32)
            act = np.stack([r[1] for r in rows]).astype(np.bool_)
            slots = np.array([r[2] for r in rows], np.int32)
            terms = np.array([r[3] for r in rows], np.int32)
            voted = np.array([r[4] for r in rows], np.int32)
            lis = np.array([r[5] for r in rows], np.int32)
            lts = np.array([r[6] for r in rows], np.int32)
            sidxs = np.array([r[7] for r in rows], np.int32)
            sterms = np.array([r[8] for r in rows], np.int32)
            # recovered tails: the device learns last/written/snapshot
            # rows, with the whole (snap, li] interval marked
            # term-unknown — prev-term lookups fall back to the host log
            # (needs_host) until traffic reconciles the ring. Everything
            # already on disk is durable, so written == last.
            unk_lo = np.where(lis > sidxs, sidxs + 1, 1).astype(np.int32)
            unk_hi = np.where(lis > sidxs, lis, 0).astype(np.int32)
            with self._state_lock:
                self._flush_member_rows()
                self.state = dev.set_rows(
                    self.state, gids,
                    active=act,
                    voting=act,
                    self_slot=slots,
                    current_term=terms,
                    voted_for=voted,
                    last_index=lis,
                    last_term=lts,
                    written_index=lis,
                    commit_index=sidxs,
                    last_applied=sidxs,
                    snapshot_index=sidxs,
                    snapshot_term=sterms,
                    unknown_lo=unk_lo,
                    unknown_hi=unk_hi,
                )
        # publish only after the device rows are live: deliver() must
        # never accept traffic for a group with inactive rows
        for name, g in hosts:
            self.groups[g.gid] = g
            self.by_name[name] = g
            self._hslots.append(self._health.ensure(name, g.cluster_name))
        self.n_groups += len(hosts)
        return sids

    # -- the step loop -----------------------------------------------------

    def _have_work(self) -> bool:
        """Is there anything for a step pass to do right now? Fresh
        ingress (ring items, internal self-deliveries, buffered lows)
        always counts. Deferred device work — hot gids, staged
        scatters, queued roles, parked rares — counts only with no
        ticket in flight: an ingest-only pass cannot act on it, so
        waiting on it mid-flight would busy-spin until realisation
        wakes us (its inflight decrement precedes the wake set, so the
        post-wake re-check sees the dispatchable state)."""
        if (
            self._rings.pending() or self._internal_q
            or self._overflow_q or self._low_dirty
        ):
            return True
        if self._pipe_inflight > 0:
            return False
        return bool(
            self._hot or self._staged_app or self._staged_written
            or self._pending_roles or self._pending_rare
        )

    def _idle_wait(self) -> None:
        """Event-driven idle block (docs/INTERNALS.md §16): clear the
        wake event, re-check for work (a publish between the last drain
        and the clear must not be lost — publish stores the item BEFORE
        setting the event, so either the re-check sees the item or the
        wait sees the set), then block until a ring publish, WAL
        notify, egress realisation, timer delivery, or stop wakes us.
        No timed polls: an idle coordinator consumes zero CPU, and the
        ``step_spurious_wakeups`` counter proves every wake found
        work."""
        wake = self._wake
        wake.clear()
        if self._have_work() or not self.running:
            return
        wake.wait()
        self.counters.incr("step_wakeups")
        if self.running and not self._have_work():
            self.counters.incr("step_spurious_wakeups")

    def _run(self) -> None:
        self._drainer_idents.add(threading.get_ident())
        if self.pipeline:
            self._run_pipelined()
            return
        while self.running:
            worked = self.step_once()
            if not worked:
                self._idle_wait()

    def _run_pipelined(self) -> None:
        """Two-stage pipelined wave loop (docs/INTERNALS.md §15). This
        thread owns host STAGING: ingress drain, command append + WAL
        handoff, queued scatters, mailbox pack, async device dispatch.
        The egress thread owns step REALISATION: egress host sync,
        egress processing (applies, acks, role changes), rare messages,
        AER fan-out. Every touch of host group state happens under
        ``_state_lock`` on either thread; the overlap window is the
        device compute + egress sync wait, which runs with no lock
        held — step N+1 stages and dispatches inside it. At most ONE
        ticket is in flight past the one being realised (the double
        buffer bound); tickets are realised strictly in dispatch order
        (egress fields are absolute per-step snapshots — out-of-order
        realisation would regress role/term mirrors)."""
        self._egress_thread = threading.Thread(
            target=self._egress_loop, name=f"ra-batch-eg-{self.name}",
            daemon=True,
        )
        self._egress_thread.start()
        if self._egress_async:
            self._sender_thread = threading.Thread(
                target=self._sender_loop, name=f"ra-batch-snd-{self.name}",
                daemon=True,
            )
            self._sender_thread.start()
            self._egress_on = True
        cv = self._pipe_cv
        while self.running:
            t0 = time.perf_counter_ns()
            # dispatch only with NO ticket in flight (the double-buffer
            # bound): while one is being realised, passes are INGEST-
            # ONLY — ingress keeps draining and commands keep reaching
            # the logs/WAL (coalescing the next step) without splitting
            # the wave into many small device steps. _pipe_inflight is
            # only incremented by this thread, so a lock-free read of 0
            # is exact (a stale >0 just delays dispatch by one pass).
            inflight = self._pipe_inflight > 0
            # classify OUTSIDE the state lock (docs/INTERNALS.md §16):
            # the WAL writer's wal_notify_many must never wait behind
            # the O(items) classification of a deep burst
            pre = self._drain_classify()
            with self._state_lock:
                ticket = self._drain_and_dispatch(
                    dispatch=not inflight, pre=pre
                )
            if inflight:
                # host staging done while the previous step's device
                # compute / egress realisation / WAL handoff were in
                # flight — the overlap the pipeline exists for
                dt = time.perf_counter_ns() - t0
                if dt > 20_000:  # ignore empty probe passes
                    self.counters.incr("pipeline_overlap_ns", dt)
                # double-buffered staging: pre-zero the NEXT dispatch's
                # full-width mailbox inside the overlap window, so the
                # dispatching pass packs into a ready spare with zero
                # take/zero cost on its critical path
                if self._prezero_useful and self._spare_mbox is None:
                    with self._state_lock:
                        buf = None
                        pool = self._mbox_pool
                        for k, b in enumerate(pool):
                            if b.shape[1] == self.capacity:
                                buf = b
                                del pool[k]
                                break
                    if buf is None:
                        buf = self._dev.mbox_buffer(
                            self._NROWS, self.capacity
                        )
                    else:
                        buf.fill(0)
                    self._spare_mbox = buf
                    self.counters.incr("staging_prezeroed")
            if ticket is not None:
                self.counters.incr("pipeline_steps")
                with cv:
                    self._pipe_inflight += 1
                    self._pipe_q.append(ticket)
                    cv.notify_all()
                continue
            self._idle_wait()
        with cv:
            cv.notify_all()
        self._egress_wake.set()

    def _egress_loop(self) -> None:
        self._drainer_idents.add(threading.get_ident())
        cv = self._pipe_cv
        while True:
            with cv:
                while not self._pipe_q and self.running:
                    cv.wait()
                if not self._pipe_q:
                    return  # stopped and drained
                ticket = self._pipe_q.popleft()
            eg_np = None
            if ticket.eg_packed is not None:
                # device sync OUTSIDE every lock: the step thread stages
                # and dispatches the next step during this wait
                eg_np = self._dev.realise(ticket.eg_packed)
            with self._state_lock:
                self._finish_ticket(ticket, eg_np)
            with cv:
                self._pipe_inflight -= 1
                cv.notify_all()
            # realisation may have produced device work (hot retries,
            # staged scatters) or unblocked deferred work the idle
            # predicate ignores while a ticket is in flight: wake the
            # step thread ONLY when such work exists — an unconditional
            # wake after a work-free realisation is exactly the
            # spurious wakeup the idle invariant forbids (caught by
            # test_command_plane's zero-spurious assertion). The
            # inflight decrement above precedes the check, so the
            # deferred state is dispatchable by the time we look; any
            # work arriving after a negative check sets the wake
            # itself (publish/stage/notify all do).
            if self._have_work() and not self._wake.is_set():
                self._wake.set()

    def _sender_loop(self) -> None:
        """Dedicated egress fan-out thread: per-destination message
        batches handed off through a bounded ring by the step/egress/
        WAL threads are shipped here, off every latency-critical loop.
        Drains outstanding batches on stop so queued acks still leave."""
        wake = self._egress_wake
        rings = self._egress_rings
        out: List = []
        while True:
            n = rings.drain(out)
            if not n:
                wake.clear()
                if rings.pending():
                    continue
                if not self.running:
                    # straggler window: a publisher that read _egress_on
                    # just before stop() flipped it may land a batch
                    # after this empty check — give it one short beat,
                    # re-drain, and let stop()'s post-join residual
                    # drain catch anything even later
                    time.sleep(0.01)
                    if rings.pending():
                        continue
                    return
                wake.wait()
                continue
            msgs_n = 0
            for node_name, msgs in out:
                try:
                    self._send_batch_inline(node_name, msgs)
                except Exception:  # noqa: BLE001
                    logger.exception(
                        "coordinator %s: egress sender batch to %s failed",
                        self.name, node_name,
                    )
                msgs_n += len(msgs)
            self.counters.incr("egress_thread_batches", n)
            self.counters.incr("egress_thread_msgs", msgs_n)
            out.clear()

    def _coop_drainer(self):
        """Register the calling thread as a drainer for the span of one
        cooperative step_* call (its self-publishes divert to
        ``_internal_q`` instead of gate-waiting on a ring it is itself
        responsible for draining). Returns a token for ``_coop_done``."""
        ident = threading.get_ident()
        if ident in self._drainer_idents:
            return 0
        self._drainer_idents.add(ident)
        return ident

    def _coop_done(self, token: int) -> None:
        if token:
            self._drainer_idents.discard(token)

    def step_once(self) -> bool:
        """One SEQUENTIAL coordinator iteration: drain ingress, scatter
        host log updates, run the fused device step, realise egress.
        Returns False when there was nothing to do. Deterministic-test
        and cooperative-driver entry point — never call it on a started
        pipelined coordinator (realisation order would invert)."""
        token = self._coop_drainer()
        try:
            return self._step_once_inner()
        finally:
            self._coop_done(token)

    def _step_once_inner(self) -> bool:
        pre = self._drain_classify()  # heavy half, off the state lock
        with self._state_lock:
            prev = self._coop_ticket
            if prev is not None:
                # flush a leftover pipelined-driver ticket first so
                # realisation order is preserved across driver modes
                self._coop_ticket = None
                eg_np = (
                    self._dev.realise(prev.eg_packed)
                    if prev.eg_packed is not None else None
                )
                self._finish_ticket(prev, eg_np)
                # the pre-drained items are NOT lost: hand them to the
                # dispatch pass the driver's next call runs
                self._drain_and_dispatch(dispatch=False, pre=pre)
                return True
            ticket = self._drain_and_dispatch(pre=pre)
            if ticket is None:
                return False
            eg_np = (
                self._dev.realise(ticket.eg_packed)
                if ticket.eg_packed is not None else None
            )
            self._finish_ticket(ticket, eg_np)
            return True

    def step_stage(self) -> bool:
        """Cooperative-pipeline half A: drain ingress, append commands,
        ship drain-produced AERs, and DISPATCH the fused device step
        (async), parking the ticket for ``step_finish``. A multi-
        coordinator driver stages every coordinator first, then
        finishes every coordinator — each device step then computes
        while the driver stages the others (the single-thread form of
        the wave pipeline, docs/INTERNALS.md §15)."""
        token = self._coop_drainer()
        try:
            return self._step_stage_inner()
        finally:
            self._coop_done(token)

    def _step_stage_inner(self) -> bool:
        pre = self._drain_classify()  # heavy half, off the state lock
        with self._state_lock:
            prev = self._coop_ticket
            if prev is not None:
                # driver skipped a finish: realise in order first
                self._coop_ticket = None
                eg_np = (
                    self._dev.realise(prev.eg_packed)
                    if prev.eg_packed is not None else None
                )
                self._finish_ticket(prev, eg_np)
            ticket = self._drain_and_dispatch(pre=pre)
            self._coop_ticket = ticket
            return ticket is not None

    def step_finish(self) -> bool:
        """Cooperative-pipeline half B: realise the ticket parked by
        ``step_stage`` (egress sync + processing + commit-driven AERs).
        Counts the staged-while-in-flight overlap."""
        token = self._coop_drainer()
        try:
            return self._step_finish_inner()
        finally:
            self._coop_done(token)

    def _step_finish_inner(self) -> bool:
        with self._state_lock:
            ticket = self._coop_ticket
            if ticket is None:
                return False
            self._coop_ticket = None
            t0 = time.perf_counter_ns()
            eg_np = (
                self._dev.realise(ticket.eg_packed)
                if ticket.eg_packed is not None else None
            )
            self._finish_ticket(ticket, eg_np)
            if ticket.stepped:
                self.counters.incr("pipeline_steps")
                # host work done between device dispatch and egress
                # sync (AER fan-out + the other coordinators' staging):
                # the window the device step computed inside
                hidden = t0 - ticket.t_pack
                if hidden > 0:
                    self.counters.incr("pipeline_overlap_ns", hidden)
            return True

    def step_pipelined(self) -> bool:
        """One cooperative PIPELINED iteration (single-driver-thread
        form of the wave pipeline, docs/INTERNALS.md §15): realise the
        PREVIOUSLY dispatched step (its device compute had the whole
        driver round to finish), then stage + dispatch the next one —
        whose drain already sees the realised egress's products, and
        whose device compute overlaps this thread realising the OTHER
        coordinators in the round-robin. Drain-produced AERs leave at
        dispatch time (inside ``_drain_and_dispatch``), so replication
        fan-out never waits a pipeline slot. Same ticket machinery as
        the threaded loop; keep calling until False before reading
        final state, and do not mix with a started loop."""
        token = self._coop_drainer()
        try:
            return self._step_pipelined_inner()
        finally:
            self._coop_done(token)

    def _step_pipelined_inner(self) -> bool:
        pre = self._drain_classify()  # heavy half, off the state lock
        with self._state_lock:
            prev = self._coop_ticket
            self._coop_ticket = None
            if prev is not None:
                eg_np = (
                    self._dev.realise(prev.eg_packed)
                    if prev.eg_packed is not None else None
                )
                self._finish_ticket(prev, eg_np)
            t0 = time.perf_counter_ns()
            ticket = self._drain_and_dispatch(pre=pre)
            self._coop_ticket = ticket
            if ticket is not None and prev is not None:
                # staged+dispatched in the same round a previous step
                # was realised: the new device step runs while the
                # driver services the other coordinators
                self.counters.incr(
                    "pipeline_overlap_ns", time.perf_counter_ns() - t0
                )
                self.counters.incr("pipeline_steps")
            return ticket is not None or prev is not None

    class _StepTicket:
        """One dispatched-but-unrealised step: the device egress handle
        plus everything realisation needs (who was consumed, the
        position->gid map, rares, and the staging timestamps)."""

        __slots__ = ("eg_packed", "consumed", "act", "aer_dirty", "rare",
                     "mbox_buf", "t_in", "t_drain", "t_pack", "stepped")

        def __init__(self, **kw):
            for k in self.__slots__:
                setattr(self, k, kw.get(k))

    def _drain_classify(self):
        """Lock-FREE half of the drain (docs/INTERNALS.md §16): pop
        every ingress lane into the reusable scratch and classify in
        one pass — commands regroup per target, generic messages
        collect into a route list, low-priority commands set aside.
        Runs on the step/driver thread WITHOUT the state lock: the
        classification of a deep-pipelined burst is O(items) pure
        Python, and holding the state lock through it starved the WAL
        writer's ``wal_notify_many`` (measured: 4x total fsync time,
        p99 8 ms -> 150 ms at 10240x96 — the writer blocked behind the
        lock, its queue grew, and every later batch paid the backlog).
        Only ``by_name`` reads happen here (GIL-safe dict reads; a
        concurrently added group at worst misses one pass, the same
        contract ``deliver`` already has). Returns the pre-drain
        ``(t_in, n_items, cmd_q, routes, lows)`` consumed by
        ``_drain_and_dispatch`` under the lock."""
        _t_in = time.perf_counter_ns()
        buf = self._drain_buf
        # native classify (docs/INTERNALS.md §18): drain the RC_* code
        # sidecar alongside the items and let rt_classify partition the
        # burst with the GIL released; Python keeps the routing half.
        # Routes around itself while ANY failpoint is armed so nemesis
        # runs always exercise the Python classification seam.
        nat = self._nat_classify and not faults.anything_armed()
        codes = self._drain_codes
        n_items = self._rings.drain(buf, codes if nat else None)
        if self._overflow_q:
            # overflow items are NEWER than the ring contents drained
            # above (a publish only overflows while the lane is full of
            # its own earlier items), so they fold AFTER the lane
            # drain; cross-pass order is kept by the producer-side
            # divert (a must-deliver publish goes straight to overflow
            # while older overflow is still parked — see deliver/
            # ingest_batch)
            with self._overflow_lock:
                n_items += len(self._overflow_q)
                buf.extend(self._overflow_q)
                if nat:
                    codes.extend(self._overflow_codes)
                self._overflow_q.clear()
                self._overflow_codes.clear()
        cmd_q: Optional[Dict[str, List[Command]]] = None
        routes: Optional[List] = None
        lows: Optional[List] = None
        if buf:
            cmd_q = {}
            routes = []
            lows = []
            if nat and len(codes) == len(buf):
                t0 = time.perf_counter_ns()
                part = _native.classify(codes, len(buf))
                if part is not None:
                    self._route_classified(buf, part, cmd_q, routes, lows)
                    self._wave_h["classify_native"].record(
                        time.perf_counter_ns() - t0)
                    self.counters.incr("native_classify_batches")
                    self.counters.incr("native_classify_items", len(buf))
                    buf.clear()
                    codes.clear()
                    self.counters.incr("ingress_ring_msgs", n_items)
                    self.counters.incr("ingress_ring_drains")
                    self._ring_gate.open()
                    return (_t_in, n_items, cmd_q, routes, lows)
                self.counters.incr("native_fallbacks")
            radd = routes.append
            by = self.by_name
            cq_get = cmd_q.get
            R_MSG, R_CMD, R_CMDS = self._R_MSG, self._R_CMD, self._R_CMDS
            for item in buf:
                tag = item[0]
                if tag == R_CMD:
                    _, name, cmd = item
                    if name not in by:
                        continue
                    if cmd.priority == "low":
                        lows.append((name, cmd))
                        continue
                    q = cq_get(name)
                    if q is None:
                        cmd_q[name] = [cmd]
                    else:
                        q.append(cmd)
                elif tag == R_MSG:
                    _, name, from_sid, msg = item
                    if name in by:
                        radd((name, from_sid, msg))
                elif tag == R_CMDS:
                    _, names, cmd = item
                    if cmd.priority == "low":
                        for name in names:
                            if name in by:
                                lows.append((name, cmd))
                        continue
                    for name in names:
                        q = cq_get(name)
                        if q is None:
                            if name not in by:
                                continue
                            cmd_q[name] = [cmd]
                        else:
                            q.append(cmd)
                else:  # R_BATCH: pre-normalized (name, from_sid, msg)
                    for trip in item[1]:
                        name = trip[0]
                        msg = trip[2]
                        if type(msg) is Command:
                            if msg.priority == "low":
                                if name in by:
                                    lows.append((name, msg))
                                continue
                            q = cq_get(name)
                            if q is None:
                                if name not in by:
                                    continue
                                cmd_q[name] = [msg]
                            else:
                                q.append(msg)
                        elif name in by:
                            radd(trip)
            buf.clear()
            if codes:
                codes.clear()
        if n_items:
            self.counters.incr("ingress_ring_msgs", n_items)
            self.counters.incr("ingress_ring_drains")
            # space was freed on every lane: wake ring-full waiters
            self._ring_gate.open()
        return (_t_in, n_items, cmd_q, routes, lows)

    def _route_classified(self, buf, part, cmd_q, routes, lows) -> None:
        """Python routing half of the native drain-classify: walk the
        per-class index partitions ``rt_classify`` returned (arrival
        order kept within each class) and run each class's straight-
        line routing loop — no per-item tag dispatch, no priority
        checks (the producer stamped those into the RC_* code).

        Ordering contract (docs/INTERNALS.md §18): order is preserved
        WITHIN each class; classes may reorder against each other.
        That is safe because any producer's causally-ordered commands
        ride a single class (clients publish R_CMD, bulk drivers
        R_CMDS, peer forwards R_BATCH) and protocol traffic is
        reorder-tolerant by the transport contract."""
        idx, counts = part
        ilist = idx.tolist()
        c_msg, c_cmd, c_cmd_low, c_cmds, c_cmds_low, c_batch = counts.tolist()
        by = self.by_name
        cq_get = cmd_q.get
        radd = routes.append
        ladd = lows.append
        o = 0
        for k in ilist[o:o + c_msg]:
            item = buf[k]
            name = item[1]
            if name in by:
                radd((name, item[2], item[3]))
        o += c_msg
        for k in ilist[o:o + c_cmd]:
            _, name, cmd = buf[k]
            if name not in by:
                continue
            q = cq_get(name)
            if q is None:
                cmd_q[name] = [cmd]
            else:
                q.append(cmd)
        o += c_cmd
        for k in ilist[o:o + c_cmd_low]:
            _, name, cmd = buf[k]
            if name in by:
                ladd((name, cmd))
        o += c_cmd_low
        for k in ilist[o:o + c_cmds]:
            _, names, cmd = buf[k]
            for name in names:
                q = cq_get(name)
                if q is None:
                    if name not in by:
                        continue
                    cmd_q[name] = [cmd]
                else:
                    q.append(cmd)
        o += c_cmds
        for k in ilist[o:o + c_cmds_low]:
            _, names, cmd = buf[k]
            for name in names:
                if name in by:
                    ladd((name, cmd))
        o += c_cmds_low
        for k in ilist[o:o + c_batch]:
            for trip in buf[k][1]:
                name = trip[0]
                msg = trip[2]
                if type(msg) is Command:
                    if msg.priority == "low":
                        if name in by:
                            ladd((name, msg))
                        continue
                    q = cq_get(name)
                    if q is None:
                        if name not in by:
                            continue
                        cmd_q[name] = [msg]
                    else:
                        q.append(msg)
                elif name in by:
                    radd(trip)

    def _drain_and_dispatch(
        self, dispatch: bool = True, pre=None
    ) -> Optional["BatchCoordinator._StepTicket"]:
        # caller holds the state lock; ``pre`` is _drain_classify()'s
        # output taken BEFORE the lock (drivers pre-classify so the
        # heavy classification never blocks the WAL writer). A None pre
        # classifies inline (tests / direct step calls).
        if pre is None:
            pre = self._drain_classify()
        _t_in, n_items, cmd_q, routes, lows = pre
        # fold the step/egress threads' own must-deliver self-publishes
        # (machine Append/Aux effects realized under the state lock —
        # including by the prev-ticket finish that just ran): they are
        # few, and folding here keeps their same-pass ordering
        if self._internal_q:
            iq = self._internal_q
            R_CMD = self._R_CMD
            if cmd_q is None:
                cmd_q, routes, lows = {}, [], []
            by = self.by_name
            n_internal = 0
            while iq:
                item = iq.popleft()
                n_internal += 1
                if item[0] == R_CMD:
                    _, name, cmd = item
                    if name not in by:
                        continue
                    if cmd.priority == "low":
                        lows.append((name, cmd))
                        continue
                    q = cmd_q.get(name)
                    if q is None:
                        cmd_q[name] = [cmd]
                    else:
                        q.append(cmd)
                else:
                    _, name, from_sid, msg = item
                    if name in by:
                        routes.append((name, from_sid, msg))
            # counted in n_items (pass-has-work accounting) but NOT in
            # ingress_ring_msgs — these never touched a ring
            n_items += n_internal
        # seed rares / AER-dirty gids parked by earlier ingest-only
        # passes (pipelined loop).
        # ALWAYS detach (aliasing trap): _route_one appends into it,
        # so keeping an alias of the live (empty) container would
        # re-seed — and re-process — this pass's rares on the next pass
        rare: List[Tuple[GroupHost, Any, Optional[ServerId]]] = (
            self._pending_rare
        )
        self._pending_rare = []
        aer_dirty: set = set()
        # appended runs: gid -> [[lo, hi, term], ...] (contiguous,
        # same-term); written: gid -> max durable idx. Run-based so the
        # device scatter is one row per touched GROUP, not per entry.
        # These ARE the staged double-buffer halves: ingest-only passes
        # leave their folds in place and the next dispatching pass
        # consumes them with zero re-merging (the WAL writer thread
        # stages durable watermarks into _staged_written directly).
        appended = self._staged_app
        written = self._staged_written
        # replies produced during routing (deferred durable acks): one
        # transport hop per destination per step, not one per group
        route_out: Dict[str, List] = {}

        by_get = self.by_name.get
        route = self._route_one
        if lows:
            low_dirty = self._low_dirty
            for name, cmd in lows:
                g = by_get(name)
                if g is not None:
                    g.low_q.append(cmd)
                    low_dirty.add(g.gid)
        if routes:
            now_mono = self.clock.monotonic()
            for name, from_sid, msg in routes:
                g = by_get(name)
                if g is not None:
                    route(g, from_sid, msg, rare, appended, written,
                          aer_dirty, route_out, now_mono)
        if route_out:
            for node_name, msgs in route_out.items():
                self._send_batch(node_name, msgs)
        if cmd_q:
            for name, cmds in cmd_q.items():
                g = by_get(name)
                if g is not None:
                    self._handle_commands(g, cmds, appended, written, aer_dirty)
        if self._low_dirty:
            self._drain_low_lane(appended, written, aer_dirty)

        if not dispatch:
            # ingest-only pass (a ticket is still being realised): the
            # drained work is already folded into the staged scatter
            # dicts the next dispatching pass consumes, and commands
            # have already reached the logs and the WAL queue — the
            # coalescing the pipeline is for happens here.
            if rare:
                self._pending_rare = rare
            if aer_dirty:
                # replication fan-out never waits for the next dispatch:
                # fresh appends ship while the in-flight step realises
                self._send_aers(aer_dirty)
            if n_items:
                self.counters.incr("staging_passes")
                _t_drain = time.perf_counter_ns()
                self._wave_h["ingress_drain"].record(_t_drain - _t_in)
                if self._trace.enabled:
                    self._trace.span("ingress_drain", self.name, _t_in,
                                     _t_drain - _t_in)
            return None
        if not (
            n_items or self._hot or rare or appended or written
            or self._pending_roles
        ):
            return None
        _t_drain = time.perf_counter_ns()

        if self._pending_roles:
            gids, roles, _ = self._pad3(
                [(gid, role, 0) for gid, role in self._pending_roles]
            )
            self._pending_roles = []
            self.state = self._dev.set_roles(self.state, gids, roles)

        # consume the staged halves: detach so concurrent stagers (the
        # WAL writer thread, the egress thread's rare paths) start a
        # fresh buffer for the NEXT dispatch
        self._staged_app = {}
        self._staged_written = {}

        app_rows: List[Tuple[int, int, int, int]] = []
        if appended:
            legacy: List[Tuple[int, int, int]] = []  # older runs, per entry
            for gid, runs in appended.items():
                for lo, hi, term in runs[:-1]:
                    legacy.extend((gid, i, term) for i in range(lo, hi + 1))
                lo, hi, term = runs[-1]
                app_rows.append((gid, lo, hi, term))
            if legacy:
                # rare (mixed-term batches): scatter older runs first so
                # the newest run's ring slots win
                gids, idxs, terms = self._pad3(legacy)
                self.state = self._dev.record_appended(
                    self.state, gids, idxs, terms
                )
        if written and self._lat_gids:
            now_w = time.monotonic_ns()
            for gid_w in self._lat_gids:
                idx_w = written.get(gid_w)
                gw = self.groups[gid_w] if idx_w is not None else None
                if gw is None:
                    continue
                lat = gw.lat
                if lat is not None and lat[3] == 0 and idx_w >= lat[0]:
                    lat[3] = now_w
                    self._commit_h["append_durable"].record(now_w - lat[2])

        # activity-scaled path selection: groups with device-relevant
        # work this step are exactly the hot set (queued messages/term
        # hints) plus those whose log tail or durable watermark moved
        # (the quorum scan can advance their commit). Everything else
        # is provably unchanged by an empty-mailbox step.
        # The newest appended runs and the durable watermarks ride the
        # packed mailbox itself (C.MBOX_SCAT_FIELDS rows) and apply
        # inside the fused step — one transfer + one dispatch per step.
        # A sharded coordinator never takes the active set (as in the
        # reference): every slice steps at full width.
        self._flush_member_rows()
        act: Optional[list] = None
        if not self._sharded and self.active_set != "never":
            cand = self._hot | appended.keys() | written.keys()
            if self.active_set == "always" or len(cand) <= (self.capacity >> 2):
                act = sorted(cand)
        eg_packed = consumed = act_np = mbox_buf = None
        stepped = False
        if act is not None:
            if act:
                gidx, act_np, consumed, mbox_buf = self._build_mailbox_sub(
                    act, app_rows, written
                )
                self.state, eg_packed = self._dev.step_sub(
                    self.state, mbox_buf, gidx
                )
                stepped = True
                self.steps += 1
                self.sub_steps += 1
                self.msgs_processed += len(consumed)
        else:
            # the newest appended runs and the watermarks ride the
            # mailbox's scatter rows on every path: a sharded seam splits
            # them by group id, so each slice's step applies its own
            consumed, mbox_buf = self._build_mailbox(app_rows, written)
            self.state, eg_packed = self._dev.step_full(self.state, mbox_buf)
            stepped = True
            self.steps += 1
            self.msgs_processed += len(consumed)
        if stepped:
            # egress download starts now (asynchronous on CUDA)
            eg_packed = self._dev.start_fetch(eg_packed)
        # full-width steps are the shape worth pre-zeroing a spare
        # mailbox for during the next overlap window (sub-batch buffers
        # are tiny; zeroing them inline is already free)
        self._prezero_useful = stepped and act is None
        _t_pack = time.perf_counter_ns()
        # dispatch is ASYNC: eg_packed is an in-flight device value; the
        # ticket's realisation half syncs it (DeviceSeam.realise) and processes
        # the egress. The sequential step_once realises inline.
        # Drain-produced AERs (fresh appends, ack-driven next_index
        # moves) leave NOW, overlapping the device compute — holding
        # them for realisation would delay the replication fan-out by a
        # whole pipeline slot. Egress-produced AERs (commit advances)
        # ride the ticket.
        sent_aers = bool(aer_dirty)
        if sent_aers:
            self._send_aers(aer_dirty)
            aer_dirty = set()
        _t_aer0 = time.perf_counter_ns()
        wh = self._wave_h
        wh["ingress_drain"].record(_t_drain - _t_in)
        if stepped:
            wh["host_pack"].record(_t_pack - _t_drain)
        if sent_aers:
            wh["aer_fanout"].record(_t_aer0 - _t_pack)
        tb = self._trace
        if tb.enabled:
            node = self.name
            tb.span("ingress_drain", node, _t_in, _t_drain - _t_in)
            if stepped:
                tb.span("host_pack", node, _t_drain, _t_pack - _t_drain)
            if sent_aers:
                tb.span("aer_fanout", node, _t_pack, _t_aer0 - _t_pack)
        return self._StepTicket(
            eg_packed=eg_packed if stepped else None,
            consumed=consumed, act=act_np, aer_dirty=aer_dirty, rare=rare,
            mbox_buf=mbox_buf, t_in=_t_in, t_drain=_t_drain, t_pack=_t_pack,
            stepped=stepped,
        )

    def _finish_ticket(self, ticket, eg_np: Optional[np.ndarray]) -> None:
        """Realise one dispatched step: process the synced egress, run
        the rare paths, fan out AERs (caller holds the state lock and
        has already synced ``eg_np`` — ideally outside the lock)."""
        aer_dirty = ticket.aer_dirty
        _t_dev = None
        if eg_np is not None:
            _t_dev = time.perf_counter_ns()
            # egress is host-synced: the device has fully consumed the
            # mailbox view, so the pack buffer may be reused
            self._mbox_release(ticket.mbox_buf)
            eg = {name: eg_np[i] for i, name in enumerate(C.EGRESS_FIELDS)}
            self._process_egress(eg, ticket.consumed, aer_dirty,
                                 act=ticket.act)
        # rare-path outbound batches per destination ACROSS the whole
        # rare loop: an election storm over 10k groups must land on a
        # peer as a handful of ring items, not one per group — per-group
        # sends overflowed the peer's bounded ingress lane and the
        # overflow was shed as lossy traffic, wedging the un-retried
        # tail of the storm (caught by the 10240-group bench election)
        rare_out: Dict[str, List] = {}
        self._install_rows = {}
        for g, msg, from_sid in ticket.rare:
            if g.gid in self._install_rows:
                # a group's deferred install rows land before its next
                # message is handled
                self._flush_install_rows()
                self._install_rows = {}
            # crash isolation for the slow paths (snapshot transfer
            # decode of untrusted bytes, membership, queries): a
            # poisoned message must not kill the step thread — every
            # group on this coordinator would freeze (the actor backend
            # gets the same guarantee from scheduler crash isolation)
            try:
                self._handle_rare(g, msg, from_sid, rare_out)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "coordinator %s: dropping rare message %r for group "
                    "%s after handler crash", self.name, type(msg).__name__,
                    g.name,
                )
        self._flush_install_rows()
        self._flush_member_rows()
        meta_sync = getattr(self.meta, "sync", None)
        if meta_sync is not None:
            meta_sync()  # the pass's forced candidacies, before they leave
        for node_name, msgs in rare_out.items():
            self._send_batch(node_name, msgs)
        _t_eg = time.perf_counter_ns()
        self._send_aers(aer_dirty)
        _t_aer = time.perf_counter_ns()
        # apply progress may have released admission-window room: wake
        # parked rejected clients (no-op attribute check when none)
        self._adm_gate.open()
        # per-step wave-phase breakdown (obs.WAVE_PHASES). host_pack
        # covered queued-scatter application + mailbox build + dispatch
        # (recorded at dispatch time); device_step is the egress host
        # sync (the device-compute wait); host_egress includes apply
        # and client replies (apply also gets its own histogram).
        wh = self._wave_h
        if _t_dev is not None:
            wh["device_step"].record(_t_dev - ticket.t_pack)
            wh["host_egress"].record(_t_eg - _t_dev)
        wh["aer_fanout"].record(_t_aer - _t_eg)
        tb = self._trace
        if tb.enabled:
            # same timestamps the histograms just consumed, as timeline
            # spans: one lane per phase per node, so step-pipelining
            # overlap (or its absence) is visible in Perfetto
            node = self.name
            if _t_dev is not None:
                tb.span("device_step", node, ticket.t_pack,
                        _t_dev - ticket.t_pack)
                tb.span("host_egress", node, _t_dev, _t_eg - _t_dev)
            tb.span("aer_fanout", node, _t_eg, _t_aer - _t_eg)

    def _stage_app(self, gid: int, lo: int, hi: int, term: int) -> None:
        """Stage an appended run for the next dispatching pass's device
        scatter (caller holds the state lock). Contiguous same-term runs
        merge in place — the staging half of the double buffer."""
        runs = self._staged_app.get(gid)
        if runs is None:
            self._staged_app[gid] = [[lo, hi, term]]
        elif runs[-1][1] + 1 == lo and runs[-1][2] == term:
            runs[-1][1] = hi
        else:
            runs.append([lo, hi, term])

    def _stage_written(self, gid: int, idx: int) -> None:
        """Stage a durable watermark (caller holds the state lock)."""
        if self._staged_written.get(gid, 0) < idx:
            self._staged_written[gid] = idx

    def _pad(self, rows, width: int):
        """Pad scatter batches to power-of-two buckets (the reference's
        bound on compiled shapes; kept so both packages scatter the same
        rows). Pads use an out-of-bounds group id, which the scatters
        drop. Returns one host column per input column."""
        n = len(rows)
        cap = 1
        while cap < n:
            cap <<= 1
        arr = np.zeros((cap, width), np.int32)
        arr[n:, 0] = self.capacity
        if n:
            arr[:n] = rows
        return tuple(arr[:, c] for c in range(width))

    def _pad3(self, triples):
        return self._pad(triples, 3)

    def _pad4(self, rows):
        return self._pad(rows, 4)

    # -- ingress routing ---------------------------------------------------

    def _route_one(self, g: GroupHost, from_sid, msg, rare, appended,
                   written, aer_dirty, route_out, now_mono=None):
        if now_mono is None:
            now_mono = self.clock.monotonic()
        if type(msg) is FromPeer:
            from_sid, msg = msg.peer, msg.msg
        t = type(msg)
        if t in MSG_OF_TYPE:
            if t is AppendEntriesRpc and msg.term >= g.term:
                g.last_contact = now_mono
                if self.lease_cfg.enabled:
                    # leader contact backing the stickiness promise,
                    # plus the follower freshness anchor for bounded
                    # local reads (docs/INTERNALS.md §20)
                    g.lease_contact = now_mono
                    if msg.commit_ts > g.fresh_anchor[1]:
                        if g.last_applied >= msg.leader_commit:
                            if msg.commit_ts > g.fresh_ts:
                                g.fresh_ts = msg.commit_ts
                        else:
                            g.fresh_anchor = (
                                msg.leader_commit, msg.commit_ts
                            )
            # host-side next_index bookkeeping rides on the same replies
            # the device will process
            elif t is AppendEntriesReply and g.role == C.R_LEADER:
                slot = g.slot_of(from_sid)
                if slot >= 0:
                    g.last_ack[slot] = now_mono
                    if self.lease_cfg.enabled and msg.term == g.term:
                        # any same-term reply (success or reject)
                        # proves contact: credit the send basis
                        self._lease_credit(g, slot)
                    if msg.success:
                        g.next_index[slot] = max(g.next_index[slot], msg.last_index + 1)
                        if slot < len(g.match_hint):
                            g.match_hint[slot] = max(
                                g.match_hint[slot], msg.last_index
                            )
                        vs = g.voter_status.get(slot)
                        if (
                            isinstance(vs, tuple)
                            and vs[0] == "nonvoter"
                            and msg.last_index >= vs[1]
                            and g.cluster_change_permitted
                        ):
                            # caught-up nonvoter: promote via a cluster
                            # change (reference: maybe_promote_peer,
                            # src/ra_server.erl:3977-3995)
                            self._handle_command(
                                g,
                                Command(kind=RA_CLUSTER_CHANGE,
                                        data=((from_sid, "voter"),)),
                                appended, written, aer_dirty,
                            )
                    else:
                        hint = max(1, min(msg.next_index, msg.last_index + 1))
                        g.next_index[slot] = min(g.next_index[slot], hint)
                    aer_dirty.add(g.gid)
            elif (
                self.lease_cfg.enabled
                and (t is PreVoteRpc or t is RequestVoteRpc)
                and not (t is RequestVoteRpc and msg.force)
                and g.slot_of(msg.candidate_id) != g.leader_slot
                and not self._stickiness_lapsed(g, now_mono)
            ):
                # leader stickiness (§20): within one election timeout
                # of leader contact, (pre-)votes for other candidates
                # are disregarded — denied at OUR term, without letting
                # the device adopt the higher term (the term echo would
                # depose the live leader the lease depends on).
                # TimeoutNow-forced candidacies bypass: the old leader
                # revoked its lease before soliciting the vote.
                deny = (
                    PreVoteResult(g.term, msg.token, False)
                    if t is PreVoteRpc
                    else RequestVoteResult(g.term, False)
                )
                out = route_out.get(msg.candidate_id[1])
                if out is None:
                    route_out[msg.candidate_id[1]] = out = []
                out.append((msg.candidate_id, deny, (g.name, self.name)))
                return
            g.inbox.append((from_sid, msg))
            self._hot.add(g.gid)
            return
        if isinstance(msg, Command):
            self._handle_command(g, msg, appended, written, aer_dirty)
            return
        if isinstance(msg, tuple) and msg and msg[0] == "log_event":
            _, evt = msg
            g.log.handle_event(evt)
            wi, wt = g.log.last_written()
            if written.get(g.gid, 0) < wi:
                written[g.gid] = wi
            aer_dirty.add(g.gid)
            if g.pending_ack is not None and wi >= g.pending_ack[1]:
                leader_sid, cover = g.pending_ack
                g.pending_ack = None
                ack = min(wi, cover)
                at = g.log.fetch_term(ack)
                out = route_out.get(leader_sid[1])
                if out is None:
                    route_out[leader_sid[1]] = out = []
                out.append(
                    (leader_sid,
                     AppendEntriesReply(g.term, True, ack + 1, ack,
                                        at if at is not None else wt),
                     (g.name, self.name))
                )
            return
        rare.append((g, msg, from_sid))

    def _handle_command(self, g: GroupHost, cmd: Command, appended, written, aer_dirty):
        self._handle_commands(g, (cmd,), appended, written, aer_dirty)

    # max low-priority commands appended per group per step (reference:
    # ?FLUSH_COMMANDS_SIZE, src/ra_server.hrl:34)
    FLUSH_COMMANDS_SIZE = 16

    def _drain_low_lane(self, appended, written, aer_dirty) -> None:
        """Bounded per-step drain of buffered low-priority commands —
        normal ingest always goes first; lows trickle in slices so a
        low-priority firehose cannot starve interactive traffic
        (reference: ra_ets_queue lane, src/ra_server_proc.erl:507-530).
        Non-leaders redirect buffered lows instead of dropping futures.
        Low-priority routing now happens at ring-drain time on the step
        thread (under the state lock), so ``low_q``/``_low_dirty`` have
        a single writer and need no extra lock."""
        dirty = self._low_dirty
        self._low_dirty = set()
        still: set = set()
        for gid in dirty:
            g = self.groups[gid]
            if g is None or not g.low_q:
                continue
            if g.role != C.R_LEADER:
                red = ("redirect", g.sid_of(g.leader_slot))
                for cmd in g.low_q:
                    if cmd.from_ref is not None:
                        self._reply(cmd.from_ref, red)
                g.low_q.clear()
                continue
            take = [
                g.low_q.popleft()
                for _ in range(min(self.FLUSH_COMMANDS_SIZE, len(g.low_q)))
            ]
            if g.low_q:
                still.add(gid)
            self._handle_commands(g, take, appended, written, aer_dirty)
        if still:
            self._low_dirty |= still

    def _handle_commands(self, g: GroupHost, cmds, appended, written, aer_dirty):
        """Append a batch of client commands for one group: one pass of
        log/run/reply bookkeeping instead of per-command."""
        if g.role != C.R_LEADER:
            red = ("redirect", g.sid_of(g.leader_slot))
            for cmd in cmds:
                if cmd.from_ref is not None:
                    self._reply(cmd.from_ref, red)
            return
        log = g.log
        term = g.term
        gid = g.gid
        pending = g.pending_replies
        me = (g.name, self.name)
        idx = log.next_index()
        first = idx
        # admission window: bound the group's appended-but-unapplied
        # backlog so a client cannot queue unbounded work ahead of apply
        # progress (the client analog of the reference's per-peer
        # pipeline window, src/ra_server.hrl:8). Commands past the
        # window are rejected with backoff (from_ref callers see
        # ("reject", "overloaded") and retry) or dropped and counted:
        # noreply commands owe no ack, and notify-mode pipelined
        # commands are at-most-once by contract (clients resend on a
        # missing applied notification — reference pipeline_command
        # semantics). Machine-INTERNAL commands (timer fires, Append
        # effects) fire exactly once with no retry path: never shed.
        if self.pressure.blocked():
            # storage-degraded pre-emption (docs/INTERNALS.md §21):
            # space-class WAL failure or hard disk watermark. Client
            # commands reject typed ("reject", "nospace") with the
            # pressure gate's waiter (opens when the probe write
            # succeeds); machine-internal commands still admit — they
            # fire exactly once with no retry path.
            admit2 = [c for c in cmds if c.internal]
            shed2 = [c for c in cmds if not c.internal]
            n_rej2 = 0
            for cmd in shed2:
                if cmd.from_ref is not None:
                    n_rej2 += 1
                    self._reply(
                        cmd.from_ref,
                        REJECT_NOSPACE + (self.pressure.waiter(),),
                    )
            if n_rej2:
                self.counters.incr("commands_rejected_nospace", n_rej2)
            if len(shed2) > n_rej2:
                self.counters.incr(
                    "commands_dropped_overload", len(shed2) - n_rej2
                )
            if shed2:
                self._obs_rec.record(
                    "admission_reject", node=self.name, group=g.name,
                    term=term,
                    detail=(f"nospace rejected={n_rej2} "
                            f"dropped={len(shed2) - n_rej2}"),
                )
            cmds = admit2
            if not cmds:
                return
        room = self.max_command_backlog - (first - 1 - g.last_applied)
        if room < len(cmds):
            admit: List[Command] = []
            shed: List[Command] = []
            for cmd in cmds:
                if cmd.internal or len(admit) < room:
                    admit.append(cmd)
                else:
                    shed.append(cmd)
            cmds = admit
            n_rej = 0
            for cmd in shed:
                if cmd.from_ref is not None:
                    n_rej += 1
                    # the reject carries an admission-gate waiter:
                    # api.process_command parks on it and is WOKEN on
                    # window release (apply progress) instead of
                    # sleeping a fixed backoff (docs/INTERNALS.md §16)
                    self._reply(
                        cmd.from_ref,
                        REJECT_OVERLOADED + (self._adm_gate.waiter(),),
                    )
            if n_rej:
                self.counters.incr("commands_rejected", n_rej)
            if len(shed) > n_rej:
                self.counters.incr(
                    "commands_dropped_overload", len(shed) - n_rej
                )
            if shed:
                self._obs_rec.record(
                    "admission_reject", node=self.name, group=g.name,
                    term=term,
                    detail=f"rejected={n_rej} dropped={len(shed) - n_rej}",
                )
            if not cmds:
                return
        # commit-stage sampling: bounded to groups on the sample mask,
        # and only for commands stamped with a submit ts
        sampled = (gid & self._lat_mask) == 0
        t_h0 = time.monotonic_ns() if sampled else 0
        # fast path: plain user commands owing no replies (the pipeline
        # shape) — build the run in one pass and bulk-append it
        simple = True
        for cmd in cmds:
            if cmd.kind != USR or cmd.from_ref is not None:
                simple = False
                break
        if simple:
            entries = [Entry(first + k, term, cmd) for k, cmd in enumerate(cmds)]
            _li, prev_term = log.last_index_term()
            log.append_many(entries)
            idx = first + len(cmds)
            ft = g.fresh_tail
            if ft is not None and ft[0] + len(ft[3]) == first and ft[2] == term:
                ft[3].extend(entries)  # second batch this step: one run
            else:
                g.fresh_tail = (first, prev_term, term, entries)
        else:
            for cmd in cmds:
                if cmd.kind in (RA_JOIN, RA_LEAVE, RA_CLUSTER_CHANGE):
                    if not self._prepare_cluster_cmd(g, cmd):
                        continue
                log.append(Entry(idx, term, cmd))
                if cmd.kind != USR:
                    g.specials.append(idx)
                if cmd.from_ref is not None:
                    if cmd.reply_mode == "after_log_append":
                        self._reply(cmd.from_ref, ("ok", (idx, term), me))
                    elif cmd.reply_mode == "await_consensus":
                        pending[idx] = cmd.from_ref
                idx += 1
        if idx == first:
            return  # every command was rejected
        last = idx - 1
        if sampled:
            now_ns = time.monotonic_ns()
            self._wave_h["wal_handoff"].record(now_ns - t_h0)
            ts0 = cmds[0].ts
            lat = g.lat
            if ts0 is not None and (
                lat is None or now_ns - lat[1] > 10_000_000_000
            ):
                # one in-flight sample per group; a sample stranded >10s
                # (leadership churn) is abandoned and replaced
                g.lat = [last, ts0, now_ns, 0, 0]
                self._lat_gids.add(gid)
                self._commit_h["submit_append"].record(now_ns - ts0)
        runs = appended.get(gid)
        if runs is None:
            appended[gid] = [[first, last, term]]
        else:
            tail = runs[-1]
            if tail[1] + 1 == first and tail[2] == term:
                tail[1] = last
            else:
                runs.append([first, last, term])
        if log.last_written()[0] >= last and written.get(gid, 0) < last:
            written[gid] = last
        aer_dirty.add(gid)

    # -- membership (reference: $ra_join/$ra_leave handling,
    # src/ra_server.erl:3491-3542; one change in flight at a time) --------

    def _prepare_cluster_cmd(self, g: GroupHost, cmd: Command) -> bool:
        """Leader-side cluster change: apply to the host member table
        immediately (Raft new-config-on-append rule), gate one change at
        a time. Returns False when rejected (caller must not append)."""
        if not g.cluster_change_permitted:
            if cmd.from_ref is not None:
                self._reply(cmd.from_ref, ("error", "cluster_change_not_permitted"))
            return False
        # rollback point: the leader's own uncommitted change must be
        # undoable if it is deposed and a new leader truncates this
        # suffix — same protocol as follower-side _adopt_cluster_cmd
        # (the truncation rollback in _host_write_entries covers both)
        history = (g.log.next_index(), list(g.members), dict(g.voter_status))
        if cmd.kind == RA_JOIN:
            member, voter = cmd.data
            member = tuple(member)
            if member in g.members:
                if cmd.from_ref is not None:
                    self._reply(cmd.from_ref, ("ok", "already_member"))
                return False
            slot = self._alloc_slot(g)
            if slot is None:
                if cmd.from_ref is not None:
                    self._reply(cmd.from_ref, ("error", "group_at_peer_capacity"))
                return False
            li = g.log.last_index_term()[0]
            g.members[slot] = member
            g.voter_status[slot] = "voter" if voter else ("nonvoter", li)
            g.next_index[slot] = li + 1
            g.commit_sent[slot] = 0
        elif cmd.kind == RA_LEAVE:
            member = tuple(cmd.data)
            slot = g.slot_of(member)
            if slot < 0:
                if cmd.from_ref is not None:
                    self._reply(cmd.from_ref, ("ok", "not_member"))
                return False
            g.members[slot] = None
            g.voter_status[slot] = None
        else:  # RA_CLUSTER_CHANGE: explicit voter-status updates
            for member, vs in cmd.data:
                slot = g.slot_of(tuple(member))
                if slot >= 0:
                    g.voter_status[slot] = vs
        g.cluster_history.append(history)
        del g.cluster_history[:-8]
        g.cluster_change_permitted = False
        g.cluster_index = g.log.next_index()
        self._sync_member_rows(g)
        return True

    def _alloc_slot(self, g: GroupHost) -> Optional[int]:
        for i, m in enumerate(g.members):
            if m is None:
                g.last_ack.pop(i, None)  # fresh occupant, fresh liveness
                g.match_hint[i] = 0  # nothing confirmed for the newcomer
                return i  # reuse a tombstoned slot
        if len(g.members) < self.P:
            g.members.append(None)
            g.next_index.append(1)
            g.commit_sent.append(0)
            g.match_hint.append(0)
            return len(g.members) - 1
        return None

    def _sync_member_rows(self, g: GroupHost) -> None:
        """Stage the host member table's active/voting view for the
        device (call sites all run under the state lock); the pass's
        rows reach it in one scatter (``_flush_member_rows``)."""
        active = np.zeros(self.P, dtype=bool)
        voting = np.zeros(self.P, dtype=bool)
        for i, m in enumerate(g.members):
            if m is not None:
                active[i] = True
                voting[i] = g.voter_status.get(i) == "voter"
        self._member_rows[g.gid] = (active, voting)
        if self.lease_cfg.enabled:
            if g.role == C.R_LEADER:
                self._lease_revoke(g, "membership change")
            self._lease_sync(g)

    def _flush_member_rows(self) -> None:
        """Write the staged member rows to the device, one scatter a
        field for every group staged since the last flush (each group's
        last view, as the reference's one scatter a change leaves it).
        Runs under the state lock, before a step is dispatched, at the
        end of every realised pass and before another write of these
        rows."""
        rows, self._member_rows = self._member_rows, {}
        if rows:
            self.state = self._dev.set_rows(
                self.state, list(rows),
                active=np.stack([a for a, _v in rows.values()]),
                voting=np.stack([v for _a, v in rows.values()]),
            )

    def _adopt_cluster_cmd(self, g: GroupHost, cmd: Command, entry_index: int = 0) -> None:
        """Follower-side adoption of a replicated cluster change (slot
        coordinates are node-local; only the member set must agree)."""
        g.cluster_history.append(
            (entry_index, list(g.members), dict(g.voter_status))
        )
        del g.cluster_history[:-8]
        if cmd.kind == RA_JOIN:
            member, voter = cmd.data
            member = tuple(member)
            slot = g.slot_of(member)
            if slot < 0:
                slot = self._alloc_slot(g)
                if slot is not None:
                    g.members[slot] = member
            if slot is not None and slot >= 0:
                # also covers the joining member itself learning its own
                # (non)voter status from the replicated entry; the join
                # entry's index is the catch-up target should this node
                # lead later (never 0 — that would promote a lagging
                # learner on its first ack)
                g.voter_status[slot] = (
                    "voter" if voter else ("nonvoter", entry_index)
                )
        elif cmd.kind == RA_LEAVE:
            slot = g.slot_of(tuple(cmd.data))
            if slot >= 0:
                g.members[slot] = None
                g.voter_status[slot] = None
        else:
            if cmd.data and cmd.data[0] == "replace":
                # force-shrink style replacement
                new = [tuple(m) for m, _vs in cmd.data[1]]
                me = (g.name, self.name)
                if me in new:
                    g.members = list(new)
                    g.self_slot = new.index(me)
                    g.voter_status = {i: "voter" for i in range(len(new))}
                    g.next_index = [1] * len(new)
                    g.commit_sent = [0] * len(new)
                    g.match_hint = [0] * len(new)
                    self.state = self._dev.set_rows(
                        self.state, g.gid, self_slot=g.self_slot
                    )
            else:
                for member, vs in cmd.data:
                    slot = g.slot_of(tuple(member))
                    if slot >= 0:
                        g.voter_status[slot] = vs
        self._sync_member_rows(g)

    # -- mailbox build -----------------------------------------------------

    # packed mailbox row indexes (see C.MBOX_FIELDS), plus the fused
    # scatter rows that ride the same buffer (C.MBOX_SCAT_FIELDS)
    _R = {
        name: i
        for i, name in enumerate(list(C.MBOX_FIELDS) + C.MBOX_SCAT_FIELDS)
    }
    _NROWS = len(C.MBOX_FIELDS) + len(C.MBOX_SCAT_FIELDS)

    # mailbox row-index vectors for the two hot message types, in the
    # flat value order _pack_hot builds (the native rt_pack_mbox ABI)
    _REP_ROWS = np.asarray(
        [_R["msg_type"], _R["sender_slot"], _R["term"], _R["success"],
         _R["reply_next_idx"], _R["reply_last_idx"],
         _R["reply_last_term"]],
        np.int32,
    )
    _AER_ROWS = np.asarray(
        [_R["msg_type"], _R["sender_slot"], _R["term"], _R["prev_idx"],
         _R["prev_term"], _R["num_entries"], _R["entries_last_term"],
         _R["leader_commit"]],
        np.int32,
    )

    def _pack_hot(self, packed, aer_i, aer_m, aer_s, rep_i, rep_m,
                  rep_s) -> None:
        """Columnwise encode of the two hot message types into the
        packed mailbox. With the native pack path on, each class is one
        flat int64 value pass + one GIL-released scatter
        (rt_pack_mbox); otherwise (or while any failpoint is armed, or
        on a scatter bounds failure) the original per-field numpy
        column stores run — both produce byte-identical buffers."""
        if (
            (rep_i or aer_i)
            and self._nat_pack
            and not faults.anything_armed()
        ):
            t0 = time.perf_counter_ns()
            ok = True
            if rep_i:
                vals: List[int] = []
                ext = vals.extend
                for s, m in zip(rep_s, rep_m):
                    ext((C.MSG_AER_REPLY, s, m.term,
                         1 if m.success else 0, m.next_index,
                         m.last_index, m.last_term))
                ok = _native.pack_mbox(packed, rep_i, vals, self._REP_ROWS)
            if ok and aer_i:
                vals = []
                ext = vals.extend
                for s, m in zip(aer_s, aer_m):
                    ext((C.MSG_AER, s, m.term, m.prev_log_index,
                         m.prev_log_term, len(m.entries),
                         m.entries[-1].term if m.entries else 0,
                         m.leader_commit))
                ok = _native.pack_mbox(packed, aer_i, vals, self._AER_ROWS)
            if ok:
                self._wave_h["pack_native"].record(
                    time.perf_counter_ns() - t0)
                self.counters.incr("native_pack_batches")
                self.counters.incr("native_pack_msgs",
                                   len(rep_i) + len(aer_i))
                return
            # partial native success is harmless: the Python stores
            # below rewrite the same cells with the same values
            self.counters.incr("native_fallbacks")
        R = self._R
        if rep_i:
            ii = np.asarray(rep_i, np.int64)
            packed[R["msg_type"], ii] = C.MSG_AER_REPLY
            packed[R["sender_slot"], ii] = rep_s
            packed[R["term"], ii] = [m.term for m in rep_m]
            packed[R["success"], ii] = [1 if m.success else 0 for m in rep_m]
            packed[R["reply_next_idx"], ii] = [m.next_index for m in rep_m]
            packed[R["reply_last_idx"], ii] = [m.last_index for m in rep_m]
            packed[R["reply_last_term"], ii] = [m.last_term for m in rep_m]
        if aer_i:
            ii = np.asarray(aer_i, np.int64)
            packed[R["msg_type"], ii] = C.MSG_AER
            packed[R["sender_slot"], ii] = aer_s
            packed[R["term"], ii] = [m.term for m in aer_m]
            packed[R["prev_idx"], ii] = [m.prev_log_index for m in aer_m]
            packed[R["prev_term"], ii] = [m.prev_log_term for m in aer_m]
            packed[R["num_entries"], ii] = [len(m.entries) for m in aer_m]
            packed[R["entries_last_term"], ii] = [
                m.entries[-1].term if m.entries else 0 for m in aer_m
            ]
            packed[R["leader_commit"], ii] = [m.leader_commit for m in aer_m]

    def _fill_scat(self, packed: np.ndarray, app_rows, written) -> None:
        """Write the fused log-tail scatter rows: the newest appended
        run per group and the durable watermarks, pad gid = capacity
        (device scatters drop out-of-range rows)."""
        R = self._R
        packed[R["a_gid"]].fill(self.capacity)
        packed[R["w_gid"]].fill(self.capacity)
        if app_rows:
            ar = np.asarray(app_rows, np.int64)
            n = len(app_rows)
            packed[R["a_gid"], :n] = ar[:, 0]
            packed[R["a_lo"], :n] = ar[:, 1]
            packed[R["a_hi"], :n] = ar[:, 2]
            packed[R["a_term"], :n] = ar[:, 3]
        if written:
            n = len(written)
            packed[R["w_gid"], :n] = np.fromiter(written.keys(), np.int64, n)
            packed[R["w_idx"], :n] = np.fromiter(written.values(), np.int64, n)

    def _mbox_take(self, width: Optional[int] = None) -> np.ndarray:
        """Pop a zeroed pack buffer from the pool (full-width by
        default, or a power-of-two sub-batch ``width``); allocates when
        empty — pool size is bounded by the tickets in flight."""
        if width is None:
            width = self.capacity
            spare = self._spare_mbox
            if spare is not None:
                # double-buffered staging: the spare was pre-zeroed in
                # the pipeline overlap window — no take/zero cost here
                self._spare_mbox = None
                return spare
        pool = self._mbox_pool
        for k, buf in enumerate(pool):
            if buf.shape[1] == width:
                del pool[k]
                buf.fill(0)
                return buf
        return self._dev.mbox_buffer(self._NROWS, width)

    def _mbox_release(self, buf: Optional[np.ndarray]) -> None:
        """Return a pack buffer once its step's egress sync proves the
        device consumed the zero-copy view."""
        if buf is not None and len(self._mbox_pool) < 6:
            self._mbox_pool.append(buf)

    def _build_mailbox(self, app_rows=None, written=None):
        packed = self._mbox_take()
        self._fill_scat(packed, app_rows, written)
        R = self._R
        packed[R["host_term_idx"]].fill(-1)
        packed[R["host_term_val"]].fill(-1)
        consumed: Dict[int, Tuple[Any, Any]] = {}
        hot = self._hot
        self._hot = set()
        groups = self.groups
        # the two hot message types are encoded COLUMNWISE after the pop
        # loop (numpy scalar stores per field per message were a top
        # cost); everything else goes through the scalar _encode
        aer_i: List[int] = []
        aer_m: List[AppendEntriesRpc] = []
        aer_s: List[int] = []
        rep_i: List[int] = []
        rep_m: List[AppendEntriesReply] = []
        rep_s: List[int] = []
        for i in hot:
            g = groups[i]
            if g is None:
                continue
            if g.host_term_hint is not None:
                packed[R["host_term_idx"], i] = g.host_term_hint[0]
                packed[R["host_term_val"], i] = g.host_term_hint[1]
                g.host_term_hint = None
            if not g.inbox:
                continue
            from_sid, msg = g.inbox.popleft()
            consumed[i] = (from_sid, msg)
            t = type(msg)
            if t is AppendEntriesRpc:
                aer_i.append(i)
                aer_m.append(msg)
                aer_s.append(g.slot_of(from_sid) if from_sid else 0)
            elif t is AppendEntriesReply:
                rep_i.append(i)
                rep_m.append(msg)
                rep_s.append(g.slot_of(from_sid) if from_sid else 0)
            else:
                self._encode(g, from_sid, msg, packed, i)
            if g.inbox:
                self._hot.add(i)  # more queued: stay hot for next step
        self._pack_hot(packed, aer_i, aer_m, aer_s, rep_i, rep_m, rep_s)
        return consumed, packed

    def _build_mailbox_sub(self, act, app_rows=None, written=None):
        """Compact mailbox for the active-set step: one COLUMN PER
        ACTIVE GROUP (power-of-two padded), plus the gather index vector
        mapping column -> group id. ``consumed`` is keyed by column
        position (the egress arrays come back in the same position
        space). Same pop-one-message-per-group semantics as the
        full-width builder."""
        n = len(act)
        # pad floor bounds the number of compiled shapes (straggler
        # tails would otherwise walk every power of two down to 1)
        cap = min(256, self.capacity)
        while cap < n:
            cap <<= 1
        packed = self._mbox_take(cap)
        self._fill_scat(packed, app_rows, written)
        R = self._R
        packed[R["host_term_idx"]].fill(-1)
        packed[R["host_term_val"]].fill(-1)
        gidx = np.full(cap, self.capacity, np.int32)  # pads dropped on scatter
        gidx[:n] = act
        self._hot = set()
        consumed: Dict[int, Tuple[Any, Any]] = {}
        groups = self.groups
        aer_i: List[int] = []
        aer_m: List[AppendEntriesRpc] = []
        aer_s: List[int] = []
        rep_i: List[int] = []
        rep_m: List[AppendEntriesReply] = []
        rep_s: List[int] = []
        for p, i in enumerate(act):
            g = groups[i]
            if g is None:
                continue
            if g.host_term_hint is not None:
                packed[R["host_term_idx"], p] = g.host_term_hint[0]
                packed[R["host_term_val"], p] = g.host_term_hint[1]
                g.host_term_hint = None
            if not g.inbox:
                continue
            from_sid, msg = g.inbox.popleft()
            consumed[p] = (from_sid, msg)
            t = type(msg)
            if t is AppendEntriesRpc:
                aer_i.append(p)
                aer_m.append(msg)
                aer_s.append(g.slot_of(from_sid) if from_sid else 0)
            elif t is AppendEntriesReply:
                rep_i.append(p)
                rep_m.append(msg)
                rep_s.append(g.slot_of(from_sid) if from_sid else 0)
            else:
                self._encode(g, from_sid, msg, packed, p)
            if g.inbox:
                self._hot.add(i)  # more queued: stay hot for next step
        self._pack_hot(packed, aer_i, aer_m, aer_s, rep_i, rep_m, rep_s)
        return gidx, np.asarray(act, np.int64), consumed, packed

    def _encode(self, g: GroupHost, from_sid, msg, p, i) -> None:
        R = self._R
        p[R["sender_slot"], i] = g.slot_of(from_sid) if from_sid else 0
        if isinstance(msg, AppendEntriesRpc):
            p[R["msg_type"], i] = C.MSG_AER
            p[R["term"], i] = msg.term
            p[R["prev_idx"], i] = msg.prev_log_index
            p[R["prev_term"], i] = msg.prev_log_term
            p[R["num_entries"], i] = len(msg.entries)
            p[R["entries_last_term"], i] = msg.entries[-1].term if msg.entries else 0
            p[R["leader_commit"], i] = msg.leader_commit
        elif isinstance(msg, AppendEntriesReply):
            p[R["msg_type"], i] = C.MSG_AER_REPLY
            p[R["term"], i] = msg.term
            p[R["success"], i] = 1 if msg.success else 0
            p[R["reply_next_idx"], i] = msg.next_index
            p[R["reply_last_idx"], i] = msg.last_index
            p[R["reply_last_term"], i] = msg.last_term
        elif isinstance(msg, RequestVoteRpc):
            p[R["msg_type"], i] = C.MSG_VOTE_REQ
            p[R["term"], i] = msg.term
            p[R["sender_slot"], i] = g.slot_of(msg.candidate_id)
            p[R["cand_last_idx"], i] = msg.last_log_index
            p[R["cand_last_term"], i] = msg.last_log_term
        elif isinstance(msg, RequestVoteResult):
            p[R["msg_type"], i] = C.MSG_VOTE_REPLY
            p[R["term"], i] = msg.term
            p[R["success"], i] = 1 if msg.vote_granted else 0
        elif isinstance(msg, PreVoteRpc):
            p[R["msg_type"], i] = C.MSG_PREVOTE_REQ
            p[R["term"], i] = msg.term
            p[R["sender_slot"], i] = g.slot_of(msg.candidate_id)
            p[R["cand_last_idx"], i] = msg.last_log_index
            p[R["cand_last_term"], i] = msg.last_log_term
            p[R["cand_machine_version"], i] = msg.machine_version
        elif isinstance(msg, PreVoteResult):
            p[R["msg_type"], i] = C.MSG_PREVOTE_REPLY
            p[R["term"], i] = msg.term
            p[R["success"], i] = 1 if msg.vote_granted else 0
            p[R["token"], i] = msg.token

    # -- egress ------------------------------------------------------------

    def _process_egress(self, eg, consumed, aer_dirty, act=None) -> None:
        """Realise one step's egress. ``act`` is None for the full-width
        step (egress row == group id) or the i64 position->gid map of an
        active-set step (egress row == position in ``act``); ``consumed``
        is keyed in the same space as the egress rows."""
        outbound: Dict[str, List[Tuple[ServerId, Any, ServerId]]] = {}

        def queue_send(to: ServerId, msg: Any, frm: ServerId):
            out = outbound.get(to[1])
            if out is None:
                outbound[to[1]] = out = []
            out.append((to, msg, frm))

        groups = self.groups
        needs_host = eg["needs_host"]
        # numpy scalar indexing (plus int()/bool() coercion) in a
        # per-message loop is slow; gather each needed field for exactly
        # the consumed rows in one vector op, then read python ints
        if consumed:
            items = list(consumed.items())
            ci = np.fromiter((i for i, _ in items), np.int64, len(items))
            nh_l = needs_host[ci].tolist()
            code_l = eg["aer_code"][ci].tolist()
            sr_l = eg["send_reply"][ci].tolist()
            term_l = eg["term"][ci].tolist()
            succ_l = eg["success"][ci].tolist()
            nxt_l = eg["next_index"][ci].tolist()
            li_l = eg["last_index"][ci].tolist()
            lt_l = eg["last_term"][ci].tolist()
            for p, (i, (from_sid, msg)) in enumerate(items):
                g = groups[i if act is None else act[i]]
                if g is None:
                    continue
                t = type(msg)
                if t is AppendEntriesRpc:
                    if nh_l[p]:
                        self._host_resolve_aer(g, from_sid, msg, queue_send)
                    elif code_l[p] == C.AER_OK:
                        # the host performs the write and owns the
                        # durable watermark, so it builds the success
                        # ack (possibly deferred until WAL fsync)
                        self._host_write_entries(g, msg)
                        self._ack_aer(g, from_sid, msg, term_l[p], outbound)
                    elif sr_l[p] and from_sid is not None:
                        queue_send(
                            from_sid,
                            AppendEntriesReply(
                                term_l[p], bool(succ_l[p]), nxt_l[p],
                                li_l[p], lt_l[p],
                            ),
                            (g.name, self.name),
                        )
                elif sr_l[p] and from_sid is not None:
                    if t is RequestVoteRpc:
                        if succ_l[p]:
                            # granting a vote resets the election timer
                            # (Raft §3.4): the granter must give its
                            # candidate a full round before campaigning
                            # itself, or dueling candidacies ping-pong
                            g.last_contact = self.clock.monotonic()
                        queue_send(
                            from_sid,
                            RequestVoteResult(term_l[p], bool(succ_l[p])),
                            (g.name, self.name),
                        )
                    elif t is PreVoteRpc:
                        if succ_l[p]:
                            g.last_contact = self.clock.monotonic()
                        queue_send(
                            from_sid,
                            PreVoteResult(term_l[p], msg.token, bool(succ_l[p])),
                            (g.name, self.name),
                        )

        # vectorized change detection: only touched groups pay Python cost
        n = self.n_groups if act is None else len(act)
        applied = (
            self._applied_np[:n] if act is None else self._applied_np[act]
        )
        interesting = np.flatnonzero(
            eg["became_candidate"][:n]
            | eg["became_leader"][:n]
            | eg["term_or_vote_changed"][:n]
            | (eg["commit_advanced_to"][:n] > applied)
            | needs_host[:n]
        )
        touched = (
            interesting.tolist() if len(consumed) == 0
            else list(set(consumed) | set(interesting.tolist()))
        )
        meta_sync = getattr(self.meta, "sync", None)
        meta_dirty = False
        if touched:
            ti = np.asarray(touched, np.int64)
            role_l = eg["role"][ti].tolist()
            gterm_l = eg["term"][ti].tolist()
            leader_l = eg["leader_slot"][ti].tolist()
            tvc_l = eg["term_or_vote_changed"][ti].tolist()
            voted_l = eg["voted_for"][ti].tolist()
            bc_l = eg["became_candidate"][ti].tolist()
            bl_l = eg["became_leader"][ti].tolist()
            ca_l = eg["commit_advanced_to"][ti].tolist()
            nh2_l = needs_host[ti].tolist()
            ag_l = eg["agreed_idx"][ti].tolist()
            now_roles = self.clock.monotonic()
            for p, pos in enumerate(touched):
                i = pos if act is None else int(act[pos])
                g = groups[i]
                if g is None:
                    continue
                new_role = role_l[p]
                if new_role != g.role:
                    self._obs_rec.record(
                        "role_change", node=self.name, group=g.name,
                        term=gterm_l[p],
                        detail=f"{self._ROLE_NAMES.get(g.role, g.role)}->"
                               f"{self._ROLE_NAMES.get(new_role, new_role)}",
                    )
                    # role transitions restart the leaderless-suspicion
                    # window (a just-deposed leader must give the new
                    # one a chance to make contact before suspecting)
                    g.last_contact = now_roles
                if g.role == C.R_LEADER and new_role != C.R_LEADER:
                    # deposed: in-flight linearizable reads must not be
                    # answered from this replica's state, and pending
                    # command futures must redirect rather than hang
                    # their clients until timeout
                    self._lease_revoke(g, "left leader")
                    for q in g.pending_queries:
                        self._reply(q["fut"], ("redirect", None))
                    g.pending_queries = []
                    g.leader_slot = leader_l[p]  # hint before the sweep
                    self._fail_pending(g)
                g.role = new_role
                g.term = gterm_l[p]
                g.leader_slot = leader_l[p]
                if tvc_l[p] and self.meta is not None:
                    # Raft safety: term AND vote must both be durable
                    # before any message leaves this step, or a
                    # restarted member could vote twice in one term:
                    # stored here, made durable by ONE sync for the
                    # whole pass before its outbound is sent below (a
                    # sync a group is 10240 serial fdatasyncs in one
                    # full-width election)
                    uid = f"{g.cluster_name}_{g.name}"
                    self.meta.store(uid, "current_term", g.term)
                    if meta_sync is None:  # a store with no pass sync
                        self.meta.store_sync(uid, "voted_for",
                                             g.sid_of(voted_l[p]))
                    else:
                        self.meta.store(uid, "voted_for", g.sid_of(voted_l[p]))
                        meta_dirty = True
                if bc_l[p]:
                    self._hot.add(i)  # keep stepping (single-member self-election)
                    self._broadcast_vote_req(g, queue_send, pre=False)
                if bl_l[p]:
                    self._on_became_leader(g, aer_dirty)
                ci2 = ca_l[p]
                if ci2 > g.last_applied:
                    self._apply_group(g, ci2)
                    aer_dirty.add(i)
                if nh2_l[p] and g.host_term_hint is None:
                    # quorum term lookup outside the device window (the
                    # AER branch may already have claimed the hint slot;
                    # that one retries first and the quorum resolves
                    # next step)
                    agreed = ag_l[p]
                    t2 = g.log.fetch_term(agreed)
                    if t2 is not None:
                        g.host_term_hint = (agreed, t2)
                        self._hot.add(i)

        if meta_dirty:
            meta_sync()
        for node_name, msgs in outbound.items():
            self._send_batch(node_name, msgs)

    def _host_resolve_aer(self, g: GroupHost, from_sid, msg: AppendEntriesRpc, queue_send):
        """Deep backfill: resolve the prev term from the host log and
        re-enqueue with an override (or reject directly when absent)."""
        t = g.log.fetch_term(msg.prev_log_index)
        if t is None:
            li, lt = g.log.last_index_term()
            snap = g.log.snapshot_index_term()
            from ra_tpu_torch.ops import decisions as dec

            nid = dec.aer_failure_next_index(
                g.last_applied, li, msg.prev_log_index, snap[0] if snap else 0
            )
            queue_send(
                from_sid,
                AppendEntriesReply(g.term, False, nid, li, lt),
                (g.name, self.name),
            )
            return
        g.host_term_hint = (msg.prev_log_index, t)
        g.inbox.appendleft((from_sid, msg))  # retry next step with override
        self._hot.add(g.gid)

    def _host_write_entries(self, g: GroupHost, msg: AppendEntriesRpc) -> None:
        if not msg.entries:
            return
        li, _ = g.log.last_index_term()
        if msg.entries[0].index == li + 1:
            # fast path (steady-state pipeline): strictly-new suffix
            to_write = msg.entries
        else:
            to_write = []
            for e in msg.entries:
                if e.index <= li and g.log.fetch_term(e.index) == e.term:
                    continue
                to_write = [x for x in msg.entries if x.index >= e.index]
                break
            if not to_write and msg.entries[-1].index > li:
                to_write = [e for e in msg.entries if e.index > li]
        if to_write:
            first_idx = to_write[0].index
            if first_idx <= li:
                # overwriting a divergent suffix: truncated specials are
                # gone, and any cluster adoption that rode on them must
                # be rolled back. The ack-suppression key is also
                # invalidated — its (sid, term, ack) invariant only
                # holds while acked entries are never truncated
                g.last_ok_sent = None
                # pending futures for truncated indexes are provably
                # dead (the entries are being overwritten): redirect
                # their clients to the new leader now — a clean
                # "redirect" verdict, safe to retry exactly-once
                self._fail_pending(g, from_idx=first_idx, verdict="redirect")
                if g.specials and g.specials[-1] >= first_idx:
                    g.specials = [s for s in g.specials if s < first_idx]
                if g.cluster_history:
                    keep = [h for h in g.cluster_history if h[0] < first_idx]
                    undone = [h for h in g.cluster_history if h[0] >= first_idx]
                    if undone:
                        _, members, voter = undone[0]
                        g.members = list(members)
                        g.voter_status = dict(voter)
                        g.cluster_history = keep
                        self._sync_member_rows(g)
            g.log.write(to_write)
            # followers adopt replicated cluster changes at write time
            # (reference: cluster scan on follower writes,
            # src/ra_server.erl:1005-1040) and index every non-USR
            # entry for the apply fast path. A leader-stamped plain_usr
            # batch skips the scan (the hot pipeline shape).
            if not msg.plain_usr:
                specials = g.specials
                for e in to_write:
                    c = e.cmd
                    if type(c) is not Command:
                        specials.append(e.index)
                        continue
                    k = c.kind
                    if k != USR:
                        specials.append(e.index)
                        if k in (RA_JOIN, RA_LEAVE, RA_CLUSTER_CHANGE):
                            self._adopt_cluster_cmd(g, c, e.index)
            # reconcile the device term ring exactly (clears the
            # multi-entry unknown interval next step). Raft log terms
            # are monotonic, so equal first/last terms mean ONE run —
            # the per-entry split loop only runs for term-crossing
            # batches (rare: a new leader resending mixed history)
            first = to_write[0]
            last = to_write[-1]
            if first.term == last.term:
                self._stage_app(g.gid, first.index, last.index, first.term)
            else:
                lo = prev = first.index
                term = first.term
                for e in to_write[1:]:
                    if e.term != term:
                        self._stage_app(g.gid, lo, prev, term)
                        lo, term = e.index, e.term
                    prev = e.index
                self._stage_app(g.gid, lo, prev, term)
            wi, _ = g.log.last_written()
            if wi >= to_write[-1].index:
                self._stage_written(g.gid, wi)

    def _ack_aer(self, g: GroupHost, from_sid, msg: AppendEntriesRpc, term, outbound):
        """Success ack with the host's durable watermark, anchored to
        what THIS AER covered (a shorter-logged new leader must not see
        acks above its own prev — mirrors the scalar backend); deferred
        until the WAL confirms when the write is still in flight.
        Appends into the caller's per-destination ``outbound`` map (hot
        path: one ack per follower group per step)."""
        last_entry = msg.entries[-1].index if msg.entries else msg.prev_log_index
        wi, wt = g.log.last_written()
        if wi >= last_entry:
            ack = min(wi, last_entry)
            prev = g.last_ok_sent
            now = self.clock.monotonic()
            if (
                prev is not None
                and prev[0] == from_sid
                and prev[1] == term
                and prev[2] == ack
                and now - prev[3] < self.tick_interval_s
            ):
                return  # identical ack just sent: nothing new for the leader
            g.last_ok_sent = (from_sid, term, ack, now)
            # steady state acks exactly at the watermark: reuse its term
            at = wt if ack == wi else g.log.fetch_term(ack)
            out = outbound.get(from_sid[1])
            if out is None:
                outbound[from_sid[1]] = out = []
            out.append((
                from_sid,
                AppendEntriesReply(term, True, ack + 1, ack,
                                   at if at is not None else wt),
                (g.name, self.name),
            ))
        else:
            g.pending_ack = (from_sid, last_entry)

    def _on_became_leader(self, g: GroupHost, aer_dirty) -> None:
        if self.lease_cfg.enabled:
            # fresh leadership starts bare: the lease is earned by this
            # term's own acks, never inherited from stale stamps
            gid = g.gid
            self._lease_expiry[gid] = 0.0
            self._lease_sent[gid, :] = 0.0
            self._lease_basis[gid, :] = 0.0
            self._lease_renew_t[gid] = 0.0
            self._lease_dirty.discard(gid)
        li, _ = g.log.last_index_term()
        g.next_index = [li + 1] * len(g.members)
        g.commit_sent = [0] * len(g.members)
        g.match_hint = [0] * len(g.members)
        g.last_ack = {}
        g.leader_slot = g.self_slot
        leaderboard.record(g.cluster_name, (g.name, self.name), tuple(g.members))
        # the new term's noop (commit gate + version carrier)
        idx = g.log.next_index()
        g.log.append(Entry(index=idx, term=g.term, cmd=Command(kind=NOOP)))
        g.specials.append(idx)
        g.noop_index = idx
        g.noop_committed = False
        g.cluster_change_permitted = False
        self._stage_app(g.gid, idx, idx, g.term)
        wi, _ = g.log.last_written()
        if wi >= idx:
            self._stage_written(g.gid, wi)
        aer_dirty.add(g.gid)

    def _apply_group(self, g: GroupHost, commit_index: int) -> None:
        li, _ = g.log.last_index_term()
        hi = min(commit_index, li)
        if hi <= g.last_applied:
            return
        # apply-duration histogram is SAMPLED (same mask as the commit
        # stages): at 10k groups per wave an unconditional record per
        # group is a measurable tax on the loop it measures
        _t_apply0 = (
            time.perf_counter_ns() if (g.gid & self._lat_mask) == 0 else 0
        )
        # commit-stage sample: the tracked entry commits (and applies)
        # in THIS call iff it is durable and within hi; ``lat`` stays a
        # local None otherwise so the hot loop pays one check per entry
        lat = g.lat
        if lat is not None:
            if lat[3] == 0 or lat[0] > hi:
                lat = None  # not durable yet / commits in a later round
            elif lat[4] == 0:
                lat[4] = time.monotonic_ns()
                self._commit_h["durable_commit"].record(lat[4] - lat[3])
        # hot loop: locals bound once, apply-result normalization inlined
        # (machines return (state, reply) or (state, reply, effects))
        entries = g.log.fetch_range(g.last_applied + 1, hi)
        if len(entries) != hi - g.last_applied:
            # fail fast like fold(): a gap below the commit index is a
            # log integrity violation, never something to skip silently
            raise KeyError(
                f"missing log entries applying ({g.last_applied}, {hi}] "
                f"in group {g.name}: got {len(entries)}"
            )
        pending = g.pending_replies
        machine = g.machine
        mver = g.effective_machine_version
        state = g.machine_state
        is_leader = g.role == C.R_LEADER
        specials = g.specials
        if specials and specials[0] <= g.last_applied:
            # stale entries (already applied or compacted away)
            g.specials = specials = [s for s in specials if s > g.last_applied]
        if (
            not pending
            and len(entries) > 1
            and (not specials or specials[0] > hi)
        ):
            # plain user-command run with no replies owed (the specials
            # index proves it without scanning): offer the machine the
            # whole payload batch at once (apply_many hook)
            batched = machine.which_module(mver).apply_many(
                {"index": hi, "term": entries[-1].term,
                 "machine_version": mver},
                [e.cmd.data for e in entries], state,
            )
            if batched is not None:
                g.machine_state = batched
                g.last_applied = hi
                self._applied_np[g.gid] = hi
                if self.lease_cfg.enabled:
                    self._lease_applied(g, hi)
                if lat is not None:
                    # noreply pipeline shape: the reply stage is the
                    # post-apply bookkeeping fan-out (no future owed)
                    now2 = time.monotonic_ns()
                    self._commit_h["commit_apply"].record(now2 - lat[4])
                    self._commit_gates(g, hi, is_leader)
                    self._commit_h["apply_reply"].record(
                        time.monotonic_ns() - now2
                    )
                    g.lat = None
                    self._lat_gids.discard(g.gid)
                else:
                    self._commit_gates(g, hi, is_leader)
                if _t_apply0:
                    self._wave_h["apply"].record(
                        time.perf_counter_ns() - _t_apply0
                    )
                return
        mac = machine.which_module(mver)
        apply_fn = mac.apply
        me = (g.name, self.name)
        for entry in entries:
            cmd = entry.cmd
            if not isinstance(cmd, Command):
                continue
            kind = cmd.kind
            if kind == USR:
                res = apply_fn(
                    {"index": entry.index, "term": entry.term,
                     "machine_version": mver},
                    cmd.data, state,
                )
                state = res[0]
                if len(res) > 2 and res[2]:
                    g.machine_state = state  # effects may read/snapshot it
                    self._realise_effects(g, res[2], is_leader)
                if lat is not None and entry.index == lat[0]:
                    t_ap = time.monotonic_ns()
                    self._commit_h["commit_apply"].record(t_ap - lat[4])
                    if pending:
                        fut = pending.pop(entry.index, None)
                        if fut is not None and is_leader:
                            self._reply(fut, ("ok", res[1], me))
                    self._commit_h["apply_reply"].record(
                        time.monotonic_ns() - t_ap
                    )
                    g.lat = lat = None
                    self._lat_gids.discard(g.gid)
                    continue
                if pending:
                    fut = pending.pop(entry.index, None)
                    if fut is not None and is_leader:
                        self._reply(fut, ("ok", res[1], me))
                continue
            if kind == NOOP:
                if cmd.machine_version > g.effective_machine_version:
                    # machine-version bump rides the term noop
                    # (reference: src/ra_server.erl:3357-3417)
                    old_v = g.effective_machine_version
                    g.effective_machine_version = mver = cmd.machine_version
                    mac = machine.which_module(mver)
                    apply_fn = mac.apply
                    res = apply_fn(
                        {"index": entry.index, "term": entry.term,
                         "machine_version": mver},
                        ("machine_version", old_v, mver), state,
                    )
                    state = res[0]
                if is_leader and entry.index >= g.noop_index:
                    # the new leader's own entry committed: unlock
                    # membership changes and linearizable reads
                    g.noop_committed = True
                    if entry.index >= g.cluster_index:
                        g.cluster_change_permitted = True
            elif kind in (RA_JOIN, RA_LEAVE, RA_CLUSTER_CHANGE):
                if entry.index >= g.cluster_index:
                    # change committed: the next one may proceed
                    g.cluster_change_permitted = is_leader and g.noop_committed
            if pending and is_leader:
                fut = pending.pop(entry.index, None)
                if fut is not None:
                    self._reply(fut, ("ok", None, me))
        g.machine_state = state
        g.last_applied = hi
        self._applied_np[g.gid] = hi
        if self.lease_cfg.enabled:
            self._lease_applied(g, hi)
        if lat is not None:
            # tracked entry was non-USR (rare): close the sample here
            now2 = time.monotonic_ns()
            self._commit_h["commit_apply"].record(now2 - lat[4])
            self._commit_h["apply_reply"].record(time.monotonic_ns() - now2)
            g.lat = None
            self._lat_gids.discard(g.gid)
        if _t_apply0:
            self._wave_h["apply"].record(time.perf_counter_ns() - _t_apply0)

    def _commit_gates(self, g: GroupHost, hi: int, is_leader: bool) -> None:
        """Noop-commit gate for apply paths that skip the per-entry loop
        (cluster entries always force the per-entry path, so reaching
        ``hi >= noop_index`` here means the noop itself committed)."""
        if is_leader and not g.noop_committed and hi >= g.noop_index:
            g.noop_committed = True
            if g.cluster_index <= hi:
                g.cluster_change_permitted = True

    # -- machine effects (batch-backend executor; reference vocabulary:
    # src/ra_machine.erl:131-159, realised per src/ra_server_proc.erl
    # handle_effects) -----------------------------------------------------

    def _realise_effects(self, g: GroupHost, effs, is_leader: bool = True) -> None:
        """Machine effects. Log effects (release_cursor / checkpoint)
        are realised on EVERY replica — followers must truncate too;
        the rest (send_msg, mod_call, timer, log read, reply, aux) are
        leader-only on the apply path. Monitor/demonitor effects need
        the actor runtime's monitor registry — groups using them should
        run on the per_group_actor backend."""
        for eff in effs:
            if not is_leader and not isinstance(
                eff, (fx.ReleaseCursor, fx.Checkpoint, fx.TryAppend)
            ):
                continue
            if isinstance(eff, fx.ReleaseCursor):
                mac = g.machine.which_module(g.effective_machine_version)
                if self._release_cursor_async(g, eff, mac):
                    continue
                g.log.update_release_cursor(
                    eff.index,
                    tuple(m for m in g.members if m is not None),
                    g.effective_machine_version,
                    eff.machine_state,
                    live_indexes=tuple(mac.live_indexes(eff.machine_state)),
                )
                self._sync_snapshot_floor(g)
            elif isinstance(eff, fx.Checkpoint):
                mac = g.machine.which_module(g.effective_machine_version)
                g.log.checkpoint(
                    eff.index,
                    tuple(m for m in g.members if m is not None),
                    g.effective_machine_version,
                    eff.machine_state,
                    live_indexes=tuple(mac.live_indexes(eff.machine_state)),
                )
            elif isinstance(eff, fx.SendMsg):
                cb = self.send_msg_cb
                if cb is not None:
                    try:
                        cb(eff.to, eff.msg, eff.options)
                    except Exception:  # noqa: BLE001
                        pass
                elif callable(getattr(eff.to, "set_result", None)) or callable(eff.to):
                    self._reply(eff.to, eff.msg)
                elif isinstance(eff.to, tuple) and len(eff.to) == 2:
                    self.transport.send(eff.to, eff.msg, from_sid=(g.name, self.name))
            elif isinstance(eff, fx.ModCall):
                try:
                    eff.fn(*eff.args)
                except Exception:  # noqa: BLE001
                    pass
            elif isinstance(eff, fx.Timer):
                self._machine_timer(g, eff)
            elif isinstance(eff, fx.LogRead):
                entries = g.log.sparse_read(list(eff.indexes))
                out = eff.fn(entries)
                if out is not None:
                    # apply runs on a drainer thread under the state
                    # lock: self-deliveries ride the internal queue
                    # straight into the next drain (never the rings —
                    # a full lane must not block the drainer on itself)
                    self._deliver_internal(g.name, out)
            elif isinstance(eff, fx.Reply):
                self._reply(eff.from_ref, eff.reply)
            elif isinstance(eff, fx.Aux):
                self._deliver_internal(g.name, ("aux", "cast", eff.cmd, None))
            elif isinstance(eff, (fx.Append, fx.TryAppend)):
                # machine-originated command re-enters via the command
                # queue: the next step's drain appends it on the leader;
                # a TryAppend on a non-leader redirects per command
                # routing (reference: src/ra_server_proc.erl:1604-1615).
                # Only the leader's copy carries the reply ref — every
                # replica realises a TryAppend, and a follower's
                # redirect must not race the leader's ok on one future
                self._deliver_internal(
                    g.name,
                    Command(kind=USR, data=eff.cmd,
                            reply_mode=eff.reply_mode,
                            from_ref=eff.from_ref if is_leader else None,
                            internal=True),
                )

    def _sync_snapshot_floor(self, g: GroupHost) -> None:
        snap = g.log.snapshot_index_term()
        if snap is not None and snap[0] > g.snap_floor:
            g.snap_floor = snap[0]
            self.state = self._dev.record_snapshot(
                self.state, [g.gid], [snap[0]], [snap[1]]
            )

    def _flush_install_rows(self) -> None:
        """Write a rare-message pass's snapshot installs to the device:
        the floors, then the terms, then leader and role, each one
        scatter for the pass (rows of different groups, each written in
        an install's own order), and close the pass. A failed write is
        dropped as the rare loop drops a crashed message: the step
        thread lives on."""
        rows, self._install_rows = self._install_rows, None
        if not rows:
            return
        gids = list(rows)
        idx, term, cur, slot = (list(v) for v in zip(*rows.values()))
        dev = self._dev
        try:
            self.state = dev.record_snapshot(self.state, gids, idx, term)
            self.state = dev.max_rows(self.state, gids, current_term=cur)
            self.state = dev.set_rows(self.state, gids, leader_slot=slot,
                                      role=C.R_FOLLOWER)
        except Exception:  # noqa: BLE001
            logger.exception(
                "coordinator %s: dropping the device rows of %d snapshot "
                "installs after a crash", self.name, len(gids))

    # -- release-cursor snapshots off the apply path ---------------------

    SNAPSHOT_WRITERS = 4  # writer threads a coordinator
    SNAPSHOT_WRITE_BATCH = 64  # snapshots a writer posts under one lock
    SNAPSHOT_SENDERS = 32  # transfers streaming at once, a coordinator

    def _release_cursor_async(self, g: GroupHost, eff, mac) -> bool:
        """Hand a release cursor's snapshot of a WAL-backed log to the
        writer threads; False (the caller snapshots inline) for other
        logs and once stop() has begun. The snapshot is due as in
        ``Log.update_release_cursor``, counted from the newest one
        handed out; the state is copied here, so later applies cannot
        change what is written. A writer writes it, then under the
        state lock sets the device's floor and the host's and compacts
        the log (``_snapshots_written``)."""
        log = g.log
        if not isinstance(log, Log):
            return False
        with self._snap_cv:
            if self._snap_closed:
                return False
            snap = log.snapshot_index_term()
            cur = max(snap[0] if snap else 0, self._snap_due.get(g.gid, 0))
            idx = eff.index
            if idx <= cur or idx - cur < log.min_snapshot_interval:
                return True
            term = log.fetch_term(idx)
            if term is None:
                return True
            meta = SnapshotMeta(
                index=idx, term=term,
                cluster=tuple(m for m in g.members if m is not None),
                machine_version=g.effective_machine_version,
                live_indexes=tuple(i for i in mac.live_indexes(
                    eff.machine_state) if i <= idx),
            )
            state = pickle.loads(pickle.dumps(eff.machine_state,
                                              pickle.HIGHEST_PROTOCOL))
            self._snap_due[g.gid] = idx
            self._snap_jobs[g.gid] = (g, meta, state)  # newest replaces
            if not self._snap_writers:
                for i in range(self.SNAPSHOT_WRITERS):
                    t = threading.Thread(
                        target=self._snapshot_writer, daemon=True,
                        name=f"ra-snap-write-{self.name}-{i}")
                    t.start()
                    self._snap_writers.append(t)
            self._snap_cv.notify()
        return True

    def _snapshot_writer(self) -> None:
        """A writer thread: takes up to ``SNAPSHOT_WRITE_BATCH`` groups
        no other writer holds, writes their snapshots outside every
        lock, then posts them under the state lock. After stop() it
        writes what was handed out, then ends."""
        cv = self._snap_cv
        while True:
            with cv:
                while True:
                    batch = []
                    for gid, job in self._snap_jobs.items():
                        if gid not in self._snap_busy:
                            batch.append(job)
                            if len(batch) == self.SNAPSHOT_WRITE_BATCH:
                                break
                    if batch:
                        break
                    if self._snap_closed and not self._snap_jobs:
                        return
                    cv.wait()
                for g, _meta, _state in batch:
                    del self._snap_jobs[g.gid]
                    self._snap_busy.add(g.gid)
            done = []
            for g, meta, state in batch:
                try:
                    g.log.snapshots.write(meta, state, kind=SNAPSHOT)
                    done.append((g, meta))
                except Exception:  # noqa: BLE001
                    # as a failed inline write: no snapshot, the log
                    # stays whole, the next release cursor tries again
                    logger.exception(
                        "coordinator %s: snapshot of group %s at %d failed",
                        self.name, g.name, meta.index)
            with self._state_lock:
                self._snapshots_written(done)
            with cv:
                for g, _meta, _state in batch:
                    self._snap_busy.discard(g.gid)
                    if g.gid not in self._snap_jobs:
                        self._snap_due.pop(g.gid, None)
                cv.notify_all()

    def _snapshots_written(self, done) -> None:
        """Post written snapshots (under the state lock): the device's
        floors in one ``record_snapshot``, then each log's snapshot and
        compaction, so a reader that sees the log's snapshot sees the
        device's floor. A snapshot an install has overtaken, or of a
        group no longer here, is not posted."""
        posted = []
        for g, meta in done:
            snap = g.log.snapshot_index_term()
            if self.groups[g.gid] is g and (snap is None
                                            or meta.index > snap[0]):
                posted.append((g, meta))
        rows = [(g.gid, m.index, m.term) for g, m in posted
                if m.index > g.snap_floor]
        if rows:
            gids, idx, term = (list(v) for v in zip(*rows))
            self.state = self._dev.record_snapshot(self.state, gids, idx,
                                                   term)
        for g, meta in posted:
            g.snap_floor = max(g.snap_floor, meta.index)
            g.log._post_snapshot(meta)

    def _machine_timer(self, g: GroupHost, eff: fx.Timer) -> None:
        old = g.machine_timers.pop(eff.name, None)
        if old is not None:
            old.cancel()
        if eff.ms is None:
            return

        def fire():
            g.machine_timers.pop(eff.name, None)
            if self.running and g.role == C.R_LEADER:
                self.deliver(
                    (g.name, self.name),
                    Command(kind=USR, data=("timeout", eff.name),
                            internal=True),
                    None,
                )

        t = threading.Timer(eff.ms / 1000.0, fire)
        t.daemon = True
        t.start()
        g.machine_timers[eff.name] = t

    def _fail_pending(self, g: GroupHost, counter: str = "pending_redirected",
                      from_idx: int = 0, verdict: str = "maybe") -> None:
        """Answer pending await_consensus futures instead of silently
        dropping them (root cause of the round-5 command wedge: a leader
        deposed between append and commit popped its pending futures on
        apply without replying, hanging every waiting client for its
        full timeout).

        The verdict matters for exactly-once semantics:
        - ``"redirect"`` — the entry is provably DEAD (truncated away):
          clients may retry with no duplicate risk;
        - ``"maybe"`` (default) — deposed with the entry still in the
          log: it MAY commit under the new leader. process_command
          surfaces this as an immediate error unless the caller opted
          into at-least-once retries — a transparent retry here is how
          the overload harness caught a double-applied incr.

        ``from_idx`` limits the sweep to truncated indexes; 0 fails
        all."""
        pending = g.pending_replies
        if not pending:
            return
        leader = g.sid_of(g.leader_slot)
        if leader == (g.name, self.name):
            leader = None  # never redirect a caller back to ourselves
        doomed = (
            list(pending) if from_idx <= 0
            else [i for i in pending if i >= from_idx]
        )
        for i in doomed:
            self._reply(pending.pop(i), (verdict, leader))
        if doomed:
            self.counters.incr(counter, len(doomed))
            self._obs_rec.record(
                "deposition", node=self.name, group=g.name, term=g.term,
                detail=f"{len(doomed)} pending futures answered "
                       f"{verdict!r} ({counter})",
            )

    # -- outbound ----------------------------------------------------------

    def _reply(self, fut, value) -> None:
        setter = getattr(fut, "set_result", None)
        if setter is not None:
            setter(value)
        elif callable(fut):
            fut(value)

    def _send_batch(self, node_name: str, msgs) -> None:
        """Per-destination batch send. With the started pipelined loop,
        the fan-out hands off to the dedicated sender thread through a
        bounded ring — the step/egress/WAL threads never pay transport
        cost; a full handoff ring falls back to an inline send (bounded
        handoff never drops)."""
        if self._egress_on:
            if self._egress_rings.publish((node_name, msgs)):
                return
            self.counters.incr("egress_thread_ring_full")
        self._send_batch_inline(node_name, msgs)

    def _send_batch_inline(self, node_name: str, msgs) -> None:
        node = self.registry.get(node_name)
        if node is None:
            return
        if isinstance(node, BatchCoordinator) and node is not self:
            # one hop for the whole batch; honor the same fault-injection
            # and liveness rules as InProcTransport.send
            if not node.running or (self.name, node_name) in self.transport.blocked:
                self.transport.dropped += len(msgs)
                return
            drop = self.transport.drop_fn
            if drop is None:
                triples = [(to[0], frm, msg) for to, msg, frm in msgs]
            else:
                triples = []
                for to, msg, frm in msgs:
                    if drop(to, msg):
                        self.transport.dropped += 1
                    else:
                        triples.append((to[0], frm, msg))
            if triples:
                # peer's ingress lane full: the peer sheds only the
                # lossy subset (counted here) and overflow-queues the
                # must-deliver remainder — never a batch-level drop
                self.transport.dropped += node.ingest_batch(triples)
            return
        if self._nat_egress and len(msgs) > 1:
            # remote batch: seal + length-frame every AER/ack frame for
            # this destination in ONE GIL-released native call on the
            # sender path (rt_seal_frames). -1 = native unavailable or
            # tcp failpoints armed: fall through to per-message send so
            # fire/mangle semantics apply frame by frame.
            sb = getattr(self.transport, "send_batch", None)
            if sb is not None:
                sent = sb(node_name, msgs)
                if sent >= 0:
                    self.counters.incr("native_egress_batches")
                    self.counters.incr("native_egress_frames", sent)
                    return
                self.counters.incr("native_fallbacks")
        for to, msg, frm in msgs:
            self.transport.send(to, msg, from_sid=frm)

    # -- leases (docs/INTERNALS.md §20) ------------------------------------

    def _lease_sync(self, g: GroupHost) -> None:
        """Mirror the group's voter set into the lease arrays. Runs at
        registration and on every membership scatter; a membership
        change while leading revokes (the old lease quorum may not
        intersect the new vote quorum)."""
        voting = np.zeros(self.P, dtype=bool)
        for i, m in enumerate(g.members):
            if m is not None and g.voter_status.get(i) == "voter":
                voting[i] = True
        self._lease_voters[g.gid] = voting
        self._lease_quorum[g.gid] = int(voting.sum()) // 2 + 1
        self._lease_self[g.gid] = g.self_slot

    def _lease_stamp_send(self, gid: int, slot: int, now: float) -> None:
        """Oldest-outstanding-send stamp for one peer slot (later sends
        before an ack keep the older, more conservative stamp)."""
        if self._lease_sent[gid, slot] == 0.0:
            self._lease_sent[gid, slot] = now

    def _lease_credit(self, g: GroupHost, slot: int) -> None:
        """Fold a same-term response from ``slot`` into its ack basis
        (send-basis rule — never the receive time)."""
        gid = g.gid
        t0 = self._lease_sent[gid, slot]
        if t0 == 0.0:
            return
        self._lease_sent[gid, slot] = 0.0
        if t0 > self._lease_basis[gid, slot]:
            self._lease_basis[gid, slot] = t0
            self._lease_dirty.add(gid)

    def _lease_refresh(self) -> None:
        """Recompute expiries for groups with newly credited bases: one
        vectorized k-th-largest pass over the dirty set (the (G,)-array
        analog of LeaseTracker.refresh). Expiry only ever advances."""
        d = self._lease_dirty
        if not d:
            return
        from ra_tpu_torch.lease import lease_expiry, quorum_bases

        gids = np.fromiter(d, np.int64, len(d))
        d.clear()
        now = self.clock.monotonic()
        bases = self._lease_basis[gids].copy()
        # the leader's own slot always counts as an ack at ``now``
        bases[np.arange(len(gids)), self._lease_self[gids]] = now
        qb = quorum_bases(bases, self._lease_voters[gids],
                          self._lease_quorum[gids])
        cfg = self.lease_cfg
        exp = np.where(qb > 0.0, lease_expiry(
            qb, cfg.election_timeout_s, cfg.safety_factor,
            cfg.drift_epsilon_s), 0.0)
        cur = self._lease_expiry[gids]
        fresh = (exp > now) & (cur <= now) & (exp > cur)
        self._lease_expiry[gids] = np.maximum(cur, exp)
        if fresh.any():
            for gid in gids[fresh].tolist():
                g = self.groups[gid]
                if g is not None:
                    self._obs_rec.record(
                        "lease_acquired", node=self.name, group=g.name,
                        term=g.term,
                        detail=f"expires in "
                               f"{self._lease_expiry[gid] - now:.3f}s",
                    )

    def _lease_revoke(self, g: GroupHost, why: str) -> None:
        """Eager revocation: clears the expiry AND the stamp/basis rows
        so acks already in flight cannot resurrect a lease for a
        leadership this group no longer holds."""
        if not self.lease_cfg.enabled:
            return
        gid = g.gid
        had = self._lease_expiry[gid] > self.clock.monotonic()
        self._lease_expiry[gid] = 0.0
        self._lease_sent[gid, :] = 0.0
        self._lease_basis[gid, :] = 0.0
        self._lease_dirty.discard(gid)
        if had:
            self.counters.incr("read_lease_revocations")
            self._obs_rec.record(
                "lease_lost", node=self.name, group=g.name, term=g.term,
                detail=why,
            )

    def _stickiness_lapsed(self, g: GroupHost, now: float) -> bool:
        """False while this replica's promise to its current leader
        still stands: (pre-)votes for OTHER candidates are disregarded
        for one election timeout after the last leader contact."""
        if g.role == C.R_LEADER:
            return False
        if g.leader_slot < 0:
            return True
        return now - g.lease_contact >= self.election_timeout_s

    def _read_staleness(self, g: GroupHost) -> float:
        """Upper bound on this replica's staleness vs the leader's
        wall clock (inf until a leader stamp has been applied)."""
        if g.fresh_ts <= 0.0:
            return float("inf")
        return max(0.0, self.clock.time() - g.fresh_ts) \
            + self.lease_cfg.drift_epsilon_s

    def _staleness_hist(self):
        if self._stale_h is None:
            from ra_tpu_torch import obs as _obs

            self._stale_h = _obs.staleness_hist(self.name)
        return self._stale_h

    def _lease_applied(self, g: GroupHost, hi: int) -> None:
        """Freshness-floor upkeep after apply reached ``hi``: leaders
        stamp their own wall clock once fully caught up; followers
        promote a pending (leader_commit, commit_ts) anchor whose
        commit point is now applied."""
        if g.role == C.R_LEADER:
            # host mirror: applied == committed, so the leader is
            # always fully caught up here
            g.fresh_ts = self.clock.time()
            return
        anchor_idx, anchor_ts = g.fresh_anchor
        if anchor_ts > 0.0 and anchor_idx <= hi:
            if anchor_ts > g.fresh_ts:
                g.fresh_ts = anchor_ts
            g.fresh_anchor = (0, 0.0)

    def _broadcast_vote_req(self, g: GroupHost, queue_send, pre: bool,
                            force: bool = False) -> None:
        li, lt = g.log.last_index_term()
        sid = (g.name, self.name)
        if pre:
            rpc = PreVoteRpc(
                term=g.term, token=g.pre_vote_token, candidate_id=sid, version=1,
                machine_version=g.machine.version(), last_log_index=li,
                last_log_term=lt,
            )
        else:
            rpc = RequestVoteRpc(
                term=g.term, candidate_id=sid, last_log_index=li,
                last_log_term=lt, force=force,
            )
        for s, member in enumerate(g.members):
            if s != g.self_slot and member is not None:
                queue_send(member, rpc, sid)

    _NEEDS_SNAPSHOT = object()  # rpc-cache sentinel

    def _send_aers(self, aer_dirty) -> None:
        outbound: Dict[str, List] = {}
        now = self.clock.monotonic()
        for gid in aer_dirty:
            g = self.groups[gid]
            if g is None:
                continue
            ft = g.fresh_tail  # valid for THIS step only, whoever we are
            g.fresh_tail = None
            if g.role != C.R_LEADER:
                continue
            li, _ = g.log.last_index_term()
            commit = g.last_applied  # host mirror of commit (applied == committed here)
            sid = (g.name, self.name)
            # lease (§20): every AER is a quorum-bearing send — stamp
            # the oldest outstanding send per peer, and carry the wall
            # clock the commit point was current at (follower
            # freshness). 0.0 when lease-off: receivers then never
            # advance their freshness floor.
            lease_on = self.lease_cfg.enabled
            cts = self.clock.time() if lease_on else 0.0
            # peers at the same next_index (the steady-state pipeline)
            # share ONE immutable rpc: one entry fetch, one object
            rpc_cache: Dict[int, Any] = {}
            for s, member in enumerate(g.members):
                if s == g.self_slot or member is None:
                    continue
                nxt = g.next_index[s]
                if nxt > li and commit <= g.commit_sent[s]:
                    continue  # nothing new to say
                if nxt <= li:
                    # per-peer pipeline window: never run more than
                    # max_pipeline_count entries ahead of the peer's
                    # CONFIRMED match (reference: Next - Match <=
                    # ?MAX_PIPELINE_COUNT, src/ra_server.erl:2308-2329).
                    # An actively-acking peer reopens the window by
                    # itself; a silent one gets an EMPTY probe at the
                    # current next point (the actor backend's
                    # empty-probe shape): its success ack rebuilds
                    # match_hint at the peer's true tail, its reject
                    # hint rewinds next_index — either resynchronizes
                    # without blindly re-sending the whole log (a fresh
                    # leader starts at match_hint 0, so a rewind-to-
                    # match here would re-replicate or snapshot-stream
                    # to every caught-up peer).
                    mh = g.match_hint[s] if s < len(g.match_hint) else 0
                    if nxt - mh > self.max_pipeline_count:
                        la = g.last_ack.get(s)
                        if la is not None and now - la <= self.tick_interval_s:
                            continue  # window full but acks are flowing
                        g.last_ack[s] = now  # one probe per tick per peer
                        self.counters.incr("stale_peer_resends")
                        prev_idx = nxt - 1
                        prev_term = g.log.fetch_term(prev_idx)
                        snap = g.log.snapshot_index_term()
                        if prev_term is None or (
                            snap is not None and prev_idx < snap[0]
                        ):
                            self._start_snapshot_sender(g, member)
                            continue
                        if lease_on:
                            self._lease_stamp_send(gid, s, now)
                        outbound.setdefault(member[1], []).append((
                            member,
                            AppendEntriesRpc(
                                term=g.term, leader_id=sid,
                                prev_log_index=prev_idx,
                                prev_log_term=prev_term,
                                leader_commit=commit, entries=(),
                                commit_ts=cts,
                            ),
                            sid,
                        ))
                        g.commit_sent[s] = commit
                        continue
                rpc = rpc_cache.get(nxt)
                if rpc is None and ft is not None and nxt >= ft[0]:
                    # steady state: the entries were appended by THIS
                    # step's _handle_commands — ship them straight
                    # through (no log re-read; all plain USR, one term)
                    first_f, prev_f, term_f, ents_f = ft
                    k = nxt - first_f
                    if k < len(ents_f):
                        rpc = AppendEntriesRpc(
                            term=g.term, leader_id=sid, prev_log_index=nxt - 1,
                            prev_log_term=prev_f if k == 0 else term_f,
                            leader_commit=commit,
                            entries=tuple(ents_f[k:k + self.aer_batch_size]),
                            plain_usr=True, commit_ts=cts,
                        )
                        rpc_cache[nxt] = rpc
                if rpc is None:
                    entries: List[Entry] = []
                    if nxt <= li:
                        entries = g.log.fetch_range(
                            nxt, min(li, nxt + self.aer_batch_size - 1)
                        )
                    prev_idx = nxt - 1
                    prev_term = g.log.fetch_term(prev_idx)
                    snap = g.log.snapshot_index_term()
                    if prev_term is None or (
                        snap is not None and prev_idx < snap[0]
                    ):
                        rpc = self._NEEDS_SNAPSHOT
                    else:
                        # stamp plain-USR batches so the receiver skips
                        # its per-entry specials scan. g.specials is
                        # only exhaustive ABOVE last_applied (older
                        # rows are pruned), so lagging-peer backfills
                        # below the applied floor never get the stamp.
                        plain = False
                        if entries and nxt > g.last_applied:
                            sp = g.specials
                            if not sp:
                                plain = True
                            else:
                                i = bisect_left(sp, nxt)
                                plain = (
                                    i >= len(sp)
                                    or sp[i] > entries[-1].index
                                )
                        rpc = AppendEntriesRpc(
                            term=g.term, leader_id=sid, prev_log_index=prev_idx,
                            prev_log_term=prev_term, leader_commit=commit,
                            entries=tuple(entries), plain_usr=plain,
                            commit_ts=cts,
                        )
                    rpc_cache[nxt] = rpc
                if rpc is self._NEEDS_SNAPSHOT:
                    # peer is behind our compacted floor: stream a snapshot
                    self._start_snapshot_sender(g, member)
                    continue
                if lease_on:
                    self._lease_stamp_send(gid, s, now)
                outbound.setdefault(member[1], []).append((member, rpc, sid))
                if rpc.entries:
                    g.next_index[s] = rpc.entries[-1].index + 1
                g.commit_sent[s] = commit
        for node_name, msgs in outbound.items():
            self._send_batch(node_name, msgs)

    # -- rare paths --------------------------------------------------------

    def _handle_rare(self, g: GroupHost, msg, from_sid,
                     rare_out: Optional[Dict[str, List]] = None) -> None:
        """``rare_out``: the realisation pass's shared per-destination
        outbound — fan-outs append into it and the caller ships ONE
        batch per destination after the whole rare loop (a per-group
        send per election would overflow a peer's bounded ingress lane
        under a 10k-group storm). A None caller (direct invocations in
        tests) ships inline."""
        if isinstance(msg, ElectionTimeout):
            if g.role == C.R_LEADER:
                return
            if msg.armed_at and g.last_contact > msg.armed_at:
                # stale detector trigger: the group has seen contact (or
                # restarted its own election window) since the suspicion
                # was confirmed — a trigger delayed behind a stall (jit
                # compile, long egress) must not pile a second election
                # onto a round that is already resolving
                return
            if g.voter_status.get(g.self_slot) != "voter":
                return  # nonvoters never start elections
            if self.lease_cfg.enabled and not self._stickiness_lapsed(
                g, self.clock.monotonic()
            ):
                # standing is stickiness-gated too (§20): a candidate
                # grants its own vote, and could be the one quorum-
                # intersection voter a live leader's lease counts on
                return
            self._obs_rec.record(
                "election", node=self.name, group=g.name, term=g.term,
                detail="pre_vote round started",
            )
            # start pre-vote host-side: queue the role scatter (batched
            # across groups at the next step), broadcast the rpc
            self._pending_roles.append((g.gid, C.R_PRE_VOTE))
            g.role = C.R_PRE_VOTE
            g.pre_vote_token += 1
            g.last_contact = self.clock.monotonic()  # election-retry window restarts
            self._hot.add(g.gid)  # force steps so the election progresses
            if len(g.members) == 1:
                return  # the next device steps self-elect
            outbound: Dict[str, List] = (
                {} if rare_out is None else rare_out
            )

            def queue_send(to, m, frm):
                outbound.setdefault(to[1], []).append((to, m, frm))

            self._broadcast_vote_req(g, queue_send, pre=True)
            if rare_out is None:
                for node_name, msgs in outbound.items():
                    self._send_batch(node_name, msgs)
            return
        if isinstance(msg, tuple) and msg and msg[0] == "local_query":
            # ("local_query", fn, fut) or a 4-tuple carrying the
            # caller's max_staleness_s bound (docs/INTERNALS.md §20):
            # the bounded form only answers when the leader-stamped
            # freshness floor proves local state is recent enough
            fn, fut = msg[1], msg[2]
            if len(msg) > 3 and msg[3] is not None:
                staleness = self._read_staleness(g)
                self._staleness_hist().record_seconds(
                    min(staleness, 3600.0)
                )
                if staleness > msg[3]:
                    self.counters.incr("read_stale_rejected")
                    self._reply(
                        fut, ("stale", staleness, g.sid_of(g.leader_slot))
                    )
                    return
                self.counters.incr("read_local_bounded")
            self._reply(fut, ("ok", fn(g.machine_state), g.sid_of(g.leader_slot)))
            return
        if isinstance(msg, TimeoutNow):
            # leadership-transfer trigger from any backend's leader: a
            # FORCED election, no pre-vote round (Raft §3.10; matches
            # the scalar backend's _call_for_election on TimeoutNow) —
            # one round trip to leadership, and correct independent of
            # any leader-stickiness in the pre-vote grant.
            if g.role == C.R_LEADER or g.voter_status.get(g.self_slot) != "voter":
                return
            g.role = C.R_CANDIDATE
            g.term += 1
            g.leader_slot = -1
            g.last_contact = self.clock.monotonic()
            if self.meta is not None:
                # term AND self-vote must be durable before any vote
                # request leaves this node (restart double-vote safety):
                # in a rare pass, ONE sync before its rare_out ships
                # (_finish_ticket) covers every group's
                uid = f"{g.cluster_name}_{g.name}"
                self.meta.store(uid, "current_term", g.term)
                if rare_out is None or getattr(self.meta, "sync", None) is None:
                    self.meta.store_sync(uid, "voted_for", (g.name, self.name))
                else:
                    self.meta.store(uid, "voted_for", (g.name, self.name))
            self.state = self._dev.force_elections(self.state, [g.gid])
            self._hot.add(g.gid)  # keep stepping (single-member self-election)
            outbound2: Dict[str, List] = (
                {} if rare_out is None else rare_out
            )

            def queue_send2(to, m, frm):
                outbound2.setdefault(to[1], []).append((to, m, frm))

            # forced candidacy (§20): the transferring leader revoked
            # its lease before sending TimeoutNow, so voters may skip
            # stickiness for this request
            self._broadcast_vote_req(g, queue_send2, pre=False, force=True)
            if rare_out is None:
                for node_name, msgs in outbound2.items():
                    self._send_batch(node_name, msgs)
            return
        if isinstance(msg, tuple) and msg and msg[0] == "transfer_leadership":
            _, target, fut = msg
            me = (g.name, self.name)
            if g.role != C.R_LEADER:
                self._reply(fut, ("redirect", g.sid_of(g.leader_slot)))
                return
            target = tuple(target)
            if target == me:
                self._reply(fut, ("ok", "already_leader"))
                return
            slot = g.slot_of(target)
            if slot < 0:
                self._reply(fut, ("error", "unknown_member"))
                return
            if g.voter_status.get(slot) != "voter":
                self._reply(fut, ("error", "non_voter"))
                return
            li, _ = g.log.last_index_term()
            # gate on the device's CONFIRMED match for the slot — the
            # host next_index advances optimistically at send time, so
            # a pipelined-to-but-unacked peer must not pass (mirrors
            # the scalar backend's match_index gate). One device read;
            # transfers are rare.
            confirmed = self._dev.read_match(self.state, g.gid, slot)
            if confirmed != li:
                self._reply(fut, ("error", "not_up_to_date"))
                return
            self._reply(fut, ("ok", None))
            # revoke BEFORE the transfer trigger leaves this node: the
            # target's forced (stickiness-bypassing) election is only
            # safe because no lease-holding leader remains (§20)
            self._lease_revoke(g, "leadership transfer")
            self._send_batch(target[1], [(target, TimeoutNow(), me)])
            return
        if isinstance(msg, tuple) and msg and msg[0] == "lane_recover":
            # watchdog strike 1: force a device re-step (fresh quorum
            # scan over current match/written state) and probe every
            # peer — their acks or reject hints resynchronize
            # replication from the confirmed point
            self.counters.incr("lane_recoveries")
            self._hot.add(g.gid)
            if g.role == C.R_LEADER:
                now = self.clock.monotonic()
                for s, m in enumerate(g.members):
                    if (
                        m is not None and s != g.self_slot
                        and s < len(g.commit_sent)
                    ):
                        g.commit_sent[s] = -1
                        g.last_ack.setdefault(s, now)
                self._send_aers({g.gid})
            return
        if isinstance(msg, tuple) and msg and msg[0] == "lane_fail":
            # watchdog second strike: recovery did not move the lane —
            # bound the failure so clients retry elsewhere instead of
            # hanging until their timeout
            self._fail_pending(g, counter="lane_redirects")
            return
        if isinstance(msg, tuple) and msg and msg[0] == "resync":
            if g.role == C.R_LEADER:
                now = self.clock.monotonic()
                for s in msg[1]:
                    if s < len(g.commit_sent):
                        # -1 sentinel: the probe must fire even at
                        # commit 0 (a fresh leader's lost noop AER)
                        g.commit_sent[s] = -1
                        g.last_ack.setdefault(s, now)
                self._send_aers({g.gid})
            return
        if isinstance(msg, tuple) and msg and msg[0] == "machine_tick":
            mac = g.machine.which_module(g.effective_machine_version)
            effs = mac.tick(msg[1], g.machine_state)
            if effs and g.role == C.R_LEADER:
                self._realise_effects(g, effs)
            return
        if isinstance(msg, tuple) and msg and msg[0] == "consistent_query":
            self._handle_consistent_query(g, msg[1], msg[2])
            return
        if isinstance(msg, HeartbeatRpc):
            # follower side of the query-index leadership confirmation.
            # A higher term is adopted before acking (the scalar backend
            # goes through _update_term, server.py; an ack from a member
            # that never acknowledged the term would be meaningless).
            if from_sid is not None:
                if msg.term >= g.term:
                    g.last_contact = self.clock.monotonic()
                    if self.lease_cfg.enabled:
                        g.lease_contact = g.last_contact
                    if msg.term > g.term or g.role != C.R_FOLLOWER:
                        self._adopt_term(g, msg.term, leader_sid=from_sid)
                    elif g.leader_slot < 0:
                        g.leader_slot = g.slot_of(from_sid)
                    reply = HeartbeatReply(term=msg.term, query_index=msg.query_index)
                else:
                    reply = HeartbeatReply(term=g.term, query_index=-1)
                self._send_batch(
                    from_sid[1], [(from_sid, reply, (g.name, self.name))]
                )
            return
        if isinstance(msg, HeartbeatReply):
            self._handle_heartbeat_reply(g, msg, from_sid)
            return
        if isinstance(msg, tuple) and msg and msg[0] == "aux":
            self._handle_aux(g, msg[1], msg[2], msg[3])
            return
        if isinstance(msg, tuple) and msg and msg[0] == "state_query":
            _, fn, fut = msg
            self._reply(fut, ("ok", fn(g), g.sid_of(g.leader_slot)))
            return
        if isinstance(msg, tuple) and msg and msg[0] == "force_shrink":
            # disaster recovery: restrict the cluster to this member and
            # elect. Mirrors the Server path: membership shrinks, a
            # durable 'replace' marker is appended (meaningful when the
            # group's log is persistent), and an election follows.
            me = (g.name, self.name)
            self._lease_revoke(g, "force_shrink")
            idx = g.log.next_index()
            g.log.append(Entry(index=idx, term=g.term, cmd=Command(
                kind="ra_cluster_change", data=("replace", ((me, "voter"),)))))
            g.specials.append(idx)
            self._stage_app(g.gid, idx, idx, g.term)
            g.members = [me]
            g.self_slot = 0
            g.next_index = [idx + 1]
            g.commit_sent = [0]
            g.match_hint = [0]
            g.voter_status = {0: "voter"}
            g.last_ack = {}
            g.cluster_change_permitted = True
            onehot = np.zeros(self.P, dtype=bool)
            onehot[0] = True
            self._flush_member_rows()
            self.state = self._dev.set_rows(
                self.state, g.gid, voting=onehot, active=onehot, self_slot=0,
            )
            self.state = self._dev.set_roles(
                self.state, [g.gid], [C.R_PRE_VOTE]
            )
            g.role = C.R_PRE_VOTE
            g.pre_vote_token += 1
            self._hot.add(g.gid)
            if len(msg) > 1 and msg[1] is not None:
                self._reply(msg[1], ("ok", None))
            return
        if isinstance(msg, InstallSnapshotRpc):
            self._receive_snapshot_chunk(g, msg, from_sid)
            return
        if isinstance(msg, (InstallSnapshotAck, InstallSnapshotResult)):
            sender = g.snap_senders.get(from_sid)
            if sender is not None:
                if isinstance(msg, InstallSnapshotAck):
                    sender.on_ack(msg)
                else:
                    sender.on_result(msg)
            return
        if isinstance(msg, tuple) and msg and msg[0] == "snap_send_done":
            _, to, result = msg
            g.snap_senders.pop(to, None)
            if result is not None and g.role == C.R_LEADER:
                slot = g.slot_of(to)
                if slot >= 0:
                    g.next_index[slot] = max(g.next_index[slot], result.last_index + 1)
                    if slot < len(g.match_hint):
                        g.match_hint[slot] = max(
                            g.match_hint[slot], result.last_index
                        )
                    # feed the result through the device path for match
                    g.inbox.append((to, AppendEntriesReply(
                        result.term, True, result.last_index + 1,
                        result.last_index, result.last_term)))
                    self._hot.add(g.gid)
                    # resume pipelining the post-snapshot tail right away
                    self._send_aers({g.gid})
            return

    _ROLE_NAMES = {0: "follower", 1: "pre_vote", 2: "candidate", 3: "leader"}

    class _AuxServerShim:
        """Duck-types the Server surface AuxContext reads, over a
        GroupHost (machine state, membership, indexes, log)."""

        def __init__(self, coord: "BatchCoordinator", g: GroupHost):
            self.machine_state = g.machine_state
            self.leader_id = g.sid_of(g.leader_slot)
            self.current_term = g.term
            self.commit_index = g.last_applied
            self.last_applied = g.last_applied
            self.log = g.log
            self._g = g
            self._coord = coord

        def members(self):
            return [m for m in self._g.members if m is not None]

        def overview(self):
            g = self._g
            return {
                "id": (g.name, self._coord.name),
                "backend": "tpu_batch",
                "role": BatchCoordinator._ROLE_NAMES.get(g.role, g.role),
                "term": g.term,
                "last_applied": g.last_applied,
                "machine": g.machine.overview(g.machine_state),
            }

    def _handle_aux(self, g: GroupHost, kind: str, cmd, from_ref) -> None:
        """Aux machine plumbing for batch-backed groups (reference:
        ra_aux surface, src/ra_aux.erl:8-23)."""
        from ra_tpu_torch.aux import AuxContext

        if not g.aux_inited:
            g.aux_state = g.machine.init_aux(g.cluster_name)
            g.aux_inited = True
        from ra_tpu_torch.machine import normalize_aux_result

        res = g.machine.handle_aux(
            self._ROLE_NAMES.get(g.role, "follower"), kind, cmd, g.aux_state,
            AuxContext(self._AuxServerShim(self, g)),
        )
        reply, g.aux_state, effs = normalize_aux_result(res, g.aux_state)
        if effs:
            # aux effects are realized regardless of role (matching the
            # proc backend, which executes them ungated)
            self._realise_effects(g, effs, True)
        if kind == "call" and from_ref is not None:
            self._reply(from_ref, ("ok", reply, (g.name, self.name)))

    def _voter_count(self, g: GroupHost) -> int:
        return sum(
            1 for i, m in enumerate(g.members)
            if m is not None and g.voter_status.get(i) == "voter"
        )

    def _handle_consistent_query(self, g: GroupHost, fn, fut) -> None:
        """Linearizable read: confirm leadership with a voter heartbeat
        quorum round before answering, gated on the leader's own noop
        having committed (Raft read-index; reference: query_index
        heartbeat protocol, src/ra_server.erl consistent queries)."""
        if g.role != C.R_LEADER:
            self._reply(fut, ("redirect", g.sid_of(g.leader_slot)))
            return
        if not g.noop_committed:
            # a fresh leader may hold committed-but-unapplied entries
            # from the previous term; ask the caller to retry
            self._reply(fut, ("redirect", None))
            return
        me = (g.name, self.name)
        if self._voter_count(g) <= 1:
            self._reply(fut, ("ok", fn(g.machine_state), me))
            return
        now = self.clock.monotonic()
        if self.lease_cfg.enabled:
            # lease fast path (§20): within a quorum-earned lease the
            # read is served locally at read_index = commit (== applied
            # on this backend) with zero quorum traffic. Demand-driven
            # renewal: reads in the back half of the window trigger a
            # stamped heartbeat round (throttled to one per quarter-
            # window) so a read-only workload renews at an amortized
            # one round per window instead of one per read.
            self._lease_refresh()
            gid = g.gid
            exp = self._lease_expiry[gid]
            if exp > now:
                self.counters.incr("read_lease_served")
                self._reply(fut, ("ok", fn(g.machine_state), me))
                if (
                    exp - now < self.lease_cfg.window_s / 2.0
                    and now - self._lease_renew_t[gid]
                    >= self.lease_cfg.window_s / 4.0
                ):
                    self._lease_renew_t[gid] = now
                    hb0 = HeartbeatRpc(
                        term=g.term, leader_id=me,
                        query_index=g.query_seq,
                    )
                    ob0: Dict[str, List] = {}
                    for s0, m0 in enumerate(g.members):
                        if (
                            m0 is None or s0 == g.self_slot
                            or g.voter_status.get(s0) != "voter"
                        ):
                            continue
                        self._lease_stamp_send(gid, s0, now)
                        ob0.setdefault(m0[1], []).append((m0, hb0, me))
                    for nn0, msgs0 in ob0.items():
                        self._send_batch(nn0, msgs0)
                return
            if exp > 0.0:
                # held a lease, lapsed: count the expiry once. Bases
                # stay — they are still honest promises and the
                # fallback round's acks re-earn the lease.
                self.counters.incr("read_lease_expirations")
                self._obs_rec.record(
                    "lease_lost", node=self.name, group=g.name,
                    term=g.term, detail="expired",
                )
                self._lease_expiry[gid] = 0.0
            self.counters.incr("read_quorum_fallback")
        fresh = []
        for q in g.pending_queries:
            if now - q["t"] < 10.0:
                fresh.append(q)
            else:
                # quorum never arrived (lost heartbeat, shrunk voter
                # set): tell the caller to retry instead of hanging
                self._reply(q["fut"], ("redirect", None))
        g.pending_queries = fresh
        g.query_seq += 1
        qid = g.query_seq
        g.pending_queries.append(
            {"qi": g.last_applied, "qid": qid, "fn": fn, "fut": fut,
             "acks": set(), "t": now}
        )
        hb = HeartbeatRpc(term=g.term, leader_id=me, query_index=qid)
        outbound: Dict[str, List] = {}
        for s, member in enumerate(g.members):
            if (
                member is None
                or s == g.self_slot
                or g.voter_status.get(s) != "voter"
            ):
                continue  # only voter acks may confirm leadership
            if self.lease_cfg.enabled:
                # the fallback round's acks re-earn the lease
                self._lease_stamp_send(g.gid, s, now)
            outbound.setdefault(member[1], []).append((member, hb, me))
        for node_name, msgs in outbound.items():
            self._send_batch(node_name, msgs)

    def _adopt_term(self, g: GroupHost, term: int, leader_sid=None) -> None:
        """Adopt a higher term seen outside the device mailbox (call
        sites hold the state lock): revert to follower on host AND
        device, persist the term, drop in-flight linearizable reads."""
        if g.role == C.R_LEADER:
            self._lease_revoke(g, "deposed by higher term")
            for q in g.pending_queries:
                self._reply(q["fut"], ("redirect", None))
            g.pending_queries = []
        bumped = term > g.term
        g.term = max(g.term, term)
        was_leader = g.role == C.R_LEADER
        g.role = C.R_FOLLOWER
        g.last_contact = self.clock.monotonic()
        g.leader_slot = g.slot_of(leader_sid) if leader_sid is not None else -1
        if was_leader:
            # deposed outside the device mailbox: same redirect contract
            # as the egress role-transition path
            self._fail_pending(g)
        if bumped and self.meta is not None:
            # entering a new term clears the durable vote (the device
            # mailbox path resets voted_for on term bumps identically)
            uid = f"{g.cluster_name}_{g.name}"
            self.meta.store(uid, "current_term", g.term)
            self.meta.store_sync(uid, "voted_for", None)
        dev = self._dev
        if bumped:
            self.state = dev.set_rows(self.state, g.gid, voted_for=-1)
        self.state = dev.max_rows(self.state, g.gid, current_term=term)
        self.state = dev.set_rows(
            self.state, g.gid, leader_slot=g.leader_slot, role=C.R_FOLLOWER,
        )

    def _handle_heartbeat_reply(self, g: GroupHost, msg: HeartbeatReply, from_sid) -> None:
        if msg.term > g.term:
            # a deposed leader must step down now, not wait for AER
            # traffic while its pending queries ride the redirect timeout
            self._adopt_term(g, msg.term)
            return
        if g.role != C.R_LEADER or from_sid is None or msg.term != g.term:
            return
        slot = g.slot_of(from_sid)
        if slot < 0 or g.voter_status.get(slot) != "voter":
            return
        if self.lease_cfg.enabled:
            self._lease_credit(g, slot)
        quorum = self._voter_count(g) // 2 + 1
        me = (g.name, self.name)
        done = []
        for q in g.pending_queries:
            if msg.query_index >= q["qid"]:
                q["acks"].add(from_sid)
                if len(q["acks"]) + 1 >= quorum and g.last_applied >= q["qi"]:
                    self._reply(q["fut"], ("ok", q["fn"](g.machine_state), me))
                    done.append(q)
        for q in done:
            g.pending_queries.remove(q)

    # -- snapshot transfer (batch-backed groups) ---------------------------

    def _snap_ack(self, g: GroupHost, chunk_no: int) -> InstallSnapshotAck:
        """Chunk ack with receiver-paced credits (docs/INTERNALS.md
        §21): 0 while this node is storage-blocked, so the sender parks
        instead of streaming chunks at a disk that cannot spool them."""
        window = max(1, self.snapshot_credit_window)
        credits = self.pressure.snapshot_credits(window)
        if credits:
            self.counters.incr("snapshot_credits_granted", credits)
        else:
            self.counters.incr("snapshot_credit_waits")
        self.counters.put("snapshot_credit_window", credits)
        return InstallSnapshotAck(g.term, chunk_no, credits)

    def _receive_snapshot_chunk(self, g: GroupHost, msg: InstallSnapshotRpc, from_sid):
        """Host-side 4-phase chunked install; the device learns the new
        floor via a record_snapshot scatter on completion."""
        me = (g.name, self.name)

        def send_one(m):
            self._send_batch(from_sid[1], [(from_sid, m, me)])

        if msg.term < g.term:
            li, lt = g.log.last_index_term()
            send_one(InstallSnapshotResult(g.term, li, lt))
            return
        g.last_contact = self.clock.monotonic()
        if self.lease_cfg.enabled:
            g.lease_contact = g.last_contact
        if msg.chunk_phase == CHUNK_INIT:
            # INIT always starts a fresh accumulator — a retried transfer
            # at the same index must not append onto stale chunks. Chunk
            # bodies spool straight to disk when the group's log store
            # supports it ("accept" is None on memory logs: RAM fallback)
            old = g.snap_accept
            if old is not None:
                oa = old.get("accept")
                if oa is not None and not oa.done:
                    oa.abort()
            g.snap_accept = {
                "meta": msg.meta, "chunks": [], "next": 1,
                "accept": g.log.begin_accept_snapshot(msg.meta),
            }
            send_one(self._snap_ack(g, msg.chunk_no))
            return
        acc = g.snap_accept
        if acc is None or acc["meta"].index != msg.meta.index:
            return  # no transfer in progress for this snapshot: ignore
        if msg.chunk_phase == CHUNK_PRE:
            acc["next"] = max(acc["next"], msg.chunk_no + 1)
            for e in msg.data:
                if g.log.fetch_term(e.index) is None:
                    g.log.write_sparse(e)
            send_one(self._snap_ack(g, msg.chunk_no))
            return
        if msg.chunk_no < acc["next"]:
            send_one(self._snap_ack(g, msg.chunk_no))
            return
        if msg.chunk_no > acc["next"]:
            return
        a = acc.get("accept")
        if a is not None and isinstance(msg.data, (bytes, bytearray)):
            a.accept_chunk(msg.data)  # straight to the disk spool
        else:
            if a is not None:
                # non-byte chunk (in-proc direct-object transfer): falls
                # back to RAM — always the first chunk, nothing is lost
                a.abort()
                acc["accept"] = a = None
            acc["chunks"].append(msg.data)
        acc["next"] += 1
        if msg.chunk_phase != CHUNK_LAST:
            send_one(self._snap_ack(g, msg.chunk_no))
            return
        # complete: install host-side, then scatter the floor to device
        from ra_tpu_torch.log.snapshot import decode_snapshot_chunks

        meta = acc["meta"]
        try:
            if a is not None:
                # seal + streaming-decode + promote: the spool dir IS
                # the new snapshot; no second serialization
                state_obj = g.log.complete_accept_snapshot(a)
            else:
                state_obj = decode_snapshot_chunks(acc["chunks"])
                g.log.install_snapshot(meta, state_obj)
        except Exception:
            # undecodable body (e.g. a machine-state type the wire
            # allowlist does not know here): abort THIS transfer so a
            # retry restarts from INIT; never poison the step thread
            g.snap_accept = None
            logger.exception(
                "coordinator %s: snapshot body for group %s failed wire "
                "decode; transfer aborted (register_wire_type missing?)",
                self.name, g.name,
            )
            return
        g.machine_state = state_obj
        g.effective_machine_version = meta.machine_version
        g.last_applied = max(g.last_applied, meta.index)
        g.snap_floor = max(g.snap_floor, meta.index)
        g.last_ok_sent = None  # log identity changed under the ack key
        # installing a snapshot forces follower: any leftover pending
        # command futures must redirect, not hang
        self._fail_pending(g)
        if g.specials:
            g.specials = [s for s in g.specials if s > meta.index]
        # adopt the snapshot's member set (node-local slot coordinates)
        if meta.cluster:
            new = [tuple(m) for m in meta.cluster]
            me = (g.name, self.name)
            if me in new and set(new) != {m for m in g.members if m is not None}:
                g.members = list(new)
                g.self_slot = new.index(me)
                g.voter_status = {i: "voter" for i in range(len(new))}
                g.next_index = [meta.index + 1] * len(new)
                g.commit_sent = [0] * len(new)
                g.match_hint = [0] * len(new)
                g.last_ack = {}
                self.state = self._dev.set_rows(
                    self.state, g.gid, self_slot=g.self_slot
                )
                self._sync_member_rows(g)
        self._applied_np[g.gid] = g.last_applied
        g.term = max(g.term, msg.term)
        g.leader_slot = g.slot_of(msg.leader_id)
        g.snap_accept = None
        self._obs_rec.record(
            "snapshot_install", node=self.name, group=g.name, term=g.term,
            detail=f"installed at index {meta.index} (term {meta.term})",
        )
        # written at the rare-message pass's end
        self._install_rows[g.gid] = (meta.index, meta.term, msg.term,
                                     g.leader_slot)
        send_one(InstallSnapshotResult(g.term, meta.index, meta.term))

    class _SenderShim:
        """Adapts a coordinator group to the interface proc.SnapshotSender
        expects (transport / server.id / enqueue / ack timeout)."""

        def __init__(self, coord: "BatchCoordinator", g: GroupHost):
            self._coord = coord
            self._g = g
            self.transport = coord.transport
            self.snapshot_ack_timeout_s = 60.0
            self.server = type(
                "S", (),
                {"id": (g.name, coord.name),
                 # the sender counts credit starvation through the
                 # server surface; route it to coordinator counters
                 "_c": staticmethod(
                     lambda field, n=1: coord.counters.incr(field, n)
                 )},
            )()

        def enqueue(self, msg, front: bool = False):
            tag = msg[0]
            to = msg[1]
            result = msg[2] if tag == "snapshot_send_done" else None
            self._coord.deliver(
                (self._g.name, self._coord.name), ("snap_send_done", to, result), None
            )

    def _start_snapshot_sender(self, g: GroupHost, to: ServerId) -> None:
        if to in g.snap_senders:
            return
        # prefer the disk-streaming reader (no decode, no blob in RAM);
        # memory-backed group logs fall back to the whole-state capture
        chunk_size = 1024 * 1024
        state_obj = chunk_iter = None
        stream = g.log.begin_snapshot_read(chunk_size)
        if stream is not None:
            meta, chunk_iter = stream
        else:
            got = g.log.read_snapshot()
            if got is None:
                return
            meta, state_obj = got
        live_entries = (
            g.log.sparse_read(list(meta.live_indexes)) if meta.live_indexes else []
        )
        from ra_tpu_torch.runtime.proc import SnapshotSender

        sender = SnapshotSender(
            self._SenderShim(self, g), to, meta, state_obj, live_entries, g.term,
            chunk_size, chunk_iter=chunk_iter,
        )
        g.snap_senders[to] = sender
        if not self._snap_send.submit(sender._run):
            g.snap_senders.pop(to, None)  # stopped

    # -- failure detection -------------------------------------------------

    def _detect_loop(self) -> None:
        cooldown: Dict[int, float] = {}
        # suspicion arming: first sighting arms a randomized deadline
        # (the textbook randomized election timeout); the election only
        # fires if the group is STILL suspicious at the deadline. Breaks
        # dueling candidacies: the node whose trigger lands first gets a
        # full round before rivals pile in.
        armed: Dict[int, float] = {}
        # command-lane watchdog state per gid:
        # (applied_seen, oldest_pending_idx, since, strikes)
        lane_watch: Dict[int, Tuple[int, int, float, int]] = {}
        last_tick = self.clock.monotonic()
        while self.running:
            try:
                now0 = self.clock.monotonic()
                if now0 - last_tick >= self.tick_interval_s:
                    last_tick = now0
                    self._lane_watchdog(lane_watch, now0)
                    # aggregate commit rate across all groups (the
                    # batch-backend ra_li feed for system_overview /
                    # placement decisions)
                    applied_total = int(
                        self._applied_np[: self.n_groups].sum()
                    )
                    prev = self._commit_li_prev
                    self._commit_li_prev = (now0, applied_total)
                    if prev is not None:
                        rate = self._commit_li.sample(
                            max(0, applied_total - prev[1]), now0 - prev[0]
                        )
                        self.counters.put("commit_rate", int(round(rate)))
                    # reclaim lanes of exited producer threads, then
                    # publish the registered-lane gauge (one lane per
                    # live producer; off the hot drain path)
                    prune = getattr(self._rings, "prune_dead", None)
                    if prune is not None:
                        prune()
                    self.counters.put(
                        "ingress_ring_lanes", self._rings.lanes()
                    )
                    self._health_scan(now0)
                    ms = int(self.clock.time() * 1000)
                    for i in range(self.n_groups):
                        g = self.groups[i]
                        if g is None:
                            continue
                        if g.has_tick:
                            self.deliver((g.name, self.name), ("machine_tick", ms), None)
                        if g.role == C.R_LEADER:
                            # peers silent for two ticks may have missed
                            # AERs (drops/partitions advance next_index
                            # optimistically): probe them so their reject
                            # hints rewind replication (zero cost while
                            # acks flow)
                            stale = [
                                s for s, m in enumerate(g.members)
                                if m is not None and s != g.self_slot
                                and now0 - g.last_ack.get(s, 0.0)
                                > 2 * self.tick_interval_s
                            ]
                            if stale:
                                self.deliver(
                                    (g.name, self.name), ("resync", stale), None
                                )
                # a stopped node unregisters: include previously-seen
                # names so disappearance reads as death
                known = set(self.registry.names()) | set(self._node_status)
                for other in known:
                    if other == self.name:
                        continue
                    alive = self.transport.node_alive(other)
                    prev = self._node_status.get(other)
                    self._node_status[other] = alive
                    if prev is True and not alive:
                        self._on_node_down(other)
                # suspicion sweep. Three leaderless shapes need retry —
                # without it a partition heal can wedge a group forever
                # (nobody re-elects once every node is "alive" again):
                #   1. a stalled election (pre-vote/candidate whose
                #      messages were lost) — mirror the actor backend's
                #      state-enter election timer;
                #   2. a follower with a known leader: a dead leader
                #      node counts once the follower has ALSO been
                #      without contact for one election timeout (vote
                #      grants refresh contact, so a member that just
                #      endorsed a campaigning rival holds off); an
                #      alive-but-silent leader (deposed, never re-won)
                #      times out on lost contact — the resync probe
                #      guarantees a live leader contacts every peer
                #      within ~2 ticks;
                #   3. a follower with NO known leader (term bumped by a
                #      failed election) — contact timeout, gated on
                #      term > 0 so fresh clusters still boot quiet until
                #      explicitly triggered (reference: ra:start_cluster
                #      calls trigger_election; no idle heartbeats).
                # window >> the 2-tick probe cadence: device pre-vote
                # grants have no leader-stickiness, so a trigger-happy
                # sweep could dethrone a healthy but loaded leader
                now = self.clock.monotonic()
                contact_window = max(
                    5 * self.tick_interval_s, 6 * self.election_timeout_s
                )
                for i in range(self.n_groups):
                    g = self.groups[i]
                    if g is None or g.role == C.R_LEADER:
                        continue
                    if g.voter_status.get(g.self_slot) != "voter":
                        continue
                    leader = g.sid_of(g.leader_slot)
                    if g.role in (C.R_PRE_VOTE, C.R_CANDIDATE):
                        suspicious = (
                            now - g.last_contact > 2 * self.election_timeout_s
                        )
                    elif leader is not None and leader[1] != self.name:
                        # a dead leader node is suspicious only once it
                        # has also been SILENT for an election timeout:
                        # last_contact refreshes on vote grants, so a
                        # member that just endorsed a campaigning rival
                        # holds off instead of racing it (the round-5
                        # takeover duel)
                        suspicious = (
                            not self.transport.node_alive(leader[1])
                            and now - g.last_contact > self.election_timeout_s
                        ) or now - g.last_contact > contact_window
                    else:
                        suspicious = (
                            g.term > 0
                            and now - g.last_contact > contact_window
                        )
                    if not suspicious:
                        armed.pop(i, None)
                    elif now >= cooldown.get(i, 0.0):
                        dl = armed.get(i)
                        if dl is None:
                            armed[i] = now + self.election_timeout_s * (
                                0.1 + random.random()
                            )
                        elif now >= dl:
                            armed.pop(i, None)
                            cooldown[i] = (
                                now + 2 * self.election_timeout_s
                                + random.random() * 2 * self.election_timeout_s
                            )
                            self.deliver(
                                (g.name, self.name), ElectionTimeout(now),
                                None,
                            )
            except Exception:  # noqa: BLE001
                pass
            time.sleep(self._detector_poll_s)

    def _lane_watchdog(
        self, lane_watch: Dict[int, Tuple[int, int, float, int]], now0: float
    ) -> None:
        """Per-command-deadline lane watchdog (runs on the detector
        thread, once per tick): a group holding pending client futures
        whose apply floor AND oldest pending index both sat still for
        ``command_deadline_s`` is a wedged lane. Strike 1 recovers
        (device re-step + peer resync probe); a further strike bounds
        the failure by redirecting the stuck clients. Turns the round-5
        class of bug (accepted command, no commit, silent 10 s client
        hang) into a detected, counted, bounded event."""
        for i in range(self.n_groups):
            g = self.groups[i]
            if g is None:
                continue
            pending = g.pending_replies
            if not pending:
                lane_watch.pop(i, None)
                continue
            try:
                oldest = min(pending)
            except (ValueError, RuntimeError):
                continue  # raced the step thread's mutation: next tick
            st = lane_watch.get(i)
            if st is None or st[0] != g.last_applied or st[1] != oldest:
                lane_watch[i] = (g.last_applied, oldest, now0, 0)
                continue
            if now0 - st[2] <= self.command_deadline_s:
                continue
            strikes = st[3] + 1
            lane_watch[i] = (g.last_applied, oldest, now0, strikes)
            self.counters.incr("lane_wedges")
            self._obs_rec.record(
                "watchdog_strike", node=self.name, group=g.name,
                term=g.term,
                detail=f"strike {strikes}: oldest pending {oldest}, "
                       f"applied {g.last_applied}",
            )
            logger.warning(
                "coordinator %s: command lane wedged for group %s "
                "(oldest pending idx %d, applied %d, role %d, strike %d)",
                self.name, g.name, oldest, g.last_applied, g.role, strikes,
            )
            self.deliver(
                (g.name, self.name),
                ("lane_recover",) if strikes == 1 else ("lane_fail",),
                None,
            )

    def _health_scan(self, now: float) -> None:
        """Per-group health pass (docs/INTERNALS.md §14), once per tick
        on the detector thread: ONE device fetch over the existing
        consensus mirrors (proven by the scans==fetches counter
        invariant), then a fully vectorized gauge/anomaly update in
        ra_tpu_torch.health — no per-group Python loop, so the cost scales
        with capacity at numpy speed, not with groups at Python speed."""
        from ra_tpu_torch import health as H

        n = self.n_groups
        if n == 0:
            return
        with self._state_lock:
            # state tensors are never updated in place (every step and
            # scatter returns fresh tensors), so a reference taken under
            # the lock stays valid and unchanging — holding the lock
            # across the host transfer would stall the step thread
            # behind the async dispatch queue ...
            st = self.state
        # ... so pay the transfer/queue wait OUTSIDE it: one fetch per
        # scan from the host's side, over every slice of a sharded state
        # (the health_fetches == health_scans counter invariant), with
        # the step loop free to run
        dev = self._dev.read_fields(st, (
            "current_term", "commit_index", "last_index", "role",
            "leader_slot", "self_slot", "match_index", "active",
        ))
        sc = self._health
        sc.counters.incr("health_fetches")
        term, commit, last, role, leader_slot, self_slot, match, active = (
            a[:n] for a in dev
        )
        applied = self._applied_np[:n]
        # follower match gap (leaders only): own tail minus the slowest
        # ACTIVE peer's confirmed match, self slot excluded
        cols = np.arange(match.shape[1])
        peers = active & (cols[None, :] != self_slot[:, None])
        slowest = np.where(
            peers, match.astype(np.int64), np.iinfo(np.int64).max
        ).min(axis=1)
        is_leader = role == C.R_LEADER
        has_peer = peers.any(axis=1)
        match_gap = np.where(
            is_leader & has_peer,
            np.maximum(last.astype(np.int64) - slowest, 0), 0,
        )
        leader_key = np.where(
            leader_slot >= 0, leader_slot.astype(np.int64), H.NO_LEADER_KEY
        )
        slots = np.asarray(self._hslots[:n], np.int64)
        sc.scan(now, slots, role, term, applied, commit, last, match_gap,
                leader_key)

    def _on_node_down(self, node_name: str) -> None:
        for i in range(self.n_groups):
            g = self.groups[i]
            if g is None or g.role == C.R_LEADER:
                continue
            leader = g.sid_of(g.leader_slot)
            if leader is not None and leader[1] == node_name:
                delay = self.election_timeout_s * (1 + random.random())
                # stamp the suspicion-confirmation time NOW: stamping at
                # fire time would make the staleness guard in
                # _handle_rare unable to drop the trigger when the
                # leader re-establishes contact during the delay
                armed = self.clock.monotonic()
                # the deadline stays on the wall clock, as a
                # threading.Timer's; none is armed once stopped
                timers = self._down_timer()
                if timers is None:
                    return
                timers.after(
                    delay,
                    lambda gg=g, at=armed: self.deliver(
                        (gg.name, self.name),
                        ElectionTimeout(at), None,
                    ),
                )

    def _down_timer(self) -> Optional[TimerService]:
        """The timer thread of the node-down election triggers, started
        by the first call; ``None`` once ``stop()`` has begun."""
        with self._down_lock:
            if self._down_timers is None and self.running:
                self._down_timers = TimerService()
            return self._down_timers

    def overview(self) -> dict:
        return {
            "node": self.name,
            "backend": "tpu_batch",
            "groups": self.n_groups,
            "steps": self.steps,
            "sub_steps": self.sub_steps,
            "msgs": self.msgs_processed,
            "commit_rate": self.counters.get("commit_rate"),
            "counters": self.counters.to_dict(),
        }
