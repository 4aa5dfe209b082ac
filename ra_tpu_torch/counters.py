"""Named counter/gauge registry.

Capability parity with the reference's ``ra_counters`` facade over the
seshat dep (reference: ``src/ra_counters.erl:10-22``) and the per-server
counter taxonomy (reference: ``src/ra.hrl:266-438``): every server (and the
WAL / segment writer) registers a fixed-width array of int64 slots, updated
lock-free on the hot path and readable by observers at any time.

Implementation: one numpy int64 vector per registered object. CPython's
GIL plus single-writer-per-slot discipline (each slot is only incremented
from its owner's event loop) makes plain ``arr[i] += n`` safe here; readers
may see slightly stale values, matching the reference's semantics.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# (name, kind, help). Kind: "counter" (monotone) or "gauge".
FieldSpec = Tuple[str, str, str]

# Per-server counter fields — same information set as the reference's
# ra_server counter index definitions (src/ra.hrl:266-438).
RA_SERVER_FIELDS: List[FieldSpec] = [
    ("commands", "counter", "commands received by the leader"),
    ("commands_rejected", "counter",
     "client commands rejected with overloaded (admission window)"),
    ("commands_dropped_overload", "counter",
     "ack-free commands dropped past the admission window"),
    ("commands_rejected_nospace", "counter",
     "client commands rejected with the typed RA_NOSPACE reason while "
     "the node's storage plane was degraded or hard-watermarked "
     "(docs/INTERNALS.md §21)"),
    ("stale_peer_resends", "counter",
     "pipeline-window stalls resolved by rewinding to the peer match"),
    ("msgs_sent", "counter", "protocol messages sent"),
    ("dropped_sends", "counter", "sends dropped due to backpressure"),
    ("send_msg_effects_sent", "counter", "send_msg effects executed"),
    ("commit_index", "gauge", "current commit index"),
    ("last_applied", "gauge", "last applied index"),
    ("commit_latency", "gauge", "approx entry-write->commit latency ms"),
    ("term", "gauge", "current term"),
    ("last_index", "gauge", "last log index"),
    ("last_written_index", "gauge", "last durably written log index"),
    ("snapshot_index", "gauge", "current snapshot index"),
    ("snapshots_written", "counter", "snapshots written"),
    ("snapshot_installed", "counter", "snapshots installed (follower)"),
    ("snapshot_send_failures", "counter",
     "snapshot sender deaths (backoff retries armed)"),
    ("snapshot_credits_granted", "counter",
     "chunk credits granted to snapshot senders (receiver-paced flow "
     "control; docs/INTERNALS.md §21)"),
    ("snapshot_credit_waits", "counter",
     "sender backoffs taken on credit starvation (receiver granted 0)"),
    ("snapshot_credit_window", "gauge",
     "last credit window granted by / observed at this server"),
    ("checkpoints_written", "counter", "checkpoints written"),
    ("recovery_checkpoint_used", "counter", "boots that skipped replay"),
    ("checkpoints_promoted", "counter", "checkpoints promoted to snapshots"),
    ("checkpoint_index", "gauge", "latest checkpoint index"),
    ("aer_received", "counter", "append_entries RPCs received"),
    ("aer_received_followers", "counter", "AERs received while follower"),
    ("aer_replies_success", "counter", "successful AER replies sent"),
    ("aer_replies_failed", "counter", "failed AER replies sent"),
    ("elections", "counter", "elections started"),
    ("pre_vote_elections", "counter", "pre-vote rounds started"),
    ("force_elections", "counter", "forced elections"),
    ("applied", "counter", "entries applied to the machine"),
    ("releases", "counter", "release-cursor truncations"),
    ("check_quorum_stepdowns", "counter",
     "leader step-downs because a quorum of voters went silent past the "
     "check-quorum window (one-way partition protection: a leader that "
     "can send but not hear acks must not reign uselessly)"),
    ("num_segments", "gauge", "number of live segment files"),
    ("compactions", "counter", "compactions run"),
    ("local_queries", "counter", "local queries served"),
    ("leader_queries", "counter", "leader queries served"),
    ("consistent_queries", "counter", "consistent queries served"),
    # -- lease-based local reads (docs/INTERNALS.md §20) ----------------
    ("read_lease_served", "counter",
     "consistent queries served locally under a valid leader lease "
     "(zero quorum traffic)"),
    ("read_quorum_fallback", "counter",
     "consistent queries that fell back to a quorum heartbeat round "
     "(lease off, invalid, or not yet earned)"),
    ("read_lease_expirations", "counter",
     "leases found lapsed at read admission (each lapse counted once)"),
    ("read_lease_revocations", "counter",
     "leases revoked eagerly on deposition/stepdown/transfer/"
     "membership change"),
    ("read_stale_rejected", "counter",
     "bounded local queries rejected because the freshness floor "
     "exceeded the caller's max_staleness_s"),
    ("read_local_bounded", "counter",
     "local queries served under an explicit max_staleness_s bound"),
    ("read_issued", "counter", "log reads issued"),
    ("read_cache", "counter", "log reads served from memtable"),
    ("read_segment", "counter", "log reads served from segments"),
    ("open_segments", "gauge", "open segment fds"),
    ("commit_rate", "gauge", "commit rate (entries/sec, smoothed)"),
]

WAL_FIELDS: List[FieldSpec] = [
    ("wal_files", "counter", "WAL files opened"),
    ("batches", "counter", "write batches flushed"),
    ("writes", "counter", "write requests (queue items) flushed"),
    ("entries", "counter", "log entries written (runs expanded)"),
    ("bytes_written", "counter", "bytes written"),
    ("fsyncs", "counter", "fsync calls"),
    ("fsync_time_us", "counter", "cumulative fsync time (us)"),
    ("batch_size", "gauge", "last batch size"),
    ("out_of_seq", "counter", "out-of-sequence writes detected"),
    ("rollovers", "counter", "WAL file rollovers"),
    ("failures", "counter", "I/O failures (WAL entered failed state)"),
    ("space_failures", "counter",
     "failures classified space-class (ENOSPC/EDQUOT): the node "
     "degrades and probe-resumes instead of restarting from disk"),
    ("group_commit_waits", "counter",
     "flushes that held the batch open coalescing an arriving burst "
     "(adaptive group commit; docs/INTERNALS.md §15)"),
    ("group_commit_delay_us", "gauge",
     "coalescing delay of the last flush (us; 0 = flushed immediately)"),
    ("native_batches", "counter",
     "batches persisted via the native serialize+write+fsync path"),
    ("native_fallbacks", "counter",
     "permanent flips off the native path (lib lost or framing format "
     "mismatch after construction) — nonzero means the Python fallback "
     "took over mid-run"),
]

# Flow-control / liveness counters for a batch coordinator's command
# lane (one vector per coordinator, name ("coordinator", node_name)).
# These are the gauges an operator watches for overload: rejects and
# drops mean clients are past the admission window; lane_wedges firing
# means accepted commands stopped committing (the watchdog recovers or
# bounds them instead of hanging clients).
COORDINATOR_FIELDS: List[FieldSpec] = [
    ("commands_rejected", "counter",
     "client commands rejected with overloaded (reject-with-backoff)"),
    ("commands_dropped_overload", "counter",
     "ack-free (noreply) commands dropped past the admission window"),
    ("commands_rejected_nospace", "counter",
     "client commands rejected with the typed RA_NOSPACE reason while "
     "the coordinator's storage plane was degraded or hard-watermarked"),
    ("snapshot_credits_granted", "counter",
     "chunk credits granted to snapshot senders (receiver-paced flow "
     "control; docs/INTERNALS.md §21)"),
    ("snapshot_credit_waits", "counter",
     "sender backoffs taken on credit starvation (receiver granted 0)"),
    ("snapshot_credit_window", "gauge",
     "last credit window granted by this coordinator's accept path"),
    ("pending_redirected", "counter",
     "pending client futures answered with a redirect on deposition/"
     "truncation instead of being silently dropped"),
    ("lane_wedges", "counter",
     "watchdog detections of a wedged command lane (accepted command, "
     "no commit progress within the deadline)"),
    ("lane_recoveries", "counter",
     "watchdog recovery attempts (re-step + peer resync probe)"),
    ("lane_redirects", "counter",
     "watchdog second-strike bounded failures (pending futures "
     "redirected so clients retry elsewhere)"),
    ("stale_peer_resends", "counter",
     "pipeline-window stalls against a silent peer resolved by an "
     "empty probe AER (its ack/reject hint resynchronizes match/next)"),
    ("commit_rate", "gauge",
     "aggregate applied-entries/sec across this coordinator's groups "
     "(leaky-integrator smoothed, sampled per tick — the batch-backend "
     "feed for placement/leader-balancing decisions)"),
    # -- lease-based local reads, batch backend (§20) -------------------
    ("read_lease_served", "counter",
     "consistent queries served locally under a valid group lease "
     "(checked against the vectorized (G,) expiry array)"),
    ("read_quorum_fallback", "counter",
     "consistent queries that fell back to a quorum heartbeat round"),
    ("read_lease_expirations", "counter",
     "group leases found lapsed at read admission"),
    ("read_lease_revocations", "counter",
     "group leases revoked on deposition/term-adoption/transfer/"
     "membership change"),
    ("read_stale_rejected", "counter",
     "bounded local queries rejected past max_staleness_s"),
    ("read_local_bounded", "counter",
     "local queries served under an explicit max_staleness_s bound"),
    ("pipeline_steps", "counter",
     "device steps dispatched via the pipelined wave loop (stage/"
     "finish drivers or the started two-stage loop); pair with "
     "pipeline_overlap_ns for how much host work each hid"),
    ("pipeline_overlap_ns", "counter",
     "host staging time (ingress drain + pack + dispatch) spent while "
     "a previous step's device compute / egress realisation was still "
     "in flight — the overlap the pipelined wave loop creates; 0 on "
     "the sequential loop (docs/INTERNALS.md §15)"),
    # -- async command plane (docs/INTERNALS.md §16) --------------------
    ("ingress_ring_msgs", "counter",
     "items drained from the lock-free ingress rings (a bulk fan-out "
     "or per-node batch counts as one item)"),
    ("ingress_ring_drains", "counter",
     "batched multi-lane ring drain passes run by the step thread"),
    ("ingress_ring_full", "counter",
     "publishes that hit a full ingress lane (backpressure: client "
     "commands reject through the admission path, lossy protocol "
     "traffic is counted and dropped, control messages gate-wait — "
     "never a silent drop)"),
    ("ingress_ring_lanes", "gauge",
     "ingress lanes registered (one per producer thread)"),
    ("ingress_overflow_msgs", "counter",
     "must-deliver items parked on the overflow queue after a full-"
     "lane publish (snapshot traffic, TimeoutNow, internal commands: "
     "never shed, never gate-waited — a foreign drainer thread parked "
     "on our gate while we park on its gate would deadlock)"),
    ("staging_passes", "counter",
     "ingest-only passes that folded drained work into the staged "
     "scatter buffers while a device step was still in flight"),
    ("staging_prezeroed", "counter",
     "mailbox pack buffers pre-zeroed inside the pipeline overlap "
     "window (the dispatch pass then packs into the spare buffer with "
     "no take/zero cost on the critical path)"),
    ("egress_thread_batches", "counter",
     "per-destination message batches shipped by the dedicated egress "
     "sender thread (off the step loop)"),
    ("egress_thread_msgs", "counter",
     "messages shipped by the dedicated egress sender thread"),
    ("egress_thread_ring_full", "counter",
     "egress handoffs that overflowed the bounded sender ring and were "
     "sent inline instead (bounded handoff never drops)"),
    ("step_wakeups", "counter",
     "times the idle step thread was woken (ring publish, WAL notify, "
     "egress realisation, stop) — the event-driven replacement for the "
     "old 50 ms timed polls"),
    ("step_spurious_wakeups", "counter",
     "wakeups that found no work (must stay 0 while idle: the "
     "zero-spurious-wakeups invariant of the async command plane)"),
    # -- native hot-loop runtime (docs/INTERNALS.md §18) ----------------
    ("native_classify_batches", "counter",
     "drain passes whose class partition ran in the native GIL-released "
     "classifier (rt_classify) instead of the per-item Python loop"),
    ("native_classify_items", "counter",
     "ring items partitioned by the native classifier"),
    ("native_pack_batches", "counter",
     "mailbox builds whose columnwise AER/reply encode ran as one "
     "native GIL-released scatter (rt_pack_mbox)"),
    ("native_pack_msgs", "counter",
     "mailbox messages encoded by the native pack scatter"),
    ("native_egress_batches", "counter",
     "per-destination egress batches sealed+framed in one native call "
     "(rt_seal_frames) on the sender path"),
    ("native_egress_frames", "counter",
     "wire frames produced by the native egress sealer"),
    ("native_fallbacks", "counter",
     "hot-loop iterations that took the byte-identical Python path "
     "while a native path was switched on (armed failpoints, "
     "out-of-range input, or a load failure after the switch)"),
]

# Per-node health-plane vector (name ("health", node_name); written
# only by the node's health scanner on its detector/tick thread). The
# scans==fetches invariant is the proof of the single-fetch-per-tick
# discipline the overhead guard relies on.
HEALTH_FIELDS: List[FieldSpec] = [
    ("health_scans", "counter", "health scans run (one per tick)"),
    ("health_fetches", "counter",
     "device/host mirror fetch operations (== health_scans proves the "
     "single-fetch-per-tick discipline)"),
    ("health_transitions", "counter", "anomaly state transitions"),
    ("health_stuck", "gauge", "groups currently classified stuck"),
    ("health_lagging", "gauge", "groups currently classified lagging"),
    ("health_flapping", "gauge", "groups currently classified flapping"),
    ("health_quiet", "gauge",
     "groups currently classified quiet (healthy)"),
    ("health_max_commit_gap", "gauge",
     "worst commit->apply gap across this node's groups"),
    ("health_max_match_gap", "gauge",
     "worst follower match gap across this node's led groups"),
    ("health_max_backlog", "gauge",
     "worst appended-but-unapplied admission backlog"),
    ("health_disk_pressure", "gauge",
     "node disk-pressure anomaly state (0=clear 1=soft 2=hard; "
     "hysteresis applied by the watermark controller, "
     "docs/INTERNALS.md §21)"),
    ("health_disk_transitions", "counter",
     "disk-pressure anomaly state transitions"),
]

# Per-watched-peer phi-accrual gauges (name ("phi", owner, target);
# written by the detector on whatever thread evaluates it). phi is a
# float: exported as phi * 1000 so the int64 slot keeps 3 decimals.
DETECTOR_FIELDS: List[FieldSpec] = [
    ("phi_milli", "gauge", "phi-accrual suspicion level x1000"),
    ("phi_suspect", "gauge", "1 while the peer is suspected, else 0"),
    ("phi_intervals", "gauge",
     "learned liveness-cadence samples in window"),
]

# Nemesis-plane vector (name ("nemesis", run_label); written by the
# nemesis Planner thread only). One inject/heal counter pair per fault
# dimension so a soak can prove every enabled dimension actually fired
# (a quiet schedule absorbing a dimension reads as injected == 0).
NEMESIS_FIELDS: List[FieldSpec] = [
    ("nemesis_partition_injected", "counter",
     "symmetric partitions injected"),
    ("nemesis_partition_healed", "counter", "symmetric partitions healed"),
    ("nemesis_oneway_injected", "counter",
     "one-way (asymmetric) partitions injected"),
    ("nemesis_oneway_healed", "counter", "one-way partitions healed"),
    ("nemesis_disk_injected", "counter",
     "disk failpoints armed (faults.py registry)"),
    ("nemesis_disk_healed", "counter", "disk failpoints disarmed"),
    ("nemesis_disk_full_injected", "counter",
     "ENOSPC/EDQUOT storms armed (storage-pressure survival plane)"),
    ("nemesis_disk_full_healed", "counter", "ENOSPC storms disarmed"),
    ("nemesis_slow_disk_injected", "counter",
     "fsync-latency brownout failpoints armed"),
    ("nemesis_slow_disk_healed", "counter",
     "fsync-latency failpoints disarmed"),
    ("nemesis_crash_injected", "counter",
     "node/coordinator crash-restarts injected"),
    ("nemesis_crash_healed", "counter",
     "crash-restart recoveries completed"),
    ("nemesis_membership_injected", "counter",
     "membership churn steps (remove+add cycles) injected"),
    ("nemesis_membership_healed", "counter",
     "membership churn steps completed (member rejoined)"),
    ("nemesis_overload_injected", "counter",
     "overload bursts (ack-free floods past the admission window)"),
    ("nemesis_overload_healed", "counter",
     "overload bursts drained (flood ended, lane live again)"),
    ("nemesis_modeflip_injected", "counter",
     "active-set step-mode flips injected (batch backend)"),
    ("nemesis_modeflip_healed", "counter",
     "active-set mode restored to its pre-fault value"),
    ("nemesis_heals_forced", "counter",
     "teardown heals forced on exit paths (0 unless a run exited with "
     "faults still armed — the heal-on-every-exit-path guarantee)"),
]

# Deterministic simulation plane (ra_tpu_torch/sim, docs/INTERNALS.md §19):
# one vector per sweep label, accumulated across every schedule the
# sweep explores — the observability contract the sim lane is gated on
# (scripts/obs_smoke.py / scripts/sim_sweep.sh).
SIM_FIELDS: List[FieldSpec] = [
    ("sim_schedules_run", "counter", "simulation schedules executed"),
    ("sim_schedules_failed", "counter",
     "schedules whose oracle found a violation"),
    ("sim_steps_executed", "counter",
     "virtual-time events executed across all schedules"),
    ("sim_msgs_delivered", "counter", "network messages delivered"),
    ("sim_msgs_dropped", "counter",
     "messages dropped (blocked pairs + schedule drops)"),
    ("sim_msgs_duplicated", "counter", "duplicate deliveries injected"),
    ("sim_msgs_delayed", "counter", "deliveries given a schedule delay"),
    ("sim_shrink_iterations", "counter",
     "delta-debugging replays run while minimizing failures"),
    ("sim_minimized_ops", "counter",
     "ops in the last minimized repro schedule"),
    ("sim_virtual_ms", "counter", "virtual milliseconds simulated"),
    ("sim_disk_exhaustions", "counter",
     "simulated nodes that ran out of their disk byte budget"),
    ("sim_disk_parked_writes", "counter",
     "write confirmations parked while a sim node was space-degraded"),
]

# Session/lock-service machine (ra_tpu_torch/models/session.py). The vector
# is owned by whoever constructs the machine (harness, sim world,
# smoke gate) — replicas constructed WITHOUT one stay silent, so a
# 3-replica fold does not triple-count.
SESSION_FIELDS: List[FieldSpec] = [
    ("session_opens", "counter", "sessions opened"),
    ("session_renews", "counter", "lease renewals"),
    ("session_closes", "counter", "clean session closes"),
    ("session_expiries_ttl", "counter",
     "sessions expired by TTL lapse (machine timer)"),
    ("session_expiries_down", "counter",
     "sessions expired by monitor DOWN"),
    ("session_lock_acquires", "counter", "lock grants (immediate)"),
    ("session_lock_waits", "counter", "lock requests queued behind a holder"),
    ("session_lock_releases", "counter", "explicit lock releases"),
    ("session_lock_steals", "counter", "locks stolen from a live holder"),
    ("session_lock_handoffs", "counter",
     "locks handed to a queued waiter after release/expiry"),
]

SEGMENT_WRITER_FIELDS: List[FieldSpec] = [
    ("mem_tables_flushed", "counter", "memtable flush jobs"),
    ("entries_flushed", "counter", "entries flushed to segments"),
    ("segments_created", "counter", "segment files created"),
    ("bytes_flushed", "counter", "bytes flushed"),
    ("flush_errors", "counter", "flush jobs that raised (retried/retained)"),
]


class Counters:
    """A fixed set of int64 slots addressed by field name."""

    __slots__ = ("name", "fields", "_idx", "arr")

    def __init__(self, name, fields: Sequence[FieldSpec]):
        self.name = name
        self.fields = list(fields)
        self._idx: Dict[str, int] = {f[0]: i for i, f in enumerate(self.fields)}
        self.arr = np.zeros(len(self.fields), dtype=np.int64)

    def incr(self, field: str, n: int = 1) -> None:
        self.arr[self._idx[field]] += n

    def put(self, field: str, v: int) -> None:
        self.arr[self._idx[field]] = v

    def get(self, field: str) -> int:
        return int(self.arr[self._idx[field]])

    def to_dict(self) -> Dict[str, int]:
        return {f[0]: int(self.arr[i]) for i, f in enumerate(self.fields)}

    def describe(self) -> List[Dict[str, object]]:
        """Field metadata + current values: [{name, kind, help, value}]
        — the exposition shape (``overview()`` drops kind/help; scrape
        surfaces need them for TYPE/HELP lines)."""
        return [
            {"name": f[0], "kind": f[1], "help": f[2], "value": int(self.arr[i])}
            for i, f in enumerate(self.fields)
        ]


class CounterRegistry:
    """Process-global registry: name -> Counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tab: Dict[object, Counters] = {}

    def new(self, name, fields: Sequence[FieldSpec]) -> Counters:
        with self._lock:
            c = self._tab.get(name)
            if c is None:
                c = Counters(name, fields)
                self._tab[name] = c
            elif [f[0] for f in c.fields] != [f[0] for f in fields]:
                # replacing a live counters object would zero its values and
                # orphan existing holders — make the conflict loud instead
                raise ValueError(
                    f"counters {name!r} already registered with a different field set"
                )
            return c

    def fetch(self, name) -> Optional[Counters]:
        # take the lock like new()/delete(): a bare dict read can race a
        # concurrent resize (delete+new) and CPython only guarantees
        # atomicity for builtin-key gets — registry keys are tuples of
        # arbitrary objects
        with self._lock:
            return self._tab.get(name)

    def delete(self, name) -> None:
        with self._lock:
            self._tab.pop(name, None)

    def overview(self) -> Dict[object, Dict[str, int]]:
        return {k: v.to_dict() for k, v in list(self._tab.items())}

    def describe_overview(self) -> Dict[object, List[Dict[str, object]]]:
        """Exposition overview: every registered vector with field kind
        and help text alongside the values (what ``overview()`` drops)."""
        with self._lock:
            items = list(self._tab.items())
        return {k: v.describe() for k, v in items}

    def names(self) -> List[object]:
        return list(self._tab.keys())


_global = CounterRegistry()


def registry() -> CounterRegistry:
    return _global


def new(name, fields: Sequence[FieldSpec] = RA_SERVER_FIELDS) -> Counters:
    return _global.new(name, fields)


def fetch(name) -> Optional[Counters]:
    return _global.fetch(name)


def delete(name) -> None:
    _global.delete(name)


def overview() -> Dict[object, Dict[str, int]]:
    return _global.overview()
