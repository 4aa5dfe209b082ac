"""Randomized KV/FIFO consistency harness over the composable nemesis.

The counterpart of the reference's shipped ``ra_kv_harness``
(reference: ``src/ra_kv_harness.erl:21-35`` — a long-running loop of
random put/get/delete, member add/remove, partitions and restarts
against a reference map, with consistency-failure detection). Runs
against either execution backend:

- ``per_group_actor``: full fault mix — partitions, member restarts,
  membership changes, and (``disk_faults=True``) seeded failpoint
  storms against the storage stack (fsync failures, torn writes,
  ENOSPC, infra-thread crashes — healed by the node's supervision);
- ``tpu_batch``: partitions + membership churn, plus
  (``restarts=True``) coordinator crash-restarts over WAL-backed
  logs — the whole coordinator is torn down and rebuilt from
  WAL/meta/segments, the crash-restart nemesis of VERDICT item 7 —
  and the same ``disk_faults`` dimension (a failed WAL on a batch
  node triggers a crash-restart from last-known-durable state).

Fault execution lives in ``ra_tpu_torch.nemesis``: each dimension is a
``Dimension`` object behind a seeded ``Planner`` whose context manager
guarantees heal + ``disarm_all`` on EVERY exit path. Flag-gated runs
fire single dimensions from the legacy workload dice (seed-compatible);
``combined=True`` lets the planner's own schedule interleave ALL
dimensions at once — including one-way partitions, overload bursts and
(batch) live active-set mode flips — which is the soak regime.

Two workloads:

- ``workload="kv"`` (default): random put/delete/get against
  ``DictKv`` with an uncertainty-tracking reference model;
- ``workload="fifo"``: the ``FifoMachine`` queue — enqueue/checkout/
  settle/return/consumer-down with a client-side checker asserting
  zero lost and zero duplicated settled messages, then a full drain
  plus a release-cursor reclamation check.

Semantics: commands that time out MAY still have committed — the model
tracks such keys as "uncertain" and accepts either outcome until the
next successful write resolves them (the same at-least-once accounting
the reference harness uses). Fifo enqueues are sent WITHOUT retry so an
ack means exactly-one application and the duplicate check is strict.

Usage (tests call ``run`` directly; ops can run it standalone)::

    result = run(seed=7, n_ops=300, backend="per_group_actor")
    assert result.consistent, result.failures
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time
from typing import Any, Dict, List, Optional, Tuple

from ra_tpu_torch import api, faults, leaderboard
from ra_tpu_torch import nemesis as nem
from ra_tpu_torch.machine import Machine
from ra_tpu_torch.models.fifo import FifoMachine
from ra_tpu_torch.protocol import Command, ElectionTimeout, ServerId, USR
from ra_tpu_torch.runtime.transport import registry as node_registry
from ra_tpu_torch.system import SystemConfig


class DictKv(Machine):
    """Plain replicated map: ("put", k, v) | ("delete", k) |
    ("incr", k, n). The incr op makes duplicate application VISIBLE
    (a re-applied put is indistinguishable from one apply; a re-applied
    incr inflates the total) — the overload dimension leans on it to
    assert zero lost/duplicated acked commands."""

    def init(self, config):
        return {}

    def apply(self, meta, cmd, state):
        if isinstance(cmd, tuple) and cmd:
            op = cmd[0]
            if op == "put":
                state = dict(state)
                state[cmd[1]] = cmd[2]
                return state, ("ok", cmd[2]), []
            if op == "delete":
                state = dict(state)
                state.pop(cmd[1], None)
                return state, ("ok", None), []
            if op == "incr":
                state = dict(state)
                state[cmd[1]] = state.get(cmd[1], 0) + cmd[2]
                return state, ("ok", state[cmd[1]]), []
        return state, None, []

    def apply_many(self, meta, cmds, state):
        state = dict(state)
        for cmd in cmds:
            if isinstance(cmd, tuple) and cmd:
                if cmd[0] == "put":
                    state[cmd[1]] = cmd[2]
                elif cmd[0] == "delete":
                    state.pop(cmd[1], None)
                elif cmd[0] == "incr":
                    state[cmd[1]] = state.get(cmd[1], 0) + cmd[2]
        return state


def _kv_factory(config):
    return DictKv()


def _fifo_factory(config):
    return FifoMachine()


@dataclasses.dataclass
class HarnessResult:
    consistent: bool
    failures: List[str]
    ops: Dict[str, int]
    final_model: Dict[str, Any]
    # per-dimension nemesis counter deltas for THIS run (the soak
    # asserts every enabled dimension actually fired) and the planner's
    # replayable action schedule (part of the repro bundle)
    nemesis: Dict[str, int] = dataclasses.field(default_factory=dict)
    schedule: List[Tuple] = dataclasses.field(default_factory=list)


# the menu moved to the nemesis plane; kept as an alias for callers
# that imported it from here
_DISK_FAULT_MENU = nem.DISK_FAULT_MENU

# key the ack-free combined-mode overload bursts increment: its final
# value is unknowable a priori (drops are legal), so the model skips it
# and the harness bounds it by the delivered count instead
_BURST_KEY = "nb_flood"


def _stable(state: Dict[str, Any]) -> Dict[str, Any]:
    """Project out the burst counter for replica-convergence compares:
    stragglers from an ack-free burst may commit AFTER the final
    consistent read, so the key moves under the comparison."""
    return {k: v for k, v in state.items() if k not in _Model.IGNORED}


def run(
    seed: int = 0,
    n_ops: int = 200,
    backend: str = "per_group_actor",
    nodes: int = 3,
    data_dir: Optional[str] = None,
    partitions: bool = True,
    restarts: Optional[bool] = None,
    membership: bool = True,
    op_timeout: float = 10.0,
    rescue: bool = False,
    disk_faults: bool = False,
    disk_full: bool = False,
    slow_disk: bool = False,
    overload: bool = False,
    rings: bool = True,
    workload: str = "kv",
    combined: bool = False,
    native: str = "auto",
    lease: bool = False,
    device=None,
) -> HarnessResult:
    """``rescue=True`` lets the harness fire operator election kicks on
    a stuck deployment (useful when hunting consistency bugs past a
    known liveness one). The CI default is False: the cluster must
    recover liveness on its own after nemesis heals — the reference's
    harness has no kick either (nemesis heals partitions only,
    test/nemesis.erl:29-33).

    ``disk_faults=True`` adds a seeded storage-nemesis dimension: ops
    occasionally arm a failpoint (fsync failure, torn write, ENOSPC,
    infra-thread crash — ``nemesis.DISK_FAULT_MENU``) against a random
    node's storage. On the batch backend, ``restarts=True`` and/or
    ``disk_faults=True`` switch the groups onto WAL-backed logs and add
    coordinator crash-restarts recovering from disk.

    ``combined=True`` is the soak regime: EVERY dimension is enabled at
    once — symmetric AND one-way partitions, disk faults, crash-
    restarts, membership churn, ack-free overload bursts, (batch) live
    active-set mode flips — and fault scheduling moves to the planner's
    own seeded rng, so the nemesis schedule is replayable from the seed
    alone. ``workload`` picks the machine under test ("kv" | "fifo").

    ``rings=False`` runs the batch backend on the lock+deque control
    command plane instead of the lock-free ingress rings (docs/
    INTERNALS.md §16) — the soak's A/B escape hatch; the actor backend
    ignores it. ``native`` selects the batch coordinator's native
    hot-loop runtime paths (docs/INTERNALS.md §18; "auto"/"off" or a
    comma list of pack,classify,egress) — the soak grid runs both so
    the disk-fault/torn-write failpoints are proven to bite through the
    native fallback seam.

    ``disk_full=True`` adds the storage-pressure survival dimension
    (docs/INTERNALS.md §21): persistent ENOSPC/EDQUOT storms against a
    random node's WAL. The node must flip into ``storage_degraded``
    (typed RA_NOSPACE rejects, heartbeats/elections/lease reads keep
    running), survive the storm with zero acked writes lost, and
    auto-resume once the storm heals — the flight-recorder dump on
    failure interleaves the ``storage_degraded``/``storage_resumed``
    transitions with the nemesis schedule. ``slow_disk=True`` arms
    persistent fsync-latency faults instead; on the actor backend the
    nodes run with a lowered brownout threshold so the nemesis
    latencies (20-50 ms) trip the detector and shed leadership.

    ``lease=True`` is the linearizable-read dimension (docs/
    INTERNALS.md §20): servers run with clock-bound leader leases so
    consistent reads serve locally, one-way partitions join the nemesis
    mix, and the workload periodically forces a deposition via
    ``api.transfer_leadership`` mid-read-stream — every consistent read
    is still checked against the reference model, so a lease that
    outlives its leader shows up as a stale read.

    ``device`` places the batch backend's coordinators (``None``:
    ``"cuda"``); the actor backend is host-only and ignores it."""
    if combined:
        partitions = True
        membership = True
        disk_faults = True
        restarts = True
    if restarts is None:
        # backend defaults: member restarts have always been part of the
        # actor mix; batch coordinator crash-restarts (WAL-backed
        # storage) are opt-in — they change the storage substrate
        restarts = backend == "per_group_actor"
    if workload not in ("kv", "fifo"):
        raise ValueError(f"unknown workload {workload!r}")
    if backend == "per_group_actor":
        return _run_actor(seed, n_ops, nodes, data_dir, partitions, restarts,
                          membership, op_timeout, rescue, disk_faults,
                          disk_full=disk_full, slow_disk=slow_disk,
                          overload=overload, workload=workload,
                          combined=combined, lease=lease)
    if backend == "tpu_batch":
        return _run_batch(seed, n_ops, nodes, partitions, membership,
                          op_timeout, rescue, restarts=restarts,
                          disk_faults=disk_faults, disk_full=disk_full,
                          slow_disk=slow_disk, data_dir=data_dir,
                          overload=overload, rings=rings, workload=workload,
                          combined=combined, native=native, lease=lease,
                          device=device)
    raise ValueError(f"unknown backend {backend!r}")


class _Model:
    """Reference map with uncertainty tracking for timed-out writes."""

    # ack-free burst traffic: delivery count is bounded, not exact
    IGNORED = frozenset({_BURST_KEY})

    def __init__(self) -> None:
        self.sure: Dict[str, Any] = {}
        self.maybe: Dict[str, set] = {}  # key -> set of acceptable values
        self.failures: List[str] = []

    def applied(self, cmd) -> None:
        k = cmd[1]
        if cmd[0] == "put":
            self.sure[k] = cmd[2]
        else:
            self.sure.pop(k, None)
        self.maybe.pop(k, None)

    def uncertain(self, cmd) -> None:
        k = cmd[1]
        cur = self.maybe.setdefault(
            k, {self.sure[k]} if k in self.sure else {None}
        )
        cur.add(cmd[2] if cmd[0] == "put" else None)

    def check_read(self, k, v, where: str) -> None:
        if k in self.maybe:
            # a stranded timed-out write may still commit later
            # (at-least-once): the key stays uncertain until the next
            # SUCCESSFUL write resolves it — a read must not pin it
            ok = v in self.maybe[k]
        else:
            ok = self.sure.get(k) == v
        if not ok:
            self.failures.append(
                f"{where}: key {k!r} read {v!r}, model "
                f"{self.maybe.get(k, self.sure.get(k))!r}"
            )

    def check_state(self, state: Dict[str, Any], where: str) -> None:
        keys = set(self.sure) | set(self.maybe) | set(state)
        for k in keys:
            if k in self.IGNORED:
                continue
            self.check_read(k, state.get(k), where)


# overload phase sizing: the backends under overload=True are built
# with max_command_backlog=_OVERLOAD_BACKLOG, and the flood below is
# sized to blow well past it
_OVERLOAD_BACKLOG = 64
_OVERLOAD_CLIENTS = 4
_OVERLOAD_OPS = 30
_OVERLOAD_FLOOD = 600


def _overload_phase(model, cluster, op_timeout, counts, seed) -> None:
    """Drive the cluster PAST the admission window and assert the
    flow-control contract:

    - bounded latency: every acked incr completed inside op_timeout and
      the whole phase inside a fixed deadline (no silent 10 s hangs);
    - zero lost acked commands and zero duplicated commands: the final
      consistent total of the incr key must land in
      [n_acked, n_acked + n_uncertain] — a lost ack undershoots, ANY
      duplicate application overshoots;
    - the window really was exceeded: the admission counters
      (rejected/dropped/throttled) must have fired somewhere.

    Runs on a healed cluster after the nemesis loop; talks only to the
    public api surface, so it is backend-agnostic."""
    import threading

    from ra_tpu_torch import counters as ra_counters

    def _admission_totals() -> int:
        total = 0
        for vals in ra_counters.overview().values():
            for f in ("commands_rejected", "commands_dropped_overload",
                      "throttled"):
                total += vals.get(f, 0)
        return total

    before = _admission_totals()
    win = api.AdmissionWindow(16, name=f"kvh_overload_{seed}")
    lock = threading.Lock()
    acked = [0]
    uncertain = [0]
    lats: List[float] = []
    t_phase = time.monotonic()

    def client(ci: int) -> None:
        for _ in range(_OVERLOAD_OPS):
            if not win.acquire(timeout=op_timeout):
                continue  # never admitted: provably no effect
            t0 = time.monotonic()
            try:
                api.process_command(
                    cluster[ci % len(cluster)], ("incr", "ov_total", 1),
                    timeout=op_timeout,
                )
                with lock:
                    acked[0] += 1
                    lats.append(time.monotonic() - t0)
            except Exception:  # noqa: BLE001 — may or may not commit
                with lock:
                    uncertain[0] += 1
            finally:
                win.release()

    threads = [
        threading.Thread(target=client, args=(ci,), daemon=True)
        for ci in range(_OVERLOAD_CLIENTS)
    ]
    for t in threads:
        t.start()
    # ack-free flood straight past the server admission window: these
    # may be DROPPED (counted) but must never duplicate — the final
    # ov_flood total is bounded by the flood size. The flood lands in
    # BURSTS (api._try_send_many: one ingress handoff per chunk) so the
    # append side sees window-sized batches — with the event-driven
    # command plane draining per publish, a one-at-a-time flood gets
    # absorbed at line rate and the window is never exceeded
    flood_cmd_total = 0
    flood_cmd = Command(kind=USR, data=("incr", "ov_flood", 1),
                        reply_mode="noreply")
    chunk = [flood_cmd] * (_OVERLOAD_BACKLOG * 3)
    for _ in range(_OVERLOAD_FLOOD // len(chunk) + 1):
        # the flood must actually land on the LEADER: after a nemesis
        # with membership ops, leadership may sit on a node outside the
        # original member list (a joined spare) — followers just
        # redirect ack-free commands, and a flood that only ever hits
        # followers never exceeds anyone's window (this was a real
        # flake: 3/3 soak seeds failed the counters-fired assert
        # whenever the spare led)
        targets = set(cluster)
        cl_name = api._cluster_of(cluster[0])
        lead = leaderboard.lookup_leader(cl_name) if cl_name else None
        if lead is not None:
            targets.add(lead)
        for sid in targets:
            flood_cmd_total += api._try_send_many(sid, chunk)
    for t in threads:
        t.join(timeout=op_timeout * _OVERLOAD_OPS)
    phase_s = time.monotonic() - t_phase
    counts["overload_acked"] = acked[0]
    counts["overload_uncertain"] = uncertain[0]
    # settle: the admitted backlog must drain
    final = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            out = api.consistent_query(cluster[0], lambda s: dict(s),
                                       timeout=op_timeout)
            total = out[1].get("ov_total", 0)
            if total >= acked[0]:
                final = out[1]
                break
        except Exception:  # noqa: BLE001
            pass
        time.sleep(0.2)
    if final is None:
        model.failures.append("overload: cluster never drained the backlog")
        return
    total = final.get("ov_total", 0)
    if not (acked[0] <= total <= acked[0] + uncertain[0]):
        model.failures.append(
            f"overload: acked={acked[0]} uncertain={uncertain[0]} but "
            f"ov_total={total} — lost or duplicated acked commands"
        )
    flood_total = final.get("ov_flood", 0)
    if flood_total > flood_cmd_total:
        model.failures.append(
            f"overload: ov_flood={flood_total} > {flood_cmd_total} "
            f"delivered — duplicated ack-free commands"
        )
    # +0.5s slack: process_command's last attempt may legitimately
    # return "ok" ~50ms past the nominal deadline (its per-attempt wait
    # floors at 0.05s), plus scheduling jitter on a loaded box
    if lats and max(lats) > op_timeout + 0.5:
        model.failures.append(
            f"overload: acked latency {max(lats):.1f}s exceeded "
            f"op_timeout {op_timeout}s"
        )
    if phase_s > 120:
        model.failures.append(
            f"overload: phase took {phase_s:.0f}s — unbounded queueing"
        )
    if _admission_totals() <= before:
        model.failures.append(
            "overload: admission counters never fired — the phase did "
            "not exceed the window (cap too high or flood too small)"
        )


# ---------------------------------------------------------------------------
# fifo workload (the second harnessed workload, over FifoMachine)


def _fifo_summary(s):
    """Deterministic replica fingerprint of a FifoState (used for the
    converged-replicas check on both backends)."""
    return (s.next_msg_id, tuple(s.queue),
            tuple(sorted((c, tuple(sorted(f.items())))
                         for c, f in s.consumers.items())))


def _snapshot_floors(cluster, timeout: float = 2.0) -> List[int]:
    """Per-member log snapshot floor via state_query (works on both
    backends: the actor proc hands ``fn`` the Server, the batch
    coordinator hands it the GroupHost — both expose ``.log``)."""
    floors: List[int] = []
    for sid in list(cluster):
        fut = api.Future()
        if not api._try_send(
                sid, ("state_query",
                      lambda s: s.log.snapshot_index_term(), fut)):
            continue
        try:
            out = fut.result(timeout)
        except Exception:  # noqa: BLE001 — member busy/partitioned
            continue
        if out and out[0] == "ok":
            it = out[1]
            floors.append(it[0] if it else 0)
    return floors


class _FifoWorkload:
    """Client pool + invariant checker for the fifo machine.

    Accounting rules:

    - enqueues go through ``send_once`` (NO retry): an ack means the
      command applied exactly once, so a payload ever delivered under
      two distinct msg_ids is a DUPLICATED application — hard failure;
    - settle/checkout/return/down are idempotent under at-least-once,
      so they use the retrying sender;
    - an acked enqueue whose payload is never delivered by the end of
      the final drain is a LOST message — hard failure;
    - redeliveries (same msg_id seen again after a ``down`` requeue or
      ``return``) are the EXPECTED at-least-once behavior and are
      counted, not failed.
    """

    N_CONSUMERS = 4

    def __init__(self, seed, failures, send, send_once, cquery) -> None:
        import threading

        self.seed = seed
        self.failures = failures
        self.send = send            # retrying send: idempotent ops only
        self.send_once = send_once  # single attempt: enqueue
        self.cquery = cquery
        self.lock = threading.Lock()
        self.inbox: collections.deque = collections.deque()
        self.cids = [f"c{j}" for j in range(self.N_CONSUMERS)]
        self.drain_cid = "drain"
        self.active: set = set()
        self.pending: Dict[str, Dict[int, Any]] = {}
        self.payload_ids: Dict[str, set] = {}
        self.delivered: Dict[int, int] = {}
        self.acked_enq: set = set()
        self.uncertain_enq: set = set()
        self.settled: set = set()
        self.redeliveries = 0

    # -- delivery sink (called from node/coordinator threads) ----------

    def on_delivery(self, cid, msgs) -> None:
        with self.lock:
            for m in msgs:
                self.inbox.append((cid, m))

    def pump(self) -> None:
        """Fold received deliveries into client state (harness thread)."""
        with self.lock:
            items = list(self.inbox)
            self.inbox.clear()
        for cid, m in items:
            if not (isinstance(m, tuple) and len(m) == 3
                    and m[0] == "delivery"):
                continue
            _, msg_id, payload = m
            ids = self.payload_ids.setdefault(payload, set())
            ids.add(msg_id)
            if len(ids) > 1:
                self.failures.append(
                    f"fifo: payload {payload!r} delivered under msg_ids "
                    f"{sorted(ids)} — an enqueue applied more than once")
            n = self.delivered.get(msg_id, 0)
            self.delivered[msg_id] = n + 1
            if n:
                self.redeliveries += 1
            if cid in self.active:
                self.pending.setdefault(cid, {})[msg_id] = payload

    # -- one workload op ----------------------------------------------

    def op(self, rng, op_i, r: float) -> None:
        """``r`` is the workload roll normalized to [0, 1)."""
        self.pump()
        if r < 0.50:
            payload = f"p{self.seed}_{op_i}"
            try:
                self.send_once(("enqueue", payload))
                self.acked_enq.add(payload)
            except Exception:  # noqa: BLE001 — may or may not commit
                self.uncertain_enq.add(payload)
        elif r < 0.62:
            cid = rng.choice(self.cids)
            credit = rng.choice((1, 2, 3, 5))
            try:
                self.send(("checkout", cid, credit))
                self.active.add(cid)
                self.pending.setdefault(cid, {})
            except Exception:  # noqa: BLE001 — uncertain: the consumer
                pass           # may exist; final_check downs every cid
        elif r < 0.84:
            cands = [(c, m) for c, mm in self.pending.items() for m in mm]
            if cands:
                cid, mid = cands[rng.randrange(len(cands))]
                try:
                    self.send(("settle", cid, mid))
                    self.pending[cid].pop(mid, None)
                    self.settled.add(mid)
                except Exception:  # noqa: BLE001 — stays pending;
                    pass           # settle is idempotent, retried later
        elif r < 0.89:
            cands = [(c, m) for c, mm in self.pending.items() for m in mm]
            if cands:
                cid, mid = cands[rng.randrange(len(cands))]
                try:
                    self.send(("return", cid, mid))
                    self.pending[cid].pop(mid, None)  # redelivery re-adds
                except Exception:  # noqa: BLE001
                    pass
        elif r < 0.93:
            if self.active:
                cid = rng.choice(sorted(self.active))
                try:
                    self.send(("down", cid, "nemesis"))
                except Exception:  # noqa: BLE001 — final_check re-downs
                    pass
                self.active.discard(cid)
                self.pending.pop(cid, None)
        else:
            # spot invariant: every acked enqueue must already be applied
            try:
                applied = self.cquery(lambda s: s.next_msg_id) - 1
                if applied < len(self.acked_enq):
                    self.failures.append(
                        f"fifo op{op_i}: {len(self.acked_enq)} acked "
                        f"enqueues but only {applied} applied — lost acks")
            except Exception:  # noqa: BLE001 — no leader right now
                pass

    # -- final conservation check -------------------------------------

    def final_check(self, cluster, tick=None) -> None:
        """On the healed cluster: tear down every consumer ever touched
        (``down`` is idempotent, so uncertain checkouts are covered),
        drain the queue through a fresh wide-credit consumer, then
        assert conservation — every acked payload delivered, none
        duplicated — and that the final release cursor actually
        reclaimed the log (snapshot floor advanced)."""
        failures = self.failures
        self.pump()
        for cid in self.cids:
            try:
                self.send(("down", cid, "teardown"))
            except Exception:  # noqa: BLE001
                failures.append(
                    f"fifo: teardown down({cid!r}) never committed")
        self.active.clear()
        self.pending = {}
        try:
            self.send(("checkout", self.drain_cid, 4096))
        except Exception:  # noqa: BLE001
            failures.append("fifo: drain consumer checkout never committed")
            return
        self.active.add(self.drain_cid)
        self.pending.setdefault(self.drain_cid, {})
        emptied = False
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if tick is not None:
                tick()
            self.pump()
            mm = self.pending.get(self.drain_cid, {})
            for mid in list(mm):
                try:
                    self.send(("settle", self.drain_cid, mid))
                    mm.pop(mid, None)
                    self.settled.add(mid)
                except Exception:  # noqa: BLE001
                    pass
            try:
                ready, inflight = self.cquery(
                    lambda s: (len(s.queue),
                               sum(len(f) for f in s.consumers.values())))
                if ready == 0 and inflight == 0:
                    emptied = True
                    break
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.05)
        if not emptied:
            failures.append(
                "fifo: drain never emptied the queue — messages stuck "
                "in ready/in-flight after heal")
        lost = self.acked_enq - set(self.payload_ids)
        if lost:
            failures.append(
                f"fifo: {len(lost)} acked enqueues never delivered "
                f"(lost): {sorted(lost)[:5]}")
        if emptied and self.settled:
            # the settle that emptied the queue emitted ReleaseCursor on
            # every replica: some member's log snapshot floor must
            # advance past 0 (snapshot install may lag the apply)
            floor = 0
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                floor = max(_snapshot_floors(cluster) or [0])
                if floor > 0:
                    break
                time.sleep(0.2)
            if floor <= 0:
                failures.append(
                    "fifo: drained + settled but no replica's snapshot "
                    "floor advanced — release-cursor truncation never "
                    "reclaimed the log")


# ---------------------------------------------------------------------------
# backends


def _run_actor(seed, n_ops, nodes, data_dir, partitions, restarts,
               membership, op_timeout, rescue=False,
               disk_faults=False, disk_full=False, slow_disk=False,
               overload=False, workload="kv",
               combined=False, lease=False) -> HarnessResult:
    import tempfile

    from ra_tpu_torch.machine import register_machine_factory

    register_machine_factory("ra_tpu_kv_harness", _kv_factory)
    register_machine_factory("ra_tpu_fifo_harness", _fifo_factory)
    mach_cls = FifoMachine if workload == "fifo" else DictKv
    factory_name = ("ra_tpu_fifo_harness" if workload == "fifo"
                    else "ra_tpu_kv_harness")
    rng = random.Random(seed)
    base = data_dir or tempfile.mkdtemp(prefix="ra_kv_harness_")
    names = [f"kvh{seed}_{i}" for i in range(nodes + 1)]  # +1 spare for joins
    for n in names:
        api.start_node(
            n, SystemConfig(
                name=f"kvh{seed}", data_dir=f"{base}/{n}",
                default_max_command_backlog=(
                    _OVERLOAD_BACKLOG if (overload or combined) else 4096
                ),
                # production logs batch release cursors into 4096-entry
                # snapshots; at harness scale that hides reclamation —
                # snapshot on every cursor so the fifo checker can see it
                min_snapshot_interval=1,
                # the slow_disk nemesis delays fsync by 20-50 ms — well
                # under the production 200 ms brownout threshold, so the
                # lane lowers it (and ticks faster) to prove the
                # detect->shed->recover loop end to end
                brownout_enter_us=10_000.0 if slow_disk else 200_000.0,
                brownout_exit_us=2_000.0 if slow_disk else 50_000.0,
                disk_check_interval_s=0.1 if slow_disk else 1.0,
            ),
            election_timeout_s=0.15, tick_interval_s=0.1, detector_poll_s=0.05,
        )
    ids = [(f"kv{i}", names[i]) for i in range(nodes)]
    spare = (f"kv{nodes}", names[nodes])
    cluster = list(ids)
    extra_cfg = {"lease": True} if lease else None
    api.start_cluster(f"kvhc{seed}", mach_cls, ids, timeout=20,
                      extra_cfg=extra_cfg)
    model = _Model()
    counts: Dict[str, int] = {}
    # rescue randomness separate from the workload stream (seed
    # determinism of the op sequence survives wall-clock rescues)
    rescue_rng = random.Random(seed ^ 0x5EED)
    consecutive_failures = [0]

    # -- nemesis context: how each dimension executes on this backend --

    def _block(a, b):
        na = node_registry().get(a)
        if na is not None:
            na.transport.block(a, b)

    def _unblock_all():
        for n in names:
            node = node_registry().get(n)
            if node is not None:
                node.transport.unblock_all()

    def _restart(victim):
        counts["restart_fired"] = counts.get("restart_fired", 0) + 1
        sid = next(s for s in cluster if s[1] == victim)
        try:
            api.restart_server(sid)
        except Exception:  # noqa: BLE001
            pass

    def _membership_step():
        try:
            if spare in cluster and len(cluster) > 3:
                out = api.remove_member(cluster[0], spare,
                                        timeout=op_timeout)
                if out[0] == "ok":
                    node = node_registry().get(spare[1])
                    if node is not None and spare[0] in node.procs:
                        node.stop_server(spare[0])
                    cluster.remove(spare)
                    return "remove"
            elif spare not in cluster:
                api.start_server(
                    spare, f"kvhc{seed}", None, cluster + [spare],
                    machine_factory=factory_name, extra_cfg=extra_cfg,
                )
                out = api.add_member(cluster[0], spare, timeout=op_timeout)
                if out[0] == "ok":
                    cluster.append(spare)
                    return "add"
        except Exception:  # noqa: BLE001 — change may be rejected
            pass
        return None

    burst_sent = [0]
    burst_data = (("settle", "__burst__", 0) if workload == "fifo"
                  else ("incr", _BURST_KEY, 1))

    def _overload_burst():
        cmd = Command(kind=USR, data=burst_data, reply_mode="noreply")
        chunk = [cmd] * _OVERLOAD_BACKLOG
        targets = set(cluster)
        cl_name = api._cluster_of(cluster[0])
        lead = leaderboard.lookup_leader(cl_name) if cl_name else None
        if lead is not None:
            targets.add(lead)
        sent = 0
        for sid in targets:
            sent += api._try_send_many(sid, chunk)
        burst_sent[0] += sent
        return sent

    dims = nem.standard_dimensions(
        partitions=partitions, oneway=combined or lease,
        disk_faults=disk_faults, disk_full=disk_full, slow_disk=slow_disk,
        restarts=restarts, membership=membership, overload=combined,
        mode_flips=False)
    ctx = nem.NemesisContext(
        peers=lambda: list(names),
        members=lambda: [n for _, n in cluster],
        block=_block, unblock_all=_unblock_all,
        restart=_restart, membership_step=_membership_step,
        fault_scopes=lambda: names[:nodes],
        overload_burst=_overload_burst)
    planner = nem.Planner(ctx, seed, f"kvh{seed}", dims)
    ctr0 = planner.counters()

    def write(cmd):
        try:
            reply, _ = api.process_command(
                rng.choice(cluster), cmd, timeout=op_timeout,
                retry_on_timeout=True,
            )
            model.applied(cmd)
            consecutive_failures[0] = 0
        except Exception:  # noqa: BLE001 — may or may not have committed
            model.uncertain(cmd)
            consecutive_failures[0] += 1

    if workload == "fifo":
        def _send(cmd):
            try:
                api.process_command(rng.choice(cluster), cmd,
                                    timeout=op_timeout, retry_on_timeout=True)
                consecutive_failures[0] = 0
            except Exception:
                consecutive_failures[0] += 1
                raise

        def _send_once(cmd):
            try:
                api.process_command(rng.choice(cluster), cmd,
                                    timeout=op_timeout)
                consecutive_failures[0] = 0
            except Exception:
                consecutive_failures[0] += 1
                raise

        fifo = _FifoWorkload(
            seed, model.failures, _send, _send_once,
            lambda fn: api.consistent_query(cluster[0], fn,
                                            timeout=op_timeout)[1])
        # node-level sinks survive server restarts AND membership churn:
        # register every consumer on every node (incl. the spare) so the
        # delivery effect finds its client wherever the leader sits
        for n in names:
            for cid in fifo.cids + [fifo.drain_cid]:
                api.register_client(
                    n, cid,
                    (lambda c: lambda _sid, msgs:
                        fifo.on_delivery(c, msgs))(cid))
    else:
        fifo = None

    anomalies = None
    try:
        with planner:
            for op_i in range(n_ops):
                if planner.net_active and op_i % 20 == 19:
                    planner.heal_transient(op_i)  # bound leaderless stretches
                if consecutive_failures[0] >= 4:
                    # nemesis bounds unavailability by healing; electing a
                    # new leader is the CLUSTER's job (rescue mode may kick
                    # one when hunting past a known liveness bug)
                    planner.heal_transient(op_i)
                    if rescue:
                        try:
                            api.trigger_election(rescue_rng.choice(cluster))
                        except Exception:  # noqa: BLE001
                            pass
                    consecutive_failures[0] = 0
                if combined:
                    planner.step(op_i)
                roll = rng.random()
                key = f"k{rng.randrange(12)}"
                if combined:
                    # fault scheduling belongs to planner.step above: map
                    # the whole roll onto the workload region so the
                    # legacy thresholds keep their relative weights
                    roll *= 0.8
                if roll < 0.8 and workload == "fifo":
                    fifo.op(rng, op_i, roll / 0.8)
                elif roll < 0.45:
                    counts["put"] = counts.get("put", 0) + 1
                    write(("put", key, rng.randrange(1000)))
                elif roll < 0.6:
                    counts["delete"] = counts.get("delete", 0) + 1
                    write(("delete", key))
                elif roll < 0.8:
                    counts["get"] = counts.get("get", 0) + 1
                    if lease and counts["get"] % 5 == 0:
                        # deposition raced against the read stream: the
                        # lease must be revoked before the new leader
                        # answers, or the next read comes back stale
                        counts["transfer"] = counts.get("transfer", 0) + 1
                        try:
                            api.transfer_leadership(
                                rng.choice(cluster), rng.choice(cluster),
                                timeout=op_timeout)
                        except Exception:  # noqa: BLE001 — no leader now
                            pass
                    try:
                        out = api.consistent_query(
                            rng.choice(cluster), lambda s: dict(s),
                            timeout=op_timeout,
                        )
                        model.check_state(out[1],
                                          f"op{op_i} consistent_query")
                    except Exception:  # noqa: BLE001 — no leader right now
                        pass
                elif roll < 0.87 and partitions:
                    counts["partition"] = counts.get("partition", 0) + 1
                    planner.fire("partition", rng, op_i)
                elif roll < 0.94 and restarts:
                    counts["restart"] = counts.get("restart", 0) + 1
                    planner.fire("crash", rng, op_i)
                elif roll < 0.97 and disk_faults:
                    # seeded storage nemesis: arm one failpoint against a
                    # random node's storage; node supervision must heal it
                    counts["disk_fault"] = counts.get("disk_fault", 0) + 1
                    planner.fire("disk", rng, op_i)
                elif roll < 0.985 and disk_full:
                    # persistent ENOSPC/EDQUOT storm: the node must flip
                    # into storage_degraded, not restart; a second roll
                    # while storming heals it (bounds the episode)
                    counts["disk_full"] = counts.get("disk_full", 0) + 1
                    planner.fire("disk_full", rng, op_i)
                elif roll < 0.993 and slow_disk:
                    counts["slow_disk"] = counts.get("slow_disk", 0) + 1
                    planner.fire("slow_disk", rng, op_i)
                elif membership and planner.sym_victim is None:
                    # membership changes only on a healed cluster: removing
                    # an alive member while another is partitioned away can
                    # drop below quorum and wedge until the next heal roll
                    counts["membership"] = counts.get("membership", 0) + 1
                    planner.fire("membership", rng, op_i)

            planner.heal_all(n_ops)
            if workload == "fifo":
                fifo.final_check(cluster)
                try:
                    final_sum = api.consistent_query(
                        cluster[0], _fifo_summary, timeout=op_timeout)[1]
                except Exception:  # noqa: BLE001
                    final_sum = None
                    model.failures.append(
                        "no leader after heal: cluster wedged")
                if final_sum is not None:
                    deadline = time.monotonic() + 30
                    laggards = list(cluster)
                    while time.monotonic() < deadline and laggards:
                        still = []
                        for sid in laggards:
                            try:
                                v = api.local_query(sid, _fifo_summary)[1]
                                if v != final_sum:
                                    still.append(sid)
                            except Exception:  # noqa: BLE001
                                still.append(sid)
                        laggards = still
                        if laggards:
                            time.sleep(0.2)
                    for sid in laggards:
                        model.failures.append(
                            f"replica {sid} never converged")
                counts["fifo_redeliveries"] = fifo.redeliveries
                counts["fifo_settled"] = len(fifo.settled)
            else:
                # quiesce, then every replica must converge to the model
                final = None
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    try:
                        out = api.consistent_query(
                            cluster[0], lambda s: dict(s),
                            timeout=op_timeout)
                        final = out[1]
                        break
                    except Exception:  # noqa: BLE001
                        time.sleep(0.2)
                if final is None:
                    model.failures.append(
                        "no leader after heal: cluster wedged")
                else:
                    model.check_state(final, "final consistent read")
                    deadline = time.monotonic() + 30
                    laggards = list(cluster)
                    want = _stable(final)
                    while time.monotonic() < deadline and laggards:
                        still = []
                        for sid in laggards:
                            try:
                                v = api.local_query(sid,
                                                    lambda s: dict(s))[1]
                                if _stable(v) != want:
                                    still.append(sid)
                            except Exception:  # noqa: BLE001
                                still.append(sid)
                        laggards = still
                        if laggards:
                            time.sleep(0.2)
                    for sid in laggards:
                        model.failures.append(
                            f"replica {sid} never converged")
                    flood = final.get(_BURST_KEY, 0)
                    if flood > burst_sent[0]:
                        model.failures.append(
                            f"overload bursts: {_BURST_KEY}={flood} > "
                            f"{burst_sent[0]} delivered — duplicated "
                            f"ack-free commands")
            if overload and workload == "kv" and not model.failures:
                _overload_phase(model, cluster, op_timeout, counts, seed)
    finally:
        anomalies = _capture_health(model.failures)
        if disk_faults or disk_full or slow_disk:
            faults.disarm_all()
        for n in names:
            try:
                api.stop_node(n)
            except Exception:  # noqa: BLE001
                pass
        leaderboard.clear()
    nem_counts = {k: v - ctr0.get(k, 0)
                  for k, v in planner.counters().items()}
    _dump_on_failure(model.failures, f"actor seed={seed}",
                     anomalies=anomalies, planner=planner)
    return HarnessResult(
        consistent=not model.failures, failures=model.failures,
        ops=counts, final_model=dict(model.sure), nemesis=nem_counts,
        schedule=list(planner.schedule),
    )


def _capture_health(failures):
    """Snapshot the health plane's anomaly rows while the cluster is
    still up (called at teardown entry — the scanners unregister when
    the nodes stop). Never raises: diagnostics must not mask the
    original failure."""
    if not failures:
        return None
    try:
        return api.cluster_health().get("anomalies", [])
    except Exception:  # noqa: BLE001
        return None


def _dump_on_failure(failures, label: str, anomalies=None,
                     planner=None) -> None:
    """Consistency/liveness failure -> dump the repro bundle: the
    flight recorder (elections, depositions, failpoint fires, watchdog
    strikes, nemesis events interleaved), the planner's replayable
    nemesis schedule (pure function of the seed), and the health
    plane's anomaly view ("which groups were stuck/lagging/flapping at
    death")."""
    if failures:
        import sys

        from ra_tpu_torch import obs

        obs.flight_recorder().dump(header=f" [kv_harness {label}]")
        if planner is not None:
            planner.dump_schedule(header=f" [kv_harness {label}]")
        if anomalies is not None:
            print(f"-- cluster health at failure ({label}): "
                  f"{len(anomalies)} anomalous groups --", file=sys.stderr)
            for row in anomalies[:10]:
                print(f"   {row['state']:<8s} {row['group']}@{row['node']} "
                      f"commit_gap={row['commit_gap']} "
                      f"backlog={row['backlog']} churn={row['churn']}",
                      file=sys.stderr)


def _run_batch(seed, n_ops, nodes, partitions, membership, op_timeout,
               rescue=False, restarts=False, disk_faults=False,
               disk_full=False, slow_disk=False,
               data_dir=None, overload=False, rings=True, workload="kv",
               combined=False, native="auto", lease=False,
               device=None) -> HarnessResult:
    import tempfile

    from ra_tpu_torch.log.log import Log
    from ra_tpu_torch.log.meta_store import FileMeta
    from ra_tpu_torch.log.segment_writer import SegmentWriter
    from ra_tpu_torch.log.tables import TableRegistry
    from ra_tpu_torch.log.wal import Wal
    from ra_tpu_torch.ops import consensus as C
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    rng = random.Random(seed)
    names = [f"kvb{seed}_{i}" for i in range(nodes + 1)]  # +1 spare for joins
    gname = "kvbg0"
    mach_cls = FifoMachine if workload == "fifo" else DictKv
    # restarts/disk_faults need real durability: WAL-backed logs, a
    # file meta store, and per-node storage that a crash-restart can
    # rebuild from (VERDICT item 7's crash-restart nemesis shape)
    use_disk = restarts or disk_faults or disk_full or slow_disk
    base = (data_dir or tempfile.mkdtemp(prefix="ra_kv_batch_")) if use_disk else None
    storage: Dict[str, dict] = {}
    model = _Model()
    counts: Dict[str, int] = {}
    consecutive_failures = [0]
    # rescue randomness is separate from the workload stream: the op
    # sequence must stay seed-deterministic even though rescues fire on
    # wall-clock conditions
    rescue_rng = random.Random(seed ^ 0x5EED)

    if workload == "fifo":
        def _send(cmd):
            try:
                api.process_command(rng.choice(cluster), cmd,
                                    timeout=op_timeout, retry_on_timeout=True)
                consecutive_failures[0] = 0
            except Exception:
                consecutive_failures[0] += 1
                raise

        def _send_once(cmd):
            try:
                api.process_command(rng.choice(cluster), cmd,
                                    timeout=op_timeout)
                consecutive_failures[0] = 0
            except Exception:
                consecutive_failures[0] += 1
                raise

        fifo = _FifoWorkload(
            seed, model.failures, _send, _send_once,
            lambda fn: api.consistent_query(cluster[0], fn,
                                            timeout=op_timeout)[1])

        def fifo_sink(to, msg, options=None):
            fifo.on_delivery(to, [msg])
    else:
        fifo = None
        fifo_sink = None

    def mk_storage(n):
        d = f"{base}/{n}"
        tables = TableRegistry()
        coord_ref: Dict[str, Any] = {}

        def notify(uid, evt):
            c = coord_ref.get("c")
            if c is not None:
                # decoupled durable-ack path (docs/INTERNALS.md §15):
                # written events are handled on the WAL writer thread
                c.wal_notify(uid, evt)

        def notify_many(items):
            c = coord_ref.get("c")
            if c is not None:
                c.wal_notify_many(items)

        sw = SegmentWriter(f"{d}/data", tables, notify)
        sw.fault_scope = n
        wal = Wal(f"{d}/wal", tables, notify, segment_writer=sw)
        wal.notify_many = notify_many
        wal.fault_scope = n
        meta = FileMeta(f"{d}/meta.dat")
        meta.fault_scope = n
        storage[n] = {"tables": tables, "wal": wal, "sw": sw, "meta": meta,
                      "dir": d, "ref": coord_ref}
        return storage[n]

    def mk_log(n):
        st = storage[n]
        # min_snapshot_interval=1: see _run_actor — release-cursor
        # reclamation must be observable at harness op counts
        return Log(gname, f"{st['dir']}/data/{gname}", st["tables"],
                   st["wal"], min_snapshot_interval=1)

    def mk_coord(n):
        c = BatchCoordinator(
            n, capacity=8, num_peers=nodes + 1, tick_interval_s=0.3,
            meta=storage[n]["meta"] if use_disk else None,
            max_command_backlog=(
                _OVERLOAD_BACKLOG if (overload or combined) else 4096),
            rings=rings,
            native=native,
            send_msg_cb=fifo_sink,
            lease=lease,
            device=device,
        )
        if use_disk:
            storage[n]["ref"]["c"] = c
        return c

    coords = {}
    for n in names:
        if use_disk:
            mk_storage(n)
        c = mk_coord(n)
        coords[n] = c
        c.start()
    cluster = [(gname, n) for n in names[:nodes]]
    spare = (gname, names[nodes])
    for _, n in cluster:
        coords[n].add_group(gname, f"kvbc{seed}", cluster, mach_cls(),
                            log=mk_log(n) if use_disk else None)
    coords[names[0]].deliver((gname, names[0]), ElectionTimeout(), None)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not any(
        coords[n].by_name[gname].role == C.R_LEADER for _, n in cluster
    ):
        time.sleep(0.05)

    # -- nemesis context ----------------------------------------------

    def _block(a, b):
        c = coords.get(a)
        if c is not None:
            c.transport.block(a, b)

    def _unblock_all():
        for c in coords.values():
            c.transport.unblock_all()

    def restart_coord(n):
        """Crash-restart one coordinator: tear it down (RAM state gone)
        and rebuild from WAL/meta/segments — recovery must come entirely
        from last-known-durable disk state."""
        counts["coord_restart"] = counts.get("coord_restart", 0) + 1
        coords[n].stop()
        st = storage[n]
        for k in ("wal", "sw", "meta"):
            try:
                st[k].close()
            except Exception:  # noqa: BLE001 — a failed WAL closes dirty
                pass
        mk_storage(n)
        c2 = mk_coord(n)
        coords[n] = c2
        c2.start()
        if planner.sym_victim == n:
            # the fresh transport lost the victim-side blocks: re-arm
            # them so a crash-restart never half-dissolves an active
            # partition (the other sides' blocks are still in place)
            for m in names:
                if m != n:
                    c2.transport.block(n, m)
        if planner.oneway_pair is not None and planner.oneway_pair[0] == n:
            c2.transport.block(*planner.oneway_pair)
        if (gname, n) in cluster:
            c2.add_group(gname, f"kvbc{seed}", list(cluster), mach_cls(),
                         log=mk_log(n))

    def _membership_step():
        try:
            if spare in cluster:
                out = api.remove_member(cluster[0], spare,
                                        timeout=op_timeout)
                if out[0] == "ok":
                    cluster.remove(spare)
                    return "remove"
            else:
                coords[spare[1]].add_group(
                    gname, f"kvbc{seed}", cluster + [spare], mach_cls(),
                    log=mk_log(spare[1]) if use_disk else None,
                )
                out = api.add_member(cluster[0], spare, timeout=op_timeout)
                if out[0] == "ok":
                    cluster.append(spare)
                    return "add"
        except Exception:  # noqa: BLE001 — change may be rejected
            pass
        return None

    burst_sent = [0]
    burst_data = (("settle", "__burst__", 0) if workload == "fifo"
                  else ("incr", _BURST_KEY, 1))

    def _overload_burst():
        cmd = Command(kind=USR, data=burst_data, reply_mode="noreply")
        chunk = [cmd] * _OVERLOAD_BACKLOG
        targets = set(cluster)
        cl_name = api._cluster_of(cluster[0])
        lead = leaderboard.lookup_leader(cl_name) if cl_name else None
        if lead is not None:
            targets.add(lead)
        sent = 0
        for sid in targets:
            sent += api._try_send_many(sid, chunk)
        burst_sent[0] += sent
        return sent

    def _set_mode(m):
        for c in coords.values():
            c.active_set = m

    def _get_mode():
        return coords[names[0]].active_set

    dims = nem.standard_dimensions(
        partitions=partitions, oneway=combined or lease,
        disk_faults=disk_faults, disk_full=disk_full, slow_disk=slow_disk,
        restarts=use_disk and restarts, membership=membership,
        overload=combined, mode_flips=combined)
    ctx = nem.NemesisContext(
        peers=lambda: list(names),
        members=lambda: [n for _, n in cluster],
        block=_block, unblock_all=_unblock_all,
        restart=restart_coord, membership_step=_membership_step,
        fault_scopes=lambda: names[:nodes],
        overload_burst=_overload_burst,
        set_mode=_set_mode, get_mode=_get_mode)
    planner = nem.Planner(ctx, seed, f"kvb{seed}", dims)
    ctr0 = planner.counters()

    def check_infra():
        """Per-op storage health sweep (the batch backend has no RaNode
        supervisor): an integrity-class WAL failure means unknown
        durability — rebuild the whole coordinator from disk (fsync-
        poison rule); a SPACE-class failure (ENOSPC/EDQUOT,
        docs/INTERNALS.md §21) provably corrupted nothing, so the
        coordinator degrades in place — admission flips to RA_NOSPACE
        rejects, this sweep probes ``reopen()`` each op (the failpoint
        seam keeps it failing while the storm is armed), and on resume
        the groups get ``wal_up`` to resend their memtable tails — no
        restart, no lost acked state. A dead infra thread is revived in
        place with its queue intact."""
        for n in names:
            st = storage.get(n)
            if st is None:
                continue
            wal = st["wal"]
            if wal.degraded:
                c = coords[n]
                if c.pressure.enter_degraded(detail="wal space storm"):
                    counts["batch_degraded"] = (
                        counts.get("batch_degraded", 0) + 1)
                if wal.reopen():
                    c.pressure.exit_degraded()
                    counts["batch_resumed"] = (
                        counts.get("batch_resumed", 0) + 1)
                    for uid in list(c.by_name):
                        c.wal_notify(uid, ("wal_up",))
            elif wal.failed:
                restart_coord(n)
            else:
                if not wal.thread_alive():
                    wal.revive_thread()
                if not st["sw"].thread_alive():
                    st["sw"].revive_thread()

    def kick():
        """Operator rescue: force an election on a random member."""
        tgt = rescue_rng.choice(cluster)
        try:
            coords[tgt[1]].deliver(tgt, ElectionTimeout(), None)
        except Exception:  # noqa: BLE001
            pass

    def write(cmd):
        try:
            reply, _ = api.process_command(
                rng.choice(cluster), cmd, timeout=op_timeout,
                retry_on_timeout=True,
            )
            model.applied(cmd)
            consecutive_failures[0] = 0
        except Exception:  # noqa: BLE001
            model.uncertain(cmd)
            consecutive_failures[0] += 1

    anomalies = None
    try:
        with planner:
            for op_i in range(n_ops):
                if use_disk:
                    check_infra()
                if consecutive_failures[0] >= 4:
                    # nemesis heal only; recovery is the cluster's job
                    # (see _run_actor)
                    planner.heal_transient(op_i)
                    if rescue:
                        kick()
                    consecutive_failures[0] = 0
                if combined:
                    planner.step(op_i)
                roll = rng.random()
                key = f"k{rng.randrange(12)}"
                if combined:
                    roll *= 0.85  # see _run_actor: workload region only
                if roll < 0.85 and workload == "fifo":
                    fifo.op(rng, op_i, roll / 0.85)
                elif roll < 0.5:
                    counts["put"] = counts.get("put", 0) + 1
                    write(("put", key, rng.randrange(1000)))
                elif roll < 0.65:
                    counts["delete"] = counts.get("delete", 0) + 1
                    write(("delete", key))
                elif roll < 0.85:
                    counts["get"] = counts.get("get", 0) + 1
                    if lease and counts["get"] % 5 == 0:
                        # deposition mid-read-stream: see _run_actor
                        counts["transfer"] = counts.get("transfer", 0) + 1
                        try:
                            api.transfer_leadership(
                                rng.choice(cluster), rng.choice(cluster),
                                timeout=op_timeout)
                        except Exception:  # noqa: BLE001
                            pass
                    try:
                        out = api.consistent_query(
                            rng.choice(cluster), lambda s: dict(s),
                            timeout=op_timeout,
                        )
                        model.check_state(out[1],
                                          f"op{op_i} consistent_query")
                    except Exception:  # noqa: BLE001
                        pass
                elif roll < 0.90 and use_disk and restarts:
                    # coordinator crash-restart: all RAM state dropped,
                    # rebuilt from WAL/meta/segments mid-workload
                    planner.fire("crash", rng, op_i)
                elif roll < 0.93 and partitions:
                    counts["partition"] = counts.get("partition", 0) + 1
                    planner.fire("partition", rng, op_i)
                elif roll < 0.96 and disk_faults:
                    counts["disk_fault"] = counts.get("disk_fault", 0) + 1
                    planner.fire("disk", rng, op_i)
                elif roll < 0.975 and disk_full:
                    # ENOSPC storm: check_infra must keep the coordinator
                    # alive degraded (no restart) until the storm heals
                    counts["disk_full"] = counts.get("disk_full", 0) + 1
                    planner.fire("disk_full", rng, op_i)
                elif roll < 0.985 and slow_disk:
                    counts["slow_disk"] = counts.get("slow_disk", 0) + 1
                    planner.fire("slow_disk", rng, op_i)
                elif membership and planner.sym_victim is None:
                    counts["membership"] = counts.get("membership", 0) + 1
                    planner.fire("membership", rng, op_i)

            planner.heal_all(n_ops)
            if use_disk:
                check_infra()
            if workload == "fifo":
                fifo.final_check(cluster,
                                 tick=check_infra if use_disk else None)
                try:
                    final_sum = api.consistent_query(
                        cluster[0], _fifo_summary, timeout=op_timeout)[1]
                except Exception:  # noqa: BLE001
                    final_sum = None
                    model.failures.append(
                        "no leader after heal: cluster wedged")
                if final_sum is not None:
                    deadline = time.monotonic() + 60
                    laggards = [n for _, n in cluster]
                    while time.monotonic() < deadline and laggards:
                        laggards = [
                            n for n in laggards
                            if _fifo_summary(
                                coords[n].by_name[gname].machine_state)
                            != final_sum
                        ]
                        if laggards:
                            time.sleep(0.2)
                    for n in laggards:
                        model.failures.append(
                            f"replica {n} never converged")
                counts["fifo_redeliveries"] = fifo.redeliveries
                counts["fifo_settled"] = len(fifo.settled)
            else:
                final = None
                deadline = time.monotonic() + 30
                kick_at = time.monotonic()
                while time.monotonic() < deadline:
                    try:
                        out = api.consistent_query(
                            cluster[0], lambda s: dict(s),
                            timeout=op_timeout)
                        final = out[1]
                        break
                    except Exception:  # noqa: BLE001
                        if rescue and time.monotonic() - kick_at > 3:
                            kick()
                            kick_at = time.monotonic()
                        time.sleep(0.2)
                if final is None:
                    model.failures.append(
                        "no leader after heal: cluster wedged")
                else:
                    model.check_state(final, "final consistent read")
                    deadline = time.monotonic() + 60  # generous on loaded hosts
                    laggards = [n for _, n in cluster]  # current members only
                    want = _stable(final)
                    while time.monotonic() < deadline and laggards:
                        laggards = [
                            n for n in laggards
                            if _stable(coords[n].by_name[gname].machine_state)
                            != want
                        ]
                        if laggards:
                            time.sleep(0.2)
                    for n in laggards:
                        g = coords[n].by_name[gname]
                        model.failures.append(
                            f"replica {n} never converged: role={g.role} "
                            f"term={g.term} applied={g.last_applied} "
                            f"members={g.members} state_keys="
                            f"{sorted(g.machine_state)[:6]} vs final_keys="
                            f"{sorted(final)[:6]}"
                        )
                    flood = final.get(_BURST_KEY, 0)
                    if flood > burst_sent[0]:
                        model.failures.append(
                            f"overload bursts: {_BURST_KEY}={flood} > "
                            f"{burst_sent[0]} delivered — duplicated "
                            f"ack-free commands")
            if overload and workload == "kv" and not model.failures:
                _overload_phase(model, cluster, op_timeout, counts, seed)
    finally:
        anomalies = _capture_health(model.failures)
        if disk_faults or disk_full or slow_disk:
            faults.disarm_all()
        for c in coords.values():
            c.stop()
        for st in storage.values():
            for k in ("wal", "sw", "meta"):
                try:
                    st[k].close()
                except Exception:  # noqa: BLE001
                    pass
        if use_disk and data_dir is None:
            import shutil

            shutil.rmtree(base, ignore_errors=True)
        leaderboard.clear()
    nem_counts = {k: v - ctr0.get(k, 0)
                  for k, v in planner.counters().items()}
    _dump_on_failure(model.failures, f"batch seed={seed}",
                     anomalies=anomalies, planner=planner)
    return HarnessResult(
        consistent=not model.failures, failures=model.failures,
        ops=counts, final_model=dict(model.sure), nemesis=nem_counts,
        schedule=list(planner.schedule),
    )


if __name__ == "__main__":  # pragma: no cover — ops entry point
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ops", type=int, default=500)
    ap.add_argument("--backend", default="per_group_actor")
    ap.add_argument("--workload", choices=("kv", "fifo"), default="kv",
                    help="machine under test: the DictKv map or the "
                         "FifoMachine queue with its settle-conservation "
                         "checker")
    ap.add_argument("--combined", action="store_true",
                    help="the combined-fault soak: every nemesis "
                         "dimension at once (incl. one-way partitions, "
                         "overload bursts, batch mode flips), scheduled "
                         "by the planner's own seeded rng")
    ap.add_argument("--disk-faults", action="store_true",
                    help="enable the seeded storage-nemesis dimension "
                         "(failpoint storms; WAL-backed logs on tpu_batch)")
    ap.add_argument("--disk-full", action="store_true",
                    help="storage-pressure survival dimension: persistent "
                         "ENOSPC/EDQUOT storms — nodes must degrade "
                         "(RA_NOSPACE), not restart, and auto-resume on "
                         "heal (docs/INTERNALS.md §21)")
    ap.add_argument("--slow-disk", action="store_true",
                    help="persistent fsync-latency faults; actor nodes "
                         "run a lowered brownout threshold so detection "
                         "sheds leadership off the browning-out node")
    ap.add_argument("--overload", action="store_true",
                    help="build the backends with a small admission "
                         "window and drive past it after the nemesis "
                         "loop (asserts bounded latency + zero lost/"
                         "duplicated acked commands)")
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--restarts", dest="restarts", action="store_true",
                     default=None,
                     help="force the restart dimension on (coordinator "
                          "crash-restarts over WAL-backed logs on tpu_batch)")
    grp.add_argument("--no-restarts", dest="restarts", action="store_false",
                     help="force the restart dimension off")
    ap.add_argument("--no-partitions", dest="partitions",
                    action="store_false", default=True,
                    help="drop the partition dimension from the mix")
    ap.add_argument("--no-membership", dest="membership",
                    action="store_false", default=True,
                    help="drop the membership-churn dimension")
    ap.add_argument("--rings", choices=("on", "off"), default="on",
                    help="off: batch backend runs the lock+deque "
                         "control command plane (A/B escape hatch)")
    ap.add_argument("--native", default="auto",
                    help="batch backend native hot-loop runtime paths: "
                         "auto (default), off, or a comma list of "
                         "pack,classify,egress (docs/INTERNALS.md §18)")
    ap.add_argument("--lease", action="store_true",
                    help="linearizable-read dimension: clock-bound "
                         "leader leases on, one-way partitions in the "
                         "nemesis mix, forced depositions racing the "
                         "consistent-read stream (docs/INTERNALS.md §20)")
    ap.add_argument("--device", default=None,
                    help="torch device of the batch backend's "
                         "coordinators (default: cuda)")
    args = ap.parse_args()
    res = run(seed=args.seed, n_ops=args.ops, backend=args.backend,
              restarts=args.restarts, disk_faults=args.disk_faults,
              disk_full=args.disk_full, slow_disk=args.slow_disk,
              partitions=args.partitions, membership=args.membership,
              overload=args.overload, rings=args.rings == "on",
              workload=args.workload, combined=args.combined,
              native=args.native, lease=args.lease, device=args.device)
    print(f"ops={res.ops} consistent={res.consistent}")
    if res.nemesis:
        fired = {k: v for k, v in res.nemesis.items() if v}
        print(f"nemesis={fired}")
    for f in res.failures:
        print("FAILURE:", f)
    sys.exit(0 if res.consistent else 1)
