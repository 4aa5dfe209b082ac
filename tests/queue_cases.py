"""Quorum queues on the batch backend: the fifo machine
(``models/fifo.py``) over three coordinators with WAL-backed logs,
release-cursor snapshots, a consumer's failure and a follower's
catch-up by snapshot install. Written once for any package with the
reference's module layout (``ra_tpu`` or ``ra_tpu_torch``) and any
device, as ``tests/loop_cases.py`` and ``tests/failover_cases.py`` are:
it takes a ``lane_cases.Lane`` and uses the standard library only, so
the card run imports no JAX.

Every queue ``q<i>`` is one Raft group with members on all three nodes,
every group elected on node 0. One run of ``waves`` sends, to every
queue at once, wave by wave, each wave's replies awaited:

1. consumer A checks out with credit 2;
2. wave E: 4 enqueues, one message each (values from ``seed``);
   A receives the first two;
3. wave S1: A settles its 2 deliveries and receives the other two;
4. ``("down", A, ...)``: A fails; the machine requeues its 2 in-flight
   messages at the head, in msg_id order (monitor effects are not
   realised on the batch backend, so the scenario sends the ``down``, as
   ``kv_harness`` does);
5. in the same wave, after it, consumer B checks out with credit 4 and
   receives the requeued pair;
6. wave S2: B settles both. The queue is empty and nothing is in
   flight, so the machine emits a ``ReleaseCursor`` at that index and
   every replica snapshots (``min_snapshot_interval`` is cut to 8 from
   the log's 4096, so a run of 12 entries a queue takes one, as
   ``kv_harness`` cuts it to 1);
7. a later run on the same cluster starts with the earlier run's B
   cancelling, in the wave of its own step 1.

Deliveries are the leader's ``SendMsg`` effects, taken by the
coordinators' ``send_msg_cb``: a sink that only appends to the
consumer's list. With ``cut``, node 2 is cut off in both directions
(each coordinator's ``transport.block``) after step 1 has applied on
every replica, and healed (``unblock_all``) once the leaders and node 1
have snapshotted; node 2 must then reach the leader's commit by a
snapshot install in every group, since everything it missed lies below
the leader's snapshot.

A cluster is hand-stepped on a ``ManualClock`` (the coordinator's
``clock=`` seam, ``step_once`` on each node in turn; the CPU tests) or
runs the started wave loops (the card). Hand-stepped, the detector's
resync probe of a silent peer, which starts the catch-up, is delivered
by hand. The WAL's writer and the snapshot sender stream from threads
of their own in both forms, so what interleaves with them is not fixed:
a record holds end states and per-queue sequences, which the machine
fixes (replies, deliveries, fingerprints, snapshot indexes and terms,
the device's snapshot columns, the compacted logs), never message
order or step counts.

``tests/test_torch_queue.py`` runs ``queue_waves`` and
``snapshot_catch_up`` on both packages on the CPU; ``chip_smoke.py``
(phase queue) runs ``queue_phase`` on the card (1024 queues x 3
replicas): both runs on one started cluster, node 2 cut off for the
second.
"""

import concurrent.futures
import importlib
import os
import random
import statistics
import threading
import time

from failover_cases import Sampler
from lane_cases import ROW
from loop_cases import steps_of

MIN_SNAPSHOT_INTERVAL = 8
CREDIT_A, CREDIT_B = 2, 4
ENQUEUES = 4
# GroupState columns of a snapshot, held against the host
SNAP_COLS = ("snapshot_index", "snapshot_term")
# a group's device row in a record: lane_cases.ROW but match_index, the
# leader's view of each follower's last ack, which an ack still in
# flight when the record is read leaves behind
ROW_FIELDS = tuple(f for f in ROW if f != "match_index")


def _mod(lane, sub):
    return importlib.import_module(f"{lane.name}.{sub}")


def consumers(part):
    """The consumer tags of run ``part``: A and B of the module doc."""
    return f"A{part}", f"B{part}"


class QueueCluster:
    """Three coordinators ``prefix``0..2 hosting ``n_queues`` fifo
    queues ``q0``.., each node with its own WAL and segment writer under
    ``workdir/<node>`` and a WAL-backed ``Log`` a queue
    (``min_snapshot_interval`` 8), built on ``log_threads`` threads.

    With ``clock`` (a ``ManualClock``) the coordinators are never
    started and ``wait`` steps them by hand; without, they are started
    and ``wait`` polls. ``deliveries[cid]`` is consumer ``cid``'s list of
    ``(msg_id, payload)``, appended by the sink on the leader's apply
    path; a consumer id is ``"<queue>/<tag>"``. Started, the
    coordinators take the election timeout, detector poll and tick
    given here."""

    def __init__(self, lane, workdir, n_queues, prefix="qw", clock=None,
                 election_timeout_s=0.3, detector_poll_s=0.05,
                 tick_interval_s=0.2, log_threads=1, parts=2,
                 progress=None):
        self.lane = lane
        self.progress = progress  # called with a line after each wave
        self.n = n_queues
        self.clock = clock
        self.names = [f"{prefix}{i}" for i in range(3)]
        self.qname = [f"q{q}" for q in range(n_queues)]
        self.deliveries = {
            f"{qn}/{tag}": [] for qn in self.qname
            for p in range(parts) for tag in consumers(p)}
        box = self.deliveries

        def sink(to, msg, _options=None):
            box[to].append(msg[1:])

        kw = {"clock": clock} if clock is not None else {
            "election_timeout_s": election_timeout_s,
            "detector_poll_s": detector_poll_s,
            "tick_interval_s": tick_interval_s}
        self.coords = [lane.coord(n, capacity=n_queues, num_peers=3,
                                  send_msg_cb=sink, **kw)
                       for n in self.names]
        self.storage = []
        self.snap_writes = {n: [] for n in self.names}  # seconds each
        self._log_threads = log_threads
        self._workdir = workdir
        self._fifo = _mod(lane, "models.fifo").FifoMachine
        self.summary = _mod(lane, "kv_harness")._fifo_summary

    # -- set-up and teardown ---------------------------------------------

    def __enter__(self):
        try:
            self._open()
        except BaseException:
            self.close()
            raise
        return self

    def __exit__(self, *exc):
        self.close()

    def _open(self):
        lane = self.lane
        Log = _mod(lane, "log.log").Log
        Wal = _mod(lane, "log.wal").Wal
        SegmentWriter = _mod(lane, "log.segment_writer").SegmentWriter
        TableRegistry = _mod(lane, "log.tables").TableRegistry
        if self.clock is None:
            for c in self.coords:
                c.start()
        for n, c in zip(self.names, self.coords):
            d = os.path.join(self._workdir, n)
            tables = TableRegistry()
            sw = SegmentWriter(os.path.join(d, "data"), tables, c.wal_notify)
            wal = Wal(os.path.join(d, "wal"), tables, c.wal_notify,
                      segment_writer=sw, max_batch_size=65536)
            wal.notify_many = c.wal_notify_many
            self.storage.append((tables, wal, sw, d))

        def build(job):
            i, qs = job
            tables, wal, _sw, d = self.storage[i]
            out = []
            for q in qs:
                uid = self.qname[q]
                log = Log(uid, os.path.join(d, "data", uid), tables, wal,
                          min_snapshot_interval=MIN_SNAPSHOT_INTERVAL)
                self._time_snapshots(log, self.snap_writes[self.names[i]])
                out.append(log)
            return out

        chunk = 512
        jobs = [(i, range(lo, min(lo + chunk, self.n)))
                for i in range(3) for lo in range(0, self.n, chunk)]
        with concurrent.futures.ThreadPoolExecutor(self._log_threads) as ex:
            parts = list(ex.map(build, jobs))
        per = len(parts) // 3
        for i, c in enumerate(self.coords):
            logs = [log for part in parts[i * per:(i + 1) * per]
                    for log in part]
            members = [[(qn, n) for n in self.names] for qn in self.qname]
            c.add_groups([(qn, f"cl{q}", members[q], self._fifo(), logs[q])
                          for q, qn in enumerate(self.qname)])

    @staticmethod
    def _time_snapshots(log, into):
        """Times each snapshot write of ``log`` (its store's ``write``,
        wrapped on the instance) into the list ``into``."""
        store = log.snapshots
        write = store.write

        def timed(*args, **kw):
            t = time.perf_counter()
            out = write(*args, **kw)
            into.append(time.perf_counter() - t)
            return out

        store.write = timed

    def close(self):
        for c in self.coords:
            c.transport.unblock_all()
            c.stop()
        for _tables, wal, sw, _d in self.storage:
            wal.close()
            sw.close()
        self.storage = []

    # -- driving -----------------------------------------------------------

    def wait(self, cond, what, timeout_s=60.0):
        """Until ``cond()``: hand-stepped, every coordinator steps in
        turn (an idle pass yields a millisecond to the WAL and sender
        threads); started, the state is polled every 10 ms."""
        deadline = time.monotonic() + timeout_s
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"queue cluster: timeout: {what}")
            worked = False
            if self.clock is not None:
                for c in self.coords:
                    worked = c.step_once() or worked
            if not worked:
                time.sleep(0.01 if self.clock is None else 0.001)

    def groups(self, i):
        by = self.coords[i].by_name
        return [by[qn] for qn in self.qname]

    def elect(self, timeout_s=60.0):
        """Every queue elected on node 0 (one ``deliver_many``), its noop
        applied on every replica, so each follower knows its leader.
        Returns the seconds it took."""
        lane, n0 = self.lane, self.names[0]
        t = time.perf_counter()
        self.coords[0].deliver_many(
            [((qn, n0), lane.protocol.ElectionTimeout(), None)
             for qn in self.qname])
        leaders = self.groups(0)
        reps = [self.groups(i) for i in range(3)]
        self.wait(lambda: all(g.role == lane.C.R_LEADER and g.noop_committed
                              for g in leaders)
                  and all(r[q].last_applied >= leaders[q].noop_index
                          for r in reps for q in range(self.n)),
                  "leaders on node 0, noops applied everywhere", timeout_s)
        return time.perf_counter() - t

    def send(self, cmds, timeout_s=60.0):
        """One wave: ``cmds[q]`` is the list of commands to queue ``q``,
        all sent through one ``deliver_many`` to the leaders on node 0.
        Waits for every reply; returns them as ``(tag, value)`` lists by
        queue, with the wall time and the command count."""
        lane, n0 = self.lane, self.names[0]
        futs = [[lane.api.Future() for _ in cs] for cs in cmds]
        msgs = [((self.qname[q], n0), lane.command(c, f), None)
                for q, cs in enumerate(cmds) for c, f in zip(cs, futs[q])]
        t = time.perf_counter()
        self.coords[0].deliver_many(msgs)
        flat = [f for fs in futs for f in fs]
        self.wait(lambda: all(f.done() for f in flat), "every reply",
                  timeout_s)
        s = time.perf_counter() - t
        replies = [[tuple(f.value[:2]) for f in fs] for fs in futs]
        return replies, {"cmds": len(msgs), "s": s,
                         "cmds_per_s": len(msgs) / s}

    def cut(self, node):
        """Node ``node`` cut off from the other two, both ways."""
        me = self.names[node]
        for i, c in enumerate(self.coords):
            if i != node:
                c.transport.block(self.names[i], me)
                self.coords[node].transport.block(me, self.names[i])

    def heal(self):
        for c in self.coords:
            c.transport.unblock_all()


def snapshot_of(g):
    it = g.log.snapshot_index_term()
    return tuple(it) if it is not None else (0, 0)


def first_index(log):
    """The lowest index the log still holds (its last index plus one if
    it holds none): what compaction left."""
    li = log.last_index_term()[0]
    for i in range(1, li + 1):
        if log.fetch(i) is not None:
            return i
    return li + 1


def waves(cl, part, seed, cut=None, timeout_s=60.0, sample_every_s=0.05):
    """One run of the module doc's waves on every queue of ``cl``, with
    consumer tags ``consumers(part)`` and payloads from
    ``random.Random(seed * 1000 + part)``; after a first run (``part``
    > 0) the earlier run's B cancels in the first wave. With ``cut`` (a
    node), that node is cut off from after step 1 until the leaders and
    node 1 have snapshotted, and must catch up by snapshot install.

    The record holds, by queue: the commands sent and their replies in
    order (``cmds``, ``replies``), each consumer's deliveries, the
    release cursor (the leader's last index after S2), and by node:
    each queue's fifo fingerprint (``kv_harness._fifo_summary``),
    snapshot (index, term), compacted first index, and the device's
    snapshot columns for every group beside the host's (``snap_floor``
    and the snapshot's term). Besides, each wave's wall time and
    commands per second, and the snapshots written and their write
    times by node. With ``cut``: the cut node's last index before the
    cut, its snapshot installs by queue and its applied index at each
    install, the leaders' first index at the heal, the seconds from the
    heal until each queue was caught up (half and 99 % of them, polled
    every ``sample_every_s``), and the threads and resident memory
    sampled over the catch-up."""
    lane, n = cl.lane, cl.n
    a, b = consumers(part)
    qn = cl.qname
    rng = random.Random(seed * 1000 + part)
    payloads = [[rng.randint(1, 10**6) for _ in range(ENQUEUES)]
                for _ in range(n)]
    cmds = [[] for _ in range(n)]
    replies = [[] for _ in range(n)]
    rec = {"waves": {}}
    box = cl.deliveries
    leaders = cl.groups(0)
    reps = [cl.groups(i) for i in range(3)]

    def wave(label, per_queue):
        for q, cs in enumerate(per_queue):
            cmds[q] += cs
        got, rate = cl.send(per_queue, timeout_s)
        bad = [(q, r) for q, rs in enumerate(got) for r in rs if r[0] != "ok"]
        if bad:
            # a redirect or "maybe" breaks every later wave's premise
            raise AssertionError(f"run {part}, wave {label}: {len(bad)} "
                                 f"replies not ok, first {bad[:3]}; "
                                 f"{diagnose(cl, [q for q, _ in bad[:2]])}")
        for q, r in enumerate(got):
            replies[q] += r
        rate["lane_wedges"] = sum(c.counters.get("lane_wedges")
                                  for c in cl.coords)
        rec["waves"][label] = rate
        if cl.progress is not None:
            cl.progress(f"run {part}, wave {label}: {rate}")

    def delivered(tag, k):
        cl.wait(lambda: all(len(box[f"{qn[q]}/{tag}"]) >= k
                            for q in range(n)),
                f"{k} deliveries to every {tag}", timeout_s)

    def applied_everywhere(nodes=(0, 1, 2)):
        cl.wait(lambda: all(reps[i][q].last_applied
                            >= leaders[q].log.last_index_term()[0]
                            for i in nodes for q in range(n)),
                f"every replica on {nodes} applied", timeout_s)

    leave = [("cancel", f"{qn[q]}/{consumers(part - 1)[1]}")
             for q in range(n)] if part else None
    wave("checkout_a", [([leave[q]] if leave else [])
                        + [("checkout", f"{qn[q]}/{a}", CREDIT_A)]
                        for q in range(n)])
    if cut is not None:
        applied_everywhere()
        rec["cut_last_index"] = [g.log.last_index_term()[0]
                                 for g in reps[cut]]
        cl.cut(cut)
    wave("enqueue", [[("enqueue", p) for p in payloads[q]]
                     for q in range(n)])
    delivered(a, CREDIT_A)
    wave("settle_a", [[("settle", f"{qn[q]}/{a}", m)
                       for m, _p in box[f"{qn[q]}/{a}"][:CREDIT_A]]
                      for q in range(n)])
    delivered(a, ENQUEUES)
    # steps 4 and 5 in one wave: each queue's down, then its checkout
    wave("down_a_checkout_b", [[("down", f"{qn[q]}/{a}", "noconnection"),
                                ("checkout", f"{qn[q]}/{b}", CREDIT_B)]
                               for q in range(n)])
    delivered(b, ENQUEUES - CREDIT_A)
    wave("settle_b", [[("settle", f"{qn[q]}/{b}", m)
                       for m, _p in box[f"{qn[q]}/{b}"]]
                      for q in range(n)])
    cursor = [g.log.last_index_term()[0] for g in leaders]
    rec["cursor"] = cursor
    live = [i for i in range(3) if i != cut]
    cl.wait(lambda: all(snapshot_of(reps[i][q])[0] >= cursor[q]
                        for i in live for q in range(n)),
            "a snapshot at the cursor on every live replica", timeout_s)
    if cut is not None:
        rec.update(catch_up(cl, cut, cursor, timeout_s, sample_every_s))
    applied_everywhere()
    rec["cmds"] = cmds
    rec["replies"] = replies
    rec["deliveries"] = {t: [list(box[f"{qn[q]}/{t}"]) for q in range(n)]
                         for t in (a, b)}
    rec.update(end_state(cl))
    return rec


def diagnose(cl, queues):
    """What each replica of ``queues`` holds (role, term, leader slot,
    seconds since leader contact, applied index, snapshot floor), the
    coordinators' nonzero counters and the flight recorder's newest
    events of those queues: the text of a failed wave's error."""
    now = cl.clock.monotonic() if cl.clock is not None else time.monotonic()
    out = []
    for q in queues:
        out.append({cl.names[i]: (g.role, g.term, g.leader_slot,
                                  round(now - g.last_contact, 3),
                                  g.last_applied, g.snap_floor)
                    for i, g in enumerate(cl.groups(i)[q] for i in range(3))})
    counters = [{k: v for k, v in c.counters.to_dict().items() if v}
                for c in cl.coords]
    names = {cl.qname[q] for q in queues}
    events = [e for e in cl.coords[0]._obs_rec.events()
              if e.get("group") in names][-12:]
    return f"replicas {out}; counters {counters}; events {events}"


def catch_up(cl, node, cursor, timeout_s, sample_every_s):
    """Heal ``node`` after the leaders' snapshots and wait until it
    holds every queue's snapshot at ``cursor``, applied, by install;
    hand-stepped, the resync probe the detector sends a silent peer is
    delivered to each leader by hand. Installs are counted by wrapping
    the node's ``_receive_snapshot_chunk`` on the instance."""
    lane, n = cl.lane, cl.n
    c = cl.coords[node]
    mine = cl.groups(node)
    leaders = cl.groups(0)
    installs = [0] * n
    applied_at = [None] * n
    receive = c._receive_snapshot_chunk
    gid = {g.gid: q for q, g in enumerate(mine)}

    def spy(g, msg, from_sid):
        floor, applied = g.snap_floor, g.last_applied
        out = receive(g, msg, from_sid)
        if g.snap_floor > floor:
            q = gid[g.gid]
            installs[q] += 1
            applied_at[q] = applied
        return out

    c._receive_snapshot_chunk = spy
    rec = {"leader_first_index": [first_index(g.log) for g in leaders]}
    done_at = {}
    with Sampler(sample_every_s) as sampler:
        rec["threads_before"], rec["rss_before"] = sampler.mark()
        t0 = time.perf_counter()
        cl.heal()
        if cl.clock is not None:
            for g in leaders:
                cl.coords[0].deliver(
                    (g.name, cl.names[0]),
                    ("resync", [g.slot_of((g.name, cl.names[node]))]), None)

        def caught():
            now = time.perf_counter() - t0
            done_at.update(
                (q, now) for q in range(n) if q not in done_at
                and mine[q].last_applied >= cursor[q]
                and snapshot_of(mine[q])[0] >= cursor[q])
            return len(done_at) == n

        deadline = time.monotonic() + timeout_s
        if cl.clock is None:
            # polled every sample_every_s for the quantiles
            shown = time.monotonic()
            while not caught():
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"{n - len(done_at)} queues never caught up")
                if cl.progress is not None and time.monotonic() - shown > 5:
                    shown = time.monotonic()
                    cl.progress(f"catch-up {time.perf_counter() - t0:.1f} s: "
                                f"{len(done_at)} of {n} caught up, "
                                f"{sum(installs)} installs, threads and "
                                f"resident bytes {sampler.mark()}")
                time.sleep(sample_every_s)
        else:
            cl.wait(caught, "the cut node caught up", timeout_s)
        rec["caught_up_s"] = time.perf_counter() - t0
        sampler.mark()
    c._receive_snapshot_chunk = receive
    when = sorted(done_at.values())
    rec["caught_up_quantiles_s"] = {
        qq: when[min(n - 1, n * qq // 100)] for qq in (50, 99)}
    rec["installs"] = installs
    rec["applied_at_install"] = applied_at
    rec["peak_threads"] = sampler.peak_threads
    rec["peak_rss"] = sampler.peak_rss
    rec["counters"] = {
        k: [x.counters.get(k) for x in cl.coords]
        for k in ("ingress_ring_full", "ingress_overflow_msgs",
                  "lane_wedges")}
    return rec


def end_state(cl):
    """By node: fingerprints, snapshots, compacted first indexes, the
    device's snapshot columns beside the host's, and (``rows``) the
    group's device row (``ROW_FIELDS``), for every queue; the
    snapshots written so far and the write times."""
    out = {"fingerprints": [], "snapshots": [], "first_index": [],
           "device_snap": [], "host_snap": [], "rows": []}
    for i, c in enumerate(cl.coords):
        gs = cl.groups(i)
        out["fingerprints"].append([cl.summary(g.machine_state) for g in gs])
        out["snapshots"].append([snapshot_of(g) for g in gs])
        out["first_index"].append([first_index(g.log) for g in gs])
        cols = cl.lane.fields(c)
        out["device_snap"].append(
            [[int(cols[f][g.gid]) for f in SNAP_COLS] for g in gs])
        out["host_snap"].append([[g.snap_floor, snapshot_of(g)[1]]
                                 for g in gs])
        out["rows"].append([{f: cols[f][g.gid].tolist() for f in ROW_FIELDS}
                            for g in gs])
    out["snapshot_writes"] = {
        n: len(ts) for n, ts in cl.snap_writes.items()}
    out["snapshot_write_s"] = {
        n: _quantiles(ts) for n, ts in cl.snap_writes.items()}
    return out


def _quantiles(ts):
    if not ts:
        return None
    s = sorted(ts)
    return {"p50": statistics.median(s),
            "p99": s[min(len(s) - 1, len(s) * 99 // 100)],
            "max": s[-1], "sum": sum(s)}


def fold(lane, cmds):
    """The fifo machine alone, no coordinator: ``cmds`` (one queue's
    commands in log order, from index 1 behind a noop) applied in turn.
    Returns the replies and each consumer's deliveries, by tag."""
    fx = _mod(lane, "effects")
    m = _mod(lane, "models.fifo").FifoMachine()
    state = m.init({})
    replies, out = [], {}
    for i, c in enumerate(cmds, start=2):
        state, reply, effs = m.apply({"index": i}, c, state)
        replies.append(reply)
        for e in effs:
            if isinstance(e, fx.SendMsg):
                out.setdefault(e.to.rsplit("/", 1)[1], []).append(e.msg[1:])
    return replies, out


def check(lane, rec, part, prior=None):
    """Run ``part``'s acceptance (``prior``: each queue's commands of the
    earlier runs on the same cluster, by queue), as the card checks it at full width: every
    reply ``ok`` and equal to the machine's alone (``fold``); every
    acknowledged enqueue delivered and settled once; A's deliveries in
    msg_id order and B's the requeued pair, first, in order; all three
    replicas' fingerprints equal in every queue; every replica's
    snapshot at or past the cursor; on every node the device's snapshot
    columns equal to the host's; with a cut, every queue of the cut node
    caught up by an install, below the snapshot index at the install.
    Raises ``AssertionError`` naming the first queue that fails."""
    a, b = consumers(part)
    for q, cs in enumerate(rec["cmds"]):
        before = prior[q] if prior else []
        want, dels = fold(lane, before + cs)
        want = want[len(before):]
        got = rec["replies"][q]
        if [r[0] for r in got] != ["ok"] * len(cs):
            raise AssertionError(f"queue {q}: replies {got}")
        if [r[1] for r in got] != want:
            raise AssertionError(f"queue {q}: replies {got} != the "
                                 f"machine's {want}")
        da, db = rec["deliveries"][a][q], rec["deliveries"][b][q]
        if (dels.get(a, []), dels.get(b, [])) != (da, db):
            raise AssertionError(f"queue {q}: deliveries {da} / {db} != "
                                 f"the machine's {dels}")
        acked = [r[1][1] for c, r in zip(cs, got) if c[0] == "enqueue"]
        settled = [c[2] for c in cs if c[0] == "settle"]
        if sorted(settled) != sorted(acked) or len(set(settled)) != len(
                settled):
            raise AssertionError(f"queue {q}: acked {acked}, settled "
                                 f"{settled}")
        if [m for m, _ in da] != sorted(acked) or [m for m, _ in db] != (
                sorted(acked)[CREDIT_A:]):
            raise AssertionError(f"queue {q}: delivery order {da} / {db}")
    fps = rec["fingerprints"]
    for q in range(len(fps[0])):
        if not fps[0][q] == fps[1][q] == fps[2][q]:
            raise AssertionError(f"queue {q}: fingerprints differ "
                                 f"{[f[q] for f in fps]}")
        for i, snaps in enumerate(rec["snapshots"]):
            if snaps[q][0] < rec["cursor"][q]:
                raise AssertionError(f"queue {q}: node {i} snapshot "
                                     f"{snaps[q]} below the cursor "
                                     f"{rec['cursor'][q]}")
    if rec["device_snap"] != rec["host_snap"]:
        for i, (d, h) in enumerate(zip(rec["device_snap"], rec["host_snap"])):
            for q, (x, y) in enumerate(zip(d, h)):
                if x != y:
                    raise AssertionError(f"node {i} queue {q}: device "
                                         f"snapshot {x} != host {y}")
    if "installs" in rec:
        for q, (k, at) in enumerate(zip(rec["installs"],
                                        rec["applied_at_install"])):
            if k < 1 or at is None or at >= rec["cursor"][q]:
                raise AssertionError(
                    f"queue {q}: {k} installs, applied {at} at the install, "
                    f"cursor {rec['cursor'][q]}")


def queue_waves(lane, workdir, n_queues, seed=0, prefix="qw", clock=None,
                **kw):
    """``waves`` once on a fresh cluster (hand-stepped when ``clock``
    is given); the record also holds the election's seconds and the
    coordinators' steps (``steps_of``, read after they stopped)."""
    with QueueCluster(lane, workdir, n_queues, prefix, clock, parts=1,
                      **kw) as cl:
        election_s = cl.elect()
        rec = waves(cl, 0, seed)
    rec["election_s"] = election_s
    rec.update(steps_of(cl.coords))
    return rec


def snapshot_catch_up(lane, workdir, n_queues, seed=0, prefix="qc",
                      clock=None, **kw):
    """``waves`` once on a fresh cluster with node 2 cut off from
    before wave E until the leaders' snapshots."""
    with QueueCluster(lane, workdir, n_queues, prefix, clock, parts=1,
                      **kw) as cl:
        election_s = cl.elect()
        rec = waves(cl, 0, seed, cut=2)
    rec["election_s"] = election_s
    rec.update(steps_of(cl.coords))
    return rec


def queue_phase(lane, workdir, n_queues, seed=0, prefix="qp", probe=None,
                timeout_s=600.0, progress=None, **kw):
    """One started cluster, ``waves`` twice, the second with node 2 cut
    off, so the second run's catch-up installs snapshots on top of the
    first run's. Every queue must still be led by node 0 after the
    first run (a leader that moved is a liveness fault: raises).
    ``probe()`` (e.g. the card's launch counts) is read before the
    election and at the end; ``progress`` (a callable) gets a line after
    each wave. Each run is ``check``-ed. Returns {"election_s", "runs":
    [rec, rec], "probes", "steps", "sub_steps", "set_up_s",
    "tear_down_s", "wall_s"}."""
    t0 = time.perf_counter()
    out = {"probes": [probe() if probe else None]}
    with QueueCluster(lane, workdir, n_queues, prefix, None, parts=2,
                      progress=progress, **kw) as cl:
        out["set_up_s"] = time.perf_counter() - t0
        out["threads_at_start"] = threading.active_count()
        if progress is not None:
            progress(f"set-up {out['set_up_s']:.3f} s")
        out["election_s"] = cl.elect(timeout_s)
        if progress is not None:
            progress(f"election {out['election_s']:.3f} s")
        out["runs"] = [waves(cl, 0, seed, timeout_s=timeout_s)]
        moved = [q for q, g in enumerate(cl.groups(0))
                 if g.role != lane.C.R_LEADER]
        if moved:
            raise AssertionError(
                f"{len(moved)} queues not led by node 0 after run 0: "
                f"{diagnose(cl, moved[:2])}")
        out["runs"].append(waves(cl, 1, seed, cut=2, timeout_s=timeout_s))
        t = time.perf_counter()
    out["tear_down_s"] = time.perf_counter() - t
    out["probes"].append(probe() if probe else None)
    out.update(steps_of(cl.coords))
    check(lane, out["runs"][0], 0)
    check(lane, out["runs"][1], 1, prior=out["runs"][0]["cmds"])
    out["wall_s"] = time.perf_counter() - t0
    return out
