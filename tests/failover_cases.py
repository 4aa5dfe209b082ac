"""The failover of a whole fleet: the node that leads every group stops,
and the survivors re-elect all of them. Written once for any package
with the reference's module layout (``ra_tpu`` or ``ra_tpu_torch``) and
any device, as ``tests/loop_cases.py`` is: it takes a
``lane_cases.Lane`` and uses the standard library only, so the card run
imports no JAX.

- ``leader_failover``: three started coordinators, every group elected
  on node 0, one acknowledged command a group, then ``fail_over``:
  node 0 stops; every group must be led again by node 1 or 2, take one
  more acknowledged command there, and hold the sum of its acknowledged
  values on both survivors. ``fail_over`` also runs on another
  scenario's cluster (``loop_cases.flip_soak``'s ``then``).
- ``restart_rejoin``: after ``fail_over``, node 0 comes back from its
  own WAL, segments and meta store as a fresh coordinator, rejoins
  every group under the survivors' leaders, catches up to the
  acknowledged totals, and takes one more command a group on all three
  replicas. ``Disk`` opens and reopens each node's storage.
- ``replace_node``: after ``restart_rejoin``, node 0 is lost for good
  and replaced, as an operator replaces a lost broker: it is shrunk out
  of every group through the group's leader, a fresh node 3 is built,
  joins every group as a non-voter, is caught up by append and
  promoted, and takes one more command a group with nodes 1 and 2.
  ``reused_slot`` shows, hand-stepped on one group, that the joining
  non-voter in the slot the leaver left is counted in no quorum before
  its promotion.
- ``node_down_triggers``: one hand-stepped follower coordinator's
  node-down election triggers (``_on_node_down``), the threads they
  take, their delays and ``armed`` stamps, and whether a trigger is
  dropped once its leader is heard from again during the delay.

``tests/test_torch_failover.py`` runs them on both packages on the CPU;
``chip_smoke.py`` (phase loop (d), (e) and (f)) runs ``fail_over``,
``restart_rejoin`` and ``replace_node`` on the card at 10240 groups x 3
replicas,
WAL-backed, on the full-width flip soak's cluster. A survivor of the
reference arms one ``threading.Timer`` a followed group; the port's
arms them all on one timer thread.
"""

import gc
import importlib
import os
import random
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

from lane_cases import ManualClock, step_until
from loop_cases import await_, replies_ok, steps_of


def os_threads() -> int:
    """The process's thread count, native threads included."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                return int(line.split()[1])
    raise RuntimeError("no thread count in /proc/self/status")


def resident_bytes() -> int:
    """The process's resident memory, from ``/proc/self/statm``."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _names() -> dict:
    """The process's Python threads by name, their digits dropped."""
    out = {}
    for t in threading.enumerate():
        k = "".join(ch for ch in t.name if not ch.isdigit())
        out[k] = out.get(k, 0) + 1
    return out


class Sampler:
    """Samples the thread count and resident memory every ``every_s`` on
    a thread of its own, keeping the peaks (and the Python threads by
    name at the thread peak); ``mark()`` takes a sample by hand and
    returns it."""

    def __init__(self, every_s=0.01):
        self.every_s = every_s
        self.peak_threads = self.peak_rss = 0
        self.peak_names = {}
        self.samples = 0
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="failover-sampler", daemon=True)

    def mark(self):
        n, rss = os_threads(), resident_bytes()
        if n > self.peak_threads:
            self.peak_names = _names()
        self.peak_threads = max(self.peak_threads, n)
        self.peak_rss = max(self.peak_rss, rss)
        self.samples += 1
        return n, rss

    def _run(self):
        while not self._done.wait(self.every_s):
            self.mark()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=5)


class TriggerSpy:
    """Watches coordinators for their node-down calls, every
    ``ElectionTimeout`` delivered to them (sent by the detector's
    suspicion sweep, or else by a node-down trigger) and which of those
    opened a pre-vote round, by group. It wraps the instance's
    ``deliver``, ``_handle_rare`` and ``_on_node_down``, which the
    coordinator's threads look up on the instance at each call."""

    def __init__(self, lane, coords, t0):
        self.downs = []  # (s since t0, node, node seen down)
        self.delivered = []  # (s since t0, node, group, armed_at, path)
        self.started = {}  # (group, node) -> path of the last round opener
        self.shed = 0  # deliveries refused (deliver returned False)
        self._sent = {}  # id(msg) -> (msg, path)
        self._et = lane.protocol.ElectionTimeout
        self._t0 = t0
        self._lock = threading.Lock()
        for c in coords:
            self._watch(c)

    def _watch(self, c):
        et, sent = self._et, self._sent
        deliver, handle, down = c.deliver, c._handle_rare, c._on_node_down

        def spy_deliver(to, msg, from_sid):
            if type(msg) is not et:
                return deliver(to, msg, from_sid)
            path = ("sweep" if threading.current_thread() is c._detector
                    else "trigger")
            with self._lock:
                sent[id(msg)] = (msg, path)
                self.delivered.append((time.perf_counter() - self._t0,
                                       c.name, to[0], msg.armed_at, path))
            ok = deliver(to, msg, from_sid)
            if not ok:
                with self._lock:
                    self.shed += 1
            return ok

        def spy_handle(g, msg, *args, **kw):
            if type(msg) is not et:
                return handle(g, msg, *args, **kw)
            token = g.pre_vote_token
            out = handle(g, msg, *args, **kw)
            if g.pre_vote_token != token:
                entry = sent.get(id(msg))
                self.started[(g.name, c.name)] = (
                    entry[1] if entry is not None and entry[0] is msg
                    else "other")
            return out

        def spy_down(node_name):
            self.downs.append((time.perf_counter() - self._t0, c.name,
                               node_name))
            return down(node_name)

        c.deliver, c._handle_rare, c._on_node_down = (
            spy_deliver, spy_handle, spy_down)


def _send(lane, coord, sids, values, bulk):
    futs = [lane.api.Future() for _ in sids]
    msgs = [(sid, lane.command(v, fut), None)
            for sid, v, fut in zip(sids, values, futs)]
    if bulk:
        coord.deliver_many(msgs)
    else:
        for m in msgs:
            coord.deliver(*m)
    return futs


def leader_failover(lane, prefix="lf", groups=64, capacity=None,
                    election_timeout_s=0.3, detector_poll_s=0.05,
                    tick_interval_s=0.2, seed=0, logs=None, metas=None,
                    probe=None, bulk=False, reply_timeout_s=30.0,
                    settle_timeout_s=60.0, sample_every_s=0.01, then=None):
    """Three started coordinators ``prefix``0..2 with ``groups`` groups
    (members on all three, an adder machine), every group elected on
    node 0 by one ``ElectionTimeout``; one acknowledged command a group
    (values from ``random.Random(seed)``, 1..1000), applied on every
    replica; then ``fail_over``:
    node 0 stops, every group is led again by node 1 or 2 and takes one
    more command there, and both survivors hold each group's two values.

    ``logs(coords, node_names)``, where given, returns each node's list
    of logs by group (e.g. WAL-backed), which the caller closes after
    this returns; ``metas``, each node's meta store (term and vote made
    durable), by node. ``probe()`` (e.g. the card's launch counts) is
    read before the stop and at the end. ``bulk`` sends the election
    triggers and each round of commands through one ``deliver_many``
    a coordinator, where 10240 single deliveries could fill the lane.
    ``then(coords, totals)``, where given, runs after ``fail_over`` on
    the cluster (node 0 stopped, both survivors at ``totals``, by
    group) before it stops; its result is the record's ``then``.

    The record is ``fail_over``'s, with the election's and the first
    write's wall time, the probes, each coordinator's ``steps`` and
    ``sub_steps`` (read after it stopped) and the wall time."""
    capacity = capacity or groups
    names = [f"{prefix}{i}" for i in range(3)]
    gname = [f"g{g}" for g in range(groups)]
    rng = random.Random(seed)
    first = [rng.randint(1, 1000) for _ in range(groups)]
    second = [rng.randint(1, 1000) for _ in range(groups)]
    coords = [
        lane.coord(n, capacity=capacity, num_peers=3,
                   election_timeout_s=election_timeout_s,
                   detector_poll_s=detector_poll_s,
                   tick_interval_s=tick_interval_s,
                   meta=metas[i] if metas is not None else None)
        for i, n in enumerate(names)
    ]
    rec = {"groups": groups, "probes": []}
    t0 = time.perf_counter()
    try:
        for c in coords:
            c.start()
        per_node = (logs(coords, names) if logs is not None
                    else [[None] * groups for _ in coords])
        for c, node_logs in zip(coords, per_node):
            c.add_groups([(gname[g], f"cl{g}", [(gname[g], n) for n in names],
                           lane.adder(), node_logs[g])
                          for g in range(groups)])
        t = time.perf_counter()
        msgs = [((gname[g], names[0]), lane.protocol.ElectionTimeout(), None)
                for g in range(groups)]
        if bulk:
            coords[0].deliver_many(msgs)
        else:
            for m in msgs:
                coords[0].deliver(*m)
        by0 = coords[0].by_name
        await_(lambda: all(by0[n].role == lane.C.R_LEADER for n in gname),
               timeout=settle_timeout_s, what="leaders on node 0")
        rec["election_s"] = time.perf_counter() - t

        t = time.perf_counter()
        replies_ok(_send(lane, coords[0], [(n, names[0]) for n in gname],
                         first, bulk), reply_timeout_s)
        rec["write_before"] = _rate(groups, time.perf_counter() - t)
        # every replica applied it, so each follower knows its leader
        await_(lambda: all(c.by_name[gname[g]].machine_state == first[g]
                           for c in coords for g in range(groups)),
               timeout=settle_timeout_s, what="every replica applied")
        rec["probes"].append(probe() if probe else None)
        rec.update(fail_over(lane, coords, first, second, bulk=bulk,
                             reply_timeout_s=reply_timeout_s,
                             settle_timeout_s=settle_timeout_s,
                             sample_every_s=sample_every_s))
        if then is not None:
            rec["then"] = then(coords, rec["expect"])
    finally:
        for c in coords:
            if c is not None:  # a restart that failed midway
                c.stop()
    rec["probes"].append(probe() if probe else None)
    rec.update(steps_of(coords))
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def fail_over(lane, coords, totals, values, bulk=False, reply_timeout_s=30.0,
              settle_timeout_s=60.0, sample_every_s=0.01):
    """On three started coordinators whose groups ``g0``.. are all led
    by ``coords[0]`` and hold the acknowledged ``totals`` (by group) on
    every replica: stop ``coords[0]``, wait on state until every group
    is led by one of the survivors, send one more command a group
    (``values``) through its new leader (one ``deliver_many`` a
    survivor with ``bulk``), every reply ``ok``, and wait until each
    group's machine state on both survivors is its total plus its
    value. The survivors are left running.

    The record holds, in seconds from the stop: ``detect_s`` (the first
    survivor's node-down call), ``first_trigger_s`` (the first node-down
    trigger delivered), ``led_s`` (every group led again) and
    ``led_quantiles_s`` (half, 90 and 99 % of the groups first seen led,
    polled every 0.1 s); the highest term and the new leaders' terms;
    how many groups a node-down trigger and how many the suspicion
    sweep elected; the triggers armed (one a group a survivor follows
    on node 0) and the ``ElectionTimeout`` deliveries by path, after
    waiting until every armed trigger was delivered, and how many of
    them ``deliver`` refused (``shed``); the peak thread count and
    resident memory sampled from the stop to the end beside their
    values just before it; ``ingress_ring_full`` and
    ``ingress_overflow_msgs`` of the survivors; the write's wall time
    and commands per second; the leader of each group (1 or 2); the
    machine states and the totals they must equal."""
    groups = len(totals)
    names = [c.name for c in coords]
    gname = [f"g{g}" for g in range(groups)]
    survivors = coords[1:]
    rec = {}
    # the node-down triggers each survivor will arm: one a group it
    # follows whose leader is on node 0
    rec["armed"] = sum(
        1 for c in survivors for n in gname
        if c.by_name[n].sid_of(c.by_name[n].leader_slot) == (n, names[0]))
    with Sampler(sample_every_s) as sampler:
        t0 = time.perf_counter()
        spy = TriggerSpy(lane, survivors, t0)
        rec["threads_before"], rec["rss_before"] = sampler.mark()
        coords[0].stop()
        rec["stop_s"] = time.perf_counter() - t0

        def leader_of(n):
            for c in survivors:
                if c.by_name[n].role == lane.C.R_LEADER:
                    return c
            return None

        # when each group is first seen led, polled every 0.1 s
        led_at = {}
        deadline = time.monotonic() + settle_timeout_s
        while True:
            now = time.perf_counter() - t0
            led_at.update((n, now) for n in gname
                          if n not in led_at and leader_of(n) is not None)
            if len(led_at) == groups:
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{groups - len(led_at)} groups never led again")
            time.sleep(0.1)
        rec["led_s"] = time.perf_counter() - t0
        when = sorted(led_at.values())
        rec["led_quantiles_s"] = {
            q: when[min(groups - 1, groups * q // 100)] for q in (50, 90, 99)}
        leaders = [leader_of(n) for n in gname]
        rec["leaders"] = [names.index(c.name) for c in leaders]
        terms = [c.by_name[n].term for c, n in zip(leaders, gname)]
        rec["term"] = max(c.by_name[n].term for c in survivors for n in gname)
        rec["leader_terms"] = {t: terms.count(t) for t in sorted(set(terms))}
        # the path that opened each group's winning round (a leader
        # opens no further round)
        by_path = {}
        for n, c in zip(gname, leaders):
            p = spy.started.get((n, c.name), "none")
            by_path[p] = by_path.get(p, 0) + 1
        rec["elected_by"] = by_path

        t = time.perf_counter()
        futs = []
        for c in survivors:
            mine = [g for g in range(groups) if leaders[g] is c]
            futs += _send(lane, c, [(gname[g], c.name) for g in mine],
                          [values[g] for g in mine], bulk)
        replies_ok(futs, reply_timeout_s)
        rec["write_after"] = _rate(groups, time.perf_counter() - t)
        expect = [a + b for a, b in zip(totals, values)]
        await_(lambda: all(c.by_name[gname[g]].machine_state == expect[g]
                           for c in survivors for g in range(groups)),
               timeout=settle_timeout_s,
               what="both survivors at the acknowledged totals")
        rec["settled_s"] = time.perf_counter() - t0
        # every armed trigger reaches its survivor, late or not
        await_(lambda: sum(1 for d in spy.delivered
                           if d[4] == "trigger") >= rec["armed"],
               timeout=settle_timeout_s, what="every trigger delivered")
        sampler.mark()
    rec["peak_threads"] = sampler.peak_threads
    rec["peak_rss"] = sampler.peak_rss
    rec["samples"] = sampler.samples
    downs = [d for d in spy.downs if d[2] == names[0]]
    assert downs, "no survivor saw node 0 stop"
    rec["detect_s"] = min(d[0] for d in downs)
    triggers = [d[0] for d in spy.delivered if d[4] == "trigger"]
    rec["first_trigger_s"] = min(triggers) if triggers else None
    rec["delivered"] = {p: sum(1 for d in spy.delivered if d[4] == p)
                        for p in ("trigger", "sweep")}
    rec["shed"] = spy.shed
    rec["states"] = [[c.by_name[n].machine_state for n in gname]
                     for c in survivors]
    rec["expect"] = expect
    rec["counters"] = {
        k: [c.counters.get(k) for c in survivors]
        for k in ("ingress_ring_full", "ingress_overflow_msgs")}
    return rec


def _rate(cmds, s):
    return {"cmds": cmds, "s": s, "cmds_per_s": cmds / s}


class Disk:
    """Each node's storage under ``workdir/<node>``, for any package of
    the reference's layout (imported by ``lane.name``): a shared WAL and
    segment writer, one ``FileMeta`` (``meta.dat``) and a WAL-backed
    ``Log`` a group (uid ``g<g>`` under ``data/``), by node index.
    ``wal_kw`` goes to the ``Wal``; ``build_logs(i)``, where given,
    builds node i's logs in place of the one-by-one default. A node's
    WAL and segment writer notify the coordinator attached to it, and
    nothing before one is.
    ``restart_rejoin`` uses ``close``, ``open_meta``, ``open_wal``,
    ``logs`` and ``wait_idle``; ``replace_node`` opens a node that the
    cluster did not start with (index 3 of four ``names``) alone, with
    ``open_meta``, ``open_wal``, ``logs`` and ``attach``."""

    def __init__(self, lane, workdir, names, groups, wal_kw=None,
                 build_logs=None):
        def mod(sub):
            return importlib.import_module(f"{lane.name}.{sub}")

        self._Wal = mod("log.wal").Wal
        self._SegmentWriter = mod("log.segment_writer").SegmentWriter
        self._TableRegistry = mod("log.tables").TableRegistry
        self._FileMeta = mod("log.meta_store").FileMeta
        self._Log = mod("log.log").Log
        self.torch = lane.torch
        self.dirs = [os.path.join(workdir, n) for n in names]
        self.groups = groups
        self.wal_kw = wal_kw or {}
        self.build_logs = build_logs
        self.metas = [None] * len(names)
        self.entries = [None] * len(names)  # (tables, wal, dir)
        self.coords = [None] * len(names)  # notified by each node's WAL

    def open_meta(self, i):
        """Node i's meta store, reloaded from its journal."""
        self.metas[i] = self._FileMeta(os.path.join(self.dirs[i], "meta.dat"))
        return self.metas[i]

    def open_wal(self, i, coord=None):
        """Node i's segment writer and WAL (recovering what the WAL
        files hold), notifying ``coord`` or, where none is given, the
        coordinator ``attach`` names later."""
        if coord is not None:
            self.attach(i, coord)
        coords = self.coords

        def notify(uid, evt):
            c = coords[i]
            if c is not None:
                c.wal_notify(uid, evt)

        def notify_many(items):
            c = coords[i]
            if c is not None:
                c.wal_notify_many(items)

        d = self.dirs[i]
        tables = self._TableRegistry()
        sw = self._SegmentWriter(os.path.join(d, "data"), tables, notify)
        w = self._Wal(os.path.join(d, "wal"), tables, notify,
                      segment_writer=sw, **self.wal_kw)
        w.notify_many = notify_many
        self.entries[i] = (tables, w, d)

    def attach(self, i, coord):
        """Route node i's storage notifications to ``coord``."""
        self.coords[i] = coord

    def logs(self, i):
        """Node i's logs by group, over what their directories hold."""
        if self.build_logs is not None:
            return self.build_logs(i)
        tables, w, d = self.entries[i]
        return [self._Log(f"g{g}", os.path.join(d, "data", f"g{g}"), tables, w)
                for g in range(self.groups)]

    def open_all(self, coords, names):
        """The ``logs`` hook of ``leader_failover`` and ``flip_soak``:
        every node's WAL for its coordinator, then its logs."""
        for i, c in enumerate(coords):
            self.open_wal(i, c)
        return [self.logs(i) for i in range(len(coords))]

    def wait_idle(self, i, timeout_s=600.0):
        """Wait until node i's segment writer has flushed what it was
        handed (a reopened WAL hands it every recovered entry)."""
        _tables, w, _d = self.entries[i]
        if not w.segment_writer.wait_idle(timeout_s):
            raise AssertionError(f"node {i}'s segment writer still busy "
                                 f"after {timeout_s} s")

    def close(self, i):
        """Close node i's WAL, segment writer and meta store. The
        reference's segment writer first finishes its flushes: its
        ``close()`` waits 10 s for its thread and then drains beside a
        thread that may still be flushing. The port's waits for its
        thread itself."""
        if self.entries[i] is not None:
            _tables, w, _d = self.entries[i]
            w.close()
            if not self.torch:
                self.wait_idle(i)
            w.segment_writer.close()
            self.entries[i] = None
        self.coords[i] = None
        if self.metas[i] is not None:
            self.metas[i].close()
            self.metas[i] = None

    def close_all(self):
        for i in range(len(self.dirs)):
            self.close(i)


class MetaSpy:
    """Counts a meta store's ``fdatasync``s (each ``store_sync``, and
    each ``sync`` that found records to flush) and the votes it
    persists, by group uid, from ``armed()`` on. It wraps the
    instance's ``store``, ``store_sync`` and ``sync``."""

    def __init__(self, meta):
        self.syncs = 0
        self.votes = {}  # uid -> the last voted_for persisted
        self._on = False
        store, store_sync, sync = meta.store, meta.store_sync, meta.sync

        def note(uid, key, value):
            if self._on and key == "voted_for" and value is not None:
                self.votes[uid] = tuple(value)

        def spy_store(uid, key, value):
            note(uid, key, value)
            return store(uid, key, value)

        def spy_store_sync(uid, key, value):
            note(uid, key, value)
            if self._on:
                self.syncs += 1
            return store_sync(uid, key, value)

        def spy_sync():
            if self._on and meta._dirty:
                self.syncs += 1
            return sync()

        meta.store, meta.store_sync, meta.sync = (
            spy_store, spy_store_sync, spy_sync)

    def arm(self):
        self._on = True


def quiet_counts(coords, probe=None, timeout_s=0.05):
    """``probe()`` and each coordinator's ``steps`` and ``sub_steps``
    read together while every running coordinator's state lock is held
    (a step dispatches and counts itself under that lock), so launches
    and steps match exactly. A lock not taken within ``timeout_s``
    drops all of them and the read starts again."""
    live = [c for c in coords if c is not None and c.running]
    while True:
        held = []
        for c in live:
            if not c._state_lock.acquire(timeout=timeout_s):
                break
            held.append(c)
        try:
            if len(held) == len(live):
                return (probe() if probe else None), steps_of(coords)
        finally:
            for c in reversed(held):
                c._state_lock.release()
        time.sleep(0.001)


def restart_rejoin(lane, coords, disk, totals, values, bulk=False,
                   probe=None, memory=None, reply_timeout_s=30.0,
                   settle_timeout_s=60.0, sample_every_s=0.01, poll_s=0.1,
                   timeline_every_s=2.0):
    """After ``fail_over`` on the same coordinators (``coords[0]``
    stopped, every group ``g0``.. led by node 1 or 2, both survivors
    at ``totals``, by group): node 0 comes back from disk. Its WAL,
    segment writer and meta store are closed (``disk.close(0)``) and
    the stopped coordinator dropped; the meta store is reopened, the
    WAL reopened with recovery (its entries flushed to segments), node
    0's logs built over their directories, a fresh coordinator named
    node 0 built with the meta store (the old one's capacity, peers,
    timeouts and active-set mode) and attached to the storage,
    every group added over them (``add_groups``: term and vote from
    the meta store, the recovered tails) and the coordinator started.
    ``coords[0]`` becomes the new coordinator, so the caller stops it.
    The scenario waits on state until every group's replica on node 0
    follows the survivor leading it, in its term, at its total; then
    sends one more command a group (``values``) through its leader
    (one ``deliver_many`` a survivor with ``bulk``), every reply
    ``ok``, and waits until all three replicas hold the new totals.

    The record holds, in seconds from the restart: ``close_s`` (node
    0's storage closed, its segment writer's flushes finished),
    ``reopen_s`` (storage reopened, WAL recovery and its segment flush
    included), ``logs_s``, ``add_groups_s`` (the coordinator built
    and every group added), ``started_s``,
    ``first_aer_s`` (a group of node 0 first seen following a leader,
    polled every ``poll_s``), ``at_totals_s`` (10, 50, 90, 99 % and all
    of node 0's groups first seen following at their totals;
    ``recover_s``, the time to recover, is the last), a ``timeline``
    every ``timeline_every_s`` (seconds, groups following a leader,
    groups at their totals, node 0's steps and messages processed, the
    thread count) and ``settled_s``; each group's recovered last index
    and term and its term and vote read back from the meta store
    before ``add_groups``; node 0's highest term against the highest
    its meta store held, and the groups whose term sits below it; the
    survivors' highest term before and after; the groups of node 0
    that persisted a vote (for a peer: ``granted``; for itself:
    ``candidate``) and the pre-vote rounds they opened after the
    restart; the meta store's ``fdatasync``s from the restart to the
    end; the peak thread count and resident memory against their
    values before the restart, with the Python threads by name at both;
    ``memory()`` (e.g. the card's allocated bytes) before, once the
    stopped coordinator was dropped, after ``add_groups`` and at the
    end; lane and egress counters of all three; the write's rate;
    ``probe()`` with the coordinators' steps, read exactly together
    (``quiet_counts``) at the restart and at the end, and the dropped
    coordinator's own; the machine states and the
    totals they must equal."""
    groups = len(totals)
    names = [c.name for c in coords]
    gname = [f"g{g}" for g in range(groups)]
    survivors = coords[1:]
    old = coords[0]
    assert not old.running, "node 0 must be stopped before its restart"
    coord_kw = {"capacity": old.capacity, "num_peers": old.P,
                "election_timeout_s": old.election_timeout_s,
                "tick_interval_s": old.tick_interval_s,
                "detector_poll_s": old._detector_poll_s,
                "active_set": old.active_set}

    def leader_of(n):
        for c in survivors:
            if c.by_name[n].role == lane.C.R_LEADER:
                return c
        return None

    rec = {"groups": groups, "replaced_steps": steps_of([old])}
    rec["survivor_term_before"] = max(
        c.by_name[n].term for c in survivors for n in gname)
    rec["probe_before"], rec["steps_before"] = quiet_counts(coords, probe)
    mem = {}
    with Sampler(sample_every_s) as sampler:
        rec["threads_before"], rec["rss_before"] = sampler.mark()
        names_before = _names()
        if memory is not None:
            mem["before"] = memory()
        t0 = time.perf_counter()
        disk.close(0)
        rec["close_s"] = time.perf_counter() - t0
        coords[0] = old = None
        gc.collect()
        if memory is not None:
            mem["released"] = memory()
        meta = disk.open_meta(0)
        spy = MetaSpy(meta)
        uid = [f"cl{g}_{gname[g]}" for g in range(groups)]
        rec["meta"] = [
            (meta.fetch(u, "current_term", 0),
             None if meta.fetch(u, "voted_for") is None
             else list(meta.fetch(u, "voted_for"))) for u in uid]
        # node 0 joins the registry only with its coordinator, once its
        # logs are open: a registered node that is not yet stepping
        # draws every leader's resync appends into full lanes
        disk.open_wal(0)
        # recovery hands every recovered entry to the segment writer;
        # a log opened meanwhile could list a segment file still being
        # written (a torn header fails its open)
        disk.wait_idle(0)
        rec["reopen_s"] = time.perf_counter() - t0
        logs = disk.logs(0)
        rec["logs_s"] = time.perf_counter() - t0
        rec["recovered"] = [list(log.last_index_term()) for log in logs]
        new = lane.coord(names[0], meta=meta, **coord_kw)
        disk.attach(0, new)
        spy.arm()
        new.add_groups([(gname[g], f"cl{g}", [(gname[g], n) for n in names],
                         lane.adder(), logs[g]) for g in range(groups)])
        rec["add_groups_s"] = time.perf_counter() - t0
        if memory is not None:
            mem["added"] = memory()
        coords[0] = new
        new.start()
        rec["started_s"] = time.perf_counter() - t0

        by0 = new.by_name
        first_aer = None
        done_at = {}
        timeline = []
        deadline = time.monotonic() + settle_timeout_s
        while True:
            now = time.perf_counter() - t0
            following = sum(1 for n in gname if by0[n].leader_slot >= 0)
            if first_aer is None and following:
                first_aer = now
            for g, n in enumerate(gname):
                if n in done_at:
                    continue
                g0, lc = by0[n], leader_of(n)
                if (lc is not None and g0.role == lane.C.R_FOLLOWER
                        and g0.term == lc.by_name[n].term
                        and g0.sid_of(g0.leader_slot) == (n, lc.name)
                        and g0.machine_state == totals[g]):
                    done_at[n] = now
            if not timeline or now - timeline[-1][0] >= timeline_every_s:
                timeline.append((now, following, len(done_at), new.steps,
                                 new.msgs_processed, sampler.mark()[0]))
            if len(done_at) == groups:
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{groups - len(done_at)} groups of node 0 never "
                    f"rejoined at their totals")
            time.sleep(poll_s)
        rec["first_aer_s"] = first_aer
        rec["timeline"] = timeline
        when = sorted(done_at.values())
        rec["at_totals_s"] = {q: when[min(groups - 1, groups * q // 100)]
                              for q in (10, 50, 90, 99)}
        rec["at_totals_s"][100] = rec["recover_s"] = when[-1]

        t = time.perf_counter()
        leaders = [leader_of(n) for n in gname]
        futs = []
        for c in survivors:
            mine = [g for g in range(groups) if leaders[g] is c]
            futs += _send(lane, c, [(gname[g], c.name) for g in mine],
                          [values[g] for g in mine], bulk)
        replies_ok(futs, reply_timeout_s)
        rec["write_after"] = _rate(groups, time.perf_counter() - t)
        expect = [a + b for a, b in zip(totals, values)]
        await_(lambda: all(c.by_name[gname[g]].machine_state == expect[g]
                           for c in coords for g in range(groups)),
               timeout=settle_timeout_s,
               what="all three replicas at the acknowledged totals")
        rec["settled_s"] = time.perf_counter() - t0
        sampler.mark()
    rec["probe_after"], rec["steps_after"] = quiet_counts(coords, probe)
    if memory is not None:
        mem["end"] = memory()
    rec["memory"] = mem
    rec["thread_names"] = {"before": names_before,
                           "peak": sampler.peak_names}
    rec["peak_threads"] = sampler.peak_threads
    rec["peak_rss"] = sampler.peak_rss
    rec["leaders"] = [names.index(c.name) for c in leaders]
    terms = [by0[n].term for n in gname]
    rec["term"] = max(terms)
    rec["meta_term"] = max(t for t, _v in rec["meta"])
    rec["below_meta"] = sum(1 for t, (m, _v) in zip(terms, rec["meta"])
                            if t < m)
    rec["survivor_term_after"] = max(
        c.by_name[n].term for c in survivors for n in gname)
    me = {(n, names[0]) for n in gname}
    rec["votes"] = {
        "granted": sum(1 for v in spy.votes.values() if v not in me),
        "candidate": sum(1 for v in spy.votes.values() if v in me)}
    rec["pre_vote_rounds"] = sum(by0[n].pre_vote_token for n in gname)
    rec["meta_syncs"] = spy.syncs
    rec["states"] = [[c.by_name[n].machine_state for n in gname]
                     for c in coords]
    rec["expect"] = expect
    rec["counters"] = {
        k: [c.counters.get(k) for c in coords]
        for k in ("ingress_ring_full", "ingress_overflow_msgs",
                  "lane_wedges", "lane_recoveries", "stale_peer_resends",
                  "egress_thread_ring_full")}
    return rec


def _quantiles(when, qs=(10, 50, 99)):
    """The times by which ``qs`` per cent and all of ``when`` had come."""
    when = sorted(when)
    n = len(when)
    out = {q: when[min(n - 1, n * q // 100)] for q in qs}
    out[100] = when[-1]
    return out


def _reply_kind(reply) -> str:
    """A reply's tag, with its detail where that is a word (``ok`` for
    ``("ok", None, leader)`` and ``("ok", 42, leader)``;
    ``ok:already_member``, ``error:cluster_change_not_permitted``)."""
    if not isinstance(reply, tuple) or not reply:
        return repr(reply)
    detail = reply[1] if len(reply) > 1 else None
    return (f"{reply[0]}:{detail}" if isinstance(detail, str)
            else str(reply[0]))


class RowSpy:
    """Counts a coordinator's member-row updates (``_sync_member_rows``,
    one a group a change: the reference's writes the device rows, the
    port's stages them) and sums their wall time; on the port also its
    flushes (``_flush_member_rows``: one device write a pass for every
    staged group), those that wrote rows and their wall time. It wraps
    the instance's methods, which the coordinator looks up on the
    instance at each call."""

    def __init__(self, coord):
        self.calls, self.s = 0, 0.0
        self.flushes, self.flush_s = 0, 0.0
        sync = coord._sync_member_rows

        def spy(g):
            t = time.perf_counter()
            try:
                return sync(g)
            finally:
                self.s += time.perf_counter() - t
                self.calls += 1

        coord._sync_member_rows = spy
        flush = getattr(coord, "_flush_member_rows", None)
        if flush is None:
            return

        def spy_flush():
            if not coord._member_rows:
                return flush()
            t = time.perf_counter()
            try:
                return flush()
            finally:
                self.flush_s += time.perf_counter() - t
                self.flushes += 1

        coord._flush_member_rows = spy_flush


def member_view(coord, gname) -> list:
    """Each group's members on ``coord`` as sorted (node, status) pairs,
    the status ``voter`` or ``nonvoter``: slots are node-local, so two
    nodes agree when these do."""
    out = []
    for n in gname:
        g = coord.by_name[n]
        out.append(sorted(
            (m[1], "voter" if g.voter_status.get(i) == "voter"
             else "nonvoter")
            for i, m in enumerate(g.members) if m is not None))
    return out


def row_mismatches(lane, coord, gname) -> int:
    """The groups whose device ``active``/``voting`` rows on ``coord``
    differ from its host member table (the state read once)."""
    f = lane.fields(coord)
    active, voting = f["active"], f["voting"]
    bad = 0
    for n in gname:
        g = coord.by_name[n]
        want_a = [False] * active.shape[1]
        want_v = [False] * active.shape[1]
        for i, m in enumerate(g.members):
            if m is not None:
                want_a[i] = True
                want_v[i] = g.voter_status.get(i) == "voter"
        if (list(map(bool, active[g.gid])) != want_a
                or list(map(bool, voting[g.gid])) != want_v):
            bad += 1
    return bad


def replace_node(lane, coords, disk, totals, values, new_name, bulk=False,
                 probe=None, memory=None, api_sample=256, clients=32,
                 reply_timeout_s=30.0, settle_timeout_s=60.0,
                 sample_every_s=0.01, poll_s=0.1, timeline_every_s=2.0):
    """After ``restart_rejoin`` on the same coordinators (node 0
    following in every group ``g0``.., nodes 1 and 2 leading, all three
    at ``totals``, by group): node 0 is lost for good and replaced by a
    fresh node ``new_name`` (storage index 3 of ``disk``).

    Node 0's coordinator stops, its storage closes (``disk.close(0)``)
    and the coordinator is dropped. Every group's leader takes
    ``RA_LEAVE`` of node 0 (the command ``api.remove_member`` builds,
    ``await_consensus``): ``api_sample`` groups through
    ``api.remove_member`` itself on ``clients`` client threads, the
    rest in one ``deliver_many`` a leader with ``bulk``; every reply
    ``ok``. Once no survivor's table names node 0 and every leader may
    change its cluster again, node 3's meta store, WAL and logs are
    opened (its logs first: a coordinator registers when it is built),
    then its coordinator is built with node 0's settings, attached,
    given every group with members nodes 1, 2 and 3 (``add_groups``)
    and started; ``coords[0]`` becomes it, so the caller stops it.
    Every leader then takes ``RA_JOIN`` of node 3 as a non-voter
    (``api.add_member(..., voter=False)`` for the sample), every reply
    ``ok``. The scenario waits on state until in every group node 3
    follows the leader in its term at its total and the leader holds it
    as a voter, then sends one more command a group (``values``)
    through its leader, every reply ``ok``, and waits until nodes 1, 2
    and 3 hold the new totals.

    The record holds, in seconds from the start: ``stop_s`` (node 0
    stopped, its storage closed), ``shrink_sent_s``, ``shrink_acked_s``
    (every leave acknowledged), ``shrink_done_s``, ``logs_s`` and
    ``add_groups_s`` of node 3, ``started_s``, ``grow_sent_s``,
    ``grow_acked_s`` (polled with the rest),
    ``first_aer_s`` (a group of node 3 first seen following, polled
    every ``poll_s``), ``at_totals_s`` and ``promoted_s`` (10, 50, 99 %
    and all of the groups first seen with node 3 at its total, and
    first seen held as a voter by the leader), ``replace_s`` (the time
    to replace a node: the last group with node 3 both at its total and
    a voter), the promotion's lag after the catch-up, a ``timeline``
    every ``timeline_every_s`` (seconds, node 3's groups following, at
    their totals, promoted; node 3's steps and messages processed; the
    thread count) and ``settled_s``. Beside them: the replies of the
    shrink, the grow and the write by kind; on nodes 1, 2 and 3 the
    groups whose table still names node 0, each group's members and
    their voter statuses (``member_view``), and the groups whose device
    rows differ from the host table (``row_mismatches``); the survivors'
    highest term before and after; node 3's pre-vote rounds; the meta
    stores' ``fdatasync``s by node; the member-row updates and the
    port's flushes of them by node, counted and timed (``RowSpy``); the
    peak thread count and resident
    memory against their values before, with the Python threads by
    name; ``memory()`` before, once node 0's coordinator was dropped,
    after ``add_groups`` and at the end; lane counters by node, and the
    snapshot chunks node 3 received (``snapshot_chunks``: its logs catch
    up by append, so none); ``probe()`` with the coordinators' steps read
    exactly together (``quiet_counts``) at the start and the end, and node 0's
    own steps at its stop (``replaced_steps``); the write's rate; the
    machine states and the totals they must equal."""
    P = lane.protocol
    groups = len(totals)
    names = [c.name for c in coords]
    gname = [f"g{g}" for g in range(groups)]
    survivors = coords[1:]
    old = coords[0]
    node0 = names[0]
    coord_kw = {"capacity": old.capacity, "num_peers": old.P,
                "election_timeout_s": old.election_timeout_s,
                "tick_interval_s": old.tick_interval_s,
                "detector_poll_s": old._detector_poll_s,
                "active_set": old.active_set}
    step = max(1, groups // api_sample) if api_sample else 0
    via_api = set(range(0, groups, step)[:api_sample]) if step else set()

    def leader_of(n):
        for c in survivors:
            if c.by_name[n].role == lane.C.R_LEADER:
                return c
        return None

    def change(kind, data, pool):
        """``kind`` with ``data(g)`` to every group's leader: the API
        sample through ``api.remove_member`` / ``api.add_member``, the
        rest as the command those build. Returns when they were sent and
        the replies' futures."""
        leaders = [leader_of(n) for n in gname]
        assert all(leaders), "a group without a leader"

        def call(g):
            sid = (gname[g], leaders[g].name)
            if kind == P.RA_LEAVE:
                return lane.api.remove_member(sid, data(g),
                                              timeout=reply_timeout_s)
            member, voter = data(g)
            return lane.api.add_member(sid, member, voter=voter,
                                       timeout=reply_timeout_s)

        calls = [pool.submit(call, g) for g in sorted(via_api)]
        futs = []
        for c in survivors:
            msgs = []
            for g in range(groups):
                if leaders[g] is c and g not in via_api:
                    fut = lane.api.Future()
                    futs.append(fut)
                    msgs.append(((gname[g], c.name), P.Command(
                        kind=kind, data=data(g),
                        reply_mode="await_consensus", from_ref=fut), None))
            if bulk:
                c.deliver_many(msgs)
            else:
                for m in msgs:
                    c.deliver(*m)
        return time.perf_counter(), futs + calls

    def kinds(futs):
        return dict(Counter(_reply_kind(f.result(timeout=reply_timeout_s))
                            for f in futs))

    rec = {"groups": groups, "api_sample": len(via_api)}
    rec["survivor_term_before"] = max(
        c.by_name[n].term for c in survivors for n in gname)
    spies = [MetaSpy(m) if m is not None else None
             for m in (disk.metas[1], disk.metas[2])]
    rows = [RowSpy(c) for c in survivors]
    mem = {}
    pool = ThreadPoolExecutor(clients, thread_name_prefix="replace-client")
    try:
        # every client thread started before the first count, so that
        # the counts before and after both hold them
        ready = threading.Barrier(clients + 1)
        started = [pool.submit(ready.wait) for _ in range(clients)]
        ready.wait()
        for f in started:
            f.result()
        rec["probe_before"], rec["steps_before"] = quiet_counts(coords, probe)
        with Sampler(sample_every_s) as sampler:
            rec["threads_before"], rec["rss_before"] = sampler.mark()
            names_before = _names()
            if memory is not None:
                mem["before"] = memory()
            for s in spies:
                if s is not None:
                    s.arm()
            t0 = time.perf_counter()
            old.stop()
            rec["replaced_steps"] = steps_of([old])
            disk.close(0)
            rec["stop_s"] = time.perf_counter() - t0
            coords[0] = old = None
            gc.collect()
            if memory is not None:
                mem["released"] = memory()

            sent, futs = change(P.RA_LEAVE, lambda g: (gname[g], node0), pool)
            rec["shrink_sent_s"] = sent - t0
            rec["replies"] = {"shrink": kinds(futs)}
            rec["shrink_acked_s"] = time.perf_counter() - t0
            await_(lambda: all(
                (n, node0) not in c.by_name[n].members
                for c in survivors for n in gname) and all(
                leader_of(n).by_name[n].cluster_change_permitted
                for n in gname),
                timeout=settle_timeout_s,
                what="node 0 out of every group on both survivors")
            rec["shrink_done_s"] = time.perf_counter() - t0

            meta = disk.open_meta(3)
            spy3 = MetaSpy(meta)
            spy3.arm()
            spies.append(spy3)
            disk.open_wal(3)
            logs = disk.logs(3)
            rec["logs_s"] = time.perf_counter() - t0
            new = lane.coord(new_name, meta=meta, **coord_kw)
            disk.attach(3, new)
            rows.append(RowSpy(new))
            chunks = []  # snapshot chunks node 3 received: none expected
            receive = new._receive_snapshot_chunk

            def spy_chunk(g, msg, from_sid):
                chunks.append(g.name)
                return receive(g, msg, from_sid)

            new._receive_snapshot_chunk = spy_chunk
            members = names[1:] + [new_name]
            new.add_groups([(gname[g], f"cl{g}",
                             [(gname[g], n) for n in members], lane.adder(),
                             logs[g]) for g in range(groups)])
            rec["add_groups_s"] = time.perf_counter() - t0
            if memory is not None:
                mem["added"] = memory()
            coords[0] = new
            new.start()
            rec["started_s"] = time.perf_counter() - t0

            sent, grow = change(P.RA_JOIN,
                                lambda g: ((gname[g], new_name), False), pool)
            rec["grow_sent_s"] = sent - t0

            # the grow's replies are awaited in the poll below, so that
            # node 3's first append is seen when it comes
            by3 = new.by_name
            first_aer = None
            at_totals, promoted = {}, {}
            timeline = []
            deadline = time.monotonic() + settle_timeout_s
            while True:
                now = time.perf_counter() - t0
                if "grow_acked_s" not in rec and all(f.done() for f in grow):
                    rec["grow_acked_s"] = now
                following = sum(1 for n in gname if by3[n].leader_slot >= 0)
                if first_aer is None and following:
                    first_aer = now
                for g, n in enumerate(gname):
                    if n in at_totals and n in promoted:
                        continue
                    lc = leader_of(n)
                    if lc is None:
                        continue
                    gl, g3 = lc.by_name[n], by3[n]
                    if (n not in at_totals and g3.role == lane.C.R_FOLLOWER
                            and g3.term == gl.term
                            and g3.sid_of(g3.leader_slot) == (n, lc.name)
                            and g3.machine_state == totals[g]):
                        at_totals[n] = now
                    if n not in promoted and gl.voter_status.get(
                            gl.slot_of((n, new_name))) == "voter":
                        promoted[n] = now
                if not timeline or now - timeline[-1][0] >= timeline_every_s:
                    timeline.append((now, following, len(at_totals),
                                     len(promoted), new.steps,
                                     new.msgs_processed, sampler.mark()[0]))
                if (len(at_totals) == groups and len(promoted) == groups
                        and "grow_acked_s" in rec):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"node 3 at its totals in {len(at_totals)} and "
                        f"promoted in {len(promoted)} of {groups} groups, "
                        f"{sum(f.done() for f in grow)} joins acknowledged")
                time.sleep(poll_s)
            rec["replies"]["grow"] = kinds(grow)
            rec["first_aer_s"] = first_aer
            rec["timeline"] = timeline
            rec["at_totals_s"] = _quantiles(at_totals.values())
            rec["promoted_s"] = _quantiles(promoted.values())
            rec["replace_s"] = max(rec["at_totals_s"][100],
                                   rec["promoted_s"][100])
            rec["promotion_lag_s"] = _quantiles(
                [max(0.0, promoted[n] - at_totals[n]) for n in gname],
                qs=(50, 99))

            t = time.perf_counter()
            leaders = [leader_of(n) for n in gname]
            futs = []
            for c in survivors:
                mine = [g for g in range(groups) if leaders[g] is c]
                futs += _send(lane, c, [(gname[g], c.name) for g in mine],
                              [values[g] for g in mine], bulk)
            rec["replies"]["write"] = kinds(futs)
            rec["write_after"] = _rate(groups, time.perf_counter() - t)
            expect = [a + b for a, b in zip(totals, values)]
            await_(lambda: all(c.by_name[gname[g]].machine_state == expect[g]
                               for c in coords for g in range(groups)),
                   timeout=settle_timeout_s,
                   what="nodes 1, 2 and 3 at the acknowledged totals")
            rec["settled_s"] = time.perf_counter() - t0
            sampler.mark()
    finally:
        pool.shutdown(wait=True)
    rec["probe_after"], rec["steps_after"] = quiet_counts(coords, probe)
    if memory is not None:
        mem["end"] = memory()
    rec["memory"] = mem
    live = survivors + [coords[0]]  # nodes 1, 2, 3
    rec["thread_names"] = {"before": names_before, "peak": sampler.peak_names}
    rec["peak_threads"] = sampler.peak_threads
    rec["peak_rss"] = sampler.peak_rss
    rec["leaders"] = [names.index(c.name) for c in leaders]
    rec["survivor_term_after"] = max(
        c.by_name[n].term for c in survivors for n in gname)
    rec["pre_vote_rounds"] = sum(by3[n].pre_vote_token for n in gname)
    rec["meta_syncs"] = [s.syncs if s is not None else None for s in spies]
    rec["member_rows"] = {"calls": [r.calls for r in rows],
                          "s": [r.s for r in rows],
                          "flushes": [r.flushes for r in rows],
                          "flush_s": [r.flush_s for r in rows]}
    rec["live_names"] = [c.name for c in live]
    rec["named_node0"] = [sum(1 for n in gname
                              if (n, node0) in c.by_name[n].members)
                          for c in live]
    rec["members"] = [member_view(c, gname) for c in live]
    rec["row_mismatches"] = [row_mismatches(lane, c, gname) for c in live]
    rec["states"] = [[c.by_name[n].machine_state for n in gname]
                     for c in live]
    rec["expect"] = expect
    rec["counters"] = {
        k: [c.counters.get(k) for c in live]
        for k in ("ingress_ring_full", "ingress_overflow_msgs",
                  "lane_wedges", "stale_peer_resends")}
    rec["snapshot_chunks"] = len(chunks)
    return rec


def reused_slot(lane, prefix="rs", cmds=4, rounds=400):
    """One group ``g0`` on hand-stepped coordinators (a ``ManualClock``):
    nodes 0, 1 and 2, elected on node 1, ``cmds`` commands applied on
    all three. Node 0 stops and leaves through node 1; a fresh node 3
    (members nodes 1, 2 and 3) joins through node 1 as a non-voter,
    taking on the leader the slot node 0 left, and is not stepped until
    the join has committed on nodes 1 and 2. Then node 2 is cut off
    (never stepped again), ``cmds`` more commands go to node 1, and
    nodes 1 and 3 are stepped in turn until node 3 is promoted and the
    new commands commit through it.

    The record holds the leader's device row of the reused slot just
    after the join was appended (``active``, ``voting``, and the
    ``match_index`` node 0 left there), and after each step of the last
    part the leader's commit index, what nodes 1 and 2 alone hold (the
    least of the leader's written index and node 2's match there) and
    whether the leader holds node 3 as a voter; the replies, and the
    machine states of nodes 1 and 3 at the end."""
    clock = ManualClock()
    names = [f"{prefix}{i}" for i in range(4)]
    P = lane.protocol
    n = "g0"
    coords = [lane.coord(x, capacity=1, num_peers=3, clock=clock)
              for x in names[:3]]
    rec = {}
    try:
        for c in coords:
            c.add_groups([(n, "cl0", [(n, x) for x in names[:3]],
                           lane.adder())])
        lead = coords[1]
        gl = lead.by_name[n]
        lead.deliver((n, names[1]), P.ElectionTimeout(), None)
        step_until(coords, lambda: gl.role == lane.C.R_LEADER
                   and gl.cluster_change_permitted, what="leader on node 1")

        def send(to, data, kind=P.USR):
            fut = lane.api.Future()
            to.deliver((n, to.name), P.Command(
                kind=kind, data=data, reply_mode="await_consensus",
                from_ref=fut), None)
            return fut

        futs = [send(lead, v) for v in range(1, cmds + 1)]
        total = sum(range(1, cmds + 1))
        step_until(coords, lambda: all(f.done() for f in futs) and all(
            c.by_name[n].machine_state == total for c in coords),
            what="the first commands on all three")
        replies = [_reply_kind(f.result(0)) for f in futs]
        coords[0].stop()
        live = coords[1:]
        fut = send(lead, (n, names[0]), P.RA_LEAVE)
        step_until(live, lambda: fut.done() and gl.cluster_change_permitted,
                   what="node 0 left")
        replies.append(_reply_kind(fut.result(0)))

        c3 = lane.coord(names[3], capacity=1, num_peers=3, clock=clock)
        coords.append(c3)
        c3.add_groups([(n, "cl0", [(n, x) for x in names[1:]], lane.adder())])
        fut = send(lead, ((n, names[3]), False), P.RA_JOIN)
        lead.step_once()
        slot = gl.slot_of((n, names[3]))
        f = lane.fields(lead)
        rec["slot"] = slot
        rec["row_at_join"] = {k: int(f[k][gl.gid][slot])
                              for k in ("active", "voting", "match_index")}
        step_until(live, lambda: fut.done() and gl.cluster_change_permitted,
                   what="the join committed")
        replies.append(_reply_kind(fut.result(0)))

        futs = [send(lead, v) for v in range(1, cmds + 1)]
        slot2 = gl.slot_of((n, names[2]))
        seen = []
        for _ in range(rounds):
            for c in (lead, c3):
                c.step_once()
                f = lane.fields(lead)
                pair = min(int(f["written_index"][gl.gid]),
                           int(f["match_index"][gl.gid][slot2]))
                seen.append((int(f["commit_index"][gl.gid]), pair,
                             gl.voter_status.get(slot) == "voter"))
            if all(x.done() for x in futs) and seen[-1][2]:
                break
        else:
            raise AssertionError("node 3 never promoted, or the commands "
                                 "never committed through it")
        replies += [_reply_kind(x.result(0)) for x in futs]
        rec["seen"] = seen
        rec["replies"] = replies
        step_until([lead, c3], lambda: c3.by_name[n].machine_state == 2 * total,
                   what="node 3 applied every command")
        rec["states"] = [c.by_name[n].machine_state for c in (lead, c3)]
    finally:
        for c in coords:
            c.stop()
    return rec


def node_down_triggers(lane, prefix="nd", groups=64, election_timeout_s=1.0,
                       contact=False, stop_early=False, ring_slots=8192,
                       settle_timeout_s=30.0):
    """One follower's node-down election triggers, hand-stepped on a
    ``ManualClock``: three unstarted coordinators, every group elected
    on node 0 and its noop applied on all three; then node 1's
    ``_on_node_down`` is called for node 0, whose leaders stay up (the
    call stands for a detection), with ``random`` seeded so that the
    delays it draws are known.

    - ``stop_early``: node 1 stops right after the call, before any
      trigger is due;
    - ``ring_slots``: node 1's ingress lanes' size: the triggers that
      find their lane full must ride the overflow queue;
    - ``contact``: the clock moves 1 s and node 0 commits one more
      command a group on all three nodes before the triggers are due,
      so that every group has heard its leader after its ``armed``
      stamp (the record holds the wall time that took).

    Otherwise the scenario waits, on state, until every trigger has
    been delivered and steps node 1 three times. The record holds the
    threads the call started, the detection time and the ``armed``
    stamps on the manual clock, the seeded delays by group, the groups
    whose trigger came before its delay had passed since the call
    began, the most any came after it had passed since the call ended,
    node 1's roles, pre-vote rounds opened and lane counters
    (``ingress_ring_full``, ``ingress_overflow_msgs``) after the steps, the
    triggers delivered after a stop, and the threads the call started
    that are still alive after node 1 stopped (at once with
    ``stop_early``, else once those that end on their own have ended
    or ``settle_timeout_s`` has passed)."""
    clock = ManualClock()
    names = [f"{prefix}{i}" for i in range(3)]
    gname = [f"g{g}" for g in range(groups)]
    coords = [
        lane.coord(n, capacity=groups, num_peers=3, clock=clock,
                   election_timeout_s=election_timeout_s,
                   ingress_ring_slots=ring_slots if i == 1 else 8192)
        for i, n in enumerate(names)
    ]
    follower = coords[1]
    by1 = follower.by_name
    rec = {"groups": groups}
    got = {}
    before = set(threading.enumerate())
    try:
        for c in coords:
            c.add_groups([(gname[g], f"cl{g}", [(gname[g], n) for n in names],
                           lane.adder()) for g in range(groups)])
        for n in gname:
            coords[0].deliver((n, names[0]), lane.protocol.ElectionTimeout(),
                              None)
        by0 = coords[0].by_name
        step_until(coords, lambda: all(
            by0[n].role == lane.C.R_LEADER
            and by0[n].last_applied >= by0[n].noop_index
            and by1[n].last_applied >= by0[n].noop_index for n in gname),
            what="leaders on node 0, noops applied on node 1")
        tokens = [by1[n].pre_vote_token for n in gname]

        deliver = follower.deliver
        et = lane.protocol.ElectionTimeout

        def spy(to, msg, from_sid):
            if type(msg) is et:
                got[to[0]] = (time.monotonic(), msg.armed_at)
            return deliver(to, msg, from_sid)

        follower.deliver = spy
        random.seed(groups)
        want = [election_timeout_s * (1 + random.random())
                for _ in range(groups)]
        random.seed(groups)
        before = set(threading.enumerate())
        rec["detected_at"] = clock.monotonic()
        w0 = time.monotonic()
        follower._on_node_down(names[0])
        w1 = time.monotonic()
        rec["new_threads"] = sorted(t.name for t in threading.enumerate()
                                    if t not in before)
        rec["want"] = want
        if stop_early:
            follower.stop()
            rec["delivered_after_stop"] = len(got)
            rec["alive_after_stop"] = sorted(
                t.name for t in threading.enumerate()
                if t not in before and t.is_alive())
            return rec
        if contact:
            clock.advance(1.0)
            futs = [lane.api.Future() for _ in gname]
            for n, fut in zip(gname, futs):
                coords[0].deliver((n, names[0]), lane.command(1, fut), None)
            step_until(coords, lambda: all(f.done() for f in futs) and all(
                c.by_name[n].machine_state == 1
                for c in coords for n in gname),
                what="one more command on every replica")
            rec["contact_s"] = time.monotonic() - w0
        await_(lambda: len(got) == groups, timeout=settle_timeout_s,
               what="every trigger delivered")
        rec["armed"] = sorted({a for _t, a in got.values()})
        rec["early"] = [n for g, n in enumerate(gname)
                        if got[n][0] - w0 < want[g]]
        rec["late_s"] = max(got[n][0] - w1 - want[g]
                            for g, n in enumerate(gname))
        for _ in range(3):
            follower.step_once()
        rec["roles"] = sorted({by1[n].role for n in gname})
        rec["rounds"] = sum(by1[n].pre_vote_token - t
                            for n, t in zip(gname, tokens))
        rec["counters"] = {k: follower.counters.get(k) for k in (
            "ingress_ring_full", "ingress_overflow_msgs")}
    finally:
        for c in coords:
            c.stop()
    # a fired threading.Timer ends on its own, just after its callback
    deadline = time.monotonic() + settle_timeout_s
    while True:
        alive = sorted(t.name for t in threading.enumerate()
                       if t not in before and t.is_alive())
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    rec["alive_after_stop"] = alive
    return rec
