"""Shared write-ahead log.

One WAL per system serves *all* raft groups on the node: every append
from every group funnels into one append-only file and one fsync per
batch — the amortization trick at the heart of the reference's design
(reference: ``src/ra_log_wal.erl`` — gen_batch_server batching, writer-id
dictionary compression :482-499, per-writer gap detection :551-586,
rollover handing memtable seqs to the segment writer :641-688, chunked
recovery :393-470).

File format (little-endian):

    header   : magic b"RTW1"
    uid-def  : kind=1 | ref u16 | len u16 | uid utf-8
    entry    : kind=2 | ref u16 | idx u64 | term u64 | crc u32 | len u32
               | payload
    trunc    : kind=3 | ref u16 | idx u64   (explicit truncate-from marker)

CRC32 covers idx|term|payload. A short/corrupt tail record is treated as
a clean EOF (torn final write), matching standard WAL recovery rules.

Threading: producers call ``write``/``truncate_write`` from any thread; a
single writer thread drains the queue in batches of up to
``max_batch_size``, performs one write+fsync, then fires the per-writer
``("written", term, seq)`` notifications. ``threaded=False`` gives tests
a deterministic ``flush()``-driven mode.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ra_tpu_torch import counters as ra_counters
from ra_tpu_torch import faults
from ra_tpu_torch.log.tables import TableRegistry
from ra_tpu_torch.utils.lib import retry
from ra_tpu_torch.utils.seq import Seq

MAGIC = b"RTW1"


class WalCorruptionError(RuntimeError):
    """Mid-file WAL corruption: an unreadable record with VALID DATA
    after it. Recovery refuses to silently drop acked entries — this is
    bit rot or tampering, not a torn tail (a partial FINAL record, with
    nothing but zero padding or EOF beyond, truncates cleanly instead).
    Reference behavior: checksum_failure_in_middle_of_file_should_fail
    vs recover_with_partial_last_entry (test/ra_log_wal_SUITE.erl)."""


K_UID = 1
K_ENTRY = 2
K_TRUNC = 3
K_SPARSE = 4  # entry layout; no gap/truncate semantics on recovery
# in-memory record marker for a contiguous same-writer run; expanded to
# per-entry K_ENTRY frames at framing time (never written to disk).
# Value mirrored in ra_tpu_torch/native/__init__.py.
K_RUN = 100

_ENTRY_HDR = struct.Struct("<BHQQII")
_UID_HDR = struct.Struct("<BHH")
_TRUNC_HDR = struct.Struct("<BHQ")

NotifyFn = Callable[[str, Any], None]


class Wal:
    def __init__(
        self,
        dir: str,
        tables: TableRegistry,
        notify: NotifyFn,
        segment_writer=None,
        max_size_bytes: int = 256 * 1024 * 1024,
        max_batch_size: int = 8192,
        sync_method: str = "datasync",  # datasync | sync | none
        compute_checksums: bool = True,
        threaded: bool = True,
        counter=None,
        native: bool = True,
        group_commit_max_delay_s: float = 0.002,
        group_commit_min_gain: int = 8,
    ):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self.tables = tables
        self.notify = notify
        # optional bulk channel: called with [(uid, event), ...] once
        # per batch instead of one notify() per writer (hosts that route
        # events through a shared lock set this — e.g. a coordinator's
        # deliver_many)
        self.notify_many: Optional[Callable[[List[Tuple[str, Any]]], None]] = None
        self.segment_writer = segment_writer
        self.max_size_bytes = max_size_bytes
        self.max_batch_size = max_batch_size
        self.sync_method = sync_method
        self.compute_checksums = compute_checksums
        # failpoint scope label (multi-node tests target one node's
        # storage); the owning node sets it to its name
        self.fault_scope: Optional[str] = None
        # resolve (and if needed g++-build) the native framer NOW, off the
        # commit path — a lazy first-batch build would stall every queued
        # append behind a compiler run
        if native:
            from ra_tpu_torch import native as _native

            native = _native.available()
        self._native = native
        # adaptive group commit (docs/INTERNALS.md §15): a flush may
        # hold its batch open for up to ``group_commit_max_delay_s``
        # while a burst is still arriving, so the burst pays ONE fsync.
        # The wait is entered only when the smoothed arrival rate
        # predicts at least ``group_commit_min_gain`` more entries
        # within the bound — an idle write never waits on a timer.
        self.group_commit_max_delay_s = group_commit_max_delay_s
        self.group_commit_min_gain = group_commit_min_gain
        from ra_tpu_torch.li import LeakyIntegrator

        self._gc_rate = LeakyIntegrator()
        self._gc_t = time.monotonic()
        # fsync-wait and batch-flush histograms (docs/INTERNALS.md §13);
        # keyed by the WAL directory's basename so every WAL in a
        # multi-node process exports its own distribution
        from ra_tpu_torch import obs as _obs

        _norm = os.path.normpath(dir)
        _parent = os.path.basename(os.path.dirname(_norm))
        _scope = (
            f"{_parent}/{os.path.basename(_norm)}" if _parent
            else (os.path.basename(_norm) or "wal")
        )
        self._scope = _scope
        # registered vector (scrapeable): the group-commit delay gauge
        # and flush counters ride the same exposition as the histograms
        self.counter = counter or ra_counters.new(
            ("wal", _scope), ra_counters.WAL_FIELDS
        )
        self._h_fsync = _obs.histogram(
            ("wal", _scope, "fsync"), help="WAL fsync/fdatasync wait"
        )
        self._h_batch = _obs.histogram(
            ("wal", _scope, "batch"),
            help="WAL batch flush (frame + write + fsync + notify)",
        )
        self._h_flush_wait = _obs.histogram(
            ("wal", _scope, "flush_wait"),
            help="adaptive group-commit coalescing wait before a flush",
        )
        self._obs_rec = _obs.flight_recorder()
        # batch flushes land on the wave timeline too (their own lane
        # per WAL scope) so Perfetto shows fsync work overlapping the
        # coordinator's device/host phases; one attr check while off
        self._trace = _obs.trace_buffer()

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._closed = False
        # failure handling: an I/O error flips the WAL into a failed
        # state (writes rejected) until reopen() rolls a fresh file —
        # the analog of the reference WAL process crashing and being
        # supervisor-restarted (src/ra_log_wal.erl + ra_log_wal_sup)
        self._failed = False
        # errno-aware failure taxonomy (docs/INTERNALS.md §21): set
        # alongside _failed to "space" (ENOSPC/EDQUOT — durable state
        # provably untouched, node degrades and probe-resumes) or
        # "integrity" (everything else — the poison path, unchanged)
        self.failure_class: Optional[str] = None
        self.on_failure: Optional[Callable[[BaseException], None]] = None
        # serializes file I/O (writer thread) against reopen() (restart
        # thread) — without it a reopen can close the file mid-write
        self._io_lock = threading.Lock()

        # per-open-file state
        self._file = None
        self._file_num = 0
        self._file_path: Optional[str] = None
        self._bytes = 0
        self._uid_refs: Dict[str, int] = {}
        # what this file holds: per uid, per memtable table id
        self._file_seqs: Dict[str, Dict[int, Seq]] = {}
        # per-writer last contiguous idx (gap detection)
        self._last_idx: Dict[str, int] = {}

        self._recover()
        self._open_next()

        self._thread: Optional[threading.Thread] = None
        if threaded:
            # arm-waker: the idle loop below blocks UNTIMED when no
            # wal.thread failpoint is armed; arming one while the
            # writer is parked must wake it so the crash bites within
            # one wakeup even with zero traffic (docs/INTERNALS.md §16)
            faults.on_arm(self._arm_wake)
            self._thread = threading.Thread(target=self._run, name="ra-wal", daemon=True)
            self._thread.start()

    def _arm_wake(self) -> None:
        with self._cv:
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # public API

    def write(
        self, uid: str, idx: int, term: int, payload: bytes,
        sparse: bool = False, tid: int = 0,
    ) -> bool:
        """Queue an append. ``sparse`` marks out-of-order live-entry
        writes (snapshot install pre-phase) that bypass gap detection;
        ``tid`` names the memtable table holding the entry (successor
        chains — the segment writer flushes from exactly that table).
        Returns False when the WAL is closed."""
        with self._cv:
            if self._closed or self._failed:
                return False
            self._queue.append(("s" if sparse else "w", uid, idx, term, payload, tid))
            if len(self._queue) == 1:
                # a non-empty queue already has a wakeup in flight (or
                # the writer is mid-flush and re-checks before waiting);
                # per-append notifies were a measurable share of a
                # 10k-group wave's enqueue fan-out
                self._cv.notify()
        return True

    def write_run(self, uid: str, first: int, terms, payloads, tid: int = 0) -> bool:
        """Queue a contiguous ascending run of appends as ONE queue item
        (the pipelined hot path: the writer loop does run-level — not
        per-entry — bookkeeping, and framing expands the run natively).
        ``terms[k]``/``payloads[k]`` belong to index ``first + k``; all
        entries live in memtable table ``tid``."""
        if not payloads:
            # an empty run must not rewind _last_idx to first-1 in the
            # writer loop or frame a zero-entry K_RUN record
            return True
        with self._cv:
            if self._closed or self._failed:
                return False
            self._queue.append(("r", uid, first, terms, payloads, tid))
            if len(self._queue) == 1:
                self._cv.notify()
        return True

    def truncate_write(self, uid: str, idx: int) -> bool:
        """Record an explicit truncate-from marker (divergent suffix
        rewrite starts at idx)."""
        with self._cv:
            if self._closed or self._failed:
                return False
            self._queue.append(("t", uid, idx, 0, b"", 0))
            if len(self._queue) == 1:
                self._cv.notify()
        return True

    def last_writer_seq(self, uid: str) -> Optional[int]:
        with self._lock:
            return self._last_idx.get(uid)

    def flush(self) -> None:
        """Drain and persist everything queued (synchronous mode / tests;
        also used for orderly shutdown)."""
        while True:
            with self._lock:
                batch = self._take_batch_locked()
            if not batch:
                return
            t0 = time.perf_counter_ns()
            self._write_batch(batch)
            dt = time.perf_counter_ns() - t0
            self._h_batch.record(dt)
            if self._trace.enabled:
                self._trace.span("wal_batch", f"wal:{self._scope}", t0, dt,
                                 cat="wal")

    def close(self) -> None:
        faults.off_arm(self._arm_wake)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.flush()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
        # unregister OUR counter vector only (a restart may have
        # registered a successor under the same scope already)
        if ra_counters.fetch(("wal", self._scope)) is self.counter:
            ra_counters.delete(("wal", self._scope))

    # ------------------------------------------------------------------
    # writer loop

    def _run(self) -> None:
        while True:
            # injected thread death (ThreadCrash is a BaseException: it
            # falls through the except below and kills the thread; the
            # node's infra supervisor detects and heals)
            faults.fire("wal.thread", self.fault_scope)
            with self._cv:
                while not self._queue and not self._closed:
                    # event-driven idle (docs/INTERNALS.md §16):
                    # producers notify on empty->non-empty, close()
                    # notifies all, and faults.arm() nudges via the
                    # arm-waker — an idle WAL writer consumes zero
                    # CPU. The timed tick survives ONLY while a
                    # wal.thread failpoint is armed: a crash_thread
                    # nemesis must keep biting within one tick while
                    # its trigger (e.g. prob) rolls the dice
                    if faults.any_armed("wal.thread"):
                        self._cv.wait(timeout=0.5)
                    else:
                        self._cv.wait()
                    # idle loop checks the site too (the cv lock
                    # releases on unwind)
                    faults.fire("wal.thread", self.fault_scope)
                if self._closed and not self._queue:
                    return
                batch = self._take_batch_locked()
            if batch:
                try:
                    batch = self._coalesce(batch)
                    t0 = time.perf_counter_ns()
                    self._write_batch(batch)
                    dt = time.perf_counter_ns() - t0
                    self._h_batch.record(dt)
                    if self._trace.enabled:
                        self._trace.span("wal_batch", f"wal:{self._scope}",
                                         t0, dt, cat="wal")
                except Exception as exc:  # noqa: BLE001
                    # any unexpected error is a failure episode, same as
                    # a file I/O error: the batch is unacked (servers
                    # resend after reopen) and the writer thread LIVES —
                    # a silently dead WAL thread would wedge every
                    # server on the node. BaseExceptions still kill the
                    # thread; the node's infra supervisor revives it.
                    self._fail(exc)

    def _take_batch_locked(self) -> List[Tuple]:
        batch = []
        while self._queue and len(batch) < self.max_batch_size:
            batch.append(self._queue.popleft())
        return batch

    def _coalesce(self, batch: List[Tuple]) -> List[Tuple]:
        """Adaptive group commit: hold a small batch open for up to
        ``group_commit_max_delay_s`` while a burst is still arriving,
        so the whole burst rides one write+fsync instead of several.

        Policy (docs/INTERNALS.md §15):
        - the smoothed arrival rate must predict >= ``group_commit_min_
          gain`` further entries inside the delay bound, or the batch
          flushes immediately — an unloaded write never waits;
        - a batch already at half ``max_batch_size`` flushes now;
        - within the wait, the batch extends every time new items land
          and flushes the moment a wait interval brings nothing (the
          burst drained) or the deadline/batch cap is hit.

        Threaded writer loop only — ``flush()`` (tests, shutdown) stays
        deterministic and never waits."""
        d = self.group_commit_max_delay_s
        # update the arrival-rate estimate on every flush (batch items
        # per elapsed wall time since the previous flush decision)
        now = time.monotonic()
        # window floor: a lone write moments after the previous flush
        # decision must not read as a high-rate burst — rate is "items
        # per recent 25ms+ window", so only sustained arrival streams
        # clear the coalescing gate
        rate = self._gc_rate.sample(len(batch), max(now - self._gc_t, 0.025))
        self._gc_t = now
        if (
            d <= 0
            or len(batch) >= self.max_batch_size // 2
            or rate * d < self.group_commit_min_gain
        ):
            self.counter.put("group_commit_delay_us", 0)
            return batch
        t0 = time.perf_counter_ns()
        deadline = t0 + int(d * 1e9)
        tick = d / 4
        while True:
            with self._cv:
                if self._closed:
                    break
                if not self._queue:
                    self._cv.wait(timeout=tick)
                got = len(self._queue)
                while self._queue and len(batch) < self.max_batch_size:
                    batch.append(self._queue.popleft())
            if (
                got == 0  # a whole interval brought nothing: burst over
                or len(batch) >= self.max_batch_size
                or time.perf_counter_ns() >= deadline
            ):
                break
        dt = time.perf_counter_ns() - t0
        self._h_flush_wait.record(dt)
        self.counter.incr("group_commit_waits")
        self.counter.put("group_commit_delay_us", dt // 1000)
        # the wait itself feeds the estimate too (long quiet waits decay
        # the rate so the NEXT lone write flushes immediately)
        now = time.monotonic()
        self._gc_rate.sample(0, now - self._gc_t)
        self._gc_t = now
        return batch

    def _write_batch(self, batch: List[Tuple]) -> None:
        # first pass: bookkeeping + record collection; second: framing
        # (natively when ra_tpu_torch.native built) + one write/fsync.
        # Per-(uid, table) index accumulation is BATCH-LEVEL and
        # RUN-LEVEL: indexes collect into (lo, hi) pair lists and merge
        # into the file seqs once per uid — per-entry Seq unions (plus
        # per-entry snapshot floor lookups) dominated the whole WAL at
        # 10k-group batches, and "r" run items process a whole
        # contiguous append run with O(1) bookkeeping.
        records: List[Tuple] = []
        # (uid, term) -> (lo, hi) pairs written in this batch
        written: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
        resends: List[Tuple[str, int]] = []
        # uid -> [last_any_idx, {tid: [(lo, hi), ...]}] pending in batch
        acc: Dict[str, list] = {}
        # uid -> [snap_idx, live_indexes-or-None] (one lookup per uid)
        snap_cache: Dict[str, list] = {}
        n_entries = 0

        def flush_uid(uid: str, info) -> None:
            per_uid = self._file_seqs.setdefault(uid, {})
            for t, pairs in info[1].items():
                cur = per_uid.get(t)
                add = Seq(pairs)
                per_uid[t] = add if cur is None or cur.is_empty() else cur.union(add)
            info[1] = {}

        def get_info(uid: str):
            info = acc.get(uid)
            if info is None:
                per_uid = self._file_seqs.setdefault(uid, {})
                last_any = max((sq.last() or 0 for sq in per_uid.values()), default=0)
                info = acc[uid] = [last_any, {}]
            return info

        def get_snap(uid: str):
            sc = snap_cache.get(uid)
            if sc is None:
                sc = snap_cache[uid] = [self.tables.snapshot_index(uid), None]
            return sc

        def note_pair(pairs_by_key, key, lo: int, hi: int) -> None:
            pend = pairs_by_key.get(key)
            if pend is None:
                pairs_by_key[key] = [(lo, hi)]
            else:
                tlo, thi = pend[-1]
                if thi + 1 == lo:
                    pend[-1] = (tlo, hi)
                else:
                    pend.append((lo, hi))

        def one(kind, uid, idx, term, payload, tid) -> None:
            nonlocal n_entries
            sc = get_snap(uid)
            snap_idx = sc[0]
            if idx <= snap_idx:
                # drop writes below the snapshot floor (dead indexes);
                # they still count as durable for writer bookkeeping
                if sc[1] is None:
                    sc[1] = self.tables.live_indexes(uid)
                if idx not in sc[1]:
                    note_pair(written, (uid, term), idx, idx)
                    self._last_idx[uid] = max(self._last_idx.get(uid, 0), idx)
                    return
            if kind != "s":
                last = self._last_idx.get(uid)
                # indexes at or below the snapshot are durable-or-dead, so
                # a jump to snap_idx+1 after a snapshot install is in-seq
                if last is not None and idx > max(last, snap_idx) + 1:
                    # gap: a write got lost upstream — ask the server to
                    # resend from the hole instead of persisting out of
                    # order
                    self.counter.incr("out_of_seq")
                    resends.append((uid, max(last, snap_idx) + 1))
                    return
            ref = self._uid_ref(uid, records)
            records.append((K_SPARSE if kind == "s" else K_ENTRY, ref, idx, term, payload))
            n_entries += 1
            info = get_info(uid)
            if kind == "s":
                # sparse writes never imply truncation of higher indexes
                self._last_idx[uid] = max(self._last_idx.get(uid, 0), idx)
                if idx > info[0]:
                    info[0] = idx
            else:
                self._last_idx[uid] = idx
                if idx <= info[0]:
                    # overwrite rewinds this file's view across ALL
                    # tables of the uid (superseded entries), including
                    # indexes still pending in this batch
                    flush_uid(uid, info)
                    per_uid = self._file_seqs[uid]
                    for t in list(per_uid):
                        per_uid[t] = per_uid[t].limit(idx - 1)
                info[0] = idx
            note_pair(info[1], tid, idx, idx)
            note_pair(written, (uid, term), idx, idx)

        for item in batch:
            kind = item[0]
            if kind == "r":
                _, uid, first, terms, payloads, tid = item
                m = len(payloads)
                snap_idx = get_snap(uid)[0]
                if first <= snap_idx:
                    # run overlaps the snapshot floor (rare): per-entry
                    # path keeps the dead-index filtering exact
                    for k in range(m):
                        one("w", uid, first + k, terms[k], payloads[k], tid)
                    continue
                last = self._last_idx.get(uid)
                if last is not None and first > max(last, snap_idx) + 1:
                    self.counter.incr("out_of_seq")
                    resends.append((uid, max(last, snap_idx) + 1))
                    continue
                last_e = first + m - 1
                ref = self._uid_ref(uid, records)
                records.append((K_RUN, ref, first, terms, payloads))
                n_entries += m
                info = get_info(uid)
                self._last_idx[uid] = last_e
                if first <= info[0]:
                    flush_uid(uid, info)
                    per_uid = self._file_seqs[uid]
                    for t in list(per_uid):
                        per_uid[t] = per_uid[t].limit(first - 1)
                info[0] = last_e
                note_pair(info[1], tid, first, last_e)
                # written events key on (uid, term): split multi-term runs
                if terms[0] == terms[-1]:
                    note_pair(written, (uid, terms[0]), first, last_e)
                else:
                    lo, t0 = first, terms[0]
                    for k in range(1, m):
                        if terms[k] != t0:
                            note_pair(written, (uid, t0), lo, first + k - 1)
                            lo, t0 = first + k, terms[k]
                    note_pair(written, (uid, t0), lo, last_e)
            elif kind == "t":
                _, uid, idx, _term, _payload, _tid = item
                info = acc.get(uid)
                if info is not None:
                    flush_uid(uid, info)
                    info[0] = idx - 1
                ref = self._uid_ref(uid, records)
                records.append((K_TRUNC, ref, idx, 0, b""))
                self._last_idx[uid] = idx - 1
                for t, sq in self._file_seqs.get(uid, {}).items():
                    self._file_seqs[uid][t] = sq.limit(idx - 1)
            else:
                one(kind, item[1], item[2], item[3], item[4], item[5])

        for uid, info in acc.items():
            if info[1]:
                flush_uid(uid, info)

        if records:
            err = None
            n_bytes = None
            # native hot path: ONE call frames + writes + fsyncs the
            # whole batch (no Python-side byte assembly or copy). Any
            # armed write/fsync failpoint routes through the Python
            # path so injection semantics stay byte-exact with tests —
            # as does an instance-level ``_sync`` override (the WAL-
            # death injection seam tests/self-healing rely on).
            if (
                self._native
                and "_sync" not in self.__dict__
                and not faults.any_armed("wal.write", "wal.fsync")
            ):
                from ra_tpu_torch import native

                with self._io_lock:
                    if self._failed:
                        return  # failed window: batch unacked, drop it
                    try:
                        self._file.flush()
                        got = native.write_batch(
                            records, self._file.fileno(), self.sync_method,
                            compute_crc=self.compute_checksums,
                        )
                    except (OSError, ValueError) as exc:
                        err = exc
                        got = None
                if err is None:
                    if got is None:
                        self._native = False  # lib lost/format miss: fall back
                        self.counter.incr("native_fallbacks")
                    else:
                        n_bytes, fsync_ns = got
                        self.counter.incr("native_batches")
                        if self.sync_method in ("datasync", "sync"):
                            self.counter.incr("fsyncs")
                            self.counter.incr("fsync_time_us", fsync_ns // 1000)
                            self._h_fsync.record(fsync_ns)
            if err is None and n_bytes is None:
                buf = self._frame(records)
                n_bytes = len(buf)
                with self._io_lock:
                    if self._failed:
                        return  # failed window: batch is unacked, drop it
                    try:
                        faults.checked_write("wal.write", self._file, buf,
                                             self.fault_scope)
                        self._sync()
                    except (OSError, ValueError) as exc:
                        err = exc
            if err is not None:
                # the whole batch is unacked (no written events fire) —
                # entries survive in memtables; servers hold/resend once
                # reopen() brings a fresh file up. (_fail outside the io
                # lock: it takes the queue lock, which reopen holds
                # while waiting for the io lock.)
                self._fail(err)
                return
            self.counter.incr("batches")
            # 'writes'/'batch_size' count QUEUE ITEMS (incl. truncate
            # markers and dead-index-dropped writes) — the pre-run-record
            # semantics dashboards may rely on; 'entries' counts the
            # expanded log entries actually framed (runs widened)
            self.counter.incr("writes", len(batch))
            self.counter.incr("entries", n_entries)
            self.counter.incr("bytes_written", n_bytes)
            self.counter.put("batch_size", len(batch))
            self._bytes += n_bytes
        if self.notify_many is not None and len(written) > 1:
            # one transport/lock round for the whole batch's written
            # events (a 10k-group batch otherwise pays 10k lock rounds)
            self.notify_many(
                [(uid, ("written", term, Seq(pairs)))
                 for (uid, term), pairs in written.items()]
            )
        else:
            for (uid, term), pairs in written.items():
                self.notify(uid, ("written", term, Seq(pairs)))
        for uid, from_idx in resends:
            self.notify(uid, ("resend_write", from_idx))
        if self._bytes >= self.max_size_bytes:
            self._rollover()

    def _sync(self) -> None:
        # fsync failure is POISON (fsyncgate): the page-cache state of
        # the file is unknowable afterwards, so the raise below fails
        # the whole writer (batch unacked, _failed set) and reopen()
        # abandons the file — a later fsync on the same fd must never
        # "succeed" and ack entries the kernel already dropped
        # the timed window covers the failpoint fire + flush + syscall:
        # the brownout detector differences fsyncs/fsync_time_us, and an
        # injected ("latency", s) fault must look exactly like the slow
        # device it models
        t0 = time.perf_counter_ns()
        faults.fire("wal.fsync", self.fault_scope)
        self._file.flush()
        if self.sync_method == "datasync":
            os.fdatasync(self._file.fileno())
        elif self.sync_method == "sync":
            os.fsync(self._file.fileno())
        else:
            return
        dt = time.perf_counter_ns() - t0
        self.counter.incr("fsyncs")
        self.counter.incr("fsync_time_us", dt // 1000)
        self._h_fsync.record(dt)

    def _uid_ref(self, uid: str, records: List[Tuple]) -> int:
        ref = self._uid_refs.get(uid)
        if ref is None:
            ref = len(self._uid_refs) + 1
            self._uid_refs[uid] = ref
            ub = uid.encode()
            records.append((K_UID, ref, len(ub), 0, ub))
        return ref

    def _frame(self, records: List[Tuple[int, int, int, int, bytes]]) -> bytes:
        """Frame records for the file — native C++ when available
        (ra_tpu_torch.native.wal_native), byte-identical Python fallback."""
        if self._native:
            from ra_tpu_torch import native

            out = native.frame_batch(records, compute_crc=self.compute_checksums)
            if out is not None:
                return out
            self._native = False  # build failed: stay on the fallback
            self.counter.incr("native_fallbacks")
        buf = bytearray()
        for rec in records:
            kind = rec[0]
            if kind == K_UID:
                _, ref, _idx, _term, payload = rec
                buf += _UID_HDR.pack(K_UID, ref, len(payload))
                buf += payload
            elif kind == K_TRUNC:
                # unpack the record's OWN ref: reusing the previous
                # iteration's ref bound a truncate marker to whatever
                # writer happened to precede it in the batch — recovery
                # would truncate the wrong log (caught by the native/
                # Python byte-parity test; the native framer was right)
                _, ref, idx, _term, _payload = rec
                buf += _TRUNC_HDR.pack(K_TRUNC, ref, idx)
            elif kind == K_RUN:
                # expand to per-entry frames (disk format is unchanged)
                _, ref, first, terms, payloads = rec
                for k, payload in enumerate(payloads):
                    idx, term = first + k, terms[k]
                    crc = (
                        zlib.crc32(struct.pack("<QQ", idx, term) + payload)
                        if self.compute_checksums
                        else 0
                    )
                    buf += _ENTRY_HDR.pack(K_ENTRY, ref, idx, term, crc,
                                           len(payload))
                    buf += payload
            else:  # K_ENTRY / K_SPARSE share the layout
                _, ref, idx, term, payload = rec
                crc = (
                    zlib.crc32(struct.pack("<QQ", idx, term) + payload)
                    if self.compute_checksums
                    else 0
                )
                buf += _ENTRY_HDR.pack(kind, ref, idx, term, crc, len(payload))
                buf += payload
        return bytes(buf)

    # ------------------------------------------------------------------
    # rollover & recovery

    def _open_next(self) -> None:
        self._file_num += 1
        self._file_path = os.path.join(self.dir, f"{self._file_num:08d}.wal")

        def _open():
            faults.fire("wal.open", self.fault_scope)
            return open(self._file_path, "ab")

        # transient open failures (EMFILE/EAGAIN bursts) retry with
        # bounded backoff (reference: ra_file.erl retries every op)
        self._file = retry(_open, attempts=3, delay_s=0.02)
        if self._file.tell() == 0:
            self._file.write(MAGIC)
            self._file.flush()
        self._bytes = self._file.tell()
        self._uid_refs = {}
        self._file_seqs = {}
        self.counter.incr("wal_files")

    def _rollover(self) -> None:
        self.counter.incr("rollovers")
        self._file.close()
        full_path, seqs = self._file_path, self._file_seqs
        self._open_next()
        if self.segment_writer is not None:
            self.segment_writer.flush_mem_tables(
                self._flush_jobs(seqs), wal_file=full_path
            )
        # no segment writer: the rolled file is the only durable copy of
        # its entries — keep it for boot-time recovery

    @staticmethod
    def _flush_jobs(seqs):
        """{uid: {tid: Seq}} -> {uid: [(tid, Seq), ...]} handoff shape
        (tid-ordered, empties dropped) — one definition for the roll and
        recovery paths."""
        jobs = {
            uid: [(t, sq) for t, sq in sorted(per.items()) if not sq.is_empty()]
            for uid, per in seqs.items()
        }
        return {uid: ts for uid, ts in jobs.items() if ts}

    def force_rollover(self) -> None:
        """Test/ops hook: roll the current file regardless of size."""
        with self._lock:
            self._rollover()

    def _fail(self, exc: BaseException) -> None:
        # both framers (native write_batch re-raises -(1000+errno) as a
        # real OSError; the Python path raises the OSError directly)
        # funnel here, so one classification covers both — the
        # native/Python parity the taxonomy tests assert is structural
        from ra_tpu_torch.pressure import CLASS_SPACE, classify_storage_error

        klass = classify_storage_error(exc)
        with self._cv:
            if self._failed:
                return  # one failure episode -> one on_failure callback
            self._failed = True
            self.failure_class = klass
        self.counter.incr("failures")
        if klass == CLASS_SPACE:
            self.counter.incr("space_failures")
        self._obs_rec.record(
            "wal_failure", node=self.fault_scope,
            detail=f"{klass}: {type(exc).__name__}: {exc}",
        )
        cb = self.on_failure
        if cb is not None:
            try:
                cb(exc)
            except Exception:  # noqa: BLE001
                pass

    @property
    def failed(self) -> bool:
        return self._failed

    @property
    def degraded(self) -> bool:
        """True while the live failure episode is space-class: the node
        is in storage_degraded (admission rejects RA_NOSPACE, probe
        loop armed) rather than poisoned."""
        return self._failed and self.failure_class == "space"

    def thread_alive(self) -> bool:
        """Writer-thread liveness for the node's infra supervisor
        (non-threaded mode drains synchronously: always 'alive')."""
        return self._thread is None or self._thread.is_alive()

    def revive_thread(self) -> None:
        """Restart a dead writer thread (supervision; the queue and
        file state survive — un-drained writes flush on the new
        thread). Synchronized: concurrent healers must never start two
        writer threads (batch bookkeeping has no writer-side lock)."""
        with self._cv:
            self._revive_thread_locked()

    def _revive_thread_locked(self) -> None:
        if self._closed or self._thread is None or self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run, name="ra-wal", daemon=True)
        self._thread.start()

    def reopen(self) -> bool:
        """Roll to a fresh file after a failure (the supervisor-restart
        analog). The failed file stays on disk — acked batches in it are
        durable and boot recovery re-reads it. Per-writer gap state is
        reset so servers' resent tails are accepted in-seq. Also revives
        a dead writer thread, so one code path heals both failure
        shapes (I/O error, thread death)."""
        with self._cv:
            if not self._failed:
                self._revive_thread_locked()
                return True  # another reopen already succeeded
            with self._io_lock:
                try:
                    if self._file is not None:
                        try:
                            self._file.close()
                        except OSError:
                            pass
                    self._queue.clear()  # unacked queue: servers resend
                    self._open_next()
                    # probe write: _open_next put 4 magic bytes on a
                    # fresh file, proving the filesystem extends files
                    # again; firing the write failpoint here makes an
                    # armed ENOSPC storm hold the WAL down (degraded)
                    # until the storm heals instead of letting reopen
                    # "succeed" into the next failing batch
                    faults.fire("wal.write", self.fault_scope)
                    self._last_idx = {}
                    self._failed = False
                    self.failure_class = None
                except OSError:
                    return False
            self._revive_thread_locked()
        return True

    def _recover(self) -> None:
        """Re-read surviving WAL files into memtables and hand them to the
        segment writer, then start from a fresh file."""
        files = sorted(
            f for f in os.listdir(self.dir) if f.endswith(".wal")
        )
        from ra_tpu_torch.protocol import Entry
        import pickle

        for fname in files:
            path = os.path.join(self.dir, fname)
            live_seqs = self._recover_file(path, Entry, pickle)
            if live_seqs is None:
                continue
            if self.segment_writer is not None and live_seqs:
                self.segment_writer.flush_mem_tables(
                    self._flush_jobs(live_seqs), wal_file=path
                )
            elif not live_seqs:
                os.unlink(path)
            # else: no segment writer configured — the file is the only
            # durable copy of these entries (the memtable rebuild above is
            # RAM only), so it must survive until a segment writer flushes
            # it; recovery re-reads it next boot (idempotent inserts)
            num = int(fname.split(".")[0])
            self._file_num = max(self._file_num, num)

    # recovery streams files in bounded chunks instead of loading them
    # whole (a 256 MB WAL x several files must not need that much RAM at
    # boot; reference reads 32 MB chunks, src/ra_log_wal.erl:393-470)
    RECOVER_CHUNK = 8 * 1024 * 1024

    def _recover_file(self, path: str, Entry, pickle):
        """Parse one WAL file streaming; returns {uid: {tid: seq}} or
        None when the file was unreadable/invalid (and removed)."""
        seqs: Dict[str, Dict[int, Seq]] = {}
        uids: Dict[int, str] = {}
        try:
            f = open(path, "rb")
        except OSError:
            return None
        with f:
            if f.read(4) != MAGIC:
                f.close()
                os.unlink(path)
                return None
            buf = b""
            pos = 0
            eof = False

            def read_chunk() -> bytes:
                faults.fire("wal.recover_read", self.fault_scope)
                return f.read(self.RECOVER_CHUNK)

            def ensure(n: int) -> bool:
                nonlocal buf, pos, eof
                while len(buf) - pos < n and not eof:
                    # transient read errors retry; a persistently bad
                    # disk surfaces the OSError to boot (data may be
                    # recoverable later — never silently unlink)
                    chunk = retry(read_chunk, attempts=3, delay_s=0.02)
                    if not chunk:
                        eof = True
                        break
                    buf = buf[pos:] + chunk
                    pos = 0
                return len(buf) - pos >= n

            def fail_if_data_follows(what: str) -> None:
                """Distinguish a torn tail from mid-file corruption: any
                non-zero byte beyond the bad record means valid data
                would be silently dropped — refuse to recover."""
                rest = buf[pos:]
                if any(rest):
                    raise WalCorruptionError(
                        f"{path}: {what} at offset ~{f.tell() - len(rest)} "
                        "with data following — refusing to truncate "
                        "acked entries (restore the file or delete it "
                        "explicitly to accept the loss)"
                    )
                while True:
                    chunk = f.read(self.RECOVER_CHUNK)
                    if not chunk:
                        return
                    if any(chunk):
                        raise WalCorruptionError(
                            f"{path}: {what} with data following — "
                            "refusing to truncate acked entries"
                        )

            while True:
                if not ensure(1):
                    break
                kind = buf[pos]
                try:
                    if kind == K_UID:
                        if not ensure(_UID_HDR.size):
                            break
                        _, ref, ln = _UID_HDR.unpack_from(buf, pos)
                        if not ensure(_UID_HDR.size + ln):
                            break
                        pos += _UID_HDR.size
                        uids[ref] = buf[pos : pos + ln].decode()
                        pos += ln
                    elif kind == K_TRUNC:
                        if not ensure(_TRUNC_HDR.size):
                            break
                        _, ref, idx = _TRUNC_HDR.unpack_from(buf, pos)
                        pos += _TRUNC_HDR.size
                        uid = uids[ref]
                        self.tables.mem_table(uid).truncate_from(idx)
                        for t in list(seqs.get(uid, {})):
                            seqs[uid][t] = seqs[uid][t].limit(idx - 1)
                        self._last_idx[uid] = idx - 1
                    elif kind in (K_ENTRY, K_SPARSE):
                        if not ensure(_ENTRY_HDR.size):
                            break
                        _, ref, idx, term, crc, ln = _ENTRY_HDR.unpack_from(buf, pos)
                        if ln > max(self.max_size_bytes, 1 << 30):
                            # the length field is unprotected by the
                            # record CRC; an implausible value is a bit
                            # flip, not a torn write (a low-byte flip is
                            # caught by the CRC check below instead)
                            raise WalCorruptionError(
                                f"{path}: implausible record length {ln} "
                                "— refusing to truncate acked entries"
                            )
                        if not ensure(_ENTRY_HDR.size + ln):
                            break  # torn tail
                        pos += _ENTRY_HDR.size
                        payload = buf[pos : pos + ln]
                        pos += ln
                        if self.compute_checksums and crc:
                            if zlib.crc32(struct.pack("<QQ", idx, term) + payload) != crc:
                                # torn FINAL record truncates; corruption
                                # with live data after it must fail loud
                                fail_if_data_follows("checksum failure")
                                break
                        uid = uids[ref]
                        # pre-init registered this uid's snapshot floor
                        # before recovery ran: skip dead indexes instead
                        # of resurrecting them (reference:
                        # ra_log_pre_init.erl:31-45)
                        snap_idx = self.tables.snapshot_index(uid)
                        if idx <= snap_idx and idx not in self.tables.live_indexes(uid):
                            self._last_idx[uid] = max(self._last_idx.get(uid, 0), idx)
                            continue
                        mt = self.tables.mem_table(uid)
                        per = seqs.setdefault(uid, {})
                        if kind == K_SPARSE:
                            # sparse records carry no contiguity or
                            # truncation semantics: never rewind the
                            # writer watermark or clip higher entries
                            t = mt.insert_sparse(Entry(idx, term, pickle.loads(payload)))
                            per[t] = per.get(t, Seq.empty()).add(idx)
                            self._last_idx[uid] = max(self._last_idx.get(uid, 0), idx)
                            continue
                        t = mt.insert(Entry(idx, term, pickle.loads(payload)))
                        last_any = max((sq.last() or 0 for sq in per.values()), default=0)
                        if idx <= last_any:
                            for tt in list(per):
                                per[tt] = per[tt].limit(idx - 1)
                        per[t] = per.get(t, Seq.empty()).add(idx)
                        self._last_idx[uid] = idx
                    else:
                        # unknown kind byte: zero padding ends the file
                        # cleanly; anything else is corruption
                        fail_if_data_follows(f"unknown record kind {kind}")
                        break
                except (struct.error, KeyError, IndexError, EOFError):
                    fail_if_data_follows("unparseable record")
                    break
        return {
            u: {t: sq for t, sq in per.items() if not sq.is_empty()}
            for u, per in seqs.items()
            if any(not sq.is_empty() for sq in per.values())
        }

    def overview(self) -> Dict[str, Any]:
        return {
            "file": self._file_path,
            "bytes": self._bytes,
            "writers": len(self._last_idx),
            "counters": self.counter.to_dict(),
        }
