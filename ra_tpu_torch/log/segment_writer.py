"""Segment writer: flushes rolled-over memtable ranges to per-server
segment files.

The reference's ``ra_log_segment_writer`` (``src/ra_log_segment_writer
.erl``): one per system; takes ``{uid: seq}`` jobs from the WAL at
rollover, truncates the flush floor by each server's snapshot state,
appends entries from the memtable to the server's open segment (rolling
to a new segment when full), fsyncs, then notifies the server with
``("segments", flushed_seq, new_refs)`` so it can update its segment set
and shrink its memtable. Deletes the WAL file once flushed.

Runs jobs on a background thread (``threaded=False`` for deterministic
tests).
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ra_tpu_torch import counters as ra_counters
from ra_tpu_torch import faults
from ra_tpu_torch.log.segment import SegmentWriterHandle
from ra_tpu_torch.protocol import encode_cmd
from ra_tpu_torch.log.tables import TableRegistry
from ra_tpu_torch.utils.lib import retry
from ra_tpu_torch.utils.seq import Seq

NotifyFn = Callable[[str, object], None]

logger = logging.getLogger("ra_tpu_torch")


class SegmentWriter:
    MAX_FLUSH_ATTEMPTS = 5

    def __init__(
        self,
        data_dir: str,
        tables: TableRegistry,
        notify: NotifyFn,
        max_entries: int = 4096,
        threaded: bool = True,
        counter=None,
    ):
        self.data_dir = data_dir
        self.tables = tables
        self.notify = notify
        self.max_entries = max_entries
        self.counter = counter or ra_counters.Counters(
            "segment_writer", ra_counters.SEGMENT_WRITER_FIELDS
        )
        # failpoint scope label; the owning node sets it to its name
        self.fault_scope: Optional[str] = None
        self._open: Dict[str, SegmentWriterHandle] = {}
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._inflight = None  # job popped but not finished (crash safety)
        self._closed = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        if threaded:
            self._thread = threading.Thread(
                target=self._run, name="ra-segment-writer", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------------

    def flush_mem_tables(
        self, seqs: Dict[str, List[Tuple[int, Seq]]],
        wal_file: Optional[str] = None,
    ) -> None:
        """``seqs``: {uid: [(tid, Seq), ...]} — the successor-chain
        handoff from WAL rollover (tid names the memtable table that
        holds each file's entries)."""
        norm = {uid: list(ts) for uid, ts in seqs.items()}
        with self._cv:
            if self._closed:
                return
            self._queue.append((norm, wal_file, 0))
            self._idle.clear()
            self._cv.notify()
        if self._thread is None:
            self._drain()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        return self._idle.wait(timeout)

    def thread_alive(self) -> bool:
        """Flusher-thread liveness for the node's infra supervisor
        (non-threaded mode drains synchronously: always 'alive')."""
        return self._thread is None or self._thread.is_alive()

    def revive_thread(self) -> None:
        """Restart a dead flusher thread (supervision). The job queue
        survives, and a job that was IN FLIGHT when the thread died is
        requeued at the front (its seqs dict already dropped finished
        uids, so completed flushes are not replayed)."""
        with self._cv:
            if self._closed or self._thread is None or self._thread.is_alive():
                return
            if self._inflight is not None:
                self._queue.appendleft(self._inflight)
                self._inflight = None
            self._thread = threading.Thread(
                target=self._run, name="ra-segment-writer", daemon=True
            )
            self._thread.start()

    def my_segments(self, uid: str) -> List[str]:
        d = self._server_dir(uid)
        if not os.path.isdir(d):
            return []
        return sorted(f for f in os.listdir(d) if f.endswith(".segment"))

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._drain()
        for h in self._open.values():
            h.close()
        self._open.clear()

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while True:
            # injected thread death — supervision revives via
            # revive_thread (in-flight job requeues at the front)
            faults.fire("segment_writer.thread", self.fault_scope)
            with self._cv:
                while not self._queue and not self._closed:
                    self._idle.set()
                    self._cv.wait(timeout=0.5)
                    # idle loop checks the site too (see Wal._run)
                    faults.fire("segment_writer.thread", self.fault_scope)
                if self._closed and not self._queue:
                    self._idle.set()
                    return
            self._drain()

    def _drain(self) -> None:
        while True:
            with self._cv:
                if not self._queue:
                    self._idle.set()
                    return
                job = self._queue.popleft()
                self._inflight = job
            seqs, wal_file, attempt = job
            try:
                self._flush_job(seqs)
            except Exception as exc:  # noqa: BLE001
                # The WAL file is the only durable copy of these entries
                # until the flush lands in segments: never unlink it on
                # failure, and never let one bad flush kill the writer.
                # Retry with backoff (requeued at the FRONT so per-uid
                # flush order is preserved); after that, leave the WAL
                # file on disk so boot-time recovery can replay it.
                self.counter.incr("flush_errors")
                with self._cv:
                    self._inflight = None
                    if attempt + 1 < self.MAX_FLUSH_ATTEMPTS:
                        self._queue.appendleft((seqs, wal_file, attempt + 1))
                        # interruptible backoff (close() notifies); total
                        # worst-case stall per job is < 1s
                        self._cv.wait(timeout=min(0.05 * (2 ** attempt), 0.4))
                    else:
                        logger.error(
                            "segment_writer: flush failed after %d attempts, "
                            "retaining %r: %r", attempt + 1, wal_file, exc,
                        )
                continue
            with self._cv:
                self._inflight = None
            if wal_file and os.path.exists(wal_file):
                os.unlink(wal_file)

    def _flush_job(self, seqs) -> None:
        # uids are removed from ``seqs`` as they complete so a retried
        # job (requeued by _drain on failure) never replays finished
        # uids' appends/notifications
        for uid in list(seqs):
            self._flush_uid(uid, seqs[uid])
            del seqs[uid]

    def _flush_uid(self, uid: str, tid_seqs) -> None:
        # flush floor: skip dead indexes below the snapshot, keep live
        # ones (reference: start_index/smallest_live_idx truncation,
        # src/ra_log_segment_writer.erl:268-390). Entries are read from
        # the EXACT memtable table the WAL file referenced (successor
        # chains): a concurrent divergent overwrite must not change what
        # this flush persists.
        # injected flush failure: lands in _drain's retry-with-backoff
        # path (the WAL file is retained until the flush succeeds)
        faults.fire("segment_writer.flush", self.fault_scope)
        snap_idx = self.tables.snapshot_index(uid)
        live = self.tables.live_indexes(uid)
        mt = self.tables.mem_table(uid)
        new_refs: List[Tuple[str, Tuple[int, int]]] = []
        handle = self._open_segment(uid)
        wrote = 0
        flushed: List[Tuple[int, Seq]] = []
        for tid, seq in tid_seqs:
            keep = seq.floor(snap_idx + 1).union(seq.intersect(live))
            for idx in keep:
                entry = mt.get_from(tid, idx)
                if entry is None:
                    continue  # already truncated/compacted away
                if handle.is_full():
                    handle.sync()
                    handle.close()
                    if handle.range:
                        new_refs.append((os.path.basename(handle.path), handle.range))
                    handle = self._roll_segment(uid)
                handle.append(entry.index, entry.term, encode_cmd(entry.cmd))
                wrote += 1
            flushed.append((tid, seq))
        if wrote:
            handle.sync()
            self.counter.incr("entries_flushed", wrote)
        self.counter.incr("mem_tables_flushed")
        if handle.range:
            new_refs.append((os.path.basename(handle.path), handle.range))
        self.notify(uid, ("segments", flushed, new_refs))

    def _server_dir(self, uid: str) -> str:
        return os.path.join(self.data_dir, uid, "segments")

    def _open_segment(self, uid: str) -> SegmentWriterHandle:
        h = self._open.get(uid)
        if h is not None:
            return h
        d = self._server_dir(uid)
        os.makedirs(d, exist_ok=True)
        existing = self.my_segments(uid)
        if existing:
            h = retry(
                lambda: SegmentWriterHandle(
                    os.path.join(d, existing[-1]), max_count=self.max_entries
                ),
                attempts=3, delay_s=0.02,
            )
            if h.is_full():
                h.close()
                h = self._new_segment(uid, existing[-1])
        else:
            h = self._new_segment(uid, None)
        self._open[uid] = h
        return h

    def _roll_segment(self, uid: str) -> SegmentWriterHandle:
        prev = os.path.basename(self._open[uid].path)
        h = self._new_segment(uid, prev)
        self._open[uid] = h
        return h

    def _new_segment(self, uid: str, prev_name: Optional[str]) -> SegmentWriterHandle:
        n = int(prev_name.split(".")[0]) + 1 if prev_name else 1
        path = os.path.join(self._server_dir(uid), f"{n:08d}.segment")
        self.counter.incr("segments_created")
        return retry(
            lambda: SegmentWriterHandle(path, max_count=self.max_entries),
            attempts=3, delay_s=0.02,
        )
