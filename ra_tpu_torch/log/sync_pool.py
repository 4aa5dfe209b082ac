"""Pooled fsync workers.

The counterpart of the reference's ``ra_log_sync`` (reference:
``src/ra_log_sync.erl:32-35`` — a pool of batching fsync workers, sized
schedulers/4, serializing snapshot-directory syncs across servers so a
burst of snapshot writes cannot issue an fsync storm against the
device). Callers block until their sync lands (durability semantics
unchanged); the pool bounds CONCURRENCY and batches same-path requests.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List, Optional


class SyncPool:
    def __init__(self, workers: Optional[int] = None,
                 coalesce_window_s: float = 0.001):
        n = workers or max(1, (os.cpu_count() or 1) // 4)
        # group-commit analog for snapshot syncs (docs/INTERNALS.md
        # §15): when a request arrives on the heels of another (a
        # snapshot burst across servers), hold it open briefly so
        # same-path joiners ride ONE fsync. Bounded and only armed
        # while a burst is evidently in progress — a lone sync pays
        # nothing.
        self.coalesce_window_s = coalesce_window_s
        self._last_req_t = float("-inf")
        self._req_gap = float("inf")  # arrival gap of the newest request
        self._cv = threading.Condition()
        self._queue: deque = deque()  # (path, Event, err_slot)
        self._closed = False
        self._threads = [
            threading.Thread(target=self._run, name=f"ra-sync-{i}", daemon=True)
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    def sync_path(self, path: str, timeout: Optional[float] = None) -> None:
        """fsync the file (or directory) at ``path`` via the pool;
        blocks until durable — like the inline os.fsync it replaces, a
        slow device makes this SLOWER, never a spurious failure (pass a
        timeout only where the caller can handle TimeoutError). Raises
        the worker's OSError on failure."""
        done = threading.Event()
        slot: Dict[str, BaseException] = {}
        with self._cv:
            if self._closed:
                # closed pool: sync inline so durability never silently
                # degrades
                self._fsync(path)
                return
            import time as _time

            now = _time.monotonic()
            self._req_gap = now - self._last_req_t
            self._last_req_t = now
            self._queue.append((path, done, slot))
            self._cv.notify()
        if not done.wait(timeout):
            raise TimeoutError(f"sync of {path!r} timed out")
        err = slot.get("err")
        if err is not None:
            raise err

    @staticmethod
    def _fsync(path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _run(self) -> None:
        import time as _time

        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    # event-driven idle: sync_path notifies on every
                    # enqueue and close() notifies all — idle workers
                    # consume zero CPU (docs/INTERNALS.md §16)
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                path, done, slot = self._queue.popleft()
                # adaptive coalescing: if another request landed within
                # the window just before this one, a burst is in
                # flight — hold briefly so its same-path joiners ride
                # this fsync (never armed for an isolated request)
                w = self.coalesce_window_s
                if (
                    w > 0 and not self._closed and not self._queue
                    and self._req_gap < 4 * w
                ):
                    # the newest request followed its predecessor
                    # closely: a burst — an isolated sync never waits
                    self._cv.wait(timeout=w)
                # batch: everyone queued behind us for the SAME path is
                # satisfied by this one fsync
                extra: List = []
                rest: deque = deque()
                while self._queue:
                    item = self._queue.popleft()
                    (extra if item[0] == path else rest).append(item)
                self._queue = rest
            try:
                self._fsync(path)
                err = None
            except OSError as e:
                err = e
            for _p, d, s in [(path, done, slot)] + extra:
                if err is not None:
                    s["err"] = err
                d.set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)
