"""Actor scheduler: thousands of mailboxes over a small thread pool.

Replaces the reference's one-BEAM-process-per-group model (reference:
``ra_server_proc`` gen_statem per group) with event-driven actors: each
actor has a mailbox and an ``on_batch`` handler; a fixed worker pool runs
at most one drain per actor at a time (per-actor serialization, batched
delivery — the same property gen_statem + selective receive provides,
engineered for CPython where a thread per group would not scale).
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, List, Optional


logger = logging.getLogger("ra_tpu_torch")


class Actor:
    """Mailbox + serialized batch handler."""

    __slots__ = (
        "name", "on_batch", "_mailbox", "_lock", "_scheduled", "_sched",
        "alive", "_idle",
    )

    def __init__(self, name: str, on_batch: Callable[[List[Any]], None], sched: "Scheduler"):
        self.name = name
        self.on_batch = on_batch
        self._mailbox: deque = deque()
        self._lock = threading.Lock()
        self._scheduled = False
        self._sched = sched
        self.alive = True
        self._idle = threading.Event()
        self._idle.set()

    def send(self, msg: Any, front: bool = False) -> None:
        with self._lock:
            if not self.alive:
                return
            if front:
                self._mailbox.appendleft(msg)
            else:
                self._mailbox.append(msg)
            if not self._scheduled:
                self._scheduled = True
                self._sched._submit(self)

    def _drain(self, max_batch: int) -> None:
        while True:
            with self._lock:
                if not self._mailbox or not self.alive:
                    self._scheduled = False
                    self._idle.set()
                    return
                batch = []
                while self._mailbox and len(batch) < max_batch:
                    batch.append(self._mailbox.popleft())
                self._idle.clear()
            try:
                self.on_batch(batch)
            except Exception:  # noqa: BLE001 — actor crash isolation
                logger.exception("actor %r crashed", self.name)
                self._sched.on_actor_crash(self)
                with self._lock:
                    self._scheduled = False
                    self._idle.set()
                return

    def kill(self, quiesce_timeout: float = 5.0) -> None:
        """Stop the actor; blocks until any in-flight batch handler has
        finished, so callers may safely read the actor-owned state."""
        with self._lock:
            self.alive = False
            self._mailbox.clear()
        self._idle.wait(quiesce_timeout)


class Scheduler:
    def __init__(self, workers: int = 4, max_batch: int = 64):
        self.max_batch = max_batch
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.on_crash: Optional[Callable[[Actor], None]] = None
        self._threads = [
            threading.Thread(target=self._run, name=f"ra-sched-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def actor(self, name: str, on_batch: Callable[[List[Any]], None]) -> Actor:
        return Actor(name, on_batch, self)

    def _submit(self, actor: Actor) -> None:
        with self._cv:
            self._queue.append(actor)
            self._cv.notify()

    def on_actor_crash(self, actor: Actor) -> None:
        if self.on_crash is not None:
            try:
                self.on_crash(actor)
            except Exception:  # noqa: BLE001
                pass

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    # event-driven idle: _submit notifies per enqueue,
                    # close() notifies all — idle scheduler workers
                    # consume zero CPU (docs/INTERNALS.md §16)
                    self._cv.wait()
                if self._closed:
                    return
                actor = self._queue.popleft()
            actor._drain(self.max_batch)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)
