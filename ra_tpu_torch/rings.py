"""Lock-free command-plane rings (docs/INTERNALS.md §16).

The ingress side of the async command plane: every producer thread
(client api calls, peer coordinators' step/egress threads, the WAL
writer, detector timers) publishes into its OWN bounded single-producer/
single-consumer ring, and the coordinator's step thread drains all
lanes in one batched pass. No producer ever contends with the step loop
on a lock, and the step loop never takes a lock to drain.

Why this is safe in CPython: the GIL serializes bytecodes, so a slot
store followed by an index store is observed in that order by every
other thread (sequential consistency at bytecode granularity). The SPSC
discipline does the rest — the producer owns ``tail``, the consumer
owns ``head``, and each lives on its own 64-byte cache line of a shared
int64 array so the two sides never write the same line.

Backpressure is explicit: ``try_push`` on a full ring returns False and
the caller decides (admission reject for client commands, counted drop
for lossy protocol traffic, a bounded gate-wait for must-deliver
control messages) — a full ring NEVER silently drops.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np

# 8 int64 slots = 64 bytes: head and tail land on separate cache lines
_PAD = 8


class SpscRing:
    """Bounded single-producer/single-consumer ring.

    ``try_push`` is producer-side only; ``pop_many`` consumer-side only.
    When a lane must be SHARED by several producers (bounded-lane mode),
    the owner arms ``producer_lock`` and pushes serialize on it — the
    consumer side stays lock-free either way.
    """

    __slots__ = ("capacity", "_mask", "_buf", "_codes", "_idx",
                 "producer_lock")

    def __init__(self, capacity: int = 8192):
        cap = 1
        while cap < capacity:
            cap <<= 1
        self.capacity = cap
        self._mask = cap - 1
        self._buf: List = [None] * cap
        # class-code sidecar (protocol.RC_*): the flat tagged-item
        # layout the native drain-classify partition consumes. Written
        # before the tail publish, like the slot itself.
        self._codes = bytearray(cap)
        # [0] = head (consumer-owned), [_PAD] = tail (producer-owned)
        self._idx = np.zeros(2 * _PAD, np.int64)
        self.producer_lock: Optional[threading.Lock] = None

    def try_push(self, item, code: int = 0) -> bool:
        """Publish one item; False when full (caller handles — never a
        silent drop). The slot store precedes the tail publish, so a
        concurrent pop never reads an unwritten slot."""
        idx = self._idx
        t = int(idx[_PAD])
        if t - int(idx[0]) >= self.capacity:
            return False
        s = t & self._mask
        self._buf[s] = item
        self._codes[s] = code
        idx[_PAD] = t + 1
        return True

    def pop_many(self, out: List, limit: Optional[int] = None,
                 codes: Optional[bytearray] = None) -> int:
        """Drain up to ``limit`` (default: all) items into ``out`` in
        FIFO order; returns the count. Slots are released (None) before
        the head publish so the producer never overwrites a live ref.
        With ``codes``, the class-code sidecar is appended in step."""
        idx = self._idx
        h = int(idx[0])
        n = int(idx[_PAD]) - h
        if limit is not None and n > limit:
            n = limit
        if n <= 0:
            return 0
        buf = self._buf
        mask = self._mask
        cbuf = self._codes
        for k in range(h, h + n):
            s = k & mask
            out.append(buf[s])
            buf[s] = None
            if codes is not None:
                codes.append(cbuf[s])
        idx[0] = h + n
        return n

    def __len__(self) -> int:
        # head before tail: both only grow and head never passes tail,
        # so a consumer that pops between the two reads cannot make the
        # difference negative (tail first could, and len() then raises)
        h = int(self._idx[0])
        return int(self._idx[_PAD]) - h


class WaitGate:
    """Renewable wakeup for backpressured waiters.

    A waiter grabs the CURRENT event (``waiter()``) and waits on it;
    ``open()`` set-and-replaces the event so every waiter parked before
    the release wakes exactly once and later waiters park on a fresh
    one. Idle cost is one attribute check: ``open()`` is a no-op until
    someone armed the gate. This is how "a waiter is woken by ack/drain
    completion, not by sleeping" is implemented end to end (admission
    rejects and ring-full rejects both carry a gate waiter).
    """

    __slots__ = ("_evt", "_armed", "_lock")

    def __init__(self):
        self._evt = threading.Event()
        self._armed = False
        self._lock = threading.Lock()

    def waiter(self) -> threading.Event:
        # the lock pairs the arm with the CURRENT event: without it a
        # waiter could arm, lose the CPU, and read the post-open fresh
        # event — the release that freed its space would then never
        # signal it and the client would sleep the full backoff bound
        with self._lock:
            self._armed = True
            return self._evt

    def open(self) -> None:
        if not self._armed:
            return  # unlocked fast path: idle cost stays one attr check
        with self._lock:
            if not self._armed:
                return
            self._armed = False
            evt = self._evt
            self._evt = threading.Event()
        evt.set()


class IngressRings:
    """Multi-lane ingress: one SPSC ring per producer thread, batched
    multi-lane drain on the consumer side.

    Lanes are created on a producer's first publish and cached in a
    thread-local (thread ids are only reused after the owner exits, so
    the single-producer invariant holds across id reuse). With
    ``max_lanes`` set, producers past the cap share lanes keyed by
    ``ident % max_lanes`` and pushes serialize on the lane's producer
    lock — the drain side is unchanged.

    ``wake`` (a threading.Event) is set after every successful publish:
    the publish-then-set order plus the consumer's clear-then-check-
    then-wait order makes lost wakeups impossible (see the step-loop
    idle protocol in coordinator._run_pipelined).
    """

    def __init__(self, lane_slots: int = 8192,
                 wake: Optional[threading.Event] = None,
                 max_lanes: Optional[int] = None):
        self._lane_slots = lane_slots
        self._max_lanes = max_lanes
        self._wake = wake
        self._lanes: Dict[int, SpscRing] = {}
        self._lane_list: List[SpscRing] = []
        self._lane_lock = threading.Lock()
        self._local = threading.local()

    # -- producer side ----------------------------------------------------

    def _lane(self) -> SpscRing:
        lane = getattr(self._local, "lane", None)
        if lane is None:
            ident = threading.get_ident()
            key = ident if self._max_lanes is None else ident % self._max_lanes
            with self._lane_lock:
                lane = self._lanes.get(key)
                if lane is None:
                    lane = SpscRing(self._lane_slots)
                    if self._max_lanes is not None:
                        lane.producer_lock = threading.Lock()
                    self._lanes[key] = lane
                    # publish the lane to the drain snapshot BEFORE any
                    # item can land in it
                    self._lane_list = list(self._lanes.values())
            self._local.lane = lane
        return lane

    def publish(self, item, code: int = 0) -> bool:
        """Push onto this thread's lane; returns False when the lane is
        full (backpressure — the caller decides the policy)."""
        lane = self._lane()
        plock = lane.producer_lock
        if plock is None:
            ok = lane.try_push(item, code)
        else:
            with plock:
                ok = lane.try_push(item, code)
        if ok:
            w = self._wake
            if w is not None and not w.is_set():
                w.set()
        return ok

    # -- consumer side ----------------------------------------------------

    def drain(self, out: List, codes: Optional[bytearray] = None) -> int:
        """Pop everything from every lane into ``out`` (per-lane FIFO
        preserved); returns the item count. With ``codes``, the class-
        code sidecar is appended in step with the items."""
        n = 0
        for lane in self._lane_list:
            if len(lane):
                n += lane.pop_many(out, None, codes)
        return n

    def pending(self) -> bool:
        for lane in self._lane_list:
            if len(lane):
                return True
        return False

    def lanes(self) -> int:
        return len(self._lane_list)

    def prune_dead(self) -> int:
        """Reclaim EMPTY lanes whose owner thread has exited (each lane
        is a slot array the drain scans forever; a workload spawning
        short-lived client threads would otherwise grow the scan and
        the memory without bound). Safe: a dead owner can never push
        again, the empty check runs under the lane lock against any
        concurrent lane creation, and an id reused by a NEW thread
        simply re-creates a fresh lane on its first publish (the
        thread-local cache is per-thread, so the new thread never sees
        the pruned object). Shared-lane mode (max_lanes) never prunes —
        lanes there are keyed by id modulo, not ownership. Returns the
        number pruned; call off the hot path (the detect tick)."""
        if self._max_lanes is not None or not self._lanes:
            return 0
        pruned = 0
        with self._lane_lock:
            # snapshot liveness UNDER the lane lock: lane creation also
            # holds it, so any thread whose lane exists here was alive
            # at lock acquisition and appears in the enumeration — a
            # pre-lock snapshot could miss a thread that started (and
            # registered a still-empty lane) after it, pruning a LIVE
            # lane whose owner would then publish into an orphan no
            # drain ever scans
            alive = {t.ident for t in threading.enumerate()}
            for ident in list(self._lanes):
                lane = self._lanes[ident]
                if ident not in alive and not len(lane):
                    del self._lanes[ident]
                    pruned += 1
            if pruned:
                self._lane_list = list(self._lanes.values())
        return pruned


class LockedLanes:
    """Condition-free lock+deque control implementation of the same
    interface — the ``rings=off`` A/B control (the pre-ring command
    plane's single guarded queue, minus its 50 ms timed polls so the
    control isolates the ring/lock difference, not the wakeup change).
    Unbounded, like the deque it replaces."""

    def __init__(self, lane_slots: int = 8192,
                 wake: Optional[threading.Event] = None,
                 max_lanes: Optional[int] = None):
        self._lock = threading.Lock()
        self._q: deque = deque()
        self._qc: deque = deque()  # class-code sidecar, in step with _q
        self._wake = wake

    def publish(self, item, code: int = 0) -> bool:
        with self._lock:
            self._q.append(item)
            self._qc.append(code)
        w = self._wake
        if w is not None and not w.is_set():
            w.set()
        return True

    def drain(self, out: List, codes: Optional[bytearray] = None) -> int:
        with self._lock:
            n = len(self._q)
            if n:
                out.extend(self._q)
                self._q.clear()
                if codes is not None:
                    codes.extend(self._qc)
                self._qc.clear()
        return n

    def pending(self) -> bool:
        return bool(self._q)

    def lanes(self) -> int:
        return 1
