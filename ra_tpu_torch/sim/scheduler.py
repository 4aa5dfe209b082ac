"""Deterministic single-threaded run queue over virtual time.

This replaces every concurrency source the threaded runtime has —
``TimerService`` wheels, actor mailup threads, WAL fsync completions,
transport deliveries — with ONE ordered heap of ``(t_ms, seq, fn)``.
``seq`` is a global arrival counter, so events at the same virtual
millisecond run in the order they were scheduled (FIFO tie-break): the
whole execution is a pure function of (schedule, seed), which is the
determinism invariant the sim tests assert byte-for-byte
(docs/INTERNALS.md §19).

Cancellation is tombstone-based (drop the ref from the live map) so a
cancel never perturbs heap order — the popped tombstone is skipped.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

from ra_tpu_torch.sim.clock import VirtualClock


class SimScheduler:
    def __init__(self, clock: VirtualClock) -> None:
        self.clock = clock
        self._heap: List[Tuple[int, int, int]] = []  # (t_ms, seq, ref)
        self._live: Dict[int, Callable[[], None]] = {}
        self._seq = 0

    def after_ms(self, delay_ms: int, fn: Callable[[], None]) -> int:
        """Schedule fn at now + delay_ms; returns a cancellable ref."""
        self._seq += 1
        ref = self._seq
        t = self.clock.now_ms + max(0, int(delay_ms))
        heapq.heappush(self._heap, (t, ref, ref))
        self._live[ref] = fn
        return ref

    def cancel(self, ref: Optional[int]) -> None:
        if ref is not None:
            self._live.pop(ref, None)

    def pending(self) -> int:
        return len(self._live)

    def run_next(self) -> bool:
        """Advance virtual time to the next live event and run it.
        Returns False when the queue is drained."""
        while self._heap:
            t, _seq, ref = heapq.heappop(self._heap)
            fn = self._live.pop(ref, None)
            if fn is None:
                continue  # cancelled tombstone
            self.clock.advance_to(t)
            fn()
            return True
        return False


class SimTimerService:
    """``ra_tpu_torch.runtime.timers.TimerService`` facade over the sim run
    queue (after/cancel/close in seconds), for code written against the
    threaded timer wheel. The sim world itself schedules in ms."""

    def __init__(self, sched: SimScheduler) -> None:
        self._sched = sched

    def after(self, delay_s: float, fn: Callable[[], None]):
        return self._sched.after_ms(int(round(delay_s * 1000.0)), fn)

    def cancel(self, ref) -> None:
        self._sched.cancel(ref)

    def close(self) -> None:
        pass
