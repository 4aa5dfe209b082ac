"""Timer service: one thread, a heap of (deadline, ref, callback).

Backs election timeouts (randomized tiers), server ticks and machine
timers — the roles gen_statem timeouts play in the reference
(reference: election_timeout_action tiers src/ra_server_proc.erl:
1931-1950, tick timer :1954).
"""

from __future__ import annotations

import heapq
import itertools
import random
import logging
import threading
from typing import Any, Callable, Dict, Optional

from ra_tpu_torch.runtime.clock import WALL


logger = logging.getLogger("ra_tpu_torch")



class TimerService:
    def __init__(self, clock=None) -> None:
        self._clock = clock or WALL
        self._heap: list = []
        self._cancelled: set = set()
        self._live: set = set()
        self._cv = threading.Condition()
        self._closed = False
        self._refs = itertools.count(1)
        self._thread = threading.Thread(target=self._run, name="ra-timers", daemon=True)
        self._thread.start()

    def after(self, delay_s: float, cb: Callable[[], None]) -> int:
        ref = next(self._refs)
        with self._cv:
            heapq.heappush(self._heap, (self._clock.monotonic() + delay_s, ref, cb))
            self._live.add(ref)
            self._cv.notify()
        return ref

    def cancel(self, ref: Optional[int]) -> None:
        if ref is None:
            return
        with self._cv:
            # only pending timers can be cancelled; marking fired refs
            # would leak them in the set forever
            if ref in self._live:
                self._cancelled.add(ref)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._closed:
                    self._cv.wait(timeout=0.5)
                if self._closed:
                    return
                deadline, ref, cb = self._heap[0]
                now = self._clock.monotonic()
                if deadline > now:
                    self._cv.wait(timeout=min(deadline - now, 0.5))
                    continue
                heapq.heappop(self._heap)
                self._live.discard(ref)
                if ref in self._cancelled:
                    self._cancelled.discard(ref)
                    continue
            # NOTE: a cancel() arriving after this point cannot stop the
            # callback; consumers treat late fires as spurious (e.g. an
            # ElectionTimeout with a live leader aborts harmlessly)
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.exception("timer callback crashed")

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=2)


def randomized_election_timeout(base_s: float, rng: Optional[random.Random] = None) -> float:
    """Randomized timeout so colliding candidates de-synchronize. An
    explicit ``rng`` makes the draw seed-deterministic (sim plane)."""
    return base_s * (1.0 + (rng or random).random())
