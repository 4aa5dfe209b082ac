"""The clock seam: every behavioral time read in the runtime goes
through an injectable clock object.

``WallClock`` (the process-wide ``WALL`` default) is a zero-overhead
facade over the ``time`` module — production behavior is unchanged.
The simulation plane (``ra_tpu_torch/sim``) injects a ``VirtualClock`` whose
``monotonic()`` is advanced by the deterministic event loop, which is
what lets one seed fully determine an execution: election windows,
check-quorum windows, tick cadences and TTL deadlines all read THIS
seam instead of ``time.monotonic()``.

Contract (docs/INTERNALS.md §19):

- ``monotonic()``/``monotonic_ns()`` — never goes backwards; the basis
  for every deadline, window and timer in the runtime.
- ``time()`` — wall-clock epoch seconds; feeds ``Tick.now_ms`` and
  machine ``system_time`` uses. Virtual clocks derive it from the same
  advancing counter so it is equally deterministic.
- ``sleep()`` — only ever called from real threads; a virtual clock
  must refuse it (nothing in a simulation may block), which doubles as
  an assertion that no thread-based code path runs under the sim.

Instrumentation-only stamps (latency histogram deltas in
``coordinator.py``/``server.py`` hot paths) intentionally stay on
``time.monotonic_ns`` where noted: they measure real elapsed host time
and are meaningless under simulation, which never runs those paths.
"""

from __future__ import annotations

import time


class WallClock:
    """The real clock: thin wrappers so the seam costs one attribute
    lookup on hot paths that already paid a method call."""

    __slots__ = ()

    def monotonic(self) -> float:
        return time.monotonic()

    def monotonic_ns(self) -> int:
        return time.monotonic_ns()

    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


WALL = WallClock()
