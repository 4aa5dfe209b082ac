"""Virtual clock: integer-millisecond simulated time.

Drop-in for ``ra_tpu_torch.runtime.clock.WallClock`` behind the clock seam
(``ServerConfig.clock``, ``TimerService(clock=...)``): ``monotonic()``
and ``time()`` read simulated time, and ``sleep()`` REFUSES — in a
deterministic simulation nothing may block a real thread; waiting is
expressed by scheduling an event (``SimScheduler.after_ms``). Any
``sleep`` reaching the virtual clock is a bug in the caller: code that
still needs a thread does not belong under the sim plane.

Time is integer milliseconds internally so two runs can never diverge
through float accumulation; ``monotonic()``/``time()`` convert at the
edge. ``time()`` is offset by a fixed epoch so code that formats wall
timestamps (Tick.now_ms consumers, log lines) sees plausible values —
the epoch is a constant, never ``time.time()``, or determinism dies.
"""

from __future__ import annotations

# fixed, arbitrary "wall" base: 2020-09-13T12:26:40Z
SIM_EPOCH_S = 1_600_000_000


class VirtualClock:
    __slots__ = ("now_ms",)

    def __init__(self) -> None:
        self.now_ms: int = 0

    # -- WallClock interface ------------------------------------------------

    def monotonic(self) -> float:
        return self.now_ms / 1000.0

    def monotonic_ns(self) -> int:
        return self.now_ms * 1_000_000

    def time(self) -> float:
        return SIM_EPOCH_S + self.now_ms / 1000.0

    def sleep(self, seconds: float) -> None:
        raise RuntimeError(
            "sleep() on the virtual clock: simulated code must schedule "
            "an event (SimScheduler.after_ms), never block a thread"
        )

    # -- simulation driver ----------------------------------------------------

    def advance_to(self, t_ms: int) -> None:
        if t_ms < self.now_ms:
            raise ValueError(f"time moved backwards: {t_ms} < {self.now_ms}")
        self.now_ms = t_ms


class SkewedClock:
    """Per-node view over a shared :class:`VirtualClock` running at a
    slightly different RATE (``1 + rate``, e.g. ``rate=0.01`` is a
    clock 1% fast).

    Rate skew — not offset — is the honest adversary for clock-bound
    leases (docs/INTERNALS.md §20): a constant offset cancels out of
    every lease comparison (basis vs now on the leader's own clock,
    contact vs now on the follower's own clock), while rate skew makes
    one node's measured election-timeout window genuinely shorter or
    longer than another's. The lease ``drift_epsilon_s`` exists to
    absorb exactly this, so the sim draws each node's rate from the
    schedule seed (bounded by ``Schedule.skew_ppm``) and the lease
    config widens epsilon to cover the bound — a run that violates
    linearizability under covered skew is a real lease-math bug."""

    __slots__ = ("_base", "rate")

    def __init__(self, base: VirtualClock, rate: float) -> None:
        self._base = base
        self.rate = rate

    def monotonic(self) -> float:
        return (self._base.now_ms / 1000.0) * (1.0 + self.rate)

    def monotonic_ns(self) -> int:
        return int(self._base.now_ms * 1_000_000 * (1.0 + self.rate))

    def time(self) -> float:
        return SIM_EPOCH_S + (self._base.now_ms / 1000.0) * (1.0 + self.rate)

    def sleep(self, seconds: float) -> None:
        raise RuntimeError(
            "sleep() on the virtual clock: simulated code must schedule "
            "an event (SimScheduler.after_ms), never block a thread"
        )
