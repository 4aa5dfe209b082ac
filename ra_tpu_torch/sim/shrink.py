"""Auto-shrinker: delta-debug a failing schedule to a minimal repro.

Determinism makes shrinking trivially sound: a candidate schedule either
reproduces the violation or it doesn't — there is no flakiness to
tolerate, so plain ddmin (Zeller/Hildebrandt) over the materialized op
list converges without repetition heuristics. The result is 1-minimal:
removing any single remaining op makes the failure disappear.

Only the external op timeline is shrunk. Seed-derived internals
(election jitter, network fault draws, nemesis choices) replay
identically under the same parameters, so candidates stay meaningful —
the same storms hit a shorter client history.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ra_tpu_torch.sim.schedule import Op, Schedule


def default_fails(sched: Schedule) -> bool:
    from ra_tpu_torch.sim.world import run_schedule

    return not run_schedule(sched).ok


def shrink(
    sched: Schedule,
    fails: Optional[Callable[[Schedule], bool]] = None,
    ctr=None,
) -> Tuple[Schedule, int]:
    """ddmin the schedule's ops down to a 1-minimal failing list.

    Returns ``(minimized schedule, replays executed)``. Raises
    ``ValueError`` if the input schedule does not fail — shrinking a
    passing schedule would silently return garbage.
    """
    fails = fails or default_fails
    ops: List[Op] = list(sched.resolve_ops())
    base = sched.with_ops(ops)  # materialized: candidates are explicit data
    iterations = 0

    def check(candidate: List[Op]) -> bool:
        nonlocal iterations
        iterations += 1
        if ctr is not None:
            ctr.incr("sim_shrink_iterations")
        return fails(base.with_ops(candidate))

    if not check(ops):
        raise ValueError("schedule does not fail; nothing to shrink")

    n = 2
    while len(ops) >= 2:
        size = len(ops) // n
        reduced = False
        # complement-only ddmin: try dropping each of the n chunks
        for i in range(n):
            start = i * size
            end = start + size if i < n - 1 else len(ops)
            candidate = ops[:start] + ops[end:]
            if candidate and check(candidate):
                ops = candidate
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(ops):
                break  # granularity 1 and nothing droppable: 1-minimal
            n = min(len(ops), 2 * n)

    if ctr is not None:
        ctr.incr("sim_minimized_ops", len(ops))
    return base.with_ops(ops), iterations
