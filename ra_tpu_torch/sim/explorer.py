"""Schedule explorer: sweep seeds x workloads, shrink what fails.

The CI-facing entry point of the simulation plane
(``python -m ra_tpu_torch.sim.explorer``, wired through
``scripts/sim_sweep.sh``). Each (workload, seed) pair becomes one
``Schedule`` with network faults and the nemesis planner on; failures
are auto-shrunk and dumped as standalone repro text a developer replays
with ``ra_tpu_torch.sim.schedule.loads`` + ``run_schedule``.

Virtual time is what makes the sweep cheap: a 12-virtual-second
schedule (8s of ops + storms, 4s of quiescence) executes in tens of
wall milliseconds because sleeps cost nothing — the run queue jumps the
clock. Measured rates live in docs/INTERNALS.md §19.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from ra_tpu_torch import counters as ra_counters
from ra_tpu_torch.counters import SIM_FIELDS
from ra_tpu_torch.sim.schedule import Schedule, dumps
from ra_tpu_torch.sim.shrink import shrink
from ra_tpu_torch.sim.workloads import WORKLOADS
from ra_tpu_torch.sim.world import run_schedule

# default fault mix: lossy, dup-happy, jittery — plus the nemesis
# planner (partitions / one-way links / restarts) on top
DEFAULT_FAULTS = dict(drop_p=0.02, dup_p=0.02, delay_p=0.15)


def explore(
    workloads: Sequence[str],
    seeds: Sequence[int],
    n_ops: int = 60,
    nemesis: bool = True,
    faults: Optional[Dict[str, float]] = None,
    shrink_failures: bool = True,
) -> Dict[str, Any]:
    """Run every (workload, seed) schedule; return a sweep summary with
    minimized repros for each failure."""
    fa = DEFAULT_FAULTS if faults is None else faults
    ctr = ra_counters.registry().new(("sim", "plane"), SIM_FIELDS)
    t0 = time.perf_counter()  # wall clock: we're OUTSIDE the sim here
    ran = 0
    steps = 0
    virtual_ms = 0
    failures: List[Dict[str, Any]] = []
    for workload in workloads:
        for seed in seeds:
            # kvread is the lease read-safety workload: leases on and
            # per-node clock rate skew at the covered bound, so the
            # sweep probes the drift-epsilon math, not a lease-off path
            lease_kw = (dict(lease=True, skew_ppm=10_000)
                        if workload == "kvread" else {})
            sched = Schedule(seed=seed, workload=workload, n_ops=n_ops,
                             nemesis=nemesis, **fa, **lease_kw)
            res = run_schedule(sched)
            ran += 1
            steps += res.steps
            virtual_ms += res.virtual_ms
            if res.ok:
                continue
            failure: Dict[str, Any] = {
                "workload": workload,
                "seed": seed,
                "violations": res.violations,
                "schedule": dumps(res.schedule),
            }
            if shrink_failures:
                minimized, replays = shrink(res.schedule, ctr=ctr)
                failure["minimized"] = dumps(minimized)
                failure["minimized_ops"] = len(minimized.ops)
                failure["shrink_replays"] = replays
            failures.append(failure)
    wall_s = time.perf_counter() - t0
    return {
        "schedules": ran,
        "failures": failures,
        "steps": steps,
        "virtual_ms": virtual_ms,
        "wall_s": wall_s,
        "per_min": (ran / wall_s * 60.0) if wall_s > 0 else float("inf"),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="sweep seeded simulation schedules; shrink failures"
    )
    p.add_argument("--workloads", default=",".join(WORKLOADS),
                   help="comma-separated subset of: " + ",".join(WORKLOADS))
    p.add_argument("--seeds", type=int, default=10,
                   help="schedules per workload")
    p.add_argument("--start", type=int, default=0, help="first seed")
    p.add_argument("--ops", type=int, default=60, help="client ops per schedule")
    p.add_argument("--no-nemesis", action="store_true",
                   help="network faults only, no planner storms")
    p.add_argument("--no-shrink", action="store_true",
                   help="report failures without minimizing them")
    args = p.parse_args(argv)

    workloads = [w.strip() for w in args.workloads.split(",") if w.strip()]
    for w in workloads:
        if w not in WORKLOADS:
            p.error(f"unknown workload {w!r}")
    seeds = range(args.start, args.start + args.seeds)

    summary = explore(
        workloads, list(seeds), n_ops=args.ops,
        nemesis=not args.no_nemesis,
        shrink_failures=not args.no_shrink,
    )
    print(
        f"sim sweep: {summary['schedules']} schedules, "
        f"{len(summary['failures'])} failed, "
        f"{summary['steps']} steps, "
        f"{summary['virtual_ms'] / 1000.0:.1f}s virtual in "
        f"{summary['wall_s']:.1f}s wall "
        f"({summary['per_min']:.0f} schedules/min)"
    )
    for f in summary["failures"]:
        print(f"\nFAIL workload={f['workload']} seed={f['seed']}")
        for v in f["violations"]:
            print(f"  violation: {v}")
        if "minimized" in f:
            print(f"  minimized to {f['minimized_ops']} ops "
                  f"({f['shrink_replays']} replays):")
            for line in f["minimized"].splitlines():
                print(f"    {line}")
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
