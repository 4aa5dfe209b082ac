"""Schedule: the complete, replayable input of one simulated run.

A ``Schedule`` plus the code under test fully determines execution —
the determinism invariant (docs/INTERNALS.md §19). Two kinds of input
live here:

- **parameters** (seed, fault probabilities, horizon): every internal
  random choice — election jitter, network drop/dup/delay decisions,
  nemesis planner draws — comes from streams derived from ``seed``;
- **ops**: the externally injected timeline — client commands, client
  process downs, nemesis steps — as explicit ``(t_ms, op)`` pairs.

``ops=None`` means "generate from the seed" (``resolve_ops``); the
shrinker materializes the generated list once and then delta-debugs the
explicit list, so a minimized repro is a plain data file with no
generator behind it. ``dumps``/``loads`` is a line-oriented text format
(one op per line) chosen so the determinism test can assert
byte-identical replay and a human can read a minimized repro directly.

Op vocabulary:
  ("cmd", payload)        -- client command to the current leader
  ("down", target)        -- monitored client process dies
  ("nem", op_i)           -- one nemesis planner step (planner rng decides)
  ("read", target)        -- consistent_query; target is a node index,
                             "leader" (current), or "old" (the leader
                             captured by the last isolate op)
  ("isolate", "leader")   -- block the current leader from everyone,
                             both directions, and remember it as "old"
  ("etimo", "other")      -- deterministic ElectionTimeout at the first
                             running voter that is not the old leader
  ("unblock",)            -- heal every directed block now
"""

from __future__ import annotations

import ast
import dataclasses
import sys
from typing import Any, List, Optional, Tuple

Op = Tuple[int, Tuple[Any, ...]]  # (t_ms, op)


def _canon(x: Any) -> Any:
    """Canonicalize op aliasing. State digests hash ``pickle`` bytes,
    and pickle memoizes: a payload string shared by identity between
    two state slots pickles as a back-reference, while two equal but
    distinct strings pickle twice. Generated ops alias module constants
    and interned literals; ``loads`` goes through ``ast.literal_eval``,
    which never builds a code object and so never interns — equal
    schedules, different bytes. Interning every string and rebuilding
    every container at the injection boundary makes both paths
    byte-identical under the digest."""
    if isinstance(x, str):
        return sys.intern(x)
    if isinstance(x, tuple):
        return tuple(_canon(v) for v in x)
    if isinstance(x, list):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {_canon(k): _canon(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return type(x)(_canon(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class Schedule:
    seed: int
    workload: str  # "kv" | "fifo" | "session"
    n_ops: int = 60
    horizon_ms: int = 8_000
    settle_ms: int = 4_000
    nodes: int = 3
    drop_p: float = 0.0
    dup_p: float = 0.0
    delay_p: float = 0.0
    delay_ms_max: int = 40
    nemesis: bool = False
    # clock-bound leader leases (docs/INTERNALS.md §20): lease=True
    # starts every server lease-enabled; skew_ppm bounds the per-node
    # clock RATE skew (parts per million, drawn from the seed) that the
    # lease drift epsilon is widened to cover
    lease: bool = False
    skew_ppm: int = 0
    # storage-pressure plane (docs/INTERNALS.md §21): a per-node disk
    # byte budget (0 = unlimited). Writes that would exceed it fail
    # space-class: the node parks them (degraded) until the horizon
    # heal frees space — acked writes must survive the episode
    disk_budget_bytes: int = 0
    ops: Optional[Tuple[Op, ...]] = None  # explicit timeline overrides n_ops

    def with_ops(self, ops: List[Op]) -> "Schedule":
        return dataclasses.replace(self, ops=tuple(ops))

    def resolve_ops(self) -> List[Op]:
        if self.ops is not None:
            return [_canon(op) for op in self.ops]
        from ra_tpu_torch.sim.workloads import generate_ops

        return [_canon(op) for op in generate_ops(self)]


def dumps(sched: Schedule) -> str:
    """Canonical one-op-per-line text; ops are materialized so the dump
    stands alone as a repro (no generator needed to re-run it)."""
    lines = [
        f"# ra_tpu_torch sim schedule v1",
        f"seed={sched.seed} workload={sched.workload} nodes={sched.nodes}",
        f"horizon_ms={sched.horizon_ms} settle_ms={sched.settle_ms}",
        f"drop_p={sched.drop_p} dup_p={sched.dup_p} delay_p={sched.delay_p}"
        f" delay_ms_max={sched.delay_ms_max} nemesis={sched.nemesis}",
        f"lease={sched.lease} skew_ppm={sched.skew_ppm}"
        f" disk_budget_bytes={sched.disk_budget_bytes}",
    ]
    for t_ms, op in sched.resolve_ops():
        lines.append(f"{t_ms} {op!r}")
    return "\n".join(lines) + "\n"


def loads(text: str) -> Schedule:
    head: dict = {}
    ops: List[Op] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" in line.split(" ", 1)[0]:
            for kv in line.split():
                k, v = kv.split("=", 1)
                head[k] = v
        else:
            t_s, op_s = line.split(" ", 1)
            ops.append((int(t_s), ast.literal_eval(op_s)))
    return Schedule(
        seed=int(head["seed"]),
        workload=head["workload"],
        nodes=int(head.get("nodes", 3)),
        horizon_ms=int(head.get("horizon_ms", 8_000)),
        settle_ms=int(head.get("settle_ms", 4_000)),
        drop_p=float(head.get("drop_p", 0.0)),
        dup_p=float(head.get("dup_p", 0.0)),
        delay_p=float(head.get("delay_p", 0.0)),
        delay_ms_max=int(head.get("delay_ms_max", 40)),
        nemesis=head.get("nemesis", "False") == "True",
        lease=head.get("lease", "False") == "True",
        skew_ppm=int(head.get("skew_ppm", 0)),
        disk_budget_bytes=int(head.get("disk_budget_bytes", 0)),
        ops=tuple(ops),
    )
