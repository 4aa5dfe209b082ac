"""Composable nemesis plane: fault dimensions as first-class objects.

ROADMAP item 5 ("scenario diversity as a product surface"): every fault
dimension the harnesses know — symmetric and one-way partitions, disk
failpoints, node/coordinator crash-restarts, membership churn, overload
bursts, active-set mode flips — is a ``Dimension`` object, and a seeded
``Planner`` interleaves them so they can run ALL AT ONCE (the regime
BlackWater-style fleets of cheap unreliable nodes actually see, and the
coverage the LNT model-checking work shows single-fault tests miss).

Contracts:

- **Replayable**: the planner draws from its OWN ``random.Random`` (in
  combined mode), so the nemesis schedule is a pure function of the
  seed; every action is appended to ``planner.schedule`` and the whole
  schedule is dumped in the repro bundle when a run fails.
- **Heal on every exit path**: the planner is a context manager whose
  ``__exit__`` unblocks every transport, restores flipped modes, and
  ``faults.disarm_all()`` — including exception/assertion teardown, so
  a failed soak cannot leak armed failpoints or blocked transports into
  the next test in the process (``nemesis_heals_forced`` counts when
  that safety net actually had faults to clean).
- **Observable**: every inject/heal lands in the ``FlightRecorder`` as
  a ``"nemesis"`` event (post-mortems interleave faults with elections)
  and bumps the per-dimension ``NEMESIS_FIELDS`` counters, so a soak
  can prove each enabled dimension actually fired.

The kv/fifo harness (``ra_tpu_torch.kv_harness``) builds a ``NemesisContext``
of backend closures (how to block, restart, churn on THAT backend) and
either fires single dimensions from its legacy dice (flag-compatible
``planner.fire``) or lets ``planner.step`` drive everything at once.
"""

from __future__ import annotations

import dataclasses
import random
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

from ra_tpu_torch import counters as ra_counters
from ra_tpu_torch import faults, obs
from ra_tpu_torch.counters import NEMESIS_FIELDS

# seeded disk-fault menu: every entry self-heals (one-shots disarm on
# fire; node supervision / the harness infra check recovers the rest).
# Entries are (site, action, trigger, weight): weights skew the draw
# per site so space-class faults (ENOSPC/EDQUOT — the storage-pressure
# survival plane, docs/INTERNALS.md §21) fire often enough per soak to
# exercise degraded-mode entry/exit without drowning out the integrity
# class (EIO / torn / thread-crash) the restart paths need.
DISK_FAULT_MENU: List[Tuple[str, Tuple, Tuple, int]] = [
    ("wal.fsync", ("raise", "eio"), ("one_shot",), 2),
    ("wal.write", ("torn", 0.5), ("one_shot",), 2),
    ("wal.write", ("raise", "enospc"), ("one_shot",), 3),
    ("wal.write", ("raise", "edquot"), ("one_shot",), 1),
    ("wal.fsync", ("raise", "enospc"), ("one_shot",), 1),
    ("wal.thread", ("crash",), ("one_shot",), 2),
    ("segment_writer.thread", ("crash",), ("one_shot",), 2),
    ("segment_writer.flush", ("raise", "eio"), ("one_shot",), 2),
    ("meta.append", ("raise", "eio"), ("one_shot",), 2),
    ("wal.fsync", ("latency", 0.02), ("one_shot", 2), 2),
]
_DISK_MENU_WEIGHTS = [w for _, _, _, w in DISK_FAULT_MENU]


def pick_disk_fault(rng: random.Random) -> Tuple[str, Tuple, Tuple]:
    """One weighted menu draw (single rng consumption: random())."""
    site, action, trigger, _w = rng.choices(
        DISK_FAULT_MENU, weights=_DISK_MENU_WEIGHTS, k=1
    )[0]
    return site, action, trigger


@dataclasses.dataclass
class NemesisContext:
    """Backend adapter: how to execute each fault on one backend.

    ``peers``/``members`` return node names; ``block`` is DIRECTIONAL
    (only ``frm``'s sends to ``to`` drop) — the transports are already
    directional (``InProcTransport``/``TcpTransport`` ``blocked`` sets),
    which is what makes one-way partitions a first-class dimension.
    Optional callbacks gate their dimensions: a backend that cannot
    flip step modes simply leaves ``set_mode`` as ``None``.
    """

    peers: Callable[[], List[str]]            # every transport peer
    members: Callable[[], List[str]]          # current member node names
    block: Callable[[str, str], None]         # drop frm -> to sends
    unblock_all: Callable[[], None]
    restart: Optional[Callable[[str], None]] = None
    membership_step: Optional[Callable[[], Optional[str]]] = None
    fault_scopes: Optional[Callable[[], List[str]]] = None
    overload_burst: Optional[Callable[[], int]] = None
    set_mode: Optional[Callable[[str], None]] = None
    get_mode: Optional[Callable[[], str]] = None


class Dimension:
    """One composable fault axis. ``inject`` draws ONLY from the rng it
    is handed (the caller decides whether that is the workload stream —
    legacy flag parity — or the planner's own stream) and returns
    ``(verb, detail)`` with verb in {"inject", "heal", "skip"}.
    ``heal`` must be idempotent: the planner calls it on every exit
    path, including after an explicit mid-run heal."""

    name = "?"

    def __init__(self) -> None:
        self.planner: Optional["Planner"] = None

    def inject(self, ctx: NemesisContext, rng: random.Random):
        raise NotImplementedError

    def heal(self, ctx: NemesisContext) -> Optional[str]:
        return None

    def active(self) -> bool:
        return False


class PartitionDimension(Dimension):
    """Symmetric isolation of one member (both directions blocked to
    every peer) — the classic kv_harness partition, dice-compatible."""

    name = "partition"

    def inject(self, ctx, rng):
        p = self.planner
        if p.sym_victim is None and rng.random() < 0.7:
            victim = rng.choice(ctx.members())
            for n in ctx.peers():
                if n != victim:
                    ctx.block(victim, n)
                    ctx.block(n, victim)
            p.sym_victim = victim
            return "inject", f"isolate {victim}"
        return "heal", None

    def heal(self, ctx):
        p = self.planner
        if p.sym_victim is not None:
            detail = f"rejoin {p.sym_victim}"
            p.sym_victim = None
            return detail
        return None

    def active(self):
        return self.planner.sym_victim is not None


class OneWayPartitionDimension(Dimension):
    """Asymmetric partition: ``a`` can no longer reach ``b`` while every
    other direction (including ``b -> a``) stays up. Blocking each
    follower's path BACK to the leader yields the classic stale-leader
    shape: AppendEntries still flow out, acks never return — the
    check-quorum step-down (server.py) is what keeps clients unwedged."""

    name = "oneway"

    def inject(self, ctx, rng):
        p = self.planner
        mem = ctx.members()
        if p.oneway_pair is None and len(mem) >= 2:
            a, b = rng.sample(mem, 2)
            ctx.block(a, b)
            p.oneway_pair = (a, b)
            return "inject", f"{a} -/-> {b}"
        return "heal", None

    def heal(self, ctx):
        p = self.planner
        if p.oneway_pair is not None:
            a, b = p.oneway_pair
            detail = f"restore {a} -> {b}"
            p.oneway_pair = None
            return detail
        return None

    def active(self):
        return self.planner.oneway_pair is not None


class DiskFaultDimension(Dimension):
    """Arm one seeded failpoint from the menu against a random node's
    storage stack; supervision (or the batch infra sweep) heals the
    damage, ``disarm_all`` clears anything still armed-but-unfired."""

    name = "disk"

    def __init__(self) -> None:
        super().__init__()
        self.armed = 0

    def inject(self, ctx, rng):
        site, action, trigger = pick_disk_fault(rng)
        faults.arm(site, action, trigger,
                   seed=rng.randrange(1 << 30),
                   scope=rng.choice(ctx.fault_scopes()))
        self.armed += 1
        return "inject", f"{site}:{action[0]}"

    def heal(self, ctx):
        if self.armed:
            self.armed = 0
            faults.disarm_all()
            return "disarm_all"
        return None

    def active(self):
        return self.armed > 0


class DiskFullDimension(Dimension):
    """ENOSPC storm: a PERSISTENT space-class failure against one
    node's WAL (``("always",)`` trigger — every write, and every reopen
    probe, keeps failing until heal). This is the storage-pressure
    survival drill (docs/INTERNALS.md §21): the victim must flip to
    ``storage_degraded`` (typed RA_NOSPACE rejects, elections/reads
    still served), NOT restart-from-disk, and its probe loop must
    auto-resume when the heal clears the storm. EDQUOT is drawn
    occasionally: same class, different errno."""

    name = "disk_full"

    def __init__(self) -> None:
        super().__init__()
        self.storming = False

    def inject(self, ctx, rng):
        if self.storming:
            return "heal", None
        scope = rng.choice(ctx.fault_scopes())
        which = "edquot" if rng.random() < 0.25 else "enospc"
        faults.arm("wal.write", ("raise", which), ("always",),
                   seed=rng.randrange(1 << 30), scope=scope)
        self.storming = True
        return "inject", f"{which} storm @ {scope or 'all'}"

    def heal(self, ctx):
        if self.storming:
            self.storming = False
            faults.disarm("wal.write")
            return "storm cleared"
        return None

    def active(self):
        return self.storming


class SlowDiskDimension(Dimension):
    """Slow-disk brownout: persistent fsync latency against one node's
    WAL. The victim's li-smoothed fsync gauge must cross the brownout
    threshold, shed its leaderships via transfer_leadership, and
    un-mark once the latency clears (docs/INTERNALS.md §21)."""

    name = "slow_disk"

    # brownout detection needs a streak of slow ticks: a storm that
    # heals on the very next roll lasts tens of milliseconds at harness
    # op rates — below any sane detector window. Hold the storm for at
    # least this many subsequent fires before a roll may heal it
    # (deterministic: hold state is a pure function of the fire
    # sequence, so schedules stay seed-replayable).
    MIN_HOLD_FIRES = 8

    def __init__(self) -> None:
        super().__init__()
        self.slowed = False
        self._held = 0

    def inject(self, ctx, rng):
        if self.slowed:
            self._held += 1
            if self._held < self.MIN_HOLD_FIRES:
                return "skip", None
            return "heal", None
        scope = rng.choice(ctx.fault_scopes())
        delay = rng.choice((0.02, 0.05))
        faults.arm("wal.fsync", ("latency", delay), ("always",),
                   seed=rng.randrange(1 << 30), scope=scope)
        self.slowed = True
        self._held = 0
        return "inject", f"fsync +{delay * 1000:.0f}ms @ {scope or 'all'}"

    def heal(self, ctx):
        if self.slowed:
            self.slowed = False
            faults.disarm("wal.fsync")
            return "latency cleared"
        return None

    def active(self):
        return self.slowed


class CrashRestartDimension(Dimension):
    """Node/coordinator crash-restart. The restart callback is expected
    to recover synchronously from durable state (server restart on the
    actor backend, coordinator rebuild from WAL/meta/segments on the
    batch backend), so inject counts as both injected and healed. A
    symmetrically-partitioned victim is skipped: restarting it would
    half-dissolve the partition on backends whose transport state dies
    with the process."""

    name = "crash"

    def inject(self, ctx, rng):
        victim = rng.choice(ctx.members())
        if victim != self.planner.sym_victim:
            ctx.restart(victim)
            return "inject", f"crash-restart {victim}"
        return "skip", None


class MembershipDimension(Dimension):
    """One churn step (remove the spare if joined, else join it). Only
    on a fully-connected cluster: removing an alive member while
    another is partitioned away can drop below quorum and wedge until
    the next heal."""

    name = "membership"

    def inject(self, ctx, rng):
        p = self.planner
        if p.sym_victim is None and p.oneway_pair is None:
            what = ctx.membership_step()
            return "inject", what or "churn"
        return "skip", None


class OverloadDimension(Dimension):
    """A bounded ack-free burst straight past the admission window
    (cluster + current leader, so the flood cannot miss the one node
    whose window matters). Bursts are self-draining; the heal hook
    marks the flood over for the counter pair."""

    name = "overload"

    def __init__(self) -> None:
        super().__init__()
        self.bursting = False

    def inject(self, ctx, rng):
        n = ctx.overload_burst()
        self.bursting = True
        return "inject", f"burst {n} ack-free cmds"

    def heal(self, ctx):
        if self.bursting:
            self.bursting = False
            return "flood drained"
        return None

    def active(self):
        return self.bursting


class ModeFlipDimension(Dimension):
    """Live active-set step-mode flip (batch backend: the coordinator
    reads ``active_set`` per step, so auto/always/never can change
    under load); heal restores the pre-fault mode."""

    name = "modeflip"

    def __init__(self) -> None:
        super().__init__()
        self.orig: Optional[str] = None

    def inject(self, ctx, rng):
        mode = rng.choice(("auto", "always", "never"))
        if self.orig is None:
            self.orig = ctx.get_mode()
        ctx.set_mode(mode)
        return "inject", f"active_set={mode}"

    def heal(self, ctx):
        if self.orig is not None:
            ctx.set_mode(self.orig)
            detail = f"active_set={self.orig}"
            self.orig = None
            return detail
        return None

    def active(self):
        return self.orig is not None


# network dimensions heal together (one unblock_all clears every block)
_NET_DIMS = ("partition", "oneway")
# dimensions cleared by the periodic transient heal (the legacy
# ``kv_harness.heal()`` scope: network blocks + armed failpoints).
# disk_full/slow_disk ride it too: their storms are persistent
# ("always" triggers), so the periodic heal is what bounds each
# degraded/brownout episode's length.
_TRANSIENT_DIMS = _NET_DIMS + ("disk", "disk_full", "slow_disk")


class Planner:
    """Seeded fault scheduler over a set of dimensions.

    Two driving modes, usable together:

    - ``fire(name, rng)`` — the legacy path: the HARNESS dice decide
      when a dimension fires and pass their own rng, so existing
      flag-gated runs keep their exact seed-deterministic op sequence;
    - ``step(op_i)`` — the combined path: the planner's own rng decides
      per op whether to fire and which dimension, so the schedule
      replays from the nemesis seed alone regardless of workload
      timing.

    Use as a context manager: ``__exit__`` ALWAYS heals everything and
    disarms every failpoint, whatever path left the block.
    """

    def __init__(self, ctx: NemesisContext, seed: int, label: str,
                 dimensions: List[Dimension],
                 fault_rate: float = 0.22) -> None:
        self.ctx = ctx
        self.seed = seed
        self.label = label
        # planner stream is decorrelated from the workload stream (which
        # uses Random(seed) directly)
        self.rng = random.Random((seed << 16) ^ 0x4E454D)  # "NEM"
        self.dims: Dict[str, Dimension] = {}
        for d in dimensions:
            d.planner = self
            self.dims[d.name] = d
        self._order = [d.name for d in dimensions]
        self.fault_rate = fault_rate
        self.schedule: List[Tuple[Any, str, str, Any]] = []
        self.sym_victim: Optional[str] = None
        self.oneway_pair: Optional[Tuple[str, str]] = None
        self.ctr = ra_counters.registry().new(("nemesis", label),
                                              NEMESIS_FIELDS)

    # -- driving -------------------------------------------------------

    def fire(self, name: str, rng: random.Random, op_i: Any = None) -> None:
        """Fire one dimension now, drawing from the CALLER's rng (legacy
        dice parity). A "heal" verdict from the dimension triggers the
        transient heal — the legacy dice healed everything transient on
        a failed partition roll."""
        dim = self.dims[name]
        out = dim.inject(self.ctx, rng)
        verb, detail = out if out is not None else ("skip", None)
        if verb == "inject":
            self._record(op_i, name, "inject", detail)
            self.ctr.incr(f"nemesis_{name}_injected")
            if name == "crash":
                # restart callbacks recover synchronously
                self.ctr.incr("nemesis_crash_healed")
            if name == "membership" and detail == "add":
                self.ctr.incr("nemesis_membership_healed")
        elif verb == "heal":
            self.heal_transient(op_i)

    def step(self, op_i: Any) -> None:
        """Combined mode: one planner-rng draw decides whether any fault
        fires this op, a second picks the dimension uniformly."""
        r = self.rng
        if r.random() >= self.fault_rate:
            return
        self.fire(r.choice(self._order), r, op_i)

    # -- healing -------------------------------------------------------

    @property
    def net_active(self) -> bool:
        return self.sym_victim is not None or self.oneway_pair is not None

    def heal_transient(self, op_i: Any = None) -> None:
        """The legacy ``heal()`` scope: drop every transport block and
        disarm failpoints (when the disk dimension is in play). Safe and
        cheap to call even when nothing is active."""
        for name in _TRANSIENT_DIMS:
            dim = self.dims.get(name)
            if dim is None:
                continue
            detail = dim.heal(self.ctx)
            if detail is not None:
                self._record(op_i, name, "heal", detail)
                self.ctr.incr(f"nemesis_{name}_healed")
        self.ctx.unblock_all()

    def heal_all(self, op_i: Any = None) -> None:
        """Heal every dimension (transients + mode flips + overload)."""
        self.heal_transient(op_i)
        for name, dim in self.dims.items():
            if name in _TRANSIENT_DIMS:
                continue
            detail = dim.heal(self.ctx)
            if detail is not None:
                self._record(op_i, name, "heal", detail)
                self.ctr.incr(f"nemesis_{name}_healed")

    # -- teardown guarantee -------------------------------------------

    def __enter__(self) -> "Planner":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        # the guarantee: EVERY exit path — normal return, consistency
        # failure, infra-check abort, arbitrary exception — leaves the
        # process with no blocks and no armed failpoints
        leaked = any(d.active() for d in self.dims.values())
        if leaked:
            self.ctr.incr("nemesis_heals_forced")
        try:
            self.heal_all("teardown")
        finally:
            faults.disarm_all()
        return False  # never swallow the original exception

    # -- replay / post-mortem -----------------------------------------

    def _record(self, op_i: Any, name: str, verb: str, detail: Any) -> None:
        self.schedule.append((op_i, name, verb, detail))
        obs.record_event("nemesis", node=self.sym_victim,
                         detail=f"{name} {verb}: {detail}"
                                f"{'' if op_i is None else f' (op {op_i})'}")

    def counters(self) -> Dict[str, int]:
        return self.ctr.to_dict()

    def dump_schedule(self, file=None, header: str = "") -> None:
        """The repro half of the bundle: replaying the run is
        ``run(seed=..., ...)`` with the same flags — this dump is the
        evidence of what that seed DID, aligned on workload op index so
        it can be read against the flight recorder."""
        f = file or sys.stderr
        print(f"-- nemesis schedule ({len(self.schedule)} actions, "
              f"seed={self.seed}){header} --", file=f)
        for op_i, name, verb, detail in self.schedule:
            print(f"   op={op_i!r:>10} {name:<10} {verb:<6} {detail}",
                  file=f)


def standard_dimensions(
    *,
    partitions: bool = True,
    oneway: bool = False,
    disk_faults: bool = False,
    disk_full: bool = False,
    slow_disk: bool = False,
    restarts: bool = False,
    membership: bool = False,
    overload: bool = False,
    mode_flips: bool = False,
) -> List[Dimension]:
    """The harness dimension set, flag-gated (a context lacking a
    callback must not enable the dimension that needs it)."""
    dims: List[Dimension] = []
    if partitions:
        dims.append(PartitionDimension())
    if oneway:
        dims.append(OneWayPartitionDimension())
    if disk_faults:
        dims.append(DiskFaultDimension())
    if disk_full:
        dims.append(DiskFullDimension())
    if slow_disk:
        dims.append(SlowDiskDimension())
    if restarts:
        dims.append(CrashRestartDimension())
    if membership:
        dims.append(MembershipDimension())
    if overload:
        dims.append(OverloadDimension())
    if mode_flips:
        dims.append(ModeFlipDimension())
    return dims
