"""Cluster health plane: vectorized per-group lag/churn introspection.

The per-group diagnosis layer the placement/rebalancing work (ROADMAP
item 1) consumes: *which* of the thousands of groups on a node are
stuck, lagging, or flapping — computed off the mirrors the node already
holds (the coordinator's device arrays + ``_applied_np``; the actor
backend's per-server scalars), with **no per-group Python loop** on the
batch backend and **one fetch per tick** (the ``scans == fetches``
counter invariant in ``HEALTH_FIELDS`` proves it). The reference's
``ra:overview/1`` + per-server metrics ETS is the capability anchor:
per-group introspection cheap enough to leave on in production;
BlackWater Raft (arxiv 2203.07920) rebalances on exactly this feed.

Per-group gauges, all numpy-vectorized per scan:

- ``commit_gap``   — commit_index - last_applied (commit→apply lag);
- ``match_gap``    — leader's last_index minus the slowest active
  peer's confirmed match (follower replication lag, leaders only);
- ``backlog``      — last_index - last_applied (the appended-but-
  unapplied admission backlog the flow-control window bounds);
- ``commit_rate``  — li-smoothed per-group applied/sec
  (:class:`ra_tpu_torch.li.VectorLeakyIntegrator`);
- ``churn``        — EWMA of the per-scan term-bump indicator in
  [0, 1] (0.3 after one election, →1 under sustained churn) plus a
  raw ``churn_rate`` in bumps/sec;
- ``leader_age_s`` — leader stickiness: seconds since the group's
  leader identity last changed.

On top, a per-group anomaly state machine with hysteresis::

    quiet ──────────────► stuck     backlog/commit_gap pending AND
      ▲   (stuck_ticks       │      applied frozen for stuck_ticks
      │    consecutive       │      consecutive scans
      │    scans)            │
      ├─────────────► flapping      churn EWMA ≥ churn_enter
      │               (exit: churn ≤ churn_exit
      │                for clear_ticks scans)
      └─────────────► lagging       any gap ≥ lag_enter
                      (exit: all gaps ≤ lag_exit
                       for clear_ticks scans)

Severity order stuck > flapping > lagging: a group qualifying for
several states reports the worst. Entering/leaving a state emits a
``health_transition`` flight-recorder event, so anomaly onsets line up
with the election/deposition/WAL-failure trace on the same timeline.

``api.cluster_health()`` merges every registered scanner with the
leaderboard into one machine-readable feed; ``scripts/ra_top.py``
renders it as a periodic terminal top-K view, and the per-node
aggregate gauges (``HEALTH_FIELDS``) ride the normal Prometheus
exposition.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ra_tpu_torch import counters as ra_counters
from ra_tpu_torch.li import VectorLeakyIntegrator

# anomaly states (int8 codes; severity == code, higher is worse)
QUIET = 0
LAGGING = 1
FLAPPING = 2
STUCK = 3
STATE_NAMES = {QUIET: "quiet", LAGGING: "lagging", FLAPPING: "flapping",
               STUCK: "stuck"}

# role codes shared with ra_tpu_torch.ops.consensus (0..3) plus the actor
# backend's non-device holds
ROLE_FOLLOWER = 0
ROLE_PRE_VOTE = 1
ROLE_CANDIDATE = 2
ROLE_LEADER = 3
ROLE_HELD = 4
ROLE_NAMES = {ROLE_FOLLOWER: "follower", ROLE_PRE_VOTE: "pre_vote",
              ROLE_CANDIDATE: "candidate", ROLE_LEADER: "leader",
              ROLE_HELD: "held"}

NO_LEADER_KEY = np.int64(-(1 << 40))  # distinct from any real identity


class HealthConfig:
    """Anomaly thresholds. Enter thresholds are strictly above exit
    thresholds (hysteresis): a group flickering around one boundary
    does not flicker between states."""

    __slots__ = ("stuck_ticks", "clear_ticks", "lag_enter", "lag_exit",
                 "churn_enter", "churn_exit", "alpha")

    def __init__(self, stuck_ticks: int = 3, clear_ticks: int = 2,
                 lag_enter: int = 64, lag_exit: int = 16,
                 churn_enter: float = 0.5, churn_exit: float = 0.1,
                 alpha: float = 0.3):
        if lag_exit >= lag_enter or churn_exit >= churn_enter:
            raise ValueError("hysteresis requires exit < enter thresholds")
        self.stuck_ticks = stuck_ticks
        self.clear_ticks = clear_ticks
        self.lag_enter = lag_enter
        self.lag_exit = lag_exit
        self.churn_enter = churn_enter
        self.churn_exit = churn_exit
        self.alpha = alpha


class HealthScanner:
    """Per-node scanner: persistent per-group EWMA/hysteresis state in
    flat numpy arrays addressed by slot, updated by one vectorized
    ``scan`` per tick. Slots are allocated per group name (``ensure``)
    and recycled on ``release`` — the batch coordinator allocates once
    at add_groups (slot == gid order), the actor node re-ensures its
    live procs each sweep.

    Thread model: ``scan`` runs only on the owner's detector/tick
    thread (single writer). ``rows``/``summary`` read best-effort
    snapshots from any thread, same contract as counters."""

    def __init__(self, node_name: str, backend: str = "",
                 capacity: int = 64,
                 config: Optional[HealthConfig] = None):
        self.node = node_name
        self.backend = backend
        self.cfg = config or HealthConfig()
        self.counters = ra_counters.new(
            ("health", node_name), ra_counters.HEALTH_FIELDS
        )
        self._lock = threading.Lock()  # slot table only; scan is 1-writer
        self._slot_of: Dict[str, int] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._names: List[Optional[str]] = [None] * capacity
        self._clusters: List[Optional[str]] = [None] * capacity
        # node-scope disk-pressure anomaly (0=clear 1=soft 2=hard); the
        # hysteresis lives in pressure.DiskWatermark — this is the
        # published, transition-evented mirror (docs/INTERNALS.md §21)
        self.disk_pressure = 0
        self._alloc(capacity)

    def _alloc(self, capacity: int) -> None:
        z_i = lambda: np.zeros(capacity, np.int64)  # noqa: E731
        z_f = lambda: np.zeros(capacity, np.float64)  # noqa: E731
        self.capacity = capacity
        self.seen = np.zeros(capacity, bool)
        self.state = np.zeros(capacity, np.int8)
        self.prev_term = z_i()
        self.prev_applied = z_i()
        self.leader_key = np.full(capacity, NO_LEADER_KEY, np.int64)
        self.leader_since = z_f()
        self.churn = z_f()  # term-bump-indicator EWMA in [0, 1]
        self.churn_rate = z_f()  # raw bumps/sec EWMA (display gauge)
        self.stuck_streak = z_i()
        self.clear_streak = z_i()
        self.li = VectorLeakyIntegrator(capacity, alpha=self.cfg.alpha)
        # last-scan snapshot (what rows() renders)
        self.role = np.zeros(capacity, np.int8)
        self.term = z_i()
        self.applied = z_i()
        self.commit_gap = z_i()
        self.match_gap = z_i()
        self.backlog = z_i()
        self.last_scan_t = 0.0

    def _grow(self, need: int) -> None:
        cap = self.capacity
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        old = self.__dict__.copy()
        old_li = self.li
        self._alloc(new_cap)
        for k in ("seen", "state", "prev_term", "prev_applied",
                  "leader_key", "leader_since", "churn", "churn_rate",
                  "stuck_streak", "clear_streak", "role", "term",
                  "applied", "commit_gap", "match_gap", "backlog"):
            getattr(self, k)[:cap] = old[k]
        old_li.grow(new_cap)
        self.li = old_li
        self.last_scan_t = old["last_scan_t"]
        self._free.extend(range(new_cap - 1, cap - 1, -1))
        self._names.extend([None] * (new_cap - cap))
        self._clusters.extend([None] * (new_cap - cap))

    # -- slot table --------------------------------------------------------

    def _reset_slot(self, slot: int) -> None:
        """Zero EVERY per-slot statistic: a recycled slot must not leak
        the previous occupant's EWMAs/streaks into a new group (a fresh
        group inheriting a dead flapper's churn would classify flapping
        on its first scan)."""
        self.seen[slot] = False
        self.state[slot] = QUIET
        self.churn[slot] = 0.0
        self.churn_rate[slot] = 0.0
        self.stuck_streak[slot] = 0
        self.clear_streak[slot] = 0
        self.li.rate[slot] = 0.0
        self.leader_since[slot] = 0.0
        self.leader_key[slot] = NO_LEADER_KEY
        for arr in (self.prev_term, self.prev_applied, self.role,
                    self.term, self.applied, self.commit_gap,
                    self.match_gap, self.backlog):
            arr[slot] = 0

    def ensure(self, name: str, cluster: str) -> int:
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is not None:
                return slot
            if not self._free:
                self._grow(self.capacity + 1)
            slot = self._free.pop()
            self._slot_of[name] = slot
            self._names[slot] = name
            self._clusters[slot] = cluster
            self._reset_slot(slot)  # fresh state on (re)allocation
            return slot

    def release(self, name: str) -> None:
        with self._lock:
            slot = self._slot_of.pop(name, None)
            if slot is None:
                return
            self._names[slot] = None
            self._clusters[slot] = None
            self._reset_slot(slot)
            self._free.append(slot)

    # -- the scan ----------------------------------------------------------

    def scan(self, now: float, slots: np.ndarray, role: np.ndarray,
             term: np.ndarray, applied: np.ndarray, commit: np.ndarray,
             last_index: np.ndarray, match_gap: np.ndarray,
             leader_key: np.ndarray) -> None:
        """One vectorized health pass over the groups at ``slots``.
        All arrays are aligned with ``slots``; ``match_gap`` is the
        caller-computed follower replication gap (0 for non-leaders),
        ``leader_key`` any int identity that changes when the group's
        leader does (NO_LEADER_KEY when unknown). The caller fetched
        its mirrors in ONE operation and bumps the ``health_fetches`` counter
        itself."""
        cfg = self.cfg
        n = len(slots)
        if n == 0:
            return
        dt = now - self.last_scan_t if self.last_scan_t else 0.0
        self.last_scan_t = now

        term = term.astype(np.int64, copy=False)
        applied = applied.astype(np.int64, copy=False)
        commit = commit.astype(np.int64, copy=False)
        last_index = last_index.astype(np.int64, copy=False)
        leader_key = leader_key.astype(np.int64, copy=False)

        fresh = ~self.seen[slots]
        if fresh.any():
            fi = slots[fresh]
            self.prev_term[fi] = term[fresh]
            self.prev_applied[fi] = applied[fresh]
            self.leader_key[fi] = leader_key[fresh]
            self.leader_since[fi] = now
            self.seen[fi] = True

        commit_gap = np.maximum(commit - applied, 0)
        backlog = np.maximum(last_index - applied, 0)
        gap = np.maximum(np.maximum(commit_gap, backlog), match_gap)

        d_applied = np.maximum(applied - self.prev_applied[slots], 0)
        progress = d_applied > 0
        bumped = term > self.prev_term[slots]
        a = cfg.alpha
        churn = a * bumped + (1 - a) * self.churn[slots]
        if dt > 0:
            self.churn_rate[slots] = (
                a * (term - self.prev_term[slots]) / dt
                + (1 - a) * self.churn_rate[slots]
            )
            self.li.sample(slots, d_applied, dt)
        moved = leader_key != self.leader_key[slots]
        if moved.any():
            mi = slots[moved]
            self.leader_key[mi] = leader_key[moved]
            self.leader_since[mi] = now

        # -- anomaly state machine (vectorized, with hysteresis) ----------
        prev_state = self.state[slots]
        pending = (backlog > 0) | (commit_gap > 0)
        stuck_streak = np.where(
            pending & ~progress, self.stuck_streak[slots] + 1, 0
        )
        is_stuck = stuck_streak >= cfg.stuck_ticks
        enter_flap = churn >= cfg.churn_enter
        enter_lag = gap >= cfg.lag_enter
        # exit only after clear_ticks consecutive below-exit scans; a
        # group with in-flight work still counts as calm while it makes
        # progress (steady load always has a nonzero instantaneous
        # backlog — only a FROZEN backlog blocks clearing)
        calm = (
            (churn <= cfg.churn_exit) & (gap <= cfg.lag_exit)
            & (progress | ~pending)
        )
        clear_streak = np.where(calm, self.clear_streak[slots] + 1, 0)
        cleared = clear_streak >= cfg.clear_ticks

        target = np.zeros(n, np.int8)
        target[enter_lag] = LAGGING
        target[enter_flap] = FLAPPING
        target[is_stuck] = STUCK
        # hold the previous anomaly unless a WORSE one fires or the
        # group has been provably calm for clear_ticks scans
        hold = (prev_state > target) & ~cleared
        state = np.where(hold, prev_state, target).astype(np.int8)

        self.stuck_streak[slots] = stuck_streak
        self.clear_streak[slots] = clear_streak
        self.churn[slots] = churn
        self.prev_term[slots] = term
        self.prev_applied[slots] = applied
        self.state[slots] = state
        self.role[slots] = role.astype(np.int8, copy=False)
        self.term[slots] = term
        self.applied[slots] = applied
        self.commit_gap[slots] = commit_gap
        self.match_gap[slots] = match_gap.astype(np.int64, copy=False)
        self.backlog[slots] = backlog

        # transitions: Python cost only for groups that actually flipped
        changed = np.flatnonzero(state != prev_state)
        if len(changed):
            from ra_tpu_torch import obs as _obs

            self.counters.incr("health_transitions", len(changed))
            for k in changed.tolist():
                slot = int(slots[k])
                _obs.record_event(
                    "health_transition", node=self.node,
                    group=self._names[slot], term=int(term[k]),
                    detail=(
                        f"{STATE_NAMES[int(prev_state[k])]}->"
                        f"{STATE_NAMES[int(state[k])]} "
                        f"commit_gap={int(commit_gap[k])} "
                        f"backlog={int(backlog[k])} "
                        f"match_gap={int(match_gap[k])} "
                        f"churn={churn[k]:.2f}"
                    ),
                )

        c = self.counters
        c.incr("health_scans")
        c.put("health_stuck", int((state == STUCK).sum()))
        c.put("health_flapping", int((state == FLAPPING).sum()))
        c.put("health_lagging", int((state == LAGGING).sum()))
        c.put("health_quiet", int((state == QUIET).sum()))
        c.put("health_max_commit_gap", int(commit_gap.max(initial=0)))
        c.put("health_max_match_gap", int(match_gap.max(initial=0)))
        c.put("health_max_backlog", int(backlog.max(initial=0)))

    # -- node-scope anomalies ----------------------------------------------

    DISK_STATE_NAMES = {0: "clear", 1: "soft", 2: "hard"}

    def note_disk_pressure(self, state: int) -> None:
        """Publish the node's disk-pressure tri-state (computed with
        hysteresis by :class:`ra_tpu_torch.pressure.DiskWatermark`). Unlike
        the per-group states this is node-scope: one value, driven by
        the owner's detector thread alongside ``scan``. Transitions
        emit a ``health_transition`` flight-recorder event so pressure
        onsets line up with WAL failures / elections on one timeline."""
        state = int(state)
        prev = self.disk_pressure
        if state == prev:
            return
        self.disk_pressure = state
        self.counters.put("health_disk_pressure", state)
        self.counters.incr("health_disk_transitions")
        from ra_tpu_torch import obs as _obs

        _obs.record_event(
            "health_transition", node=self.node, group="",
            detail=(
                f"disk_pressure {self.DISK_STATE_NAMES.get(prev, prev)}->"
                f"{self.DISK_STATE_NAMES.get(state, state)}"
            ),
        )

    # -- reads -------------------------------------------------------------

    def rows(self) -> List[Dict[str, Any]]:
        """Per-group gauge rows from the latest scan (any thread)."""
        with self._lock:
            present = [(name, slot) for name, slot in self._slot_of.items()]
        now = time.monotonic()
        out = []
        for name, i in present:
            if not self.seen[i]:
                continue
            out.append({
                "group": name,
                "cluster": self._clusters[i],
                "node": self.node,
                "state": STATE_NAMES[int(self.state[i])],
                "severity": int(self.state[i]),  # == state code, higher worse
                "role": ROLE_NAMES.get(int(self.role[i]), "?"),
                "term": int(self.term[i]),
                "applied": int(self.applied[i]),
                "commit_gap": int(self.commit_gap[i]),
                "match_gap": int(self.match_gap[i]),
                "backlog": int(self.backlog[i]),
                "commit_rate": round(float(self.li.rate[i]), 2),
                "churn": round(float(self.churn[i]), 3),
                "churn_rate": round(float(self.churn_rate[i]), 3),
                "leader_age_s": round(
                    max(0.0, now - float(self.leader_since[i])), 2
                ),
            })
        return out

    def summary(self) -> Dict[str, Any]:
        c = self.counters
        return {
            "node": self.node,
            "backend": self.backend,
            "groups": len(self._slot_of),
            "scans": c.get("health_scans"),
            "fetches": c.get("health_fetches"),
            "transitions": c.get("health_transitions"),
            "states": {
                "stuck": c.get("health_stuck"),
                "flapping": c.get("health_flapping"),
                "lagging": c.get("health_lagging"),
                "quiet": c.get("health_quiet"),
            },
            "disk_pressure": self.DISK_STATE_NAMES.get(
                self.disk_pressure, self.disk_pressure
            ),
            "reads": self._read_totals(),
        }

    # read-path totals (docs/INTERNALS.md §20) summed over this node's
    # server/coordinator counter sets; cumulative, so consumers like
    # scripts/ra_top.py can difference successive snapshots into reads/s
    _READ_FIELDS = ("read_lease_served", "read_quorum_fallback",
                    "read_local_bounded", "read_stale_rejected")

    def _read_totals(self) -> Dict[str, int]:
        tot = dict.fromkeys(self._READ_FIELDS, 0)
        reg = ra_counters.registry()
        for key in reg.names():
            mine = key == ("coordinator", self.node) or (
                isinstance(key, tuple) and len(key) == 2
                and isinstance(key[1], tuple) and len(key[1]) == 2
                and key[1][1] == self.node
            )
            if not mine:
                continue
            cs = reg.fetch(key)
            if cs is None:
                continue
            for f in self._READ_FIELDS:
                try:
                    tot[f] += cs.get(f)
                except KeyError:
                    pass  # counter set without read fields
        return tot


# ---------------------------------------------------------------------------
# process-global scanner registry (api.cluster_health joins over it)

_lock = threading.Lock()
_scanners: Dict[str, HealthScanner] = {}


def register(node_name: str, backend: str = "", capacity: int = 64,
             config: Optional[HealthConfig] = None) -> HealthScanner:
    with _lock:
        sc = _scanners.get(node_name)
        if sc is None:
            sc = HealthScanner(node_name, backend=backend,
                               capacity=capacity, config=config)
            _scanners[node_name] = sc
        return sc


def unregister(node_name: str) -> None:
    with _lock:
        _scanners.pop(node_name, None)
    ra_counters.delete(("health", node_name))


def scanners() -> Dict[str, HealthScanner]:
    with _lock:
        return dict(_scanners)


def node_health(node_name: str) -> Optional[Dict[str, Any]]:
    with _lock:
        sc = _scanners.get(node_name)
    if sc is None:
        return None
    return {"summary": sc.summary(), "groups": sc.rows()}
