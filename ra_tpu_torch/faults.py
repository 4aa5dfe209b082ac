"""Failpoint-driven disk/infra fault injection.

A process-global registry of **named injection sites** threaded through
the storage and infra stack (WAL batch write/fsync/recovery, segment
flush, compaction copy/rename, snapshot spool/promote, meta append, TCP
send/frame, writer-thread loops). Tests and the nemesis harness *arm* a
site with a deterministic trigger and an action; production code pays a
single dict miss per site check when nothing is armed — no lock, no
allocation (the BlackWater-style discipline: storage faults must be as
scriptable as partitions, arxiv 2203.07920).

Grammar (tuples, so nemesis scripts can carry them verbatim):

triggers
    ("one_shot",)        fire on the 1st hit, then disarm
    ("one_shot", n)      fire on the nth hit (1-based), then disarm
    ("every", n)         fire on every nth hit
    ("prob", p)          fire each hit with probability p (armed seed)
    ("always",)          fire on every hit

actions
    ("raise", name)      raise OSError(errno.<NAME>) — "enospc", "eio",
                         "eagain", "emfile" (or any errno name)
    ("torn", frac)       at a data site: write only the first
                         ``int(len(data) * frac)`` bytes, then raise
                         EIO — a torn/short write with the prefix on
                         disk (recovery must truncate or reject it)
    ("latency", secs)    sleep, then continue normally
    ("crash",)           raise ThreadCrash (a BaseException): kills the
                         hosting thread the way a real thread death
                         does, so supervision paths are exercised

Sites may be **scoped**: arming with ``scope="nodeA"`` only fires for
call sites that pass the same scope (multi-node tests target one node's
storage). An unscoped armed failpoint fires for every scope.

Site inventory (kept in docs/INTERNALS.md "Fault injection"):
    wal.write  wal.fsync  wal.open  wal.recover_read  wal.thread
    segment_writer.flush  segment_writer.thread  segment.append
    segments.compact_copy  segments.compact_rename
    snapshot.write  snapshot.chunk  snapshot.promote
    meta.append  tcp.send  tcp.frame
"""

from __future__ import annotations

import errno as _errno
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class ThreadCrash(BaseException):
    """Injected thread death. Deliberately a BaseException: the WAL and
    segment-writer loops catch ``Exception`` (failure episodes) but let
    this propagate and kill the thread, so the node's infra supervisor
    restart path is what recovers — same shape as a real VM thread
    death."""


class _Failpoint:
    __slots__ = ("site", "action", "trigger", "scope", "rng", "lock",
                 "hit_count", "fire_count")

    def __init__(self, site: str, action: Tuple, trigger: Tuple,
                 seed: int, scope: Optional[str]):
        self.site = site
        self.action = tuple(action)
        self.trigger = tuple(trigger)
        self.scope = scope
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        self.hit_count = 0
        self.fire_count = 0

    def _should_fire(self) -> bool:
        """Called under self.lock; advances counters/rng deterministically."""
        self.hit_count += 1
        kind = self.trigger[0]
        if kind == "one_shot":
            n = self.trigger[1] if len(self.trigger) > 1 else 1
            return self.hit_count == n
        if kind == "every":
            return self.hit_count % self.trigger[1] == 0
        if kind == "prob":
            return self.rng.random() < self.trigger[1]
        if kind == "always":
            return True
        raise ValueError(f"unknown trigger {self.trigger!r}")


_lock = threading.Lock()
_armed: Dict[str, _Failpoint] = {}

# arm-wakers: callbacks invoked after every arm() (docs/INTERNALS.md
# §16). Event-driven idle loops (the WAL writer's untimed wait) need a
# nudge when a failpoint is armed against an IDLE thread — a parked
# loop re-checks its armed sites on wake, so a crash_thread nemesis
# still bites within one wakeup even with zero traffic. Callbacks must
# be cheap and never raise; registration is idempotent per callback.
_arm_wakers: List = []


def on_arm(cb) -> None:
    """Register ``cb()`` to run after every ``arm()``."""
    with _lock:
        if cb not in _arm_wakers:
            _arm_wakers.append(cb)


def off_arm(cb) -> None:
    with _lock:
        try:
            _arm_wakers.remove(cb)
        except ValueError:
            pass

# built-in sites whose call sites DO NOT pass a scope label: arming
# them with a scope would be a silent no-op (the _take scope filter
# would reject every hit), so arm() refuses. tcp.* sites ARE scoped,
# by the transport's node_name — a "host:port" string, not a RaNode
# name. Unknown/custom sites accept any scope.
UNSCOPED_SITES = frozenset({
    "segment.append", "segments.compact_copy", "segments.compact_rename",
    "snapshot.write", "snapshot.chunk", "snapshot.promote",
})


def arm(site: str, action: Tuple, trigger: Tuple = ("one_shot",),
        seed: int = 0, scope: Optional[str] = None) -> None:
    """Arm ``site``. Re-arming replaces the previous failpoint."""
    fp = _Failpoint(site, action, trigger, seed, scope)
    if fp.action[0] not in ("raise", "torn", "latency", "crash"):
        raise ValueError(f"unknown action {action!r}")
    if fp.trigger[0] not in ("one_shot", "every", "prob", "always"):
        raise ValueError(f"unknown trigger {trigger!r}")
    if scope is not None and site in UNSCOPED_SITES:
        raise ValueError(
            f"site {site!r} does not support scoping (its call sites "
            "pass no scope label — a scoped failpoint would never fire)"
        )
    if fp.action[0] == "crash" and not site.endswith(".thread"):
        # ThreadCrash is only recoverable where a supervisor watches the
        # hosting thread (the *.thread loop sites); anywhere else it
        # would silently wedge an arbitrary caller thread
        raise ValueError(
            f"('crash',) is only valid at *.thread sites, not {site!r}"
        )
    with _lock:
        _armed[site] = fp
        wakers = list(_arm_wakers)
    for cb in wakers:
        try:
            cb()
        except Exception:  # noqa: BLE001 — a waker must never block arming
            pass


def disarm(site: str) -> None:
    with _lock:
        _armed.pop(site, None)


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def armed_sites() -> Dict[str, Tuple[Tuple, Tuple]]:
    with _lock:
        return {s: (fp.action, fp.trigger) for s, fp in _armed.items()}


def any_armed(*sites: str) -> bool:
    """True when any of ``sites`` has a live failpoint. Lock-free (the
    production fast path: hot loops route around accelerated paths only
    while injection is actually armed)."""
    if not _armed:
        return False
    return any(s in _armed for s in sites)


def anything_armed() -> bool:
    """True when ANY failpoint is live, regardless of site. The generic
    native-path gate: paths whose fault surface is the whole item flow
    (drain-classify, mailbox pack) rather than a named site fall back to
    Python whenever injection is running at all. Note ``any_armed()``
    with no sites returns False by design — this is the distinct
    'is a nemesis active' question."""
    return bool(_armed)


def stats(site: str) -> Tuple[int, int]:
    """(hits, fires) for an armed site; (0, 0) when not armed."""
    fp = _armed.get(site)
    if fp is None:
        return (0, 0)
    with fp.lock:
        return (fp.hit_count, fp.fire_count)


def _errno_exc(name: str) -> OSError:
    code = getattr(_errno, name.upper(), _errno.EIO)
    return OSError(code, f"injected: {name} at failpoint")


def _take(fp: _Failpoint, scope: Optional[str]) -> Optional[Tuple]:
    """Trigger evaluation; returns the action to perform or None."""
    if fp.scope is not None and scope != fp.scope:
        return None
    with fp.lock:
        fired = fp._should_fire()
        if not fired:
            return None
        fp.fire_count += 1
        one_shot = fp.trigger[0] == "one_shot"
    if one_shot:
        with _lock:
            if _armed.get(fp.site) is fp:
                del _armed[fp.site]
    # a firing failpoint is a flight-recorder event: post-mortem traces
    # of nemesis runs must show WHEN each injected fault bit relative
    # to the role changes/depositions around it
    from ra_tpu_torch import obs as _obs

    _obs.record_event(
        "failpoint", node=scope,
        detail=f"{fp.site} -> {fp.action!r} (fire #{fp.fire_count})",
    )
    return fp.action


def fire(site: str, scope: Optional[str] = None) -> None:
    """The site check. Fast path (nothing armed): one dict miss."""
    fp = _armed.get(site)
    if fp is None:
        return
    act = _take(fp, scope)
    if act is None:
        return
    kind = act[0]
    if kind == "raise":
        raise _errno_exc(act[1])
    if kind == "latency":
        time.sleep(act[1])
        return
    if kind == "crash":
        raise ThreadCrash(f"injected thread crash at {site}")
    if kind == "torn":
        # a torn action at a no-data site degrades to a plain I/O error
        raise _errno_exc("eio")


def checked_write(site: str, f, data, scope: Optional[str] = None) -> None:
    """``f.write(data)`` with torn-write support: a torn action writes
    only a prefix of ``data`` (leaving it on disk) and then raises EIO,
    so recovery sees exactly what a power cut mid-write leaves behind.
    Fast path (nothing armed): one dict miss + the write."""
    fp = _armed.get(site)
    if fp is None:
        f.write(data)
        return
    act = _take(fp, scope)
    if act is None:
        f.write(data)
        return
    kind = act[0]
    if kind == "torn":
        cut = int(len(data) * act[1])
        if cut > 0:
            f.write(data[:cut])
            try:
                f.flush()
            except (OSError, ValueError):
                pass
        raise _errno_exc("eio")
    if kind == "latency":
        time.sleep(act[1])
        f.write(data)
        return
    if kind == "raise":
        raise _errno_exc(act[1])
    if kind == "crash":
        raise ThreadCrash(f"injected thread crash at {site}")


def mangle(site: str, data: bytes, scope: Optional[str] = None) -> bytes:
    """Corrupt in-flight bytes (wire frames): a torn action truncates,
    a raise action flips the first byte (the receiver's MAC/CRC must
    reject either). Latency sleeps; crash raises."""
    fp = _armed.get(site)
    if fp is None:
        return data
    act = _take(fp, scope)
    if act is None:
        return data
    kind = act[0]
    if kind == "torn":
        return data[: int(len(data) * act[1])]
    if kind == "raise":
        if not data:
            return data
        return bytes([data[0] ^ 0xFF]) + data[1:]
    if kind == "latency":
        time.sleep(act[1])
        return data
    raise ThreadCrash(f"injected thread crash at {site}")
