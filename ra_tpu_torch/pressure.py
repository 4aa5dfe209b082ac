"""Storage-pressure survival plane (docs/INTERNALS.md §21).

Four cooperating pieces, shared by both backends:

- **failure taxonomy** (``classify_storage_error``): every WAL /
  segment / snapshot / meta write failure is either *integrity* class
  (EIO, torn frame, short write — durable state may be corrupt, the
  only safe answer is the poison-and-restart-from-disk path that
  already exists) or *space* class (ENOSPC / EDQUOT — the write
  provably did NOT corrupt anything already durable: the kernel
  refused to extend the file, it did not scribble on it). Space-class
  flips the node into ``storage_degraded`` instead of restarting it.
- **StoragePressure**: the per-node degraded/hard-watermark state that
  admission consults. Client commands reject with the typed
  ``RA_NOSPACE`` reason through the existing reject-with-backoff path;
  raft control traffic (heartbeats, elections, lease reads) never
  touches it — control traffic must not require new disk.
- **DiskWatermark**: soft/hard byte thresholds with hysteresis over
  the per-system usage (WAL + segments + snapshots + accept spools).
  Soft triggers emergency reclamation *before* ENOSPC ever fires; hard
  pre-empts admission.
- **BrownoutDetector**: li-smoothed fsync-latency detection. A disk
  that still acks but takes hundreds of ms per fsync is browner than
  dead — the node sheds leadership (``transfer_leadership``) and takes
  it back only after the latency recovers.

The classification is deliberately a single shared function: the
native ``wal_write_batch`` surfaces errno as ``-(1000+errno)`` and
``ra_tpu_torch.native.write_batch`` re-raises it as a real ``OSError``, so
the native and Python framers funnel into the same classifier —
parity is structural, and parity-tested in tests/test_pressure.py.
"""

from __future__ import annotations

import errno
import os
import threading
from typing import List, Optional, Tuple

from ra_tpu_torch import counters as _counters
from ra_tpu_torch import obs
from ra_tpu_torch.li import LeakyIntegrator
from ra_tpu_torch.rings import WaitGate

# -- failure taxonomy ------------------------------------------------------

CLASS_SPACE = "space"
CLASS_INTEGRITY = "integrity"

# EDQUOT is "ENOSPC for your quota": same recovery story (reclaim and
# the write path comes back), same no-corruption guarantee.
SPACE_ERRNOS = frozenset(
    e for e in (errno.ENOSPC, getattr(errno, "EDQUOT", None)) if e is not None
)


def classify_storage_error(exc: BaseException) -> str:
    """-> "space" | "integrity".

    Space class is a *whitelist*: only errnos whose failure mode is
    "the write was refused, durable bytes are untouched" qualify.
    Everything else — EIO, unexpected ValueErrors from the framer,
    short writes surfaced as OSError without errno — stays integrity
    class and keeps the existing poison semantics, because guessing
    recoverable on a corrupting fault loses acked data.
    """
    if isinstance(exc, OSError) and exc.errno in SPACE_ERRNOS:
        return CLASS_SPACE
    return CLASS_INTEGRITY


# -- counters --------------------------------------------------------------

# Per-node storage-pressure vector (name ("disk", node_name)). Written
# by the node's detector/probe threads; the brownout gauges ride the
# same vector so one registration covers the whole survival plane.
DISK_FIELDS: List[_counters.FieldSpec] = [
    ("disk_used_bytes", "gauge", "accounted bytes (WAL+segments+snapshots)"),
    ("disk_soft_limit_bytes", "gauge", "soft watermark (0 = unlimited)"),
    ("disk_hard_limit_bytes", "gauge", "hard watermark (0 = unlimited)"),
    ("disk_pressure_state", "gauge",
     "watermark state: 0 ok, 1 soft (reclaiming), 2 hard (admission "
     "pre-empted)"),
    ("disk_soft_trips", "counter", "soft watermark crossings"),
    ("disk_hard_trips", "counter", "hard watermark crossings"),
    ("disk_reclaims", "counter", "emergency reclamation passes run"),
    ("disk_reclaimed_bytes", "counter",
     "bytes freed by emergency reclamation passes"),
    ("disk_degraded_entered", "counter",
     "space-class storage failures that flipped the node degraded"),
    ("disk_degraded_resumed", "counter",
     "degraded episodes ended by a successful probe write"),
    ("disk_probe_attempts", "counter",
     "probe writes attempted while degraded (bounded backoff)"),
    ("brownout_active", "gauge", "1 while the node is browned out"),
    ("brownout_entered", "counter", "brownout episodes entered"),
    ("brownout_exited", "counter", "brownout episodes exited (recovered)"),
    ("brownout_sheds", "counter",
     "leaderships shed via transfer_leadership while browned out"),
    ("brownout_fsync_us", "gauge",
     "smoothed mean WAL fsync latency (us) feeding the detector"),
]


# -- byte accounting -------------------------------------------------------


def dir_bytes(path: str) -> int:
    """Recursive on-disk byte accounting for one system directory.

    st_size, not st_blocks: the WAL/segment writers never punch holes,
    and st_size is what the deterministic tests can predict. Races with
    concurrent prune/rollover are fine — the watermark controller only
    needs a monotone-enough signal, not an audit."""
    total = 0
    stack = [path]
    while stack:
        d = stack.pop()
        try:
            with os.scandir(d) as it:
                for de in it:
                    try:
                        if de.is_dir(follow_symlinks=False):
                            stack.append(de.path)
                        elif de.is_file(follow_symlinks=False):
                            total += de.stat(follow_symlinks=False).st_size
                    except OSError:
                        continue  # pruned underneath us
        except OSError:
            continue
    return total


# -- degraded / admission state --------------------------------------------


class StoragePressure:
    """Per-node storage-pressure state consulted by admission and the
    snapshot-credit grant policy.

    ``blocked()`` is the single question the admission paths ask: True
    while a space-class failure episode is live (``degraded``) or the
    hard watermark is tripped (``hard``). Rejected clients park on
    ``waiter()`` — the gate opens on resume so they wake immediately
    instead of sleeping their full backoff bound (same WaitGate
    contract as the overload admission window)."""

    def __init__(self, node: str, counters=None):
        self.node = node
        self._lock = threading.Lock()
        self._gate = WaitGate()
        self.degraded = False
        self.hard = False
        self.brownout = False
        self.counter = counters if counters is not None else _counters.new(
            ("disk", node), DISK_FIELDS
        )
        self._obs_rec = obs.flight_recorder()

    # admission ---------------------------------------------------------
    def blocked(self) -> bool:
        return self.degraded or self.hard

    def waiter(self):
        return self._gate.waiter()

    # degraded episodes (space-class WAL failures) ----------------------
    def enter_degraded(self, detail: str = "") -> bool:
        with self._lock:
            if self.degraded:
                return False
            self.degraded = True
        self.counter.incr("disk_degraded_entered")
        self._obs_rec.record("storage_degraded", node=self.node, detail=detail)
        return True

    def exit_degraded(self) -> bool:
        with self._lock:
            if not self.degraded:
                return False
            self.degraded = False
        self.counter.incr("disk_degraded_resumed")
        self._obs_rec.record("storage_resumed", node=self.node)
        self._gate.open()
        return True

    # hard watermark ----------------------------------------------------
    def set_hard(self, on: bool) -> None:
        with self._lock:
            if self.hard == on:
                return
            self.hard = on
        if not on:
            self._gate.open()

    # snapshot credits --------------------------------------------------
    def snapshot_credits(self, default: int = 4) -> int:
        """Receiver-paced credit grant for snapshot chunk streaming: 0
        while writes are blocked (an install spool is new disk), else
        the default window."""
        return 0 if self.blocked() else default

    def delete(self) -> None:
        _counters.delete(("disk", self.node))


# -- watermark controller --------------------------------------------------


class DiskWatermark:
    """Soft/hard byte watermarks with hysteresis.

    ``tick(used)`` returns the transitions this sample caused, e.g.
    ``["soft_enter"]`` / ``["hard_exit", "soft_exit"]``. Exit requires
    dropping below ``threshold * exit_factor`` — a usage level hovering
    at the line must not flap reclamation on and off every tick."""

    def __init__(self, soft_bytes: int = 0, hard_bytes: int = 0,
                 exit_factor: float = 0.85):
        if soft_bytes and hard_bytes and hard_bytes < soft_bytes:
            raise ValueError("hard watermark below soft watermark")
        if not 0.0 < exit_factor <= 1.0:
            raise ValueError("exit_factor must be in (0, 1]")
        self.soft_bytes = soft_bytes
        self.hard_bytes = hard_bytes
        self.exit_factor = exit_factor
        self.soft = False
        self.hard = False
        self.used = 0

    @property
    def state(self) -> int:
        return 2 if self.hard else (1 if self.soft else 0)

    def tick(self, used: int) -> List[str]:
        self.used = used
        out: List[str] = []
        if self.hard_bytes:
            if not self.hard and used >= self.hard_bytes:
                self.hard = True
                out.append("hard_enter")
            elif self.hard and used < self.hard_bytes * self.exit_factor:
                self.hard = False
                out.append("hard_exit")
        if self.soft_bytes:
            if not self.soft and used >= self.soft_bytes:
                self.soft = True
                out.append("soft_enter")
            elif self.soft and used < self.soft_bytes * self.exit_factor:
                self.soft = False
                out.append("soft_exit")
        return out


# -- slow-disk brownout ----------------------------------------------------


class BrownoutDetector:
    """li-smoothed fsync-latency brownout detection.

    Fed per tick with the WAL's cumulative ``fsyncs`` /
    ``fsync_time_us`` counters; the detector differences them into a
    mean-latency-per-fsync sample, folds it through a leaky integrator,
    and requires ``streak`` consecutive ticks past the enter (resp.
    under the exit) threshold before flipping — a single slow fsync
    must not shed a leadership. enter > exit is the hysteresis band."""

    def __init__(self, enter_us: float = 200_000.0, exit_us: float = 50_000.0,
                 streak: int = 3, alpha: float = 0.5):
        if exit_us >= enter_us:
            raise ValueError("brownout exit threshold must be < enter")
        self.enter_us = enter_us
        self.exit_us = exit_us
        self.streak = streak
        self._li = LeakyIntegrator(alpha=alpha)
        self._last: Optional[Tuple[int, int]] = None  # (fsyncs, time_us)
        self._hi = 0
        self._lo = 0
        self.active = False
        self.smoothed_us = 0.0

    def sample(self, fsyncs: int, fsync_time_us: int) -> List[str]:
        """-> [] | ["enter"] | ["exit"]."""
        if self._last is None:
            self._last = (fsyncs, fsync_time_us)
            return []
        dn = fsyncs - self._last[0]
        dt_us = fsync_time_us - self._last[1]
        self._last = (fsyncs, fsync_time_us)
        if dn < 0 or dt_us < 0:  # counter reset (WAL re-registered)
            return []
        # no fsyncs this tick: decay toward zero rather than hold — an
        # idle disk is not evidence of a brownout either way. dt=1 turns
        # the rate integrator into a plain value EWMA over mean latency.
        mean_us = (dt_us / dn) if dn > 0 else 0.0
        self.smoothed_us = self._li.sample(mean_us, 1.0)
        out: List[str] = []
        if self.smoothed_us >= self.enter_us:
            self._hi += 1
            self._lo = 0
            if not self.active and self._hi >= self.streak:
                self.active = True
                out.append("enter")
        elif self.smoothed_us < self.exit_us:
            self._lo += 1
            self._hi = 0
            if self.active and self._lo >= self.streak:
                self.active = False
                out.append("exit")
        else:
            self._hi = 0
            self._lo = 0
        return out
