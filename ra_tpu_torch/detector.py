"""Adaptive (phi-accrual) node failure detector.

The role of the reference's ``aten`` dependency (reference:
``src/ra_server_proc.erl:384`` registers with aten; aten 0.6.0 is a
poll-based adaptive detector): instead of a fixed liveness deadline,
track the inter-arrival times of liveness evidence per node and compute

    phi(t) = -log10( P(no evidence for t, given the observed history) )

under a normal model of the sampled intervals. ``phi`` grows smoothly
as evidence stops arriving; a node is *suspect* above a threshold
(default 8 — roughly "this silence had probability 1e-8"). Adaptive:
on a jittery link the learned variance widens and suspicion slows
down; on a steady link it tightens.

Observability (docs/INTERNALS.md §14): a detector constructed with an
``owner`` node name exports one counters vector per watched peer —
``("phi", owner, peer)`` with ``phi_milli`` / ``phi_suspect`` /
``phi_intervals`` gauges (``counters.DETECTOR_FIELDS``) riding the normal
Prometheus exposition — and records ``suspect`` / ``unsuspect``
transition events in the flight recorder, so "who suspected whom when"
lines up with the election/role-change trace. Gauges refresh whenever
``suspect``/``phi`` is evaluated and on the periodic ``publish()``
sweep the node's detector loop drives.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional


class PhiAccrualDetector:
    # -log10(1e-12) bounds phi at 12: thresholds at/above it would make
    # suspect() permanently false, so they are clamped
    MAX_THRESHOLD = 11.0

    def __init__(
        self,
        threshold: float = 8.0,
        window: int = 64,
        min_std: float = 0.01,
        bootstrap_interval: float = 0.5,
        owner: Optional[str] = None,
    ):
        self.threshold = min(threshold, self.MAX_THRESHOLD)
        self.window = window
        self.min_std = min_std
        self.bootstrap_interval = bootstrap_interval
        self.owner = owner
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}
        self._intervals: Dict[str, Deque[float]] = {}
        self._suspected: Dict[str, bool] = {}
        self._gauges: Dict[str, object] = {}
        self._closed = False

    def heartbeat(self, node: str, now: Optional[float] = None) -> None:
        """Record liveness evidence for ``node`` (a fresh pong, an
        inbound message, a successful poll)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            prev = self._last.get(node)
            self._last[node] = now
            if prev is not None:
                interval = max(now - prev, 1e-6)
                iv = self._intervals.setdefault(node, deque(maxlen=self.window))
                if iv and interval > 4 * (sum(iv) / len(iv)) + 1.0:
                    # an outage gap, not a cadence sample: recording it
                    # would inflate mean/std and blind the detector to
                    # the NEXT failure for minutes — treat as a restart
                    # and relearn the cadence
                    iv.clear()
                else:
                    iv.append(interval)
        # fresh evidence: phi collapses — flip a standing suspicion now
        # rather than waiting for the next suspect()/publish() poll
        if self.owner is not None and self._suspected.get(node):
            self._observe(node, self.phi(node, now), now)

    def phi(self, node: str, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last.get(node)
            if last is None:
                return 0.0  # never seen: no evidence either way
            iv = self._intervals.get(node)
            if not iv:
                mean, std = self.bootstrap_interval, self.bootstrap_interval / 2
            else:
                mean = sum(iv) / len(iv)
                var = sum((x - mean) ** 2 for x in iv) / len(iv)
                std = max(math.sqrt(var), self.min_std, mean / 10)
        elapsed = now - last
        # P(interval > elapsed) under N(mean, std), via the logistic
        # approximation of the normal CDF (cheap, monotone, and the
        # standard trick in phi-accrual implementations)
        y = (elapsed - mean) / std
        p = 1.0 / (1.0 + math.exp(-y * 1.702))
        p_longer = max(1.0 - p, 1e-12)
        return -math.log10(p_longer)

    def suspect(self, node: str, now: Optional[float] = None) -> bool:
        p = self.phi(node, now)
        if self.owner is not None:
            self._observe(node, p, now)
        return p > self.threshold

    def publish(self, now: Optional[float] = None) -> None:
        """Refresh the exported gauges (and fire any pending suspicion
        transitions) for every watched peer — called periodically by
        the owning node's detector loop so the phi surface stays live
        even when nothing polls ``suspect()``."""
        if self.owner is None:
            return
        with self._lock:
            nodes = list(self._last)
        for node in nodes:
            self._observe(node, self.phi(node, now), now)

    def _observe(self, node: str, phi: float, now: Optional[float]) -> None:
        """Update the per-peer gauges and record suspect/unsuspect
        flight-recorder transitions (owner-mode only)."""
        from ra_tpu_torch import counters as ra_counters

        if self._closed:
            # a straggling publish() must not resurrect gauge vectors
            # close() already deleted from the global registry
            return
        g = self._gauges.get(node)
        if g is None:
            g = self._gauges[node] = ra_counters.new(
                ("phi", self.owner, node), ra_counters.DETECTOR_FIELDS
            )
        g.put("phi_milli", int(phi * 1000))
        with self._lock:
            iv = self._intervals.get(node)
            g.put("phi_intervals", len(iv) if iv else 0)
            sus = phi > self.threshold
            was = self._suspected.get(node, False)
            self._suspected[node] = sus
        g.put("phi_suspect", int(sus))
        if sus != was:
            from ra_tpu_torch import obs as _obs

            _obs.record_event(
                "suspect" if sus else "unsuspect", node=self.owner,
                detail=f"peer={node} phi={phi:.2f} "
                       f"threshold={self.threshold:.1f}",
            )

    def overview(self, now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        """Per-peer phi snapshot: {peer: {phi, suspect, intervals}}."""
        with self._lock:
            nodes = list(self._last)
        out = {}
        for node in nodes:
            p = self.phi(node, now)
            with self._lock:
                iv = self._intervals.get(node)
                n_iv = len(iv) if iv else 0
            out[node] = {
                "phi": round(p, 3),
                "suspect": p > self.threshold,
                "intervals": n_iv,
            }
        return out

    def forget(self, node: str) -> None:
        from ra_tpu_torch import counters as ra_counters

        with self._lock:
            self._last.pop(node, None)
            self._intervals.pop(node, None)
            self._suspected.pop(node, None)
            had = self._gauges.pop(node, None)
        if had is not None and self.owner is not None:
            ra_counters.delete(("phi", self.owner, node))

    def close(self) -> None:
        """Drop every watched peer and its exported gauges (owner node
        shutting down). The flag stops concurrent evaluations from
        re-registering deleted gauges; callers should stop their
        publish loop first (RaNode.stop joins the detector thread)."""
        self._closed = True
        with self._lock:
            nodes = list(self._last)
        for node in nodes:
            self.forget(node)
