"""Clock-bound leader leases: the pure math (docs/INTERNALS.md §20).

A leader that has heard a quorum of acks recently enough may serve
linearizable reads locally, because the same quorum promises (via
pre-vote leader stickiness) not to elect a replacement until a full
election timeout of silence has passed on their own clocks. The lease
window must therefore be strictly shorter than that promise:

    expiry = basis + election_timeout * safety_factor - drift_epsilon

with ``safety_factor < 1`` and ``drift_epsilon`` absorbing bounded
clock-RATE drift between nodes over one window (no absolute clock
agreement is assumed — every comparison is leader-local monotonic
time through the ``runtime/clock.py`` seam, so the sim backend can
skew it adversarially).

``basis`` is NOT the ack receive time. An ack proves the follower was
alive at some moment between our send and our receive; crediting
receive time would over-credit by the one-way return latency, which an
adversarial network can stretch arbitrarily. Each tracker therefore
stamps the OLDEST outstanding send per peer and credits that stamp
when any response at the leader's term arrives — always a lower bound
on the follower's true last-contact time (ra_tpu_torch mirror of the
send-basis rule in "Paxos vs Raft", arxiv 2004.05074 §4.3).

The quorum basis is the k-th largest per-voter basis (self counts at
``now``): at least k voters heard from us at or after it, and any
future election quorum intersects them in ≥1 voter whose stickiness
promise outlives our (shorter) lease.

Two consumers share this module: the actor backend's per-server
``LeaseTracker`` and the batch coordinator's vectorized ``(G, P)``
stamp arrays (``quorum_bases``). Both funnel the final horizon through
``lease_expiry`` so the safety arithmetic lives in exactly one place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Defaults: the window is deliberately a fraction of the follower
# promise (election_timeout), with a small absolute epsilon on top for
# clock-rate drift. 0.8/2ms keeps leases comfortably renewable by
# read-triggered rounds at the repo's 0.15 s test election timeout.
DEFAULT_SAFETY_FACTOR = 0.8
DEFAULT_DRIFT_EPSILON_S = 0.002

# Test-only failpoint (in the style of models/fifo.py
# SIM_BUG_REVERSED_REQUEUE): when flipped on, the drift bound is
# mis-derived — the margin terms ADD to the window instead of
# shrinking it, so a lease can outlive the follower promise and a
# deposed leader will serve stale reads. The sim oracle must catch
# this on every seed (tests/test_sim.py).
SIM_BUG_DRIFT_BOUND = False


def lease_expiry(basis, election_timeout_s: float,
                 safety_factor: float = DEFAULT_SAFETY_FACTOR,
                 drift_epsilon_s: float = DEFAULT_DRIFT_EPSILON_S):
    """Safe lease horizon for a quorum ack basis. Elementwise over
    numpy arrays (the batch backend passes a ``(G,)`` basis column)."""
    if SIM_BUG_DRIFT_BOUND:
        # planted bug: margins flipped to extensions — the lease
        # outlives the follower stickiness promise
        return basis + election_timeout_s * (1.0 + safety_factor) \
            + drift_epsilon_s
    return basis + election_timeout_s * safety_factor - drift_epsilon_s


@dataclass(frozen=True)
class LeaseConfig:
    """Lease knobs. ``enabled`` defaults OFF everywhere: leader
    stickiness changes election behavior (a follower with recent
    leader contact refuses pre-votes), which existing churn tests
    trigger deliberately; harness/bench/sim opt in explicitly."""

    enabled: bool = False
    election_timeout_s: float = 0.15
    safety_factor: float = DEFAULT_SAFETY_FACTOR
    drift_epsilon_s: float = DEFAULT_DRIFT_EPSILON_S

    def expiry(self, basis: float) -> float:
        return lease_expiry(basis, self.election_timeout_s,
                            self.safety_factor, self.drift_epsilon_s)

    @property
    def window_s(self) -> float:
        """Nominal lease length from a fresh basis."""
        return self.expiry(0.0)


class LeaseTracker:
    """Scalar lease state for one actor-backend leader.

    The owner stamps ``record_send`` on every quorum-bearing outbound
    (AER, heartbeat), credits ``record_ack`` on every same-term
    response, and calls ``refresh`` to fold the credited bases into a
    monotonically-advancing expiry. ``revoke`` clears BOTH the expiry
    and the stamps: acks already in flight at deposition time must not
    resurrect a lease for a leadership we no longer hold.
    """

    __slots__ = ("cfg", "expiry", "_sent", "_basis")

    def __init__(self, cfg: LeaseConfig):
        self.cfg = cfg
        self.expiry = 0.0
        self._sent: Dict[object, float] = {}
        self._basis: Dict[object, float] = {}

    def record_send(self, peer, now: float) -> None:
        """Stamp the oldest outstanding send to ``peer`` (later sends
        before an ack keep the older, more conservative stamp)."""
        self._sent.setdefault(peer, now)

    def record_ack(self, peer) -> bool:
        """Credit a same-term response from ``peer`` against its
        oldest outstanding send. Unsolicited responses (no send on
        record — e.g. a duplicate ack) credit nothing: under-crediting
        is always safe. Returns True if a basis advanced."""
        basis = self._sent.pop(peer, None)
        if basis is None:
            return False
        if basis > self._basis.get(peer, 0.0):
            self._basis[peer] = basis
            return True
        return False

    def refresh(self, voters: Sequence, self_id, now: float) -> bool:
        """Recompute the expiry from the current per-voter bases
        (self credits at ``now``). Returns True when the lease
        horizon advanced (it never moves backwards: an older quorum's
        promise is not withdrawn by a newer minority)."""
        n = len(voters)
        if n == 0:
            return False
        k = n // 2 + 1
        bases = sorted(
            (now if v == self_id else self._basis.get(v, 0.0)
             for v in voters),
            reverse=True,
        )
        basis = bases[k - 1]
        if basis <= 0.0:
            return False
        e = self.cfg.expiry(basis)
        if e > self.expiry:
            self.expiry = e
            return True
        return False

    def valid(self, now: float) -> bool:
        return now < self.expiry

    def remaining(self, now: float) -> float:
        return max(0.0, self.expiry - now)

    def revoke(self) -> bool:
        """Drop the lease AND the stamps (in-flight pre-revocation
        acks must not resurrect it). Returns True if a live-or-past
        lease existed (callers count revocations only when one did)."""
        had = self.expiry > 0.0
        self.expiry = 0.0
        self._sent.clear()
        self._basis.clear()
        return had


def quorum_bases(bases: np.ndarray, voter_mask: np.ndarray,
                 quorum: np.ndarray) -> np.ndarray:
    """Vectorized per-group quorum basis for the batch backend.

    ``bases``: (G, P) float64 per-slot ack bases, with each group's
    self slot already set to "now"; ``voter_mask``: (G, P) bool;
    ``quorum``: (G,) int voter-majority sizes. Returns the (G,) k-th
    largest voter basis; groups with no quorum (or no positive basis
    at the quorum rank) get 0.0.
    """
    masked = np.where(voter_mask, bases, -np.inf)
    order = -np.sort(-masked, axis=1)  # descending per row
    k = np.clip(quorum - 1, 0, bases.shape[1] - 1).astype(np.int64)
    out = np.take_along_axis(order, k[:, None], axis=1)[:, 0]
    return np.where(np.isfinite(out) & (quorum >= 1) & (out > 0.0),
                    out, 0.0)
