"""Leaky integrator: smoothed commit-rate gauge.

The role of the reference's ``ra_li`` (``src/ra_li.erl``, driving the
``commit_rate`` overview gauge): an exponentially-decayed rate estimate
updated from (count, dt) samples. :class:`VectorLeakyIntegrator` is the
batched form — one EWMA lane per raft group, updated from numpy count
vectors so the health plane smooths thousands of per-group commit rates
in one vector op per tick (no per-group Python loop).
"""

from __future__ import annotations

import numpy as np


class LeakyIntegrator:
    __slots__ = ("alpha", "rate")

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.rate = 0.0

    def sample(self, count: int, dt_s: float) -> float:
        if dt_s <= 0:
            return self.rate
        inst = count / dt_s
        self.rate = self.alpha * inst + (1 - self.alpha) * self.rate
        return self.rate


class VectorLeakyIntegrator:
    """Per-slot leaky integrators over a fixed capacity, updated in one
    vectorized pass: ``rate[i] = a*inst[i] + (1-a)*rate[i]`` for the
    slots named by an index array. Slots not in the update set keep
    their last estimate (they decay only when sampled — matching the
    scalar integrator, which is also only fed when its owner ticks)."""

    __slots__ = ("alpha", "rate")

    def __init__(self, capacity: int, alpha: float = 0.3):
        self.alpha = alpha
        self.rate = np.zeros(capacity, np.float64)

    def grow(self, capacity: int) -> None:
        if capacity > len(self.rate):
            new = np.zeros(capacity, np.float64)
            new[: len(self.rate)] = self.rate
            self.rate = new

    def sample(self, slots: np.ndarray, counts: np.ndarray,
               dt_s: float) -> np.ndarray:
        """Fold ``counts/dt_s`` into the integrators at ``slots``;
        returns the updated rates for those slots."""
        if dt_s <= 0:
            return self.rate[slots]
        inst = counts / dt_s
        upd = self.alpha * inst + (1 - self.alpha) * self.rate[slots]
        self.rate[slots] = upd
        return upd

    def reset(self, slots: np.ndarray) -> None:
        self.rate[slots] = 0.0
