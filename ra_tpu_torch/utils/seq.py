"""Sparse index sequences.

A ``Seq`` is a set of non-negative log indexes stored as a normalized,
ascending list of inclusive ``(lo, hi)`` ranges. It is the backbone of
live-index tracking, WAL pending-write tracking and compaction planning —
the same role ``ra_seq`` plays in the reference (reference:
``src/ra_seq.erl``, ``docs/internals/LOG.md:496-532``), re-designed here as
an immutable ascending-range structure rather than the reference's
high-to-low cons list, because batch conversion to dense device arrays
wants ascending order.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

Range = Tuple[int, int]


class Seq:
    """Immutable sparse sequence of integer indexes."""

    __slots__ = ("_ranges",)

    def __init__(self, ranges: Optional[Sequence[Range]] = None, _normalized: bool = False):
        if ranges is None:
            self._ranges: List[Range] = []
        elif _normalized:
            self._ranges = list(ranges)
        else:
            self._ranges = _normalize(ranges)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def empty() -> "Seq":
        return _EMPTY

    @staticmethod
    def from_range(lo: int, hi: int) -> "Seq":
        if hi < lo:
            return _EMPTY
        return Seq([(lo, hi)], _normalized=True)

    @staticmethod
    def from_list(idxs: Iterable[int]) -> "Seq":
        s = sorted(set(idxs))
        if not s:
            return _EMPTY
        ranges: List[Range] = []
        lo = prev = s[0]
        for i in s[1:]:
            if i == prev + 1:
                prev = i
            else:
                ranges.append((lo, prev))
                lo = prev = i
        ranges.append((lo, prev))
        return Seq(ranges, _normalized=True)

    # -- basic queries -----------------------------------------------------

    def is_empty(self) -> bool:
        return not self._ranges

    def first(self) -> Optional[int]:
        return self._ranges[0][0] if self._ranges else None

    def last(self) -> Optional[int]:
        return self._ranges[-1][1] if self._ranges else None

    def __len__(self) -> int:
        return sum(hi - lo + 1 for lo, hi in self._ranges)

    def __contains__(self, idx: int) -> bool:
        i = bisect.bisect_right(self._ranges, (idx, float("inf"))) - 1
        if i < 0:
            return False
        lo, hi = self._ranges[i]
        return lo <= idx <= hi

    def __iter__(self) -> Iterator[int]:
        for lo, hi in self._ranges:
            yield from range(lo, hi + 1)

    def __reversed__(self) -> Iterator[int]:
        for lo, hi in reversed(self._ranges):
            yield from range(hi, lo - 1, -1)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Seq) and self._ranges == other._ranges

    def __hash__(self) -> int:
        return hash(tuple(self._ranges))

    def __repr__(self) -> str:
        return f"Seq({self._ranges!r})"

    def ranges(self) -> List[Range]:
        """Ascending list of inclusive (lo, hi) ranges."""
        return list(self._ranges)

    def range(self) -> Optional[Range]:
        """Bounding (first, last) range, or None when empty."""
        if not self._ranges:
            return None
        return (self._ranges[0][0], self._ranges[-1][1])

    # -- construction ops --------------------------------------------------

    def append(self, idx: int) -> "Seq":
        """Add ``idx``, which must be greater than ``last()``."""
        if self._ranges:
            lo, hi = self._ranges[-1]
            if idx <= hi:
                raise ValueError(f"append {idx} not greater than last {hi}")
            if idx == hi + 1:
                return Seq(self._ranges[:-1] + [(lo, idx)], _normalized=True)
        return Seq(self._ranges + [(idx, idx)], _normalized=True)

    def append_run(self, lo: int, hi: int) -> "Seq":
        """Add the contiguous run ``[lo, hi]`` in one step; ``lo`` must
        be greater than ``last()`` (the bulk-append hot path — one range
        update instead of hi-lo+1 copies)."""
        if hi < lo:
            return self
        if self._ranges:
            plo, phi = self._ranges[-1]
            if lo <= phi:
                raise ValueError(f"append_run {lo} not greater than last {phi}")
            if lo == phi + 1:
                return Seq(self._ranges[:-1] + [(plo, hi)], _normalized=True)
        return Seq(self._ranges + [(lo, hi)], _normalized=True)

    def add(self, idx: int) -> "Seq":
        """Add an arbitrary index (set union with {idx})."""
        if idx in self:
            return self
        return self.union(Seq.from_list([idx]))

    def union(self, other: "Seq") -> "Seq":
        return Seq(self._ranges + other._ranges)

    def extend_range(self, lo: int, hi: int) -> "Seq":
        return self.union(Seq.from_range(lo, hi))

    # -- trimming ----------------------------------------------------------

    def floor(self, idx: int) -> "Seq":
        """Keep only indexes >= idx."""
        out: List[Range] = []
        for lo, hi in self._ranges:
            if hi < idx:
                continue
            out.append((max(lo, idx), hi))
        return Seq(out, _normalized=True)

    def limit(self, idx: int) -> "Seq":
        """Keep only indexes <= idx."""
        out: List[Range] = []
        for lo, hi in self._ranges:
            if lo > idx:
                break
            out.append((lo, min(hi, idx)))
        return Seq(out, _normalized=True)

    def subtract(self, other: "Seq") -> "Seq":
        """Set difference self - other."""
        if other.is_empty() or self.is_empty():
            return self
        out: List[Range] = []
        obstacles = other._ranges
        j = 0
        for lo, hi in self._ranges:
            cur = lo
            while j < len(obstacles) and obstacles[j][1] < cur:
                j += 1
            k = j
            while cur <= hi:
                if k >= len(obstacles) or obstacles[k][0] > hi:
                    out.append((cur, hi))
                    break
                olo, ohi = obstacles[k]
                if olo > cur:
                    out.append((cur, olo - 1))
                cur = max(cur, ohi + 1)
                k += 1
        return Seq(out, _normalized=True)

    def intersect(self, other: "Seq") -> "Seq":
        out: List[Range] = []
        a, b = self._ranges, other._ranges
        i = j = 0
        while i < len(a) and j < len(b):
            lo = max(a[i][0], b[j][0])
            hi = min(a[i][1], b[j][1])
            if lo <= hi:
                out.append((lo, hi))
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
        return Seq(out, _normalized=True)

    def in_range(self, lo: int, hi: int) -> "Seq":
        return self.floor(lo).limit(hi)

    # -- chunking (for WAL/snapshot transfer batching) ---------------------

    def list_chunk(self, n: int) -> Tuple[List[int], "Seq"]:
        """Take up to n smallest indexes as a list; return (chunk, rest)."""
        chunk: List[int] = []
        for idx in self:
            if len(chunk) >= n:
                break
            chunk.append(idx)
        if not chunk:
            return [], self
        return chunk, self.floor(chunk[-1] + 1)


def _normalize(ranges: Sequence[Range]) -> List[Range]:
    rs = sorted((lo, hi) for lo, hi in ranges if lo <= hi)
    out: List[Range] = []
    for lo, hi in rs:
        if out and lo <= out[-1][1] + 1:
            plo, phi = out[-1]
            out[-1] = (plo, max(phi, hi))
        else:
            out.append((lo, hi))
    return out


_EMPTY = Seq([], _normalized=True)
