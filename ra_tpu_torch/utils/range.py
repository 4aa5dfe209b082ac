"""Contiguous inclusive integer range algebra.

Equivalent capability to the reference's ``src/ra_range.erl`` (extend /
limit / truncate / overlap / subtract over ``{Lo, Hi}``). A range is a
``(lo, hi)`` tuple with ``lo <= hi``, or ``None`` for the empty range.
"""

from __future__ import annotations

from typing import Optional, Tuple

Range = Optional[Tuple[int, int]]


def new(lo: int, hi: int) -> Range:
    return (lo, hi) if lo <= hi else None


def size(r: Range) -> int:
    return 0 if r is None else r[1] - r[0] + 1


def contains(r: Range, idx: int) -> bool:
    return r is not None and r[0] <= idx <= r[1]


def extend(r: Range, idx: int) -> Range:
    """Append idx which must be hi+1 (or create a fresh range)."""
    if r is None:
        return (idx, idx)
    lo, hi = r
    if idx != hi + 1:
        raise ValueError(f"extend: {idx} is not contiguous with {r}")
    return (lo, idx)


def limit(r: Range, idx: int) -> Range:
    """Keep only indexes <= idx."""
    if r is None:
        return None
    lo, hi = r
    return new(lo, min(hi, idx))


def floor(r: Range, idx: int) -> Range:
    """Keep only indexes >= idx."""
    if r is None:
        return None
    lo, hi = r
    return new(max(lo, idx), hi)


def truncate(r: Range, idx: int) -> Range:
    """Drop indexes <= idx (truncate head through idx)."""
    if r is None:
        return None
    lo, hi = r
    return new(max(lo, idx + 1), hi)


def overlap(a: Range, b: Range) -> Range:
    if a is None or b is None:
        return None
    return new(max(a[0], b[0]), min(a[1], b[1]))


def union(a: Range, b: Range) -> Range:
    """Bounding union (only valid for adjacent/overlapping ranges)."""
    if a is None:
        return b
    if b is None:
        return a
    return (min(a[0], b[0]), max(a[1], b[1]))


def subtract(a: Range, b: Range):
    """a - b as a list of 0..2 ranges."""
    if a is None:
        return []
    if b is None:
        return [a]
    out = []
    lo, hi = a
    blo, bhi = b
    if lo < blo:
        r = new(lo, min(hi, blo - 1))
        if r:
            out.append(r)
    if hi > bhi:
        r = new(max(lo, bhi + 1), hi)
        if r:
            out.append(r)
    return out
