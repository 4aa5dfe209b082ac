"""Per-server in-memory table of recent log entries.

Plays the role of the reference's ETS-backed memtables (reference:
``src/ra_mt.erl`` — strictly-monotone inserts within one table,
**successor chaining** on overwrite or size rotation :86-225,
flush-driven deletion :439, range tracking). Entries live here from the
moment they are appended until the segment writer has flushed them.

Why chains matter: the segment writer flushes a rolled WAL file's
entries concurrently with the server possibly overwriting a divergent
suffix. Entries are therefore **never overwritten in place** (the
reference's core invariant, docs/internals/LOG.md:82-96): an overwrite
(or a table exceeding ``max_entries``) starts a successor table; the
old table keeps its entries — identified by table id — until the flush
that references them completes. Reads serve the *visible* view (newest
table first, truncations applied); flush reads address an exact table
id and see exactly what the WAL file contained.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ra_tpu_torch.protocol import Entry
from ra_tpu_torch.utils.seq import Seq

# rotation threshold (reference: ?MAX_MEMTBL_ENTRIES, src/ra_mt.erl:39)
MAX_MEMTBL_ENTRIES = 1_000_000


class _Table:
    __slots__ = ("tid", "entries", "seq")

    def __init__(self, tid: int):
        self.tid = tid
        self.entries: Dict[int, Entry] = {}
        # the VISIBLE indexes of this table (truncations shrink it; the
        # entries dict keeps rows for in-flight flushes)
        self.seq: Seq = Seq.empty()


class MemTable:
    __slots__ = ("uid", "max_entries", "_tables", "_next_tid")

    def __init__(self, uid: str, max_entries: int = MAX_MEMTBL_ENTRIES):
        self.uid = uid
        self.max_entries = max_entries
        self._tables: List[_Table] = [_Table(0)]  # newest first
        self._next_tid = 1

    # -- writes ------------------------------------------------------------

    @property
    def current_tid(self) -> int:
        return self._tables[0].tid

    def _successor(self) -> _Table:
        t = _Table(self._next_tid)
        self._next_tid += 1
        self._tables.insert(0, t)
        return t

    def insert(self, entry: Entry) -> int:
        """Insert; returns the table id that took the entry. Overwriting
        an index present in the head table (divergent-suffix rewrite) or
        exceeding the rotation threshold starts a successor table —
        never an in-place mutation."""
        head = self._tables[0]
        if entry.index in head.entries or len(head.entries) >= self.max_entries:
            # visibility: everything at/above the overwritten index is
            # superseded across the whole chain
            if entry.index in head.entries:
                self._limit_visible(entry.index - 1)
            head = self._successor()
        head.entries[entry.index] = entry
        head.seq = head.seq.add(entry.index)
        return head.tid

    def insert_run(self, entries) -> Optional[int]:
        """Bulk insert of a strictly-new contiguous ascending run (the
        leader/steady-follower append path): one visibility-seq update
        for the whole run instead of per-entry copies. Returns the table
        id that took the run, or None when the run needs the per-entry
        path (overwrite of a live index or table rotation) — the caller
        then loops :meth:`insert`."""
        head = self._tables[0]
        first = entries[0].index
        if (
            first in head.entries
            or len(head.entries) + len(entries) > self.max_entries
        ):
            return None
        d = head.entries
        for e in entries:
            d[e.index] = e
        head.seq = head.seq.append_run(first, entries[-1].index)
        return head.tid

    def insert_sparse(self, entry: Entry) -> int:
        """Out-of-order insert for snapshot live entries (no truncation
        semantics)."""
        head = self._tables[0]
        if entry.index in head.entries:
            head = self._successor()
        head.entries[entry.index] = entry
        head.seq = head.seq.add(entry.index)
        return head.tid

    def truncate_from(self, idx: int) -> None:
        self._limit_visible(idx - 1)

    def _limit_visible(self, last: int) -> None:
        for t in self._tables:
            t.seq = t.seq.limit(last)
        self._gc_tables()

    # -- reads -------------------------------------------------------------

    def get_range(self, lo: int, hi: int) -> List[Optional[Entry]]:
        """Visible entries for ``[lo, hi]`` (None holes) in ONE pass
        over the table chain: seq RANGE intersections instead of a
        per-index membership bisect per table — the read hot path for
        AER construction and the apply loop."""
        n = hi - lo + 1
        out: List[Optional[Entry]] = [None] * n
        remaining = n
        for t in self._tables:
            if remaining == 0:
                break
            entries = t.entries
            for rlo, rhi in t.seq.ranges():
                if rhi < lo or rlo > hi:
                    continue
                for i in range(max(rlo, lo), min(rhi, hi) + 1):
                    k = i - lo
                    if out[k] is None:
                        ent = entries.get(i)
                        if ent is not None:
                            out[k] = ent
                            remaining -= 1
        return out

    def get(self, idx: int) -> Optional[Entry]:
        """Visible read: newest table first, truncations respected."""
        for t in self._tables:
            if idx in t.seq:
                e = t.entries.get(idx)
                if e is not None:
                    return e
        return None

    def get_with_tid(self, idx: int) -> Optional[Tuple[Entry, int]]:
        """Visible read returning the holding table's id (resends must
        tag WAL records with the table that actually owns the entry)."""
        for t in self._tables:
            if idx in t.seq:
                e = t.entries.get(idx)
                if e is not None:
                    return e, t.tid
        return None

    def get_from(self, tid: int, idx: int) -> Optional[Entry]:
        """Exact-table read for flush jobs: returns what that table
        holds even if a successor has since superseded the index."""
        for t in self._tables:
            if t.tid == tid:
                return t.entries.get(idx)
        return None

    # -- deletion ----------------------------------------------------------

    def record_flushed(self, seq: Seq, tid: int) -> None:
        """Delete entries the segment writer persisted from the exact
        table the WAL handed over (reference: record_flushed on tid)."""
        for t in self._tables:
            if t.tid != tid:
                continue
            for i in seq:
                t.entries.pop(i, None)
            t.seq = t.seq.subtract(seq)
        self._gc_tables()

    def set_first(self, idx: int, live=None) -> None:
        """Drop everything below idx (snapshot truncation), retaining any
        indexes in `live` (a Seq of live indexes below the snapshot)."""
        for t in self._tables:
            for i in list(t.entries):
                if i < idx and (live is None or i not in live):
                    del t.entries[i]
            kept = t.seq.floor(idx)
            if live is not None:
                kept = kept.union(t.seq.intersect(live))
            t.seq = kept
        self._gc_tables()

    def _gc_tables(self) -> None:
        # Drop non-head tables whose VISIBLE seq is empty: every row
        # still in them is superseded (truncation/overwrite made it
        # invisible; the replacement entries live in a successor with
        # their own WAL records), so pending flushes that wanted them
        # may safely skip. This bounds chain growth under leadership
        # churn — without it, superseded rows whose file seqs the WAL
        # rewound are never referenced by any flush and leak forever.
        self._tables = [self._tables[0]] + [
            t for t in self._tables[1:] if t.entries and not t.seq.is_empty()
        ]

    # -- introspection -----------------------------------------------------

    def seq(self) -> Seq:
        out = Seq.empty()
        for t in self._tables:
            out = out.union(t.seq)
        return out

    def range(self) -> Optional[Tuple[int, int]]:
        return self.seq().range()

    def num_tables(self) -> int:
        return len(self._tables)

    def __len__(self) -> int:
        return sum(len(t.entries) for t in self._tables)
