"""In-memory log with controllable durability watermark.

The oracle's storage fake (cf. reference ``test/ra_log_memory.erl`` —
a pure map implementation of the full log API with fake async
``last_written``). With ``auto_written=True`` every write is durable
immediately; with ``auto_written=False`` the test (or in-proc runtime)
must drain ``pending_written_events()`` and feed them back through
``handle_event`` to advance the watermark — exactly how the real WAL's
written notifications behave.

Storage layout: the contiguous tail lives in a plain Python list
(``_list`` holds indexes ``[_base, _base+len)``), so the hot paths —
bulk append, ``fetch_range`` for AER construction and the apply loop —
are C-level ``extend``/slice operations instead of per-entry dict
traffic. Rare out-of-window entries (live entries kept below a
snapshot floor, sparse writes during snapshot install) go to the
``_sparse`` dict.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ra_tpu_torch.log.api import LogApi
from ra_tpu_torch.protocol import Entry, SnapshotMeta
from ra_tpu_torch.utils.seq import Seq


class MemoryLog(LogApi):
    def __init__(self, auto_written: bool = True):
        self._base = 1  # index of _list[0]
        self._list: List[Entry] = []  # contiguous run [_base, _base+len)
        self._sparse: Dict[int, Entry] = {}  # out-of-window entries
        self._last_index = 0
        self._last_term = 0
        self._written_index = 0
        self._written_term = 0
        self._first_index = 1
        self.auto_written = auto_written
        self._pending: Seq = Seq.empty()
        self._snapshot: Optional[Tuple[SnapshotMeta, Any]] = None
        self._checkpoints: List[Tuple[SnapshotMeta, Any]] = []

    # -- writes ------------------------------------------------------------

    def append(self, entry: Entry) -> None:
        if entry.index != self._last_index + 1:
            raise ValueError(
                f"non-contiguous append: {entry.index} after {self._last_index}"
            )
        self._store_run((entry,))

    def append_many(self, entries: Sequence[Entry]) -> None:
        if not entries:
            return
        if entries[0].index != self._last_index + 1:
            raise ValueError(
                f"non-contiguous append: {entries[0].index} after "
                f"{self._last_index}"
            )
        self._store_run(entries)

    def write(self, entries: Sequence[Entry]) -> None:
        if not entries:
            return
        first = entries[0].index
        if first > self._last_index + 1:
            raise ValueError(f"gap: write at {first}, last is {self._last_index}")
        if first <= self._last_index:
            # Overwrite: truncate divergent suffix, rewind watermark
            # (cf. src/ra_log.erl:560-580 last_written rewind).
            self.set_last_index(first - 1)
        self._store_run(entries)

    def _store_run(self, entries: Sequence[Entry]) -> None:
        """One-pass store of a contiguous run starting at
        ``_last_index + 1`` (callers validated the head)."""
        first = entries[0].index
        lst = self._list
        if not lst:
            self._base = first
        elif first != self._base + len(lst):
            # the contiguous window does not reach first (possible only
            # after sparse writes beyond the tail): spill the window to
            # the sparse map and restart it at first
            for e in lst:
                self._sparse[e.index] = e
            lst.clear()
            self._base = first
        lst.extend(entries)
        last = entries[-1]
        self._last_index = last.index
        self._last_term = last.term
        if self.auto_written:
            self._written_index = last.index
            self._written_term = last.term
        else:
            for e in entries:
                self._pending = self._pending.add(e.index)

    def write_sparse(self, entry: Entry) -> None:
        off = entry.index - self._base
        lst = self._list
        if 0 <= off < len(lst):
            lst[off] = entry
        elif off == len(lst) and (lst or entry.index == self._base):
            lst.append(entry)
        else:
            self._sparse[entry.index] = entry
        if entry.index > self._last_index:
            self._last_index = entry.index
            self._last_term = entry.term
            if self.auto_written:
                self._written_index = entry.index
                self._written_term = entry.term

    def set_last_index(self, idx: int) -> None:
        cut = idx - self._base + 1
        if cut < 0:
            cut = 0
        del self._list[cut:]
        if self._sparse:
            for i in [k for k in self._sparse if k > idx]:
                del self._sparse[i]
        self._last_index = idx
        t = self.fetch_term(idx)
        self._last_term = t if t is not None else 0
        if self._written_index > idx:
            self._written_index = idx
            self._written_term = self._last_term
        self._pending = self._pending.limit(idx)

    # -- durability simulation --------------------------------------------

    def pending_written_events(self) -> List[Any]:
        """Drain pending writes as ("written", term, seq) events."""
        if self._pending.is_empty():
            return []
        evts = []
        # group pending by term, preserving order
        cur_term = None
        cur: List[int] = []
        for idx in self._pending:
            e = self.fetch(idx)
            if e is None:
                continue
            if cur_term is None or e.term == cur_term:
                cur_term = e.term
                cur.append(idx)
            else:
                evts.append(("written", cur_term, Seq.from_list(cur)))
                cur_term, cur = e.term, [idx]
        if cur:
            evts.append(("written", cur_term, Seq.from_list(cur)))
        self._pending = Seq.empty()
        return evts

    def handle_event(self, evt: Any) -> List[Any]:
        if isinstance(evt, tuple) and evt and evt[0] == "written":
            _, term, seq = evt
            if seq is None:  # durability already reflected (auto mode)
                return []
            last = seq.last()
            if last is None:
                return []
            # Only advance if the entry we wrote is still the one in the
            # log at that index (it may have been overwritten since).
            e = self.fetch(last)
            if e is not None and e.term == term and last > self._written_index:
                self._written_index = last
                self._written_term = term
            return []
        return []

    # -- reads -------------------------------------------------------------

    def last_index_term(self) -> Tuple[int, int]:
        return self._last_index, self._last_term

    def last_written(self) -> Tuple[int, int]:
        return self._written_index, self._written_term

    def first_index(self) -> int:
        return self._first_index

    def fetch(self, idx: int) -> Optional[Entry]:
        off = idx - self._base
        lst = self._list
        if 0 <= off < len(lst):
            return lst[off]
        return self._sparse.get(idx)

    def fetch_term(self, idx: int) -> Optional[int]:
        e = self.fetch(idx)
        if e is not None:
            return e.term
        if self._snapshot is not None and idx == self._snapshot[0].index:
            return self._snapshot[0].term
        if idx == 0:
            return 0
        return None

    def fold(self, lo: int, hi: int, fn: Callable[[Entry, Any], Any], acc: Any) -> Any:
        for i in range(lo, hi + 1):
            e = self.fetch(i)
            if e is None:
                raise KeyError(f"missing log entry {i}")
            acc = fn(e, acc)
        return acc

    def fetch_range(self, lo: int, hi: int) -> List[Entry]:
        """Entries lo..hi inclusive, stopping at the first missing index
        (same contract as the file-backed log)."""
        off = lo - self._base
        lst = self._list
        if 0 <= off < len(lst):
            out = lst[off : hi - self._base + 1]
            nxt = lo + len(out)
            if nxt <= hi and self._sparse:
                # window ended before hi: continue through sparse runs
                fetch = self._sparse.get
                for i in range(nxt, hi + 1):
                    e = fetch(i)
                    if e is None:
                        break
                    out.append(e)
            return out
        out: List[Entry] = []
        fetch = self.fetch
        for i in range(lo, hi + 1):
            e = fetch(i)
            if e is None:
                break
            out.append(e)
        return out

    def sparse_read(self, idxs: Sequence[int]) -> List[Entry]:
        out = []
        for i in idxs:
            e = self.fetch(i)
            if e is not None:
                out.append(e)
        return out

    # -- snapshots ---------------------------------------------------------

    def snapshot_index_term(self) -> Optional[Tuple[int, int]]:
        if self._snapshot is None:
            return None
        m = self._snapshot[0]
        return (m.index, m.term)

    def snapshot_meta(self) -> Optional[SnapshotMeta]:
        return self._snapshot[0] if self._snapshot else None

    def install_snapshot(self, meta: SnapshotMeta, machine_state: Any) -> List[Any]:
        self._snapshot = (meta, machine_state)
        live = set(meta.live_indexes)
        lst = self._list
        cut = meta.index - self._base + 1
        if cut > 0:
            cut = min(cut, len(lst))
            for e in lst[:cut]:
                if e.index in live:
                    self._sparse[e.index] = e
            del lst[:cut]
            self._base = meta.index + 1
        elif not lst:
            self._base = meta.index + 1
        if self._sparse:
            for i in [
                k for k in self._sparse if k <= meta.index and k not in live
            ]:
                del self._sparse[i]
        self._first_index = meta.index + 1
        if self._last_index < meta.index:
            self._last_index = meta.index
            self._last_term = meta.term
        if self._written_index < meta.index:
            self._written_index = meta.index
            self._written_term = meta.term
        self._pending = self._pending.floor(meta.index + 1)
        return []

    def update_release_cursor(
        self, idx, cluster, machine_version, machine_state, live_indexes=()
    ) -> List[Any]:
        if idx <= (self._snapshot[0].index if self._snapshot else 0):
            return []
        t = self.fetch_term(idx)
        if t is None:
            return []
        meta = SnapshotMeta(
            index=idx, term=t, cluster=tuple(cluster), machine_version=machine_version,
            live_indexes=tuple(i for i in live_indexes if i <= idx),
        )
        return self.install_snapshot(meta, machine_state)

    def checkpoint(
        self, idx, cluster, machine_version, machine_state, live_indexes=()
    ) -> List[Any]:
        t = self.fetch_term(idx)
        if t is None:
            return []
        meta = SnapshotMeta(
            index=idx, term=t, cluster=tuple(cluster), machine_version=machine_version,
            live_indexes=tuple(i for i in live_indexes if i <= idx),
        )
        self._checkpoints.append((meta, machine_state))
        return []

    def promote_checkpoint(self, idx: int) -> List[Any]:
        eligible = [cp for cp in self._checkpoints if cp[0].index <= idx]
        if not eligible:
            return []
        meta, state = max(eligible, key=lambda cp: cp[0].index)
        self._checkpoints = [cp for cp in self._checkpoints if cp[0].index > meta.index]
        return self.install_snapshot(meta, state)

    def read_snapshot(self) -> Optional[Tuple[SnapshotMeta, Any]]:
        return self._snapshot

    # recovery checkpoints (orderly-shutdown replay skip)

    def write_recovery_checkpoint(self, meta: SnapshotMeta, machine_state: Any) -> None:
        self._recovery = (meta, machine_state)

    def read_recovery_checkpoint(self) -> Optional[Tuple[SnapshotMeta, Any]]:
        return getattr(self, "_recovery", None)

    def discard_recovery_checkpoint(self) -> None:
        self._recovery = None
