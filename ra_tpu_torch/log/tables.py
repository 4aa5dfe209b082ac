"""Per-system registry of memtables and snapshot floor state.

Combines the roles of the reference's ``ra_log_ets`` (owner of all
memtable ETS tables so they outlive individual server crashes,
``src/ra_log_ets.erl``) and ``ra_log_snapshot_state`` (the public table
of per-UId snapshot index / smallest live index the WAL and segment
writer consult to drop dead writes, ``src/ra_log_snapshot_state.erl``).
One instance per running system; thread-safe.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ra_tpu_torch.log.memtable import MemTable
from ra_tpu_torch.utils.seq import Seq


class TableRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tables: Dict[str, MemTable] = {}
        # uid -> (snapshot_idx, smallest_live_idx, live_indexes Seq)
        self._snap: Dict[str, Tuple[int, int, Seq]] = {}

    # -- memtables ---------------------------------------------------------

    def mem_table(self, uid: str) -> MemTable:
        with self._lock:
            t = self._tables.get(uid)
            if t is None:
                t = MemTable(uid)
                self._tables[uid] = t
            return t

    def delete_mem_table(self, uid: str) -> None:
        with self._lock:
            self._tables.pop(uid, None)

    def uids(self) -> List[str]:
        return list(self._tables.keys())

    # -- snapshot floor state ----------------------------------------------

    def set_snapshot_state(
        self, uid: str, snapshot_idx: int, live_indexes: Seq
    ) -> None:
        smallest = live_indexes.first()
        smallest_live = smallest if smallest is not None else snapshot_idx + 1
        with self._lock:
            self._snap[uid] = (snapshot_idx, smallest_live, live_indexes)

    def snapshot_index(self, uid: str) -> int:
        return self._snap.get(uid, (0, 1, Seq.empty()))[0]

    def smallest_live_index(self, uid: str) -> int:
        """Writes below this index are dead and may be dropped by the WAL
        and skipped by the segment writer."""
        return self._snap.get(uid, (0, 1, Seq.empty()))[1]

    def live_indexes(self, uid: str) -> Seq:
        return self._snap.get(uid, (0, 1, Seq.empty()))[2]

    def delete_snapshot_state(self, uid: str) -> None:
        with self._lock:
            self._snap.pop(uid, None)
