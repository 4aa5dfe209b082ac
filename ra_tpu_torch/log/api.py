"""Log facade interface.

The consensus core only ever touches its log through this interface —
the same boundary as the reference's ``ra_log`` facade (reference:
``src/ra_log.erl:72-99`` for the event/effect types and the API surface
used from ``src/ra_server.erl``). Two implementations exist:

- ``ra_tpu_torch.log.memory.MemoryLog`` — synchronous in-memory fake with
  controllable written-watermark, used by the oracle tests and by
  in-proc integration clusters (cf. reference test/ra_log_memory.erl);
- ``ra_tpu_torch.log.log.Log`` — the real memtable + shared WAL + segments +
  snapshots engine.

Write model is async: ``append``/``write`` make entries *visible* for
reads immediately, but they only become *durable* (counted for
replication acks and quorum) once a ``("written", term, seq)`` event has
been handled. The server learns about durability via
``handle_event`` -> ``written_up_to``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

from ra_tpu_torch.protocol import Entry, SnapshotMeta


class LogApi:
    # -- writes ------------------------------------------------------------

    def append(self, entry: Entry) -> None:
        """Leader append. entry.index must equal next_index(); raises on
        gaps (crash-on-integrity-error, cf. src/ra_log.erl:541-545)."""
        raise NotImplementedError

    def append_many(self, entries: Sequence[Entry]) -> None:
        """Leader bulk append of a contiguous run starting at
        next_index(). Implementations may override with a single-pass
        version; the default loops ``append``."""
        for e in entries:
            self.append(e)

    def write(self, entries: Sequence[Entry]) -> None:
        """Follower write; may rewind/overwrite a divergent suffix."""
        raise NotImplementedError

    def set_last_index(self, idx: int) -> None:
        """Truncate the log tail down to idx (divergence handling)."""
        raise NotImplementedError

    def write_sparse(self, entry: Entry) -> None:
        """Out-of-order write of a live entry during snapshot install."""
        raise NotImplementedError

    # -- reads -------------------------------------------------------------

    def last_index_term(self) -> Tuple[int, int]:
        raise NotImplementedError

    def last_written(self) -> Tuple[int, int]:
        raise NotImplementedError

    def next_index(self) -> int:
        return self.last_index_term()[0] + 1

    def fetch(self, idx: int) -> Optional[Entry]:
        raise NotImplementedError

    def fetch_term(self, idx: int) -> Optional[int]:
        raise NotImplementedError

    def fold(self, lo: int, hi: int, fn: Callable[[Entry, Any], Any], acc: Any) -> Any:
        raise NotImplementedError

    def fetch_range(self, lo: int, hi: int) -> List[Entry]:
        """Contiguous read [lo, hi]; stops early at the first missing
        index (hot path: AER construction and the apply loop — concrete
        logs override with a batched implementation)."""
        out: List[Entry] = []
        for i in range(lo, hi + 1):
            e = self.fetch(i)
            if e is None:
                break
            out.append(e)
        return out

    def sparse_read(self, idxs: Sequence[int]) -> List[Entry]:
        raise NotImplementedError

    def exists(self, idx: int, term: int) -> bool:
        if idx == 0:
            return True
        t = self.fetch_term(idx)
        return t is not None and t == term

    # -- events ------------------------------------------------------------

    def handle_event(self, evt: Any) -> List[Any]:
        """Process a log event (e.g. ("written", term, seq)); returns
        follow-up effects for the server runtime."""
        raise NotImplementedError

    # -- snapshots ---------------------------------------------------------

    def snapshot_index_term(self) -> Optional[Tuple[int, int]]:
        raise NotImplementedError

    def snapshot_meta(self) -> Optional[SnapshotMeta]:
        raise NotImplementedError

    def install_snapshot(self, meta: SnapshotMeta, machine_state: Any) -> List[Any]:
        """Follower-side: replace log prefix with a received snapshot."""
        raise NotImplementedError

    def update_release_cursor(
        self, idx: int, cluster, machine_version: int, machine_state: Any,
        live_indexes=(),
    ) -> List[Any]:
        """Machine says state <= idx is captured in machine_state: maybe
        take a snapshot and truncate everything below except
        ``live_indexes`` (log-as-value-store retention)."""
        raise NotImplementedError

    def checkpoint(
        self, idx: int, cluster, machine_version: int, machine_state: Any,
        live_indexes=(),
    ) -> List[Any]:
        raise NotImplementedError

    def promote_checkpoint(self, idx: int) -> List[Any]:
        raise NotImplementedError

    def read_snapshot(self) -> Optional[Tuple[SnapshotMeta, Any]]:
        raise NotImplementedError

    # -- streaming snapshot transfer (reference: the snapshot behaviour's
    # begin_read/read_chunk + begin_accept/accept_chunk/complete_accept,
    # src/ra_snapshot.erl:135-210,742-860). Defaults return None: logs
    # without a disk-backed snapshot store (MemoryLog) fall back to the
    # whole-blob transfer path. ---------------------------------------------

    def begin_snapshot_read(self, chunk_size: int):
        """-> (meta, byte-chunk iterator reading from DISK) or None."""
        return None

    def begin_accept_snapshot(self, meta: SnapshotMeta):
        """-> ChunkAccept spooling chunks to disk, or None."""
        return None

    def complete_accept_snapshot(self, accept) -> Any:
        """Seal an accept started by :meth:`begin_accept_snapshot`:
        decode + promote the capture, apply the log-side bookkeeping of
        :meth:`install_snapshot`, return the machine state."""
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        pass

    def overview(self) -> dict:
        li, lt = self.last_index_term()
        wi, wt = self.last_written()
        return {
            "last_index": li,
            "last_term": lt,
            "last_written_index": wi,
            "last_written_term": wt,
            "snapshot": self.snapshot_index_term(),
        }
