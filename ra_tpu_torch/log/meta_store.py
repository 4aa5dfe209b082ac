"""Durable per-server metadata store (term / voted_for / last_applied).

File-backed successor to the reference's dets-based ``ra_log_meta``
(``src/ra_log_meta.erl``): one store per system, batched async writes for
``last_applied``, synchronous durability for term/vote changes. Format:
an append-only journal of CRC-framed pickled ``(uid, key, value)``
records, compacted to a snapshot rewrite once it grows past a threshold.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from typing import Any, Dict, Optional

from ra_tpu_torch import faults
from ra_tpu_torch.log.meta import MetaApi
from ra_tpu_torch.utils.lib import atomic_write, retry

_FRAME = struct.Struct("<II")  # crc, len


class FileMeta(MetaApi):
    COMPACT_BYTES = 4 * 1024 * 1024

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # failpoint scope label; the owning node sets it to its name
        self.fault_scope = None
        self._lock = threading.Lock()
        self._tab: Dict[str, Dict[str, Any]] = {}
        self._dirty = False
        self._recover()
        self._f = open(self.path, "ab")

    # ------------------------------------------------------------------

    def _recover(self) -> None:
        base = self.path + ".base"
        if os.path.exists(base):
            try:
                self._tab = pickle.loads(open(base, "rb").read())
            except Exception:
                self._tab = {}
        if not os.path.exists(self.path):
            return
        data = open(self.path, "rb").read()
        pos, n = 0, len(data)
        while pos + _FRAME.size <= n:
            crc, ln = _FRAME.unpack_from(data, pos)
            pos += _FRAME.size
            payload = data[pos : pos + ln]
            if len(payload) < ln or (crc and zlib.crc32(payload) != crc):
                break  # torn tail
            pos += ln
            try:
                uid, key, value = pickle.loads(payload)
            except Exception:
                break
            if key == "__deleted__":
                self._tab.pop(uid, None)
            else:
                self._tab.setdefault(uid, {})[key] = value

    def _append(self, uid: str, key: str, value: Any, sync: bool) -> None:
        payload = pickle.dumps((uid, key, value))
        rec = _FRAME.pack(zlib.crc32(payload), len(payload)) + payload
        with self._lock:
            self._tab.setdefault(uid, {})[key] = value
            start = self._f.tell()
            attempt = [0]

            def _write():
                if attempt[0]:
                    # a prior partial write may have left bytes: rewind
                    # SIZE and POSITION to the pre-record offset (seek
                    # matters after compaction reopens the journal in
                    # "wb" mode — truncate alone would leave the write
                    # position past the hole and recovery would stop at
                    # the zero frame, losing the record). First attempts
                    # pay nothing.
                    self._f.truncate(start)
                    self._f.seek(start)
                attempt[0] += 1
                faults.checked_write("meta.append", self._f, rec,
                                     self.fault_scope)

            retry(_write, attempts=3, delay_s=0.02)
            if sync:
                # fdatasync is OUTSIDE the retry on purpose: a failed
                # fsync is poison (the kernel may have dropped dirty
                # pages covering EARLIER records, not just this one) —
                # it must propagate to the caller, never be retried
                # into a false "success" (same rule as Wal._sync)
                self._f.flush()
                os.fdatasync(self._f.fileno())
            else:
                self._dirty = True
            if self._f.tell() > self.COMPACT_BYTES:
                self._compact_locked()

    def _compact_locked(self) -> None:
        atomic_write(self.path + ".base", pickle.dumps(self._tab))
        self._f.close()
        self._f = open(self.path, "wb")

    # ------------------------------------------------------------------

    def store(self, uid: str, key: str, value: Any) -> None:
        self._append(uid, key, value, sync=False)

    def store_sync(self, uid: str, key: str, value: Any) -> None:
        self._append(uid, key, value, sync=True)

    def fetch(self, uid: str, key: str, default: Any = None) -> Any:
        return self._tab.get(uid, {}).get(key, default)

    def sync(self) -> None:
        with self._lock:
            if self._dirty:
                self._f.flush()
                os.fdatasync(self._f.fileno())
                self._dirty = False

    def delete(self, uid: str) -> None:
        self._append(uid, "__deleted__", True, sync=True)
        with self._lock:
            self._tab.pop(uid, None)

    def close(self) -> None:
        self.sync()
        self._f.close()
