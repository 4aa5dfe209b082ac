"""On-disk immutable-ish segment files.

Long-term home of log entries once the WAL rolls over — the counterpart
of the reference's segment files (reference: ``src/ra_log_segment.erl``
— fixed index region + data region, per-entry CRC, sparse reads via
binary search, bounded pending writes). Layout (little-endian):

    header : magic b"RTS1" | max_count u32
    index  : max_count slots of (idx u64 | term u64 | offset u64 |
             length u32 | crc u32)  — slot order = append order
    data   : concatenated payloads

Index slots are written incrementally as entries append (buffered, then
flushed+fsynced on ``sync``). An unfilled slot has idx 0 (indexes are
>= 1), so recovery simply stops at the first empty slot.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ra_tpu_torch import faults
from ra_tpu_torch.utils.lib import retry

MAGIC = b"RTS1"
_HDR = struct.Struct("<4sI")
_SLOT = struct.Struct("<QQQII")


class SegmentWriterHandle:
    """Append handle for one segment file."""

    def __init__(self, path: str, max_count: int = 4096, compute_checksums: bool = True):
        self.path = path
        self.max_count = max_count
        self.compute_checksums = compute_checksums
        self.count = 0
        self.range: Optional[Tuple[int, int]] = None
        exists = os.path.exists(path)
        # transient open failures (EMFILE/EAGAIN bursts) retry with
        # backoff — ra_file parity (reference: src/ra_file.erl:1-37);
        # fsync failures stay poison and are never retried
        self._f = retry(lambda: open(path, "r+b" if exists else "w+b"),
                        attempts=3, delay_s=0.02)
        if not exists or os.path.getsize(path) < _HDR.size:
            self._f.write(_HDR.pack(MAGIC, max_count))
            self._f.write(b"\x00" * (_SLOT.size * max_count))
            self._f.flush()
            self._data_end = self._data_start
        else:
            magic, mc = _HDR.unpack(self._f.read(_HDR.size))
            if magic != MAGIC:
                raise ValueError(f"bad segment magic in {path}")
            self.max_count = mc
            # scan index to find fill level
            idx_bytes = self._f.read(_SLOT.size * mc)
            end = self._data_start
            for i in range(mc):
                idx, term, off, ln, crc = _SLOT.unpack_from(idx_bytes, i * _SLOT.size)
                if idx == 0:
                    break
                self.count += 1
                self.range = (
                    (min(self.range[0], idx), max(self.range[1], idx))
                    if self.range
                    else (idx, idx)
                )
                end = max(end, off + ln)
            self._data_end = end

    @property
    def _data_start(self) -> int:
        return _HDR.size + _SLOT.size * self.max_count

    def is_full(self) -> bool:
        return self.count >= self.max_count

    def append(self, idx: int, term: int, payload: bytes) -> None:
        if self.is_full():
            raise ValueError("segment full")
        crc = zlib.crc32(payload) if self.compute_checksums else 0
        off = self._data_end
        self._f.seek(off)
        # a torn payload write leaves the index slot unwritten (idx 0),
        # so recovery stops cleanly at the previous entry; a torn SLOT
        # is caught by the per-entry CRC on read
        faults.checked_write("segment.append", self._f, payload)
        self._f.seek(_HDR.size + self.count * _SLOT.size)
        self._f.write(_SLOT.pack(idx, term, off, len(payload), crc))
        self._data_end = off + len(payload)
        self.count += 1
        # min/max (not blind extend): appends may arrive out of index
        # order across retry/recovery replays; ranges must never invert
        self.range = (
            (min(self.range[0], idx), max(self.range[1], idx))
            if self.range
            else (idx, idx)
        )

    def sync(self) -> None:
        self._f.flush()
        os.fdatasync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.flush()
        finally:
            self._f.close()


class SegmentReader:
    """Read-only view over one segment file. Two index modes (reference:
    ``src/ra_log_segment.erl:55-59``):

    - ``"map"`` (default): the whole index region is parsed into a dict
      on open — fastest lookups, O(entries) memory per open segment;
    - ``"binary"``: the raw index bytes are kept unparsed and point
      lookups binary-search the slot array (segments are written in
      ascending index order; rewritten out-of-order files detected at
      open fall back to map mode). Sparse external reads over many
      segments stay cheap in memory, and a small read-ahead caches the
      next few entries' payloads per seek (reference read-ahead,
      ``src/ra_log_segment.erl:468-505``).
    """

    READ_AHEAD = 8

    def __init__(self, path: str, compute_checksums: bool = True, mode: str = "map"):
        self.path = path
        self.compute_checksums = compute_checksums
        self.mode = mode
        # reader opens retry like the writer's (ra_file parity): sparse
        # reads race compaction renames, and a transient EMFILE burst
        # must not fail a read that would succeed a moment later
        self._f = retry(lambda: open(path, "rb"), attempts=3, delay_s=0.02)
        magic, mc = _HDR.unpack(self._f.read(_HDR.size))
        if magic != MAGIC:
            raise ValueError(f"bad segment magic in {path}")
        idx_bytes = self._f.read(_SLOT.size * mc)
        self.range: Optional[Tuple[int, int]] = None
        self._ra_cache: Dict[int, Tuple[int, bytes]] = {}
        # count filled slots + establish range/monotonicity in one scan
        n = 0
        lo = hi = None
        monotone = True
        prev = -1
        for i in range(mc):
            idx = _SLOT.unpack_from(idx_bytes, i * _SLOT.size)[0]
            if idx == 0:
                break
            n += 1
            lo = idx if lo is None else min(lo, idx)
            hi = idx if hi is None else max(hi, idx)
            if idx <= prev:
                monotone = False
            prev = idx
        self._n = n
        self._last_read = -2  # sequential-pattern detector for read-ahead
        if lo is not None:
            self.range = (lo, hi)
        if mode == "binary" and monotone:
            self._idx_bytes: Optional[bytes] = idx_bytes
            self.index = _LazyIndex(self)
        else:
            # map mode (or non-monotone rewrites: binary search invalid)
            self.mode = "map"
            self._idx_bytes = None
            self.index = {}
            for i in range(n):
                idx, term, off, ln, crc = _SLOT.unpack_from(idx_bytes, i * _SLOT.size)
                self.index[idx] = (term, off, ln, crc)

    def _slot_pos(self, idx: int) -> int:
        """Binary-search the raw slot array; returns the slot position
        or -1 (binary mode only)."""
        lo, hi = 0, self._n - 1
        b = self._idx_bytes
        while lo <= hi:
            mid = (lo + hi) // 2
            sidx = _SLOT.unpack_from(b, mid * _SLOT.size)[0]
            if sidx == idx:
                return mid
            if sidx < idx:
                lo = mid + 1
            else:
                hi = mid - 1
        return -1

    def _slot_for(self, idx: int) -> Optional[Tuple[int, int, int, int]]:
        pos = self._slot_pos(idx)
        if pos < 0:
            return None
        _sidx, term, off, ln, crc = _SLOT.unpack_from(self._idx_bytes, pos * _SLOT.size)
        return (term, off, ln, crc)

    def _entry(self, idx: int) -> Optional[Tuple[int, int, int, int]]:
        if self._idx_bytes is not None:
            return self._slot_for(idx)
        return self.index.get(idx)

    def term(self, idx: int) -> Optional[int]:
        e = self._entry(idx)
        return e[0] if e else None

    def read(self, idx: int) -> Optional[Tuple[int, bytes]]:
        hit = self._ra_cache.get(idx)
        if hit is not None:
            self._last_read = idx
            return hit
        pos = self._slot_pos(idx) if self._idx_bytes is not None else -1
        if self._idx_bytes is not None:
            if pos < 0:
                return None
            e = _SLOT.unpack_from(self._idx_bytes, pos * _SLOT.size)[1:]
        else:
            e = self.index.get(idx)
            if e is None:
                return None
        term, off, ln, crc = e
        self._f.seek(off)
        payload = self._f.read(ln)
        if self.compute_checksums and crc and zlib.crc32(payload) != crc:
            raise IOError(f"segment crc mismatch at idx {idx} in {self.path}")
        if self._idx_bytes is not None and self._last_read == idx - 1:
            # a forward walk is in progress: prefetch the next slots with
            # ONE contiguous read (slots and data are append-ordered in
            # binary mode)
            self._read_ahead(pos)
        self._last_read = idx
        return term, payload

    def _read_ahead(self, pos: int) -> None:
        self._ra_cache.clear()
        b = self._idx_bytes
        last = min(pos + self.READ_AHEAD, self._n - 1)
        if last <= pos:
            return
        slots = [
            _SLOT.unpack_from(b, i * _SLOT.size)
            for i in range(pos + 1, last + 1)
        ]
        start = slots[0][2]
        end = slots[-1][2] + slots[-1][3]
        self._f.seek(start)
        blob = self._f.read(end - start)
        for sidx, term, off, ln, crc in slots:
            payload = blob[off - start : off - start + ln]
            if len(payload) < ln:
                break
            if self.compute_checksums and crc and zlib.crc32(payload) != crc:
                break
            self._ra_cache[sidx] = (term, payload)

    def indexes(self) -> List[int]:
        if self._idx_bytes is not None:
            out = []
            for i in range(self._n):
                out.append(_SLOT.unpack_from(self._idx_bytes, i * _SLOT.size)[0])
            return out
        return sorted(self.index)

    def close(self) -> None:
        self._f.close()


class _LazyIndex:
    """Binary-mode stand-in for the parsed index dict: supports the
    mapping surface the read/compaction paths use without materializing
    every slot. Deliberately NOT a dict subclass — an unsupported dict
    method must raise, never silently answer from an empty mapping."""

    __slots__ = ("_r",)

    def __init__(self, reader: SegmentReader):
        self._r = reader

    def get(self, idx, default=None):
        e = self._r._slot_for(idx)
        return e if e is not None else default

    def __getitem__(self, idx):
        e = self._r._slot_for(idx)
        if e is None:
            raise KeyError(idx)
        return e

    def __contains__(self, idx):
        return self._r._slot_for(idx) is not None

    def __len__(self):
        return self._r._n

    def __iter__(self):
        return iter(self._r.indexes())

    def keys(self):
        return self._r.indexes()

    def values(self):
        return [self._r._slot_for(i) for i in self._r.indexes()]

    def items(self):
        return [(i, self._r._slot_for(i)) for i in self._r.indexes()]
