"""Native (C++) acceleration for the storage and hot-loop runtime paths.

Two libraries, built with g++ on first use (cached ``.so`` next to the
source) and exposed through ctypes bindings:

- ``wal_native``: WAL batch framing + write + fsync;
- ``rt_native``: the hot-loop runtime (docs/INTERNALS.md §18) — ring
  drain classification, mailbox pack scatter, and egress frame sealing.

Everything here has a pure-Python fallback. ``available()`` reports the
WAL library (the historical contract); ``entry_points()`` reports every
loaded symbol so bench artifacts are self-describing. A failed build is
cached per source mtime (a missing compiler does not re-attempt the
build on every import) and surfaces the compiler stderr in ONE warning
instead of a silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "wal_native.cpp")
_SO = os.path.join(_HERE, "wal_native.so")
_RT_SRC = os.path.join(_HERE, "rt_native.cpp")
_RT_SO = os.path.join(_HERE, "rt_native.so")

_lib = None
_lock = threading.Lock()
_tried = False
_rt_lib = None
_rt_tried = False

# negative build cache: src path -> source mtime the failure was seen
# at (a changed source retries; an unchanged one never rebuilds), and
# whether the one-shot warning for it was already emitted
_build_failed: Dict[str, float] = {}
_warned: set = set()


def _build(src: str = _SRC, so: str = _SO) -> Optional[str]:
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    mtime = os.path.getmtime(src)
    if _build_failed.get(src) == mtime:
        return None  # cached negative result for this exact source
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", so, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return so
    except Exception as e:  # noqa: BLE001
        _build_failed[src] = mtime
        if src not in _warned:
            _warned.add(src)
            detail = ""
            if isinstance(e, subprocess.CalledProcessError) and e.stderr:
                detail = e.stderr.decode("utf-8", "replace").strip()
            elif isinstance(e, FileNotFoundError):
                detail = "g++ not found"
            else:
                detail = repr(e)
            print(
                f"ra_tpu_torch.native: build of {os.path.basename(src)} failed; "
                f"falling back to the Python paths "
                f"({detail[:2000]})",
                file=sys.stderr,
            )
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build(_SRC, _SO)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        if not hasattr(lib, "wal_write_batch"):
            return None  # stale cached .so predating the write path
        lib.wal_frame_batch.restype = ctypes.c_long
        lib.wal_frame_batch.argtypes = [
            ctypes.c_char_p,  # kinds u8*
            ctypes.c_void_p,  # refs u16*
            ctypes.c_void_p,  # idxs u64*
            ctypes.c_void_p,  # terms u64*
            ctypes.c_void_p,  # offs u64*
            ctypes.c_void_p,  # lens u32*
            ctypes.c_long,
            ctypes.c_char_p,  # blob
            ctypes.c_int,
            ctypes.c_void_p,  # out
            ctypes.c_long,
        ]
        lib.wal_frame_bound.restype = ctypes.c_long
        lib.wal_frame_bound.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long]
        lib.wal_crc32.restype = ctypes.c_uint32
        lib.wal_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.wal_write_batch.restype = ctypes.c_long
        lib.wal_write_batch.argtypes = [
            ctypes.c_char_p,  # kinds u8*
            ctypes.c_void_p,  # refs u16*
            ctypes.c_void_p,  # idxs u64*
            ctypes.c_void_p,  # terms u64*
            ctypes.c_void_p,  # offs u64*
            ctypes.c_void_p,  # lens u32*
            ctypes.c_long,
            ctypes.c_char_p,  # blob
            ctypes.c_int,     # compute_crc
            ctypes.c_int,     # fd
            ctypes.c_int,     # sync_mode
            ctypes.c_void_p,  # fsync_ns out
        ]
        _lib = lib
        return _lib


def _load_rt():
    global _rt_lib, _rt_tried
    with _lock:
        if _rt_tried:
            return _rt_lib
        _rt_tried = True
        so = _build(_RT_SRC, _RT_SO)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        if not hasattr(lib, "rt_seal_frames"):
            return None  # stale cached .so
        lib.rt_classify.restype = ctypes.c_long
        lib.rt_classify.argtypes = [
            ctypes.c_char_p,  # codes u8*
            ctypes.c_long,    # n
            ctypes.c_long,    # n_classes
            ctypes.c_void_p,  # out_idx i32*
            ctypes.c_void_p,  # counts i32*
        ]
        lib.rt_pack_mbox.restype = ctypes.c_long
        lib.rt_pack_mbox.argtypes = [
            ctypes.c_void_p,  # vals i64*
            ctypes.c_void_p,  # cols i32*
            ctypes.c_long,    # n
            ctypes.c_void_p,  # rows i32*
            ctypes.c_long,    # nf
            ctypes.c_void_p,  # out i32*
            ctypes.c_long,    # nrows
            ctypes.c_long,    # width
        ]
        lib.rt_seal_frames.restype = ctypes.c_long
        lib.rt_seal_frames.argtypes = [
            ctypes.c_char_p,  # blob
            ctypes.c_void_p,  # offs u64*
            ctypes.c_void_p,  # lens u32*
            ctypes.c_long,    # n
            ctypes.c_char_p,  # key
            ctypes.c_long,    # keylen
            ctypes.c_long,    # mac_len
            ctypes.c_void_p,  # out
            ctypes.c_long,    # out_cap
        ]
        _rt_lib = lib
        return _rt_lib


def available() -> bool:
    """Whether the native WAL library is loaded (historical contract —
    the Wal's construction-time gate). The runtime entry points report
    through ``entry_points()``."""
    return _load() is not None


def entry_points() -> Dict[str, bool]:
    """Which native entry points actually loaded, keyed by the seam
    they serve — recorded into bench JSON so artifacts are
    self-describing, and consulted by the coordinator's per-path
    switches."""
    wal = _load() is not None
    rt = _load_rt() is not None
    return {
        "wal": wal,
        "pack": rt,
        "classify": rt,
        "egress": rt,
    }


# record: (kind:int, ref:int, idx:int, term:int, payload:bytes), or a
# contiguous run (K_RUN, ref, first_idx, terms_list, payloads_list) that
# expands to per-entry K_ENTRY frames (mirrors ra_tpu_torch.log.wal.K_RUN)
Record = Tuple[int, int, int, int, bytes]
K_RUN = 100
_K_ENTRY = 2


def _pack_arrays(records: List[Record]):
    """Expand records (runs widened) into the parallel column arrays +
    payload blob the native entry points consume."""
    n = 0
    for r in records:
        n += len(r[4]) if r[0] == K_RUN else 1
    kinds = np.empty(n, np.uint8)
    refs = np.empty(n, np.uint16)
    idxs = np.empty(n, np.uint64)
    terms = np.empty(n, np.uint64)
    lens = np.empty(n, np.uint32)
    parts = []
    i = 0
    for rec in records:
        kind = rec[0]
        if kind == K_RUN:
            # vectorized fill for the whole run — one Python round per
            # contiguous append run instead of one per entry
            _, ref, first, run_terms, payloads = rec
            m = len(payloads)
            sl = slice(i, i + m)
            kinds[sl] = _K_ENTRY
            refs[sl] = ref
            idxs[sl] = np.arange(first, first + m, dtype=np.uint64)
            terms[sl] = run_terms
            lens[sl] = [len(p) for p in payloads]
            parts.extend(payloads)
            i += m
        else:
            _, ref, idx, term, payload = rec
            kinds[i] = kind
            refs[i] = ref
            idxs[i] = idx
            terms[i] = term
            lens[i] = len(payload)
            parts.append(payload)
            i += 1
    offs = np.empty(n, np.uint64)
    if n:
        offs[0] = 0
        np.cumsum(lens[:-1], dtype=np.uint64, out=offs[1:])
    return n, kinds, refs, idxs, terms, offs, lens, b"".join(parts)


def frame_batch(records: List[Record], compute_crc: bool = True) -> Optional[bytes]:
    """Frame a WAL batch natively; None when the native lib is absent."""
    lib = _load()
    if lib is None or not records:
        return None if lib is None else b""
    n, kinds, refs, idxs, terms, offs, lens, blob = _pack_arrays(records)
    bound = lib.wal_frame_bound(
        kinds.ctypes.data_as(ctypes.c_char_p), lens.ctypes.data, n
    )
    out = ctypes.create_string_buffer(bound)
    w = lib.wal_frame_batch(
        kinds.ctypes.data_as(ctypes.c_char_p),
        refs.ctypes.data,
        idxs.ctypes.data,
        terms.ctypes.data,
        offs.ctypes.data,
        lens.ctypes.data,
        n,
        blob,
        1 if compute_crc else 0,
        ctypes.cast(out, ctypes.c_void_p),
        bound,
    )
    if w < 0:
        return None
    return out.raw[:w]


_SYNC_MODES = {"none": 0, "datasync": 1, "sync": 2}


def write_batch(
    records: List[Record], fd: int, sync_method: str,
    compute_crc: bool = True,
) -> Optional[Tuple[int, int]]:
    """Frame + write + fsync a whole WAL batch natively against ``fd``
    (one call, no Python-side byte assembly; the GIL is released for
    the duration). Returns ``(bytes_written, fsync_wait_ns)``; None
    when the native lib is absent, the batch is malformed, or the sync
    method is unknown (callers fall back to the Python path). Raises
    OSError (errno preserved) on write/fsync failure — fsync failure
    poisons the file exactly as the Python path's rule demands."""
    lib = _load()
    mode = _SYNC_MODES.get(sync_method)
    if lib is None or mode is None:
        return None
    if not records:
        return (0, 0)
    n, kinds, refs, idxs, terms, offs, lens, blob = _pack_arrays(records)
    fsync_ns = ctypes.c_longlong(0)
    w = lib.wal_write_batch(
        kinds.ctypes.data_as(ctypes.c_char_p),
        refs.ctypes.data,
        idxs.ctypes.data,
        terms.ctypes.data,
        offs.ctypes.data,
        lens.ctypes.data,
        n,
        blob,
        1 if compute_crc else 0,
        fd,
        mode,
        ctypes.byref(fsync_ns),
    )
    if w <= -1000:
        err = -(w + 1000)
        raise OSError(err, os.strerror(err))
    if w < 0:
        return None
    return int(w), int(fsync_ns.value)


def crc32(data: bytes) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    return int(lib.wal_crc32(data, len(data)))


# -- hot-loop runtime bindings (rt_native.so) -------------------------------

# number of ring item classes (ra_tpu_torch.protocol RC_* codes)
N_CLASSES = 6


def classify(codes, n: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Partition ``n`` drained ring items by their class-code sidecar
    (``codes``: a bytes/bytearray of length >= n). Returns ``(idx,
    counts)`` — ``idx`` holds the item indexes grouped by class in
    arrival order, class k occupying ``idx[counts[:k].sum() :
    +counts[k]]`` — or None when the native lib is absent or a code is
    out of range (caller falls back to the Python loop)."""
    lib = _load_rt()
    if lib is None or n <= 0:
        return None
    idx = np.empty(n, np.int32)
    counts = np.empty(N_CLASSES, np.int32)
    rc = lib.rt_classify(
        codes if isinstance(codes, bytes) else bytes(codes[:n]),
        n,
        N_CLASSES,
        idx.ctypes.data,
        counts.ctypes.data,
    )
    if rc < 0:
        return None
    return idx, counts


def pack_mbox(packed: np.ndarray, cols, vals, rows: np.ndarray) -> bool:
    """Scatter per-message field values into the packed int32 mailbox:
    ``packed[rows[f], cols[k]] = vals[k * len(rows) + f]`` — one
    GIL-released call for the whole message class. ``vals`` is the
    flat row-major int64 value list (len(cols) * len(rows)); ``rows``
    the int32 mailbox row indexes. Returns False when the native lib
    is absent or the scatter is out of bounds (caller falls back to
    the columnwise numpy stores)."""
    lib = _load_rt()
    if lib is None:
        return False
    cols_a = np.asarray(cols, np.int32)
    vals_a = np.asarray(vals, np.int64)
    n = len(cols_a)
    if n == 0:
        return True
    if len(vals_a) != n * len(rows) or not packed.flags.c_contiguous:
        return False
    rc = lib.rt_pack_mbox(
        vals_a.ctypes.data,
        cols_a.ctypes.data,
        n,
        rows.ctypes.data,
        len(rows),
        packed.ctypes.data,
        packed.shape[0],
        packed.shape[1],
    )
    return rc == 0


def seal_frames(payloads: List[bytes], key: bytes,
                mac_len: int = 16) -> Optional[bytes]:
    """Batch-seal egress wire frames: for each payload, the u32-LE
    length prefix + truncated HMAC-SHA256(key, payload) MAC + payload,
    concatenated — byte-identical to the Python per-frame path of
    ``TcpTransport`` (_LEN.pack + _seal). One GIL-released call for
    the whole per-destination batch. None when the native lib is
    absent (caller falls back)."""
    lib = _load_rt()
    if lib is None:
        return None
    n = len(payloads)
    if n == 0:
        return b""
    lens = np.fromiter((len(p) for p in payloads), np.uint32, n)
    offs = np.empty(n, np.uint64)
    offs[0] = 0
    np.cumsum(lens[:-1], dtype=np.uint64, out=offs[1:])
    blob = b"".join(payloads)
    bound = int(lens.sum()) + n * (4 + mac_len)
    out = ctypes.create_string_buffer(bound)
    w = lib.rt_seal_frames(
        blob,
        offs.ctypes.data,
        lens.ctypes.data,
        n,
        key,
        len(key),
        mac_len,
        ctypes.cast(out, ctypes.c_void_p),
        bound,
    )
    if w < 0:
        return None
    return out.raw[:w]
