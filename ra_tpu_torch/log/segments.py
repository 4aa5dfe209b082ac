"""Per-server set of segment files + open-file cache + compaction.

The role of the reference's ``ra_log_segments`` (segment-ref set, FLRU
fd cache, compaction planning — ``src/ra_log_segments.erl:191-344``).

Compaction tiers:
- snapshot-floor truncation deletes whole segments with no live index
  and no tail, and minor-compacts straddling segments in place;
- **major compaction** groups adjacent below-floor segments that are
  <50% live (by entries or bytes), merges each group's live entries
  into the group's first segment, and turns the rest into symlinks —
  crash-safe via the reference's marker protocol
  (``docs/internals/COMPACTION.md:144-176``): write a
  ``<first>.compaction_group`` manifest, build ``<first>.compacting``,
  atomic-rename over the first segment, then symlink the others and
  delete the manifest. Recovery inspects the manifest to tell a
  pre-rename crash (discard partial work) from a post-rename one
  (recreate symlinks).
"""

from __future__ import annotations

import bisect
import os
import pickle
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ra_tpu_torch import faults
from ra_tpu_torch.log.segment import SegmentReader, SegmentWriterHandle
from ra_tpu_torch.protocol import Entry
from ra_tpu_torch.utils.flru import FLRU
from ra_tpu_torch.utils.lib import retry, sync_dir
from ra_tpu_torch.utils.seq import Seq

# symlinks left by major compaction are kept briefly so in-flight
# readers of the old names can finish (reference: ?SYMLINK_KEEPFOR_S,
# src/ra_log_segments.erl:41)
SYMLINK_KEEP_S = 60.0


class SegmentSet:
    def __init__(
        self,
        dir: str,
        open_cache: int = 8,
        index_mode: str = "map",
        readonly: bool = False,
    ):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self.index_mode = index_mode  # "map" | "binary" (low-memory)
        self.readonly = readonly
        self._lock = threading.RLock()
        # filename -> (lo, hi) inclusive range
        self.refs: Dict[str, Tuple[int, int]] = {}
        self._cache: FLRU[str, SegmentReader] = FLRU(
            open_cache, on_evict=lambda k, r: r.close()
        )
        # interval index over refs for O(log n) point lookups (the
        # reference keeps segment refs in a sorted ra_lol structure,
        # src/ra_log_segments.erl:64-66): items sorted by lo, plus a
        # prefix-max of hi so the left-walk prunes immediately
        self._items: List[Tuple[int, int, str]] = []
        self._los: List[int] = []
        self._pmax: List[int] = []
        # a readonly view (external ReadPlan.execute) must not run crash
        # recovery: unlinking the owning process's in-flight .compacting
        # temp or .compaction_group marker would abort its live pass
        if not readonly:
            self._recover_compaction()
        for f in sorted(os.listdir(dir)):
            p = os.path.join(dir, f)
            if f.endswith(".segment") and not os.path.islink(p):
                try:
                    r = SegmentReader(p)
                except (ValueError, OSError, struct.error):
                    # struct.error: shorter than its header and index
                    # region, which the segment writer writes before any
                    # entry, so a file it is still creating: no entry is
                    # in it yet, and its range comes with the writer's
                    # notification
                    continue
                if r.range:
                    self.refs[f] = r.range
                r.close()
        self._rebuild_interval_index()

    def _rebuild_interval_index(self) -> None:
        items = sorted((rng[0], rng[1], f) for f, rng in self.refs.items())
        self._items = items
        self._los = [it[0] for it in items]
        pmax: List[int] = []
        m = -1
        for _lo, hi, _f in items:
            m = max(m, hi)
            pmax.append(m)
        self._pmax = pmax

    def _recover_compaction(self) -> None:
        """Finish or roll back a major compaction interrupted by a crash
        (reference recovery table, COMPACTION.md:168-176)."""
        listing = sorted(os.listdir(self.dir))
        markers = {f[: -len(".compaction_group")] for f in listing
                   if f.endswith(".compaction_group")}
        for f in listing:
            if f.endswith(".segment.compacting"):
                # minor-compaction temp: always safe to discard
                os.unlink(os.path.join(self.dir, f))
                continue
            if (
                f.endswith(".compacting")
                and f[: -len(".compacting")] not in markers
            ):
                # major temp created before its marker: roll back
                os.unlink(os.path.join(self.dir, f))
                continue
            if not f.endswith(".compaction_group"):
                continue
            marker = os.path.join(self.dir, f)
            try:
                with open(marker, "rb") as m:
                    files = pickle.load(m)
            except Exception:  # noqa: BLE001 — torn marker: roll back
                files = []
            tmp = marker[: -len(".compaction_group")] + ".compacting"
            if len(files) < 2 or os.path.exists(tmp):
                # pre-rename crash (or undecidable): discard partial
                # work, originals are intact
                if os.path.exists(tmp):
                    os.unlink(tmp)
            else:
                # rename completed: the first segment holds the merged
                # data; recreate the symlinks (idempotent)
                first = files[0]
                for other in files[1:]:
                    p = os.path.join(self.dir, other)
                    if os.path.islink(p):
                        continue
                    if os.path.exists(p):
                        os.unlink(p)
                    os.symlink(first, p)
            os.unlink(marker)
        sync_dir(self.dir)

    # -- bookkeeping ------------------------------------------------------

    def add_ref(self, fname: str, rng: Tuple[int, int]) -> None:
        with self._lock:
            self.refs[fname] = rng
            self._cache.evict(fname)  # re-open to see new entries
            self._rebuild_interval_index()

    def num_segments(self) -> int:
        return len(self.refs)

    def _reader(self, fname: str) -> SegmentReader:
        r = self._cache.get(fname)
        if r is None:
            r = SegmentReader(os.path.join(self.dir, fname), mode=self.index_mode)
            self._cache.insert(fname, r)
        return r

    def files_for(self, idx: int) -> List[str]:
        """Newest-first list of files whose range covers idx (later files
        hold rewrites and win). O(log n + matches) via the interval
        index — the hot AER-construction read path must not scan every
        segment ref."""
        j = bisect.bisect_right(self._los, idx) - 1
        out: List[str] = []
        pmax = self._pmax
        items = self._items
        while j >= 0 and pmax[j] >= idx:
            lo, hi, f = items[j]
            if lo <= idx <= hi:
                out.append(f)
            j -= 1
        if len(out) > 1:
            out.sort(reverse=True)
        return out

    # -- reads ------------------------------------------------------------

    def fetch_term(self, idx: int) -> Optional[int]:
        with self._lock:
            for f in self.files_for(idx):
                t = self._reader(f).term(idx)
                if t is not None:
                    return t
        return None

    def fetch(self, idx: int) -> Optional[Entry]:
        with self._lock:
            for f in self.files_for(idx):
                got = self._reader(f).read(idx)
                if got is not None:
                    term, payload = got
                    return Entry(idx, term, pickle.loads(payload))
        return None

    def range(self) -> Optional[Tuple[int, int]]:
        with self._lock:
            if not self.refs:
                return None
            return (
                min(lo for lo, _ in self.refs.values()),
                max(hi for _, hi in self.refs.values()),
            )

    # -- compaction -------------------------------------------------------

    def truncate_below(self, snapshot_idx: int, live: Seq) -> int:
        """Snapshot moved to snapshot_idx: delete segments that hold no
        index above it and no live index; minor-compact segments that
        straddle the floor but keep live/tail entries. Returns number of
        files removed."""
        removed = 0
        with self._lock:
            for f in sorted(self.refs):
                lo, hi = self.refs[f]
                if lo > snapshot_idx:
                    continue
                # live entries below the floor plus the tail above it
                # survive
                keep = live.in_range(lo, hi).union(
                    Seq.from_range(max(lo, snapshot_idx + 1), hi)
                )
                if keep.is_empty():
                    self._cache.evict(f)
                    try:
                        os.unlink(os.path.join(self.dir, f))
                    except OSError:
                        pass
                    del self.refs[f]
                    removed += 1
                elif hi > snapshot_idx and len(keep) < (hi - lo + 1):
                    # only floor-straddling segments are rewritten
                    # inline; fully-below-floor segments keep their dead
                    # entries until a major pass groups them (their
                    # sparseness is the grouping signal — reference
                    # minor compaction likewise only deletes). A failed
                    # rewrite keeps the original (dead-entry GC is
                    # best-effort; the next truncate retries it)
                    try:
                        self._minor_compact(f, keep)
                    except OSError:
                        tmp = os.path.join(self.dir, f + ".compacting")
                        if os.path.exists(tmp):
                            try:
                                os.unlink(tmp)
                            except OSError:
                                pass
            self._rebuild_interval_index()
        return removed

    def _minor_compact(self, fname: str, keep: Seq) -> None:
        """Rewrite fname with only `keep` indexes. Crash-safe: write
        `.compacting`, fsync, atomic-rename over the original."""
        src = self._reader(fname)
        tmp_path = os.path.join(self.dir, fname + ".compacting")
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        w = SegmentWriterHandle(tmp_path, max_count=max(len(keep), 1))
        lo = hi = None
        for idx in keep:
            faults.fire("segments.compact_copy")
            got = src.read(idx)
            if got is None:
                continue
            term, payload = got
            w.append(idx, term, payload)
            lo = idx if lo is None else lo
            hi = idx
        w.sync()
        w.close()
        self._cache.evict(fname)

        def _swap():
            faults.fire("segments.compact_rename")
            os.replace(tmp_path, os.path.join(self.dir, fname))

        retry(_swap, attempts=3, delay_s=0.02)
        if lo is not None:
            self.refs[fname] = (lo, hi)

    # -- major compaction -------------------------------------------------

    def major_compact(
        self,
        snapshot_idx: int,
        live: Seq,
        max_count: int = 4096,
    ) -> Dict[str, List[str]]:
        """Merge groups of sparse below-floor segments (reference:
        take_group <50% live by entries or bytes, respecting max_count;
        src/ra_log_segments.erl:191-344). Returns the reference's result
        shape: {"unreferenced": deleted, "linked": now-symlinks,
        "compacted": rewritten first segments}."""
        result: Dict[str, List[str]] = {
            "unreferenced": [], "linked": [], "compacted": [],
        }
        with self._lock:
            self._prune_symlinks()
            # evaluate oldest-first; only segments entirely below the
            # snapshot floor participate (the tail is still hot)
            candidates: List[Tuple[str, List[int], bool]] = []
            for f in sorted(self.refs):
                lo, hi = self.refs[f]
                if hi > snapshot_idx:
                    continue
                r = self._reader(f)
                live_idx = [i for i in live.in_range(lo, hi) if i in r.index]
                if not live_idx:
                    self._cache.evict(f)
                    try:
                        os.unlink(os.path.join(self.dir, f))
                    except OSError:
                        pass
                    del self.refs[f]
                    result["unreferenced"].append(f)
                    continue
                total = len(r.index)
                live_bytes = sum(r.index[i][2] for i in live_idx)
                total_bytes = sum(e[2] for e in r.index.values()) or 1
                dense = (
                    len(live_idx) / total >= 0.5
                    and live_bytes / total_bytes >= 0.5
                )
                # small files stay groupable even when dense, so the
                # output of earlier major passes keeps folding together
                # (size-tiered behavior; bounds file count near
                # total_live / max_count)
                if total <= max_count // 4:
                    dense = False
                candidates.append((f, live_idx, dense))

            groups: List[List[Tuple[str, List[int]]]] = []
            cur: List[Tuple[str, List[int]]] = []
            cur_count = 0
            for f, live_idx, dense in candidates:
                if dense:
                    # dense segment breaks adjacency: finalize the group
                    if len(cur) > 1:
                        groups.append(cur)
                    cur, cur_count = [], 0
                    continue
                if cur and cur_count + len(live_idx) > max_count:
                    if len(cur) > 1:
                        groups.append(cur)
                    cur, cur_count = [], 0
                cur.append((f, live_idx))
                cur_count += len(live_idx)
            if len(cur) > 1:
                groups.append(cur)
            # the interval index must not outlive the unreferenced-file
            # deletions above: a concurrent reader resolving an index
            # through stale items would open an unlinked file (symlinked
            # names later are fine — they resolve to merged data)
            self._rebuild_interval_index()

        # the merges (candidate reads, entry copies, fsyncs) run OUTSIDE
        # the lock — consensus-path fetch/fetch_term must not block on a
        # disk-bound pass. The marker/symlink protocol already tolerates
        # concurrent readers of the old names; the swap step re-takes
        # the lock and verifies the group is still intact.
        for grp in groups:
            built = self._merge_group_build(grp)
            if built is None:
                continue
            tmp, marker, new_range = built
            with self._lock:
                self._merge_group_swap(
                    [f for f, _ in grp], tmp, marker, new_range, result
                )
        with self._lock:
            self._rebuild_interval_index()
        return result

    def _merge_group_build(self, grp):
        """Unlocked phase of one group merge: durable tmp + manifest,
        then copy live entries via privately-opened readers (the shared
        FLRU cache is lock-guarded). Returns (tmp, marker, range), or
        None after rolling back if a group file vanished concurrently
        (snapshot-floor truncation deleted it)."""
        files = [f for f, _ in grp]
        first = files[0]
        stem = first.split(".")[0]
        marker = os.path.join(self.dir, stem + ".compaction_group")
        tmp = os.path.join(self.dir, stem + ".compacting")
        total = sum(len(li) for _, li in grp)

        # 0. the .compacting inode must exist durably BEFORE the marker:
        # recovery reads "marker present + tmp absent" as "rename
        # completed", so tmp-after-marker ordering would misclassify a
        # crash in between as complete and symlink away unmerged data
        if os.path.exists(tmp):
            os.unlink(tmp)
        with open(tmp, "wb") as t:
            t.flush()
            os.fsync(t.fileno())
        sync_dir(self.dir)

        # 1. durable manifest of the group
        with open(marker, "wb") as m:
            pickle.dump(files, m)
            m.flush()
            os.fsync(m.fileno())
        sync_dir(self.dir)

        # 2. merge all live entries into the .compacting segment
        w = SegmentWriterHandle(tmp, max_count=max(total, 1))
        try:
            for f, live_idx in grp:
                faults.fire("segments.compact_copy")
                r = SegmentReader(os.path.join(self.dir, f), mode=self.index_mode)
                try:
                    for i in live_idx:
                        got = r.read(i)
                        if got is not None:
                            w.append(i, got[0], got[1])
                finally:
                    r.close()
        except (OSError, ValueError):
            w.close()
            self._abort_merge(marker, tmp)
            return None
        w.sync()
        w.close()
        return tmp, marker, w.range

    def _abort_merge(self, marker: str, tmp: str) -> None:
        # marker goes first: a crash between the unlinks must never
        # leave "marker present + tmp absent", which recovery reads as
        # a completed rename
        try:
            os.unlink(marker)
        except OSError:
            pass
        sync_dir(self.dir)
        try:
            os.unlink(tmp)
        except OSError:
            pass

    def _merge_group_swap(self, files, tmp, marker, new_range, result) -> None:
        """Locked phase: verify the group survived, atomic-rename the
        merged data over the first segment, symlink the rest."""
        first = files[0]
        if any(f not in self.refs for f in files):
            # truncation raced us and removed a member: the originals
            # (or their deletions) win; discard the merged tmp
            self._abort_merge(marker, tmp)
            return

        # 3. atomic rename over the FIRST segment (before symlinks, so a
        # reader following a symlink always sees merged data)
        for f in files:
            self._cache.evict(f)

        def _swap():
            faults.fire("segments.compact_rename")
            os.replace(tmp, os.path.join(self.dir, first))

        try:
            retry(_swap, attempts=3, delay_s=0.02)
        except OSError:
            # rename never landed: originals are intact — roll back
            self._abort_merge(marker, tmp)
            return
        sync_dir(self.dir)

        # 4. the rest become symlinks to the first
        for other in files[1:]:
            p = os.path.join(self.dir, other)
            os.unlink(p)
            os.symlink(first, p)
            del self.refs[other]
            result["linked"].append(other)
        sync_dir(self.dir)

        # 5. drop the manifest — compaction is complete
        os.unlink(marker)
        if new_range is not None:
            self.refs[first] = new_range
        result["compacted"].append(first)

    def _prune_symlinks(self) -> None:
        now = time.time()
        for f in os.listdir(self.dir):
            p = os.path.join(self.dir, f)
            if os.path.islink(p):
                try:
                    if now - os.lstat(p).st_mtime > SYMLINK_KEEP_S:
                        os.unlink(p)
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            self._cache.evict_all()
