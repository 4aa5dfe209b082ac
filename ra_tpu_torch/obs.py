"""Observability: log-bucketed histograms, flight recorder, exposition.

The measurement layer for ROADMAP item 2 ("publish a top-5 cost table"):
before any commit/read optimization ports (arxiv 1905.10786), the wave
loop and the commit path need per-phase timing and a post-mortem trace.
Three primitives, all safe on the hot path:

- :class:`LogHistogram` — HdrHistogram-style log-bucketed latency
  histogram (power-of-two octaves with linear sub-buckets, int64 numpy
  slots, same single-writer discipline as ``ra_tpu_torch.counters.Counters``).
  Relative quantile error is bounded by ``1/SUB_BUCKETS`` (~3.1%).
  Values are recorded in NANOSECONDS; exports convert.

- :class:`FlightRecorder` — bounded ring buffer of structured events
  (role changes, elections, depositions, snapshot installs, watchdog
  strikes, admission rejects, failpoint fires, WAL failures, health
  transitions, phi suspect/unsuspect flips) with
  monotonic timestamps, group id and term. Appends are lock-free
  (CPython: slot assignment is atomic; sequence numbers come from an
  ``itertools.count``, whose ``next`` is atomic), so any thread —
  detector, WAL writer, step loop — may record. Reads are best-effort
  snapshots, exactly like counter reads.

- exposition — ``prometheus_text()`` renders every registered counter
  (with the kind/help from its field specs) and histogram (as a summary
  with p50/p90/p99/p99.9 quantiles in seconds) in Prometheus text
  format; ``api.system_overview`` bundles the same data as one dict
  (parity with the reference's ``ra:overview/1`` over seshat counters).

The reference keeps this layer in ``ra_counters``/seshat plus the
per-server overview (``src/ra.erl`` overview/1); a TPU-batched hot path
additionally needs distributions (one smoothed gauge cannot answer
"where do 92.5 ms go") and a wave-phase breakdown, recorded here.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# log-bucketed histogram

SUB_BITS = 5
SUB_BUCKETS = 1 << SUB_BITS  # linear sub-buckets per power-of-two octave
# enough buckets for any int64 nanosecond value (shift <= 63 - SUB_BITS)
N_BUCKETS = ((64 - SUB_BITS) << SUB_BITS) + SUB_BUCKETS


def bucket_of(v: int) -> int:
    """Bucket index for a non-negative int. Buckets are exact below
    ``SUB_BUCKETS`` and cover ``[lo, lo + 2**shift)`` ranges above, with
    ``SUB_BUCKETS`` linear sub-buckets per octave (HdrHistogram
    bucketing; max relative error 1/SUB_BUCKETS)."""
    if v < SUB_BUCKETS:
        return v if v >= 0 else 0
    shift = v.bit_length() - 1 - SUB_BITS
    b = ((shift + 1) << SUB_BITS) + ((v >> shift) - SUB_BUCKETS)
    return b if b < N_BUCKETS else N_BUCKETS - 1


def bucket_bounds(b: int) -> Tuple[int, int]:
    """Inclusive [lo, hi] value range of bucket ``b`` (inverse of
    :func:`bucket_of`)."""
    if b < SUB_BUCKETS:
        return b, b
    shift = (b >> SUB_BITS) - 1
    lo = ((b & (SUB_BUCKETS - 1)) + SUB_BUCKETS) << shift
    return lo, lo + (1 << shift) - 1


class LogHistogram:
    """Lock-free log-bucketed histogram (single-writer slots, like
    ``Counters``; readers may see slightly stale values). Records
    non-negative integers — by convention nanoseconds.

    ``locked=True`` adds a writer lock for histograms shared by
    CONCURRENT writers (e.g. the per-node commit-stage family, written
    by every actor server on the node across scheduler worker threads
    plus any coordinator step thread): ``arr[b] += n`` is a
    read-modify-write, so multi-writer updates would lose increments
    and drift ``n``/``total`` from the bucket sums. Recording is
    sampled on those paths, so the lock is off the per-command cost."""

    __slots__ = ("name", "help", "unit", "arr", "n", "total", "max_v",
                 "_lock")

    def __init__(self, name, help: str = "", unit: str = "ns",
                 locked: bool = False):
        self.name = name
        self.help = help
        self.unit = unit
        self.arr = np.zeros(N_BUCKETS, dtype=np.int64)
        self.n = 0
        self.total = 0
        self.max_v = 0
        self._lock = threading.Lock() if locked else None

    def record(self, v: int, count: int = 1) -> None:
        v = int(v)
        if v < 0:
            v = 0
        if v < SUB_BUCKETS:
            b = v
        else:
            shift = v.bit_length() - 1 - SUB_BITS
            b = ((shift + 1) << SUB_BITS) + ((v >> shift) - SUB_BUCKETS)
            if b >= N_BUCKETS:
                b = N_BUCKETS - 1
        lock = self._lock
        if lock is not None:
            with lock:
                self.arr[b] += count
                self.n += count
                self.total += v * count
                if v > self.max_v:
                    self.max_v = v
            return
        self.arr[b] += count
        self.n += count
        self.total += v * count
        if v > self.max_v:
            self.max_v = v

    def record_seconds(self, s: float, count: int = 1) -> None:
        self.record(int(s * 1e9), count)

    # -- reads -------------------------------------------------------------

    def percentile(self, p: float) -> int:
        """Value at percentile ``p`` (0..100), as the midpoint of the
        covering bucket; 0 when empty."""
        return self.percentiles((p,))[0]

    def percentiles(self, ps: Sequence[float]) -> List[int]:
        counts = self.arr.copy()  # snapshot: writer may race the scan
        total = int(counts.sum())
        if total == 0:
            return [0] * len(ps)
        cum = np.cumsum(counts)
        out = []
        for p in ps:
            # rank of the p-th percentile observation (1-based)
            rank = max(1, min(total, int(np.ceil(p / 100.0 * total))))
            b = int(np.searchsorted(cum, rank))
            lo, hi = bucket_bounds(b)
            out.append((lo + hi) // 2)
        return out

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def to_dict(self) -> Dict[str, Any]:
        """Summary percentiles in milliseconds (assuming ns records)."""
        p50, p90, p99, p999 = self.percentiles((50, 90, 99, 99.9))
        return {
            "count": self.n,
            "sum_ms": round(self.total / 1e6, 3),
            "mean_ms": round(self.mean() / 1e6, 4),
            "max_ms": round(self.max_v / 1e6, 3),
            "p50_ms": round(p50 / 1e6, 4),
            "p90_ms": round(p90 / 1e6, 4),
            "p99_ms": round(p99 / 1e6, 4),
            "p99_9_ms": round(p999 / 1e6, 4),
        }

    def nonzero_buckets(self) -> List[Tuple[int, int, int]]:
        """(lo, hi, count) for every non-empty bucket (debug/export)."""
        idx = np.flatnonzero(self.arr)
        return [(*bucket_bounds(int(b)), int(self.arr[b])) for b in idx]

    def merge(self, other: "LogHistogram") -> None:
        """Fold another histogram's buckets into this one (aggregation
        across nodes/shards; both must use the same unit)."""
        self.arr += other.arr
        self.n += other.n
        self.total += other.total
        if other.max_v > self.max_v:
            self.max_v = other.max_v

    def reset(self) -> None:
        self.arr[:] = 0
        self.n = 0
        self.total = 0
        self.max_v = 0


class HistogramRegistry:
    """Process-global registry: name -> LogHistogram (mirrors
    CounterRegistry; ``new`` returns the existing histogram when the
    name is already registered)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tab: Dict[object, LogHistogram] = {}

    def new(self, name, help: str = "", unit: str = "ns",
            locked: bool = False) -> LogHistogram:
        with self._lock:
            h = self._tab.get(name)
            if h is None:
                h = LogHistogram(name, help=help, unit=unit, locked=locked)
                self._tab[name] = h
            return h

    def fetch(self, name) -> Optional[LogHistogram]:
        with self._lock:
            return self._tab.get(name)

    def delete(self, name) -> None:
        with self._lock:
            self._tab.pop(name, None)

    def names(self) -> List[object]:
        with self._lock:
            return list(self._tab.keys())

    def overview(self) -> Dict[object, Dict[str, Any]]:
        with self._lock:
            items = list(self._tab.items())
        return {k: h.to_dict() for k, h in items if h.n}


_hists = HistogramRegistry()


def histograms() -> HistogramRegistry:
    return _hists


def histogram(name, help: str = "", unit: str = "ns",
              locked: bool = False) -> LogHistogram:
    return _hists.new(name, help=help, unit=unit, locked=locked)


# -- well-known histogram families ------------------------------------------

# coordinator wave-loop phases (per step; docs/INTERNALS.md §13).
# WAVE_STEP_PHASES are DISJOINT slices of one coordinator step — they
# sum to the step-loop wall time and are the share denominator in
# attribution tools; WAVE_SUBSET_PHASES are finer-grained views RECORDED
# WITHIN a step phase (never added to the denominator). profile_wave.py
# derives its tables from these, so a new phase lands there for free.
WAVE_STEP_PHASES = (
    ("ingress_drain", "drain ingress queues + route messages + append "
                      "client commands (includes WAL handoff)"),
    ("host_pack", "apply queued device scatters + pack the mailbox"),
    ("device_step", "fused consensus step dispatch + egress host sync"),
    ("host_egress", "realise egress: acks, role changes, apply, replies"),
    ("aer_fanout", "build + send outbound AER batches"),
)
WAVE_SUBSET_PHASES = {
    "apply": "subset of host_egress (machine apply, sampled groups)",
    "wal_handoff": "subset of ingress_drain (log.append hand-off, "
                   "sampled groups)",
    "classify_native": "subset of ingress_drain (GIL-released native "
                       "class partition of the drained burst; zero "
                       "samples when the native path is off)",
    "pack_native": "subset of host_pack (GIL-released native mailbox "
                   "scatter; zero samples when the native path is off)",
}
WAVE_PHASES = WAVE_STEP_PHASES + tuple(WAVE_SUBSET_PHASES.items())

# commit-latency decomposition stages (sampled per command; both backends)
COMMIT_STAGES = (
    ("submit_append", "client submit -> leader log append"),
    ("append_durable", "log append -> WAL durable watermark covers it"),
    ("durable_commit", "durable -> quorum commit observed"),
    ("commit_apply", "commit observed -> machine apply done"),
    ("apply_reply", "machine apply -> client reply issued"),
)


def wave_hists(node_name: str) -> Dict[str, LogHistogram]:
    return {
        ph: histogram(("wave", node_name, ph), help=h)
        for ph, h in WAVE_PHASES
    }


def staleness_hist(node_name: str) -> LogHistogram:
    """Observed staleness bound claimed at each bounded local read
    (api.local_query max_staleness_s path, docs/INTERNALS.md §20) —
    recorded in ns of leader wall time, whether the read was served or
    rejected, so the distribution shows how fresh followers really run."""
    return histogram(
        ("follower_read_staleness", node_name),
        help="leader-stamped staleness bound evaluated for bounded "
             "local reads (max_staleness_s, docs/INTERNALS.md §20)",
        locked=True,
    )


def commit_hists(node_name: str) -> Dict[str, LogHistogram]:
    # locked: one family per NODE, but every actor server on the node
    # (scheduler worker threads) and any coordinator step thread write
    # it concurrently — recording is sampled, so the lock is cheap
    return {
        st: histogram(("commit", node_name, st), help=h, locked=True)
        for st, h in COMMIT_STAGES
    }


# ---------------------------------------------------------------------------
# flight recorder


class FlightRecorder:
    """Bounded ring of structured events for post-mortem debugging.

    Events: ``(t_monotonic, seq, kind, node, group, term, detail)``.
    Appends are lock-free and safe from any thread; the ring holds the
    most recent ``capacity`` events. ``dump()`` renders them oldest
    first — the shape a liveness flake is debugged from."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._slots: List[Optional[Tuple]] = [None] * capacity
        self._ctr = itertools.count()

    def record(self, kind: str, node: Optional[str] = None,
               group: Optional[str] = None, term: Optional[int] = None,
               detail: Any = None) -> None:
        n = next(self._ctr)  # atomic in CPython
        self._slots[n % self.capacity] = (
            time.monotonic(), n, kind, node, group, term, detail
        )

    def events(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """Events oldest -> newest (optionally only the last ``n``)."""
        got = [s for s in list(self._slots) if s is not None]
        got.sort(key=lambda s: s[1])
        if last is not None:
            got = got[-last:]
        return [
            {"ts": s[0], "seq": s[1], "kind": s[2], "node": s[3],
             "group": s[4], "term": s[5], "detail": s[6]}
            for s in got
        ]

    def clear(self) -> None:
        self._slots = [None] * self.capacity

    def dump(self, file=None, last: int = 200, header: str = "") -> None:
        """Human-readable dump of the most recent events (stderr by
        default) — called automatically when a kv_harness/nemesis run
        fails so liveness flakes arrive with their trace attached."""
        f = file or sys.stderr
        evts = self.events(last=last)
        print(f"-- flight recorder dump ({len(evts)} events){header} --",
              file=f)
        if not evts:
            print("   (no events recorded)", file=f)
            return
        t0 = evts[0]["ts"]
        for e in evts:
            grp = f" group={e['group']}" if e["group"] is not None else ""
            trm = f" term={e['term']}" if e["term"] is not None else ""
            det = f" {e['detail']}" if e["detail"] is not None else ""
            print(
                f"  +{e['ts'] - t0:9.3f}s #{e['seq']:<6d} "
                f"{e['kind']:<18s} node={e['node']}{grp}{trm}{det}",
                file=f,
            )


_recorder = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _recorder


def record_event(kind: str, node: Optional[str] = None,
                 group: Optional[str] = None, term: Optional[int] = None,
                 detail: Any = None) -> None:
    _recorder.record(kind, node=node, group=group, term=term, detail=detail)


# ---------------------------------------------------------------------------
# trace buffer (Chrome/Perfetto trace-event export)


class TraceBuffer:
    """Bounded ring of completed phase spans, exported as Chrome trace
    events (``chrome://tracing`` / Perfetto JSON) so wave-phase overlap
    is VISIBLE on a timeline — the verification surface the coordinator
    step-pipelining work (ROADMAP item 2) needs: histograms say how
    long ``device_step`` takes, the trace shows whether it overlaps
    ``host_egress`` of the previous step.

    Span recording follows the flight-recorder discipline: lock-free
    appends (atomic slot store + ``itertools.count``), timestamps from
    ``time.perf_counter_ns()`` (the clock the wave loop already reads),
    safe from any thread. Disabled by default — the step loop pays one
    attribute check per step until ``enable()`` (profile_wave --trace,
    tests, or an operator turning it on live)."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.enabled = False
        self._slots: List[Optional[Tuple]] = [None] * capacity
        self._ctr = itertools.count()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._slots = [None] * self.capacity
        self._ctr = itertools.count()

    def span(self, name: str, pid: str, ts_ns: int, dur_ns: int,
             tid: Optional[str] = None, cat: str = "wave") -> None:
        """Record one completed span (begin at ``ts_ns``, ``dur_ns``
        long; perf_counter_ns clock). ``pid`` groups lanes per node,
        ``tid`` is the lane (defaults to the span name)."""
        n = next(self._ctr)  # atomic in CPython
        self._slots[n % self.capacity] = (
            ts_ns, dur_ns, name, pid, tid or name, cat, n
        )

    def spans(self) -> List[Tuple]:
        got = [s for s in list(self._slots) if s is not None]
        got.sort(key=lambda s: (s[0], s[6]))
        return got

    def to_chrome(self) -> Dict[str, Any]:
        """Render the ring as a Chrome trace-event document: matched
        B/E pairs per (pid, tid) lane plus process/thread metadata.
        Timestamps are microsecond floats relative to the earliest
        span (the format's expectation)."""
        spans = self.spans()
        events: List[Dict[str, Any]] = []
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}
        t0 = spans[0][0] if spans else 0
        for ts_ns, dur_ns, name, pid_s, tid_s, cat, _n in spans:
            pid = pids.setdefault(pid_s, len(pids) + 1)
            tkey = (pid_s, tid_s)
            if tkey not in tids:
                tids[tkey] = len(tids) + 1
            tid = tids[tkey]
            ts_us = (ts_ns - t0) / 1e3
            events.append({"name": name, "cat": cat, "ph": "B",
                           "ts": ts_us, "pid": pid, "tid": tid})
            events.append({"name": name, "cat": cat, "ph": "E",
                           "ts": ts_us + max(dur_ns, 0) / 1e3,
                           "pid": pid, "tid": tid})
        meta = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": pid_s}}
            for pid_s, pid in pids.items()
        ] + [
            {"name": "thread_name", "ph": "M", "pid": pids[pid_s],
             "tid": tid, "args": {"name": tid_s}}
            for (pid_s, tid_s), tid in tids.items()
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns the number
        of span events written (excluding metadata)."""
        import json

        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


_trace = TraceBuffer()


def trace_buffer() -> TraceBuffer:
    return _trace


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural validation of a Chrome trace document (the obs_smoke
    gate and the tests both run dumped files through this): span events
    must carry numeric ts/pid/tid, every lane's B/E events must nest
    and match, and each lane's begin timestamps must be monotone.
    Returns a list of problems (empty == well-formed)."""
    errors: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        return ["traceEvents missing or not a list"]
    lanes: Dict[Tuple, List] = {}
    for i, e in enumerate(doc["traceEvents"]):
        ph = e.get("ph")
        if ph == "M":
            continue
        if ph not in ("B", "E", "X", "i", "I"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts != ts or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if not isinstance(e.get("pid"), int) or not isinstance(
            e.get("tid"), int
        ):
            errors.append(f"event {i}: non-int pid/tid")
            continue
        lanes.setdefault((e["pid"], e["tid"]), []).append(
            (ts, ph, e.get("name"), i)
        )
    for lane, evts in lanes.items():
        stack: List[Tuple] = []
        last_b = -1.0
        for ts, ph, name, i in evts:  # events are emitted in ts order
            if ph == "B":
                if ts < last_b:
                    errors.append(
                        f"lane {lane}: non-monotone begin at event {i}"
                    )
                last_b = ts
                stack.append((name, ts))
            elif ph == "E":
                if not stack:
                    errors.append(f"lane {lane}: E without B at event {i}")
                    continue
                b_name, b_ts = stack.pop()
                if name is not None and b_name != name:
                    errors.append(
                        f"lane {lane}: mismatched span {b_name!r}/"
                        f"{name!r} at event {i}"
                    )
                if ts < b_ts:
                    errors.append(
                        f"lane {lane}: span {name!r} ends before it "
                        f"begins at event {i}"
                    )
        if stack:
            errors.append(
                f"lane {lane}: {len(stack)} unmatched B events"
            )
    return errors


# ---------------------------------------------------------------------------
# exposition


def _metric_name(name) -> str:
    """Flatten a registry key into a Prometheus metric-name suffix."""
    if isinstance(name, tuple):
        flat = "_".join(str(p) for p in name)
    else:
        flat = str(name)
    return "".join(c if c.isalnum() or c == "_" else "_" for c in flat)


def _label_of(name) -> str:
    s = str(name).replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")
    return f'name="{s}"'


def prometheus_text() -> str:
    """Prometheus text exposition of every registered counter vector and
    histogram. Counters keep their field kind/help (the describe() path
    ``overview()`` drops); histograms export as summaries in SECONDS
    plus ``_count``/``_sum``."""
    from ra_tpu_torch import counters as _counters

    out: List[str] = []
    # counters: one metric family per field name; vectors become labels.
    # Collect (field -> kind, help, [(owner, value)]) across the registry.
    fields: Dict[str, Tuple[str, str, List[Tuple[object, int]]]] = {}
    reg = _counters.registry()
    for owner in reg.names():
        c = reg.fetch(owner)
        if c is None:
            continue
        vals = c.to_dict()
        for fname, kind, help_txt in c.fields:
            ent = fields.get(fname)
            if ent is None:
                ent = fields[fname] = (kind, help_txt, [])
            ent[2].append((owner, vals[fname]))
    for fname in sorted(fields):
        kind, help_txt, rows = fields[fname]
        metric = f"ra_{_metric_name(fname)}"
        out.append(f"# HELP {metric} {help_txt}")
        out.append(f"# TYPE {metric} {'counter' if kind == 'counter' else 'gauge'}")
        for owner, v in rows:
            out.append(f"{metric}{{{_label_of(owner)}}} {v}")
    # histograms: summaries with fixed quantiles, values in seconds
    for name in sorted(_hists.names(), key=str):
        h = _hists.fetch(name)
        if h is None:
            continue
        metric = f"ra_{_metric_name(name)}_seconds"
        out.append(f"# HELP {metric} {h.help or 'latency histogram'}")
        out.append(f"# TYPE {metric} summary")
        ps = h.percentiles((50, 90, 99, 99.9))
        for q, v in zip(("0.5", "0.9", "0.99", "0.999"), ps):
            out.append(f'{metric}{{quantile="{q}"}} {v / 1e9:.9f}')
        out.append(f"{metric}_sum {h.total / 1e9:.9f}")
        out.append(f"{metric}_count {h.n}")
    return "\n".join(out) + "\n"
