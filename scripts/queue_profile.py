#!/usr/bin/env python3
"""Where the time of phase queue's release-cursor wave goes: one run of
``tests/queue_cases.py``'s waves at full width on started coordinators
(as ``chip_smoke.py`` phase queue runs it, without the cut), with every
thread's stack sampled during wave S2 (the settles that empty every
queue, so every replica snapshots) and the release-cursor path timed
piece by piece.

    python3 scripts/queue_profile.py [--queues 10240] [--dir DIR]
        [--every 0.05] [--device cuda]

``--dir`` is where the logs live (default: a fresh directory in the
temporary directory, removed at the end). Prints the card's name and power limit,
each wave's line, then for S2: per coordinator the calls and seconds of
``Log.update_release_cursor``, ``SnapshotStore.write``,
``DeviceSeam.record_snapshot`` and ``BatchCoordinator._apply_group``,
the applied progress second by second, and the innermost frames of the
``ra_tpu_torch`` code each thread was found in, most frequent first.
"""

import argparse
import collections
import json
import os
import shutil
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))


class Timers:
    """Wraps methods at class level; seconds and calls by thread name."""

    def __init__(self):
        self.s = collections.defaultdict(float)
        self.n = collections.Counter()
        self.undo = []

    def wrap(self, cls, name):
        orig = getattr(cls, name)
        timers = self

        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                key = (threading.current_thread().name, name)
                timers.s[key] += time.perf_counter() - t
                timers.n[key] += 1

        setattr(cls, name, timed)
        self.undo.append((cls, name, orig))

    def restore(self):
        for cls, name, orig in reversed(self.undo):
            setattr(cls, name, orig)


class StackSampler:
    """Every ``every`` seconds, the innermost frames in ``ra_tpu_torch``
    (and the first frame outside it) of every live thread, counted by
    thread-name prefix."""

    def __init__(self, every):
        self.every = every
        self.counts = collections.defaultdict(collections.Counter)
        self.samples = 0
        self._done = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        me = threading.get_ident()
        names = {}
        while not self._done.wait(self.every):
            names.update((t.ident, t.name) for t in threading.enumerate())
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                chain = []
                f = frame
                while f is not None and len(chain) < 4:
                    code = f.f_code
                    where = f"{os.path.basename(code.co_filename)}:{code.co_name}"
                    if "ra_tpu_torch" in code.co_filename or not chain:
                        chain.append(where)
                    f = f.f_back
                name = names.get(ident, "?")
                if name.startswith(("ra-snap-send", "Thread", "ra-sync")):
                    name = name.rstrip("0123456789")
                self.counts[name][" < ".join(chain)] += 1
            self.samples += 1

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._t.join(timeout=5)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queues", type=int, default=10240)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--every", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    import lane_cases
    import queue_cases as QC
    from ra_tpu_torch.log.log import Log
    from ra_tpu_torch.log.snapshot import SnapshotStore
    from ra_tpu_torch.ops import kernels
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator
    from ra_tpu_torch.runtime.device import DeviceSeam

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(cs.nvidia_smi_line(), flush=True)
        kernels.build_many(("quorum", "step"))
    if args.dir:
        wd, fs = args.dir, "given"
        os.makedirs(wd, exist_ok=True)
    else:
        import tempfile

        wd = tempfile.mkdtemp(prefix="ra_queue_profile_")
        fs = cs.fs_type(wd)
    print(f"logs under {wd} ({fs})", flush=True)
    lane = lane_cases.Lane("ra_tpu_torch", dev)
    timers = Timers()
    for cls, name in ((Log, "update_release_cursor"),
                      (SnapshotStore, "write"),
                      (DeviceSeam, "record_snapshot"),
                      (DeviceSeam, "upload"),
                      (BatchCoordinator, "_apply_group"),
                      (BatchCoordinator, "_sync_snapshot_floor"),
                      (BatchCoordinator, "_realise_effects")):
        timers.wrap(cls, name)
    out = {}
    live = {}

    def dump(label):
        print(f"-- {label}: timers (thread, function): [calls, s]", flush=True)
        for k, v in sorted(timers.s.items()):
            print(f"   {k[0]} {k[1]}: [{timers.n[k]}, {v:.3f}]", flush=True)
        sampler = live.get("sampler")
        if sampler is not None:
            print(f"-- {label}: stacks over {sampler.samples} samples",
                  flush=True)
            for k, v in sorted(sampler.counts.items()):
                for chain, n in v.most_common(8):
                    print(f"   {k}: {n} {chain}", flush=True)
    try:
        t = time.perf_counter()
        with QC.QueueCluster(
                lane, wd, args.queues, "qf", None, parts=1,
                election_timeout_s=cs.API_ELECTION_TIMEOUT_S,
                detector_poll_s=0.1, tick_interval_s=1.0,
                log_threads=cs.QUEUE_LOG_THREADS,
                progress=lambda line: print(line, flush=True)) as cl:
            out["set_up_s"] = time.perf_counter() - t
            out["election_s"] = cl.elect(args.timeout)
            send = cl.send

            def watched_send(cmds, timeout_s=60.0):
                if not any(c[0][0] == "settle" and c[0][1].endswith("/B0")
                           for c in cmds[:1]):
                    return send(cmds, timeout_s)
                timers.s.clear()
                timers.n.clear()
                stop = live["stop"] = threading.Event()

                def watch():
                    t0 = time.perf_counter()
                    while not stop.wait(2.0):
                        print("progress", json.dumps({
                            "s": round(time.perf_counter() - t0, 1),
                            "applied": [sum(g.last_applied
                                            for g in cl.groups(i))
                                        for i in range(3)],
                            "snapshots": [len(v) for v in
                                          cl.snap_writes.values()],
                            "steps": [c.steps for c in cl.coords],
                            "wedges": [c.counters.get("lane_wedges")
                                       for c in cl.coords]}), flush=True)

                threading.Thread(target=watch, daemon=True).start()
                live["sampler"] = StackSampler(args.every).__enter__()
                try:
                    return send(cmds, timeout_s)
                finally:
                    dump("wave S2 replied")

            cl.send = watched_send
            try:
                rec = QC.waves(cl, 0, 12, timeout_s=args.timeout)
            finally:
                if "stop" in live:
                    live["stop"].set()
                if "sampler" in live:
                    live["sampler"].__exit__()
                dump("every replica snapshotted (or failed)")
            out["waves"] = rec["waves"]
            out["snapshot_write_s"] = rec["snapshot_write_s"]
    finally:
        timers.restore()
        t = time.perf_counter()
        if not args.dir:
            shutil.rmtree(wd, ignore_errors=True)
        out["remove_s"] = time.perf_counter() - t
    for k, v in out.items():
        print(k, json.dumps(v, default=str), flush=True)


if __name__ == "__main__":
    main()
