"""Time a node's replacement in every group on one device, and show where
the coordinators' threads spend it.

    python3 scripts/replace_probe.py [--groups 10240] [--device cuda]
        [--scatters 2000] [--wal] [--out FILE]

First it times the device seam's member-row write alone at the
cluster's width: ``set_rows`` of one group's ``active`` and ``voting``
rows (what ``_sync_member_rows`` issues a group a change), the median
of ``--scatters`` calls ended by a synchronise, against one call that
writes ``--scatters`` groups' rows at once. Then it builds three started
coordinators of ``--groups`` groups x 3 replicas with in-memory logs
(with ``--wal``: WAL-backed logs as phase loop's, a shared WAL a node
in a temporary directory, node 3's too; phase loop's timeouts: election 2.0 s, detector poll 0.1 s, active set
``auto``), elects every group on node 1 (so node 0 follows everywhere),
applies one command a group on all three, and runs
``tests/failover_cases.py``'s ``replace_node``: node 0 lost and
replaced by a fresh node 3 (its meta store and WAL in a temporary
directory, its logs in memory unless ``--wal``). A monitor thread prints every 2 s each
node's steps, messages, lane counters, the groups whose table still
names node 0, the leaders free to change their cluster, the replies
pending, and node 3's groups following; and samples every 0.1 s the
innermost frames of each coordinator thread (step, egress, detector,
sender), whose counts it prints at the end. The record's line (``chip_smoke.replace_line``)
follows. Times on the CPU are the CPU's, not the card's.
"""

import argparse
import os
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402
import failover_cases as FC  # noqa: E402
import lane_cases as L  # noqa: E402
from ra_tpu_torch.runtime.device import DeviceSeam  # noqa: E402


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_scatters(dev, groups, n) -> dict:
    """One group's member rows a call, against ``n`` groups' in one."""
    from ra_tpu_torch.ops import consensus as C

    seam = DeviceSeam(dev)
    st = C.make_group_state(groups, 3, 32, device=dev)
    act = np.array([False, True, True])
    vot = np.array([False, True, True])
    for _ in range(50):
        st = seam.set_rows(st, 7, active=act, voting=vot)
    sync(dev)
    each = []
    for g in range(n):
        t = time.perf_counter()
        st = seam.set_rows(st, g % groups, active=act, voting=vot)
        sync(dev)
        each.append(time.perf_counter() - t)
    t = time.perf_counter()
    for g in range(n):
        st = seam.set_rows(st, g % groups, active=act, voting=vot)
    sync(dev)
    loop_s = time.perf_counter() - t
    gids = list(range(min(n, groups)))
    rows_a = np.tile(act, (len(gids), 1))
    t = time.perf_counter()
    st = seam.set_rows(st, gids, active=rows_a, voting=rows_a)
    sync(dev)
    return {"calls": n, "median_ms_synced": 1e3 * float(np.median(each)),
            "loop_ms_a_call": 1e3 * loop_s / n,
            "one_call_ms_for_all": 1e3 * (time.perf_counter() - t)}


class Monitor:
    """Progress every ``every_s`` and step-thread frame samples."""

    def __init__(self, coords, node0, every_s=2.0, sample_s=0.1, out=None):
        self.coords, self.node0 = coords, node0
        self.every_s, self.sample_s, self.out = every_s, sample_s, out
        self.frames = {}
        self._done = threading.Event()
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="replace-monitor")

    def _line(self):
        parts = [f"t={time.perf_counter() - self._t0:.1f}"]
        for c in list(self.coords):
            if c is None:
                continue
            k = c.counters.get
            s = (f"{c.name}: steps {c.steps} msgs {c.msgs_processed} "
                 f"wedges {k('lane_wedges')} ring_full "
                 f"{k('ingress_ring_full')}")
            if c.name.endswith("3"):
                s += (" following " + str(sum(
                    1 for g in c.by_name.values() if g.leader_slot >= 0)))
            else:
                groups = list(c.by_name.values())
                s += (f" naming0 {sum(1 for g in groups if any(m and m[1] == self.node0 for m in g.members))}"
                      f" permitted {sum(1 for g in groups if g.cluster_change_permitted)}"
                      f" pending {sum(len(g.pending_replies) for g in groups)}")
            parts.append(s)
        return " | ".join(parts)

    def _sample(self):
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            name = names.get(ident, "")
            if not name.startswith("ra-batch-"):
                continue
            kind = name[len("ra-batch-"):].rstrip("0123456789")
            stack = traceback.extract_stack(frame)[-6:]
            key = f"[{kind}] " + " < ".join(
                f"{f.name}:{f.lineno}" for f in reversed(stack))
            self.frames[key] = self.frames.get(key, 0) + 1

    def _run(self):
        last = 0.0
        while not self._done.wait(self.sample_s):
            self._sample()
            now = time.perf_counter()
            if now - last >= self.every_s:
                last = now
                print(self._line(), file=self.out, flush=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=10)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=10240)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scatters", type=int, default=2000)
    ap.add_argument("--settle", type=float, default=300.0)
    ap.add_argument("--wal", action="store_true",
                    help="WAL-backed logs, as phase loop's")
    ap.add_argument("--out", default=None,
                    help="file for the monitor's lines (default stdout)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    dev = torch.device(args.device)
    card = chip_smoke.nvidia_smi_line() if dev.type == "cuda" else "cpu"
    G = args.groups
    if dev.type == "cuda":
        from ra_tpu_torch.ops import kernels
        kernels.build_many(["quorum", "step"])
    print(f"member-row writes at G={G}: "
          f"{time_scatters(dev, G, args.scatters)} | {card}", flush=True)
    out = open(args.out, "w") if args.out else sys.stdout
    lane = L.Lane("ra_tpu_torch", dev)
    lane.leaderboard.clear()
    names = [f"rq{i}" for i in range(4)]
    gname = [f"g{g}" for g in range(G)]
    workdir = tempfile.mkdtemp(prefix="ra_replace_probe_")
    if args.wal:
        from ra_tpu_torch import bench

        disk = FC.Disk(lane, workdir, names, G, wal_kw=chip_smoke.WAL_KW,
                       build_logs=lambda i: bench.wal_logs(
                           [disk.entries[i]], G)[0])
    else:
        disk = FC.Disk(lane, workdir, names, G,
                       build_logs=lambda i: [None] * G)
    coords = [lane.coord(n, capacity=G, num_peers=3, active_set="auto",
                         election_timeout_s=2.0, detector_poll_s=0.1)
              for n in names[:3]]
    try:
        t = time.perf_counter()
        for c in coords:
            c.start()
        per_node = (disk.open_all(coords, names[:3]) if args.wal
                    else [[None] * G] * 3)
        for c, logs in zip(coords, per_node):
            c.add_groups([(n, f"cl{g}", [(n, x) for x in names[:3]],
                           lane.adder(), logs[g])
                          for g, n in enumerate(gname)])
        coords[1].deliver_many([((n, names[1]),
                                 lane.protocol.ElectionTimeout(), None)
                                for n in gname])
        by1 = coords[1].by_name
        FC.await_(lambda: all(by1[n].role == lane.C.R_LEADER
                              and by1[n].cluster_change_permitted
                              for n in gname), timeout=args.settle,
                  what="leaders on node 1")
        totals = [g % 97 + 1 for g in range(G)]
        FC.replies_ok(FC._send(lane, coords[1], [(n, names[1]) for n in gname],
                               totals, True), 120.0)
        FC.await_(lambda: all(c.by_name[n].machine_state == totals[g]
                              for c in coords for g, n in enumerate(gname)),
                  timeout=args.settle, what="every replica applied")
        print(f"set-up {time.perf_counter() - t:.3f} s", flush=True)
        with Monitor(coords, names[0], out=out) as mon:
            try:
                rp = FC.replace_node(
                    lane, coords, disk, totals, [1] * G, names[3], bulk=True,
                    api_sample=256, clients=32, reply_timeout_s=120.0,
                    settle_timeout_s=args.settle,
                    poll_s=chip_smoke.LOOP_REPLACE_POLL_S)
            finally:
                # a thread parked on its wake event or condition is idle
                busy = {k: v for k, v in mon.frames.items()
                        if not k.split("] ", 1)[1].startswith("wait:")}
                top = sorted(busy.items(), key=lambda kv: -kv[1])[:40]
                print(f"coordinator threads' busy frames (innermost "
                      f"first), samples (of {sum(mon.frames.values())}):",
                      flush=True)
                for k, v in top:
                    print(f"  {v:6d}  {k}", flush=True)
        print(f"replace: {chip_smoke.replace_line(rp, card)}", flush=True)
    finally:
        for c in coords:
            if c is not None:
                c.stop()
        disk.close_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
