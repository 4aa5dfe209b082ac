#!/usr/bin/env python3
"""Time what a release-cursor snapshot costs on a file system: the
file-system operations a ``SnapshotStore.write`` is made of, one at a
time, then whole snapshot writes of a drained fifo queue's state (the
state phase queue of ``chip_smoke.py`` snapshots), one after another as
a coordinator's apply path writes them and on several threads at once,
and the set-up of a ``SnapshotStore`` (the per-log directories).

    python3 scripts/snapshot_write_probe.py [--dirs DIR ...] [--n 256]
        [--threads 8]

``--dirs`` defaults to the temporary directory. Prints the card's name and power limit when ``nvidia-smi``
answers, then one JSON line a directory: for each measure the median,
p99 and mean in ms over ``--n`` samples, and the file system's type.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def stats(ts):
    s = sorted(ts)
    return {"p50_ms": statistics.median(s) * 1e3,
            "p99_ms": s[min(len(s) - 1, len(s) * 99 // 100)] * 1e3,
            "mean_ms": sum(s) / len(s) * 1e3, "n": len(s)}


def timed(fn, n):
    out = []
    for i in range(n):
        t = time.perf_counter()
        fn(i)
        out.append(time.perf_counter() - t)
    return out


def fs_type(path):
    try:
        out = subprocess.run(["df", "-T", path], capture_output=True,
                             text=True, timeout=10).stdout.splitlines()
        return out[1].split()[1]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def drained_queue_state():
    """A fifo queue's state at its release cursor: empty, nothing in
    flight, one consumer registered (as phase queue's settle_b)."""
    from ra_tpu_torch.models.fifo import FifoMachine

    m = FifoMachine()
    st = m.init({})
    cmds = ([("checkout", "q/A", 2)]
            + [("enqueue", v) for v in (11, 22, 33, 44)]
            + [("settle", "q/A", 1), ("settle", "q/A", 2),
               ("down", "q/A", "noconnection"), ("checkout", "q/B", 4),
               ("settle", "q/B", 3), ("settle", "q/B", 4)])
    for i, c in enumerate(cmds, start=2):
        st = m.apply({"index": i}, c, st)[0]
    return st


def probe(root, n, threads):
    from ra_tpu_torch.log.snapshot import SnapshotStore
    from ra_tpu_torch.protocol import SnapshotMeta

    d = tempfile.mkdtemp(prefix="ra_snap_probe_", dir=root)
    out = {"dir": root, "fs": fs_type(root)}
    try:
        body = b"x" * 128

        def create_fsync(i):
            with open(os.path.join(d, f"f{i}"), "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())

        out["create_write_fsync"] = stats(timed(create_fsync, n))
        out["mkdir"] = stats(timed(
            lambda i: os.mkdir(os.path.join(d, f"m{i}")), n))
        out["rename"] = stats(timed(
            lambda i: os.replace(os.path.join(d, f"m{i}"),
                                 os.path.join(d, f"r{i}")), n))
        out["listdir"] = stats(timed(lambda i: os.listdir(d), n))

        def dir_fsync(i):
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

        out["dir_fsync"] = stats(timed(dir_fsync, n))
        state = drained_queue_state()
        stores = []
        out["store_set_up"] = stats(timed(
            lambda i: stores.append(SnapshotStore(os.path.join(d, f"s{i}"))),
            n))

        def write(i):
            stores[i].write(SnapshotMeta(index=12, term=1, cluster=(),
                                         machine_version=0), state)

        out["snapshot_write_serial"] = stats(timed(write, n))
        more = [SnapshotStore(os.path.join(d, f"t{i}")) for i in range(n)]

        def write_more(i):
            t = time.perf_counter()
            more[i].write(SnapshotMeta(index=12, term=1, cluster=(),
                                       machine_version=0), state)
            return time.perf_counter() - t

        t = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            each = list(pool.map(write_more, range(n)))
        wall = time.perf_counter() - t
        out[f"snapshot_write_{threads}_threads"] = dict(
            stats(each), wall_s=wall, writes_per_s=n / wall)
    finally:
        t = time.perf_counter()
        shutil.rmtree(d, ignore_errors=True)
        out["remove_s"] = time.perf_counter() - t
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dirs", nargs="*", default=None)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    dirs = args.dirs
    if dirs is None:
        dirs = [tempfile.gettempdir()]
    try:
        import chip_smoke

        print(chip_smoke.nvidia_smi_line(), flush=True)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        print(f"no card: {e}", flush=True)
    for root in dirs:
        print(json.dumps(probe(root, args.n, args.threads)), flush=True)


if __name__ == "__main__":
    main()
