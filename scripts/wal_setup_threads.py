#!/usr/bin/env python3
"""Time the set-up of the WAL-backed logs of a full-width cluster (three
coordinators of 10240 groups, 30,720 ``Log``s) built on N threads, the
way ``ra_tpu_torch.bench.wal_logs`` builds them on 8, and the teardown
(closing the WALs, removing the directories). Thread counts run in
turns, each in a fresh directory, so a later run finds no warmer disk
than an earlier one of another count.

    python3 scripts/wal_setup_threads.py [--device cuda] [--threads 8 32]
        [--rounds 2] [--groups 10240]

Prints one JSON line per run and the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def build_logs(storage, groups: int, threads: int, chunk: int = 512):
    """``bench.wal_logs`` with its pool's size as an argument."""
    from ra_tpu_torch.log.log import Log

    def build(job):
        (tables, w, d), lo = job
        return [Log(f"g{g}", os.path.join(d, "data", f"g{g}"), tables, w)
                for g in range(lo, min(lo + chunk, groups))]

    jobs = [(n, lo) for n in storage for lo in range(0, groups, chunk)]
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(build, jobs))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--groups", type=int, default=10240)
    args = ap.parse_args()

    import chip_smoke as cs
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    if args.device.startswith("cuda"):
        print(cs.nvidia_smi_line(), flush=True)
    order = []
    for r in range(args.rounds):
        order += args.threads if r % 2 == 0 else args.threads[::-1]
    for k, threads in enumerate(order):
        wd = tempfile.mkdtemp(prefix="ra_wal_setup_")
        names = [f"ws{k}_{i}" for i in range(3)]
        coords = [BatchCoordinator(n, capacity=args.groups, num_peers=3,
                                   device=args.device) for n in names]
        storage = []
        try:
            cs.open_storage(coords, names, wd, storage)
            t = time.perf_counter()
            build_logs(storage, args.groups, threads)
            built = time.perf_counter() - t
        finally:
            t = time.perf_counter()
            for _tables, w, _d in storage:
                w.close()
                w.segment_writer.close()
            for c in coords:
                c.stop()
            shutil.rmtree(wd, ignore_errors=True)
            torn = time.perf_counter() - t
        print(json.dumps({"threads": threads, "logs": 3 * args.groups,
                          "build_s": built, "teardown_s": torn}), flush=True)


if __name__ == "__main__":
    main()
