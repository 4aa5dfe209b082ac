#!/usr/bin/env python3
"""Time what making a term and a vote durable costs in a ``FileMeta``
(``ra_tpu_torch/log/meta_store.py``) on a file system, as a coordinator
writes them: each group's ``store`` of its term then ``store_sync`` of
its vote, one group after another (one ``fdatasync`` a group), and a
pass of 10240 groups' ``store``s of both followed by one ``sync`` (one
``fdatasync`` a pass).

    python3 scripts/meta_sync_probe.py [--dir DIR] [--n 1000]
        [--groups 10240]

``--dir`` defaults to the temporary directory; the probe writes its
journal in a fresh directory there and removes it. Prints one JSON
line: the per-group pair's median, p99 and mean in ms over ``--n``
groups and their sum, the pass's ``store`` time, its one ``sync`` and
its total in ms, the file system's type and, when ``nvidia-smi``
answers, the card's name and power limit.
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

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from ra_tpu_torch.log.meta_store import FileMeta  # noqa: E402


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"
    return out.splitlines()[0].strip() if out else "none"


def fs_type(d: str) -> str:
    out = subprocess.run(["df", "-T", d], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return out[1].split()[1] if len(out) > 1 else "unknown"


def ms_stats(xs) -> dict:
    xs = sorted(x * 1e3 for x in xs)
    return {"p50_ms": statistics.median(xs),
            "p99_ms": xs[min(len(xs) - 1, len(xs) * 99 // 100)],
            "mean_ms": statistics.fmean(xs), "sum_ms": sum(xs), "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=tempfile.gettempdir())
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--groups", type=int, default=10240)
    args = ap.parse_args()
    work = tempfile.mkdtemp(prefix="ra_meta_probe_", dir=args.dir)
    try:
        meta = FileMeta(os.path.join(work, "one", "meta.dat"))
        one = []
        for g in range(args.n):
            uid = f"cl{g}_g{g}"
            t = time.perf_counter()
            meta.store(uid, "current_term", 2)
            meta.store_sync(uid, "voted_for", (f"g{g}", "n1"))
            one.append(time.perf_counter() - t)
        meta.close()

        meta = FileMeta(os.path.join(work, "pass", "meta.dat"))
        t = time.perf_counter()
        for g in range(args.groups):
            uid = f"cl{g}_g{g}"
            meta.store(uid, "current_term", 2)
            meta.store(uid, "voted_for", (f"g{g}", "n1"))
        stored = time.perf_counter() - t
        meta.sync()
        total = time.perf_counter() - t
        meta.close()
        out = {
            "per_group_store_sync": ms_stats(one),
            "pass": {"groups": args.groups, "store_ms": stored * 1e3,
                     "sync_ms": (total - stored) * 1e3,
                     "total_ms": total * 1e3},
            "fs": fs_type(args.dir), "dir": args.dir, "card": card(),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
