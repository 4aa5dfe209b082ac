"""The port's plain step on CPU tensors when several threads step at once
(ROADMAP Queue 3 item 2), and ``step_once`` on both packages.

1. ``consensus_step_packed_sub_scat`` at capacity 8, P = 3, one thread
   and then ``--threads`` threads at once: through the entry point
   (which runs the CPU route under ``_CPU_STEP_LOCK``) and through the
   plain version directly (no lock). Prints each thread's median ms a
   step, lock wait included, and the wall time.
2. ``step_once`` of a hand-stepped 3-coordinator cluster (one group,
   capacity 8) on the JAX package and on the port: the median ms a step.

Run from the repository root:

    env JAX_PLATFORMS=cpu python scripts/cpu_step_threads.py
"""

import argparse
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

import torch  # noqa: E402

torch.set_num_threads(1)

from ra_tpu_torch.ops import consensus as C  # noqa: E402

G, P, K = 8, 3, 32


def step_threads(fn, threads: int, steps: int):
    """Median ms a step of each thread, and the wall seconds."""
    packed = torch.zeros((len(C.MBOX_FIELDS) + len(C.MBOX_SCAT_FIELDS), G),
                         dtype=torch.int32)
    packed[len(C.MBOX_FIELDS)] = G  # no scatter rows (pad gid)
    packed[len(C.MBOX_FIELDS) + 4] = G
    gidx = torch.arange(G, dtype=torch.int32)
    out = []

    def work():
        st = C.make_group_state(G, P, K, device="cpu")
        ts = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fn(st, packed, gidx)
            ts.append(time.perf_counter() - t0)
        out.append(round(sorted(ts)[len(ts) // 2] * 1e3, 3))

    th = [threading.Thread(target=work) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in th:
        t.start()
    for t in th:
        t.join()
    return out, round(time.perf_counter() - t0, 3)


def step_once_ms(name: str, steps: int) -> float:
    import conftest  # noqa: F401  (pins JAX to the CPU)
    import lane_cases as L

    lane = L.Lane(name)
    coords, ids = L.mk_cluster(lane, "cst", "auto", L.ManualClock())
    try:
        L.elect(lane, coords, ids, 0)
        ts = []
        for _ in range(steps):
            coords[0].deliver(ids[0], lane.command(1, reply_mode="noreply"),
                              None)
            t0 = time.perf_counter()
            coords[0].step_once()
            ts.append(time.perf_counter() - t0)
            L.step_all(coords[1:])
        return round(sorted(ts)[len(ts) // 2] * 1e3, 3)
    finally:
        L.close(coords)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    for label, fn in (("entry point, locked", C.consensus_step_packed_sub_scat),
                      ("plain, no lock", C.consensus_step_packed_sub_scat_plain)):
        for n in (1, args.threads):
            med, wall = step_threads(fn, n, args.steps)
            print(f"step_sub G={G} P={P}, {label}, {n} thread(s): median ms "
                  f"a step by thread {med}, wall {wall} s", flush=True)
    for name in ("ra_tpu", "ra_tpu_torch"):
        print(f"step_once {name} (hand-stepped, capacity {G}): median "
              f"{step_once_ms(name, args.steps * 2)} ms", flush=True)


if __name__ == "__main__":
    main()
