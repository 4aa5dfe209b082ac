"""The two suspects of ROADMAP Queue 3, at small scale on the CPU, on the
JAX package and on the port (its coordinators on ``device="cpu"``).

1. Lease reads in a sparse client shape: a fleet of ``--groups`` groups
   on three started coordinators with ``lease=True``; one command and
   then one consistent read for every group (stride 1) or every fourth
   group (stride 4), the reads right after the commands or after a pause
   past the lease window (``election_timeout_s * 0.8``). Prints the
   seconds the writes took and the reads served by the lease and by a
   quorum round. ``--warm`` first runs one unmeasured fleet of the same
   size (so the JAX package's step is compiled before the clock
   matters).
2. "command lane wedged": the same fleet with a short command deadline
   (``--deadline``) under ``--clients`` client threads writing to every
   group at once. Prints the watchdog's strikes (``lane_wedges``) and
   recoveries, and checks every reply.

Run from the repository root (it imports ``tests/torch_batch.py``):

    env JAX_PLATFORMS=cpu python scripts/queue3_suspects.py
"""

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

import conftest  # noqa: E402,F401  (pins JAX to the CPU)
from torch_batch import PACKAGES, Pkg, clear_both  # noqa: E402

ELECTION_TIMEOUT_S = 2.0  # phase api's


def fleet(pkg, tag, groups, **kw):
    names = [f"{tag}{i}" for i in range(3)]
    coords = [pkg.coord(n, capacity=groups, num_peers=3,
                        election_timeout_s=ELECTION_TIMEOUT_S, **kw)
              for n in names]
    for c in coords:
        c.add_groups([(f"g{g}", f"cl{g}", [(f"g{g}", n) for n in names],
                       pkg.adder()) for g in range(groups)])
    for c in coords:
        c.start()
    coords[0].deliver_many([((f"g{g}", names[0]), pkg.election(), None)
                            for g in range(groups)])
    deadline = time.monotonic() + 120
    while any(coords[0].by_name[f"g{g}"].role != pkg.C.R_LEADER
              for g in range(groups)):
        if time.monotonic() > deadline:
            raise TimeoutError("election incomplete")
        time.sleep(0.02)
    return names, coords


def stop(coords):
    for c in reversed(coords):
        c.stop()


def lease_shape(pkg, groups, stride, pause, clients):
    names, coords = fleet(pkg, f"ls{stride}", groups, lease=True)
    try:
        called = list(range(0, groups, stride))

        def command(g):
            r, _ = pkg.api.process_command((f"g{g}", names[0]), g + 1,
                                           timeout=60)
            assert r == g + 1, (g, r)

        def read(g):
            out = pkg.api.consistent_query((f"g{g}", names[g % 3]),
                                           lambda s: s, timeout=60)
            assert out[0] == "ok" and out[1] == g + 1, (g, out)

        with ThreadPoolExecutor(clients) as pool:
            t = time.perf_counter()
            list(pool.map(command, called))
            write_s = round(time.perf_counter() - t, 3)
            time.sleep(pause)
            list(pool.map(read, called))
        return {"write_s": write_s, "reads": len(called),
                "lease_served": sum(c.counters.get("read_lease_served")
                                    for c in coords),
                "quorum_fallback": sum(c.counters.get("read_quorum_fallback")
                                       for c in coords)}
    finally:
        stop(coords)


def lane_load(pkg, groups, deadline_s, clients, rounds):
    names, coords = fleet(pkg, "ll", groups, command_deadline_s=deadline_s)
    try:
        def command(g):
            r, _ = pkg.api.process_command((f"g{g}", names[0]), 1, timeout=60)
            return r

        t = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            for k in range(1, rounds + 1):
                got = list(pool.map(command, range(groups)))
                assert got == [k] * groups, got
        return {"commands": groups * rounds,
                "seconds": round(time.perf_counter() - t, 3),
                "lane_wedges": coords[0].counters.get("lane_wedges"),
                "lane_recoveries": coords[0].counters.get("lane_recoveries")}
    finally:
        stop(coords)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=64)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--pause", type=float, default=2.5)
    ap.add_argument("--deadline", type=float, default=0.3)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--packages", default=",".join(PACKAGES))
    ap.add_argument("--parts", default="lease,lane")
    args = ap.parse_args()
    parts = args.parts.split(",")
    for name in args.packages.split(","):
        if args.warm:
            clear_both()
            lease_shape(Pkg(name), args.groups, 1, 0.0, args.clients)
        for stride in (1, 4) if "lease" in parts else ():
            for pause in (0.0, args.pause):
                clear_both()
                r = lease_shape(Pkg(name), args.groups, stride, pause,
                                args.clients)
                print(f"lease {name}: groups {args.groups}, stride {stride}, "
                      f"pause {pause} s: {r}", flush=True)
        if "lane" in parts:
            clear_both()
            r = lane_load(Pkg(name), args.groups, args.deadline,
                          args.clients * 4, args.rounds)
            print(f"lane {name}: groups {args.groups}, command deadline "
                  f"{args.deadline} s, {args.clients * 4} clients: {r}",
                  flush=True)
        clear_both()


if __name__ == "__main__":
    main()
