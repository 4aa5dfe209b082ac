#!/usr/bin/env python3
"""Time the quorum kernel (``csrc/quorum.cu``) at every tiling it takes.

    python3 scripts/quorum_sweep.py [--calls 50]

For each block size (32, 64, 128, 256 threads), through the kernel's
``ra_quorum_launch_tiled`` entry, at the main
path's G = 10240 with P = 3, 5 and 7 and at the scaling shape G =
4,194,304, P = 3 (96.5 MB, above the 50 MB L2): the result is checked
against the plain version bit for bit, then the card time a call is
taken from ``torch.profiler`` over ``--calls`` calls and the time a call
from CUDA events (median). The empty kernel at the main path's grid is
timed the same way, for the launch floor. It prints one JSON line per
row, tagged with the card's name and power limit; the block size that
``ra_quorum_launch`` uses (``kThreads``) is chosen from these rows. Needs a CUDA card; imports no JAX.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ra_tpu_torch.ops import quorum as Q  # noqa: E402

THREADS = (32, 64, 128, 256)
SHAPES = ((cs.GROUPS, 3), (cs.GROUPS, 5), (cs.GROUPS, 7), cs.SCALING)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quorum_sweep: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi_line()
    fn = Q._kernel("ra_quorum_launch_tiled")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rng = np.random.default_rng(7)
    floor = cs.launch_floor(torch, Q, cs.GROUPS, dev)
    print(json.dumps({"empty_kernel": floor, "device": card}), flush=True)
    for g, p in SHAPES:
        m, v, nv = (torch.from_numpy(a).to(dev)
                    for a in cs.quorum_inputs(rng, g, p))
        want = Q.agreed_commit_plain(m, v, nv)
        bound_ms = cs.quorum_bound(g, p)[0]
        for threads in THREADS:
            out = torch.empty(g, dtype=torch.int32, device=dev)

            def call():
                rc = fn(m.data_ptr(), v.data_ptr(), nv.data_ptr(),
                        out.data_ptr(), g, p, threads, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(
                    f"{threads} threads a block != plain at G={g}, P={p}")
            _, dev_us = cs.profile_kernels(torch, call, args.calls,
                                           ("quorum_kernel",))
            card_us = sum(dev_us.values())
            print(json.dumps({
                "g": g, "p": p, "threads": threads,
                "blocks": -(-g // threads), "card_us": card_us,
                "ms": cs.median_ms(call),
                "bound_share": bound_ms * 1e3 / card_us, "device": card}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
